"""The Lion optimizer (Chen et al. 2023), as `optax.lion` computes it.

`torch.optim` has no Lion.  Per parameter p with gradient g and momentum m
(zero at the start):

    u = sign((1 - b1) g + b1 m)
    p <- p - lr (u + weight_decay p)
    m <- (1 - b2) g + b2 m

with optax's defaults b1 = 0.9, b2 = 0.99 and weight_decay = 1e-3 (the
weight decay is scaled by the learning rate, as in optax).
"""

from __future__ import annotations

from typing import Tuple

import torch


class Lion(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 1e-3, betas: Tuple[float, float] = (0.9, 0.99),
                 weight_decay: float = 1e-3):
        if lr <= 0.0:
            raise ValueError(f"lr must be positive, got {lr}")
        if not all(0.0 <= b < 1.0 for b in betas):
            raise ValueError(f"betas must lie in [0, 1), got {betas}")
        super().__init__(params, dict(lr=lr, betas=tuple(betas), weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, wd = group["lr"], group["weight_decay"]
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["exp_avg"] = torch.zeros_like(p)
                m = state["exp_avg"]
                u = torch.sign((1.0 - b1) * g + b1 * m)
                p.add_(-lr * (u + wd * p))
                m.copy_((1.0 - b2) * g + b2 * m)
        return loss


__all__ = ["Lion"]
