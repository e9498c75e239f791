"""The training-step body shared by `fit` and, later, the sharded step.

Port of `continuousnf_tpu/parallel/sharding.py::make_train_step_body`
(:36-81) for one device (`mesh=None`).  The Hutchinson probes are drawn here,
before the loss, and the steering draw inside `inference`, both from one
`torch.Generator`, in the order of the JAX package's key splits (:55,
`core/icnf.py:485`).  Both can be given instead (`eps=`, `steer_r=`).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.icnf import ICNF, _device_of, loss_and_metrics
from ..ode.adjoint import flatten_tree
from ..types import Mode


def make_train_step_body(icnf: ICNF, optimizer: torch.optim.Optimizer, mesh=None) -> Callable:
    """Return `step(ps, xs, generator=None, weights=None, ys=None, eps=None,
    steer_r=None) -> metrics`: one TRAIN loss, its gradient through the
    BACKSOLVE adjoint, and one `optimizer.step()`.  The leaves of the params
    tree `ps` must be the optimizer's parameters; they are updated in place.
    `metrics` holds loss, e (mean ||f|| integral), n (mean ||eps^T J||
    integral), all detached, and nfe (the forward solve's NFE)."""
    if mesh is not None:
        raise NotImplementedError("mesh parallelism is not ported yet (ROADMAP queue 1, item 19)")
    owned = {id(p) for group in optimizer.param_groups for p in group["params"]}

    def step(ps, xs, generator=None, weights=None, ys=None, eps=None, steer_r=None):
        leaves, _ = flatten_tree(ps)
        if any(id(p) not in owned for p in leaves):
            raise ValueError("the params tree's leaves must be the optimizer's parameters")
        if eps is None and not icnf.compute_mode.exact_trace:
            eps = icnf.draw_eps(generator, xs.shape[0], _device_of(ps))
        l, metrics = loss_and_metrics(
            icnf, Mode.TRAIN, xs, ps, ys=ys, generator=generator, weights=weights,
            eps=eps, steer_r=steer_r,
        )
        grads = torch.autograd.grad(l, leaves)
        for p, g in zip(leaves, grads):
            p.grad = g
        optimizer.step()
        for p in leaves:
            p.grad = None
        return dict(metrics, loss=l.detach())

    return step


__all__ = ["make_train_step_body"]
