"""The standard normal base distribution.

Port of `continuousnf_tpu/distributions.py:21-46`.  Sampling takes an
explicit `torch.Generator` where the JAX package takes a PRNG key.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def std_normal_logpdf(z: torch.Tensor) -> torch.Tensor:
    """log N(z; 0, I) summed over the last axis."""
    d = z.shape[-1]
    return -0.5 * (d * _LOG_2PI + torch.sum(torch.square(z), dim=-1))


def std_normal_sample(
    generator: Optional[torch.Generator],
    shape: Tuple[int, ...],
    dtype=torch.float32,
    device=None,
) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class MvStdNormal:
    """Standard multivariate normal over `dim` dimensions."""

    dim: int

    def logpdf(self, z: torch.Tensor) -> torch.Tensor:
        return std_normal_logpdf(z)

    def sample(
        self,
        generator: Optional[torch.Generator],
        batch_shape: Tuple[int, ...] = (),
        dtype=torch.float32,
        device=None,
    ) -> torch.Tensor:
        return std_normal_sample(generator, (*batch_shape, self.dim), dtype, device)


__all__ = ["std_normal_logpdf", "std_normal_sample", "MvStdNormal"]
