"""The standard normal base distribution and the Hutchinson probe draw.

Port of `continuousnf_tpu/distributions.py:21-46` and `sample_eps`
(:146-165).  Sampling takes an explicit `torch.Generator` where the JAX
package takes a PRNG key.
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


def sample_eps(
    generator: Optional[torch.Generator],
    shape: Tuple[int, ...],
    kind,
    dtype=torch.float32,
    device=None,
) -> torch.Tensor:
    """Draw Hutchinson probe vectors: `kind` is an `EpsDist` (standard
    Gaussian, or Rademacher +-1 with equal odds)."""
    from .types import EpsDist

    if kind == EpsDist.GAUSSIAN:
        return torch.randn(shape, generator=generator, dtype=dtype, device=device)
    if kind == EpsDist.RADEMACHER:
        bits = torch.randint(0, 2, shape, generator=generator, device=device)
        return (2 * bits - 1).to(dtype)
    raise ValueError(f"unknown eps dist {kind}")


__all__ = ["std_normal_logpdf", "std_normal_sample", "MvStdNormal", "sample_eps"]
