"""Distribution adapter: an ICNF as a probability distribution.

Port of `continuousnf_tpu/dist.py:22-58` (`ICNFDist`, TEST mode).  Sampling
takes a `torch.Generator`, or the base draw `z1` itself.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from .core.icnf import ICNF, generate, inference
from .types import Mode


@dataclasses.dataclass(frozen=True)
class ICNFDist:
    """Unconditional ICNF distribution: `logpdf`, `pdf` and `sample`."""

    icnf: ICNF
    mode: Mode
    ps: Any

    def __len__(self) -> int:
        return self.icnf.nvars

    def logpdf(self, x) -> torch.Tensor:
        """log-density of `x` ((B, nvars) -> (B,), or (nvars,) -> scalar)."""
        logpx, _, _ = inference(self.icnf, self.mode, x, self.ps)
        return logpx

    def pdf(self, x) -> torch.Tensor:
        return torch.exp(self.logpdf(x))

    def sample(
        self,
        n: Optional[int] = None,
        *,
        generator: Optional[torch.Generator] = None,
        z1=None,
    ) -> torch.Tensor:
        """Draw `n` samples ((n, nvars); `n=None` -> one (nvars,) sample)."""
        return generate(self.icnf, self.mode, self.ps, n, generator=generator, z1=z1)

    rand = sample


__all__ = ["ICNFDist"]
