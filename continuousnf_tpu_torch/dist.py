"""Distribution adapter: an ICNF as a probability distribution.

Port of `continuousnf_tpu/dist.py`: `ICNFDist` (:22-58) and `CondICNFDist`
(:61-95), TEST mode.  Sampling takes a `torch.Generator`, or the base draw
`z1` itself.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from .core.icnf import ICNF, _device_of, generate, inference
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


@dataclasses.dataclass(frozen=True)
class CondICNFDist:
    """Conditional ICNF distribution with a fixed conditioning `ys`,
    (n_cond,) for every query or (B, n_cond) rows: `logpdf`, `pdf` and
    `sample`."""

    icnf: ICNF
    mode: Mode
    ps: Any
    ys: Any

    def __len__(self) -> int:
        return self.icnf.nvars

    def _ys_for(self, batch: Optional[int]):
        """The conditioning of a call over `batch` queries: a single row as
        it is, rows sliced to the first `batch` (the reference's matrix
        mode, `ys[:, 1:size(A, 2)]`).  ys may be given as any array-like
        (a list, a numpy array); it is converted first, onto the params'
        device, as the JAX package does."""
        ys = torch.as_tensor(self.ys, dtype=self.icnf.dtype, device=_device_of(self.ps))
        if ys.ndim == 1 or batch is None:
            return ys
        return ys[:batch]

    def logpdf(self, x) -> torch.Tensor:
        """log-density of `x` given ys ((B, nvars) -> (B,), or (nvars,) ->
        scalar)."""
        batch = x.shape[0] if x.ndim == 2 else None
        logpx, _, _ = inference(self.icnf, self.mode, x, self.ps, ys=self._ys_for(batch))
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
        """Draw `n` samples given ys ((n, nvars); `n=None` -> one (nvars,)
        sample)."""
        return generate(self.icnf, self.mode, self.ps, n, ys=self._ys_for(n), generator=generator, z1=z1)

    rand = sample


__all__ = ["ICNFDist", "CondICNFDist"]
