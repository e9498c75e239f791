"""Entry-point shape and dtype checks (port of the part of
`continuousnf_tpu/utils/debug.py::check_array` that the inference entry
points use)."""

from __future__ import annotations

from typing import Any, Optional, Tuple


def check_array(
    name: str,
    x: Any,
    *,
    rank: Optional[Tuple[int, ...]] = None,
    last_dim: Optional[int] = None,
    dtype: Any = None,
) -> None:
    """Raise with an actionable message when `x` has the wrong rank, trailing
    dim or dtype.  Reads metadata only."""
    shape = getattr(x, "shape", None)
    if shape is None:
        raise TypeError(f"{name} must be an array-like with .shape, got {type(x).__name__}")
    shape = tuple(shape)
    if rank is not None and len(shape) not in rank:
        raise ValueError(f"{name} must have rank in {rank}, got shape {shape}")
    if last_dim is not None and shape[-1] != last_dim:
        raise ValueError(f"{name} must have trailing dim {last_dim}, got shape {shape}")
    if dtype is not None:
        got = getattr(x, "dtype", None)
        if got is not None and got != dtype:
            raise ValueError(f"{name} must have dtype {dtype}, got {got}")


__all__ = ["check_array"]
