"""Augmented CNF dynamics, TEST mode: vector field plus exact divergence.

Port of `continuousnf_tpu/core/dynamics.py`: `TestState` and `safe_norm`
(:35-61) and the closed-form TEST branch of `make_augmented_dynamics`
(:266-300).  The state is batch-major: z (B, dz), dlogp (B,).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..types import ComputeMode, Mode


class TestState(NamedTuple):
    """ODE state in TEST mode: transported sample + log-density delta."""

    z: torch.Tensor  # (B, dz)
    dlogp: torch.Tensor  # (B,)


def safe_norm(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2 norm that is exactly 0 (with a zero gradient) at v = 0."""
    sq = torch.sum(v * v, dim=dim)
    pos = sq > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, sq, torch.ones_like(sq))), torch.zeros_like(sq))


def make_augmented_dynamics(
    nn,
    mode: Mode,
    compute_mode: ComputeMode,
    norm_z: bool,
    norm_j: bool,
    passive_aug_dims: int = 0,
):
    """Build the ODE right-hand side `f(t, state, args)`; `args["ps"]` holds
    the net's params tree.

    TEST mode on Dense/tanh chains: the closed-form 2-layer trace for tanh
    MLPs with biases, the chain product for any other tanh-or-identity chain.
    """
    if mode != Mode.TEST:
        raise NotImplementedError(
            "TRAIN-mode dynamics are not ported yet (ROADMAP queue 1, items 4-6)"
        )
    if passive_aug_dims:
        raise NotImplementedError(
            "passive augmentation is not ported yet (ROADMAP queue 1, item 14)"
        )
    from ..ops.fused_dynamics import (
        exact_dense_chain_trace,
        exact_tanh_mlp_trace,
        is_dense_tanh_chain,
        supports_fusion,
    )

    if supports_fusion(nn):

        def f_test(t, state: TestState, args):
            dz, tr = exact_tanh_mlp_trace(args["ps"], state.z)
            return TestState(z=dz, dlogp=-tr)

    elif is_dense_tanh_chain(nn):

        def f_test(t, state: TestState, args):
            dz, tr = exact_dense_chain_trace(nn, args["ps"], state.z)
            return TestState(z=dz, dlogp=-tr)

    else:
        raise NotImplementedError(
            f"TEST dynamics for {type(nn).__name__} (Planar and generic exact fields) "
            "are not ported yet (ROADMAP queue 1, item 16)"
        )
    return f_test


__all__ = ["TestState", "safe_norm", "make_augmented_dynamics"]
