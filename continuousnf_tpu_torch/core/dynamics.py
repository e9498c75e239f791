"""Augmented CNF dynamics: vector field plus divergence and regularizer rates.

Port of `continuousnf_tpu/core/dynamics.py`: `TestState`, `TrainState` and
`safe_norm` (:35-61), `_batch_apply` (:64-73), the closed-form TEST branch of
`make_augmented_dynamics` (:266-300), `_hutchinson_field` with its VJP and
JVP probes (:185-206), the TRAIN fields `f_train` (:377-382) and `f_train_fused`
(:334-375), and the exact-trace TRAIN field `f_train_exact` (:302-332) with
its closed form `exact_tanh_mlp_trace_fro` (:155-182).  The state is
batch-major: z (B, dz), the accumulators (B,); probes are (K, B, dz).

Conditional calls (`args["ys"]`, (B, n_cond) or (n_cond,), broadcast over
the batch) feed the net [z | ys]; the divergence is in z only.  The JAX
package runs its generic identity-basis fields for them (:76-152, chosen at
:286-297 and :314-323); the port, which has no generic field yet (ROADMAP
queue 1, item 16), runs the same math for Dense chains as the chain product
with the z rows of the first layer.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..types import ADMode, ComputeMode, Mode

_ITEM14 = "(ROADMAP queue 1, item 14)"


class TestState(NamedTuple):
    """ODE state in TEST mode: transported sample + log-density delta."""

    z: torch.Tensor  # (B, dz)
    dlogp: torch.Tensor  # (B,)


class TrainState(NamedTuple):
    """TRAIN-mode state: adds the two RNODE regularizer accumulators."""

    z: torch.Tensor  # (B, dz)
    dlogp: torch.Tensor  # (B,)
    reg_e: torch.Tensor  # (B,)  integral of ||dz/dt||
    reg_n: torch.Tensor  # (B,)  integral of ||eps^T J||


def safe_sqrt(sq: torch.Tensor) -> torch.Tensor:
    """sqrt of a sum of squares that is exactly 0 (with a zero gradient) at 0."""
    pos = sq > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, sq, torch.ones_like(sq))), torch.zeros_like(sq))


def safe_norm(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2 norm that is exactly 0 (with a zero gradient) at v = 0."""
    return safe_sqrt(torch.sum(v * v, dim=dim))


def _batch_apply(nn_apply, ps, z: torch.Tensor, ys):
    """The net on z, or on [z | ys] with ys broadcast over the batch."""
    if ys is None:
        return nn_apply(ps, z)
    from ..nets.modules import with_cond

    return nn_apply(ps, with_cond(z, ys))


def _hutchinson_field(nn_apply, ad: ADMode):
    """dz plus the K-probe Hutchinson trace estimate and the probe-norm
    rate, both averaged over probes: reverse mode (`ADMode.VJP`) from
    eps^T J, forward mode (`ADMode.JVP`) from J eps.  eps is (K, B, dz),
    fixed over the trajectory.  The products go through `torch.func.vjp` /
    `torch.func.jvp`, so the field is differentiable again (the adjoint
    takes its VJP) and runs under `torch.no_grad()` in the forward solve."""
    from torch.func import jvp, vjp

    def field(ps, z, ys, eps):
        f = lambda zz: _batch_apply(nn_apply, ps, zz, ys)  # noqa: E731
        if ad == ADMode.VJP:
            dz, vjp_fn = vjp(f, z)
            eJ = torch.stack([vjp_fn(e)[0] for e in eps])  # (K, B, dz)
        else:
            dz, Je0 = jvp(f, (z,), (eps[0],))
            eJ = torch.stack([Je0] + [jvp(f, (z,), (e,))[1] for e in eps[1:]])  # J eps, (K, B, dz)
        tr_est = torch.mean(torch.sum(eJ * eps, dim=-1), dim=0)
        n_rate = torch.mean(safe_norm(eJ), dim=0)
        return dz, tr_est, n_rate

    return field


def make_augmented_dynamics(
    nn,
    mode: Mode,
    compute_mode: ComputeMode,
    norm_z: bool,
    norm_j: bool,
    passive_aug_dims: int = 0,
):
    """Build the ODE right-hand side `f(t, state, args)`; `args["ps"]` holds
    the net's params tree, `args.get("ys")` the conditioning (or None) and,
    in TRAIN mode, `args["eps"]` the (K, B, dz) probes.

    TEST mode on Dense/tanh chains: the closed-form 2-layer trace for tanh
    MLPs with biases, the chain product for any other tanh-or-identity chain.
    TRAIN mode: the Hutchinson estimator with reverse-mode (VJP, eps^T J)
    or forward-mode (JVP, J eps) probes, and the RNODE rates ||f|| (norm_z)
    and the probe norm ||eps^T J|| or ||J eps|| (norm_j); with
    `compute_mode.exact_trace` the exact trace and ||J||_F instead (Dense
    chains only; `args["eps"]` is not read).
    """
    if passive_aug_dims:
        raise NotImplementedError(f"passive augmentation is not ported yet {_ITEM14}")
    if mode == Mode.TEST:
        return _test_field(nn)
    if compute_mode.exact_trace:
        return _exact_train_field(nn, norm_z, norm_j)
    from ..ops.fused_dynamics import fused_tanh_mlp_dynamics, supports_fusion

    hutch = _hutchinson_field(nn.apply, compute_mode.ad)

    def pack(dz, tr_est, e_rate, n_rate):
        zero = torch.zeros_like(tr_est)
        return TrainState(
            z=dz,
            dlogp=-tr_est,
            reg_e=e_rate if norm_z else zero,
            reg_n=n_rate if norm_j else zero,
        )

    fused_field = compute_mode.fused and compute_mode.ad == ADMode.VJP and compute_mode.num_probes == 1
    if fused_field and supports_fusion(nn):

        def f_train_fused(t, state: TrainState, args):
            # The per-stage kernel (K10): every stage of a TRAIN solve that
            # the whole-solve kernels do not take (DIRECT, fixed steps,
            # float64); those take their Hairer pick on f_train.
            if args.get("ys") is not None:
                # The unconditional net only, as in the JAX package
                # (:353-362): a conditional call runs the Hutchinson field.
                dz, tr_est, n_rate = hutch(args["ps"], state.z, args["ys"], args["eps"])
                return pack(dz, tr_est, safe_norm(dz) if norm_z else None, n_rate)
            return pack(*fused_tanh_mlp_dynamics(args["ps"], state.z, args["eps"][0]))

        return f_train_fused

    def f_train(t, state: TrainState, args):
        dz, tr_est, n_rate = hutch(args["ps"], state.z, args.get("ys"), args["eps"])
        return pack(dz, tr_est, safe_norm(dz) if norm_z else None, n_rate)

    return f_train


def exact_tanh_mlp_trace_fro(params, z: torch.Tensor):
    """Closed-form (y, tr J, ||J||_F) of a 2-layer tanh MLP per sample.

    With m[b, i, j] = sum_h W1[i, h] dh_h W2[h, j], J_ij = m_ij dy_j, so
    tr J = sum_i m_ii dy_i and ||J||_F^2 = sum_ij m_ij^2 dy_j^2.  All dz^2
    inner sums are one (B, H) @ (H, dz^2) product, as in the JAX package."""
    (p1, p2) = params
    w1, b1, w2, b2 = p1["w"], p1["b"], p2["w"], p2["b"]
    dz = w1.shape[0]
    h = torch.tanh(z @ w1 + b1)
    y = torch.tanh(h @ w2 + b2)
    dh = 1.0 - h * h
    dy = 1.0 - y * y
    p2m = (w1.T[:, :, None] * w2[:, None, :]).reshape(w1.shape[1], dz * dz)
    m = (dh @ p2m).reshape(-1, dz, dz)
    tr = torch.einsum("bii,bi->b", m, dy)
    fro2 = torch.einsum("bij,bj->b", m * m, dy * dy)
    return y, tr, safe_sqrt(fro2)


def _chain_or_refuse(nn, what: str) -> None:
    from ..ops.fused_dynamics import is_dense_tanh_chain

    if not is_dense_tanh_chain(nn):
        raise NotImplementedError(
            f"{what} for {type(nn).__name__} (Planar and the generic identity-basis fields) "
            "are not ported yet (ROADMAP queue 1, item 16)"
        )


def _exact_train_field(nn, norm_z: bool, norm_j: bool):
    """TRAIN with the exact divergence and the exact ||J||_F rate: the closed
    form for unconditional 2-layer tanh MLPs, the chain Jacobian for other
    Dense chains and for conditional calls."""
    from ..ops.fused_dynamics import exact_dense_chain_jacobian, supports_fusion

    _chain_or_refuse(nn, "exact-trace TRAIN dynamics")
    closed_form = supports_fusion(nn)

    def f_train_exact(t, state: TrainState, args):
        ys = args.get("ys")
        if closed_form and ys is None:
            dz, tr, fro = exact_tanh_mlp_trace_fro(args["ps"], state.z)
        else:
            dz, jac = exact_dense_chain_jacobian(nn, args["ps"], state.z, ys)
            tr = torch.diagonal(jac, dim1=-2, dim2=-1).sum(-1)
            fro = safe_norm(jac.reshape(jac.shape[0], -1))
        zero = torch.zeros_like(tr)
        return TrainState(
            z=dz,
            dlogp=-tr,
            reg_e=safe_norm(dz) if norm_z else zero,
            reg_n=fro if norm_j else zero,
        )

    return f_train_exact


def _test_field(nn):
    """TEST: the closed-form trace for unconditional 2-layer tanh MLPs, the
    chain product for other Dense chains and for conditional calls."""
    from ..ops.fused_dynamics import exact_dense_chain_trace, exact_tanh_mlp_trace, supports_fusion

    _chain_or_refuse(nn, "TEST dynamics")
    closed_form = supports_fusion(nn)

    def f_test(t, state: TestState, args):
        ys = args.get("ys")
        if closed_form and ys is None:
            dz, tr = exact_tanh_mlp_trace(args["ps"], state.z)
        else:
            dz, tr = exact_dense_chain_trace(nn, args["ps"], state.z, ys)
        return TestState(z=dz, dlogp=-tr)

    return f_test


__all__ = ["TestState", "TrainState", "safe_norm", "safe_sqrt", "exact_tanh_mlp_trace_fro", "make_augmented_dynamics"]
