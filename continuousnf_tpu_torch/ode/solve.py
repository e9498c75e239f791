"""Adaptive and fixed-step explicit RK integration, forward only.

Port of `continuousnf_tpu/ode/solve.py:45-265` and `:411-477`.  The state is
one flat vector (a `TestState` is flattened to `[z.ravel() | dlogp]`,
batch-major, the order of the JAX package's `ravel_pytree`), and one error
norm covers the whole flat state: the step control is batch-global.

The loop is eager PyTorch: each attempted step reads its loop condition on
the host.  The solve-in-kernel path (`full_solve`, `ops/fused_solve.py`)
replaces it with one kernel launch.  Gradients through the solve are not
ported yet (the BACKSOLVE adjoint is ROADMAP queue 1, item 6): a solve whose
inputs require grad raises.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from ..types import Adjoint, SolverOptions
from .tableaus import ButcherTableau, get_tableau

# Step-size controller constants (Hairer / OrdinaryDiffEq-style values); the
# CUDA kernel in ops/csrc/k3_test_solve.cu uses the same numbers.
_SAFETY = 0.9
_QMIN = 0.2
_QMAX = 10.0
_EEST_FLOOR = 1.0e-4


class StepState(NamedTuple):
    """Carry of the adaptive loop."""

    t: torch.Tensor
    y: torch.Tensor
    dt: torch.Tensor
    k1: torch.Tensor  # f(t, y), the FSAL register
    eest_prev: torch.Tensor
    steps: int
    accepted: torch.Tensor


class SolveStats(NamedTuple):
    steps: Any  # total attempted steps
    accepted: Any  # accepted steps
    nfe: Any  # vector-field evaluations
    dt_last: Any = None  # final step size (None where not tracked)


def _rms_norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(torch.square(x)))


def _error_estimate(err, y, y_new, rtol, atol) -> torch.Tensor:
    """Hairer scaled error norm: sqrt(mean((err / (atol + rtol*max(|y|,|y_new|)))^2))."""
    sc = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y_new))
    return _rms_norm(err / sc)


def _rk_step(f, tab: ButcherTableau, t, dt, y, k1):
    """One explicit RK step.  Returns (y_new, (err, err3), k_last); zero
    coefficients are skipped, as in the JAX package."""

    def weighted(ws):
        acc = torch.zeros_like(y)
        for i, wi in enumerate(ws):
            if wi != 0.0:
                acc = acc + (dt * wi) * ks[i]
        return acc

    ks = [k1]
    for i in range(1, tab.num_stages):
        yi = y
        for j, aij in enumerate(tab.a[i]):
            if aij != 0.0:
                yi = yi + (dt * aij) * ks[j]
        ks.append(f(t + tab.c[i] * dt, yi))
    y_new = y
    for i, bi in enumerate(tab.b):
        if bi != 0.0:
            y_new = y_new + (dt * bi) * ks[i]
    err = weighted(tab.btilde) if tab.btilde is not None else torch.zeros_like(y)
    err3 = weighted(tab.btilde3) if tab.btilde3 is not None else None
    return y_new, (err, err3), ks[-1]


def _nfe_per_attempt(tab: ButcherTableau) -> int:
    """Field evaluations inside one attempted step (stage-1 FSAL reuse
    excluded; the non-FSAL refresh is counted by the caller)."""
    return tab.num_stages - 1


def _initial_step_size(f, t0, y0, f0, tdir, order: int, rtol, atol, t_span_len) -> torch.Tensor:
    """Hairer's automatic initial step selection (Hairer, Norsett, Wanner II.4)."""
    sc = atol + rtol * torch.abs(y0)
    d0 = _rms_norm(y0 / sc)
    d1 = _rms_norm(f0 / sc)
    small = 1e-6
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), small, 0.01 * d0 / d1)
    h0 = torch.minimum(h0, t_span_len)
    y1 = y0 + tdir * h0 * f0
    f1 = f(t0 + tdir * h0, y1)
    d2 = _rms_norm((f1 - f0) / sc) / h0
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(
        dmax <= 1e-15,
        torch.clamp(h0 * 1e-3, min=small),
        (0.01 / dmax) ** (1.0 / (order + 1)),
    )
    h = torch.minimum(torch.minimum(100.0 * h0, h1), t_span_len)
    return (tdir * h).to(y0.dtype)


def _controller_factors(order: int):
    """PI controller exponents (OrdinaryDiffEq-style defaults for explicit RK)."""
    return 7.0 / (10.0 * order), 2.0 / (5.0 * order)


def _attempt_step(f, tab: ButcherTableau, state: StepState, t1, tdir, rtol, atol) -> StepState:
    """Accept/reject plus the PI controller for one attempted step."""
    t, y, dt, k1, eest_prev, steps, accepted = state
    beta1, beta2 = _controller_factors(tab.order)

    remaining = torch.abs(t1 - t)
    is_last = torch.abs(dt) >= remaining
    dt_use = tdir * torch.minimum(torch.abs(dt), remaining)

    y_new, (err, err3), k_last = _rk_step(f, tab, t, dt_use, y, k1)
    eest = _error_estimate(err, y, y_new, rtol, atol)
    if err3 is not None:
        # Hairer's stretched 8(5,3) estimate (dop853.f).
        e3 = _error_estimate(err3, y, y_new, rtol, atol)
        denom = torch.sqrt(torch.square(eest) + 0.01 * torch.square(e3))
        eest = torch.where(denom > 0.0, torch.square(eest) / torch.clamp(denom, min=1e-30), eest)
    finite = torch.isfinite(eest) & torch.all(torch.isfinite(y_new))
    accept = (eest <= 1.0) & finite

    eest_c = torch.clamp(eest, min=_EEST_FLOOR)
    q_acc = _SAFETY * eest_c ** (-beta1) * eest_prev ** beta2
    q_acc = torch.where(torch.isfinite(q_acc), q_acc, _QMIN)
    q_rej = _SAFETY * eest_c ** (-1.0 / tab.order)
    q_rej = torch.where(torch.isfinite(q_rej) & finite, q_rej, _QMIN)
    dt_next = torch.where(
        accept,
        dt_use * torch.clamp(q_acc, _QMIN, _QMAX),
        dt_use * torch.clamp(q_rej, _QMIN, 1.0),
    )

    t_next = torch.where(accept, torch.where(is_last, t1, t + dt_use), t)
    y_next = torch.where(accept, y_new, y)
    if tab.fsal:
        k1_next = torch.where(accept, k_last, k1)
    else:
        # Non-FSAL: f at the (possibly unchanged) point, one more NFE.
        k1_next = torch.where(accept, f(t_next, y_next), k1)
    return StepState(
        t=t_next,
        y=y_next,
        dt=dt_next,
        k1=k1_next,
        eest_prev=torch.where(accept, eest_c, eest_prev),
        steps=steps + 1,
        accepted=accepted + accept.to(accepted.dtype),
    )


def _solve_adaptive_while(f, tab: ButcherTableau, y0, t0, t1, rtol, atol, max_steps, dt0):
    """Forward adaptive solve.  `dt0` is None (Hairer pick) or a step size
    (number or 0-d tensor); its sign is taken from the direction t0 -> t1."""
    tdir = torch.sign(t1 - t0)
    span = torch.abs(t1 - t0)

    f0 = f(t0, y0)
    if dt0 is None:
        dt_init = _initial_step_size(f, t0, y0, f0, tdir, tab.order, rtol, atol, span)
    else:
        dt_init = tdir * torch.abs(torch.as_tensor(dt0, dtype=y0.dtype, device=y0.device))

    state = StepState(
        t=t0,
        y=y0,
        dt=dt_init,
        k1=f0,
        eest_prev=torch.ones((), dtype=y0.dtype, device=y0.device),
        steps=0,
        accepted=torch.zeros((), dtype=torch.int32, device=y0.device),
    )
    while state.steps < max_steps and bool((state.t - t1) * tdir < 0):
        state = _attempt_step(f, tab, state, t1, tdir, rtol, atol)
    nfe_per = _nfe_per_attempt(tab) + (0 if tab.fsal else 1)
    steps = torch.tensor(state.steps, dtype=torch.int32, device=y0.device)
    stats = SolveStats(
        steps=steps,
        accepted=state.accepted,
        nfe=steps * nfe_per + (2 if dt0 is None else 1),
        dt_last=state.dt,
    )
    return state.y, stats


def _solve_fixed(f, tab: ButcherTableau, y0, t0, t1, num_steps: int):
    """Fixed-step integration (`SolverOptions.fixed_num_steps`)."""
    dt = (t1 - t0) / num_steps
    t, y = t0, y0
    for i in range(num_steps):
        y, _, _ = _rk_step(f, tab, t, dt, y, f(t, y))
        t = t0 + dt * (i + 1.0)
    n = torch.tensor(num_steps, dtype=torch.int32, device=y0.device)
    return y, SolveStats(steps=n, accepted=n, nfe=n * tab.num_stages)


def _solve_forward_flat(func_flat, opts: SolverOptions, y0f, t0, t1, args):
    """The plain solve on the flat state, by `SolverOptions`."""
    tab = get_tableau(opts.method, opts.rtol)

    def f(t, yf):
        return func_flat(yf, t, args)

    if opts.fixed_num_steps is not None:
        return _solve_fixed(f, tab, y0f, t0, t1, opts.fixed_num_steps)
    if tab.btilde is None:
        raise ValueError(
            f"method {opts.method!r} has no embedded error estimate; "
            "set SolverOptions.fixed_num_steps for fixed-step integration"
        )
    if opts.adjoint == Adjoint.DIRECT:
        # The forward of the DIRECT path: the same adaptive grid, capped at
        # direct_max_steps attempts; it does not track dt_last.
        yf, stats = _solve_adaptive_while(
            f, tab, y0f, t0, t1, opts.rtol, opts.atol, opts.direct_max_steps, opts.dt0
        )
        return yf, stats._replace(dt_last=None)
    return _solve_adaptive_while(
        f, tab, y0f, t0, t1, opts.rtol, opts.atol, opts.max_steps, opts.dt0
    )


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def forbid_grad(*trees) -> None:
    """Raise when autograd would have to record a graph through the solve:
    gradients (the BACKSOLVE adjoint) are not ported yet."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in _tensors(trees)):
        raise NotImplementedError(
            "gradients through the ODE solve (the BACKSOLVE adjoint) are not ported "
            "yet (ROADMAP queue 1, item 6); run under torch.no_grad() or detach inputs"
        )


def _ravel(y0) -> Tuple[torch.Tensor, Callable]:
    """Flatten a tensor or a (named) tuple of tensors to one vector, leaf by
    leaf in order; return it and the inverse map."""
    if isinstance(y0, torch.Tensor):
        shape = y0.shape
        return y0.reshape(-1), lambda yf: yf.reshape(shape)
    shapes = [leaf.shape for leaf in y0]
    sizes = [leaf.numel() for leaf in y0]

    def unravel(yf):
        parts = [p.reshape(s) for p, s in zip(torch.split(yf, sizes), shapes)]
        return type(y0)(*parts) if hasattr(y0, "_fields") else type(y0)(parts)

    return torch.cat([leaf.reshape(-1) for leaf in y0]), unravel


def odeint_with_stats(
    func: Callable[[torch.Tensor, Any, Any], Any],
    y0: Any,
    t0,
    t1,
    args: Any = None,
    opts: SolverOptions = SolverOptions(),
    full_solve=None,
):
    """Integrate `dy/dt = func(t, y, args)` from t0 to t1 (t1 < t0 runs
    backward).  Returns the final state and `SolveStats`.

    `full_solve`, when given, replaces the adaptive forward solve on the flat
    state (`full_solve.forward(y0f, t0, t1, args) -> (yTf, stats)`, the
    solve-in-kernel path).  The DIRECT and fixed-step paths ignore it, as in
    the JAX package.
    """
    if getattr(opts, "tstops", None):
        raise NotImplementedError("tstops are not ported yet (ROADMAP queue 1, item 15)")
    forbid_grad(y0, args)
    y0f, unravel = _ravel(y0)
    t0 = torch.as_tensor(t0, dtype=y0f.dtype, device=y0f.device)
    t1 = torch.as_tensor(t1, dtype=y0f.dtype, device=y0f.device)

    def func_flat(yf, t, args_):
        return _ravel(func(t, unravel(yf), args_))[0]

    if full_solve is not None and opts.fixed_num_steps is None and opts.adjoint != Adjoint.DIRECT:
        yf, stats = full_solve.forward(y0f, t0, t1, args)
    else:
        yf, stats = _solve_forward_flat(func_flat, opts, y0f, t0, t1, args)
    return unravel(yf), stats


__all__ = ["odeint_with_stats", "SolveStats", "forbid_grad"]
