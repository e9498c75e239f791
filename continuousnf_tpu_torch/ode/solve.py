"""Adaptive and fixed-step explicit RK integration.

Port of `continuousnf_tpu/ode/solve.py`: the tableau steps, the controller
and the adaptive and fixed-step loops (:45-336), the dispatch of
`odeint_with_stats` with its tstops segments (:411-477), `backsolve_stats`
(:480-517), `odeint_saveat` (:520-559) and `odeint` (:562-572).  The state
is one flat vector (a `TestState` is flattened to `[z.ravel() | dlogp]`, a
`TrainState` to `[z.ravel() | dlogp | reg_e | reg_n]`, batch-major, the
order of the JAX package's `ravel_pytree`), and one error norm covers the
whole flat state: the step control is batch-global.

The loop is eager PyTorch: each attempted step reads its loop condition on
the host.  The solve-in-kernel path (`full_solve`, `ops/fused_solve.py`)
replaces it with one kernel launch.  Gradients flow through the BACKSOLVE
adjoint (`ode/adjoint.py`) or, under `Adjoint.DIRECT` and for fixed-step
solves (under every adjoint, as in the JAX package), through the loop
itself: autograd records each attempted step (discretize-then-optimize).
`Adjoint.NONE` solves are forward only and raise when their inputs require
grad.
"""

from __future__ import annotations

import dataclasses
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
    dt_used: Any = None  # the step of the last attempt


class SolveStats(NamedTuple):
    steps: Any  # total attempted steps
    accepted: Any  # accepted steps
    nfe: Any  # vector-field evaluations
    dt_last: Any = None  # final step size (None where not tracked)
    dt_used: Any = None  # the step of the last attempt (None where not tracked)


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
    t, y, dt, k1, eest_prev, steps, accepted, _ = state
    beta1, beta2 = _controller_factors(tab.order)

    remaining = torch.abs(t1 - t)
    is_last = torch.abs(dt) >= remaining
    dt_use = tdir * torch.minimum(torch.abs(dt), remaining)

    y_new, (err, err3), k_last = _rk_step(f, tab, t, dt_use, y, k1)
    # The error estimate drives only control flow (accept, the next step
    # size) and carries no gradient, as in the JAX package: through a
    # recorded (DIRECT) step it would reach the cotangents through
    # sqrt(mean(err^2)), whose derivative is infinite where err is 0.
    eest = _error_estimate(err, y, y_new, rtol, atol).detach()
    if err3 is not None:
        # Hairer's stretched 8(5,3) estimate (dop853.f).
        e3 = _error_estimate(err3, y, y_new, rtol, atol).detach()
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
        dt_used=dt_use,
    )


def _solve_adaptive_while(f, tab: ButcherTableau, y0, t0, t1, rtol, atol, max_steps, dt0):
    """Adaptive solve of at most `max_steps` attempted steps.  `dt0` is None
    (Hairer pick) or a step size (number or 0-d tensor); its sign is taken
    from the direction t0 -> t1.  With grad enabled autograd records every
    attempted step, the Hairer pick and each `dt_use` included: the DIRECT
    path (the JAX package's `_solve_adaptive_scan`, :268-313, which masks
    the steps after t1 where this loop stops, to the same values)."""
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
        dt_used=torch.zeros((), dtype=y0.dtype, device=y0.device),
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
        dt_used=state.dt_used,
    )
    return state.y, stats


def _solve_fixed(f, tab: ButcherTableau, y0, t0, t1, num_steps: int):
    """Fixed-step integration (`SolverOptions.fixed_num_steps`), recorded by
    autograd under grad (`_solve_fixed_scan`, :316-336)."""
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
        # The DIRECT path: the same adaptive grid, capped at
        # direct_max_steps attempts; it does not track dt_last.
        yf, stats = _solve_adaptive_while(
            f, tab, y0f, t0, t1, opts.rtol, opts.atol, opts.direct_max_steps, opts.dt0
        )
        return yf, stats._replace(dt_last=None, dt_used=None)
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


def needs_grad(*trees) -> bool:
    """True when autograd would record a graph through these tensors."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in _tensors(trees))


def forbid_grad(*trees) -> None:
    """Raise when autograd would have to record a graph through an
    `Adjoint.NONE` solve, which has no backward (nor in the JAX package)."""
    if needs_grad(*trees):
        raise NotImplementedError(
            "an Adjoint.NONE solve is forward only; differentiate with Adjoint.BACKSOLVE or "
            "Adjoint.DIRECT, or run it under torch.no_grad()"
        )


def _sum_stats(a: Optional[SolveStats], b: SolveStats) -> SolveStats:
    """Stats of two chained solves: the counts summed, the second's dt_last
    and dt_used."""
    if a is None:
        return b
    return b._replace(steps=a.steps + b.steps, accepted=a.accepted + b.accepted, nfe=a.nfe + b.nfe)


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


def _flat_problem(func, y0, t0, t1):
    """The flat initial state, its inverse map, the end times as tensors of
    its type and device, and `func` on the flat state."""
    y0f, unravel = _ravel(y0)

    def func_flat(yf, t, args_):
        return _ravel(func(t, unravel(yf), args_))[0]

    as_t = lambda t: torch.as_tensor(t, dtype=y0f.dtype, device=y0f.device)  # noqa: E731
    return y0f, unravel, as_t(t0), as_t(t1), func_flat


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

    Gradients: BACKSOLVE adaptive solves by the continuous adjoint; DIRECT
    and fixed-step solves (any adjoint) through the recorded loop; NONE
    solves raise.  `full_solve`, when given, replaces the adaptive forward
    solve on the flat state (`full_solve.forward(y0f, t0, t1, args) ->
    (yTf, stats)`, the solve-in-kernel path) under BACKSOLVE and NONE and,
    under BACKSOLVE, the backward integration (`full_solve.adjoint`; when it
    is None the plain backward runs).  The DIRECT and fixed-step paths
    ignore it, as in the JAX package.

    `opts.tstops` (interior times in the direction of integration) chain
    segment solves at each stop, each with `full_solve`; the stats sum the
    segments' counts and keep the last segment's dt_last.
    """
    if getattr(opts, "tstops", None):
        seg_opts = dataclasses.replace(opts, tstops=None)
        grid = [t0, *opts.tstops, t1]
        y, stats = y0, None
        for ta, tb in zip(grid[:-1], grid[1:]):
            y, st = odeint_with_stats(func, y, ta, tb, args, seg_opts, full_solve=full_solve)
            stats = _sum_stats(stats, st)
        return y, stats
    y0f, unravel, t0, t1, func_flat = _flat_problem(func, y0, t0, t1)
    if opts.fixed_num_steps is None and opts.adjoint == Adjoint.BACKSOLVE:
        from .adjoint import odeint_backsolve_flat

        yf, stats = odeint_backsolve_flat(func_flat, opts, y0f, t0, t1, args, full_solve)
        return unravel(yf), stats
    if opts.fixed_num_steps is None and opts.adjoint == Adjoint.NONE:
        forbid_grad(y0f, args)
        if full_solve is not None:
            yf, stats = full_solve.forward(y0f, t0, t1, args)
            return unravel(yf), stats
    yf, stats = _solve_forward_flat(func_flat, opts, y0f, t0, t1, args)
    return unravel(yf), stats


def backsolve_stats(
    func: Callable[[torch.Tensor, Any, Any], Any],
    y0: Any,
    t0,
    t1,
    args: Any,
    cotangent_fn: Callable[[Any], torch.Tensor],
    opts: SolverOptions = SolverOptions(),
    full_solve=None,
):
    """The forward solve and the statistics of the BACKSOLVE backward
    integration for the gradient of `cotangent_fn(yT_state)` (a scalar):
    the forward as the BACKSOLVE path runs it (`full_solve.forward` when
    given), the cotangent of the final state from `cotangent_fn`, and the
    same backward integration `_Backsolve` runs (`full_solve.adjoint` when
    there is one, warm-started from the forward's dt_last), with its stats
    kept.  Returns (yT_state, fwd_stats, bwd_stats)."""
    from .adjoint import _forward_opts, backward_stats_flat

    y0f, unravel, t0, t1, func_flat = _flat_problem(func, y0, t0, t1)
    with torch.no_grad():
        if full_solve is not None:
            yTf, fwd_stats = full_solve.forward(y0f, t0, t1, args)
        else:
            yTf, fwd_stats = _solve_forward_flat(func_flat, _forward_opts(opts), y0f, t0, t1, args)
    with torch.enable_grad():
        yv = yTf.detach().requires_grad_()
        (g_yf,) = torch.autograd.grad(cotangent_fn(unravel(yv)), [yv])
    bwd_stats = backward_stats_flat(func_flat, opts, yTf, t0, t1, args, g_yf, full_solve, fwd_stats)
    return unravel(yTf), fwd_stats, bwd_stats


def odeint_saveat(
    func: Callable[[torch.Tensor, Any, Any], Any],
    y0: Any,
    t_grid,
    args: Any = None,
    opts: SolverOptions = SolverOptions(),
    full_solve=None,
):
    """Integrate over the time grid `t_grid` (T + 1 points, both endpoints
    included) by chained segment solves, each with `full_solve` and a fresh
    step controller.  Returns (states, stats): each leaf of `states` gains a
    leading time axis of length T + 1 (states[0] is y0), and `stats` sums
    the segments' counts (dt_last: the last segment's)."""
    states, stats, y = [y0], None, y0
    for ta, tb in zip(t_grid[:-1], t_grid[1:]):
        y, st = odeint_with_stats(func, y, ta, tb, args, opts, full_solve=full_solve)
        states.append(y)
        stats = _sum_stats(stats, st)
    if isinstance(y0, torch.Tensor):
        return torch.stack(states), stats
    stacked = [torch.stack(leaves) for leaves in zip(*states)]
    return (type(y0)(*stacked) if hasattr(y0, "_fields") else type(y0)(stacked)), stats


def odeint(
    func: Callable[[torch.Tensor, Any, Any], Any],
    y0: Any,
    t0,
    t1,
    args: Any = None,
    opts: SolverOptions = SolverOptions(),
):
    """`odeint_with_stats` without the stats: the final state."""
    return odeint_with_stats(func, y0, t0, t1, args, opts)[0]


__all__ = [
    "odeint",
    "odeint_with_stats",
    "odeint_saveat",
    "backsolve_stats",
    "SolveStats",
    "forbid_grad",
    "needs_grad",
]
