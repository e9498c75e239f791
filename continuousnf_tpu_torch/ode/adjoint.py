"""Continuous adjoint (backsolve) differentiation of the ODE solve.

Port of `continuousnf_tpu/ode/adjoint.py:37-192`, `backward_stats_flat`
included.  The backward pass
re-integrates the state together with the adjoint ODE

    dy/dt = f(t, y, p),   da/dt = -(df/dy)^T a,   dg/dt = -(df/dp)^T a

from t1 down to t0 with the same adaptive solver: memory does not grow with
the number of forward steps.  `_Backsolve` is a `torch.autograd.Function`
over the flat state, the two end times and the tensor leaves of `args`
(the net's params, the conditioning ys of a conditional model and the
Hutchinson probes).  The ys cotangent is integrated like the params' (in
the plain backward, in the one error norm of the whole augmented state, as
in the JAX package) and comes back in the shape of the ys given.

The probes are Monte-Carlo constants: their cotangent is zero and is never
integrated.  With a fused solve that has a backward kernel
(`FullSolve.adjoint`, K2 on the card) the backward integration runs there,
warm-started from the forward solve's last step size; otherwise each stage's
VJP comes from `torch.autograd.grad` of the plain field and the initial step
is Hairer's pick over the whole augmented state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

import torch

from ..types import Adjoint, SolverOptions


def _forward_opts(opts: SolverOptions) -> SolverOptions:
    return dataclasses.replace(opts, adjoint=Adjoint.NONE)


class _Leaf(int):
    """Position of a tensor leaf in a flattened tree."""


def flatten_tree(tree) -> Tuple[List[torch.Tensor], Callable]:
    """The tensor leaves of a tree of dicts, tuples and lists (None and
    other non-tensors are kept as they are), and the map from a list of
    leaves back to the tree."""
    leaves: List[torch.Tensor] = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            return _Leaf(len(leaves) - 1)
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(walk(v) for v in x)
        return x

    skeleton = walk(tree)

    def rebuild(new_leaves, node=skeleton):
        if isinstance(node, _Leaf):
            return new_leaves[node]
        if isinstance(node, dict):
            return {k: rebuild(new_leaves, v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(rebuild(new_leaves, v) for v in node)
        return node

    return leaves, rebuild


@dataclasses.dataclass
class _Problem:
    """What the autograd Function needs besides tensors; `stats` receives the
    forward solve's SolveStats."""

    func_flat: Callable
    opts: SolverOptions
    full_solve: Any
    rebuild: Callable
    eps_leaf: int  # index of the probe leaf, -1 if none
    stats: Any = None


class _Backsolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, prob: _Problem, y0f, t0, t1, *leaves):
        from .solve import _solve_forward_flat

        args = prob.rebuild(list(leaves))
        if prob.full_solve is not None:
            yf, stats = prob.full_solve.forward(y0f, t0, t1, args)
        else:
            yf, stats = _solve_forward_flat(prob.func_flat, _forward_opts(prob.opts), y0f, t0, t1, args)
        prob.stats = stats
        ctx.prob = prob
        ctx.save_for_backward(yf, t0, t1, *leaves)
        return yf

    @staticmethod
    def backward(ctx, g_y):
        yT, t0, t1, *leaves = ctx.saved_tensors
        need = ctx.needs_input_grad
        a_y0, dt0, dt1, g_leaves, _ = _backward_integrate(
            ctx.prob, yT, t0, t1, leaves, g_y, need_t0=need[2], need_t1=need[3]
        )
        return (None, a_y0, dt0, dt1, *g_leaves)


def _backward_integrate(prob: _Problem, yT, t0, t1, leaves, g_y, need_t0: bool, need_t1: bool):
    """The BACKSOLVE backward integration.  Returns (a_y0, dL/dt0, dL/dt1,
    the cotangents of `leaves`, its SolveStats); the time cotangents are
    None unless asked for."""
    from .solve import _solve_forward_flat

    args = prob.rebuild(list(leaves))
    f_of = lambda t, y: prob.func_flat(y, t, args)
    # dL/dt1 = <g, f(y(t1), t1)>
    dt1 = torch.sum(g_y * f_of(t1, yT)).to(t1.dtype) if need_t1 else None

    fs = prob.full_solve
    if fs is not None and fs.adjoint is not None:
        dt_warm = getattr(prob.stats, "dt_last", None)
        y0_rec, a_y0, g_args, stats = fs.adjoint(yT, g_y, args, t1, t0, dt_warm=dt_warm)
        g_leaves, _ = flatten_tree(g_args)
    else:
        n = yT.numel()
        diff = [i for i in range(len(leaves)) if i != prob.eps_leaf]
        sizes = [leaves[i].numel() for i in diff]

        def aug_flat(augf, t, _):
            with torch.enable_grad():
                y = augf[:n].detach().requires_grad_()
                lv = list(leaves)
                for i in diff:
                    lv[i] = leaves[i].detach().requires_grad_()
                f = prob.func_flat(y, t, prob.rebuild(lv))
                grads = torch.autograd.grad(f, [y] + [lv[i] for i in diff], augf[n : 2 * n], allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, [y] + [lv[i] for i in diff])]
            return torch.cat([f.detach()] + [-g.reshape(-1) for g in grads])

        aug0 = torch.cat([yT, g_y] + [torch.zeros(s, dtype=yT.dtype, device=yT.device) for s in sizes])
        augT, stats = _solve_forward_flat(aug_flat, _forward_opts(prob.opts), aug0, t1, t0, None)
        y0_rec, a_y0 = augT[:n], augT[n : 2 * n]
        g_leaves = list(leaves)
        for i, part in zip(diff, torch.split(augT[2 * n :], sizes)):
            g_leaves[i] = part.reshape(leaves[i].shape)
    if prob.eps_leaf >= 0:
        g_leaves[prob.eps_leaf] = torch.zeros_like(leaves[prob.eps_leaf])
    # dL/dt0 = -<a(t0), f(y(t0), t0)>
    dt0 = (-torch.sum(a_y0 * f_of(t0, y0_rec))).to(t0.dtype) if need_t0 else None
    return a_y0, dt0, dt1, g_leaves, stats


def _problem(func_flat, opts: SolverOptions, args, full_solve) -> Tuple[_Problem, List[torch.Tensor]]:
    leaves, rebuild = flatten_tree(args)
    eps = args.get("eps") if isinstance(args, dict) else None
    eps_leaf = next((i for i, x in enumerate(leaves) if x is eps), -1)
    return _Problem(func_flat, opts, full_solve, rebuild, eps_leaf), leaves


def backward_stats_flat(func_flat, opts: SolverOptions, yTf, t0, t1, args, g_yf, full_solve=None, fwd_stats=None):
    """The SolveStats of the BACKSOLVE backward integration from the final
    state `yTf` with the cotangent `g_yf`: the integration `_Backsolve`'s
    backward runs (the fused adjoint member when there is one, warm-started
    from `fwd_stats.dt_last`, else the plain one), run again with its stats
    kept, which a backward cannot return.  The same inputs give the same
    adaptive grid."""
    prob, leaves = _problem(func_flat, opts, args, full_solve)
    prob.stats = fwd_stats
    with torch.no_grad():
        return _backward_integrate(prob, yTf, t0, t1, leaves, g_yf, need_t0=False, need_t1=False)[4]


def odeint_backsolve_flat(func_flat, opts: SolverOptions, y0f, t0, t1, args, full_solve=None):
    """The BACKSOLVE solve of `odeint_with_stats` on the flat state:
    (yTf, stats), differentiable in y0f, t0, t1 and the tensors of `args`.

    `full_solve`, when given, replaces the forward solve, and its `adjoint`
    member (when not None) the backward integration."""
    prob, leaves = _problem(func_flat, opts, args, full_solve)
    yf = _Backsolve.apply(prob, y0f, t0, t1, *leaves)
    return yf, prob.stats


__all__ = ["odeint_backsolve_flat", "backward_stats_flat", "flatten_tree"]
