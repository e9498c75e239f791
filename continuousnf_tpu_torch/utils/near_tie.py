"""Near-ties of the step controller, and the diagnostic that finds them.

With one state dimension (the conditional recipe: dz = 1) the norm rates
|f| and |eps^T J| have kinks where f or J crosses zero.  The error estimate
of a step across a kink, and with it the next step size, can then depend on
the last bits of the state: a kernel and its plain twin, or the twin on the
card and on the CPU, which sum in other orders, take different step grids
(another attempted step count, or the same count with the accumulated
norms apart by more than 1e-4).  `roundoff_witness` measures how far a
solve's own result moves under roundoff: its twin run again from inputs
(the state, the probe, ys, the weights, the span and the first step size)
whose every element is moved one float32 ulp up or down at random.  Only on an input whose witness shows
such a move is a kernel let differ from its twin by more than the usual
bound, and then by at most four times the twin's own move.

A second kind of tie sits at the end of a forward solve: where the planned
step falls within roundoff of the remaining span, one solve reaches t1 in
one step and the other stops short of it and takes one more, short step.
The forward kernels and their twins return the last step they took
(`dt_used`) beside the next step size; `last_step_tie` reads it.

    python -m continuousnf_tpu_torch.utils.near_tie [--cases recipe-B1,recipe-B128]

runs, on one CUDA card, the conditional chain kernels (the K1 chain form,
K7 TEST and exact, the K2 chain form from the K1 chain form's output) on the
inputs of the conditional cases of tests/test_torch_cuda.py, with the norm
rates on and off, and prints for each solve the attempted and accepted
steps, the next step size and the last step taken of the kernel, of its
twin on the card and of its twin on the CPU, their relative distances from each other and from the
float64 twin, and two witnesses of the twin on the card: with only z0 (zT)
nudged, and with every input nudged.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch


def rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max|got - ref| / max(1, max|ref|), in float64 on got's device."""
    got, ref = got.double(), ref.to(device=got.device, dtype=torch.float64)
    return float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))


def nudge(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """`x` with each element moved one ulp of its dtype, up or down at random
    (the signs drawn on the CPU from `generator`)."""
    up = (torch.rand(x.shape, generator=generator) < 0.5).to(x.device)
    inf = torch.full_like(x, math.inf)
    return torch.where(up, torch.nextafter(x, inf), torch.nextafter(x, -inf))


def is_forward(out) -> bool:
    """Whether `out` is a forward solve's output (zT, accT, steps,
    accepted, dt_last, dt_used), not an adjoint's (seven or eight items)."""
    return len(out) < 7


def split(out):
    """(attempted steps, the tensors) of a solve's output: a forward's
    (zT, accT, steps, accepted, dt_last, dt_used) gives z and each
    accumulator row; an adjoint's (z0, acc0, a_z0, g_ws, g_bs, steps,
    accepted[, a_ys0]) gives z0, a_z0, each gradient and a_ys0."""
    if is_forward(out):
        B = out[0].shape[0]
        return int(out[2]), [out[0]] + list(out[1].reshape(-1, B))
    return int(out[5]), [out[0], out[2]] + list(out[3]) + list(out[4]) + list(out[7:])


def roundoff_witness(twin, tab, spec, kw: dict, keys=None, ref=None, n: int = 16, seed: int = 0):
    """The twin's own move under roundoff: `twin(tab, spec, **kw)` (or its
    output `ref`) against n runs with the tensors kw[k] for k in `keys`
    nudged (`nudge`; by default every tensor argument, the weights, the
    span and the first step size included).  Returns (steps, spreads): the
    attempted step counts of the n nudged runs, and for each tensor of the
    output (`split`) the largest relative distance (`rel`) of the nudged
    runs' from the unnudged run's."""
    keys = list(kw) if keys is None else keys
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        if ref is None:
            ref = twin(tab, spec, **kw)
        _, ref_values = split(ref)
        steps, spreads = [], [0.0] * len(ref_values)
        for _ in range(n):
            moved = {k: [nudge(x, gen) for x in kw[k]] if isinstance(kw[k], list) else nudge(kw[k], gen)
                     for k in keys if isinstance(kw[k], list) or torch.is_tensor(kw[k])}
            s, values = split(twin(tab, spec, **dict(kw, **moved)))
            steps.append(s)
            spreads = [max(d, rel(a, b)) for d, a, b in zip(spreads, values, ref_values)]
    return steps, spreads


def witness(twin, tab, spec, kw: dict, state: str, ref=None, n: int = 16):
    """`roundoff_witness` with the state `state` (z0, or an adjoint's zT)
    nudged alone, then with every input nudged, n runs each.  Returns the
    step counts of all 2n runs and, per tensor, the larger spread."""
    steps_z, spreads_z = roundoff_witness(twin, tab, spec, kw, [state], ref, n)
    steps_all, spreads_all = roundoff_witness(twin, tab, spec, kw, None, ref, n, seed=1)
    return steps_z + steps_all, [max(a, b) for a, b in zip(spreads_z, spreads_all)]


def shows_near_tie(ref_steps: int, steps, spreads, tol: float) -> bool:
    """Whether a witness (`witness`) shows a near-tie: a nudged run took
    another attempted step count, or moved a tensor by more than `tol`
    relative."""
    return any(s != ref_steps for s in steps) or max(spreads) > tol


def within_near_tie(out_k, out_p, steps, spreads, tol: float, grad_tol: float = None):
    """The rule for a solve whose witness shows a near-tie: the kernel's
    attempted step count within the range of the twin's own (`out_p`'s and
    the nudged runs' `steps`), and each of its tensors (`split`) within
    max(tol, 4x that tensor's spread under roundoff) of the twin's; an
    adjoint's gradients and a_ys0 with `grad_tol` for `tol`.  Returns
    (holds, the readings as a line)."""
    (sk, vk), (sp, vp) = split(out_k), split(out_p)
    counts = [sp] + list(steps)
    tols = [tol] * len(vk) if is_forward(out_k) else [tol, tol] + [grad_tol or tol] * (len(vk) - 2)
    errs = [rel(a, b) for a, b in zip(vk, vp)]
    holds = (
        min(counts) <= sk <= max(counts)
        and all(e <= max(t, 4.0 * d) for e, d, t in zip(errs, spreads, tols))
        and all(bool(torch.isfinite(a).all()) for a in vk)
    )
    line = (f"steps {sk} (the twin's own under roundoff {sorted(set(counts))}); relative distance to the twin "
            + ", ".join(f"{e:.3e} (its spread {d:.3e})" for e, d in zip(errs, spreads)))
    return holds, line


def bf16_step_gate(steps: int) -> int:
    """The attempted steps by which two solves under bf16 stage matmuls may
    part: max(2, steps // 20), the gate ROADMAP queue 3 holds dop853's
    roundoff-driven steps to.  Single-pass bf16 rounding (2^-9 relative a
    product) floods the error estimate at rtol 1e-3, so the step grid
    follows the last bits of the state."""
    return max(2, int(steps) // 20)


def within_bf16_noise(out_k, out_p, spreads, tol: float, grad_tol: float = None, steps=()):
    """The rule for a solve under bf16 stage matmuls against its twin: the
    attempted step count within `bf16_step_gate` of the twin's or within
    the range of the twin's own under roundoff (`steps`, the witness's
    counts), and each tensor (`split`) within max(tol, 4x that tensor's
    spread under roundoff), the spreads of the twin's own
    `roundoff_witness`; an adjoint's gradients with `grad_tol` for `tol`.
    Returns (holds, the readings as a line)."""
    (sk, vk), (sp, vp) = split(out_k), split(out_p)
    counts = [sp] + list(steps)
    tols = [tol] * len(vk) if is_forward(out_k) else [tol, tol] + [grad_tol or tol] * (len(vk) - 2)
    errs = [rel(a, b) for a, b in zip(vk, vp)]
    steps_hold = abs(sk - sp) <= bf16_step_gate(sp) or min(counts) <= sk <= max(counts)
    holds = (
        steps_hold
        and all(e <= max(t, 4.0 * d) for e, d, t in zip(errs, spreads, tols))
        and all(bool(torch.isfinite(a).all()) for a in vk)
    )
    line = (f"steps {sk} against {sp} (within {bf16_step_gate(sp)} or the twin's own {sorted(set(counts))}: "
            f"{steps_hold}); relative distance to the twin "
            + ", ".join(f"{e:.3e} (its spread {d:.3e})" for e, d in zip(errs, spreads)))
    return holds, line


def last_step_tie(out_k, out_p, tol: float):
    """Whether two forward solves (`is_forward`) part only at their last
    step: their attempted and their accepted step counts each differ by
    one, the solve with more steps took a last step shorter than the other's
    last step (it stopped short of t1 and took the remainder, where the
    other reached t1 at once), and z and each accumulator row agree within
    `tol` relative (`rel`).  Returns (holds, the readings as a line)."""
    (sk, vk), (sp, vp) = split(out_k), split(out_p)
    longer, shorter = (out_k, out_p) if sk > sp else (out_p, out_k)
    errs = [rel(a, b) for a, b in zip(vk, vp)]
    holds = (
        abs(sk - sp) == 1
        and abs(int(out_k[3]) - int(out_p[3])) == 1
        and abs(float(longer[5])) < abs(float(shorter[5]))
        and max(errs) <= tol
        and all(bool(torch.isfinite(a).all()) for a in vk)
    )
    line = (f"steps {sk} against {sp}; last steps taken {float(out_k[5]):.6g} against {float(out_p[5]):.6g}; "
            f"relative distance to the twin {max(errs):.3e}")
    return holds, line


# ---- the diagnostic ----

# id -> (dims, B, span): the conditional cases of tests/test_torch_cuda.py.
CASES = {
    "recipe-B1": ((2, 64, 64, 1), 1, (0.0, 13.0)),
    "recipe-B128": ((2, 64, 64, 1), 128, (0.0, 13.0)),
    "recipe-B4096": ((2, 64, 64, 1), 4096, (0.0, 13.0)),
    "recipe-reverse": ((2, 64, 64, 1), 4096, (13.0, 0.0)),
    "narrow-ncond2": ((5, 9, 7, 3), 300, (0.0, 2.0)),
    "two-layer": ((3, 16, 1), 256, (0.0, 4.0)),
}


def case_inputs(dims, B: int, span, device, seed: int = 0):
    """The inputs tests/test_torch_cuda.py gives its conditional cases:
    Glorot weights (seed), z0 ~ U[0, 1) and dlogp0 ~ N(0, 0.5^2) (seed + 1),
    the probe, accumulators ~ N(0, 0.5^2) and the adjoint's cotangents
    (seed + 2), ys ~ U(-1, 1) (seed 9).  Returns (train, test, adjoint)
    keyword arguments; the adjoint's zT, accT and dt_init come from the
    forward."""
    from .. import params_from_numpy
    from .configs import glorot_params

    ps = params_from_numpy(glorot_params(np.random.default_rng(seed), dims), device)
    dz, nc = dims[-1], dims[0] - dims[-1]
    T = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    r1, r2 = np.random.default_rng(seed + 1), np.random.default_rng(seed + 2)
    z0, dlogp0 = T(r1.uniform(size=(B, dz))), T(r1.normal(0.0, 0.5, B))
    eps, acc0 = T(r2.normal(size=(1, B, dz))), T(r2.normal(0.0, 0.5, (3, B)))
    azT, aaccT = T(r2.normal(0.0, 1.0 / B, (B, dz))), T(r2.normal(0.0, 1.0 / B, (3, B)))
    ys = T(np.random.default_rng(9).uniform(-1.0, 1.0, (B, nc)))
    t0, t1 = torch.tensor(span[0], device=device), torch.tensor(span[1], device=device)
    base = dict(rtol=1e-3, atol=1e-6, max_steps=10_000, ws=[p["w"] for p in ps], bs=[p["b"] for p in ps], ys=ys)
    dt = torch.tensor(0.05 if span[1] > span[0] else -0.05, device=device)
    train = dict(base, norm_z=True, norm_j=True, z0=z0, eps=eps, acc0=acc0, t0=t0, t1=t1, dt_init=dt)
    test = dict(base, z0=z0, dlogp0=dlogp0, t0=t0, t1=t1, dt_init=dt)
    adjoint = dict(base, norm_z=True, norm_j=True, eps=eps, azT=azT, aaccT=aaccT, t_hi=t1, t_lo=t0)
    return train, test, adjoint


def _to(kw: dict, device=None, dtype=None) -> dict:
    move = lambda v: v.to(device=device, dtype=dtype) if torch.is_tensor(v) else v  # noqa: E731
    return {k: ([move(x) for x in v] if isinstance(v, list) else move(v)) for k, v in kw.items()}


def _report(label: str, kernel, twin, tab, spec, kw: dict, key: str, tol: float) -> None:
    """One solve: the kernel, its twin on the card, on the CPU and in
    float64 (on the card), the twin's witnesses on the card (its state
    nudged alone, and every input nudged), and which rule the kernel
    meets."""
    with torch.no_grad():
        out_k = kernel(tab, spec, **kw)
        out_p = twin(tab, spec, **kw)
        out_c = twin(tab, spec, **_to(kw, device="cpu"))
        out_64 = twin(tab, spec, **_to(kw, dtype=torch.float64))
    torch.cuda.synchronize()
    steps, spreads = roundoff_witness(twin, tab, spec, kw, [key], ref=out_p)
    steps_all, spreads_all = roundoff_witness(twin, tab, spec, kw, ref=out_p, seed=1)
    (sk, vk), (sp, vp), (sc, vc), (s64, v64) = (split(o) for o in (out_k, out_p, out_c, out_64))
    forward = is_forward(out_k)
    acc = (lambda o: int(o[3])) if forward else (lambda o: int(o[6]))  # noqa: E731
    dt = (lambda o: f" dt_last {float(o[4]):.5f} dt_used {float(o[5]):.5f}") if forward else (lambda o: "")  # noqa: E731
    d = lambda xs, ys: max(rel(a, b) for a, b in zip(xs, ys))  # noqa: E731
    near = shows_near_tie(sp, steps + steps_all, spreads + spreads_all, tol)
    strict = sk == sp and d(vk, vp) <= tol
    both = [max(a, b) for a, b in zip(spreads, spreads_all)]
    rule, _ = within_near_tie(out_k, out_p, steps + steps_all, both, 1e-4, tol)
    last = forward and last_step_tie(out_k, out_p, tol)[0]
    print(f"{label}: kernel {sk}/{acc(out_k)}{dt(out_k)}; card twin {sp}/{acc(out_p)}{dt(out_p)}; "
          f"cpu twin {sc}/{acc(out_c)}{dt(out_c)}; float64 twin {s64}/{acc(out_64)}{dt(out_64)} | "
          f"kernel-card {d(vk, vp):.3e}, card-cpu {d(vp, vc):.3e}; to float64: kernel {d(vk, v64):.3e}, "
          f"card {d(vp, v64):.3e}, cpu {d(vc, v64):.3e} | witness, {key} nudged one ulp: steps {steps}, "
          f"spread {max(spreads):.3e}; every input nudged: steps {steps_all}, spread {max(spreads_all):.3e} "
          f"({'a near-tie' if near else 'no near-tie'}) | the kernel meets "
          + ("the twin's bound" if strict else "the near-tie rule" if rule and near
             else "the last-step rule" if last else "no rule"),
          flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cases", default=",".join(CASES), help="comma-separated case ids")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("near_tie needs a CUDA card")
    from .. import MLP
    from ..ode.tableaus import TSIT5
    from ..ops import fused_solve as fs

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    for case in args.cases.split(","):
        dims, B, span = CASES[case]
        spec = fs.chain_spec(MLP(dims, device=dev), dims[-1])
        for norms in ((True, True), (False, False)):
            train, test, adjoint = case_inputs(dims, B, span, dev)
            on = "on" if norms[0] else "off"
            train.update(norm_z=norms[0], norm_j=norms[1])
            adjoint.update(norm_z=norms[0], norm_j=norms[1])
            exact = {k: v for k, v in train.items() if k != "eps"}
            head = f"{case} (B={B}, tspan {span}) norm rates {on}"
            _report(f"{head} K1 chain form", fs.run_chain_train_solve_kernel, fs.solve_train_plain, TSIT5, spec,
                    train, "z0", 1e-4)
            _report(f"{head} K7 exact", fs.run_chain_exact_solve_kernel, fs.solve_train_exact_plain, TSIT5, spec,
                    exact, "z0", 1e-4)
            with torch.no_grad():
                out = fs.run_chain_train_solve_kernel(TSIT5, spec, **train)
            tdir = torch.sign(train["t1"] - train["t0"])
            adjoint.update(zT=out[0], accT=out[1], dt_init=-tdir * out[4].abs())
            _report(f"{head} K2 chain form", fs.run_chain_adjoint_kernel, fs.adjoint_train_plain, TSIT5, spec,
                    adjoint, "zT", 1e-3)
        _report(f"{case} (B={B}, tspan {span}) K7 TEST", fs.run_chain_test_solve_kernel, fs.solve_test_plain, TSIT5,
                spec, test, "z0", 1e-4)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
