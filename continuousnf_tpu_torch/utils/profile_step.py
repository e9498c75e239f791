"""Where the time goes in a training step and a `logpdf` call on the card.

    python -m continuousnf_tpu_torch.utils.profile_step [--model power6|flagship|cond_gaussian|miniboone43|miniboone860|hepmass42|miniboone86|bsds126|cond_hepmass42|cond_miniboone86|cond_miniboone860|refbench16|...]
        [--steps 10]
        [--probes K] [--jvp] [--test-grad] [--direct | --fixed N] [--bf16]

Builds the model (`--model power6`: the tabular power6 model, RNODE,
MLP 6 -> 64 -> 64 -> 6; `--model flagship`: RNODE, MLP 16 -> 48 -> 16;
`--model cond_gaussian`: the conditional recipe, CondRNODE, MLP
2 -> 64 -> 64 -> 1 on [x | y]; `--model miniboone43`: the tabular
MINIBOONE model, RNODE, MLP 43 -> 128 -> 128 -> 43, through the wide chain
kernels; `--model miniboone860`: FFJORD's MINIBOONE model, RNODE, MLP
43 -> 860 -> 860 -> 43, through the streamed chain kernels; `--model
hepmass42`: the README net family at the HEPMASS width, RNODE, MLP
42 -> 126 -> 42, through the wide 2-layer kernels and the wide chain
forms; `--model miniboone86` / `bsds126`: the same family at 86 -> 258 ->
86 and 126 -> 378 -> 126, through streamed K3 and K5, the streamed chain
forms, and streamed K7 exact with the streamed K4 adjoint for the
exact-trace step; `--model cond_hepmass42`: CondRNODE at the HEPMASS width,
MLP 43 -> 126 -> 42 on [z | ys], through the COND instances of the wide K1
and K2 chain forms, wide K3 and wide K5, and of wide K7 exact with the wide
K4 adjoint for the exact-trace step; `--model cond_miniboone86`: CondRNODE
at the MINIBOONE width, MLP 87 -> 258 -> 86 on [z | ys], through the COND
instances of the streamed K1 and K2 chain forms, streamed K3 and streamed
K5, and of streamed K7 exact with the streamed K4 adjoint for the
exact-trace step; `--model cond_miniboone860`: CondRNODE, MLP 44 -> 860 ->
860 -> 43 on [z | ys], batch 1024, through the COND instances of the
streamed K1 and K2 chain forms, streamed K7 TEST for `logpdf` and streamed
K7 exact for the exact-trace step's forward, its backward the plain
BACKSOLVE; `--model refbench16`: the reference benchmark suite's RNODE 8 + 8
with one 16 -> 16 tanh layer, through the narrow chain kernels; any other
name of `utils/configs.py`'s MODELS, the depth configurations among them),
its weights and its data from a seed as `utils/configs.py` makes
them, one Gaussian VJP probe (`--probes K` Gaussian probes, `--jvp`
forward-mode ones: the Hutchinson train steps run the probe instances of
the K1 and K2 kernels or of their chain forms, narrow, wide (miniboone43;
at cond_hepmass42 their probe COND instances, K6 x K8) or streamed
(miniboone860, miniboone86, bsds126; at cond_miniboone86 and
cond_miniboone860 their probe COND instances), K6), batch 4096 (or the configuration's own
`batch`: 2048 for miniboone43 and bsds126, 1024 for miniboone860 and
cond_miniboone860), fused kernels on, and for each path (the
Hutchinson train step, the exact-trace train step, `logpdf`; for a
configuration with its own training batch, the train step at that batch
too):
  * the wall time per call, CUDA events over `--steps` calls after a
    warm-up, without the profiler;
  * under `torch.profiler`, one run of the same number of calls: its wall
    time per call (a host range around the calls and the final
    synchronize: the profiled window), the card's busy time per call (the
    union of the device activities' intervals within that window) and the
    idle share 1 - busy / window, both from that one run, so it never falls
    below 0;
  * the kernels that take the most of it, by name, and the host operations
    that take the most of the CPU's own time under the profiler (where an
    idle card waits).
With `--test-grad` (always for the README family past state width 32 and
for cond_hepmass42 and cond_miniboone86) it
measures one more path, the TEST loss (the exact-trace maximum likelihood)
and its gradient in the params (`test_grad`): on a 2-layer net the forward
runs K3 and the backward K5 (past state width 32 wide K3 and wide K5, past
the wide limits streamed K3 and K5), on deeper chains K7 TEST and the plain
backward.  `--direct` runs the train
steps under `SolverOptions(adjoint=Adjoint.DIRECT)` and `--fixed N` under N
rk4 steps: the whole-solve kernels do not take them, so a 2-layer net's
Hutchinson step evaluates its field stage by stage in K10 and
differentiates the recorded solve (`logpdf` keeps the default solver).
`--bf16` builds the model under bf16 stage matmuls (`VecJacMode(fused=True,
bf16=True)`: bf16 K1 and K2 in the train step, bf16 K3 in `logpdf`; on
the flagship or `--model microbench`, the flagship at tspan (0, 1)),
leaves out the exact-trace step (no bf16 kernel or twin runs it yet) and
adds `sample(B)`.
Needs a CUDA card; prints one line per figure, then one JSON object.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .configs import MODELS, cuda_ms, glorot_params, make_icnf, model_data


def interval_union(intervals, lo: float, hi: float) -> float:
    """The length of the union of the intervals (start, end), clipped to
    [lo, hi]: the time in that window during which at least one of them
    runs.  At most hi - lo."""
    total, cur_lo, cur_hi = 0.0, None, None
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if cur_hi is None or a > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = a, b
        else:
            cur_hi = max(cur_hi, b)
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return total


_WINDOW = "profile_step.window"


def _busy(fn, reps: int, top: int = 6):
    """One profiled run of `reps` calls: (the profiled window's wall ms per
    call, the card's busy ms per call, the top kernels by their self time,
    the top host operations by their own CPU time (name, ms per call)).
    Busy is the union of the device activities' intervals (kernels, copies,
    sets) within the window, a host range around the calls and the final
    synchronize, so it never passes the window's wall time."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(_WINDOW):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    rows, host = [], []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if e.key == _WINDOW:
            continue
        if t > 0 and getattr(e, "device_type", None) is not None and "CUDA" in str(e.device_type):
            rows.append((e.key, t / 1e3 / reps))
        elif e.self_cpu_time_total > 0:
            host.append((f"{e.key} ({e.count // reps} calls)", e.self_cpu_time_total / 1e3 / reps))
    rows.sort(key=lambda r: -r[1])
    host.sort(key=lambda r: -r[1])
    events = prof.events()
    on_card = [e for e in events if "CUDA" in str(getattr(e, "device_type", ""))]
    card_ids = {id(e) for e in on_card}
    window = [e.time_range for e in events if e.name == _WINDOW and id(e) not in card_ids]
    if len(window) != 1:
        raise RuntimeError(f"profile_step: found {len(window)} profiled windows")
    lo, hi = window[0].start, window[0].end
    # The card's own activities; a host range's mirror on the card's
    # timeline (a user annotation) is not one.
    device = [(e.time_range.start, e.time_range.end) for e in on_card
              if not getattr(e, "is_user_annotation", False) and e.name != _WINDOW]
    busy_us = interval_union(device, lo, hi)
    return (hi - lo) / 1e3 / reps, busy_us / 1e3 / reps, rows[:top], host[:top]


def profile_model(name: str, steps: int, seed: int = 0, num_probes: int = 1, jvp: bool = False,
                  test_grad: bool = False, direct: bool = False, fixed: int = 0, bf16: bool = False) -> dict:
    import continuousnf_tpu_torch as cnf

    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(seed)
    cfg = MODELS[name]
    ps_np = glorot_params(rng, cfg["dims"])
    B = cfg.get("batch", 4096)
    data = model_data(name, rng, B)
    xs_np, ys_np = data if cfg.get("n_cond") else (data, None)
    xs = torch.from_numpy(xs_np).to(dev)
    ys = None if ys_np is None else torch.from_numpy(ys_np).to(dev)

    if direct:
        solver = cnf.SolverOptions(adjoint=cnf.Adjoint.DIRECT)
    elif fixed:
        solver = cnf.SolverOptions(method="rk4", fixed_num_steps=fixed)
    else:
        solver = cnf.SolverOptions()

    def model(exact: bool, solver=cnf.SolverOptions()):
        return make_icnf(name, dev, exact=exact, num_probes=num_probes, ad="jvp" if jvp else "vjp", solver=solver,
                         bf16=bf16)

    out = {"model": name, "device": torch.cuda.get_device_name(0), "probes": num_probes, "jvp": jvp,
           "direct": direct, "fixed": fixed, "bf16": bf16}
    gen = torch.Generator(device=dev).manual_seed(seed)

    # bf16 has no exact-trace stages (ROADMAP queue 2, the bf16 row).
    paths = [("train_step", False, B)] + ([] if bf16 else [("exact_train_step", True, B)])
    if "batch_size" in cfg:
        paths.append((f"train_step_b{cfg['batch_size']}", False, cfg["batch_size"]))
    for label, exact, b in paths:
        icnf = model(exact, solver)
        ps = cnf.params_from_numpy(ps_np, dev)
        leaves = [x.requires_grad_() for p in ps for x in (p["w"], p["b"])]
        step = cnf.parallel.make_train_step_body(icnf, cnf.Lion(leaves, lr=1e-3))
        yb = None if ys is None else ys[:b]
        call = lambda: step(ps, xs[:b], gen, ys=yb)  # noqa: E731
        out[label] = _measure(call, steps)
    if test_grad or name in ("hepmass42", "miniboone86", "bsds126", "cond_hepmass42", "cond_miniboone86"):
        icnf = model(False)
        ps = cnf.params_from_numpy(ps_np, dev)
        leaves = [x.requires_grad_() for p in ps for x in (p["w"], p["b"])]
        out["test_grad"] = _measure(
            lambda: torch.autograd.grad(cnf.loss(icnf, cnf.Mode.TEST, xs, ps, ys=ys), leaves), steps
        )
    ps = cnf.params_from_numpy(ps_np, dev)
    dist = cnf.ICNFDist(model(False), cnf.Mode.TEST, ps) if ys is None else \
        cnf.CondICNFDist(model(False), cnf.Mode.TEST, ps, ys)
    with torch.no_grad():
        out["logpdf"] = _measure(lambda: dist.logpdf(xs), steps)
        if bf16:
            out["sample"] = _measure(lambda: dist.sample(B, generator=gen), steps)
    return out


def _measure(call, steps: int) -> dict:
    for _ in range(3):
        call()
    wall = cuda_ms(call, steps)
    window, busy, top, host = _busy(call, steps)
    return {"wall_ms": wall, "window_ms": window, "busy_ms": busy, "idle_share": 1.0 - busy / window,
            "top": [{"kernel": k[:80], "ms": t} for k, t in top],
            "host": [{"op": k[:80], "ms": t} for k, t in host]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(MODELS), default="power6")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--probes", type=int, default=1, help="Hutchinson probes K of the train steps")
    ap.add_argument("--jvp", action="store_true", help="forward-mode (JVP) probes")
    ap.add_argument("--test-grad", action="store_true", help="also the TEST loss and its gradient")
    solve = ap.add_mutually_exclusive_group()
    solve.add_argument("--direct", action="store_true", help="train steps under the DIRECT adjoint")
    solve.add_argument("--fixed", type=int, default=0, metavar="N", help="train steps under N rk4 steps")
    ap.add_argument("--bf16", action="store_true", help="bf16 stage matmuls (bf16 K3, K1, K2)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA card")
    res = profile_model(a.model, a.steps, num_probes=a.probes, jvp=a.jvp, test_grad=a.test_grad, direct=a.direct,
                        fixed=a.fixed, bf16=a.bf16)
    for label, r in res.items():
        if not isinstance(r, dict):
            continue
        print(f"{a.model} {label}: wall {r['wall_ms']:.4f} ms; profiled: window {r['window_ms']:.4f} ms, card busy "
              f"{r['busy_ms']:.4f} ms, idle {100 * r['idle_share']:.1f} %")
        for k in r["top"]:
            print(f"    {k['ms']:.4f} ms  {k['kernel']}")
        for k in r["host"]:
            print(f"    host {k['ms']:.4f} ms  {k['op']}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
