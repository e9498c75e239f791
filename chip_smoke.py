#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

The main path is density evaluation and sampling at the flagship width
(RNODE, nvars = 8, naug = 8, MLP 16 -> 48 -> 16 with tanh, tspan (0, 13),
tsit5 at rtol 1e-3 / atol 1e-6, batch 4096) through
`ICNFDist(icnf, Mode.TEST, ps).logpdf` and `.sample`, whose solve runs in the
K3 CUDA kernel.  Weights are random, made from a seed with numpy.

Phases, each failing the run (nonzero exit) on any mismatch:
  1. versions and the card's name and power limit;
  2. build of every kernel from the sources in this checkout;
  3. TF32 off for matmuls and cuDNN;
  4. the flagship model with Glorot weights, small nonzero biases and
     xs ~ U[0, 1) of shape (4096, 8);
  5. each kernel's wrapper against its plain PyTorch version on the same
     inputs at the main path's shapes, then logpdf through the kernel against
     logpdf through the plain path (same steps; |dlogp| within
     1e-4 * max(1, max |logp|));
  6. the main path (logpdf, sample, logpdf of the samples) with the launch
     counters reset just before it; finite outputs of the right shapes, and
     each kernel launched during it;
  7. CUDA-event timings of kernel and plain versions.
The last lines are the kernels' JSON record, the nvidia-smi line, and
{"ok": true, "device": {...}}.  Without a CUDA device it exits nonzero and
prints no result.
"""

import json
import math
import subprocess
import sys
import time

SEED = 0
BATCH = 4096
NVARS, NAUG = 8, 8
TOL = 1e-4  # relative bound on kernel-vs-plain differences (f32 sums in another order)


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of `fn` between CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def flagship_params(rng):
    """Glorot-uniform weights and small nonzero biases, JAX layout."""
    import numpy as np

    dims = (NVARS + NAUG, 3 * (NVARS + NAUG), NVARS + NAUG)
    ps = []
    for din, dout in zip(dims[:-1], dims[1:]):
        lim = math.sqrt(6.0 / (din + dout))
        ps.append({
            "w": rng.uniform(-lim, lim, (din, dout)).astype(np.float32),
            "b": rng.normal(0.0, 0.05, (dout,)).astype(np.float32),
        })
    return tuple(ps), dims


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    import continuousnf_tpu_torch as cnf
    from continuousnf_tpu_torch.ops import _build
    from continuousnf_tpu_torch.ops.fused_solve import (
        _KERNEL,
        run_solve_kernel,
        solve_test_plain,
    )
    from continuousnf_tpu_torch.ode.tableaus import TSIT5

    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"card: {smi}")

    t_build = time.perf_counter()
    lib_path, log = _build.build_library(_KERNEL)
    print(f"built {lib_path.name} in {time.perf_counter() - t_build:.2f} s")
    for line in log.splitlines():
        if any(k in line for k in ("entry function", "registers", "spill")):
            print(f"  ptxas: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    rng = np.random.default_rng(SEED)
    ps_np, dims = flagship_params(rng)
    xs_np = rng.uniform(0.0, 1.0, (BATCH, NVARS)).astype(np.float32)
    ps = cnf.params_from_numpy(ps_np, dev)
    xs = torch.from_numpy(xs_np).to(dev)

    def model(fused: bool):
        return cnf.construct(
            cnf.RNODE, cnf.MLP(dims, device=dev), NVARS, NAUG,
            tspan=(0.0, 13.0), steer_rate=0.1, lam3=1e-2,
            compute_mode=cnf.VecJacMode(fused=fused),
        )

    icnf_k, icnf_p = model(True), model(False)
    opts = icnf_k.solver

    # Phase 5a: the wrapper against its plain version, main-path shapes.
    zdim = NVARS + NAUG
    z0 = torch.cat([xs, torch.zeros((BATCH, NAUG), device=dev)], dim=1)
    dlogp0 = torch.from_numpy(rng.normal(0.0, 0.1, BATCH).astype(np.float32)).to(dev)
    spec = cnf.ops.fused_solve.chain_spec(icnf_k.nn, zdim)
    kw = dict(
        rtol=opts.rtol, atol=opts.atol, max_steps=opts.max_steps,
        ws=[p["w"] for p in ps], bs=[p["b"] for p in ps], z0=z0, dlogp0=dlogp0,
        t0=torch.tensor(0.0, device=dev), t1=torch.tensor(13.0, device=dev),
        dt_init=torch.tensor(0.05, device=dev),
    )
    with torch.no_grad():
        out_k = run_solve_kernel(TSIT5, spec, **kw)
        out_p = solve_test_plain(TSIT5, spec, **kw)
    torch.cuda.synchronize()
    steps_k, steps_p = int(out_k[2]), int(out_p[2])
    check(steps_k == steps_p and int(out_k[3]) == int(out_p[3]),
          f"K3 steps/accepted {steps_k}/{int(out_k[3])} != plain {steps_p}/{int(out_p[3])}")
    err_z = float((out_k[0] - out_p[0]).abs().max())
    err_l = float((out_k[1] - out_p[1]).abs().max())
    check(bool(torch.isfinite(out_k[0]).all() and torch.isfinite(out_k[1]).all()), "K3 output not finite")
    check(err_z <= TOL * max(1.0, float(out_p[0].abs().max())), f"K3 zT differs by {err_z}")
    check(err_l <= TOL * max(1.0, float(out_p[1].abs().max())), f"K3 dlogpT differs by {err_l}")
    max_abs_err = max(err_z, err_l)
    print(f"K3 vs plain: steps {steps_k}, max|dz| {err_z:.3e} (max|z| {float(out_p[0].abs().max()):.3e}), "
          f"max|ddlogp| {err_l:.3e} (max|dlogp| {float(out_p[1].abs().max()):.3e})")

    # Phase 5b: logpdf through the kernel against the plain path.
    for n in (16, BATCH):
        with torch.no_grad():
            lp_k, _, st_k = cnf.inference(icnf_k, cnf.Mode.TEST, xs[:n], ps)
            lp_p, _, st_p = cnf.inference(icnf_p, cnf.Mode.TEST, xs[:n], ps)
        dlp = float((lp_k - lp_p).abs().max())
        check(int(st_k.steps) == int(st_p.steps), f"B={n}: steps {int(st_k.steps)} != {int(st_p.steps)}")
        check(dlp <= TOL * max(1.0, float(lp_p.abs().max())), f"B={n}: logp differs by {dlp}")
        print(f"logpdf B={n}: steps {int(st_k.steps)}, nfe {int(st_k.nfe)}, max|dlogp| {dlp:.3e}")

    # Phase 6: the main path, counters reset just before it.
    dist = cnf.ICNFDist(icnf_k, cnf.Mode.TEST, ps)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    run_solve_kernel.launches = 0
    with torch.no_grad():
        lp = dist.logpdf(xs)
        n_logpdf = run_solve_kernel.launches
        samples = dist.sample(BATCH, generator=gen)
        n_sample = run_solve_kernel.launches - n_logpdf
        lp_samples = dist.logpdf(samples)
    torch.cuda.synchronize()
    launches = run_solve_kernel.launches
    check(n_logpdf >= 1 and n_sample >= 1, f"K3 launches: logpdf {n_logpdf}, sample {n_sample}")
    check(tuple(lp.shape) == (BATCH,) and bool(torch.isfinite(lp).all()), "logpdf not finite")
    check(tuple(samples.shape) == (BATCH, NVARS) and bool(torch.isfinite(samples).all()), "samples not finite")
    check(bool(torch.isfinite(lp_samples).all()), "logpdf of samples not finite")
    print(f"main path: logpdf mean {float(lp.mean()):.4f}, logpdf(samples) mean "
          f"{float(lp_samples.mean()):.4f}, K3 launches {launches}")

    # Phase 7: timings (CUDA events).
    with torch.no_grad():
        _, _, st = cnf.inference(icnf_k, cnf.Mode.TEST, xs, ps)
        nfe = int(st.nfe)
        ms_k = cuda_ms(lambda: dist.logpdf(xs), 10)
        ms_s = cuda_ms(lambda: dist.sample(BATCH, generator=gen), 10)
        ms_p = cuda_ms(lambda: cnf.inference(icnf_p, cnf.Mode.TEST, xs, ps), 3)
        ms_kernel = cuda_ms(lambda: run_solve_kernel(TSIT5, spec, **kw), 10)
        ms_plain = cuda_ms(lambda: solve_test_plain(TSIT5, spec, **kw), 3)
    print(f"logpdf B={BATCH}: kernel {ms_k:.4f} ms ({BATCH / ms_k * 1e3:.1f} evals/s, "
          f"{ms_k * 1e3 / nfe:.3f} us/NFE), plain {ms_p:.4f} ms ({BATCH / ms_p * 1e3:.1f} evals/s); "
          f"steps {int(st.steps)}, NFE {nfe}")
    print(f"sample n={BATCH}: kernel {ms_s:.4f} ms ({BATCH / ms_s * 1e3:.1f} samples/s)")
    print(f"K3 alone: {ms_kernel:.4f} ms, plain version {ms_plain:.4f} ms ({steps_k} steps)")

    print(json.dumps({"kernels": [{
        "name": _KERNEL,
        "route": "cuda",
        "source": "continuousnf_tpu_torch/ops/csrc/k3_test_solve.cu",
        "replaces": "continuousnf_tpu/ops/fused_solve.py:1043",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms_kernel,
        "plain_ms": ms_plain,
    }]}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
