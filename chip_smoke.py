#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card and check them.

    python3 chip_smoke.py

The flagship model: RNODE, nvars = 8, naug = 8, MLP 16 -> 48 -> 16 with
tanh, lambda1 = lambda2 = lambda3 = 1e-2, steer_rate 0.1, tspan (0, 13),
tsit5 at rtol 1e-3 / atol 1e-6, one Gaussian VJP Hutchinson probe, batch
4096.  Weights are random, made from a seed with numpy.  Three main paths:
  * serving: `ICNFDist(icnf, Mode.TEST, ps).logpdf` and `.sample`, whose
    solve runs in K3;
  * training: `fit(ICNFModel(icnf, n_epochs=1, batch_size=4096), X)` on
    4 x 4096 samples, four Lion steps whose forward solve runs in K1 and
    whose BACKSOLVE adjoint runs in K2;
  * exact training: the same `fit` on the same model with
    `VecJacMode(fused=True, exact_trace=True)` (no probes: the exact trace
    and ||J||_F), whose forward solve runs in the K4 forward kernel and
    whose adjoint runs in the K4 adjoint kernel.

Phases, each failing the run (nonzero exit) on any mismatch:
  1. versions and the card's name and power limit;
  2. build of every kernel from the sources in this checkout (one nvcc per
     source, all at once), with the ptxas lines;
  3. TF32 off for matmuls and cuDNN;
  4. the flagship model with Glorot weights, small nonzero biases and
     xs ~ U[0, 1) of shape (4096, 8);
  5. K3 against its plain version at the main path's shapes, then logpdf
     through the kernel against logpdf through the plain path (same steps;
     |dlogp| within 1e-4 * max(1, max |logp|));
  6. the serving path (logpdf, sample, logpdf of the samples) with the
     launch counters reset just before it;
  7. K1 against `solve_train_plain` from nonzero accumulators (same steps;
     z and each accumulator row within 1e-4 * max(1, max |.|)), and K2
     against `adjoint_train_plain` from K1's output with the same cotangent
     and warm start (same steps; z0 and a_z0 within 1e-4 relative of the
     float64 twin, or within 4x the float32 twin's own distance from it;
     each parameter gradient within 1e-3 * max(1, max |g|): sums of 4096
     terms in another order);
  8. one training loss and its gradient through fused=True (K1, K2) and
     fused=False (the plain BACKSOLVE adjoint): losses within 1e-4
     relative; both gradients within 2e-2 * max|g| of a float64 rtol 1e-7
     plain solve (the two backward solves run on different step grids, and
     the warm-started fused one is the coarser, as in the JAX package);
  9. the training path, `fit` for one epoch of four Lion steps with the
     launch counters reset just before it: four steps, finite losses, K1
     and K2 each launched at least four times;
 10. CUDA-event timings of the kernels, their plain versions and the
     training step;
 11. the K4 forward against `solve_train_exact_plain` from nonzero
     accumulators (same steps; z and each accumulator row within
     1e-4 * max(1, max |.|)), and the K4 adjoint against
     `adjoint_train_exact_plain` from the K4 forward's output with its last
     step as the warm start (same steps; z0 and a_z0 held to the float64
     twin as K2's are; the chained gradients within 1e-3 * max|g|);
 12. the exact training loss and gradient through fused=True (K4) and
     fused=False: losses within 1e-4 relative, both gradients within
     2e-2 * max|g| of a float64 rtol 1e-7 plain solve;
 13. the exact training path, `fit` for four Lion steps with the launch
     counters reset just before it: the K4 forward and the K4 adjoint
     each launched exactly four times;
 14. CUDA-event timings of the K4 kernels, their plain versions and the
     exact training step.
The last lines are the kernels' JSON record, the nvidia-smi line, and
{"ok": true, "device": {...}}.  Without a CUDA device it exits nonzero and
prints no result.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np

SEED = 0
BATCH = 4096
NVARS, NAUG = 8, 8
TOL = 1e-4  # relative bound on kernel-vs-plain differences (f32 sums in another order)
GRAD_TOL = 1e-3  # K2's and K4's batch-summed parameter gradients: 4096-term sums in another order
SOLVE_REL = 2e-2  # training gradients vs a float64 rtol 1e-7 solve, relative to max|g|
N_STEPS = 4  # Lion steps of the training path


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
    dims = (NVARS + NAUG, 3 * (NVARS + NAUG), NVARS + NAUG)
    ps = []
    for din, dout in zip(dims[:-1], dims[1:]):
        lim = math.sqrt(6.0 / (din + dout))
        ps.append({
            "w": rng.uniform(-lim, lim, (din, dout)).astype(np.float32),
            "b": rng.normal(0.0, 0.05, (dout,)).astype(np.float32),
        })
    return tuple(ps), dims


def rel_err(got, ref) -> float:
    """max|got - ref| / max(1, max|ref|)."""
    return float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))


def to64(v):
    """A kernel's keyword argument in float64 (tensors and lists of them)."""
    import torch

    if torch.is_tensor(v):
        return v.double()
    return [x.double() for x in v] if isinstance(v, list) else v


def hold_backward_state(label, out_k, out_p, out_64):
    """z0 and a_z0 of a backsolve against the float64 twin.  The state
    reconstructed backward is ill-conditioned here: the twin's own float32
    result differs from its float64 one by more than 1e-4 (step sizes set by
    a roundoff-level eest, errors grown over tspan 13; PERF.md).  So the
    kernel is held, beside the 1e-4 bound, to at most 4x the twin's own
    float32 distance from the float64 twin."""
    for what, i in (("z0", 0), ("a_z0", 2)):
        e_k, e_p, e_kp = rel_err(out_k[i], out_64[i]), rel_err(out_p[i], out_64[i]), rel_err(out_k[i], out_p[i])
        check(e_k <= max(TOL, 4.0 * e_p), f"{label} {what}: {e_k} from the float64 twin, the float32 twin {e_p}")
        print(f"{label} {what}: relative distance to the float64 twin {e_k:.3e} (float32 twin {e_p:.3e}); "
              f"to the float32 twin {e_kp:.3e}")


def loss_grad(cnf, icnf, ps_np, xs, dev, dtype=None, **kw):
    """One TRAIN loss and its gradient in the params' leaves (w1, b1, w2, b2)."""
    import torch

    dtype = dtype or torch.float32
    p = cnf.params_from_numpy(ps_np, dev)
    leaves = [x.to(dtype).requires_grad_() for layer in p for x in (layer["w"], layer["b"])]
    p = tuple({"w": w, "b": b} for w, b in zip(leaves[::2], leaves[1::2]))
    l, m = cnf.loss_and_metrics(icnf, cnf.Mode.TRAIN, xs.to(dtype), p, **kw)
    return l.detach(), torch.autograd.grad(l, leaves), m


def hold_gradients(label, l_k, g_k, l_p, g_p, l_t, g_t):
    """The fused and plain losses within 1e-4 relative, and both gradients
    within SOLVE_REL * max|g| of the float64 rtol 1e-7 solve.  The two
    backward solves run on different step grids: the fused one is
    warm-started from the forward's last step and takes about half the
    plain one's steps.  At the flagship the JAX package's own fused gradient
    sits 3.5e-3 * max|g| from such a solve and its plain one 5e-4 (PERF.md),
    so rtol 2e-3 between them is out of reach there."""
    check(abs(float(l_k - l_p)) <= TOL * max(1.0, abs(float(l_p))), f"{label} losses {float(l_k)} vs {float(l_p)}")
    for name, a, b, t in zip(("w1", "b1", "w2", "b2"), g_k, g_p, g_t):
        d_k, d_p = float((a.double() - t).abs().max()), float((b.double() - t).abs().max())
        scale = float(t.abs().max())
        check(max(d_k, d_p) <= SOLVE_REL * scale,
              f"{label} g_{name}: fused {d_k} and plain {d_p} from the float64 solve, max|g| {scale}")
        print(f"{label} g_{name}: max|g| {scale:.4e}; distance to the float64 rtol 1e-7 solve: fused {d_k:.4e}, "
              f"plain {d_p:.4e}; fused vs plain {float((a - b).abs().max()):.4e}")


def fit_path(cnf, fs, icnf, ps_np, dev, seed):
    """`fit` for one epoch of N_STEPS Lion steps at BATCH, every launch
    counter reset just before it.  Checks the step count and finite losses
    and params; returns the FitResult."""
    import torch

    X = torch.from_numpy(np.random.default_rng(seed).uniform(0.0, 1.0, (N_STEPS * BATCH, NVARS))
                         .astype("float32")).to(dev)
    lion_steps = []

    def lion(params):
        opt = cnf.Lion(params, lr=1e-3)
        opt.register_step_post_hook(lambda *_: lion_steps.append(1))
        return opt

    for f in (fs.run_solve_kernel, fs.run_train_solve_kernel, fs.run_adjoint_kernel,
              fs.run_exact_solve_kernel, fs.run_exact_adjoint_kernel):
        f.launches = 0
    res = cnf.fit(cnf.ICNFModel(icnf, optimizers=(lion,), n_epochs=1, batch_size=BATCH), X,
                  ps=cnf.params_from_numpy(ps_np, dev), seed=SEED)
    torch.cuda.synchronize()
    check(len(lion_steps) == N_STEPS, f"{len(lion_steps)} Lion steps, expected {N_STEPS}")
    check(bool(np.isfinite(res.losses).all()), f"fit losses {res.losses}")
    check(all(bool(torch.isfinite(x).all()) for layer in res.ps for x in layer.values()), "fitted params not finite")
    return res


def step_ms(cnf, icnf, ps_np, xs, gen, dev, reps):
    """CUDA-event milliseconds of one step of the step body (loss, gradient,
    Lion)."""
    p = cnf.params_from_numpy(ps_np, dev)
    leaves = [x.requires_grad_() for layer in p for x in (layer["w"], layer["b"])]
    step = cnf.parallel.make_train_step_body(icnf, cnf.Lion(leaves, lr=1e-3))
    return cuda_ms(lambda: step(p, xs, gen), reps)


def serving(cnf, fs, TSIT5, icnf_k, icnf_p, ps, xs, rng, dev):
    """Phases 5 and 6 and K3's timings.  Returns K3's record."""
    import torch

    opts = icnf_k.solver
    zdim = NVARS + NAUG
    z0 = torch.cat([xs, torch.zeros((BATCH, NAUG), device=dev)], dim=1)
    dlogp0 = torch.from_numpy(rng.normal(0.0, 0.1, BATCH).astype("float32")).to(dev)
    spec = fs.chain_spec(icnf_k.nn, zdim)
    kw = dict(
        rtol=opts.rtol, atol=opts.atol, max_steps=opts.max_steps,
        ws=[p["w"] for p in ps], bs=[p["b"] for p in ps], z0=z0, dlogp0=dlogp0,
        t0=torch.tensor(0.0, device=dev), t1=torch.tensor(13.0, device=dev),
        dt_init=torch.tensor(0.05, device=dev),
    )
    with torch.no_grad():
        out_k = fs.run_solve_kernel(TSIT5, spec, **kw)
        out_p = fs.solve_test_plain(TSIT5, spec, **kw)
    torch.cuda.synchronize()
    steps_k, steps_p = int(out_k[2]), int(out_p[2])
    check(steps_k == steps_p and int(out_k[3]) == int(out_p[3]),
          f"K3 steps/accepted {steps_k}/{int(out_k[3])} != plain {steps_p}/{int(out_p[3])}")
    err_z = float((out_k[0] - out_p[0]).abs().max())
    err_l = float((out_k[1] - out_p[1]).abs().max())
    check(bool(torch.isfinite(out_k[0]).all() and torch.isfinite(out_k[1]).all()), "K3 output not finite")
    check(err_z <= TOL * max(1.0, float(out_p[0].abs().max())), f"K3 zT differs by {err_z}")
    check(err_l <= TOL * max(1.0, float(out_p[1].abs().max())), f"K3 dlogpT differs by {err_l}")
    print(f"K3 vs plain: steps {steps_k}, max|dz| {err_z:.3e} (max|z| {float(out_p[0].abs().max()):.3e}), "
          f"max|ddlogp| {err_l:.3e} (max|dlogp| {float(out_p[1].abs().max()):.3e})")

    for n in (16, BATCH):
        with torch.no_grad():
            lp_k, _, st_k = cnf.inference(icnf_k, cnf.Mode.TEST, xs[:n], ps)
            lp_p, _, st_p = cnf.inference(icnf_p, cnf.Mode.TEST, xs[:n], ps)
        dlp = float((lp_k - lp_p).abs().max())
        check(int(st_k.steps) == int(st_p.steps), f"B={n}: steps {int(st_k.steps)} != {int(st_p.steps)}")
        check(dlp <= TOL * max(1.0, float(lp_p.abs().max())), f"B={n}: logp differs by {dlp}")
        print(f"logpdf B={n}: steps {int(st_k.steps)}, nfe {int(st_k.nfe)}, max|dlogp| {dlp:.3e}")

    # Phase 6: the serving path, counters reset just before it.
    dist = cnf.ICNFDist(icnf_k, cnf.Mode.TEST, ps)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    fs.run_solve_kernel.launches = 0
    with torch.no_grad():
        lp = dist.logpdf(xs)
        n_logpdf = fs.run_solve_kernel.launches
        samples = dist.sample(BATCH, generator=gen)
        n_sample = fs.run_solve_kernel.launches - n_logpdf
        lp_samples = dist.logpdf(samples)
    torch.cuda.synchronize()
    launches = fs.run_solve_kernel.launches
    check(n_logpdf >= 1 and n_sample >= 1, f"K3 launches: logpdf {n_logpdf}, sample {n_sample}")
    check(tuple(lp.shape) == (BATCH,) and bool(torch.isfinite(lp).all()), "logpdf not finite")
    check(tuple(samples.shape) == (BATCH, NVARS) and bool(torch.isfinite(samples).all()), "samples not finite")
    check(bool(torch.isfinite(lp_samples).all()), "logpdf of samples not finite")
    print(f"serving path: logpdf mean {float(lp.mean()):.4f}, logpdf(samples) mean "
          f"{float(lp_samples.mean()):.4f}, K3 launches {launches}")

    with torch.no_grad():
        _, _, st = cnf.inference(icnf_k, cnf.Mode.TEST, xs, ps)
        nfe = int(st.nfe)
        ms_k = cuda_ms(lambda: dist.logpdf(xs), 10)
        ms_s = cuda_ms(lambda: dist.sample(BATCH, generator=gen), 10)
        ms_p = cuda_ms(lambda: cnf.inference(icnf_p, cnf.Mode.TEST, xs, ps), 3)
        ms_kernel = cuda_ms(lambda: fs.run_solve_kernel(TSIT5, spec, **kw), 10)
        ms_plain = cuda_ms(lambda: fs.solve_test_plain(TSIT5, spec, **kw), 3)
    print(f"logpdf B={BATCH}: kernel {ms_k:.4f} ms ({BATCH / ms_k * 1e3:.1f} evals/s, "
          f"{ms_k * 1e3 / nfe:.3f} us/NFE), plain {ms_p:.4f} ms ({BATCH / ms_p * 1e3:.1f} evals/s); "
          f"steps {int(st.steps)}, NFE {nfe}")
    print(f"sample n={BATCH}: kernel {ms_s:.4f} ms ({BATCH / ms_s * 1e3:.1f} samples/s)")
    print(f"K3 alone: {ms_kernel:.4f} ms, plain version {ms_plain:.4f} ms ({steps_k} steps)")
    return {
        "name": fs.K3_KERNEL, "route": "cuda",
        "source": "continuousnf_tpu_torch/ops/csrc/k3_test_solve.cu",
        "replaces": "continuousnf_tpu/ops/fused_solve.py:1043",
        "launches": launches, "max_abs_err": max(err_z, err_l), "ms": ms_kernel, "plain_ms": ms_plain,
    }


def training(cnf, fs, TSIT5, icnf_k, icnf_p, ps_np, xs, rng, dev):
    """Phases 7 to 10 for K1, K2 and the training step.  Returns their
    records."""
    import torch

    opts = icnf_k.solver
    zdim = NVARS + NAUG
    ps = cnf.params_from_numpy(ps_np, dev)
    spec = fs.chain_spec(icnf_k.nn, zdim)
    T = lambda a: torch.from_numpy(a.astype("float32")).to(dev)
    eps = T(rng.normal(size=(1, BATCH, zdim)))
    base = dict(norm_z=True, norm_j=True, rtol=opts.rtol, atol=opts.atol, max_steps=opts.max_steps,
                ws=[p["w"] for p in ps], bs=[p["b"] for p in ps], eps=eps)

    # Phase 7a: K1 against its twin, from nonzero accumulators.
    kw1 = dict(base, z0=torch.cat([xs, torch.zeros((BATCH, NAUG), device=dev)], dim=1),
               acc0=T(rng.normal(0.0, 0.1, (3, BATCH))), t0=torch.tensor(0.0, device=dev),
               t1=torch.tensor(13.0, device=dev), dt_init=torch.tensor(0.05, device=dev))
    with torch.no_grad():
        out_k = fs.run_train_solve_kernel(TSIT5, spec, **kw1)
        out_p = fs.solve_train_plain(TSIT5, spec, **kw1)
    torch.cuda.synchronize()
    check((int(out_k[2]), int(out_k[3])) == (int(out_p[2]), int(out_p[3])),
          f"K1 steps/accepted {int(out_k[2])}/{int(out_k[3])} != plain {int(out_p[2])}/{int(out_p[3])}")
    check(bool(torch.isfinite(out_k[0]).all() and torch.isfinite(out_k[1]).all()), "K1 output not finite")
    errs1 = [rel_err(out_k[0], out_p[0])] + [rel_err(out_k[1][r], out_p[1][r]) for r in range(3)]
    check(max(errs1) <= TOL, f"K1 differs from its twin: z, dlogp, reg_e, reg_n relative errors {errs1}")
    abs1 = max(float((out_k[0] - out_p[0]).abs().max()), float((out_k[1] - out_p[1]).abs().max()))
    print(f"K1 vs plain: steps {int(out_k[2])}, relative errors z {errs1[0]:.3e}, dlogp {errs1[1]:.3e}, "
          f"reg_e {errs1[2]:.3e}, reg_n {errs1[3]:.3e}; dt_last {float(out_k[4]):.5f} vs {float(out_p[4]):.5f}")

    # Phase 7b: K2 against its twin from K1's final state, a loss-like
    # cotangent and K1's last step as the warm start.
    kw2 = dict(base, zT=out_k[0], accT=out_k[1], azT=T(rng.normal(0.0, 1.0 / BATCH, (BATCH, zdim))),
               aaccT=T(np.stack([np.full(BATCH, 1.0 / BATCH), np.full(BATCH, 1e-2 / BATCH),
                                 np.full(BATCH, 1e-2 / BATCH)])),
               t_hi=torch.tensor(13.0, device=dev), t_lo=torch.tensor(0.0, device=dev),
               dt_init=-out_k[4].abs())
    with torch.no_grad():
        adj_k = fs.run_adjoint_kernel(TSIT5, spec, **kw2)
        adj_p = fs.adjoint_train_plain(TSIT5, spec, **kw2)
        adj_64 = fs.adjoint_train_plain(TSIT5, spec, **{k: to64(v) for k, v in kw2.items()})
    torch.cuda.synchronize()
    check((int(adj_k[5]), int(adj_k[6])) == (int(adj_p[5]), int(adj_p[6])),
          f"K2 steps/accepted {int(adj_k[5])}/{int(adj_k[6])} != plain {int(adj_p[5])}/{int(adj_p[6])}")
    check(all(bool(torch.isfinite(x).all()) for x in [adj_k[0], adj_k[2]] + adj_k[3] + adj_k[4]), "K2 output not finite")
    hold_backward_state("K2", adj_k, adj_p, adj_64)
    e_g = [rel_err(a, b) for a, b in zip(adj_k[3] + adj_k[4], adj_p[3] + adj_p[4])]
    check(max(e_g) <= GRAD_TOL, f"K2 parameter gradients differ from the twin: w1, w2, b1, b2 {e_g}")
    abs2 = max(float((a - b).abs().max()) for a, b in zip(
        [adj_k[0], adj_k[2]] + adj_k[3] + adj_k[4], [adj_p[0], adj_p[2]] + adj_p[3] + adj_p[4]))
    print(f"K2 vs plain: steps {int(adj_k[5])}, gradient relative errors g_w1 {e_g[0]:.3e}, g_w2 {e_g[1]:.3e}, "
          f"g_b1 {e_g[2]:.3e}, g_b2 {e_g[3]:.3e}")

    # Phase 8: the loss and its gradient through both paths, same draws.
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    eps_s = icnf_k.draw_eps(gen, BATCH, dev)
    steer_r = 0.05

    kw = dict(eps=eps_s, steer_r=steer_r)
    n1, n2 = fs.run_train_solve_kernel.launches, fs.run_adjoint_kernel.launches
    l_k, g_k, m_k = loss_grad(cnf, icnf_k, ps_np, xs, dev, **kw)
    check(fs.run_train_solve_kernel.launches == n1 + 1 and fs.run_adjoint_kernel.launches == n2 + 1,
          "the fused gradient did not run K1 and K2 once each")
    l_p, g_p, _ = loss_grad(cnf, icnf_p, ps_np, xs, dev, **kw)
    icnf_t = cnf.construct(
        cnf.RNODE, cnf.MLP((zdim, 3 * zdim, zdim), device=dev, dtype=torch.float64), NVARS, NAUG,
        tspan=(0.0, 13.0), steer_rate=0.1, lam3=1e-2, solver=cnf.SolverOptions(rtol=1e-7, atol=1e-9),
        dtype=torch.float64,
    )
    l_t, g_t, _ = loss_grad(cnf, icnf_t, ps_np, xs, dev, torch.float64, eps=eps_s.double(), steer_r=steer_r)
    torch.cuda.synchronize()
    hold_gradients("Hutchinson", l_k, g_k, l_p, g_p, l_t, g_t)
    print(f"train step B={BATCH}: loss fused {float(l_k):.6f} plain {float(l_p):.6f} float64 {float(l_t):.6f}, "
          f"forward NFE {int(m_k['nfe'])}")

    # Phase 9: the training path, counters reset just before it.
    res = fit_path(cnf, fs, icnf_k, ps_np, dev, SEED + 2)
    n_k1, n_k2 = fs.run_train_solve_kernel.launches, fs.run_adjoint_kernel.launches
    check(n_k1 >= N_STEPS and n_k2 >= N_STEPS, f"fit launched K1 {n_k1} and K2 {n_k2} times")
    print(f"training path: fit {N_STEPS} Lion steps at B={BATCH}, epoch loss {float(res.losses[0]):.6f}, "
          f"{float(res.metrics['samples_per_s'][0]):.1f} samples/s (host clock), K1 launches {n_k1}, "
          f"K2 launches {n_k2}")

    # Phase 10: timings.
    ms_step = step_ms(cnf, icnf_k, ps_np, xs, gen, dev, 5)
    ms_step_p = step_ms(cnf, icnf_p, ps_np, xs, gen, dev, 1)
    with torch.no_grad():
        ms_k1 = cuda_ms(lambda: fs.run_train_solve_kernel(TSIT5, spec, **kw1), 10)
        ms_p1 = cuda_ms(lambda: fs.solve_train_plain(TSIT5, spec, **kw1), 3)
        ms_k2 = cuda_ms(lambda: fs.run_adjoint_kernel(TSIT5, spec, **kw2), 10)
        ms_p2 = cuda_ms(lambda: fs.adjoint_train_plain(TSIT5, spec, **kw2), 2)
    print(f"train step B={BATCH} (loss, gradient, Lion): fused {ms_step:.4f} ms "
          f"({BATCH / ms_step * 1e3:.1f} samples/s), plain {ms_step_p:.4f} ms ({BATCH / ms_step_p * 1e3:.1f} samples/s)")
    print(f"K1 alone: {ms_k1:.4f} ms, plain version {ms_p1:.4f} ms ({int(out_k[2])} steps)")
    print(f"K2 alone: {ms_k2:.4f} ms, plain version {ms_p2:.4f} ms ({int(adj_k[5])} steps)")
    return [
        {"name": fs.K1_KERNEL, "route": "cuda", "source": "continuousnf_tpu_torch/ops/csrc/k1_train_solve.cu",
         "replaces": "continuousnf_tpu/ops/fused_solve.py:1043", "launches": n_k1, "max_abs_err": abs1,
         "ms": ms_k1, "plain_ms": ms_p1},
        {"name": fs.K2_KERNEL, "route": "cuda", "source": "continuousnf_tpu_torch/ops/csrc/k2_train_adjoint.cu",
         "replaces": "continuousnf_tpu/ops/fused_solve.py:1767", "launches": n_k2, "max_abs_err": abs2,
         "ms": ms_k2, "plain_ms": ms_p2},
    ]


def exact_training(cnf, fs, TSIT5, dims, ps_np, xs, rng, dev):
    """Phases 11 to 14 for the K4 forward, the K4 adjoint and the exact
    training step.  Returns their records."""
    import torch

    zdim = NVARS + NAUG

    def model(fused: bool, dtype=torch.float32, **kw):
        return cnf.construct(
            cnf.RNODE, cnf.MLP(dims, device=dev, dtype=dtype), NVARS, NAUG, tspan=(0.0, 13.0),
            steer_rate=0.1, lam3=1e-2, compute_mode=cnf.VecJacMode(fused=fused, exact_trace=True),
            dtype=dtype, **kw,
        )

    icnf_k, icnf_p = model(True), model(False)
    opts = icnf_k.solver
    ps = cnf.params_from_numpy(ps_np, dev)
    spec = fs.chain_spec(icnf_k.nn, zdim)
    T = lambda a: torch.from_numpy(a.astype("float32")).to(dev)
    base = dict(norm_z=True, norm_j=True, rtol=opts.rtol, atol=opts.atol, max_steps=opts.max_steps,
                ws=[p["w"] for p in ps], bs=[p["b"] for p in ps])

    # Phase 11a: the K4 forward against its twin, from nonzero accumulators.
    kw1 = dict(base, z0=torch.cat([xs, torch.zeros((BATCH, NAUG), device=dev)], dim=1),
               acc0=T(rng.normal(0.0, 0.1, (3, BATCH))), t0=torch.tensor(0.0, device=dev),
               t1=torch.tensor(13.0, device=dev), dt_init=torch.tensor(0.05, device=dev))
    with torch.no_grad():
        out_k = fs.run_exact_solve_kernel(TSIT5, spec, **kw1)
        out_p = fs.solve_train_exact_plain(TSIT5, spec, **kw1)
    torch.cuda.synchronize()
    check((int(out_k[2]), int(out_k[3])) == (int(out_p[2]), int(out_p[3])),
          f"K4 forward steps/accepted {int(out_k[2])}/{int(out_k[3])} != plain {int(out_p[2])}/{int(out_p[3])}")
    check(bool(torch.isfinite(out_k[0]).all() and torch.isfinite(out_k[1]).all()), "K4 forward output not finite")
    errs = [rel_err(out_k[0], out_p[0])] + [rel_err(out_k[1][r], out_p[1][r]) for r in range(3)]
    check(max(errs) <= TOL, f"K4 forward differs from its twin: z, dlogp, reg_e, reg_n relative errors {errs}")
    abs_f = max(float((out_k[0] - out_p[0]).abs().max()), float((out_k[1] - out_p[1]).abs().max()))
    print(f"K4 forward vs plain: steps {int(out_k[2])}, relative errors z {errs[0]:.3e}, dlogp {errs[1]:.3e}, "
          f"reg_e {errs[2]:.3e}, reg_n {errs[3]:.3e}; dt_last {float(out_k[4]):.5f} vs {float(out_p[4]):.5f}")

    # Phase 11b: the K4 adjoint against its twin from the K4 forward's final
    # state, a loss-like cotangent and its last step as the warm start.
    kw2 = dict(base, zT=out_k[0], accT=out_k[1], azT=T(rng.normal(0.0, 1.0 / BATCH, (BATCH, zdim))),
               aaccT=T(np.stack([np.full(BATCH, 1.0 / BATCH), np.full(BATCH, 1e-2 / BATCH),
                                 np.full(BATCH, 1e-2 / BATCH)])),
               t_hi=torch.tensor(13.0, device=dev), t_lo=torch.tensor(0.0, device=dev),
               dt_init=-out_k[4].abs())
    with torch.no_grad():
        adj_k = fs.run_exact_adjoint_kernel(TSIT5, spec, **kw2)
        adj_p = fs.adjoint_train_exact_plain(TSIT5, spec, **kw2)
        adj_64 = fs.adjoint_train_exact_plain(TSIT5, spec, **{k: to64(v) for k, v in kw2.items()})
    torch.cuda.synchronize()
    check((int(adj_k[5]), int(adj_k[6])) == (int(adj_p[5]), int(adj_p[6])),
          f"K4 adjoint steps/accepted {int(adj_k[5])}/{int(adj_k[6])} != plain {int(adj_p[5])}/{int(adj_p[6])}")
    check(all(bool(torch.isfinite(x).all()) for x in [adj_k[0], adj_k[2]] + adj_k[3] + adj_k[4]),
          "K4 adjoint output not finite")
    hold_backward_state("K4 adjoint", adj_k, adj_p, adj_64)
    e_g = [float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(adj_k[3] + adj_k[4], adj_p[3] + adj_p[4])]
    check(max(e_g) <= GRAD_TOL, f"K4 adjoint gradients differ from the twin: w1, w2, b1, b2 (of max|g|) {e_g}")
    abs_a = max(float((a - b).abs().max()) for a, b in zip(
        [adj_k[0], adj_k[2]] + adj_k[3] + adj_k[4], [adj_p[0], adj_p[2]] + adj_p[3] + adj_p[4]))
    print(f"K4 adjoint vs plain: steps {int(adj_k[5])}, chained gradient errors (of max|g|) g_w1 {e_g[0]:.3e}, "
          f"g_w2 {e_g[1]:.3e}, g_b1 {e_g[2]:.3e}, g_b2 {e_g[3]:.3e}")

    # Phase 12: the exact loss and its gradient through both paths.
    n_f, n_a = fs.run_exact_solve_kernel.launches, fs.run_exact_adjoint_kernel.launches
    l_k, g_k, m_k = loss_grad(cnf, icnf_k, ps_np, xs, dev, steer_r=0.05)
    check((fs.run_exact_solve_kernel.launches, fs.run_exact_adjoint_kernel.launches) == (n_f + 1, n_a + 1),
          "the exact fused gradient did not run the K4 forward and adjoint once each")
    l_p, g_p, _ = loss_grad(cnf, icnf_p, ps_np, xs, dev, steer_r=0.05)
    icnf_t = model(False, torch.float64, solver=cnf.SolverOptions(rtol=1e-7, atol=1e-9))
    l_t, g_t, _ = loss_grad(cnf, icnf_t, ps_np, xs, dev, torch.float64, steer_r=0.05)
    torch.cuda.synchronize()
    hold_gradients("exact", l_k, g_k, l_p, g_p, l_t, g_t)
    print(f"exact train step B={BATCH}: loss fused {float(l_k):.6f} plain {float(l_p):.6f} float64 {float(l_t):.6f}, "
          f"forward NFE {int(m_k['nfe'])}")

    # Phase 13: the exact training path, counters reset just before it.
    res = fit_path(cnf, fs, icnf_k, ps_np, dev, SEED + 3)
    n_fwd, n_adj = fs.run_exact_solve_kernel.launches, fs.run_exact_adjoint_kernel.launches
    check(n_fwd == N_STEPS and n_adj == N_STEPS,
          f"exact fit launched the K4 forward {n_fwd} and the K4 adjoint {n_adj} times")
    print(f"exact training path: fit {N_STEPS} Lion steps at B={BATCH}, epoch loss {float(res.losses[0]):.6f}, "
          f"{float(res.metrics['samples_per_s'][0]):.1f} samples/s (host clock), K4 forward launches {n_fwd}, "
          f"K4 adjoint launches {n_adj}")

    # Phase 14: timings.
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    steps = [step_ms(cnf, icnf_k, ps_np, xs, gen, dev, 5), step_ms(cnf, icnf_p, ps_np, xs, gen, dev, 1)]
    with torch.no_grad():
        ms_f = cuda_ms(lambda: fs.run_exact_solve_kernel(TSIT5, spec, **kw1), 10)
        ms_pf = cuda_ms(lambda: fs.solve_train_exact_plain(TSIT5, spec, **kw1), 2)
        ms_a = cuda_ms(lambda: fs.run_exact_adjoint_kernel(TSIT5, spec, **kw2), 5)
        ms_pa = cuda_ms(lambda: fs.adjoint_train_exact_plain(TSIT5, spec, **kw2), 1)
    print(f"exact train step B={BATCH} (loss, gradient, Lion): fused {steps[0]:.4f} ms "
          f"({BATCH / steps[0] * 1e3:.1f} samples/s), plain {steps[1]:.4f} ms ({BATCH / steps[1] * 1e3:.1f} samples/s)")
    print(f"K4 forward alone: {ms_f:.4f} ms, plain version {ms_pf:.4f} ms ({int(out_k[2])} steps, "
          f"{ms_f * 1e3 / int(out_k[2]):.1f} us per attempted step)")
    print(f"K4 adjoint alone: {ms_a:.4f} ms, plain version {ms_pa:.4f} ms ({int(adj_k[5])} steps, "
          f"{ms_a * 1e3 / int(adj_k[5]):.1f} us per attempted step)")
    return [
        {"name": fs.K4_KERNEL, "route": "cuda", "source": "continuousnf_tpu_torch/ops/csrc/k4_exact_solve.cu",
         "replaces": "continuousnf_tpu/ops/fused_solve.py:1043", "launches": n_fwd, "max_abs_err": abs_f,
         "ms": ms_f, "plain_ms": ms_pf},
        {"name": fs.K4A_KERNEL, "route": "cuda", "source": "continuousnf_tpu_torch/ops/csrc/k4_exact_adjoint.cu",
         "replaces": "continuousnf_tpu/ops/fused_solve.py:1767", "launches": n_adj, "max_abs_err": abs_a,
         "ms": ms_a, "plain_ms": ms_pa},
    ]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import continuousnf_tpu_torch as cnf
    from continuousnf_tpu_torch.ops import _build
    from continuousnf_tpu_torch.ops import fused_solve as fs
    from continuousnf_tpu_torch.ode.tableaus import TSIT5

    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"card: {smi}")

    t_build = time.perf_counter()
    built = _build.build_libraries([fs.K3_KERNEL, fs.K1_KERNEL, fs.K2_KERNEL, fs.K4_KERNEL, fs.K4A_KERNEL])
    print(f"built {len(built)} kernels in {time.perf_counter() - t_build:.2f} s (one nvcc each, in parallel)")
    for name, (lib_path, log) in built.items():
        print(f"  {lib_path.name}")
        for line in log.splitlines():
            if any(k in line for k in ("entry function", "registers", "spill")):
                print(f"    ptxas: {line.strip()}")
    dz, H = NVARS + NAUG, 3 * (NVARS + NAUG)
    print(f"K4 adjoint dynamic shared memory per 128-thread block at dz={dz}, H={H}: "
          f"{fs._library(fs.K4A_KERNEL).cnf_k4a_smem_bytes(dz, H, 128)} bytes")

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
    records = [serving(cnf, fs, TSIT5, icnf_k, icnf_p, ps, xs, rng, dev)]
    records += training(cnf, fs, TSIT5, icnf_k, icnf_p, ps_np, xs, rng, dev)
    records += exact_training(cnf, fs, TSIT5, dims, ps_np, xs, rng, dev)

    print(json.dumps({"kernels": records}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
