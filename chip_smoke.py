#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card and check them.

    python3 chip_smoke.py

The flagship model: RNODE, nvars = 8, naug = 8, MLP 16 -> 48 -> 16 with
tanh, lambda1 = lambda2 = lambda3 = 1e-2, steer_rate 0.1, tspan (0, 13),
tsit5 at rtol 1e-3 / atol 1e-6, one Gaussian VJP Hutchinson probe, batch
4096.  Weights are random, made from a seed with numpy; the configurations
and their weight and data recipes are those of
continuousnf_tpu_torch/utils/configs.py.  The main paths:
  * serving: `ICNFDist(icnf, Mode.TEST, ps).logpdf` and `.sample`, whose
    solve runs in K3;
  * training: `fit(ICNFModel(icnf, n_epochs=1, batch_size=4096), X)` on
    4 x 4096 samples, four Lion steps whose forward solve runs in K1 and
    whose BACKSOLVE adjoint runs in K2;
  * exact training: the same `fit` on the same model with
    `VecJacMode(fused=True, exact_trace=True)` (no probes: the exact trace
    and ||J||_F), whose forward solve runs in the K4 forward kernel and
    whose adjoint runs in the K4 adjoint kernel;
  * the deep chain: the tabular power6 model of benchmarks/tabular.py
    (RNODE, nvars = 6, MLP 6 -> 64 -> 64 -> 6 tanh, lambda1 = lambda2 =
    1e-2, tspan (0, 1), no steering, one VJP probe, batch 4096) served
    through K7 TEST, trained through the K1 and K2 chain forms and, under
    exact trace, through the K7 exact forward with the plain backward.

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
 10. the K1 and K2 chain forms on the flagship's 2-layer net, held to the
     twins as K1 and K2 are, and CUDA-event timings of the kernels (the
     chain forms beside K1 and K2, at B = 4096 and 512), their plain
     versions and the training step;
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
     exact training step;
 15. the power6 model with Glorot weights and N(0, 0.05) biases, data from
     the recipe of the JAX package's synthetic_tabular (tanh(z mix) + 0.1 z);
 16. the K1 chain form against `solve_train_plain` from nonzero
     accumulators and the K2 chain form against `adjoint_train_plain` from
     its output with its last step as the warm start (bounds as K1's and
     K2's);
 17. K7 TEST against `solve_test_plain` and the K7 exact forward against
     `solve_train_exact_plain` (bounds as K1's);
 18. the serving path (logpdf, sample) through K7 TEST, counters reset just
     before it, and logpdf through the kernel against the plain path;
 19. one Hutchinson loss and its gradient through fused=True and
     fused=False, held as in phase 8;
 20. the training path, `fit` for four Lion steps, counters reset just
     before it: the K1 and K2 chain forms each launched at least four times;
 21. one exact loss and its gradient (K7 exact forward, plain backward),
     held as in phase 12, and the exact `fit` for four Lion steps: K7 exact
     launched at least four times;
 22. CUDA-event timings of the chain kernels, their plain versions, the
     power6 train steps and logpdf.
Every kernel's record carries its bound: the larger of the operations its
inputs need (FMA counted from the widths, times the field evaluations of the
timed call) at 67 TFLOP/s f32 and the bytes of its inputs and outputs at
3.35 TB/s (the H100 SXM's data-sheet rates).  The last lines are the
kernels' JSON record, the nvidia-smi line, and {"ok": true, "device":
{...}}.  Without a CUDA device it exits nonzero and prints no result.
"""

import ctypes
import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
BATCH = 4096
TOL = 1e-4  # relative bound on kernel-vs-plain differences (f32 sums in another order)
GRAD_TOL = 1e-3  # K2's and K4's batch-summed parameter gradients: 4096-term sums in another order
SOLVE_REL = 2e-2  # training gradients vs a float64 rtol 1e-7 solve, relative to max|g|
N_STEPS = 4  # Lion steps of the training path
F32_FLOPS = 67e12  # H100 SXM f32 rate outside the tensor cores
HBM_BYTES = 3.35e12  # H100 SXM memory rate
SOURCE = "continuousnf_tpu_torch/ops/csrc/"


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


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


def hold_forward(label, out_k, out_p) -> float:
    """A forward kernel's (zT, accT, steps, accepted, dt_last) against its
    twin's: equal attempted and accepted steps, finite values, z and each
    accumulator row within TOL * max(1, max|.|).  Returns the largest
    absolute difference."""
    import torch

    check((int(out_k[2]), int(out_k[3])) == (int(out_p[2]), int(out_p[3])),
          f"{label} steps/accepted {int(out_k[2])}/{int(out_k[3])} != plain {int(out_p[2])}/{int(out_p[3])}")
    check(bool(torch.isfinite(out_k[0]).all() and torch.isfinite(out_k[1]).all()), f"{label} output not finite")
    B = out_k[0].shape[0]
    errs = [rel_err(out_k[0], out_p[0])] + [rel_err(a, b) for a, b in zip(out_k[1].reshape(-1, B),
                                                                           out_p[1].reshape(-1, B))]
    check(max(errs) <= TOL, f"{label} differs from its twin: z and accumulator rows relative errors {errs}")
    print(f"{label} vs plain: steps {int(out_k[2])}, relative errors z and accumulators "
          + ", ".join(f"{e:.3e}" for e in errs) + f"; dt_last {float(out_k[4]):.5f} vs {float(out_p[4]):.5f}")
    return max(float((out_k[0] - out_p[0]).abs().max()), float((out_k[1] - out_p[1]).abs().max()))


def hold_adjoint(label, adj_k, adj_p, adj_64) -> float:
    """A Hutchinson adjoint kernel's (z0, acc0, a_z0, g_ws, g_bs, steps,
    accepted) against its twin's: equal steps, finite values, z0 and a_z0
    held to the float64 twin, each gradient within GRAD_TOL * max(1,
    max|g|).  Returns the largest absolute difference."""
    import torch

    check((int(adj_k[5]), int(adj_k[6])) == (int(adj_p[5]), int(adj_p[6])),
          f"{label} steps/accepted {int(adj_k[5])}/{int(adj_k[6])} != plain {int(adj_p[5])}/{int(adj_p[6])}")
    check(all(bool(torch.isfinite(x).all()) for x in [adj_k[0], adj_k[2]] + adj_k[3] + adj_k[4]),
          f"{label} output not finite")
    hold_backward_state(label, adj_k, adj_p, adj_64)
    e_g = [rel_err(a, b) for a, b in zip(adj_k[3] + adj_k[4], adj_p[3] + adj_p[4])]
    check(max(e_g) <= GRAD_TOL, f"{label} parameter gradients (ws, then bs) differ from the twin: {e_g}")
    print(f"{label} vs plain: steps {int(adj_k[5])}, gradient relative errors (ws, then bs) "
          + ", ".join(f"{e:.3e}" for e in e_g))
    return max(float((a - b).abs().max()) for a, b in zip(
        [adj_k[0], adj_k[2]] + adj_k[3] + adj_k[4], [adj_p[0], adj_p[2]] + adj_p[3] + adj_p[4]))


def hold_logpdf(cnf, label, icnf_k, icnf_p, xs, ps) -> None:
    """TEST inference through the kernel against the plain path at B = 16
    and BATCH: equal steps, logp within TOL * max(1, max|logp|)."""
    import torch

    for n in (16, BATCH):
        with torch.no_grad():
            lp_k, _, st_k = cnf.inference(icnf_k, cnf.Mode.TEST, xs[:n], ps)
            lp_p, _, st_p = cnf.inference(icnf_p, cnf.Mode.TEST, xs[:n], ps)
        dlp = float((lp_k - lp_p).abs().max())
        check(int(st_k.steps) == int(st_p.steps), f"{label} B={n}: steps {int(st_k.steps)} != {int(st_p.steps)}")
        check(dlp <= TOL * max(1.0, float(lp_p.abs().max())), f"{label} B={n}: logp differs by {dlp}")
        print(f"{label} logpdf B={n}: steps {int(st_k.steps)}, nfe {int(st_k.nfe)}, max|dlogp| {dlp:.3e}")


def loss_grad(cnf, icnf, ps_np, xs, dev, dtype=None, **kw):
    """One TRAIN loss and its gradient in the params' leaves (w1, b1, w2, b2)."""
    import torch

    dtype = dtype or torch.float32
    p = cnf.params_from_numpy(ps_np, dev)
    leaves = [x.to(dtype).requires_grad_() for layer in p for x in (layer["w"], layer["b"])]
    p = tuple({"w": w, "b": b} for w, b in zip(leaves[::2], leaves[1::2]))
    l, m = cnf.loss_and_metrics(icnf, cnf.Mode.TRAIN, xs.to(dtype), p, **kw)
    return l.detach(), torch.autograd.grad(l, leaves), m


def kernel_record(name, source, replaces, launches, err, ms, plain_ms, fma, B, steps, floats):
    """One kernel's line of the JSON record.  Its bound is the larger of
    2 * fma * B * (1 + 6 steps) operations (fma per sample and field
    evaluation; the first stage, then six per attempted step) at F32_FLOPS
    and 4 * floats bytes (each input read once, each output written once)
    at HBM_BYTES."""
    t_ops = 2.0 * fma * B * (1 + 6 * int(steps)) / F32_FLOPS * 1e3
    t_bytes = 4.0 * floats / HBM_BYTES * 1e3
    return {
        "name": name, "route": "cuda", "source": SOURCE + source, "replaces": replaces,
        "launches": int(launches), "max_abs_err": float(err), "ms": float(ms), "plain_ms": float(plain_ms),
        "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }


def two_layer_fma(dz, H):
    """FMA per sample and field evaluation of the 2-layer kernels, counted
    from the widths: K3 (forward, M dh), K1 (forward, one pullback), K2
    (forward, pullback, both VJPs, the outer products of P entries), the K4
    forward (forward, the dz rows of m) and adjoint (that, ct_m, the VJPs,
    the outer products with g_pm)."""
    P = 2 * dz * H + H + dz
    return {"k3": 3 * dz * H, "k1": 4 * dz * H, "k2": 8 * dz * H + 2 * P,
            "k4": 2 * dz * H + dz * dz * H, "k4a": 3 * dz * dz * H + 6 * dz * H}


def chain_fma(dims):
    """The same for the chain kernels, with S = sum in_i out_i: the K1 chain
    form 2 S (forward, pullback); K7 exact S plus dz columns of H1 +
    sum_(i>0) in_i out_i; K7 TEST S plus dz columns of H1 + the middle
    layers' in_i out_i + H_(N-1) (only the diagonal entry of the last
    layer's product); the K2 chain form 6 S + sum out_i (four passes and the
    outer products)."""
    pairs = list(zip(dims[:-1], dims[1:]))
    S = sum(a * b for a, b in pairs)
    middle = sum(a * b for a, b in pairs[1:-1])
    return {"k1c": 2 * S, "k7e": S + dims[0] * (dims[1] + middle + dims[-2] * dims[-1]),
            "k7t": S + dims[0] * (dims[1] + middle + dims[-2]), "k2c": 6 * S + sum(dims[1:])}


def hold_gradients(label, l_k, g_k, l_p, g_p, l_t, g_t):
    """The fused and plain losses within 1e-4 relative, and both gradients
    within SOLVE_REL * max|g| of the float64 rtol 1e-7 solve.  The two
    backward solves run on different step grids: the fused one is
    warm-started from the forward's last step and takes about half the
    plain one's steps.  At the flagship the JAX package's own fused gradient
    sits 3.5e-3 * max|g| from such a solve and its plain one 5e-4 (PERF.md),
    so rtol 2e-3 between them is out of reach there."""
    check(abs(float(l_k - l_p)) <= TOL * max(1.0, abs(float(l_p))), f"{label} losses {float(l_k)} vs {float(l_p)}")
    names = [f"{x}{i + 1}" for i in range(len(g_t) // 2) for x in ("w", "b")]
    for name, a, b, t in zip(names, g_k, g_p, g_t):
        d_k, d_p = float((a.double() - t).abs().max()), float((b.double() - t).abs().max())
        scale = float(t.abs().max())
        check(max(d_k, d_p) <= SOLVE_REL * scale,
              f"{label} g_{name}: fused {d_k} and plain {d_p} from the float64 solve, max|g| {scale}")
        print(f"{label} g_{name}: max|g| {scale:.4e}; distance to the float64 rtol 1e-7 solve: fused {d_k:.4e}, "
              f"plain {d_p:.4e}; fused vs plain {float((a - b).abs().max()):.4e}")


def fit_path(cnf, fs, icnf, ps_np, dev, X):
    """`fit` for one epoch of N_STEPS Lion steps at BATCH on the data X
    (numpy), every launch counter reset just before it.  Checks the step
    count and finite losses and params; returns the FitResult."""
    import torch

    X = torch.from_numpy(X).to(dev)
    lion_steps = []

    def lion(params):
        opt = cnf.Lion(params, lr=1e-3)
        opt.register_step_post_hook(lambda *_: lion_steps.append(1))
        return opt

    fs.reset_launches()
    res = cnf.fit(cnf.ICNFModel(icnf, optimizers=(lion,), n_epochs=1, batch_size=BATCH), X,
                  ps=cnf.params_from_numpy(ps_np, dev), seed=SEED)
    torch.cuda.synchronize()
    check(len(lion_steps) == N_STEPS, f"{len(lion_steps)} Lion steps, expected {N_STEPS}")
    check(bool(np.isfinite(res.losses).all()), f"fit losses {res.losses}")
    check(all(bool(torch.isfinite(x).all()) for layer in res.ps for x in layer.values()), "fitted params not finite")
    return res


def paired_ms(fa, fb, reps: int):
    """CUDA-event milliseconds per call of fa and of fb, each the mean of two
    timings taken in the order a, b, b, a."""
    from continuousnf_tpu_torch.utils.configs import cuda_ms

    a1, b1, b2, a2 = cuda_ms(fa, reps), cuda_ms(fb, reps), cuda_ms(fb, reps), cuda_ms(fa, reps)
    return (a1 + a2) / 2, (b1 + b2) / 2


def step_ms(cnf, icnf, ps_np, xs, gen, dev, reps):
    """CUDA-event milliseconds of one step of the step body (loss, gradient,
    Lion)."""
    from continuousnf_tpu_torch.utils.configs import cuda_ms

    p = cnf.params_from_numpy(ps_np, dev)
    leaves = [x.requires_grad_() for layer in p for x in (layer["w"], layer["b"])]
    step = cnf.parallel.make_train_step_body(icnf, cnf.Lion(leaves, lr=1e-3))
    return cuda_ms(lambda: step(p, xs, gen), reps)


def serving(cnf, fs, TSIT5, icnf_k, icnf_p, ps, xs, rng, dev):
    """Phases 5 and 6 and K3's timings.  Returns K3's record."""
    import torch
    from continuousnf_tpu_torch.utils.configs import cuda_ms

    opts = icnf_k.solver
    zdim = icnf_k.zdim
    z0 = torch.cat([xs, torch.zeros((BATCH, icnf_k.naugmented), device=dev)], dim=1)
    dlogp0 = torch.from_numpy(rng.normal(0.0, 0.1, BATCH).astype("float32")).to(dev)
    spec = fs.chain_spec(icnf_k.nn, zdim)
    kw = dict(
        rtol=opts.rtol, atol=opts.atol, max_steps=opts.max_steps,
        ws=[p["w"] for p in ps], bs=[p["b"] for p in ps], z0=z0, dlogp0=dlogp0,
        t0=torch.tensor(0.0, device=dev), t1=torch.tensor(icnf_k.tspan[1], device=dev),
        dt_init=torch.tensor(0.05, device=dev),
    )
    with torch.no_grad():
        out_k = fs.run_solve_kernel(TSIT5, spec, **kw)
        out_p = fs.solve_test_plain(TSIT5, spec, **kw)
    torch.cuda.synchronize()
    err_k3 = hold_forward("K3", out_k, out_p)
    steps_k = int(out_k[2])
    hold_logpdf(cnf, "flagship", icnf_k, icnf_p, xs, ps)

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
    check(tuple(samples.shape) == (BATCH, icnf_k.nvars) and bool(torch.isfinite(samples).all()), "samples not finite")
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
    dz, H = zdim, spec.out_dims[0]
    return kernel_record(fs.K3_KERNEL, "k3_test_solve.cu", "continuousnf_tpu/ops/fused_solve.py:1043", launches,
                         err_k3, ms_kernel, ms_plain, two_layer_fma(dz, H)["k3"], BATCH, steps_k,
                         2 * dz * H + H + dz + 2 * BATCH * (dz + 1))


def training(cnf, fs, TSIT5, icnf_k, icnf_p, ps_np, xs, rng, dev):
    """Phases 7 to 10 for K1, K2 and the training step.  Returns their
    records."""
    import torch
    from continuousnf_tpu_torch.utils.configs import cuda_ms, make_icnf, model_data

    opts = icnf_k.solver
    zdim = icnf_k.zdim
    ps = cnf.params_from_numpy(ps_np, dev)
    spec = fs.chain_spec(icnf_k.nn, zdim)
    T = lambda a: torch.from_numpy(a.astype("float32")).to(dev)
    eps = T(rng.normal(size=(1, BATCH, zdim)))
    base = dict(norm_z=True, norm_j=True, rtol=opts.rtol, atol=opts.atol, max_steps=opts.max_steps,
                ws=[p["w"] for p in ps], bs=[p["b"] for p in ps], eps=eps)

    # Phase 7a: K1 against its twin, from nonzero accumulators.
    kw1 = dict(base, z0=torch.cat([xs, torch.zeros((BATCH, icnf_k.naugmented), device=dev)], dim=1),
               acc0=T(rng.normal(0.0, 0.1, (3, BATCH))), t0=torch.tensor(0.0, device=dev),
               t1=torch.tensor(icnf_k.tspan[1], device=dev), dt_init=torch.tensor(0.05, device=dev))
    with torch.no_grad():
        out_k = fs.run_train_solve_kernel(TSIT5, spec, **kw1)
        out_p = fs.solve_train_plain(TSIT5, spec, **kw1)
    torch.cuda.synchronize()
    abs1 = hold_forward("K1", out_k, out_p)

    # Phase 7b: K2 against its twin from K1's final state, a loss-like
    # cotangent and K1's last step as the warm start.
    kw2 = dict(base, zT=out_k[0], accT=out_k[1], azT=T(rng.normal(0.0, 1.0 / BATCH, (BATCH, zdim))),
               aaccT=T(np.stack([np.full(BATCH, 1.0 / BATCH), np.full(BATCH, 1e-2 / BATCH),
                                 np.full(BATCH, 1e-2 / BATCH)])),
               t_hi=torch.tensor(icnf_k.tspan[1], device=dev), t_lo=torch.tensor(0.0, device=dev),
               dt_init=-out_k[4].abs())
    with torch.no_grad():
        adj_k = fs.run_adjoint_kernel(TSIT5, spec, **kw2)
        adj_p = fs.adjoint_train_plain(TSIT5, spec, **kw2)
        adj_64 = fs.adjoint_train_plain(TSIT5, spec, **{k: to64(v) for k, v in kw2.items()})
    torch.cuda.synchronize()
    abs2 = hold_adjoint("K2", adj_k, adj_p, adj_64)

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
    icnf_t = make_icnf("flagship", dev, fused=False, dtype=torch.float64,
                       solver=cnf.SolverOptions(rtol=1e-7, atol=1e-9))
    l_t, g_t, _ = loss_grad(cnf, icnf_t, ps_np, xs, dev, torch.float64, eps=eps_s.double(), steer_r=steer_r)
    torch.cuda.synchronize()
    hold_gradients("Hutchinson", l_k, g_k, l_p, g_p, l_t, g_t)
    print(f"train step B={BATCH}: loss fused {float(l_k):.6f} plain {float(l_p):.6f} float64 {float(l_t):.6f}, "
          f"forward NFE {int(m_k['nfe'])}")

    # Phase 9: the training path, counters reset just before it.
    res = fit_path(cnf, fs, icnf_k, ps_np, dev, model_data("flagship", np.random.default_rng(SEED + 2), N_STEPS * BATCH))
    n_k1, n_k2 = fs.run_train_solve_kernel.launches, fs.run_adjoint_kernel.launches
    check(n_k1 >= N_STEPS and n_k2 >= N_STEPS, f"fit launched K1 {n_k1} and K2 {n_k2} times")
    print(f"training path: fit {N_STEPS} Lion steps at B={BATCH}, epoch loss {float(res.losses[0]):.6f}, "
          f"{float(res.metrics['samples_per_s'][0]):.1f} samples/s (host clock), K1 launches {n_k1}, "
          f"K2 launches {n_k2}")

    # Phase 10: the K1 and K2 chain forms on this 2-layer net, held to the
    # same twins, then timings.  The chain forms are timed beside K1 and K2
    # (order 2-layer, chain, chain, 2-layer) at BATCH and BATCH / 8: the
    # fused solve keeps K1 and K2 for 2-layer nets where they are faster.
    with torch.no_grad():
        out_c = fs.run_chain_train_solve_kernel(TSIT5, spec, **kw1)
        adj_c = fs.run_chain_adjoint_kernel(TSIT5, spec, **kw2)
    torch.cuda.synchronize()
    hold_forward("K1 chain form, 2 layers", out_c, out_p)
    hold_adjoint("K2 chain form, 2 layers", adj_c, adj_p, adj_64)
    ms_step = step_ms(cnf, icnf_k, ps_np, xs, gen, dev, 5)
    ms_step_p = step_ms(cnf, icnf_p, ps_np, xs, gen, dev, 1)
    with torch.no_grad():
        ms_k1, ms_k1c = paired_ms(lambda: fs.run_train_solve_kernel(TSIT5, spec, **kw1),
                                  lambda: fs.run_chain_train_solve_kernel(TSIT5, spec, **kw1), 10)
        ms_p1 = cuda_ms(lambda: fs.solve_train_plain(TSIT5, spec, **kw1), 3)
        ms_k2, ms_k2c = paired_ms(lambda: fs.run_adjoint_kernel(TSIT5, spec, **kw2),
                                  lambda: fs.run_chain_adjoint_kernel(TSIT5, spec, **kw2), 10)
        ms_p2 = cuda_ms(lambda: fs.adjoint_train_plain(TSIT5, spec, **kw2), 2)
        b = BATCH // 8
        kw1_b = dict(kw1, z0=kw1["z0"][:b], eps=eps[:, :b], acc0=kw1["acc0"][:, :b])
        out_b = fs.run_train_solve_kernel(TSIT5, spec, **kw1_b)
        kw2_b = dict(kw2, eps=eps[:, :b], zT=out_b[0], accT=out_b[1], azT=kw2["azT"][:b], aaccT=kw2["aaccT"][:, :b],
                     dt_init=-out_b[4].abs())
        small = [paired_ms(lambda: fs.run_train_solve_kernel(TSIT5, spec, **kw1_b),
                           lambda: fs.run_chain_train_solve_kernel(TSIT5, spec, **kw1_b), 10),
                 paired_ms(lambda: fs.run_adjoint_kernel(TSIT5, spec, **kw2_b),
                           lambda: fs.run_chain_adjoint_kernel(TSIT5, spec, **kw2_b), 10)]
    print(f"train step B={BATCH} (loss, gradient, Lion): fused {ms_step:.4f} ms "
          f"({BATCH / ms_step * 1e3:.1f} samples/s), plain {ms_step_p:.4f} ms ({BATCH / ms_step_p * 1e3:.1f} samples/s)")
    print(f"K1 alone: {ms_k1:.4f} ms, plain version {ms_p1:.4f} ms ({int(out_k[2])} steps); "
          f"the K1 chain form on the same input {ms_k1c:.4f} ms ({ms_k1c / ms_k1:.3f}x)")
    print(f"K2 alone: {ms_k2:.4f} ms, plain version {ms_p2:.4f} ms ({int(adj_k[5])} steps); "
          f"the K2 chain form on the same input {ms_k2c:.4f} ms ({ms_k2c / ms_k2:.3f}x)")
    print(f"B={b}: K1 {small[0][0]:.4f} ms, the K1 chain form {small[0][1]:.4f} ms ({small[0][1] / small[0][0]:.3f}x); "
          f"K2 {small[1][0]:.4f} ms, the K2 chain form {small[1][1]:.4f} ms ({small[1][1] / small[1][0]:.3f}x)")
    dz, H = zdim, spec.out_dims[0]
    fma, P = two_layer_fma(dz, H), 2 * dz * H + H + dz
    return [
        kernel_record(fs.K1_KERNEL, "k1_train_solve.cu", "continuousnf_tpu/ops/fused_solve.py:1043", n_k1, abs1,
                      ms_k1, ms_p1, fma["k1"], BATCH, out_k[2], P + BATCH * (3 * dz + 6)),
        kernel_record(fs.K2_KERNEL, "k2_train_adjoint.cu", "continuousnf_tpu/ops/fused_solve.py:1767", n_k2, abs2,
                      ms_k2, ms_p2, fma["k2"], BATCH, adj_k[5], 2 * P + BATCH * (5 * dz + 9)),
    ]


def exact_training(cnf, fs, TSIT5, ps_np, xs, rng, dev):
    """Phases 11 to 14 for the K4 forward, the K4 adjoint and the exact
    training step.  Returns their records."""
    import torch
    from continuousnf_tpu_torch.utils.configs import cuda_ms, make_icnf, model_data

    icnf_k, icnf_p = (make_icnf("flagship", dev, fused=fused, exact=True) for fused in (True, False))
    zdim = icnf_k.zdim
    opts = icnf_k.solver
    ps = cnf.params_from_numpy(ps_np, dev)
    spec = fs.chain_spec(icnf_k.nn, zdim)
    T = lambda a: torch.from_numpy(a.astype("float32")).to(dev)
    base = dict(norm_z=True, norm_j=True, rtol=opts.rtol, atol=opts.atol, max_steps=opts.max_steps,
                ws=[p["w"] for p in ps], bs=[p["b"] for p in ps])

    # Phase 11a: the K4 forward against its twin, from nonzero accumulators.
    kw1 = dict(base, z0=torch.cat([xs, torch.zeros((BATCH, icnf_k.naugmented), device=dev)], dim=1),
               acc0=T(rng.normal(0.0, 0.1, (3, BATCH))), t0=torch.tensor(0.0, device=dev),
               t1=torch.tensor(icnf_k.tspan[1], device=dev), dt_init=torch.tensor(0.05, device=dev))
    with torch.no_grad():
        out_k = fs.run_exact_solve_kernel(TSIT5, spec, **kw1)
        out_p = fs.solve_train_exact_plain(TSIT5, spec, **kw1)
    torch.cuda.synchronize()
    abs_f = hold_forward("K4 forward", out_k, out_p)

    # Phase 11b: the K4 adjoint against its twin from the K4 forward's final
    # state, a loss-like cotangent and its last step as the warm start.
    kw2 = dict(base, zT=out_k[0], accT=out_k[1], azT=T(rng.normal(0.0, 1.0 / BATCH, (BATCH, zdim))),
               aaccT=T(np.stack([np.full(BATCH, 1.0 / BATCH), np.full(BATCH, 1e-2 / BATCH),
                                 np.full(BATCH, 1e-2 / BATCH)])),
               t_hi=torch.tensor(icnf_k.tspan[1], device=dev), t_lo=torch.tensor(0.0, device=dev),
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
    icnf_t = make_icnf("flagship", dev, fused=False, exact=True, dtype=torch.float64,
                       solver=cnf.SolverOptions(rtol=1e-7, atol=1e-9))
    l_t, g_t, _ = loss_grad(cnf, icnf_t, ps_np, xs, dev, torch.float64, steer_r=0.05)
    torch.cuda.synchronize()
    hold_gradients("exact", l_k, g_k, l_p, g_p, l_t, g_t)
    print(f"exact train step B={BATCH}: loss fused {float(l_k):.6f} plain {float(l_p):.6f} float64 {float(l_t):.6f}, "
          f"forward NFE {int(m_k['nfe'])}")

    # Phase 13: the exact training path, counters reset just before it.
    res = fit_path(cnf, fs, icnf_k, ps_np, dev, model_data("flagship", np.random.default_rng(SEED + 3), N_STEPS * BATCH))
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
    dz, H = zdim, spec.out_dims[0]
    fma, P = two_layer_fma(dz, H), 2 * dz * H + H + dz
    return [
        kernel_record(fs.K4_KERNEL, "k4_exact_solve.cu", "continuousnf_tpu/ops/fused_solve.py:1043", n_fwd, abs_f,
                      ms_f, ms_pf, fma["k4"], BATCH, out_k[2], P + BATCH * (2 * dz + 6)),
        kernel_record(fs.K4A_KERNEL, "k4_exact_adjoint.cu", "continuousnf_tpu/ops/fused_solve.py:1767", n_adj, abs_a,
                      ms_a, ms_pa, fma["k4a"], BATCH, adj_k[5], 2 * P + BATCH * (4 * dz + 9)),
    ]


def deep_chain(cnf, fs, TSIT5, rng, dev):
    """Phases 15 to 22: the power6 model through the chain kernels.  Returns
    their records."""
    import torch
    from continuousnf_tpu_torch.utils.configs import MODELS, cuda_ms, glorot_params, make_icnf, model_data

    dims = MODELS["power6"]["dims"]
    dz = dims[-1]
    ps_np = glorot_params(rng, dims)
    xs_np = model_data("power6", rng, BATCH)
    ps = cnf.params_from_numpy(ps_np, dev)
    xs = torch.from_numpy(xs_np).to(dev)
    T = lambda a: torch.from_numpy(a.astype("float32")).to(dev)

    def model(fused: bool, exact: bool = False, dtype=torch.float32, **kw):
        return make_icnf("power6", dev, fused=fused, exact=exact, dtype=dtype, **kw)

    icnf_k, icnf_p = model(True), model(False)
    opts = icnf_k.solver
    spec = fs.chain_spec(icnf_k.nn, dz)
    widths = ", ".join(str(w) for w in dims)
    for lib_name, fn in ((fs.K1C_KERNEL, "cnf_k1c_smem_bytes"), (fs.K7_KERNEL, "cnf_k7_smem_bytes"),
                         (fs.K2C_KERNEL, "cnf_k2c_smem_bytes")):
        arr = (ctypes.c_int * len(dims))(*dims)
        sizes = {blk: getattr(fs._library(lib_name), fn)(len(dims) - 1, arr, blk) for blk in (128, 64, 32)}
        print(f"{lib_name} dynamic shared memory per block at widths ({widths}): "
              + ", ".join(f"{v} bytes at {k} threads" for k, v in sizes.items()))
    base = dict(rtol=opts.rtol, atol=opts.atol, max_steps=opts.max_steps,
                ws=[p["w"] for p in ps], bs=[p["b"] for p in ps])
    span = dict(t0=torch.tensor(0.0, device=dev), t1=torch.tensor(1.0, device=dev),
                dt_init=torch.tensor(0.05, device=dev))

    # Phase 16: the K1 chain form from nonzero accumulators, the K2 chain form
    # from its output.
    eps = T(rng.normal(size=(1, BATCH, dz)))
    train = dict(base, norm_z=True, norm_j=True, eps=eps)
    kw1 = dict(train, z0=xs, acc0=T(rng.normal(0.0, 0.1, (3, BATCH))), **span)
    with torch.no_grad():
        out_k = fs.run_chain_train_solve_kernel(TSIT5, spec, **kw1)
        out_p = fs.solve_train_plain(TSIT5, spec, **kw1)
    torch.cuda.synchronize()
    abs1 = hold_forward("K1 chain form", out_k, out_p)
    kw2 = dict(train, zT=out_k[0], accT=out_k[1], azT=T(rng.normal(0.0, 1.0 / BATCH, (BATCH, dz))),
               aaccT=T(np.stack([np.full(BATCH, 1.0 / BATCH), np.full(BATCH, 1e-2 / BATCH),
                                 np.full(BATCH, 1e-2 / BATCH)])),
               t_hi=torch.tensor(1.0, device=dev), t_lo=torch.tensor(0.0, device=dev), dt_init=-out_k[4].abs())
    with torch.no_grad():
        adj_k = fs.run_chain_adjoint_kernel(TSIT5, spec, **kw2)
        adj_p = fs.adjoint_train_plain(TSIT5, spec, **kw2)
        adj_64 = fs.adjoint_train_plain(TSIT5, spec, **{k: to64(v) for k, v in kw2.items()})
    torch.cuda.synchronize()
    abs2 = hold_adjoint("K2 chain form", adj_k, adj_p, adj_64)

    # Phase 17: K7 TEST and the K7 exact forward.
    kwt = dict(base, z0=xs, dlogp0=T(rng.normal(0.0, 0.1, BATCH)), **span)
    kwe = dict(base, norm_z=True, norm_j=True, z0=xs, acc0=T(rng.normal(0.0, 0.1, (3, BATCH))), **span)
    with torch.no_grad():
        t_k = fs.run_chain_test_solve_kernel(TSIT5, spec, **kwt)
        t_p = fs.solve_test_plain(TSIT5, spec, **kwt)
        e_k = fs.run_chain_exact_solve_kernel(TSIT5, spec, **kwe)
        e_p = fs.solve_train_exact_plain(TSIT5, spec, **kwe)
    torch.cuda.synchronize()
    abs_t = hold_forward("K7 TEST", t_k, t_p)
    abs_e = hold_forward("K7 exact", e_k, e_p)

    # Phase 18: serving through K7 TEST, counters reset just before it.
    hold_logpdf(cnf, "power6", icnf_k, icnf_p, xs, ps)
    dist = cnf.ICNFDist(icnf_k, cnf.Mode.TEST, ps)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    k7t = fs.run_chain_test_solve_kernel
    fs.reset_launches()
    with torch.no_grad():
        lp = dist.logpdf(xs)
        n_logpdf = k7t.launches
        samples = dist.sample(BATCH, generator=gen)
        n_sample = k7t.launches - n_logpdf
    torch.cuda.synchronize()
    n_k7t = k7t.launches
    others = {k: w.launches for k, w in fs.KERNEL_WRAPPERS.items() if w is not k7t and w.launches}
    check(n_logpdf >= 1 and n_sample >= 1 and not others,
          f"K7 TEST launches: logpdf {n_logpdf}, sample {n_sample}; other kernels {others}")
    check(tuple(lp.shape) == (BATCH,) and bool(torch.isfinite(lp).all()), "power6 logpdf not finite")
    check(tuple(samples.shape) == (BATCH, dz) and bool(torch.isfinite(samples).all()), "power6 samples not finite")
    print(f"power6 serving path: logpdf mean {float(lp.mean()):.4f}, sample mean |x| "
          f"{float(samples.abs().mean()):.4f}, K7 TEST launches {n_k7t}")

    # Phase 19: the Hutchinson loss and its gradient through both paths.
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    eps_s = icnf_k.draw_eps(gen, BATCH, dev)
    n1, n2 = fs.run_chain_train_solve_kernel.launches, fs.run_chain_adjoint_kernel.launches
    l_k, g_k, m_k = loss_grad(cnf, icnf_k, ps_np, xs, dev, eps=eps_s)
    check((fs.run_chain_train_solve_kernel.launches, fs.run_chain_adjoint_kernel.launches) == (n1 + 1, n2 + 1),
          "the fused power6 gradient did not run the K1 and K2 chain forms once each")
    l_p, g_p, _ = loss_grad(cnf, icnf_p, ps_np, xs, dev, eps=eps_s)
    icnf_t = model(False, dtype=torch.float64, solver=cnf.SolverOptions(rtol=1e-7, atol=1e-9))
    l_t, g_t, _ = loss_grad(cnf, icnf_t, ps_np, xs, dev, torch.float64, eps=eps_s.double())
    torch.cuda.synchronize()
    hold_gradients("power6 Hutchinson", l_k, g_k, l_p, g_p, l_t, g_t)
    print(f"power6 train step B={BATCH}: loss fused {float(l_k):.6f} plain {float(l_p):.6f} "
          f"float64 {float(l_t):.6f}, forward NFE {int(m_k['nfe'])}")

    # Phase 20: the training path, counters reset just before it.
    X = model_data("power6", np.random.default_rng(SEED + 7), N_STEPS * BATCH)
    res = fit_path(cnf, fs, icnf_k, ps_np, dev, X)
    n_k1c, n_k2c = fs.run_chain_train_solve_kernel.launches, fs.run_chain_adjoint_kernel.launches
    check(n_k1c >= N_STEPS and n_k2c >= N_STEPS, f"power6 fit launched the K1 chain form {n_k1c} and the K2 chain "
          f"form {n_k2c} times")
    print(f"power6 training path: fit {N_STEPS} Lion steps at B={BATCH}, epoch loss {float(res.losses[0]):.6f}, "
          f"{float(res.metrics['samples_per_s'][0]):.1f} samples/s (host clock), K1 chain form launches {n_k1c}, "
          f"K2 chain form launches {n_k2c}")

    # Phase 21: the exact loss and gradient (K7 exact forward, plain
    # backward), then the exact training path.
    icnf_ek, icnf_ep = model(True, True), model(False, True)
    n7 = fs.run_chain_exact_solve_kernel.launches
    l_k, g_k, m_k = loss_grad(cnf, icnf_ek, ps_np, xs, dev)
    check(fs.run_chain_exact_solve_kernel.launches == n7 + 1, "the exact power6 gradient did not run K7 exact once")
    l_p, g_p, _ = loss_grad(cnf, icnf_ep, ps_np, xs, dev)
    icnf_t = model(False, True, torch.float64, solver=cnf.SolverOptions(rtol=1e-7, atol=1e-9))
    l_t, g_t, _ = loss_grad(cnf, icnf_t, ps_np, xs, dev, torch.float64)
    torch.cuda.synchronize()
    hold_gradients("power6 exact", l_k, g_k, l_p, g_p, l_t, g_t)
    res = fit_path(cnf, fs, icnf_ek, ps_np, dev, X)
    n_k7e = fs.run_chain_exact_solve_kernel.launches
    check(n_k7e >= N_STEPS, f"power6 exact fit launched K7 exact {n_k7e} times")
    print(f"power6 exact training path: fit {N_STEPS} Lion steps at B={BATCH}, epoch loss "
          f"{float(res.losses[0]):.6f}, {float(res.metrics['samples_per_s'][0]):.1f} samples/s (host clock), "
          f"K7 exact launches {n_k7e}")

    # Phase 22: timings.
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    ms_step = step_ms(cnf, icnf_k, ps_np, xs, gen, dev, 5)
    ms_step_p = step_ms(cnf, icnf_p, ps_np, xs, gen, dev, 1)
    ms_estep = step_ms(cnf, icnf_ek, ps_np, xs, gen, dev, 2)
    with torch.no_grad():
        _, _, st = cnf.inference(icnf_k, cnf.Mode.TEST, xs, ps)
        ms_lp = cuda_ms(lambda: dist.logpdf(xs), 10)
        ms_lp_p = cuda_ms(lambda: cnf.inference(icnf_p, cnf.Mode.TEST, xs, ps), 2)
        times = {}
        for name, kernel, plain, kw in (
            ("k1c", fs.run_chain_train_solve_kernel, fs.solve_train_plain, kw1),
            ("k2c", fs.run_chain_adjoint_kernel, fs.adjoint_train_plain, kw2),
            ("k7t", fs.run_chain_test_solve_kernel, fs.solve_test_plain, kwt),
            ("k7e", fs.run_chain_exact_solve_kernel, fs.solve_train_exact_plain, kwe),
        ):
            times[name] = (cuda_ms(lambda: kernel(TSIT5, spec, **kw), 5), cuda_ms(lambda: plain(TSIT5, spec, **kw), 1))
    print(f"power6 train step B={BATCH} (loss, gradient, Lion): fused {ms_step:.4f} ms "
          f"({BATCH / ms_step * 1e3:.1f} samples/s), plain {ms_step_p:.4f} ms ({BATCH / ms_step_p * 1e3:.1f} samples/s)")
    print(f"power6 exact train step B={BATCH}: fused forward, plain backward {ms_estep:.4f} ms "
          f"({BATCH / ms_estep * 1e3:.1f} samples/s)")
    print(f"power6 logpdf B={BATCH}: kernel {ms_lp:.4f} ms ({BATCH / ms_lp * 1e3:.1f} evals/s), plain {ms_lp_p:.4f} ms; "
          f"steps {int(st.steps)}, NFE {int(st.nfe)}")
    steps = {"k1c": out_k[2], "k2c": adj_k[5], "k7t": t_k[2], "k7e": e_k[2]}
    for name, label in (("k1c", "K1 chain form"), ("k2c", "K2 chain form"), ("k7t", "K7 TEST"), ("k7e", "K7 exact")):
        ms_k, ms_p = times[name]
        n = int(steps[name])
        print(f"{label} alone: {ms_k:.4f} ms, plain version {ms_p:.4f} ms ({n} steps, "
              f"{ms_k * 1e3 / max(n, 1):.1f} us per attempted step)")
    fma = chain_fma(dims)
    P = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    return [
        kernel_record(fs.K1C_KERNEL, "k1_chain_solve.cu", "continuousnf_tpu/ops/fused_solve.py:1043", n_k1c, abs1,
                      *times["k1c"], fma["k1c"], BATCH, out_k[2], P + BATCH * (3 * dz + 6)),
        kernel_record(fs.K2C_KERNEL, "k2_chain_adjoint.cu", "continuousnf_tpu/ops/fused_solve.py:1767", n_k2c, abs2,
                      *times["k2c"], fma["k2c"], BATCH, adj_k[5], 2 * P + BATCH * (5 * dz + 9)),
        kernel_record(fs.K7_KERNEL + "/test", "k7_chain_solve.cu", "continuousnf_tpu/ops/fused_solve.py:1043",
                      n_k7t, abs_t, *times["k7t"], fma["k7t"], BATCH, t_k[2], P + BATCH * (2 * dz + 2)),
        kernel_record(fs.K7_KERNEL + "/exact", "k7_chain_solve.cu", "continuousnf_tpu/ops/fused_solve.py:1043",
                      n_k7e, abs_e, *times["k7e"], fma["k7e"], BATCH, e_k[2], P + BATCH * (2 * dz + 6)),
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
    from continuousnf_tpu_torch.utils.configs import MODELS, glorot_params, make_icnf, model_data

    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"card: {smi}")

    t_build = time.perf_counter()
    built = _build.build_libraries([fs.K3_KERNEL, fs.K1_KERNEL, fs.K2_KERNEL, fs.K4_KERNEL, fs.K4A_KERNEL,
                                    fs.K1C_KERNEL, fs.K2C_KERNEL, fs.K7_KERNEL])
    print(f"built {len(built)} kernels in {time.perf_counter() - t_build:.2f} s (one nvcc each, in parallel)")
    for name, (lib_path, log) in built.items():
        print(f"  {lib_path.name}")
        for line in log.splitlines():
            if any(k in line for k in ("entry function", "registers", "spill")):
                print(f"    ptxas: {line.strip()}")
    dims = MODELS["flagship"]["dims"]
    dz, H = dims[0], dims[1]
    print(f"K4 adjoint dynamic shared memory per 128-thread block at dz={dz}, H={H}: "
          f"{fs._library(fs.K4A_KERNEL).cnf_k4a_smem_bytes(dz, H, 128)} bytes")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    rng = np.random.default_rng(SEED)
    ps_np = glorot_params(rng, dims)
    xs_np = model_data("flagship", rng, BATCH)
    ps = cnf.params_from_numpy(ps_np, dev)
    xs = torch.from_numpy(xs_np).to(dev)
    icnf_k, icnf_p = make_icnf("flagship", dev, fused=True), make_icnf("flagship", dev, fused=False)
    records = [serving(cnf, fs, TSIT5, icnf_k, icnf_p, ps, xs, rng, dev)]
    records += training(cnf, fs, TSIT5, icnf_k, icnf_p, ps_np, xs, rng, dev)
    records += exact_training(cnf, fs, TSIT5, ps_np, xs, rng, dev)
    records += deep_chain(cnf, fs, TSIT5, rng, dev)

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
