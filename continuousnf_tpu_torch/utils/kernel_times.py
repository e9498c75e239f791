"""CUDA-event times of every solve kernel at the chip smoke's shapes.

    python continuousnf_tpu_torch/utils/kernel_times.py [--tableau tsit5] [--reps 10] [--models flagship,power6,...]
        [--probes K] [--jvp]

builds the kernels of the `continuousnf_tpu_torch` package on the import
path and times, on one CUDA card, each kernel alone on fixed inputs: K3,
K1, K2 and the K4 forward and adjoint on the flagship (MLP 16 -> 48 -> 16,
B = 4096, tspan (0, 13)), the K1 and K2 chain forms and K7 TEST and exact
on power6 (MLP 6 -> 64 -> 64 -> 6, B = 4096, tspan (0, 1)) and on the
conditional recipe (MLP 2 -> 64 -> 64 -> 1 on [x | y], B = 4096, tspan
(0, 13); the "_cond" keys) and, when `--models` names it, the wide forms of
those four on miniboone43 (MLP 43 -> 128 -> 128 -> 43, B = 2048, tspan
(0, 1); the "_wide" keys) and on hepmass42 the five routes of a 2-layer
net past state width 32 (MLP 42 -> 126 -> 42, B = 4096, tspan (0, 13);
the "_hepmass" keys: wide K3 and wide K5 from its output, the wide K1 and
K2 chain forms, wide K7 exact and the wide K4 adjoint from its output) and
on miniboone860 the streamed forms of the chain kernels (MLP 43 -> 860 ->
860 -> 43, B = 1024, tspan (0, 1); the "_stream" keys: streamed K7 TEST,
the streamed K1 and K2 chain forms, streamed K7 exact), on miniboone86 the
streamed forms of a 2-layer net past the wide limits (MLP 86 -> 258 -> 86,
B = 4096, tspan (0, 13); the "_mb86" keys: streamed K3 and streamed K5 from
its output, the streamed K1 and K2 chain forms) and on
cond_hepmass42 the COND instances of the wide forms (CondRNODE, MLP 43 ->
126 -> 42 on [z | ys], B = 4096, tspan (0, 13); the "_condhep" keys: wide
K3 COND and wide K5 COND from its output, the wide K1 and K2 chain forms'
COND instances, wide K7 exact COND and the wide K4 adjoint COND from its
output),
Glorot weights and data from numpy seeds, under
one tableau (rtol 1e-3 / atol 1e-6; the README tolerances for verner65).
Where the package has K5 (the TEST adjoint), it is timed on the flagship
from K3's output, with a loss-like cotangent and K3's last step as the warm
start (the "k5" key), as `chip_smoke.py` phase 47 holds it; where it
has K10 (the per-stage TRAIN field), one launch on the flagship's z0 and
probe (the "k10" key, [ms, 0]: a call's time, which its launch dominates).
With `--probes K` (K Gaussian probes) or `--jvp` (forward-mode probes) it
times only the Hutchinson kernels, K1 and K2 and their chain forms, through
their probe instances (K6; the "/K<K>" or "/jvp-K<K>" keys), with the wide
forms on miniboone43 and hepmass42, the wide forms' probe COND instances on
cond_hepmass42 (K6 x K8) and the streamed forms on miniboone860 and
miniboone86 where `--models` names them.  Each time is the mean of `reps` calls after one warm-up call.  It prints the card's name and power limit, then
one JSON line {"tableau": ..., "kernels": {name: [ms, attempted steps]}}.

By default it uses only wrappers that earlier versions of the package have
too, so running it as a file with PYTHONPATH set to another checkout times
that checkout's kernels: run two checkouts alternately, one after the
other on the same card, to compare them.
"""

import argparse
import json
import subprocess
import sys

import numpy as np
import torch


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tableau", default="tsit5")
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--models", default="flagship,power6,cond_gaussian")
    parser.add_argument("--probes", type=int, default=1, help="Hutchinson probes K of K1, K2 and their chain forms")
    parser.add_argument("--jvp", action="store_true", help="forward-mode (JVP) probes")
    args = parser.parse_args()
    probes = args.probes != 1 or args.jvp
    # Keyword arguments earlier versions of the package lack are passed only when asked for.
    probe_kw = {"jvp": True} if args.jvp else {}
    suffix = (f"/jvp-K{args.probes}" if args.jvp else f"/K{args.probes}") if probes else ""
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times needs a CUDA card")
    import continuousnf_tpu_torch as cnf
    from continuousnf_tpu_torch.ode.tableaus import TABLEAUS
    from continuousnf_tpu_torch.ops import _build
    from continuousnf_tpu_torch.ops import fused_solve as fs
    from continuousnf_tpu_torch.utils.configs import MODELS, cuda_ms, glorot_params, model_data

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}; package {cnf.__file__}", flush=True)
    models = args.models.split(",")
    has_k5 = hasattr(fs, "run_test_adjoint_kernel")
    has_k10 = hasattr(fs, "K10_KERNEL")
    kernels = {"flagship": [fs.K3_KERNEL, fs.K1_KERNEL, fs.K2_KERNEL, fs.K4_KERNEL, fs.K4A_KERNEL]
               + ([fs.K5_KERNEL] if has_k5 else []) + ([fs.K10_KERNEL] if has_k10 else []),
               "power6": [fs.K1C_KERNEL, fs.K2C_KERNEL, fs.K7_KERNEL],
               "cond_gaussian": [fs.K1C_KERNEL, fs.K2C_KERNEL, fs.K7_KERNEL]}
    if probes:
        kernels = {"flagship": [fs.K1_KERNEL, fs.K2_KERNEL], "power6": [fs.K1C_KERNEL, fs.K2C_KERNEL],
                   "cond_gaussian": [fs.K1C_KERNEL, fs.K2C_KERNEL]}
    if "miniboone43" in models:
        kernels["miniboone43"] = [fs.K1W_KERNEL, fs.K2W_KERNEL] + ([] if probes else [fs.K7W_KERNEL])
    if "miniboone86" in models:
        kernels["miniboone86"] = [fs.K1S_KERNEL, fs.K2S_KERNEL] + ([] if probes else [fs.K3S_KERNEL, fs.K5S_KERNEL])
    if "miniboone860" in models:
        kernels["miniboone860"] = [fs.K1S_KERNEL, fs.K2S_KERNEL] + ([] if probes else [fs.K7S_KERNEL])
    if "cond_hepmass42" in models:
        kernels["cond_hepmass42"] = [fs.K1W_KERNEL, fs.K2W_KERNEL] + ([] if probes else [
            fs.K3W_KERNEL, fs.K5W_KERNEL, fs.K7W_KERNEL, fs.K4WA_KERNEL])
    if "hepmass42" in models:
        kernels["hepmass42"] = [fs.K1W_KERNEL, fs.K2W_KERNEL] + ([] if probes else [
            fs.K7W_KERNEL, fs.K3W_KERNEL, fs.K5W_KERNEL, fs.K4WA_KERNEL])
    _build.build_libraries(sorted({k for m in models for k in kernels[m]}))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    tab = TABLEAUS[args.tableau]
    tol = (3.452669831108329e-4, 1.1920929e-7) if args.tableau == "verner65" else (1e-3, 1e-6)
    out = {}

    def time_pair(label, spec, run_fwd, run_adj, kw_fwd, kw_adj_extra):
        with torch.no_grad():
            fwd = run_fwd(tab, spec, **kw_fwd)
            ms_f = cuda_ms(lambda: run_fwd(tab, spec, **kw_fwd), args.reps)
            out[label[0]] = [ms_f, int(fwd[2])]
            if run_adj is None:
                return
            kw = {k: v for k, v in kw_fwd.items() if k not in ("z0", "acc0", "dlogp0", "t0", "t1", "dt_init")}
            kw.update(kw_adj_extra, zT=fwd[0], accT=fwd[1].reshape(-1, B), t_hi=kw_fwd["t1"], t_lo=kw_fwd["t0"],
                      dt_init=-fwd[4].abs())
            adj = run_adj(tab, spec, **kw)
            out[label[1]] = [cuda_ms(lambda: run_adj(tab, spec, **kw), max(2, args.reps // 2)), int(adj[5])]

    for name in models:
        cfg = MODELS[name]
        dims, span, B = cfg["dims"], cfg["tspan"], cfg.get("batch", 4096)
        rng = np.random.default_rng(0)
        ps = cnf.params_from_numpy(glorot_params(rng, dims), dev)
        data = model_data(name, rng, B)
        cond = {}
        if isinstance(data, tuple):
            data, ys = data
            cond = {"ys": torch.from_numpy(ys).to(dev)}
        xs = torch.from_numpy(data).to(dev)
        dz = dims[-1]
        z0 = torch.cat([xs, torch.zeros((B, dz - xs.shape[1]), device=dev)], dim=1)
        T = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
        spec = fs.chain_spec(cnf.MLP(dims, device=dev), dz)
        tag = "_cond" if cond else ""
        base = dict(rtol=tol[0], atol=tol[1], max_steps=10_000, ws=[p["w"] for p in ps], bs=[p["b"] for p in ps],
                    t0=torch.tensor(span[0], device=dev), t1=torch.tensor(span[1], device=dev),
                    dt_init=torch.tensor(0.05, device=dev), **cond)
        train = dict(base, norm_z=True, norm_j=True, z0=z0, acc0=T(rng.normal(0.0, 0.1, (3, B))))
        eps = T(rng.normal(size=(args.probes, B, dz)))
        adj = dict(azT=T(rng.normal(0.0, 1.0 / B, (B, dz))),
                   aaccT=T(np.stack([np.full(B, 1.0 / B), np.full(B, 1e-2 / B), np.full(B, 1e-2 / B)])))
        test = dict(base, z0=z0, dlogp0=T(rng.normal(0.0, 0.1, B)))
        if probes:
            keys = {"flagship": ("k1", "k2"), "miniboone43": ("k1c_wide", "k2c_wide"),
                    "hepmass42": ("k1c_hepmass", "k2c_hepmass"), "miniboone86": ("k1c_mb86", "k2c_mb86"),
                    "miniboone860": ("k1c_stream", "k2c_stream"),
                    "cond_hepmass42": ("k1wc_condhep", "k2wc_condhep")}.get(name, ("k1c" + tag, "k2c" + tag))
            wide = (fs.run_wide_train_solve_kernel, fs.run_wide_adjoint_kernel)
            stream = (fs.run_stream_train_solve_kernel, fs.run_stream_adjoint_kernel)
            runs = {"flagship": (fs.run_train_solve_kernel, fs.run_adjoint_kernel), "miniboone43": wide,
                    "hepmass42": wide, "miniboone860": stream, "miniboone86": stream,
                    "cond_hepmass42": (fs.run_wide_cond_train_solve_kernel, fs.run_wide_cond_adjoint_kernel),
                    }.get(name, (fs.run_chain_train_solve_kernel, fs.run_chain_adjoint_kernel))
            time_pair(tuple(k + suffix for k in keys), spec, *runs, dict(train, eps=eps, **probe_kw),
                      dict(adj, eps=eps, **probe_kw))
        elif name == "flagship":
            time_pair(("k3",), spec, fs.run_solve_kernel, None, test, None)
            if has_k5:
                with torch.no_grad():
                    fwd = fs.run_solve_kernel(tab, spec, **dict(test, dlogp0=torch.zeros(B, device=dev)))
                    kw5 = {k: v for k, v in base.items() if k not in ("t0", "t1", "dt_init")}
                    kw5.update(zT=fwd[0], accT=fwd[1][None], azT=adj["azT"], aaccT=T(np.full((1, B), 1.0 / B)),
                               t_hi=base["t1"], t_lo=base["t0"], dt_init=-fwd[4].abs())
                    k5 = fs.run_test_adjoint_kernel(tab, spec, **kw5)
                    ms5 = cuda_ms(lambda: fs.run_test_adjoint_kernel(tab, spec, **kw5), max(2, args.reps // 2))
                out["k5"] = [ms5, int(k5[5])]
            if has_k10:
                from continuousnf_tpu_torch.ops.fused_dynamics import run_fused_field_kernel as k10

                k10_args = (ps[0]["w"], ps[0]["b"], ps[1]["w"], ps[1]["b"], z0, eps[0])
                with torch.no_grad():
                    out["k10"] = [cuda_ms(lambda: k10(*k10_args), 20 * args.reps), 0]
            time_pair(("k1", "k2"), spec, fs.run_train_solve_kernel, fs.run_adjoint_kernel, dict(train, eps=eps),
                      dict(adj, eps=eps))
            time_pair(("k4", "k4a"), spec, fs.run_exact_solve_kernel, fs.run_exact_adjoint_kernel, train, adj)
        elif name == "hepmass42":
            time_pair(("k3w_hepmass", "k5w_hepmass"), spec, fs.run_wide_test2_solve_kernel,
                      fs.run_wide_test_adjoint_kernel, test, dict(azT=adj["azT"], aaccT=T(np.full((1, B), 1.0 / B))))
            time_pair(("k1c_hepmass", "k2c_hepmass"), spec, fs.run_wide_train_solve_kernel, fs.run_wide_adjoint_kernel,
                      dict(train, eps=eps), dict(adj, eps=eps))
            time_pair(("k7e_hepmass", "k4w_hepmass"), spec, fs.run_wide_exact_solve_kernel,
                      fs.run_wide_exact_adjoint_kernel, train, adj)
        elif name == "cond_hepmass42":
            time_pair(("k3wc_condhep", "k5wc_condhep"), spec, fs.run_wide_cond_test2_solve_kernel,
                      fs.run_wide_cond_test_adjoint_kernel, test, dict(azT=adj["azT"], aaccT=T(np.full((1, B), 1.0 / B))))
            time_pair(("k1wc_condhep", "k2wc_condhep"), spec, fs.run_wide_cond_train_solve_kernel,
                      fs.run_wide_cond_adjoint_kernel, dict(train, eps=eps), dict(adj, eps=eps))
            time_pair(("k7ec_condhep", "k4wc_condhep"), spec, fs.run_wide_cond_exact_solve_kernel,
                      fs.run_wide_cond_exact_adjoint_kernel, train, adj)
        elif name == "miniboone86":
            time_pair(("k3s_mb86", "k5s_mb86"), spec, fs.run_stream_test2_solve_kernel,
                      fs.run_stream_test_adjoint_kernel, test, dict(azT=adj["azT"], aaccT=T(np.full((1, B), 1.0 / B))))
            time_pair(("k1c_mb86", "k2c_mb86"), spec, fs.run_stream_train_solve_kernel, fs.run_stream_adjoint_kernel,
                      dict(train, eps=eps), dict(adj, eps=eps))
        elif name == "miniboone860":
            time_pair(("k7t_stream",), spec, fs.run_stream_test_solve_kernel, None, test, None)
            time_pair(("k1c_stream", "k2c_stream"), spec, fs.run_stream_train_solve_kernel,
                      fs.run_stream_adjoint_kernel, dict(train, eps=eps), dict(adj, eps=eps))
            time_pair(("k7e_stream",), spec, fs.run_stream_exact_solve_kernel, None, train, None)
        elif name == "miniboone43":
            time_pair(("k7t_wide",), spec, fs.run_wide_test_solve_kernel, None, test, None)
            time_pair(("k1c_wide", "k2c_wide"), spec, fs.run_wide_train_solve_kernel, fs.run_wide_adjoint_kernel,
                      dict(train, eps=eps), dict(adj, eps=eps))
            time_pair(("k7e_wide",), spec, fs.run_wide_exact_solve_kernel, None, train, None)
        else:
            time_pair(("k7t" + tag,), spec, fs.run_chain_test_solve_kernel, None, test, None)
            time_pair(("k1c" + tag, "k2c" + tag), spec, fs.run_chain_train_solve_kernel, fs.run_chain_adjoint_kernel,
                      dict(train, eps=eps), dict(adj, eps=eps))
            time_pair(("k7e" + tag,), spec, fs.run_chain_exact_solve_kernel, None, train, None)
        torch.cuda.synchronize()
    print(json.dumps({"tableau": args.tableau, "probes": args.probes, "jvp": args.jvp, "kernels": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
