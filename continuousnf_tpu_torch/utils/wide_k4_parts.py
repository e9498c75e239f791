"""Where the wide K4 adjoint's time goes, by parts, on one CUDA card.

    python -m continuousnf_tpu_torch.utils.wide_k4_parts [--reps 3]

Builds `csrc/k4_wide_adjoint.cu` as it is and three variants of it, each
with one part of the work taken out, into `build/kernels/parts/`, and times
each (CUDA events, the mean of `reps` calls, in the order a b c d d c b a)
on the hepmass42 inputs (MLP 42 -> 126 -> 42, B = 4096, tspan (0, 13),
tsit5 at rtol 1e-3, from wide K7 exact's output):
  * `full`: the kernel;
  * `no_pm_grad`: the g_pm entries' gradient sums left out (the block still
    adds a zero rate into its vectors for each of them);
  * `no_chunk_passes`: the two passes over the basis rows (m, then ct_m and
    ct_dh) left out;
  * `no_pm_state`: those passes and the g_pm block of the state left out,
    the solver's vectors P floats long instead of P + dz^2 H.
A variant computes something else than the kernel, and its step count may
differ: compare microseconds per attempted step.  Prints the card's name
and power limit, one line per variant, then one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from .configs import MODELS, cuda_ms, glorot_params, model_data

_PM = "      for (int t = 0; t < nv; ++t) v = fmaf(mp[t * stride], a.DH[t * hp + h], v);\n"
_PASS = "    for (int r0 = 0; r0 < rows; r0 += R) {\n"
_NO_PASS = "    for (int r0 = 0; r0 < 0; r0 += R) {\n"
_PT = "  const int Pt = L.P + L.dz * L.dz * L.width[1];"


def variants(src: str) -> dict:
    """The kernel's source and the three variants' sources."""
    if src.count(_PM) != 1 or src.count(_PASS) != 2 or src.count(_PT) != 1:
        raise RuntimeError("k4_wide_adjoint.cu no longer has the parts this script takes out")
    return {
        "full": src,
        "no_pm_grad": src.replace(_PM, ""),
        "no_chunk_passes": src.replace(_PASS, _NO_PASS),
        "no_pm_state": src.replace(_PASS, _NO_PASS).replace(_PT, "  const int Pt = L.P;"),
    }


def _build_variant(name: str, src: str) -> ctypes.CDLL:
    from ..ops import _build
    from ..ops import fused_solve as fs

    out = _build.BUILD_DIR / "parts"
    out.mkdir(parents=True, exist_ok=True)
    path, lib = out / f"{name}.cu", out / f"lib{name}.so"
    path.write_text(src)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib), str(path)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    handle = ctypes.CDLL(str(lib))
    for fn, (argtypes, restype) in fs._SIGNATURES[fs.K4WA_KERNEL].items():
        getattr(handle, fn).argtypes, getattr(handle, fn).restype = argtypes, restype
    return handle


def main(argv=None) -> int:
    import concurrent.futures

    import continuousnf_tpu_torch as cnf
    from continuousnf_tpu_torch.ode.tableaus import TSIT5
    from continuousnf_tpu_torch.ops import _build
    from continuousnf_tpu_torch.ops import fused_solve as fs

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("wide_k4_parts needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    srcs = variants(Path(_build.CSRC / f"{fs.K4WA_KERNEL}.cu").read_text())
    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:
        libs = dict(zip(srcs, pool.map(lambda kv: _build_variant(*kv), srcs.items())))

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dims, B = MODELS["hepmass42"]["dims"], 4096
    dz = dims[-1]
    rng = np.random.default_rng(0)
    ps = cnf.params_from_numpy(glorot_params(rng, dims), dev)
    xs = torch.from_numpy(model_data("hepmass42", rng, B)).to(dev)
    T = lambda x: torch.from_numpy(x.astype(np.float32)).to(dev)  # noqa: E731
    spec = fs.chain_spec(cnf.MLP(dims, device=dev), dz)
    base = dict(rtol=1e-3, atol=1e-6, max_steps=10_000, ws=[p["w"] for p in ps], bs=[p["b"] for p in ps],
                norm_z=True, norm_j=True)
    t0, t1 = (torch.tensor(t, device=dev) for t in MODELS["hepmass42"]["tspan"])
    z0 = torch.cat([xs, torch.zeros((B, dz - xs.shape[1]), device=dev)], dim=1)
    with torch.no_grad():
        fwd = fs.run_wide_exact_solve_kernel(TSIT5, spec, **base, z0=z0, acc0=T(rng.normal(0.0, 0.1, (3, B))),
                                             t0=t0, t1=t1, dt_init=torch.tensor(0.05, device=dev))
    adj = dict(base, zT=fwd[0], accT=fwd[1], azT=T(rng.normal(0.0, 1.0 / B, (B, dz))),
               aaccT=T(np.stack([np.full(B, 1.0 / B), np.full(B, 1e-2 / B), np.full(B, 1e-2 / B)])),
               t_hi=t1, t_lo=t0, dt_init=-fwd[4].abs())
    library = fs._library
    times = {name: [] for name in libs}
    try:
        for name in list(libs) + list(libs)[::-1]:
            fs._library = lambda _n, _lib=libs[name]: _lib
            with torch.no_grad():
                out = fs._launch_wide_exact_adjoint(TSIT5, spec, **adj)
                ms = cuda_ms(lambda: fs._launch_wide_exact_adjoint(TSIT5, spec, **adj), a.reps)
            times[name].append((ms, int(out[5])))
    finally:
        fs._library = library
    res = {name: [{"ms": ms, "steps": n, "us_per_step": ms * 1e3 / n} for ms, n in runs] for name, runs in times.items()}
    for name, runs in res.items():
        print(f"{name}: " + "; ".join(f"{r['ms']:.4f} ms ({r['steps']} steps, {r['us_per_step']:.1f} us per attempted "
                                      "step)" for r in runs))
    print(json.dumps({"card": smi, "variants": res}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
