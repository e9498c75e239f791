"""The model configurations that `chip_smoke.py` and `utils/profile_step.py`
drive on the card, their weight and data recipes, and a CUDA-event timer.

  * flagship (`bench.py:142-177`): RNODE, nvars = 8, naug = 8, MLP
    16 -> 48 -> 16 tanh, lambda3 = 1e-2, steer_rate 0.1, tspan (0, 13);
    data xs ~ U[0, 1).
  * power6 (`benchmarks/tabular.py:69-79`): RNODE, nvars = 6, naug = 0, MLP
    6 -> 64 -> 64 -> 6 tanh on all three layers, tspan (0, 1), no steering;
    data from the recipe of the JAX package's `synthetic_tabular`
    (`continuousnf_tpu/data.py:56-64`), tanh(z mix) + 0.1 z.
  * miniboone43 (`benchmarks/tabular.py:58-79`): RNODE, nvars = 43, naug = 0,
    MLP 43 -> 128 -> 128 -> 43 tanh on all three layers, tspan (0, 1), no
    steering, batch 2048 (the JAX package's tabular benchmark batch); data
    from the same `synthetic_tabular` recipe at 43 variables.
  * hepmass42 (`bench.py:142-177`'s recipe at nvars = naug = 21): RNODE,
    the README net family MLP((n_in, 3 n_in, n_in)) at n_in = 42, the
    HEPMASS width (21 features in the MAF preprocessing of the UCI tabular
    suite), 42 -> 126 -> 42 tanh, lambda3 = 1e-2, steer_rate 0.1, tspan
    (0, 13); data from the `synthetic_tabular` recipe at 21 variables.  Past
    the 2-layer kernels' state width: the wide 2-layer kernels and the wide
    chain forms run it.
  * miniboone860 (FFJORD's tabular MINIBOONE model, Grathwohl et al.,
    ICLR 2019, the appendix's tabular hyperparameters: hidden widths
    20 x d, two hidden layers, at d = 43): RNODE, nvars = 43, naug = 0,
    MLP 43 -> 860 -> 860 -> 43 tanh on all three layers, tspan (0, 1), no
    steering, batch 1024; data and weights by miniboone43's recipe (the
    repo's tabular family, `benchmarks/tabular.py:69`, at FFJORD's widths).
    Its weights (3.25 MB) pass a block's shared memory: the chain kernels'
    streamed forms run it.  Departures from FFJORD: FFJORD's own layer type
    and nonlinearity are not in the repo's MLP family (a Dense tanh chain
    stands in); the batch is 1024, not FFJORD's 1000: the largest power of
    two at which the JAX package's forward-kernel VMEM guard still admits
    the chain (at 2048 it reads 62.6 MB and falls back to XLA).  Widths and
    depth are FFJORD's, not cut.
  * miniboone86 (the README net family MLP((n_in, 3 n_in, n_in)),
    README.md:31-33, at nvars = naug = 43, the MINIBOONE width: 43
    features in the MAF preprocessing of the UCI tabular suite): RNODE,
    MLP 86 -> 258 -> 86 tanh, lambda3 = 1e-2, steer_rate 0.1, tspan (0, 13),
    batch 4096; data from the `synthetic_tabular` recipe at 43 variables.
    Past the wide 2-layer kernels' state width: streamed K3 and K5, the
    streamed K1 and K2 chain forms, and streamed K7 exact with the streamed
    K4 adjoint run it.  Nothing is cut.
  * bsds126 (the same family at BSDS300's 63 features): RNODE, nvars =
    naug = 63, MLP 126 -> 378 -> 126 tanh, the same lambda, steering and
    tspan, batch 2048: the largest power of two at which the JAX package's
    forward-kernel VMEM guard still admits the net (30.2 MB; 60.4 MB at
    4096 falls back to XLA); data from the recipe at 63 variables.  The top
    of the streamed forms' state width.
  * microbench (`benchmarks/kernel_microbench.py:93-152`): the flagship at
    tspan (0, 1), the configuration that benchmark times in float32 and
    under bf16 stage matmuls (`make_icnf(..., bf16=True)`).
  * cond_gaussian (`continuousnf_tpu/recipes.py:254-289`, BASELINE config
    #3): CondRNODE, nvars = 1, naug = 0, one conditioning input, MLP
    2 -> 64 -> 64 -> 1 tanh on all three layers reading [x | y], tspan
    (0, 13), steer_rate 0.1; data y ~ U(-1, 1), x | y ~ N(0.7 y, 0.3^2).
  * cond_hepmass42 (the README net family's conditional form at the HEPMASS
    width): CondRNODE, nvars = naug = 21, one conditioning column, MLP
    43 -> 126 -> 42 tanh on [z | ys], hepmass42's recipe (lambda3 = 1e-2,
    steer_rate 0.1, tspan (0, 13)).  HEPMASS (UCI; Baldi et al. 2016,
    "Parameterized neural networks for high-energy physics") is a
    parametrised data set: its signal depends on a mass of 500, 750, 1000,
    1250 or 1500 GeV, and the density-estimation literature keeps 21 of its
    features (Papamakarios et al. 2017, MAF), so p(x | mass) is the
    conditional density its users fit.  The data are synthetic: ys one of
    the five masses, standardised (mean 1000, std 353.55), and xs the
    `synthetic_tabular` recipe at 21 variables plus 0.5 ys.  Past the narrow
    widths: the COND instances of wide K3, wide K5 and the wide K1 and K2
    chain forms run it.  Nothing is cut.
  * cond_miniboone86 (the README net family's conditional form at the
    MINIBOONE width, beside miniboone86): CondRNODE, nvars = naug = 43, one
    conditioning column, MLP 87 -> 258 -> 86 tanh on [z | ys], miniboone86's
    recipe (lambda3 = 1e-2, steer_rate 0.1, tspan (0, 13), batch 4096).
    MiniBooNE (UCI, "MiniBooNE particle identification") labels each of its
    130,064 events signal (36,499, electron neutrinos) or background
    (93,565), and the density-estimation literature keeps 43 of its 50
    features (Papamakarios et al. 2017, MAF), so p(x | label) is the
    class-conditional density its users fit.  The data are synthetic: ys
    the label drawn with the signal share 36,499 / 130,064 and standardised
    (signal about +1.601, background about -0.625), and xs the
    `synthetic_tabular` recipe at 43 variables plus 0.5 ys.  Past the wide
    limits: the COND instances of streamed K3, streamed K5 and the streamed
    K1 and K2 chain forms run it, and under exact trace those of streamed
    K7 exact and the streamed K4 adjoint.  Nothing is cut.
  * cond_miniboone860 (FFJORD's tabular MINIBOONE model in its conditional
    form, beside miniboone860): CondRNODE, nvars = 43, naug = 0, one
    conditioning column, MLP 44 -> 860 -> 860 -> 43 tanh on all three
    layers reading [z | ys], miniboone860's tspan (0, 1), no steering,
    batch 1024; data by cond_miniboone86's recipe (p(x | label) of
    MiniBooNE).  The COND instances of streamed K7 TEST (serving) and
    streamed K7 exact (its exact forward; the deep chain's exact gradient
    runs the plain BACKSOLVE, as the JAX package's does) run it.  Widths,
    depth and batch are miniboone860's, not cut.
  * refbench16 (ContinuousNormalizingFlows.jl's benchmark suite, its
    `benchmark/benchmarks.jl:24-49,78-99,146-166`, SURVEY.md:320: RNODE,
    nvars = 8, naugs = 8, Dense(16 => 16, tanh), timed in TRAIN and TEST,
    loss and gradient): RNODE, nvars = naug = 8, MLP 16 -> 16, one tanh
    layer, on the flagship's recipe (lambda3 = 1e-2, steer_rate 0.1, tspan
    (0, 13)) and data; batch 4096, and 64, the suite's n (REFBENCH_BATCH).
    A 1-layer net: the narrow chain kernels run it.  Nothing is cut.
  * cond_refbench16: its conditional form, CondRNODE, MLP 17 -> 16 on
    [z | ys], one conditioning column drawn as cond_miniboone86 draws its
    label (the standardised MiniBooNE signal label), xs the flagship's
    U[0, 1) + 0.5 ys.
  * cond_flagship (the README net, MLP((n, 3n, n)) at README.md:31-33, in
    its conditional form at the flagship widths; the narrow member of the
    family whose wide member is cond_hepmass42): CondRNODE, nvars = naug
    = 8, one conditioning column, MLP 17 -> 48 -> 16 tanh on [z | ys], the
    flagship recipe (lambda3 = 1e-2, steer_rate 0.1, tspan (0, 13)), batch
    4096; data drawn as cond_refbench16's (ys the standardised MiniBooNE
    label, xs U[0, 1) + 0.5 ys).  A conditional 2-layer tanh net within
    state width 32: the COND instances of K3 (TEST) and of the K4 forward
    and adjoint (exact trace) run it, beside K5's COND instance (the TEST
    backward) and the K1 and K2 chain forms' (Hutchinson TRAIN).  Nothing is
    cut.
  * deep5_power6 and deep8_power6: power6's recipe at 5 and 8 layers, MLP
    6 -> 64 x 4 -> 6 and 6 -> 64 x 7 -> 6.  Their weights and K2 slots pass
    the narrow forms' shared memory (`fused_solve._narrow_smem_bytes`): the
    wide forms run them.  deep8_narrow, MLP 6 -> 32 x 7 -> 6, the same
    recipe, keeps the narrow forms at 8 layers.
  * deep5_miniboone43 and deep5_miniboone128: miniboone43's recipe at 5
    layers, MLP 43 -> 64 x 4 -> 43 (the wide forms) and 43 -> 128 x 4 -> 43
    (weights past a block's shared memory: the streamed forms), batch 2048.
  * deep5_miniboone860 and cond_deep5_miniboone860: miniboone860's and
    cond_miniboone860's recipes at 5 layers, MLP 43 -> 860 x 4 -> 43 and
    44 -> 860 x 4 -> 43 (the streamed forms), batch 1024.

All: lambda1 = lambda2 = 1e-2 (the RNODE defaults), tsit5 at rtol 1e-3 /
atol 1e-6, one Gaussian VJP probe (`make_icnf` takes K probes and JVP
probes), batch 4096 in the scripts unless the entry names its own `batch`
(miniboone43 and bsds126: 2048; miniboone860 and cond_miniboone860: 1024); the conditional recipe
trains at its `batch_size` of 128, cond_hepmass42, cond_miniboone86 and cond_flagship at 4096.  Weights
are Glorot-uniform with N(0, 0.05) biases, drawn with numpy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MODELS = {
    "flagship": dict(dims=(16, 48, 16), nvars=8, naug=8, tspan=(0.0, 13.0), extra={"steer_rate": 0.1, "lam3": 1e-2}),
    "power6": dict(dims=(6, 64, 64, 6), nvars=6, naug=0, tspan=(0.0, 1.0), extra={}),
    "miniboone43": dict(dims=(43, 128, 128, 43), nvars=43, naug=0, tspan=(0.0, 1.0), extra={}, batch=2048),
    "miniboone860": dict(dims=(43, 860, 860, 43), nvars=43, naug=0, tspan=(0.0, 1.0), extra={}, batch=1024),
    "hepmass42": dict(dims=(42, 126, 42), nvars=21, naug=21, tspan=(0.0, 13.0), extra={"steer_rate": 0.1, "lam3": 1e-2}),
    "miniboone86": dict(dims=(86, 258, 86), nvars=43, naug=43, tspan=(0.0, 13.0),
                        extra={"steer_rate": 0.1, "lam3": 1e-2}),
    "bsds126": dict(dims=(126, 378, 126), nvars=63, naug=63, tspan=(0.0, 13.0),
                    extra={"steer_rate": 0.1, "lam3": 1e-2}, batch=2048),
    "cond_gaussian": dict(dims=(2, 64, 64, 1), nvars=1, naug=0, tspan=(0.0, 13.0), extra={"steer_rate": 0.1},
                          n_cond=1, batch_size=128),
    "cond_hepmass42": dict(dims=(43, 126, 42), nvars=21, naug=21, tspan=(0.0, 13.0),
                           extra={"steer_rate": 0.1, "lam3": 1e-2}, n_cond=1),
    "cond_miniboone86": dict(dims=(87, 258, 86), nvars=43, naug=43, tspan=(0.0, 13.0),
                             extra={"steer_rate": 0.1, "lam3": 1e-2}, n_cond=1),
    "cond_miniboone860": dict(dims=(44, 860, 860, 43), nvars=43, naug=0, tspan=(0.0, 1.0), extra={}, n_cond=1,
                              batch=1024),
    "refbench16": dict(dims=(16, 16), nvars=8, naug=8, tspan=(0.0, 13.0), extra={"steer_rate": 0.1, "lam3": 1e-2}),
    "cond_refbench16": dict(dims=(17, 16), nvars=8, naug=8, tspan=(0.0, 13.0),
                            extra={"steer_rate": 0.1, "lam3": 1e-2}, n_cond=1),
    "cond_flagship": dict(dims=(17, 48, 16), nvars=8, naug=8, tspan=(0.0, 13.0),
                          extra={"steer_rate": 0.1, "lam3": 1e-2}, n_cond=1),
    "deep5_power6": dict(dims=(6, 64, 64, 64, 64, 6), nvars=6, naug=0, tspan=(0.0, 1.0), extra={}),
    "deep8_power6": dict(dims=(6,) + (64,) * 7 + (6,), nvars=6, naug=0, tspan=(0.0, 1.0), extra={}),
    "deep8_narrow": dict(dims=(6,) + (32,) * 7 + (6,), nvars=6, naug=0, tspan=(0.0, 1.0), extra={}),
    "deep5_miniboone43": dict(dims=(43, 64, 64, 64, 64, 43), nvars=43, naug=0, tspan=(0.0, 1.0), extra={},
                              batch=2048),
    "deep5_miniboone128": dict(dims=(43, 128, 128, 128, 128, 43), nvars=43, naug=0, tspan=(0.0, 1.0), extra={},
                               batch=2048),
    "deep5_miniboone860": dict(dims=(43, 860, 860, 860, 860, 43), nvars=43, naug=0, tspan=(0.0, 1.0), extra={},
                               batch=1024),
    "cond_deep5_miniboone860": dict(dims=(44, 860, 860, 860, 860, 43), nvars=43, naug=0, tspan=(0.0, 1.0),
                                    extra={}, n_cond=1, batch=1024),
}
#: The reference benchmark suite's batch (its n), refbench16's second batch.
REFBENCH_BATCH = 64
#: HEPMASS's signal masses in GeV (Baldi et al. 2016), cond_hepmass42's conditioning.
HEPMASS_MASSES = (500.0, 750.0, 1000.0, 1250.0, 1500.0)
#: MiniBooNE's signal and background events (UCI), the label shares of the
#: cond_miniboone86 and cond_miniboone860 data.
MINIBOONE_EVENTS = (36_499, 93_565)
# kernel_microbench (`benchmarks/kernel_microbench.py:93-152`): the flagship at
# tspan (0, 1), run in float32 and under bf16 stage matmuls.
MODELS["microbench"] = dict(MODELS["flagship"], tspan=(0.0, 1.0))


def glorot_params(rng: np.random.Generator, dims):
    """Glorot-uniform weights and N(0, 0.05) biases in the JAX layout
    (numpy float32), drawn layer by layer, w then b."""
    ps = []
    for din, dout in zip(dims[:-1], dims[1:]):
        lim = math.sqrt(6.0 / (din + dout))
        ps.append({
            "w": rng.uniform(-lim, lim, (din, dout)).astype(np.float32),
            "b": rng.normal(0.0, 0.05, (dout,)).astype(np.float32),
        })
    return tuple(ps)


def tabular_data(rng: np.random.Generator, n: int, nvars: int) -> np.ndarray:
    """n samples of the recipe of the JAX package's `synthetic_tabular`:
    tanh(z mix) + 0.1 z, z ~ N(0, I), mix ~ N(0, 1 / nvars)."""
    mix = rng.normal(size=(nvars, nvars)) / math.sqrt(nvars)
    z = rng.normal(size=(n, nvars))
    return (np.tanh(z @ mix) + 0.1 * z).astype(np.float32)


def cond_gaussian_data(rng: np.random.Generator, n: int):
    """n pairs of the conditional recipe (`continuousnf_tpu/recipes.py:270-273`):
    y ~ U(-1, 1), x | y ~ N(0.7 y, 0.3^2).  Returns (xs, ys), (n, 1) each."""
    ys = rng.uniform(-1.0, 1.0, (n, 1))
    xs = 0.7 * ys + 0.3 * rng.normal(size=(n, 1))
    return xs.astype(np.float32), ys.astype(np.float32)


def cond_hepmass_data(rng: np.random.Generator, n: int):
    """n pairs of cond_hepmass42's synthetic data: ys one of HEPMASS_MASSES
    drawn uniformly, standardised (mean 1000, std 353.55: -1.414, -0.707, 0,
    0.707 or 1.414), and xs = the `synthetic_tabular` recipe at 21 variables
    + 0.5 ys.  Returns (xs (n, 21), ys (n, 1)), float32."""
    masses = np.asarray(HEPMASS_MASSES)
    ys = (rng.choice(masses, size=(n, 1)) - masses.mean()) / masses.std()
    xs = tabular_data(rng, n, 21) + 0.5 * ys
    return xs.astype(np.float32), ys.astype(np.float32)


def miniboone_label(rng: np.random.Generator, n: int) -> np.ndarray:
    """n MiniBooNE labels (n, 1), float64: 1 for signal with MiniBooNE's
    signal share (MINIBOONE_EVENTS) and 0 for background, standardised by
    the share's mean and standard deviation (signal about +1.601,
    background about -0.625)."""
    signal, background = MINIBOONE_EVENTS
    share = signal / (signal + background)
    label = (rng.uniform(size=(n, 1)) < share).astype(np.float64)
    return (label - share) / math.sqrt(share * (1.0 - share))


def cond_miniboone_data(rng: np.random.Generator, n: int):
    """n pairs of cond_miniboone86's synthetic data: ys the standardised
    label (`miniboone_label`), and xs = the `synthetic_tabular` recipe at 43
    variables + 0.5 ys.  Returns (xs (n, 43), ys (n, 1)), float32."""
    ys = miniboone_label(rng, n)
    xs = tabular_data(rng, n, 43) + 0.5 * ys
    return xs.astype(np.float32), ys.astype(np.float32)


def cond_refbench_data(rng: np.random.Generator, n: int):
    """n pairs of cond_refbench16's synthetic data: ys the standardised
    MiniBooNE label (`miniboone_label`), xs the flagship's U[0, 1) at 8
    variables + 0.5 ys.  Returns (xs (n, 8), ys (n, 1)), float32."""
    ys = miniboone_label(rng, n)
    xs = rng.uniform(0.0, 1.0, (n, 8)) + 0.5 * ys
    return xs.astype(np.float32), ys.astype(np.float32)


def two_moons(rng: np.random.Generator, n: int, noise: float = 0.05) -> np.ndarray:
    """n points of the two-moons toy of the JAX package's `data.two_moons`
    (`continuousnf_tpu/data.py:22-32`), the data of the trajectory example,
    drawn with numpy: half on each arc, plus N(0, noise^2) noise."""
    n1 = n // 2
    t1 = rng.uniform(size=n1) * math.pi
    t2 = rng.uniform(size=n - n1) * math.pi
    upper = np.stack([np.cos(t1), np.sin(t1)], -1)
    lower = np.stack([1.0 - np.cos(t2), 0.5 - np.sin(t2)], -1)
    return (np.concatenate([upper, lower]) + noise * rng.normal(size=(n, 2))).astype(np.float32)


def model_data(name: str, rng: np.random.Generator, n: int):
    """n data points of the configuration `name` (numpy float32): xs, or
    (xs, ys) for a conditional configuration."""
    nvars = MODELS[name]["nvars"]
    if name in ("power6", "miniboone43", "miniboone860", "hepmass42", "miniboone86", "bsds126") or name.startswith(
            "deep"):
        return tabular_data(rng, n, nvars)
    if name in ("cond_refbench16", "cond_flagship"):
        return cond_refbench_data(rng, n)
    if name == "cond_gaussian":
        return cond_gaussian_data(rng, n)
    if name == "cond_hepmass42":
        return cond_hepmass_data(rng, n)
    if name in ("cond_miniboone86", "cond_miniboone860", "cond_deep5_miniboone860"):
        return cond_miniboone_data(rng, n)
    return rng.uniform(0.0, 1.0, (n, nvars)).astype(np.float32)


def make_icnf(name: str, device, *, fused: bool = True, exact: bool = False, dtype=torch.float32, num_probes: int = 1,
              ad="vjp", bf16: bool = False, **kw):
    """The configuration `name` as an ICNF on `device` (CondRNODE for a
    conditional one, else RNODE): `fused`, `exact`, `num_probes`, `ad`
    ("vjp" or "jvp", or an `ADMode`) and `bf16` (bf16 stage matmuls) pick
    its `ComputeMode` (`VecJacMode` or `JacVecMode`); `kw` goes to
    `construct` (a `solver`, say)."""
    from .. import MLP, RNODE, ADMode, ComputeMode, CondRNODE, construct

    cfg = MODELS[name]
    variant = CondRNODE if cfg.get("n_cond") else RNODE
    mode = ComputeMode(ad=ADMode(ad), num_probes=num_probes, fused=fused, exact_trace=exact, bf16=bf16)
    return construct(
        variant, MLP(cfg["dims"], device=device, dtype=dtype), cfg["nvars"], cfg["naug"], tspan=cfg["tspan"],
        compute_mode=mode, dtype=dtype, **cfg["extra"], **kw,
    )


def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean milliseconds per call of `fn` between CUDA events, after one
    warm-up call unless `warmup` is False (for a function that has run
    already)."""
    if warmup:
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
