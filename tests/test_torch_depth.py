"""The port's chain kernels at every depth against the JAX package on the
CPU: 1-layer nets (MLP 6 -> 6, and the conditional MLP 7 -> 5 with two ys
columns) and chains of 5 and 8 layers (MLP 5 -> 9 -> 7 -> 7 -> 7 -> 5,
MLP 4 -> 8 x 7 -> 4, and the conditional MLP 5 -> 9 -> 7 -> 7 -> 7 -> 3
with two ys columns).  The plain versions of the K1 chain form, the K2
chain form and K7 TEST and exact against the JAX package's kernels in
interpret mode, with one VJP probe, K = 2 and JVP; TEST and TRAIN
`inference`, the loss and its gradients against `jax.grad`; the chain
kernels' coverage and refusals at these depths, the narrow forms' shared
memory rule, the fused solve's choice of wrappers, the reference benchmark
suite's configuration (refbench16) and `fit`.

Inputs come from numpy seeds; the JAX probe and steering draws are
reproduced from its key split (`core/icnf.py:485`) and handed to the port.
Where a forward solve parts from the JAX kernel's by one step, the port's
twin takes the JAX kernel's count under one-ulp moves of its inputs
(`near_tie.witness`) or the JAX package's own unfused path on the same
inputs takes the port's count (the 5-layer TEST solve parts so: JAX kernel
and unfused path 13 steps, the twin 12, and 13 under most one-ulp moves;
float64 12)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import continuousnf_tpu as cnf
import continuousnf_tpu_torch as tcnf
from continuousnf_tpu.ops import fused_solve as jfs
from continuousnf_tpu_torch.ode.tableaus import TSIT5
from continuousnf_tpu_torch.ops import fused_solve as tfs
from continuousnf_tpu_torch.utils import near_tie
from continuousnf_tpu_torch.utils.configs import MODELS, REFBENCH_BATCH, glorot_params, model_data

# The port's entry points default to the CUDA card; these tests run it on the CPU.
tcnf.set_default_device("cpu")

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# name -> (dims, nvars, naug, n_cond)
NETS = {
    "one": ((6, 6), 4, 2, 0),
    "cond-one": ((7, 5), 3, 2, 2),
    "five": ((5, 9, 7, 7, 7, 5), 3, 2, 0),
    "eight": ((4,) + (8,) * 7 + (4,), 4, 0, 0),
    "cond-five": ((5, 9, 7, 7, 7, 3), 2, 1, 2),
}
B = 16
MODE_NAMES = {"train": "TRAIN", "test": "TEST", "exact": "TRAIN"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch on one thread for this module: under several test workers a
    pool of threads for these tiny products costs more than it gains."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cm(m, mode="train", fused=True, k=1, jvp=False):
    ad = m.ADMode.JVP if jvp else m.ADMode.VJP
    return m.ComputeMode(ad=ad, num_probes=k, fused=fused, exact_trace=mode == "exact")


def _model(m, net, compute_mode=None, **kw):
    dims, nvars, naug, n_cond = NETS[net]
    variant = m.CondRNODE if n_cond else m.RNODE
    return m.construct(variant, m.MLP(dims), nvars, naug, compute_mode=compute_mode or _cm(m), **kw)


def _np_params(net, seed):
    return glorot_params(np.random.default_rng(seed), NETS[net][0])


def _data(net, n, seed):
    """(xs (n, nvars), ys (n, n_cond) or None): x ~ N(0, 1), y ~ U(-1, 1)."""
    _, nvars, _, nc = NETS[net]
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n, nvars)).astype(np.float32)
    return xs, (rng.uniform(-1.0, 1.0, (n, nc)).astype(np.float32) if nc else None)


def _jps(ps_np):
    return jax.tree.map(jnp.asarray, ps_np)


def _leaves(ps):
    return [p[k] for p in ps for k in ("w", "b")]


def _launch_counts():
    return {name: w.launches for name, w in tfs.KERNEL_WRAPPERS.items()}


def _y0(net, xs, nacc):
    naug = NETS[net][2]
    z0 = np.concatenate([xs, np.zeros((xs.shape[0], naug), np.float32)], axis=1)
    return np.concatenate([z0.ravel(), np.zeros(nacc * xs.shape[0], np.float32)])


def _spec(dims, n_cond=0):
    n = len(dims) - 1
    return tfs.ChainSpec((dims[0] + n_cond,) + tuple(dims[1:-1]), tuple(dims[1:]), (True,) * n, n_cond)


def _hold_steps(st, st_r, unfused_steps, witness_steps):
    """Equal attempted and accepted steps and NFE, or, where the two part by
    one attempted and one accepted step, the port's twin taking the JAX
    kernel's count under one-ulp moves of its inputs (`witness_steps()`) or
    the JAX package's unfused path on the same inputs taking the port's
    count (`unfused_steps()`)."""
    if int(st.steps) != int(st_r.steps):
        assert abs(int(st.steps) - int(st_r.steps)) == 1 and abs(int(st.accepted) - int(st_r.accepted)) == 1
        assert int(st_r.steps) in witness_steps() or unfused_steps() == int(st.steps)
    else:
        assert (int(st.accepted), int(st.nfe)) == (int(st_r.accepted), int(st_r.nfe))


# ---- the twins against the JAX package's kernels (interpret mode) ----


# mode -> the fused solve's forward wrapper and its twin
_FORWARDS = {
    "train": ("run_chain_train_solve_kernel", tfs.solve_train_plain),
    "test": ("run_chain_test_solve_kernel", tfs.solve_test_plain),
    "exact": ("run_chain_exact_solve_kernel", tfs.solve_train_exact_plain),
}


@pytest.mark.parametrize("net", list(NETS))
@pytest.mark.parametrize("mode", ["train", "test", "exact"])
def test_depth_forward_twins_match_jax_kernel(monkeypatch, mode, net):
    """The plain versions of the K1 chain form (train), K7 TEST (test) and
    K7 exact (exact), through the fused solve on CPU tensors, against the
    JAX package's forward kernel in interpret mode from zero accumulators:
    equal steps (or a one-step parting the JAX unfused path takes), values
    at 1e-4.  No kernel is launched."""
    mode_name = MODE_NAMES[mode]
    ps_np = _np_params(net, 1)
    xs, ys = _data(net, B, 2)
    nacc = 1 if mode == "test" else 3
    y0f = _y0(net, xs, nacc)
    eps = np.random.default_rng(3).normal(size=(1, B, NETS[net][0][-1])).astype(np.float32) if mode == "train" else None
    jicnf = _model(cnf, net, _cm(cnf, mode))
    jfull = jfs.make_full_solve(jicnf, getattr(cnf.Mode, mode_name), B)
    jargs = {"ps": _jps(ps_np), "eps": None if eps is None else jnp.asarray(eps),
             "ys": None if ys is None else jnp.asarray(ys)}
    yT_r, st_r = jfull.forward(jnp.asarray(y0f), 0.0, 1.0, jargs)
    name, twin = _FORWARDS[mode]
    calls, wrapped = [], getattr(tfs, name)
    monkeypatch.setattr(tfs, name, lambda tab, spec, **kw: calls.append((tab, spec, kw)) or wrapped(tab, spec, **kw))
    tfull = tfs.make_full_solve(_model(tcnf, net, _cm(tcnf, mode)), getattr(tcnf.Mode, mode_name), B)
    targs = {"ps": tcnf.params_from_numpy(ps_np), "eps": None if eps is None else torch.from_numpy(eps),
             "ys": None if ys is None else torch.from_numpy(ys)}
    before = _launch_counts()
    with torch.no_grad():
        yT, st = tfull.forward(torch.from_numpy(y0f), torch.tensor(0.0), torch.tensor(1.0), targs)
    assert _launch_counts() == before and len(calls) == 1

    def witness_steps():
        tab, spec, kw = calls[0]
        return near_tie.witness(twin, tab, spec, kw, "z0", n=8)[0]

    def unfused_steps():
        icnf = _model(cnf, net, _cm(cnf, mode, fused=False), tspan=(0.0, 1.0))
        extra = {} if eps is None else {"eps": jnp.asarray(eps)}
        _, _, st_u = cnf.inference(icnf, getattr(cnf.Mode, mode_name), jnp.asarray(xs), _jps(ps_np),
                                   ys=None if ys is None else jnp.asarray(ys), key=jax.random.PRNGKey(0), **extra)
        return int(st_u.steps)

    _hold_steps(st, st_r, unfused_steps, witness_steps)
    np.testing.assert_allclose(yT.numpy(), np.asarray(yT_r), **TOL)


# (net, probes, jvp)
ADJOINT_CASES = [
    ("one", 1, False), ("cond-one", 1, False), ("five", 1, False), ("eight", 1, False), ("one", 2, False),
    ("one", 1, True), ("cond-one", 2, False), ("eight", 1, True),
]


@pytest.mark.parametrize("net,k,jvp", ADJOINT_CASES,
                         ids=[f"{n}-{'jvp' if j else f'k{k}'}" for n, k, j in ADJOINT_CASES])
def test_depth_adjoint_twin_matches_jax_kernel(net, k, jvp):
    """The K2 chain form's plain version (its probe instance's with K
    probes or JVP) against the JAX package's adjoint kernel in interpret
    mode at one tile, from the same final state, cotangent and warm start:
    equal steps, the states, a_ys0 and the gradients (the ys rows of g_W0
    among them) at 1e-4."""
    dims, _, _, nc = NETS[net]
    dz = dims[-1]
    ps_np = _np_params(net, 4)
    xs, ys = _data(net, B, 5)
    eps = np.random.default_rng(6).normal(size=(k, B, dz)).astype(np.float32)
    span = 1.0
    jfull = jfs.make_full_solve(_model(cnf, net, _cm(cnf, k=k, jvp=jvp), tspan=(0.0, span)), cnf.Mode.TRAIN, B)
    args = {"ps": _jps(ps_np), "eps": jnp.asarray(eps), "ys": None if ys is None else jnp.asarray(ys)}
    yTf, fst = jfull.forward(jnp.asarray(_y0(net, xs, 3)), 0.0, span, args)
    rng = np.random.default_rng(7)
    g_yf = np.concatenate([rng.normal(0.0, 0.1, B * dz), np.full(B, 1.0 / B), np.full(2 * B, 1e-2 / B)]).astype(
        np.float32)
    dt_warm = float(fst.dt_last)
    y0_r, ay0_r, gargs_r, st_r = jfull.adjoint(yTf, jnp.asarray(g_yf), args, span, 0.0, dt_warm=dt_warm)

    tfull = tfs.make_full_solve(_model(tcnf, net, _cm(tcnf, k=k, jvp=jvp), tspan=(0.0, span)), tcnf.Mode.TRAIN, B)
    targs = {"ps": tcnf.params_from_numpy(ps_np), "eps": torch.from_numpy(eps),
             "ys": None if ys is None else torch.from_numpy(ys)}
    before = _launch_counts()
    y0, ay0, gargs, st = tfull.adjoint(
        torch.from_numpy(np.array(yTf)), torch.from_numpy(g_yf), targs, torch.tensor(span), torch.tensor(0.0),
        dt_warm=dt_warm,
    )
    assert _launch_counts() == before
    assert (int(st.steps), int(st.accepted), int(st.nfe)) == (int(st_r.steps), int(st_r.accepted), int(st_r.nfe))
    np.testing.assert_allclose(y0.numpy(), np.asarray(y0_r), **TOL)
    np.testing.assert_allclose(ay0.numpy(), np.asarray(ay0_r), **TOL)
    for a, b in zip(_leaves(gargs["ps"]), _leaves(gargs_r["ps"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    if nc:
        np.testing.assert_allclose(gargs["ys"].numpy(), np.asarray(gargs_r["ys"]), **TOL)
        assert float(gargs["ps"][0]["w"][dz:].abs().max()) > 0.0


# ---- inference and gradients ----


def _jax_draws(icnf, key, batch):
    """The probes and the steering r JAX TRAIN `inference` draws from `key`."""
    eps_key, steer_key = jax.random.split(key)
    eps = None if icnf.compute_mode.exact_trace else np.array(icnf.draw_eps(eps_key, batch))
    r = float(jax.random.uniform(steer_key, (), icnf.dtype, -icnf.steer_rate, icnf.steer_rate))
    return eps, r


@pytest.mark.parametrize("net", ["one", "cond-one", "eight"])
@pytest.mark.parametrize("mode", ["test", "train", "exact"])
def test_depth_inference_matches_jax(mode, net):
    """TEST and TRAIN `inference` through the fused solve (the chain
    kernels' twins) against the JAX package's kernels in interpret mode,
    with the same weights, inputs, ys, probes and steering draw (steer_rate
    0.1, the reference suite's recipe)."""
    mode_name = MODE_NAMES[mode]
    jicnf = _model(cnf, net, _cm(cnf, mode), steer_rate=0.1)
    ticnf = _model(tcnf, net, _cm(tcnf, mode), steer_rate=0.1)
    ps_np = _np_params(net, 8)
    xs, ys = _data(net, B, 9)
    key = jax.random.PRNGKey(10)
    lp_r, regs_r, st_r = cnf.inference(jicnf, getattr(cnf.Mode, mode_name), jnp.asarray(xs), _jps(ps_np),
                                       ys=None if ys is None else jnp.asarray(ys), key=key)
    extra = {}
    if mode_name == "TRAIN":
        eps, r = _jax_draws(jicnf, key, B)
        extra = {"steer_r": r} if eps is None else {"steer_r": r, "eps": eps}
    with torch.no_grad():
        lp, regs, st = tcnf.inference(ticnf, getattr(tcnf.Mode, mode_name), xs, tcnf.params_from_numpy(ps_np),
                                      ys=ys, **extra)
    assert (int(st.steps), int(st.accepted), int(st.nfe)) == (int(st_r.steps), int(st_r.accepted), int(st_r.nfe))
    for a, b in ((lp, lp_r), (regs.e, regs_r.e), (regs.n, regs_r.n)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# (net, mode, probes, jvp)
GRAD_CASES = [
    ("one", "train", 1, False), ("one", "exact", 1, False), ("cond-one", "train", 1, False), ("one", "train", 2, False),
    ("cond-one", "train", 1, True), ("eight", "train", 1, True),
]


@pytest.mark.parametrize("net,mode,k,jvp", GRAD_CASES,
                         ids=[f"{n}-{m}-{'jvp' if j else f'k{k}'}" for n, m, k, j in GRAD_CASES])
def test_depth_gradients_match_jax_grad(net, mode, k, jvp):
    """The loss and its gradients in the params (and ys) through BACKSOLVE
    against `jax.grad` of the JAX package's fused loss (its kernels in
    interpret mode).  The Hutchinson gradients run the K1 and K2 chain
    forms' twins (their probe instances' with K probes or JVP), the exact
    one K7's twin forward and the plain backward (forward-only, as in the
    JAX package)."""
    mode_name = MODE_NAMES[mode]
    jicnf = _model(cnf, net, _cm(cnf, mode, k=k, jvp=jvp), steer_rate=0.1)
    ticnf = _model(tcnf, net, _cm(tcnf, mode, k=k, jvp=jvp), steer_rate=0.1)
    full = tfs.make_full_solve(ticnf, getattr(tcnf.Mode, mode_name), B)
    assert (full.adjoint is None) == (mode != "train")
    ps_np = _np_params(net, 11)
    xs, ys = _data(net, B, 12)
    key = jax.random.PRNGKey(13)
    jys = None if ys is None else jnp.asarray(ys)
    l_r, (g_r, gy_r) = jax.value_and_grad(
        lambda p, y: cnf.loss(jicnf, getattr(cnf.Mode, mode_name), jnp.asarray(xs), p, ys=y, key=key), argnums=(0, 1)
    )(_jps(ps_np), jys)
    ps = tcnf.params_from_numpy(ps_np)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    ys_t = None if ys is None else torch.from_numpy(ys).requires_grad_()
    extra = {}
    if mode_name == "TRAIN":
        eps, r = _jax_draws(jicnf, key, B)
        extra = {"steer_r": r} if eps is None else {"steer_r": r, "eps": eps}
    l = tcnf.loss(ticnf, getattr(tcnf.Mode, mode_name), xs, ps, ys=ys_t, **extra)
    g = torch.autograd.grad(l, leaves + ([] if ys_t is None else [ys_t]))
    np.testing.assert_allclose(float(l.detach()), float(l_r), **GRAD_TOL)
    ref = _leaves(g_r) + ([] if ys is None else [gy_r])
    for a, b in zip(g, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


# ---- coverage, refusals and routing ----


# name -> (dims, n_cond, probes, jvp)
_COVERED = {
    "one-layer": ((6, 6), 0, 1, False),
    "one-layer-dz32": ((32, 32), 0, 1, False),
    "refbench16": ((16, 16), 0, 1, False),
    "cond-refbench16": ((16, 16), 1, 1, False),
    "one-layer-k4": ((16, 16), 0, 4, False),
    "one-layer-jvp": ((16, 16), 1, 1, True),
    "five-layer-power6": ((6, 64, 64, 64, 64, 6), 0, 1, False),
    "eight-layer-power6": ((6,) + (64,) * 7 + (6,), 0, 1, False),
    "eight-layer-narrow": ((6,) + (32,) * 7 + (6,), 0, 2, False),
    "five-layer-wide": ((43, 64, 64, 64, 64, 43), 0, 1, False),
    "five-layer-streamed": ((43, 128, 128, 128, 128, 43), 0, 1, False),
    "five-layer-miniboone860": ((43, 860, 860, 860, 860, 43), 0, 4, False),
    "cond-five-layer-miniboone860": ((43, 860, 860, 860, 860, 43), 1, 1, True),
}
# name -> (dims, n_cond, what the refusal names, its ROADMAP row)
_REFUSED = {
    "nine-layer": ((6,) + (16,) * 8 + (6,), 0, "9-layer chains", "shape variants (b2)"),
    "nine-layer-wide": ((43,) + (64,) * 8 + (43,), 0, "9-layer chains", "shape variants (b2)"),
    "cond-nine-layer": ((6,) + (16,) * 8 + (6,), 1, "9-layer chains", "shape variants (b2)"),
    "one-layer-dz33": ((33, 33), 0, "1-layer nets of state width 33 > 32", "shape variants (c2)"),
    "cond-one-layer-dz64": ((64, 64), 1, "1-layer nets of state width 64 > 32", "shape variants (c2)"),
    "cond-one-layer-past-shared-memory": ((32, 32), 2000, "1-layer nets of shared memory", "shape variants (c2)"),
}


@pytest.mark.parametrize("name", list(_COVERED))
def test_depth_coverage(name):
    """The chain kernels take 1-layer nets up to state width 32 (the narrow
    forms) and chains of 5 to 8 layers in their narrow, wide and streamed
    forms, conditional or not, with K probes or JVP."""
    dims, n_cond, k, jvp = _COVERED[name]
    assert tfs._kernel_covers(TSIT5, _spec(dims, n_cond), k, chain=True, jvp=jvp) is None


@pytest.mark.parametrize("name", list(_REFUSED))
def test_depth_refusals_name_their_roadmap_row(name):
    """Chains past 8 layers and 1-layer nets past state width 32 are
    refused with the reason and their ROADMAP queue 2 row, by the coverage
    rule and by the wrappers' checks on a CUDA tensor (a stand-in: only
    its device is read)."""
    dims, n_cond, why, row = _REFUSED[name]
    spec = _spec(dims, n_cond)
    msg = tfs._kernel_covers(TSIT5, spec, chain=True)
    assert why in msg and f"ROADMAP queue 2, {row}" in msg
    fake = types.SimpleNamespace(device=torch.device("cuda", 0))
    with pytest.raises(NotImplementedError, match=row.replace("(", r"\(").replace(")", r"\)")):
        tfs._cuda_only("K7", fake, TSIT5, spec, chain=True)


@pytest.mark.parametrize(
    "dims,n_cond,wide",
    [
        ((16, 16), 0, False),
        ((32, 32), 3, False),
        ((6, 64, 64, 6), 0, False),
        ((6, 48, 48, 48, 48, 6), 0, False),
        ((6,) + (32,) * 7 + (6,), 0, False),
        ((6, 64, 64, 64, 64, 6), 0, True),
        ((6,) + (64,) * 7 + (6,), 0, True),
        ((16, 64, 64, 64, 16), 0, False),
        ((6, 64, 64, 6), 300, True),
    ],
    ids=["refbench16", "one-layer-dz32-cond", "power6", "five-layer-48", "eight-layer-32", "five-layer-power6",
         "eight-layer-power6", "four-layer", "power6-wide-ys"],
)
def test_narrow_forms_shared_memory_rule(dims, n_cond, wide):
    """A chain within the narrow widths whose weights and K2 slots at a
    32-thread block pass a block's shared memory goes to the wide forms
    before any launch: the weights of the narrow layout (layer 0's rows at
    the padded state width (a 1-layer net's rows at DZ), the middle layers
    and their transposes at pitches of 8, the last layer's rows at DZ) and
    32 slots of 4 DZ + 5 hsum + n_cond floats."""
    spec = _spec(dims, n_cond)
    assert tfs._wide_chain(spec) == wide
    assert (tfs._narrow_smem_bytes(spec) > tfs.WIDE_SMEM_BYTES) == wide
    if dims == (6, 64, 64, 6) and not n_cond:
        # power6's K2 chain form: layer 0, the middle layer and its transpose, the
        # last layer (37 KB), and 86 KB of slots at 32 threads.
        assert tfs._narrow_smem_bytes(spec) == 4 * (576 + 8256 + 520 + 100 + 32 * 673)
    if dims == (16, 16):
        # a 1-layer net: its 16 rows at DZ = 16 and its bias; slots of 4 DZ
        # floats and a DZ-float scratch vector for each of the 5 hidden blocks (odd).
        assert tfs._narrow_smem_bytes(spec) == 4 * (16 * 16 + 16 + 100 + 32 * 145)


_WRAPPERS = {
    "test": ["run_chain_test_solve_kernel"],
    "train": ["run_chain_train_solve_kernel", "run_chain_adjoint_kernel"],
    "exact": ["run_chain_exact_solve_kernel"],
}
_WIDE_WRAPPERS = {
    "test": ["run_wide_test_solve_kernel"],
    "train": ["run_wide_train_solve_kernel", "run_wide_adjoint_kernel"],
    "exact": ["run_wide_exact_solve_kernel"],
}


@pytest.mark.parametrize("dims", [(6, 6), (6,) + (32,) * 7 + (6,), (6, 64, 64, 64, 64, 6)],
                         ids=["one-layer", "eight-layer-narrow", "five-layer-past-narrow-shared-memory"])
@pytest.mark.parametrize("mode", ["test", "train", "exact"])
def test_fused_solve_routes_by_depth_and_shared_memory(monkeypatch, mode, dims):
    """`make_full_solve` hands 1-layer nets and narrow 8-layer chains to the
    narrow chain wrappers and a 5-layer chain whose K2 slots pass the narrow
    forms' shared memory to the wide ones, forward and (Hutchinson TRAIN)
    backward."""
    called = []
    for name in {n for d in (_WRAPPERS, _WIDE_WRAPPERS) for names in d.values() for n in names}:
        wrapped = getattr(tfs, name)
        monkeypatch.setattr(tfs, name, lambda *a, _n=name, _f=wrapped, **kw: called.append(_n) or _f(*a, **kw))
    icnf = tcnf.construct(tcnf.RNODE, tcnf.MLP(dims), 4, 2, compute_mode=_cm(tcnf, mode))
    ps = tcnf.params_from_numpy(glorot_params(np.random.default_rng(21), dims))
    xs = np.random.default_rng(22).normal(size=(4, 4)).astype(np.float32)
    if mode == "test":
        with torch.no_grad():
            tcnf.inference(icnf, tcnf.Mode.TEST, xs, ps)
    else:
        leaves = [x.requires_grad_() for x in _leaves(ps)]
        extra = {"eps": np.random.default_rng(23).normal(size=(1, 4, 6)).astype(np.float32)} if mode == "train" else {}
        torch.autograd.grad(tcnf.loss(icnf, tcnf.Mode.TRAIN, xs, ps, **extra), leaves)
    assert called == (_WIDE_WRAPPERS if tfs._wide_chain(_spec(dims)) else _WRAPPERS)[mode]


@pytest.mark.parametrize("dims,library", [((6, 6), "k2_chain_adjoint@depths"), ((6, 8, 6), "k2_chain_adjoint"),
                                           ((6, 8, 8, 8, 6), "k2_chain_adjoint"),
                                           ((6,) + (8,) * 4 + (6,), "k2_chain_adjoint@depths"),
                                           ((6,) + (8,) * 7 + (6,), "k2_chain_adjoint@depths")],
                         ids=["one-layer", "two-layer", "four-layer", "five-layer", "eight-layer"])
def test_depths_past_2_to_4_take_the_sources_other_build(dims, library):
    """A chain kernel's source builds twice: as it stands for 2 to 4 layers
    (the instances of the earlier depths keep their code) and with
    CNF_ALL_DEPTHS, as `<source>@depths`, for 1 to 8; the wrappers load the
    build that takes the chain's depth."""
    assert tfs._depth_build(tfs.K2C_KERNEL, _spec(dims)) == library
    from continuousnf_tpu_torch.ops import _build

    src, flags = _build.source_of(library)
    assert src == _build.CSRC / "k2_chain_adjoint.cu" and flags == (("-DCNF_ALL_DEPTHS",) if "@" in library else ())


# ---- the reference benchmark suite's model ----


@pytest.mark.parametrize("name", ["refbench16", "cond_refbench16"])
def test_refbench16_logpdf_and_loss_match_jax(name):
    """refbench16 (RNODE, nvars = naug = 8, Dense(16 => 16, tanh), the
    reference benchmark suite's model, on the flagship's recipe over tspan
    (0, 13)) and its conditional form at the suite's n = 64: TEST `logpdf`
    and the TRAIN loss against the JAX package's kernels in interpret mode,
    each through the narrow chain kernels' twins."""
    cfg = MODELS[name]
    n = REFBENCH_BATCH
    data = model_data(name, np.random.default_rng(31), n)
    xs, ys = data if cfg.get("n_cond") else (data, None)
    ps_np = glorot_params(np.random.default_rng(32), cfg["dims"])

    def build(m):
        variant = m.CondRNODE if cfg.get("n_cond") else m.RNODE
        return m.construct(variant, m.MLP(cfg["dims"]), cfg["nvars"], cfg["naug"], tspan=cfg["tspan"],
                           compute_mode=m.VecJacMode(fused=True), **cfg["extra"])

    jicnf, ticnf = build(cnf), build(tcnf)
    assert tfs.chain_spec(ticnf.nn, 16).n_layers == 1
    jys = None if ys is None else jnp.asarray(ys)
    lp_r, _, st_r = cnf.inference(jicnf, cnf.Mode.TEST, jnp.asarray(xs), _jps(ps_np), ys=jys)
    with torch.no_grad():
        lp, _, st = tcnf.inference(ticnf, tcnf.Mode.TEST, xs, tcnf.params_from_numpy(ps_np), ys=ys)
    assert int(st.steps) == int(st_r.steps)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_r), **TOL)
    key = jax.random.PRNGKey(33)
    l_r = cnf.loss(jicnf, cnf.Mode.TRAIN, jnp.asarray(xs), _jps(ps_np), ys=jys, key=key)
    eps, r = _jax_draws(jicnf, key, n)
    with torch.no_grad():
        l = tcnf.loss(ticnf, tcnf.Mode.TRAIN, xs, tcnf.params_from_numpy(ps_np), ys=ys, eps=eps, steer_r=r)
    np.testing.assert_allclose(float(l), float(l_r), **GRAD_TOL)


def test_one_layer_fit_on_cpu():
    """`fit` on refbench16 at a small batch: finite losses, moving
    parameters, and no kernel launched on the CPU."""
    cfg = MODELS["refbench16"]
    ps_np = glorot_params(np.random.default_rng(41), cfg["dims"])
    X = model_data("refbench16", np.random.default_rng(42), 2 * B)
    icnf = tcnf.construct(tcnf.RNODE, tcnf.MLP(cfg["dims"]), 8, 8, tspan=(0.0, 1.0),
                          compute_mode=tcnf.VecJacMode(fused=True), **cfg["extra"])
    before = _launch_counts()
    res = tcnf.fit(tcnf.ICNFModel(icnf, n_epochs=1, batch_size=B), X, ps=tcnf.params_from_numpy(ps_np), seed=0)
    assert _launch_counts() == before
    assert res.epochs == 1 and np.isfinite(res.losses).all()
    moved = [float((a - torch.from_numpy(b)).abs().max()) for a, b in zip(_leaves(res.ps), _leaves(ps_np))]
    assert min(moved) > 0.0
