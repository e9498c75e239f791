"""The port's wide chain path against the JAX package on the CPU: the tabular
MINIBOONE model of benchmarks/tabular.py:58 (RNODE, MLP 43 -> 128 -> 128 ->
43 tanh), which the chain kernels' wide forms (the wide K1 and K2 chain
forms, wide K7 TEST and exact) take on the card.  Their plain versions,
through the fused solve on CPU tensors, against the JAX package's kernels in
interpret mode; TEST and TRAIN `inference`; the loss and its gradients
against `jax.grad`; the coverage rule of the narrow and wide forms; and the
fused solve's choice of wrappers by width.

Inputs come from numpy seeds; the JAX probe draws are reproduced from its
key split (`core/icnf.py:485`) and handed to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import continuousnf_tpu as cnf
import continuousnf_tpu_torch as tcnf
from continuousnf_tpu.ode.tableaus import TSIT5 as JTSIT5
from continuousnf_tpu.ops import fused_solve as jfs
from continuousnf_tpu_torch.ode.tableaus import TSIT5
from continuousnf_tpu_torch.ops import fused_solve as tfs
from continuousnf_tpu_torch.utils.configs import MODELS, glorot_params, model_data

# The port's entry points default to the CUDA card; these tests run it on the CPU.
tcnf.set_default_device("cpu")

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
MINIBOONE = MODELS["miniboone43"]["dims"]
NVARS = MODELS["miniboone43"]["nvars"]
B = 16
MODE_NAMES = {"train": "TRAIN", "test": "TEST", "exact": "TRAIN"}


def _cm(m, mode, fused=True):
    return m.ComputeMode(ad=m.ADMode.VJP, fused=fused, exact_trace=mode == "exact")


def _np_params(seed):
    """Glorot-uniform weights and N(0, 0.05) biases, as the chip scripts make them."""
    return glorot_params(np.random.default_rng(seed), MINIBOONE)


def _data(n, seed):
    """The recipe of the JAX package's `synthetic_tabular` at 43 variables."""
    return model_data("miniboone43", np.random.default_rng(seed), n)


def _model(m, compute_mode=None, **kw):
    cm = compute_mode if compute_mode is not None else m.VecJacMode(fused=True)
    return m.construct(m.RNODE, m.MLP(MINIBOONE), NVARS, 0, compute_mode=cm, **kw)


def _jps(ps_np):
    return jax.tree.map(jnp.asarray, ps_np)


def _leaves(ps):
    return [p[k] for p in ps for k in ("w", "b")]


def _launch_counts():
    return {name: w.launches for name, w in tfs.KERNEL_WRAPPERS.items()}


def _y0(xs, nacc):
    return np.concatenate([xs.ravel(), np.zeros(nacc * xs.shape[0], np.float32)])


def _jax_eps(icnf, key, batch):
    """The probes JAX `inference` draws from `key`."""
    eps_key, _ = jax.random.split(key)
    return np.array(icnf.draw_eps(eps_key, batch))


def test_miniboone_configuration():
    """The configuration as benchmarks/tabular.py:58 runs it: 43 variables,
    no augmentation, MLP 43 -> 128 -> 128 -> 43, tspan (0, 1), batch 2048;
    the port's chain is one the wide forms take and the narrow ones do not."""
    cfg = MODELS["miniboone43"]
    assert (cfg["dims"], cfg["nvars"], cfg["naug"], cfg["tspan"], cfg["batch"]) == (
        (43, 128, 128, 43), 43, 0, (0.0, 1.0), 2048)
    xs = _data(64, 0)
    assert xs.shape == (64, 43) and xs.dtype == np.float32 and np.isfinite(xs).all()
    spec = tfs.chain_spec(tcnf.MLP(MINIBOONE), NVARS)
    assert tfs._wide_chain(spec) and tfs._kernel_covers(TSIT5, spec, chain=True) is None


@pytest.mark.parametrize("mode", ["train", "test", "exact"])
def test_wide_forward_twins_match_jax_kernel(mode):
    """The plain versions of the wide K1 chain form (train), wide K7 TEST
    (test) and wide K7 exact (exact), through the fused solve on CPU
    tensors, against the JAX package's forward kernel in interpret mode from
    zero accumulators: equal attempted and accepted steps, values at 1e-4.
    No kernel is launched."""
    mode_name = MODE_NAMES[mode]
    ps_np = _np_params(1)
    xs = _data(B, 2)
    nacc = 1 if mode == "test" else 3
    y0f = _y0(xs, nacc)
    eps = np.random.default_rng(3).normal(size=(1, B, NVARS)).astype(np.float32) if mode == "train" else None
    jfull = jfs.make_full_solve(_model(cnf, _cm(cnf, mode)), getattr(cnf.Mode, mode_name), B)
    jargs = {"ps": _jps(ps_np), "eps": None if eps is None else jnp.asarray(eps), "ys": None}
    yT_r, st_r = jfull.forward(jnp.asarray(y0f), 0.0, 1.0, jargs)
    tfull = tfs.make_full_solve(_model(tcnf, _cm(tcnf, mode)), getattr(tcnf.Mode, mode_name), B)
    targs = {"ps": tcnf.params_from_numpy(ps_np), "eps": None if eps is None else torch.from_numpy(eps), "ys": None}
    before = _launch_counts()
    with torch.no_grad():
        yT, st = tfull.forward(torch.from_numpy(y0f), torch.tensor(0.0), torch.tensor(1.0), targs)
    assert _launch_counts() == before
    assert (int(st.steps), int(st.accepted), int(st.nfe)) == (int(st_r.steps), int(st_r.accepted), int(st_r.nfe))
    np.testing.assert_allclose(yT.numpy(), np.asarray(yT_r), **TOL)


def test_wide_adjoint_twin_matches_jax_kernel():
    """The wide K2 chain form's plain version against the JAX package's
    adjoint kernel in interpret mode, at a batch where the JAX package runs
    one tile (the port keeps single-tile numerics; at B = 2048 it would run
    two of 1024), from the same final state, cotangent and warm start:
    equal steps, results at 1e-4."""
    jspec = jfs.chain_spec(cnf.MLP(MINIBOONE), NVARS)
    assert jfs._vmem_estimate_adjoint(JTSIT5, jspec, B, 3, 1, False) <= jfs._VMEM_BUDGET_BYTES // 2
    ps_np = _np_params(4)
    xs = _data(B, 5)
    eps = np.random.default_rng(6).normal(size=(1, B, NVARS)).astype(np.float32)
    jfull = jfs.make_full_solve(_model(cnf), cnf.Mode.TRAIN, B)
    args = {"ps": _jps(ps_np), "eps": jnp.asarray(eps), "ys": None}
    yTf, fst = jfull.forward(jnp.asarray(_y0(xs, 3)), 0.0, 1.0, args)
    rng = np.random.default_rng(7)
    g_yf = np.concatenate(
        [rng.normal(0.0, 0.1, B * NVARS), np.full(B, 1.0 / B), np.full(2 * B, 1e-2 / B)]
    ).astype(np.float32)
    dt_warm = float(fst.dt_last)
    y0_r, ay0_r, gargs_r, st_r = jfull.adjoint(yTf, jnp.asarray(g_yf), args, 1.0, 0.0, dt_warm=dt_warm)

    tfull = tfs.make_full_solve(_model(tcnf), tcnf.Mode.TRAIN, B)
    targs = {"ps": tcnf.params_from_numpy(ps_np), "eps": torch.from_numpy(eps), "ys": None}
    before = _launch_counts()
    y0, ay0, gargs, st = tfull.adjoint(
        torch.from_numpy(np.array(yTf)), torch.from_numpy(g_yf), targs, torch.tensor(1.0), torch.tensor(0.0),
        dt_warm=dt_warm,
    )
    assert _launch_counts() == before
    assert (int(st.steps), int(st.accepted), int(st.nfe)) == (int(st_r.steps), int(st_r.accepted), int(st_r.nfe))
    np.testing.assert_allclose(y0.numpy(), np.asarray(y0_r), **TOL)
    np.testing.assert_allclose(ay0.numpy(), np.asarray(ay0_r), **TOL)
    for a, b in zip(_leaves(gargs["ps"]), _leaves(gargs_r["ps"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("mode", ["test", "train", "exact"])
def test_wide_inference_matches_jax(mode, fused):
    """TEST and TRAIN `inference` of the MINIBOONE model against the JAX
    package's path of the same kind (unfused, or its kernel in interpret
    mode), with the same weights, inputs and probes."""
    mode_name = MODE_NAMES[mode]
    jicnf, ticnf = _model(cnf, _cm(cnf, mode, fused)), _model(tcnf, _cm(tcnf, mode, fused))
    ps_np = _np_params(8)
    xs = _data(B, 9)
    key = jax.random.PRNGKey(10)
    lp_r, regs_r, st_r = cnf.inference(jicnf, getattr(cnf.Mode, mode_name), jnp.asarray(xs), _jps(ps_np), key=key)
    extra = {"eps": _jax_eps(jicnf, key, B)} if mode == "train" else {}
    with torch.no_grad():
        lp, regs, st = tcnf.inference(ticnf, getattr(tcnf.Mode, mode_name), xs, tcnf.params_from_numpy(ps_np), **extra)
    assert (int(st.steps), int(st.accepted), int(st.nfe)) == (int(st_r.steps), int(st_r.accepted), int(st_r.nfe))
    for a, b in ((lp, lp_r), (regs.e, regs_r.e), (regs.n, regs_r.n)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("mode", ["train", "exact"])
def test_wide_gradients_match_jax_grad(mode):
    """The MINIBOONE loss and its gradients through the fused BACKSOLVE
    against `jax.grad` of the JAX package's fused loss: the Hutchinson
    gradient runs the wide K1 and K2 chain forms' twins, the exact one wide
    K7 exact's twin and the plain backward (forward-only, as in the JAX
    package)."""
    exact = mode == "exact"
    jicnf, ticnf = _model(cnf, _cm(cnf, mode)), _model(tcnf, _cm(tcnf, mode))
    full = tfs.make_full_solve(ticnf, tcnf.Mode.TRAIN, B)
    assert (full.adjoint is None) == exact
    ps_np = _np_params(11)
    xs = _data(B, 12)
    key = jax.random.PRNGKey(13)
    l_r, g_r = jax.value_and_grad(lambda p: cnf.loss(jicnf, cnf.Mode.TRAIN, jnp.asarray(xs), p, key=key))(_jps(ps_np))
    ps = tcnf.params_from_numpy(ps_np)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    extra = {} if exact else {"eps": _jax_eps(jicnf, key, B)}
    l = tcnf.loss(ticnf, tcnf.Mode.TRAIN, xs, ps, **extra)
    g = torch.autograd.grad(l, leaves)
    np.testing.assert_allclose(float(l.detach()), float(l_r), **GRAD_TOL)
    for a, b in zip(g, _leaves(g_r)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


def _spec(dims, n_cond=0):
    n = len(dims) - 1
    ins = (dims[0] + n_cond,) + tuple(dims[1:-1])
    return tfs.ChainSpec(ins, tuple(dims[1:]), (True,) * n, n_cond)


# name -> (dims, n_cond, wide form?)
_WIDE_COVERED = {
    "miniboone": (MINIBOONE, 0, True),
    "dz64-hidden128": ((64, 128, 128, 64), 0, True),
    "two-layer-chain-dz40": ((40, 48, 40), 0, True),
    "hepmass42": ((42, 126, 42), 0, True),
    "power6": ((6, 64, 64, 6), 0, False),
    "cond-recipe": ((1, 64, 64, 1), 1, False),
    "dz32-hidden64": ((32, 64, 64, 32), 0, False),
}
# name -> (dims, n_cond, what the refusal names, probes).  Past state width
# 64, hidden width 128 or shared memory the streamed forms take one VJP
# probe; with two the chain is refused, naming why the wide forms do not
# take it.  Conditional wide chains run the wide forms' COND instances, with
# two probes their probe COND instances (K6 x K8); past the probe COND
# instances' shared memory or the wide widths the wide forms refuse them,
# naming why, and the streamed probe COND instances take them (K8 in the
# streamed forms).
_WIDE_REFUSED = {
    "dz65": ((65, 128, 128, 65), 0, "state width 65 > 64", 2),
    "hidden129": ((43, 129, 128, 43), 0, "hidden width 129 > 128", 2),
    "conditional-wide": ((64, 128, 128, 120, 64), 1, "shared memory", 2),
    "five-layer": ((43, 64, 64, 64, 64, 43), 0, "5-layer chains", 1),
    "weights-past-shared-memory": ((64, 128, 128, 128, 64), 0, "shared memory", 2),
    "conditional-hepmass42": ((42, 129, 42), 1, "hidden width 129 > 128", 2),
    "two-layer-dz66": ((66, 198, 66), 0, "state width 66 > 64", 2),
}


@pytest.mark.parametrize("name", list(_WIDE_COVERED))
def test_wide_coverage(name):
    """The chain kernels cover the MINIBOONE widths through their wide forms
    (state widths to 64, hidden to 128) and keep power6, the conditional
    recipe and every chain within 32 and 64 on the narrow forms."""
    dims, n_cond, wide = _WIDE_COVERED[name]
    spec = _spec(dims, n_cond)
    assert tfs._kernel_covers(TSIT5, spec, chain=True) is None
    assert tfs._wide_chain(spec) == wide


@pytest.mark.parametrize("name", list(_WIDE_REFUSED))
def test_wide_refusals_name_their_roadmap_row(name):
    """What the wide forms do not take is refused by them with the reason and
    its ROADMAP queue 2 row; the streamed forms (their probe instances with
    K probes, K6, and for conditional chains their probe COND instances,
    K6 x K8) take exactly the chains of up to 4 layers among them (chains
    past state width 64, hidden width 128 or shared memory), and refuse the
    rest."""
    dims, n_cond, why, probes = _WIDE_REFUSED[name]
    spec = _spec(dims, n_cond)
    msg = tfs._kernel_covers(TSIT5, spec, probes, chain=True, stream=False)
    assert msg is not None and why in msg and "ROADMAP queue 2" in msg
    streamed = tfs._kernel_covers(TSIT5, spec, probes, chain=True)
    assert (streamed is None) == tfs._stream_chain(spec, probes != 1) == (len(dims) <= 5)


def test_two_layer_kernels_refuse_a_wide_state():
    """The 2-layer kernels still keep a sample's state in registers: dz > 32
    is refused there, naming its ROADMAP row."""
    msg = tfs._kernel_covers(TSIT5, _spec((40, 48, 40)), chain=False)
    assert "state width 40 > 32" in msg and "ROADMAP queue 2" in msg


_WRAPPERS = {
    ("test", False): ["run_chain_test_solve_kernel"],
    ("test", True): ["run_wide_test_solve_kernel"],
    ("train", False): ["run_chain_train_solve_kernel", "run_chain_adjoint_kernel"],
    ("train", True): ["run_wide_train_solve_kernel", "run_wide_adjoint_kernel"],
    ("exact", False): ["run_chain_exact_solve_kernel"],
    ("exact", True): ["run_wide_exact_solve_kernel"],
}


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("mode", ["test", "train", "exact"])
def test_fused_solve_takes_the_forms_by_width(monkeypatch, mode, wide):
    """`make_full_solve` runs 3-layer chains within the narrow widths
    through the narrow chain wrappers and wider ones through the wide
    wrappers, forward and (Hutchinson TRAIN) backward; the exact chain's
    backward is the plain one."""
    called = []
    for name in {n for names in _WRAPPERS.values() for n in names}:
        wrapped = getattr(tfs, name)
        monkeypatch.setattr(tfs, name, lambda *a, _n=name, _f=wrapped, **kw: called.append(_n) or _f(*a, **kw))
    dims = (5, 66, 7, 5) if wide else (5, 9, 7, 5)
    icnf = tcnf.construct(tcnf.RNODE, tcnf.MLP(dims), 5, compute_mode=_cm(tcnf, mode))
    ps = tcnf.params_from_numpy(glorot_params(np.random.default_rng(21), dims))
    xs = np.random.default_rng(22).normal(size=(8, 5)).astype(np.float32)
    if mode == "test":
        with torch.no_grad():
            tcnf.inference(icnf, tcnf.Mode.TEST, xs, ps)
    else:
        leaves = [x.requires_grad_() for x in _leaves(ps)]
        extra = {"eps": np.random.default_rng(23).normal(size=(1, 8, 5)).astype(np.float32)} if mode == "train" else {}
        torch.autograd.grad(tcnf.loss(icnf, tcnf.Mode.TRAIN, xs, ps, **extra), leaves)
    assert called == _WRAPPERS[mode, wide]


def test_wide_fit_on_cpu():
    """`fit` on the fused MINIBOONE model: finite losses, moving parameters,
    and no kernel launched on the CPU."""
    ps_np = _np_params(17)
    X = _data(2 * B, 18)
    before = _launch_counts()
    res = tcnf.fit(tcnf.ICNFModel(_model(tcnf), n_epochs=1, batch_size=B), X, ps=tcnf.params_from_numpy(ps_np), seed=0)
    assert _launch_counts() == before
    assert res.epochs == 1 and np.isfinite(res.losses).all()
    moved = [float((a - torch.from_numpy(b)).abs().max()) for a, b in zip(_leaves(res.ps), _leaves(ps_np))]
    assert min(moved) > 0.0
