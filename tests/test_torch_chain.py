"""The port's deep-chain path against the JAX package on the CPU: Dense tanh
chains of 3 and 4 layers (the tabular power6 model, MLP 6 -> 64 -> 64 -> 6,
and a narrow 3-layer chain).  The chain kernels' plain versions (the K1 and
K2 chain forms, the K7 TEST and exact forwards) against the JAX package's
kernels in interpret mode, TEST and TRAIN `inference`, the loss and its
gradients, `fit`, the chain kernels' coverage rule, and the entry points'
device default.

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
from continuousnf_tpu_torch.ode.tableaus import DOPRI5, TSIT5
from continuousnf_tpu_torch.ops import fused_solve as tfs
from continuousnf_tpu_torch.utils.configs import glorot_params, tabular_data

# The port's entry points default to the CUDA card; these tests run it on the CPU.
tcnf.set_default_device("cpu")

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
POWER6, SMALL, DEEP4, TOY2D = (6, 64, 64, 6), (5, 9, 7, 5), (4, 16, 12, 8, 4), (2, 32, 32, 2)
# dims -> (nvars, naug)
SPLIT = {POWER6: (6, 0), SMALL: (3, 2), DEEP4: (4, 0), TOY2D: (2, 0)}
B = 32
MODE_NAMES = {"train": "TRAIN", "test": "TEST", "exact": "TRAIN"}


def _cm(m, mode, fused=True):
    return m.ComputeMode(ad=m.ADMode.VJP, fused=fused, exact_trace=mode == "exact")


def _np_params(dims, seed):
    """Glorot-uniform weights and N(0, 0.05) biases, as the chip scripts make them."""
    return glorot_params(np.random.default_rng(seed), dims)


def _data(dims, n, seed):
    """The recipe of the JAX package's `synthetic_tabular`: tanh(z mix) + 0.1 z."""
    return tabular_data(np.random.default_rng(seed), n, SPLIT[dims][0])


def _model(m, dims, compute_mode=None, variant=None, **kw):
    nvars, naug = SPLIT[dims]
    cm = compute_mode if compute_mode is not None else m.VecJacMode(fused=True)
    return m.construct(variant or m.RNODE, m.MLP(dims), nvars, naug, compute_mode=cm, **kw)


def _jps(ps_np):
    return jax.tree.map(jnp.asarray, ps_np)


def _leaves(ps):
    return [p[k] for p in ps for k in ("w", "b")]


def _launch_counts():
    return {name: w.launches for name, w in tfs.KERNEL_WRAPPERS.items()}


def _y0(dims, xs, nacc):
    naug = SPLIT[dims][1]
    z0 = np.concatenate([xs, np.zeros((xs.shape[0], naug), np.float32)], axis=1)
    return np.concatenate([z0.ravel(), np.zeros(nacc * xs.shape[0], np.float32)])


@pytest.mark.parametrize("dims", [SMALL, POWER6], ids=["small", "power6"])
@pytest.mark.parametrize("mode", ["train", "test", "exact"])
def test_chain_forward_twins_match_jax_kernel(mode, dims):
    """The plain versions of the K1 chain form (train), K7 TEST (test) and
    the K7 exact forward (exact), through the fused solve on CPU tensors,
    against the JAX package's forward kernel in interpret mode from zero
    accumulators (the JAX kernel zeroes them): equal attempted and accepted
    steps, values at 1e-4.  No kernel is launched."""
    mode_name = MODE_NAMES[mode]
    ps_np = _np_params(dims, 1)
    xs = _data(dims, B, 2)
    nacc = 1 if mode == "test" else 3
    y0f = _y0(dims, xs, nacc)
    eps = None
    if mode == "train":
        eps = np.random.default_rng(3).normal(size=(1, B, dims[-1])).astype(np.float32)
    jfull = jfs.make_full_solve(_model(cnf, dims, _cm(cnf, mode)), getattr(cnf.Mode, mode_name), B)
    jargs = {"ps": _jps(ps_np), "eps": None if eps is None else jnp.asarray(eps), "ys": None}
    yT_r, st_r = jfull.forward(jnp.asarray(y0f), 0.0, 1.0, jargs)
    tfull = tfs.make_full_solve(_model(tcnf, dims, _cm(tcnf, mode)), getattr(tcnf.Mode, mode_name), B)
    targs = {"ps": tcnf.params_from_numpy(ps_np), "eps": None if eps is None else torch.from_numpy(eps), "ys": None}
    before = _launch_counts()
    with torch.no_grad():
        yT, st = tfull.forward(torch.from_numpy(y0f), torch.tensor(0.0), torch.tensor(1.0), targs)
    assert _launch_counts() == before
    assert (int(st.steps), int(st.accepted), int(st.nfe)) == (int(st_r.steps), int(st_r.accepted), int(st_r.nfe))
    np.testing.assert_allclose(yT.numpy(), np.asarray(yT_r), **TOL)


@pytest.mark.parametrize("dims", [SMALL, POWER6], ids=["small", "power6"])
def test_chain_adjoint_twin_matches_jax_kernel(dims):
    """The K2 chain form's plain version against the JAX package's adjoint
    kernel in interpret mode, at a batch where the JAX package runs one tile
    (its single-tile numerics are what the port keeps; at power6 and
    B = 4096 it would run two), from the same final state, cotangent and
    warm start: equal steps, results at 1e-4."""
    jspec = jfs.chain_spec(cnf.MLP(dims), dims[-1])
    assert jfs._vmem_estimate_adjoint(JTSIT5, jspec, B, 3, 1, False) <= jfs._VMEM_BUDGET_BYTES // 2
    ps_np = _np_params(dims, 4)
    xs = _data(dims, B, 5)
    eps = np.random.default_rng(6).normal(size=(1, B, dims[-1])).astype(np.float32)
    span = 1.0
    jfull = jfs.make_full_solve(_model(cnf, dims, tspan=(0.0, span)), cnf.Mode.TRAIN, B)
    args = {"ps": _jps(ps_np), "eps": jnp.asarray(eps), "ys": None}
    yTf, fst = jfull.forward(jnp.asarray(_y0(dims, xs, 3)), 0.0, span, args)
    rng = np.random.default_rng(7)
    g_yf = np.concatenate(
        [rng.normal(0.0, 0.1, B * dims[-1]), np.full(B, 1.0 / B), np.full(2 * B, 1e-2 / B)]
    ).astype(np.float32)
    dt_warm = float(fst.dt_last)
    y0_r, ay0_r, gargs_r, st_r = jfull.adjoint(yTf, jnp.asarray(g_yf), args, span, 0.0, dt_warm=dt_warm)

    tfull = tfs.make_full_solve(_model(tcnf, dims, tspan=(0.0, span)), tcnf.Mode.TRAIN, B)
    targs = {"ps": tcnf.params_from_numpy(ps_np), "eps": torch.from_numpy(eps), "ys": None}
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


def _jax_eps(icnf, key, batch):
    """The probes JAX `inference` draws from `key`."""
    eps_key, _ = jax.random.split(key)
    return np.array(icnf.draw_eps(eps_key, batch))


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize(
    "mode,dims",
    [("test", POWER6), ("train", POWER6), ("exact", POWER6), ("train", DEEP4), ("test", DEEP4)],
    ids=["test-power6", "train-power6", "exact-power6", "train-4-layer", "test-4-layer"],
)
def test_chain_inference_matches_jax(mode, dims, fused):
    """TEST and TRAIN `inference` of the deep-chain models against the JAX
    package's path of the same kind (unfused, or its kernel in interpret
    mode), with the same weights, inputs and probes."""
    mode_name = MODE_NAMES[mode]
    jicnf = _model(cnf, dims, _cm(cnf, mode, fused))
    ticnf = _model(tcnf, dims, _cm(tcnf, mode, fused))
    ps_np = _np_params(dims, 8)
    xs = _data(dims, B, 9)
    key = jax.random.PRNGKey(10)
    lp_r, regs_r, st_r = cnf.inference(jicnf, getattr(cnf.Mode, mode_name), jnp.asarray(xs), _jps(ps_np), key=key)
    extra = {"eps": _jax_eps(jicnf, key, B)} if mode == "train" else {}
    with torch.no_grad():
        lp, regs, st = tcnf.inference(ticnf, getattr(tcnf.Mode, mode_name), xs, tcnf.params_from_numpy(ps_np), **extra)
    assert (int(st.steps), int(st.accepted), int(st.nfe)) == (int(st_r.steps), int(st_r.accepted), int(st_r.nfe))
    for a, b in ((lp, lp_r), (regs.e, regs_r.e), (regs.n, regs_r.n)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    if mode_name == "TRAIN":
        assert float(regs.e.min()) > 0.0 and float(regs.n.min()) > 0.0


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("mode", ["train", "exact"])
def test_chain_gradients_match_jax_grad(mode, fused):
    """The power6 loss and its gradients through BACKSOLVE against `jax.grad`
    of the JAX package's loss on the path of the same kind.  Fused, the
    Hutchinson gradient runs the K1 and K2 chain forms' twins, the exact one
    the K7 forward's twin and the plain backward (forward-only, as in the
    JAX package)."""
    exact = mode == "exact"
    jicnf, ticnf = _model(cnf, POWER6, _cm(cnf, mode, fused)), _model(tcnf, POWER6, _cm(tcnf, mode, fused))
    full = tfs.make_full_solve(ticnf, tcnf.Mode.TRAIN, B)
    assert (full is None) == (not fused)
    if fused:
        assert (full.adjoint is None) == exact
    ps_np = _np_params(POWER6, 11)
    xs = _data(POWER6, B, 12)
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


def test_toy2d_ffjord_matches_jax():
    """The toy2d shape MLP 2 -> 32 -> 32 -> 2 under FFJORD (both norm rates
    off) through the fused TRAIN solve, against the JAX package's kernel."""
    dims = TOY2D
    jicnf = _model(cnf, dims, variant=cnf.FFJORD)
    ticnf = _model(tcnf, dims, variant=tcnf.FFJORD)
    assert (ticnf.lam1, ticnf.lam2) == (0.0, 0.0)
    ps_np = _np_params(dims, 14)
    xs = np.random.default_rng(15).normal(size=(B, 2)).astype(np.float32)
    key = jax.random.PRNGKey(16)
    lp_r, regs_r, st_r = cnf.inference(jicnf, cnf.Mode.TRAIN, jnp.asarray(xs), _jps(ps_np), key=key)
    with torch.no_grad():
        lp, regs, st = tcnf.inference(ticnf, tcnf.Mode.TRAIN, xs, tcnf.params_from_numpy(ps_np),
                                      eps=_jax_eps(jicnf, key, B))
    assert (int(st.steps), int(st.accepted)) == (int(st_r.steps), int(st_r.accepted))
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_r), **TOL)
    assert float(regs.e.abs().max()) == 0.0 and float(regs.n.abs().max()) == 0.0


def test_chain_fit_on_cpu():
    """`fit` on the fused power6 model: finite losses, moving parameters, and
    no kernel launched on the CPU."""
    ps_np = _np_params(POWER6, 17)
    X = _data(POWER6, 2 * B, 18)
    before = _launch_counts()
    res = tcnf.fit(tcnf.ICNFModel(_model(tcnf, POWER6), n_epochs=1, batch_size=B), X,
                   ps=tcnf.params_from_numpy(ps_np), seed=0)
    assert _launch_counts() == before
    assert res.epochs == 1 and np.isfinite(res.losses).all()
    moved = [float((a - torch.from_numpy(b)).abs().max()) for a, b in zip(_leaves(res.ps), _leaves(ps_np))]
    assert min(moved) > 0.0


# name -> (dims, tableau, activations, n_cond, probes, chain kernels?)
_COVERED = {
    "power6": (POWER6, TSIT5, None, 0, 1, True),
    "toy2d": (TOY2D, TSIT5, None, 0, 1, True),
    "beta": ((1, 64, 64, 1), TSIT5, None, 0, 1, True),
    "four-layer": ((16, 64, 64, 64, 16), TSIT5, None, 0, 1, True),
    "dz32": ((32, 64, 64, 32), TSIT5, None, 0, 1, True),
    "two-layer": ((16, 48, 16), TSIT5, None, 0, 1, False),
    "two-layer-chain-kernels": ((16, 48, 16), TSIT5, None, 0, 1, True),
    "conditional": (POWER6, TSIT5, None, 2, 1, True),
    "identity-layer": (POWER6, TSIT5, (True, True, False), 0, 1, True),
    "dopri5": (POWER6, DOPRI5, None, 0, 1, True),
    "wide-hidden": ((6, 65, 64, 6), TSIT5, None, 0, 1, True),
    "dz33": ((33, 64, 64, 33), TSIT5, None, 0, 1, True),
    "miniboone": ((43, 64, 64, 43), TSIT5, None, 0, 1, True),
    "two-probes": (POWER6, TSIT5, None, 0, 2, True),
    "two-layer-two-probes": ((16, 48, 16), TSIT5, None, 0, 2, False),
    "conditional-jvp": (POWER6, TSIT5, None, 2, 3, True),
    "two-layer-jvp": ((16, 48, 16), TSIT5, None, 0, 1, False),
    "wide-two-probes": ((43, 64, 64, 43), TSIT5, None, 0, 2, True),
    "wide-jvp": ((43, 64, 64, 43), TSIT5, None, 0, 1, True),
    "five-layer": ((6, 16, 16, 16, 16, 6), TSIT5, None, 0, 1, True),
    "one-layer-chain-kernels": ((6, 6), TSIT5, None, 0, 1, True),
}
_UNCOVERED = {
    "nine-layer": ((6,) + (16,) * 8 + (6,), TSIT5, None, 0, 1, True, "at most 8 layers"),
    "one-layer-dz33": ((33, 33), TSIT5, None, 0, 1, True, "1-layer nets of state width 33 > 32"),
    "two-layer-conditional-exact": ((16, 48, 16), TSIT5, None, 2, 1, False, "K8 in the 2-layer kernels"),
    "one-layer": ((6, 6), TSIT5, None, 0, 1, False, "1-layer"),
    "three-layer-2-layer-kernels": (POWER6, TSIT5, None, 0, 1, False, "K3, K1, K2 and K4 take 2 layers"),
}


def _spec(dims, acts, n_cond):
    n = len(dims) - 1
    ins = (dims[0] + n_cond,) + tuple(dims[1:-1])
    return tfs.ChainSpec(ins, tuple(dims[1:]), acts or (True,) * n, n_cond)


@pytest.mark.parametrize("name", list(_COVERED) + list(_UNCOVERED))
def test_kernel_coverage_rule(name):
    """Which configurations each kernel family takes: the 2-layer kernels
    (K3, K1, K2, K4) unconditional tanh chains of 2 layers with state widths
    up to 32, the chain kernels chains of 1 to 8 tanh or identity layers
    with hidden widths up to 64 and state widths up to 32, conditional or
    not, and through their wide forms ones of 2 layers or more up to 128
    and 64 (the fused solve takes them for every depth but 2, for
    conditional nets and for identity layers), both every embedded explicit tableau, and K VJP or
    JVP probes in the Hutchinson kernels, the wide forms included; the rest names its
    limit or the kernel still to port (a 2-layer conditional exact-TRAIN
    backward needs the K4 adjoint with ys rows: K8 in the 2-layer
    kernels)."""
    if name in _COVERED:
        dims, tab, acts, n_cond, k, chain = _COVERED[name]
        assert tfs._kernel_covers(tab, _spec(dims, acts, n_cond), k, chain, "jvp" in name) is None
    else:
        dims, tab, acts, n_cond, k, chain, why = _UNCOVERED[name]
        assert why in tfs._kernel_covers(tab, _spec(dims, acts, n_cond), k, chain, "jvp" in name)


_WRAPPERS = {
    ("test", False): ["run_solve_kernel"],
    ("test", True): ["run_chain_test_solve_kernel"],
    ("train", False): ["run_train_solve_kernel", "run_adjoint_kernel"],
    ("train", True): ["run_chain_train_solve_kernel", "run_chain_adjoint_kernel"],
    ("exact", False): ["run_exact_solve_kernel", "run_exact_adjoint_kernel"],
    ("exact", True): ["run_chain_exact_solve_kernel"],
}


_DEPTHS = {"two-layer": (5, 15, 5), "three-layer": SMALL, "one-layer": (5, 5), "five-layer": (5, 9, 7, 7, 7, 5)}


@pytest.mark.parametrize("depth", list(_DEPTHS))
@pytest.mark.parametrize("mode", ["test", "train", "exact"])
def test_fused_solve_takes_the_kernels_by_depth(monkeypatch, mode, depth):
    """`make_full_solve` runs 2-layer nets through the 2-layer wrappers and
    the other depths (1-layer nets, chains of 3 layers or more) through the
    chain wrappers, as the JAX package runs its N-layer stages for every
    depth but 2, forward and (TRAIN) backward; the exact and TEST backward of
    every depth but 2 is the plain one."""
    called = []
    for name in {n for names in _WRAPPERS.values() for n in names}:
        wrapped = getattr(tfs, name)
        monkeypatch.setattr(tfs, name, lambda *a, _n=name, _f=wrapped, **kw: called.append(_n) or _f(*a, **kw))
    dims = _DEPTHS[depth]
    deep = depth != "two-layer"
    icnf = tcnf.construct(tcnf.RNODE, tcnf.MLP(dims), 3, 2, compute_mode=_cm(tcnf, mode))
    ps = tcnf.params_from_numpy(_np_params(dims, 21))
    xs = _data(SMALL, 8, 22)
    if mode == "test":
        with torch.no_grad():
            tcnf.inference(icnf, tcnf.Mode.TEST, xs, ps)
    else:
        leaves = [x.requires_grad_() for x in _leaves(ps)]
        extra = {"eps": np.random.default_rng(23).normal(size=(1, 8, 5)).astype(np.float32)} if mode == "train" else {}
        torch.autograd.grad(tcnf.loss(icnf, tcnf.Mode.TRAIN, xs, ps, **extra), leaves)
    assert called == _WRAPPERS[mode, deep]


def test_chain_params_round_trip():
    """The chain kernels' flat [W0 | b0 | W1 | b1 | ...] and its split."""
    ps = tcnf.params_from_numpy(_np_params(DEEP4, 19))
    spec = tfs.chain_spec(tcnf.MLP(DEEP4), 4)
    ws, bs = [p["w"] for p in ps], [p["b"] for p in ps]
    flat, widths = tfs._chain_params("test", spec, ws, bs, torch.device("cpu"))
    assert list(widths) == list(DEEP4) and flat.numel() == sum(a * b + b for a, b in zip(DEEP4[:-1], DEEP4[1:]))
    ws2, bs2 = tfs._split_params(flat, spec)
    assert all(torch.equal(a, b) for a, b in zip(ws + bs, ws2 + bs2))


def test_exact_adjoint_of_a_deep_chain_is_refused():
    """K7 is forward-only, as in the JAX package: the exact adjoint wrapper
    and its twin refuse a chain of 3 layers."""
    spec = tfs.chain_spec(tcnf.MLP(SMALL), 5)
    ps = tcnf.params_from_numpy(_np_params(SMALL, 20))
    z = torch.zeros((4, 5))
    acc = torch.zeros((3, 4))
    kw = dict(norm_z=True, norm_j=True, rtol=1e-3, atol=1e-6, max_steps=100, ws=[p["w"] for p in ps],
              bs=[p["b"] for p in ps], zT=z, accT=acc, azT=z, aaccT=acc, t_hi=torch.tensor(1.0),
              t_lo=torch.tensor(0.0), dt_init=torch.tensor(-0.1))
    for fn in (tfs.run_exact_adjoint_kernel, tfs.adjoint_train_exact_plain):
        with pytest.raises(ValueError, match="forward-only"):
            fn(TSIT5, spec, **kw)


@pytest.fixture
def no_device(monkeypatch):
    """No card and no default device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    previous = tcnf.set_default_device(None)
    yield
    tcnf.set_default_device(previous)


_ENTRY_POINTS = {
    "Dense": lambda: tcnf.Dense(3, 4),
    "MLP": lambda: tcnf.MLP(POWER6),
    "Chain.init": lambda: tcnf.MLP(POWER6, device="cpu").init(),
    "params_from_numpy": lambda: tcnf.params_from_numpy(_np_params(POWER6, 0)),
    "init_params": lambda: tcnf.init_params(tcnf.construct(tcnf.RNODE, tcnf.MLP(POWER6, device="cpu"), 6)),
    "ICNF.init": lambda: tcnf.construct(tcnf.RNODE, tcnf.MLP(POWER6, device="cpu"), 6).init(),
    "fit": lambda: tcnf.fit(
        tcnf.ICNFModel(tcnf.construct(tcnf.RNODE, tcnf.MLP(POWER6, device="cpu"), 6), n_epochs=1, batch_size=4),
        _data(POWER6, 4, 0),
    ),
}


@pytest.mark.parametrize("name", list(_ENTRY_POINTS))
def test_entry_points_need_a_device(no_device, name):
    """Without a card and without a named device, the entry points raise and
    say how to ask for the CPU; they never carry on there."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _ENTRY_POINTS[name]()


def test_named_devices_and_tensors_decide(no_device):
    """A named device, a default set with `set_default_device`, or the
    caller's tensors decide the device."""
    assert tcnf.MLP(POWER6, device="cpu").layers[0].w.device.type == "cpu"
    assert tcnf.params_from_numpy(_np_params(POWER6, 0), "cpu")[0]["w"].device.type == "cpu"
    icnf = tcnf.construct(tcnf.RNODE, tcnf.MLP(POWER6, device="cpu"), 6)
    assert tcnf.init_params(icnf, device="cpu")[0]["w"].device.type == "cpu"
    res = tcnf.fit(tcnf.ICNFModel(icnf, n_epochs=1, batch_size=4), torch.from_numpy(_data(POWER6, 4, 0)))
    assert res.ps[0]["w"].device.type == "cpu"
    assert tcnf.set_default_device("cpu") is None
    assert tcnf.Dense(3, 4).w.device.type == "cpu"
