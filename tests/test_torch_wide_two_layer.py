"""2-layer tanh nets past the 2-layer kernels' state width in the port
against the JAX package on the CPU: the README net family
MLP((n_in, 3 n_in, n_in)) at the HEPMASS width, `MLP((42, 126, 42))`
(hepmass42: RNODE, nvars = naug = 21, the flagship recipe of bench.py), and
`MLP((40, 48, 40))`.  On the card they run wide K3 and wide K5 (TEST), the
wide K1 and K2 chain forms (Hutchinson TRAIN) and wide K7 exact with the
wide K4 adjoint (exact TRAIN).  Their plain versions, through the fused
solve on CPU tensors, against the JAX package's kernels in interpret mode
(the TEST forward, K5, the K4 adjoint, the TRAIN forwards); TEST and TRAIN
`inference`; the Hutchinson, exact and TEST losses and their gradients
against `jax.grad`; the fused solve's choice of wrappers; the coverage rule;
`fit`.

Inputs come from numpy seeds at B = 16, where the JAX package runs one tile;
the JAX probe and steering draws are reproduced from its key split
(`core/icnf.py:485`) and handed to the port."""

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
from continuousnf_tpu_torch.utils.configs import MODELS, glorot_params, tabular_data

# The port's entry points default to the CUDA card; these tests run it on the CPU.
tcnf.set_default_device("cpu")

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
HEPMASS = MODELS["hepmass42"]["dims"]
NETS = {"dz40": (40, 48, 40), "hepmass42": HEPMASS}
B = 16
MODE_NAMES = {"train": "TRAIN", "test": "TEST", "exact": "TRAIN"}
WIDE2 = ("run_wide_test2_solve_kernel", "run_wide_test_adjoint_kernel", "run_wide_exact_adjoint_kernel")


def _cm(m, mode, fused=True, k=1, ad="vjp"):
    return (m.JacVecMode if ad == "jvp" else m.VecJacMode)(k, fused=fused, exact_trace=mode == "exact")


def _model(m, dims, mode="train", fused=True, **kw):
    """The flagship recipe (bench.py:142-177) at n_in = dims[0]: RNODE,
    nvars = naug = n_in / 2, steer_rate 0.1, lambda3 = 1e-2, tspan (0, 1)
    unless given."""
    kw = {"tspan": (0.0, 1.0), "steer_rate": 0.1, "lam3": 1e-2, **kw}
    cm = kw.pop("compute_mode", None) or _cm(m, mode, fused)
    n = dims[0] // 2
    return m.construct(m.RNODE, m.MLP(dims), n, dims[0] - n, compute_mode=cm, **kw)


def _np_params(dims, seed):
    return glorot_params(np.random.default_rng(seed), dims)


def _data(dims, n, seed):
    """The recipe of the JAX package's `synthetic_tabular` at n_in / 2 variables."""
    return tabular_data(np.random.default_rng(seed), n, dims[0] // 2)


def _jps(ps_np):
    return jax.tree.map(jnp.asarray, ps_np)


def _leaves(ps):
    return [p[k] for p in ps for k in ("w", "b")]


def _launch_counts():
    return {name: w.launches for name, w in tfs.KERNEL_WRAPPERS.items()}


def _jax_draws(icnf, key, batch, probes=True):
    """The probes (None without) and the steering r JAX `inference` draws from
    `key`."""
    eps_key, steer_key = jax.random.split(key)
    r = float(jax.random.uniform(steer_key, (), jnp.float32, -icnf.steer_rate, icnf.steer_rate))
    return (np.array(icnf.draw_eps(eps_key, batch)) if probes else None), r


def _y0(dims, xs, nacc):
    z0 = np.concatenate([xs, np.zeros((xs.shape[0], dims[-1] - xs.shape[1]), np.float32)], axis=1)
    return np.concatenate([z0.ravel(), np.zeros(nacc * xs.shape[0], np.float32)])


def test_hepmass42_configuration():
    """The README net family at the HEPMASS width: 21 variables, 21
    augmented dimensions, MLP 42 -> 126 -> 42, the flagship's steering,
    lambda3 and tspan; a 2-layer tanh chain the register-resident 2-layer
    kernels refuse and their wide forms take."""
    cfg = MODELS["hepmass42"]
    assert (cfg["dims"], cfg["nvars"], cfg["naug"], cfg["tspan"], cfg["extra"]) == (
        (42, 126, 42), 21, 21, (0.0, 13.0), {"steer_rate": 0.1, "lam3": 1e-2})
    assert "batch" not in cfg  # the scripts' batch of 4096
    spec = tfs.chain_spec(tcnf.MLP(HEPMASS), 42)
    assert tfs._wide_two_layer(spec) and tfs._wide_two_layer_covers(TSIT5, spec) is None
    assert "state width 42 > 32" in tfs._kernel_covers(TSIT5, spec)
    xs = _data(HEPMASS, 64, 0)
    assert xs.shape == (64, 21) and xs.dtype == np.float32 and np.isfinite(xs).all()


@pytest.mark.parametrize("mode", ["test", "train", "exact"])
@pytest.mark.parametrize("net", list(NETS))
def test_wide_two_layer_forward_twins_match_jax_kernel(net, mode):
    """The plain versions of wide K3 (test: the closed-form TEST stage), the
    wide K1 chain form (train) and wide K7 exact (exact: the 2-layer pm
    stage), through the fused solve on CPU tensors, against the JAX
    package's forward kernel in interpret mode from zero accumulators: equal
    attempted and accepted steps, values at 1e-4.  No kernel is launched."""
    dims = NETS[net]
    ps_np = _np_params(dims, 1)
    xs = _data(dims, B, 2)
    nacc = 1 if mode == "test" else 3
    y0f = _y0(dims, xs, nacc)
    eps = np.random.default_rng(3).normal(size=(1, B, dims[-1])).astype(np.float32) if mode == "train" else None
    jfull = jfs.make_full_solve(_model(cnf, dims, mode), getattr(cnf.Mode, MODE_NAMES[mode]), B)
    jargs = {"ps": _jps(ps_np), "eps": None if eps is None else jnp.asarray(eps), "ys": None}
    yT_r, st_r = jfull.forward(jnp.asarray(y0f), 0.0, 1.0, jargs)
    tfull = tfs.make_full_solve(_model(tcnf, dims, mode), getattr(tcnf.Mode, MODE_NAMES[mode]), B)
    targs = {"ps": tcnf.params_from_numpy(ps_np), "eps": None if eps is None else torch.from_numpy(eps), "ys": None}
    before = _launch_counts()
    with torch.no_grad():
        yT, st = tfull.forward(torch.from_numpy(y0f), torch.tensor(0.0), torch.tensor(1.0), targs)
    assert _launch_counts() == before
    assert (int(st.steps), int(st.accepted), int(st.nfe)) == (int(st_r.steps), int(st_r.accepted), int(st_r.nfe))
    np.testing.assert_allclose(yT.numpy(), np.asarray(yT_r), **TOL)


def _adjoint_case(net, mode, seed):
    """The JAX package's fused forward and adjoint (its kernels in interpret
    mode, one tile) and the port's fused adjoint (the twin on the CPU) from
    the same final state, cotangent and warm start."""
    dims = NETS[net]
    span = 2.0
    ps_np = _np_params(dims, seed)
    xs = _data(dims, B, seed + 1)
    nacc = 1 if mode == "test" else 3
    mode_j, mode_t = getattr(cnf.Mode, MODE_NAMES[mode]), getattr(tcnf.Mode, MODE_NAMES[mode])
    jspec = jfs.chain_spec(cnf.MLP(dims), dims[-1])
    assert jfs._vmem_estimate_adjoint(JTSIT5, jspec, B, nacc, 1, mode == "exact") <= jfs._VMEM_BUDGET_BYTES // 2
    jfull = jfs.make_full_solve(_model(cnf, dims, mode, tspan=(0.0, span)), mode_j, B)
    assert jfull.adjoint is not None
    args = {"ps": _jps(ps_np), "eps": None, "ys": None}
    yTf, fst = jfull.forward(jnp.asarray(_y0(dims, xs, nacc)), 0.0, span, args)
    rng = np.random.default_rng(seed + 2)
    acc_ct = [np.full(B, 1.0 / B)] + ([np.full(2 * B, 1e-2 / B)] if nacc == 3 else [])
    g_yf = np.concatenate([rng.normal(0.0, 0.1, B * dims[-1])] + acc_ct).astype(np.float32)
    dt_warm = float(fst.dt_last)
    ref = jfull.adjoint(yTf, jnp.asarray(g_yf), args, span, 0.0, dt_warm=dt_warm)
    tfull = tfs.make_full_solve(_model(tcnf, dims, mode, tspan=(0.0, span)), mode_t, B)
    targs = {"ps": tcnf.params_from_numpy(ps_np), "eps": None, "ys": None}
    before = _launch_counts()
    got = tfull.adjoint(torch.from_numpy(np.array(yTf)), torch.from_numpy(g_yf), targs, torch.tensor(span),
                        torch.tensor(0.0), dt_warm=dt_warm)
    assert _launch_counts() == before
    return got, ref


@pytest.mark.parametrize("mode", ["test", "exact"], ids=["K5", "K4-adjoint"])
@pytest.mark.parametrize("net", list(NETS))
def test_wide_two_layer_adjoint_twins_match_jax_kernel(net, mode):
    """The plain versions of wide K5 (the TEST backsolve, ct_m folded into
    g) and of the wide K4 adjoint (the exact backsolve with g_pm in the state
    and chained after it), through the fused solve's backward member on CPU
    tensors, against the JAX package's adjoint kernel in interpret mode at
    one tile: equal steps, accepted steps and NFE, states and gradients at
    1e-4.  No kernel is launched."""
    (y0, ay0, gargs, st), (y0_r, ay0_r, gargs_r, st_r) = _adjoint_case(net, mode, 4)
    assert (int(st.steps), int(st.accepted), int(st.nfe)) == (int(st_r.steps), int(st_r.accepted), int(st_r.nfe))
    np.testing.assert_allclose(y0.numpy(), np.asarray(y0_r), **TOL)
    np.testing.assert_allclose(ay0.numpy(), np.asarray(ay0_r), **TOL)
    for a, b in zip(_leaves(gargs["ps"]), _leaves(gargs_r["ps"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("mode", ["test", "train", "exact"])
@pytest.mark.parametrize("net", list(NETS))
def test_wide_two_layer_inference_matches_jax(net, mode):
    """TEST and TRAIN `inference` (Hutchinson with the JAX probe and
    steering draws handed over, and exact) against the JAX package's fused
    path (its kernels in interpret mode), with the same weights and inputs."""
    dims = NETS[net]
    mode_name = MODE_NAMES[mode]
    jicnf, ticnf = _model(cnf, dims, mode), _model(tcnf, dims, mode)
    ps_np = _np_params(dims, 8)
    xs = _data(dims, B, 9)
    key = jax.random.PRNGKey(10)
    lp_r, regs_r, st_r = cnf.inference(jicnf, getattr(cnf.Mode, mode_name), jnp.asarray(xs), _jps(ps_np), key=key)
    extra = {}
    if mode != "test":
        eps, r = _jax_draws(jicnf, key, B, mode == "train")
        extra = {"steer_r": r} if eps is None else {"eps": eps, "steer_r": r}
    with torch.no_grad():
        lp, regs, st = tcnf.inference(ticnf, getattr(tcnf.Mode, mode_name), xs, tcnf.params_from_numpy(ps_np), **extra)
    assert (int(st.steps), int(st.accepted), int(st.nfe)) == (int(st_r.steps), int(st_r.accepted), int(st_r.nfe))
    for a, b in ((lp, lp_r), (regs.e, regs_r.e), (regs.n, regs_r.n)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("mode", ["test", "train", "exact"])
@pytest.mark.parametrize("net", list(NETS))
def test_wide_two_layer_gradients_match_jax_grad(net, mode):
    """The TEST, Hutchinson and exact losses and their gradients through the
    fused BACKSOLVE against `jax.grad` of the JAX package's fused loss: the
    backward members are wide K5's, the wide K2 chain form's and the wide K4
    adjoint's twins."""
    dims = NETS[net]
    mode_name = MODE_NAMES[mode]
    jicnf, ticnf = _model(cnf, dims, mode), _model(tcnf, dims, mode)
    assert tfs.make_full_solve(ticnf, getattr(tcnf.Mode, mode_name), B).adjoint is not None
    ps_np = _np_params(dims, 11)
    xs = _data(dims, B, 12)
    key = jax.random.PRNGKey(13)
    jmode = getattr(cnf.Mode, mode_name)
    l_r, g_r = jax.value_and_grad(lambda p: cnf.loss(jicnf, jmode, jnp.asarray(xs), p, key=key))(_jps(ps_np))
    extra = {}
    if mode != "test":
        eps, r = _jax_draws(jicnf, key, B, mode == "train")
        extra = {"steer_r": r} if eps is None else {"eps": eps, "steer_r": r}
    ps = tcnf.params_from_numpy(ps_np)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    before = _launch_counts()
    l = tcnf.loss(ticnf, getattr(tcnf.Mode, mode_name), xs, ps, **extra)
    g = torch.autograd.grad(l, leaves)
    assert _launch_counts() == before
    np.testing.assert_allclose(float(l.detach()), float(l_r), **GRAD_TOL)
    for a, b in zip(g, _leaves(g_r)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


def test_hepmass42_gradient_at_its_span_is_as_close_to_float64_as_jax():
    """The hepmass42 configuration itself (tspan (0, 13)): the Hutchinson
    TRAIN loss within 1e-4 of `jax.grad`'s, the JAX draws handed over, and
    the port's fused gradient as close to a float64 rtol 1e-7 solve as the
    JAX package's fused one (within 2x its distance).  Over this span every
    float32 path, fused or not, JAX or port, sits 2e-4 to 8e-4 max|g| from
    the float64 solve, so the two fused gradients are not held to each other
    at 1e-4."""
    jicnf = _model(cnf, HEPMASS, tspan=(0.0, 13.0))
    ps_np = _np_params(HEPMASS, 14)
    xs = _data(HEPMASS, B, 15)
    key = jax.random.PRNGKey(16)
    l_r, g_r = jax.value_and_grad(lambda p: cnf.loss(jicnf, cnf.Mode.TRAIN, jnp.asarray(xs), p, key=key))(_jps(ps_np))
    eps, r = _jax_draws(jicnf, key, B)

    def grads(dtype, **kw):
        icnf = _model(tcnf, HEPMASS, tspan=(0.0, 13.0), dtype=dtype, **kw)
        leaves = [x.to(dtype).requires_grad_() for x in _leaves(tcnf.params_from_numpy(ps_np))]
        ps = tuple({"w": w, "b": b} for w, b in zip(leaves[::2], leaves[1::2]))
        l = tcnf.loss(icnf, tcnf.Mode.TRAIN, torch.from_numpy(xs).to(dtype), ps, eps=torch.from_numpy(eps).to(dtype),
                      steer_r=r)
        return l.detach(), torch.autograd.grad(l, leaves)

    l, g = grads(torch.float32)
    _, g64 = grads(torch.float64, fused=False, solver=tcnf.SolverOptions(rtol=1e-7, atol=1e-9))
    np.testing.assert_allclose(float(l), float(l_r), **GRAD_TOL)
    for a, b, t in zip(g, _leaves(g_r), g64):
        t = t.numpy()
        d_port, d_jax = np.abs(a.numpy() - t).max(), np.abs(np.asarray(b) - t).max()
        assert d_port <= 2.0 * d_jax and d_port <= 2e-2 * np.abs(t).max()


def _spec(dims, n_cond=0, acts=None):
    ins = (dims[0] + n_cond,) + tuple(dims[1:-1])
    return tfs.ChainSpec(ins, tuple(dims[1:]), acts or (True,) * (len(dims) - 1), n_cond)


# name -> (dims, n_cond, activations, what the refusal names; None: covered)
_WIDE2_CASES = {
    "hepmass42": (HEPMASS, 0, None, None),
    "dz40": ((40, 48, 40), 0, None, None),
    "dz64-hidden128": ((64, 128, 64), 0, None, None),
    "conditional-hepmass42": (HEPMASS, 1, None, None),
    "dz66": ((66, 198, 66), 0, None, "state width 66 > 64"),
    "hidden129": ((42, 129, 42), 0, None, "hidden width 129 > 128"),
    "identity-output": (HEPMASS, 0, (True, False), "reference fault 2"),
}


@pytest.mark.parametrize("name", list(_WIDE2_CASES))
def test_wide_two_layer_coverage(name):
    """The wide 2-layer kernels take the 2-layer tanh nets to dz 64 and
    hidden 128 (conditional ones in wide K3's and wide K5's COND instances),
    and refuse wider ones (ROADMAP queue 2, shape variants (e)) and identity
    layers (the JAX package's 2-layer TEST and exact stages assume tanh
    layers: reference fault 2)."""
    dims, n_cond, acts, why = _WIDE2_CASES[name]
    msg = tfs._wide_two_layer_covers(TSIT5, _spec(dims, n_cond, acts))
    if why is None:
        assert msg is None
    else:
        assert msg is not None and why in msg


# mode -> the wrappers the loss and its gradient call, in order
_ROUTES = {
    "test": ["run_wide_test2_solve_kernel", "run_wide_test_adjoint_kernel"],
    "train": ["run_wide_train_solve_kernel", "run_wide_adjoint_kernel"],
    "exact": ["run_wide_exact_solve_kernel", "run_wide_exact_adjoint_kernel"],
    "train-K4": ["run_wide_train_solve_kernel", "run_wide_adjoint_kernel"],
    "train-jvp": ["run_wide_train_solve_kernel", "run_wide_adjoint_kernel"],
}


@pytest.mark.parametrize("route", list(_ROUTES))
def test_fused_solve_takes_the_wide_forms_for_wide_two_layer_nets(monkeypatch, route):
    """`make_full_solve` runs an unconditional 2-layer tanh net past state
    width 32 through wide K3 and wide K5 (TEST), the wide K1 and K2 chain
    forms with all K probes and the direction (Hutchinson TRAIN) and wide K7
    exact with the wide K4 adjoint (exact TRAIN), forward and backward, and
    no other wrapper."""
    mode = route.split("-")[0]
    k, ad = {"train-K4": (4, "vjp"), "train-jvp": (1, "jvp")}.get(route, (1, "vjp"))
    called = []
    names = {n for v in _ROUTES.values() for n in v} | {
        "run_solve_kernel", "run_train_solve_kernel", "run_adjoint_kernel", "run_exact_solve_kernel",
        "run_exact_adjoint_kernel", "run_test_adjoint_kernel", "run_wide_test_solve_kernel"}
    for name in names:
        wrapped = getattr(tfs, name)

        def spy(*a, _n=name, _f=wrapped, **kw):
            called.append((_n, tuple(kw["eps"].shape) if kw.get("eps") is not None else None, kw.get("jvp")))
            return _f(*a, **kw)

        monkeypatch.setattr(tfs, name, spy)
    dims = (40, 48, 40)
    icnf = _model(tcnf, dims, mode, compute_mode=_cm(tcnf, mode, True, k, ad))
    ps = tcnf.params_from_numpy(_np_params(dims, 21))
    xs = _data(dims, 8, 22)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    extra = {"eps": np.random.default_rng(23).normal(size=(k, 8, 40)).astype(np.float32)} if mode == "train" else {}
    torch.autograd.grad(tcnf.loss(icnf, getattr(tcnf.Mode, MODE_NAMES[mode]), xs, ps, **extra), leaves)
    assert [c[0] for c in called] == _ROUTES[route]
    if mode == "train":
        assert [c[1:] for c in called] == [((k, 8, 40), ad == "jvp")] * 2


def test_wide_two_layer_wrappers_run_the_twins_on_the_cpu_without_counting():
    """On CPU tensors wide K3, wide K5 and the wide K4 adjoint run their
    twins, bit for bit, and count no launch; `reset_launches` covers them."""
    assert {getattr(tfs, n) for n in WIDE2} <= set(tfs.KERNEL_WRAPPERS.values())
    dims = (40, 48, 40)
    spec = tfs.chain_spec(tcnf.MLP(dims), 40)
    ps = tcnf.params_from_numpy(_np_params(dims, 24))
    rng = np.random.default_rng(25)
    T = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    base = dict(rtol=1e-3, atol=1e-6, max_steps=100, ws=[p["w"] for p in ps], bs=[p["b"] for p in ps])
    tfs.reset_launches()
    kw = dict(base, z0=T(rng.normal(size=(8, 40))), dlogp0=T(rng.normal(size=8)), t0=torch.tensor(0.0),
              t1=torch.tensor(1.0), dt_init=torch.tensor(0.05))
    got = tfs.run_wide_test2_solve_kernel(TSIT5, spec, **kw)
    fwd = tfs.solve_test_plain(TSIT5, spec, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, fwd))
    adj = dict(base, zT=fwd[0], accT=fwd[1][None], azT=T(rng.normal(size=(8, 40))), aaccT=T(rng.normal(size=(1, 8))),
               t_hi=torch.tensor(1.0), t_lo=torch.tensor(0.0), dt_init=torch.tensor(-0.05))
    for wrapper, twin, extra in ((tfs.run_wide_test_adjoint_kernel, tfs.adjoint_test_plain, {}),
                                 (tfs.run_wide_exact_adjoint_kernel, tfs.adjoint_train_exact_plain,
                                  dict(norm_z=True, norm_j=True, accT=T(rng.normal(size=(3, 8))),
                                       aaccT=T(rng.normal(size=(3, 8)))))):
        got, ref = wrapper(TSIT5, spec, **dict(adj, **extra)), twin(TSIT5, spec, **dict(adj, **extra))
        assert all(torch.equal(a, b) for a, b in zip(got[:3] + got[5:], ref[:3] + ref[5:]))
        assert all(torch.equal(a, b) for a, b in zip(got[3] + got[4], ref[3] + ref[4]))
    assert all(w.launches == 0 for w in tfs.KERNEL_WRAPPERS.values())


@pytest.mark.parametrize("exact", [False, True], ids=["hutchinson", "exact"])
def test_wide_two_layer_fit_on_cpu(exact):
    """`fit` on the fused hepmass42 model for two Lion steps: finite losses,
    moving parameters, and no kernel launched on the CPU."""
    ps_np = _np_params(HEPMASS, 17)
    X = _data(HEPMASS, 2 * B, 18)
    before = _launch_counts()
    model = tcnf.ICNFModel(_model(tcnf, HEPMASS, "exact" if exact else "train"), n_epochs=1, batch_size=B)
    res = tcnf.fit(model, X, ps=tcnf.params_from_numpy(ps_np), seed=0)
    assert _launch_counts() == before
    assert res.epochs == 1 and np.isfinite(res.losses).all()
    moved = [float((a - torch.from_numpy(b)).abs().max()) for a, b in zip(_leaves(res.ps), _leaves(ps_np))]
    assert min(moved) > 0.0


def test_wide_k4_parts_takes_out_each_part():
    """`utils/wide_k4_parts.py` finds, in the wide K4 adjoint's source, each
    part it takes out (the g_pm gradient sums, the two basis-row passes, the
    g_pm block of the state), so its variants differ from the kernel where
    they should."""
    from pathlib import Path

    from continuousnf_tpu_torch.ops import _build
    from continuousnf_tpu_torch.utils import wide_k4_parts

    src = Path(_build.CSRC / f"{tfs.K4WA_KERNEL}.cu").read_text()
    v = wide_k4_parts.variants(src)
    assert v["full"] == src and len({v[k] for k in v}) == 4
    assert v["no_pm_state"].count("const int Pt = L.P;") == 1
