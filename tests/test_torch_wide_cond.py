"""Conditional nets past the narrow widths in the port against the JAX
package on the CPU (K8 in the wide forms): a conditional 2-layer net
`MLP((35, 72, 34))` on [z | ys] with one ys column, whose TEST stages run
wide K3's and wide K5's COND instances on the card, its Hutchinson ones
the wide K1 and K2 chain forms' COND instances (with K probes or JVP their
probe COND instances: tests/test_torch_wide_cond_probes.py) and its exact
ones wide K7 exact's and the wide K4 adjoint's, and a conditional 3-layer chain
`MLP((10, 72, 72, 8))` with two ys columns, past hidden width 64, which
trains through the same chain-form instances and serves through wide K7
TEST's (the exact trace: tests/test_torch_wide_cond_exact.py).  The COND twins through
the fused solve on CPU tensors against the JAX package's kernels in
interpret mode at one tile (the TEST and TRAIN forwards, the TEST and TRAIN
adjoints with a_ys0); TEST and TRAIN `inference`; the losses and their
gradients in the params and in ys against `jax.grad`; `CondICNFDist.logpdf`;
the coverage rule, the wrappers `make_full_solve` picks, and what is still
refused, each naming its ROADMAP row; the cond_hepmass42 configuration and
`fit`.

Inputs come from numpy seeds at B = 16, where the JAX package runs one tile;
the JAX probe and steering draws are reproduced from its key split
(`core/icnf.py:485`) and handed to the port.  Tolerances: values at
rtol = atol = 1e-4 (float32 sums in another order), gradients at rtol 1e-4,
atol 1e-5."""

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
from continuousnf_tpu_torch.utils.configs import HEPMASS_MASSES, MODELS, glorot_params, model_data

# The port's entry points default to the CUDA card; these tests run it on the CPU.
tcnf.set_default_device("cpu")

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
TWO, THREE = (35, 72, 34), (10, 72, 72, 8)
COND_HEPMASS = MODELS["cond_hepmass42"]["dims"]
# dims -> (nvars, naug, n_cond)
SPLIT = {TWO: (17, 17, 1), THREE: (4, 4, 2), COND_HEPMASS: (21, 21, 1), (17, 48, 16): (8, 8, 1),
         (2, 64, 64, 1): (1, 0, 1)}
NETS = {"two-layer": TWO, "three-layer": THREE}
B = 16
MODE_NAMES = {"train": "TRAIN", "test": "TEST", "exact": "TRAIN"}
COND_WRAPPERS = ("run_wide_cond_train_solve_kernel", "run_wide_cond_adjoint_kernel",
                 "run_wide_cond_test2_solve_kernel", "run_wide_cond_test_adjoint_kernel",
                 "run_wide_cond_test_solve_kernel", "run_wide_cond_exact_solve_kernel",
                 "run_wide_cond_exact_adjoint_kernel")


def _cm(m, mode, fused=True, k=1, ad="vjp"):
    return (m.JacVecMode if ad == "jvp" else m.VecJacMode)(k, fused=fused, exact_trace=mode == "exact")


def _model(m, dims, mode="train", fused=True, **kw):
    """CondRNODE on [z | ys] with hepmass42's recipe (steer_rate 0.1,
    lambda3 = 1e-2), tspan (0, 1) unless given."""
    kw = {"tspan": (0.0, 1.0), "steer_rate": 0.1, "lam3": 1e-2, **kw}
    cm = kw.pop("compute_mode", None) or _cm(m, mode, fused)
    nvars, naug, _ = SPLIT[dims]
    return m.construct(m.CondRNODE, m.MLP(dims), nvars, naug, compute_mode=cm, **kw)


def _np_params(dims, seed):
    return glorot_params(np.random.default_rng(seed), dims)


def _data(dims, n, seed):
    """(xs (n, nvars), ys (n, n_cond)): x ~ N(0, 1) next to y ~ U(-1, 1)."""
    rng = np.random.default_rng(seed)
    nvars, _, nc = SPLIT[dims]
    return rng.normal(size=(n, nvars)).astype(np.float32), rng.uniform(-1.0, 1.0, (n, nc)).astype(np.float32)


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


def _spec(dims, n_cond):
    return tfs.ChainSpec((dims[0],) + tuple(dims[1:-1]), tuple(dims[1:]), (True,) * (len(dims) - 1), n_cond)


def test_cond_hepmass42_configuration():
    """CondRNODE at the HEPMASS width: 21 variables, 21 augmented
    dimensions, one conditioning column, MLP 43 -> 126 -> 42 on [z | ys],
    hepmass42's steering, lambda3 and tspan; the data's ys are the five
    standardised signal masses and xs the tabular recipe shifted by 0.5 ys.
    The wide COND instances take it, the wide K4 adjoint's included; the
    narrow kernels do not, nor the wide 2-layer kernels a conditional net
    past the wide limits, whose TEST stages the streamed COND instances take
    and whose exact backward the streamed K4 adjoint's COND instance
    takes."""
    cfg = MODELS["cond_hepmass42"]
    hep = MODELS["hepmass42"]
    assert (cfg["dims"], cfg["nvars"], cfg["naug"], cfg["n_cond"]) == ((43, 126, 42), 21, 21, 1)
    assert (cfg["tspan"], cfg["extra"]) == (hep["tspan"], hep["extra"]) and "batch" not in cfg
    xs, ys = model_data("cond_hepmass42", np.random.default_rng(0), 4096)
    assert xs.shape == (4096, 21) and ys.shape == (4096, 1) and xs.dtype == ys.dtype == np.float32
    masses = np.asarray(HEPMASS_MASSES)
    np.testing.assert_allclose(np.unique(ys), (masses - 1000.0) / 353.5533905932738, rtol=1e-6)
    assert np.isfinite(xs).all()
    icnf = tcnf.construct(tcnf.CondRNODE, tcnf.MLP(cfg["dims"]), 21, 21)
    spec = tfs.chain_spec(icnf.nn, icnf.zdim)
    assert spec.n_cond == 1 and tfs._wide_two_layer(spec) and tfs._wide_chain(spec)
    assert tfs._wide_two_layer_covers(TSIT5, spec) is None
    assert tfs._kernel_covers(TSIT5, spec, chain=True) is None
    past = _spec((44, 130, 43), 1)
    assert "hidden width 130 > 128" in tfs._wide_two_layer_covers(TSIT5, past)
    assert tfs._stream_two_layer_covers(TSIT5, past) is None
    assert tfs._stream_exact_covers(TSIT5, past) is None


@pytest.mark.parametrize("net,mode", [("two-layer", "test"), ("two-layer", "train"), ("three-layer", "train")])
def test_wide_cond_forward_twins_match_jax_kernel(net, mode):
    """The plain versions of wide K3's COND instance (test: the closed-form
    TEST stage on [z | ys]) and of the wide K1 chain form's (train), through
    the fused solve on CPU tensors, against the JAX package's forward kernel
    with ys rows in interpret mode from zero accumulators: equal attempted
    and accepted steps and NFE, values at 1e-4.  No kernel is launched."""
    dims = NETS[net]
    ps_np = _np_params(dims, 1)
    xs, ys = _data(dims, B, 2)
    nacc = 1 if mode == "test" else 3
    y0f = _y0(dims, xs, nacc)
    eps = np.random.default_rng(3).normal(size=(1, B, dims[-1])).astype(np.float32) if mode == "train" else None
    jfull = jfs.make_full_solve(_model(cnf, dims, mode), getattr(cnf.Mode, MODE_NAMES[mode]), B)
    jargs = {"ps": _jps(ps_np), "eps": None if eps is None else jnp.asarray(eps), "ys": jnp.asarray(ys)}
    yT_r, st_r = jfull.forward(jnp.asarray(y0f), 0.0, 1.0, jargs)
    tfull = tfs.make_full_solve(_model(tcnf, dims, mode), getattr(tcnf.Mode, MODE_NAMES[mode]), B)
    targs = {"ps": tcnf.params_from_numpy(ps_np), "eps": None if eps is None else torch.from_numpy(eps),
             "ys": torch.from_numpy(ys)}
    before = _launch_counts()
    with torch.no_grad():
        yT, st = tfull.forward(torch.from_numpy(y0f), torch.tensor(0.0), torch.tensor(1.0), targs)
    assert _launch_counts() == before
    assert (int(st.steps), int(st.accepted), int(st.nfe)) == (int(st_r.steps), int(st_r.accepted), int(st_r.nfe))
    np.testing.assert_allclose(yT.numpy(), np.asarray(yT_r), **TOL)


@pytest.mark.parametrize("net,mode", [("two-layer", "test"), ("two-layer", "train"), ("three-layer", "train")],
                         ids=["K5-COND-two-layer", "K2-COND-two-layer", "K2-COND-three-layer"])
def test_wide_cond_adjoint_twins_match_jax_kernel(net, mode):
    """The plain versions of wide K5's COND instance (the TEST backsolve,
    ct_m folded into g) and of the wide K2 chain form's (the Hutchinson
    backsolve), through the fused solve's backward member on CPU tensors,
    against the JAX package's adjoint kernel in interpret mode at one tile,
    from the same final state, cotangent and warm start: equal steps,
    accepted steps and NFE; the states, a_ys0 and the gradients (the ys rows
    of g_W0 among them, which are not zero) at 1e-4.  No kernel is
    launched."""
    dims = NETS[net]
    dz, span = dims[-1], 2.0
    ps_np = _np_params(dims, 4)
    xs, ys = _data(dims, B, 5)
    nacc = 1 if mode == "test" else 3
    eps = np.random.default_rng(6).normal(size=(1, B, dz)).astype(np.float32) if mode == "train" else None
    mode_j, mode_t = getattr(cnf.Mode, MODE_NAMES[mode]), getattr(tcnf.Mode, MODE_NAMES[mode])
    jfull = jfs.make_full_solve(_model(cnf, dims, mode, tspan=(0.0, span)), mode_j, B)
    assert jfull.adjoint is not None
    args = {"ps": _jps(ps_np), "eps": None if eps is None else jnp.asarray(eps), "ys": jnp.asarray(ys)}
    yTf, fst = jfull.forward(jnp.asarray(_y0(dims, xs, nacc)), 0.0, span, args)
    rng = np.random.default_rng(7)
    acc_ct = [np.full(B, 1.0 / B)] + ([np.full(2 * B, 1e-2 / B)] if nacc == 3 else [])
    g_yf = np.concatenate([rng.normal(0.0, 0.1, B * dz)] + acc_ct).astype(np.float32)
    dt_warm = float(fst.dt_last)
    y0_r, ay0_r, gargs_r, st_r = jfull.adjoint(yTf, jnp.asarray(g_yf), args, span, 0.0, dt_warm=dt_warm)
    tfull = tfs.make_full_solve(_model(tcnf, dims, mode, tspan=(0.0, span)), mode_t, B)
    targs = {"ps": tcnf.params_from_numpy(ps_np), "eps": None if eps is None else torch.from_numpy(eps),
             "ys": torch.from_numpy(ys)}
    before = _launch_counts()
    y0, ay0, gargs, st = tfull.adjoint(torch.from_numpy(np.array(yTf)), torch.from_numpy(g_yf), targs,
                                       torch.tensor(span), torch.tensor(0.0), dt_warm=dt_warm)
    assert _launch_counts() == before
    assert (int(st.steps), int(st.accepted), int(st.nfe)) == (int(st_r.steps), int(st_r.accepted), int(st_r.nfe))
    np.testing.assert_allclose(y0.numpy(), np.asarray(y0_r), **TOL)
    np.testing.assert_allclose(ay0.numpy(), np.asarray(ay0_r), **TOL)
    assert gargs["ys"].shape == ys.shape
    np.testing.assert_allclose(gargs["ys"].numpy(), np.asarray(gargs_r["ys"]), **TOL)
    for a, b in zip(_leaves(gargs["ps"]), _leaves(gargs_r["ps"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert float(gargs["ps"][0]["w"][dz:].abs().max()) > 0.0


# (net, mode) -> the forward wrapper the fused solve calls
_FORWARDS = {("two-layer", "test"): "run_wide_cond_test2_solve_kernel",
             ("three-layer", "test"): "run_wide_cond_test_solve_kernel",
             ("two-layer", "train"): "run_wide_cond_train_solve_kernel",
             ("three-layer", "train"): "run_wide_cond_train_solve_kernel"}


@pytest.mark.parametrize("mode", ["test", "train"])
@pytest.mark.parametrize("net", list(NETS))
def test_wide_cond_inference_matches_jax(monkeypatch, net, mode):
    """TEST and TRAIN `inference` with per-sample ys (the JAX probe and
    steering draws handed over) against the JAX package's fused path (its
    kernels in interpret mode), with the same weights, inputs and ys, the
    solve through the forward wrapper the route names: equal steps, or at a
    tie of the last step (one solve reaches t1, the other stops short and
    takes the remainder: one attempted and one accepted step more) the JAX
    package's own unfused path on the same draws taking the port's count;
    values at 1e-4."""
    calls = []
    name = _FORWARDS[(net, mode)]
    wrapper = getattr(tfs, name)
    monkeypatch.setattr(tfs, name, lambda tab, spec, **kw: calls.append(kw) or wrapper(tab, spec, **kw))
    dims = NETS[net]
    mode_name = MODE_NAMES[mode]
    jicnf, ticnf = _model(cnf, dims, mode), _model(tcnf, dims, mode)
    ps_np = _np_params(dims, 8)
    xs, ys = _data(dims, B, 9)
    key = jax.random.PRNGKey(10)
    lp_r, regs_r, st_r = cnf.inference(jicnf, getattr(cnf.Mode, mode_name), jnp.asarray(xs), _jps(ps_np),
                                       ys=jnp.asarray(ys), key=key)
    extra = {}
    if mode != "test":
        eps, r = _jax_draws(jicnf, key, B)
        extra = {"eps": eps, "steer_r": r}
    with torch.no_grad():
        lp, regs, st = tcnf.inference(ticnf, getattr(tcnf.Mode, mode_name), xs, tcnf.params_from_numpy(ps_np),
                                      ys=ys, **extra)
    assert len(calls) == 1
    if int(st.steps) != int(st_r.steps):
        _, _, st_u = cnf.inference(_model(cnf, dims, mode, fused=False), getattr(cnf.Mode, mode_name),
                                   jnp.asarray(xs), _jps(ps_np), ys=jnp.asarray(ys), key=key)
        assert abs(int(st.steps) - int(st_r.steps)) == 1 and abs(int(st.accepted) - int(st_r.accepted)) == 1
        assert int(st_u.steps) == int(st.steps)
    else:
        assert (int(st.accepted), int(st.nfe)) == (int(st_r.accepted), int(st_r.nfe))
    for a, b in ((lp, lp_r), (regs.e, regs_r.e), (regs.n, regs_r.n)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("net,mode", [("two-layer", "test"), ("two-layer", "train"), ("three-layer", "train")])
def test_wide_cond_gradients_match_jax_grad(net, mode):
    """The TEST and Hutchinson losses and their gradients in the params and
    in ys (B, n_cond) through the fused BACKSOLVE against `jax.grad` of the
    JAX package's fused loss: the backward members are the twins of wide
    K5's and the wide K2 chain form's COND instances, a_ys0 summed back to
    ys's shape."""
    dims = NETS[net]
    mode_name = MODE_NAMES[mode]
    jicnf, ticnf = _model(cnf, dims, mode), _model(tcnf, dims, mode)
    assert tfs.make_full_solve(ticnf, getattr(tcnf.Mode, mode_name), B).adjoint is not None
    ps_np = _np_params(dims, 11)
    xs, ys = _data(dims, B, 12)
    key = jax.random.PRNGKey(13)
    jmode = getattr(cnf.Mode, mode_name)
    l_r, (g_r, gy_r) = jax.value_and_grad(
        lambda p, y: cnf.loss(jicnf, jmode, jnp.asarray(xs), p, ys=y, key=key), argnums=(0, 1)
    )(_jps(ps_np), jnp.asarray(ys))
    extra = {}
    if mode != "test":
        eps, r = _jax_draws(jicnf, key, B)
        extra = {"eps": eps, "steer_r": r}
    ps = tcnf.params_from_numpy(ps_np)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    ys_t = torch.from_numpy(ys).requires_grad_()
    before = _launch_counts()
    l = tcnf.loss(ticnf, getattr(tcnf.Mode, mode_name), xs, ps, ys=ys_t, **extra)
    g = torch.autograd.grad(l, leaves + [ys_t])
    assert _launch_counts() == before
    np.testing.assert_allclose(float(l.detach()), float(l_r), **GRAD_TOL)
    for a, b in zip(g, _leaves(g_r) + [gy_r]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


@pytest.mark.parametrize("net", ["two-layer", "cond-hepmass42"])
def test_cond_dist_logpdf_matches_jax(net):
    """`CondICNFDist(icnf, TEST, ps, ys).logpdf` of the conditional 2-layer
    net and of cond_hepmass42 (its data recipe, its own span (0, 13)) against
    the JAX package's, the TEST solve through wide K3's COND twin."""
    dims = TWO if net == "two-layer" else COND_HEPMASS
    extra = {} if net == "two-layer" else {"tspan": (0.0, 13.0)}
    jicnf, ticnf = _model(cnf, dims, "test", **extra), _model(tcnf, dims, "test", **extra)
    ps_np = _np_params(dims, 14)
    if net == "two-layer":
        xs, ys = _data(dims, B, 15)
    else:
        xs, ys = model_data("cond_hepmass42", np.random.default_rng(15), B)
    ref = cnf.CondICNFDist(jicnf, cnf.Mode.TEST, _jps(ps_np), jnp.asarray(ys)).logpdf(jnp.asarray(xs))
    with torch.no_grad():
        got = tcnf.CondICNFDist(ticnf, tcnf.Mode.TEST, tcnf.params_from_numpy(ps_np), torch.from_numpy(ys)).logpdf(xs)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


# name -> (dims, n_cond, probes, jvp, what the refusal names; None: covered)
# Past the wide limits (_STREAMED) the streamed COND instances take one VJP probe,
# and their probe COND instances K probes or JVP (row (d6)).
_STREAMED = {"hidden129", "dz65", "miniboone860", "hidden129-K2", "miniboone860-jvp"}
_COVERAGE = {
    "two-layer": (TWO, 1, 1, False, None),
    "three-layer": (THREE, 2, 1, False, None),
    "cond-hepmass42": (COND_HEPMASS, 1, 1, False, None),
    "dz64-hidden128": ((65, 128, 128, 64), 1, 1, False, None),
    "two-layer-K2": (TWO, 1, 2, False, None),
    "three-layer-jvp": (THREE, 2, 1, True, None),
    "hidden129": ((44, 129, 43), 1, 1, False, None),
    "dz65": ((66, 130, 65), 1, 1, False, None),
    "miniboone860": ((44, 860, 860, 43), 1, 1, False, None),
    "hidden129-K2": ((44, 129, 43), 1, 2, False, None),
    "miniboone860-jvp": ((44, 860, 860, 43), 1, 1, True, None),
}


@pytest.mark.parametrize("name", list(_COVERAGE))
def test_wide_cond_coverage(name):
    """The wide K1 and K2 chain forms' COND instances take conditional chains
    past the narrow widths that the wide forms keep, with one VJP probe and
    (their probe COND instances) with K probes or JVP probes; conditional
    chains past the wide limits run the streamed forms' COND instances with
    one VJP probe and their probe COND instances with K probes or JVP
    (row (d6)); the streamed forms take no chain the wide forms keep."""
    dims, nc, k, jvp, why = _COVERAGE[name]
    spec = _spec(dims, nc)
    assert tfs._wide_chain(spec) and tfs._stream_chain(spec, True) == (name in _STREAMED)
    assert tfs._stream_chain(spec) == (name in _STREAMED)
    msg = tfs._kernel_covers(TSIT5, spec, k, chain=True, jvp=jvp)
    assert msg == why
    if why is not None:
        assert "ROADMAP queue 2" in why


def test_cond_shared_memory_rule_counts_the_ys_rows():
    """The wide forms' shared-memory rule counts a conditional chain's ys
    rows of the first layer and, per tile row of the wide K2 chain form's
    COND instance, its ys values and ys cotangents: a chain that the wide
    forms keep unconditionally can pass the limit once it reads enough ys
    columns, and is then a conditional chain past the wide limits, which
    the streamed COND instances take with one probe and their probe COND
    instances with two."""
    base = (64, 128, 128, 120, 64)
    assert tfs._wide_limit(_spec(base, 0)) is None
    for nc in (1, 8):
        grown = _spec((64 + nc,) + base[1:], nc)
        assert tfs._wide_smem_floats(grown) - tfs._wide_smem_floats(_spec(base, 0)) >= nc * (128 | 1) + 8 * nc
    wide = next(nc for nc in range(1, 64) if tfs._wide_limit(_spec((64 + nc,) + base[1:], nc)) is not None)
    assert "shared memory" in tfs._wide_limit(_spec((64 + wide,) + base[1:], wide))
    assert tfs._kernel_covers(TSIT5, _spec((64 + wide,) + base[1:], wide), chain=True) is None
    assert tfs._stream_chain(_spec((64 + wide,) + base[1:], wide))
    assert tfs._kernel_covers(TSIT5, _spec((64 + wide,) + base[1:], wide), 2, chain=True) is None
    assert tfs._stream_chain(_spec((64 + wide,) + base[1:], wide), True)
    assert tfs._kernel_covers(TSIT5, _spec((64 + wide - 1,) + base[1:], wide - 1), chain=True) is None


def _fake_cuda():
    """A stand-in for a CUDA tensor: the coverage checks read its device."""
    return types.SimpleNamespace(device=torch.device("cuda", 0))


# name -> (check, dims, n_cond, keyword arguments, the row or reason the refusal names)
_REFUSED = {
    "probe-instance-shared-memory": ("chain", (65, 128, 128, 120, 64), 1, dict(wide=True, cond=True, k_probes=2),
                                     "their streamed forms take the chain"),
    "streamed-chain": ("chain", (44, 860, 860, 43), 1, dict(wide=True, cond=True),
                       "their streamed forms take the chain"),
    "streamed-two-layer": ("two", (87, 258, 86), 1, dict(cond=True), "state width 86 > 64"),
    "wide-K4-adjoint-hidden130": ("two", (44, 130, 43), 1, dict(cond=True), "hidden width 130 > 128"),
    "unconditional-instance": ("chain", TWO, 1, dict(wide=True), "unconditional instance"),
    "unconditional-K3": ("two", TWO, 1, {}, "unconditional instance"),
    "unconditional-K7": ("chain", THREE, 2, dict(wide=True), "unconditional instance"),
    "cond-instance-unconditional": ("two", (34, 72, 34), 0, dict(cond=True), "COND instance"),
}


@pytest.mark.parametrize("name", list(_REFUSED))
def test_cond_refusals_on_the_card_name_their_row(name):
    """What the wide instances refuse of conditional nets past the narrow
    widths raises NotImplementedError through the wrappers' checks, naming
    its reason or ROADMAP queue 2 row (stable names): with two probes, a
    chain the one-probe COND instance keeps whose probe COND instance's
    shared memory it passes (the streamed probe COND instances take it, row
    (d6): tests/test_torch_stream_cond_probes.py); past the wide limits the
    wide chain forms and the wide 2-layer kernels, the wide K4 adjoint among
    them, name the limit (the streamed COND instances take those nets:
    tests/test_torch_stream_cond.py); and no unconditional instance takes a
    conditional net, nor a COND instance an unconditional one."""
    check, dims, nc, kw, why = _REFUSED[name]
    spec = _spec(dims, nc)
    with pytest.raises(NotImplementedError) as err:
        if check == "chain":
            k = kw.pop("k_probes", 1)
            tfs._cuda_only("wide K1", _fake_cuda(), TSIT5, spec, k, chain=True, **kw)
        else:
            tfs._cuda_only_wide_two_layer("wide K3", _fake_cuda(), TSIT5, spec, **kw)
    assert why in str(err.value)
    if why.startswith("conditional chains past"):
        assert "ROADMAP queue 2" in str(err.value)


# name -> (check, label, dims, n_cond, probes, JVP?); None: the chain forms' and wide K3's
_ACCEPTED = {
    "chain-forms-and-K3": None,
    "wide-K7-TEST-three-layer": ("chain", "wide K7", THREE, 2, 1, False),
    "wide-K7-exact-two-layer": ("chain", "wide K7", TWO, 1, 1, False),
    "wide-K7-exact-cond-hepmass42": ("chain", "wide K7", COND_HEPMASS, 1, 1, False),
    "wide-K4-adjoint": ("two", "the wide K4 adjoint", TWO, 1, 1, False),
    "wide-K4-adjoint-cond-hepmass42": ("two", "the wide K4 adjoint", COND_HEPMASS, 1, 1, False),
    "wide-probes-K4": ("chain", "wide K1", TWO, 1, 4, False),
    "wide-probes-jvp": ("chain", "wide K2", THREE, 2, 1, True),
}


@pytest.mark.parametrize("name", list(_ACCEPTED))
def test_cond_instances_accept_what_they_cover(name):
    """The same checks pass the configurations the COND instances take:
    cond_hepmass42 and the conditional 2-layer net in the chain forms', wide
    K3's, wide K7's and the wide K4 adjoint's, the 3-layer chain in the
    chain forms' and wide K7's; K probes and JVP probes in the chain forms'
    probe COND instances (K6 x K8)."""
    if _ACCEPTED[name] is None:
        for dims, nc in ((COND_HEPMASS, 1), (TWO, 1)):
            spec = _spec(dims, nc)
            tfs._cuda_only("wide K1", _fake_cuda(), TSIT5, spec, chain=True, wide=True, cond=True)
            tfs._cuda_only_wide_two_layer("wide K3", _fake_cuda(), TSIT5, spec, cond=True)
        tfs._cuda_only("wide K2", _fake_cuda(), TSIT5, _spec(THREE, 2), chain=True, wide=True, cond=True)
        return
    check, label, dims, nc, k, jvp = _ACCEPTED[name]
    spec = _spec(dims, nc)
    if check == "chain":
        tfs._cuda_only(label, _fake_cuda(), TSIT5, spec, k, chain=True, wide=True, jvp=jvp, cond=True)
    else:
        tfs._cuda_only_wide_two_layer(label, _fake_cuda(), TSIT5, spec, cond=True)


# route -> (dims, mode, probes, JVP?, the wrappers the loss and its gradient call, in order)
_ROUTES = {
    "two-layer-test": (TWO, "test", 1, False, ["run_wide_cond_test2_solve_kernel",
                                                "run_wide_cond_test_adjoint_kernel"]),
    "two-layer-train": (TWO, "train", 1, False, ["run_wide_cond_train_solve_kernel", "run_wide_cond_adjoint_kernel"]),
    "two-layer-exact": (TWO, "exact", 1, False, ["run_wide_cond_exact_solve_kernel",
                                                  "run_wide_cond_exact_adjoint_kernel"]),
    "two-layer-train-K2": (TWO, "train", 2, False, ["run_wide_cond_train_solve_kernel",
                                                    "run_wide_cond_adjoint_kernel"]),
    "two-layer-train-K4": (TWO, "train", 4, False, ["run_wide_cond_train_solve_kernel",
                                                    "run_wide_cond_adjoint_kernel"]),
    "two-layer-train-jvp2": (TWO, "train", 2, True, ["run_wide_cond_train_solve_kernel",
                                                     "run_wide_cond_adjoint_kernel"]),
    "three-layer-test": (THREE, "test", 1, False, ["run_wide_cond_test_solve_kernel"]),
    "three-layer-exact": (THREE, "exact", 1, False, ["run_wide_cond_exact_solve_kernel"]),
    "three-layer-train": (THREE, "train", 1, False, ["run_wide_cond_train_solve_kernel",
                                                     "run_wide_cond_adjoint_kernel"]),
    "three-layer-train-jvp": (THREE, "train", 1, True, ["run_wide_cond_train_solve_kernel",
                                                        "run_wide_cond_adjoint_kernel"]),
    "narrow-two-layer-test": ((17, 48, 16), "test", 1, False, ["run_cond_solve_kernel",
                                                                "run_test_adjoint_kernel"]),
    "narrow-recipe-train": ((2, 64, 64, 1), "train", 1, False, ["run_chain_train_solve_kernel",
                                                                 "run_chain_adjoint_kernel"]),
}


@pytest.mark.parametrize("route", list(_ROUTES))
def test_fused_solve_takes_the_cond_instances(monkeypatch, route):
    """`make_full_solve` runs a conditional net past the narrow widths
    through the COND instances: a 2-layer tanh net through wide K3's and
    wide K5's (TEST) and the wide K1 and K2 chain forms' (Hutchinson, any
    probes: K probes and JVP run their probe COND instances), a 3-layer chain
    through the chain forms' (Hutchinson) and wide K7 TEST's and exact's
    (the TEST forward; the exact forward, whose gradient runs the plain
    BACKSOLVE); exact training of a 2-layer net through wide K7 exact's and
    the wide K4 adjoint's.  Narrow conditional nets are not rerouted to the
    wide forms: a 2-layer one runs K3's and K5's COND instances in TEST mode,
    the narrow recipe chain the narrow chain forms.  No other wrapper is
    called, none of the unconditional wide ones among them."""
    dims, mode, k, jvp, want = _ROUTES[route]
    called = []
    names = {n for v in _ROUTES.values() for n in v[4]} | {
        "run_wide_train_solve_kernel", "run_wide_adjoint_kernel", "run_wide_test2_solve_kernel",
        "run_wide_test_adjoint_kernel", "run_stream_train_solve_kernel", "run_stream_adjoint_kernel",
        "run_stream_test_solve_kernel", "run_chain_exact_solve_kernel", "run_wide_test_solve_kernel",
        "run_wide_exact_solve_kernel", "run_wide_exact_adjoint_kernel", "run_stream_exact_solve_kernel",
        "run_stream_exact_adjoint_kernel"}
    for name in names:
        wrapped = getattr(tfs, name)

        def spy(*a, _n=name, _f=wrapped, **kw):
            called.append((_n, kw.get("ys") is not None, tuple(kw["eps"].shape) if kw.get("eps") is not None else None))
            return _f(*a, **kw)

        monkeypatch.setattr(tfs, name, spy)
    icnf = _model(tcnf, dims, mode, compute_mode=_cm(tcnf, mode, True, k, "jvp" if jvp else "vjp"))
    ps = tcnf.params_from_numpy(_np_params(dims, 21))
    xs, ys = _data(dims, 8, 22)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    extra = {"eps": np.random.default_rng(23).normal(size=(k, 8, dims[-1])).astype(np.float32)} if mode == "train" else {}
    torch.autograd.grad(tcnf.loss(icnf, getattr(tcnf.Mode, MODE_NAMES[mode]), xs, ps, ys=ys, **extra), leaves)
    assert [c[0] for c in called] == want
    assert all(c[1] for c in called)
    if mode == "train":
        assert [c[2] for c in called] == [(k, 8, dims[-1])] * 2


def test_wide_cond_wrappers_run_the_twins_on_the_cpu_without_counting():
    """On CPU tensors the seven COND wrappers run their twins, bit for bit
    (a_ys0 last from the three adjoints), and count no launch; they are in
    KERNEL_WRAPPERS, so `reset_launches` covers them."""
    assert {getattr(tfs, n) for n in COND_WRAPPERS} <= set(tfs.KERNEL_WRAPPERS.values())
    dims = TWO
    spec = tfs.chain_spec(tcnf.MLP(dims), 34)
    ps = tcnf.params_from_numpy(_np_params(dims, 24))
    rng = np.random.default_rng(25)
    T = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    ys = T(rng.uniform(-1.0, 1.0, (8, 1)))
    base = dict(rtol=1e-3, atol=1e-6, max_steps=100, ws=[p["w"] for p in ps], bs=[p["b"] for p in ps], ys=ys)
    tfs.reset_launches()
    fwd_kw = dict(base, z0=T(rng.normal(size=(8, 34))), t0=torch.tensor(0.0), t1=torch.tensor(1.0),
                  dt_init=torch.tensor(0.05))
    kw = dict(fwd_kw, dlogp0=T(rng.normal(size=8)))
    got = tfs.run_wide_cond_test2_solve_kernel(TSIT5, spec, **kw)
    fwd = tfs.solve_test_plain(TSIT5, spec, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, fwd))
    assert all(torch.equal(a, b) for a, b in zip(tfs.run_wide_cond_test_solve_kernel(TSIT5, spec, **kw), fwd))
    exact = dict(fwd_kw, norm_z=True, norm_j=True, acc0=T(rng.normal(size=(3, 8))))
    fwd_e = tfs.solve_train_exact_plain(TSIT5, spec, **exact)
    assert all(torch.equal(a, b) for a, b in zip(tfs.run_wide_cond_exact_solve_kernel(TSIT5, spec, **exact), fwd_e))
    train = dict(fwd_kw, norm_z=True, norm_j=True, eps=T(rng.normal(size=(1, 8, 34))), acc0=T(rng.normal(size=(3, 8))))
    got = tfs.run_wide_cond_train_solve_kernel(TSIT5, spec, **train)
    fwd_t = tfs.solve_train_plain(TSIT5, spec, **train)
    assert all(torch.equal(a, b) for a, b in zip(got, fwd_t))
    adj = dict(base, azT=T(rng.normal(size=(8, 34))), t_hi=torch.tensor(1.0), t_lo=torch.tensor(0.0),
               dt_init=torch.tensor(-0.05))
    for wrapper, twin, extra in ((tfs.run_wide_cond_test_adjoint_kernel, tfs.adjoint_test_plain,
                                  dict(zT=fwd[0], accT=fwd[1][None], aaccT=T(rng.normal(size=(1, 8))))),
                                 (tfs.run_wide_cond_adjoint_kernel, tfs.adjoint_train_plain,
                                  dict(norm_z=True, norm_j=True, eps=train["eps"], zT=fwd_t[0], accT=fwd_t[1],
                                       aaccT=T(rng.normal(size=(3, 8))))),
                                 (tfs.run_wide_cond_exact_adjoint_kernel, tfs.adjoint_train_exact_plain,
                                  dict(norm_z=True, norm_j=True, zT=fwd_e[0], accT=fwd_e[1],
                                       aaccT=T(rng.normal(size=(3, 8)))))):
        got, ref = wrapper(TSIT5, spec, **dict(adj, **extra)), twin(TSIT5, spec, **dict(adj, **extra))
        assert len(got) == len(ref) == 8
        assert all(torch.equal(a, b) for a, b in zip(got[:3] + got[5:], ref[:3] + ref[5:]))
        assert all(torch.equal(a, b) for a, b in zip(got[3] + got[4], ref[3] + ref[4]))
    assert all(w.launches == 0 for w in tfs.KERNEL_WRAPPERS.values())


def test_cond_hepmass42_fit_on_cpu():
    """`fit(CondICNFModel(...), X, Y)` on the fused cond_hepmass42 model for
    two Lion steps at B = 16: finite losses, moving parameters, and no
    kernel launched on the CPU."""
    ps_np = _np_params(COND_HEPMASS, 17)
    X, Y = model_data("cond_hepmass42", np.random.default_rng(18), 2 * B)
    before = _launch_counts()
    icnf = _model(tcnf, COND_HEPMASS, "train", tspan=(0.0, 13.0))
    model = tcnf.CondICNFModel(icnf, n_epochs=1, batch_size=B)
    res = tcnf.fit(model, X, Y, ps=tcnf.params_from_numpy(ps_np), seed=0)
    assert _launch_counts() == before
    assert res.epochs == 1 and np.isfinite(res.losses).all()
    moved = [float((a - torch.from_numpy(b)).abs().max()) for a, b in zip(_leaves(res.ps), _leaves(ps_np))]
    assert min(moved) > 0.0
