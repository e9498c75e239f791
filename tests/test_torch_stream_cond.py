"""Conditional nets past the wide limits in the port against the JAX package
on the CPU (K8 in the streamed forms): a conditional 2-layer net
`MLP((67, 80, 66))` on [z | ys] with one ys column, past state width 64,
whose TEST stages run streamed K3's and streamed K5's COND instances on the
card and its Hutchinson ones the streamed K1 and K2 chain forms' COND
instances, and a conditional 3-layer chain `MLP((10, 136, 136, 8))` with
two ys columns, past hidden width 128, which trains through the same
chain-form instances; and cond_miniboone86 (CondRNODE at the MINIBOONE
width, `MLP((87, 258, 86))`) as a whole slice.  The COND twins through the
fused solve on CPU tensors against the JAX package's kernels in interpret
mode at one tile (the TEST and TRAIN forwards, the TEST and Hutchinson
adjoints with a_ys0); TEST and TRAIN `inference`; the losses and their
gradients in the params and in ys against `jax.grad`;
`CondICNFDist.logpdf`; the coverage rule, the wrappers `make_full_solve`
picks (with K probes or JVP too: the probe COND instances, row (d6),
tests/test_torch_stream_cond_probes.py), what the instances refuse, by
name; the wrappers' CPU branch; the cond_miniboone86 configuration and
`fit`.

Inputs come from numpy seeds at B = 16 (cond_miniboone86: 8), where the
JAX package runs one tile; the JAX probe and steering draws are reproduced
from its key split (`core/icnf.py:485`) and handed to the port.  The JAX
package's fused solves are shared between the tests through module-scoped
fixtures.  Tolerances as in tests/test_torch_wide_cond.py: values at
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
from continuousnf_tpu_torch.utils import near_tie
from continuousnf_tpu_torch.utils.configs import MINIBOONE_EVENTS, MODELS, glorot_params, model_data

# The port's entry points default to the CUDA card; these tests run it on the CPU.
tcnf.set_default_device("cpu")

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
TWO, THREE = (67, 80, 66), (10, 136, 136, 8)
COND_MB86 = MODELS["cond_miniboone86"]["dims"]
# dims -> (nvars, naug, n_cond)
SPLIT = {TWO: (33, 33, 1), THREE: (4, 4, 2), COND_MB86: (43, 43, 1)}
NETS = {"two-layer": TWO, "three-layer": THREE}
B = 16
MODE_NAMES = {"train": "TRAIN", "test": "TEST", "exact": "TRAIN"}


def _cm(m, mode, fused=True, k=1, ad="vjp"):
    return (m.JacVecMode if ad == "jvp" else m.VecJacMode)(k, fused=fused, exact_trace=mode == "exact")


def _model(m, dims, mode="train", fused=True, **kw):
    """CondRNODE on [z | ys] with miniboone86's recipe (steer_rate 0.1,
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


def _jax_draws(icnf, key, batch):
    """The probes and the steering r JAX `inference` draws from `key`."""
    eps_key, steer_key = jax.random.split(key)
    r = float(jax.random.uniform(steer_key, (), jnp.float32, -icnf.steer_rate, icnf.steer_rate))
    return np.array(icnf.draw_eps(eps_key, batch)), r


def _y0(dims, xs, nacc):
    z0 = np.concatenate([xs, np.zeros((xs.shape[0], dims[-1] - xs.shape[1]), np.float32)], axis=1)
    return np.concatenate([z0.ravel(), np.zeros(nacc * xs.shape[0], np.float32)])


def _spec(dims, n_cond):
    return tfs.ChainSpec((dims[0],) + tuple(dims[1:-1]), tuple(dims[1:]), (True,) * (len(dims) - 1), n_cond)


def test_cond_miniboone86_configuration():
    """CondRNODE at the MINIBOONE width: 43 variables, 43 augmented
    dimensions, one conditioning column, MLP 87 -> 258 -> 86 on [z | ys],
    miniboone86's recipe; ys the standardised MiniBooNE label (signal share
    36,499 / 130,064), xs the tabular recipe shifted by 0.5 ys.  The
    streamed forms' COND instances take it, the streamed K4 adjoint's
    included; the wide forms do not."""
    cfg, twin = MODELS["cond_miniboone86"], MODELS["miniboone86"]
    assert (cfg["dims"], cfg["nvars"], cfg["naug"], cfg["n_cond"]) == ((87, 258, 86), 43, 43, 1)
    assert (cfg["tspan"], cfg["extra"]) == (twin["tspan"], twin["extra"]) and "batch" not in cfg
    xs, ys = model_data("cond_miniboone86", np.random.default_rng(0), 4096)
    assert xs.shape == (4096, 43) and ys.shape == (4096, 1) and xs.dtype == ys.dtype == np.float32
    share = MINIBOONE_EVENTS[0] / sum(MINIBOONE_EVENTS)
    sd = np.sqrt(share * (1.0 - share))
    np.testing.assert_allclose(np.unique(ys), [-share / sd, (1.0 - share) / sd], rtol=1e-6)
    np.testing.assert_allclose(np.unique(ys), [-0.6245738, 1.6010918], rtol=1e-6)
    assert abs(float((ys > 0).mean()) - share) < 0.03 and np.isfinite(xs).all()
    icnf = tcnf.construct(tcnf.CondRNODE, tcnf.MLP(cfg["dims"]), 43, 43)
    spec = tfs.chain_spec(icnf.nn, icnf.zdim)
    assert spec.n_cond == 1 and tfs._wide_two_layer(spec) and tfs._stream_chain(spec)
    assert tfs._stream_two_layer(spec) and tfs._stream_two_layer_covers(TSIT5, spec) is None
    assert tfs._kernel_covers(TSIT5, spec, chain=True) is None
    assert "state width 86 > 64" in tfs._wide_two_layer_covers(TSIT5, spec)
    assert tfs._stream_exact_covers(TSIT5, spec) is None


# ---- the twins against the JAX package's kernels (interpret mode) ----


@pytest.fixture(scope="module")
def jax_solves():
    """The JAX package's fused forward and backward solves per (net, mode),
    computed once: the forward from zero accumulators over (0, 2), then its
    adjoint from the forward's final state with a loss-like cotangent and
    the forward's last step as warm start."""
    cache = {}

    def get(net, mode):
        if (net, mode) in cache:
            return cache[(net, mode)]
        dims = NETS[net]
        dz, span = dims[-1], 2.0
        ps_np = _np_params(dims, 4)
        xs, ys = _data(dims, B, 5)
        nacc = 1 if mode == "test" else 3
        eps = np.random.default_rng(6).normal(size=(1, B, dz)).astype(np.float32) if mode == "train" else None
        y0f = _y0(dims, xs, nacc)
        jfull = jfs.make_full_solve(_model(cnf, dims, mode, tspan=(0.0, span)), getattr(cnf.Mode, MODE_NAMES[mode]),
                                    B)
        args = {"ps": _jps(ps_np), "eps": None if eps is None else jnp.asarray(eps), "ys": jnp.asarray(ys)}
        yTf, fst = jfull.forward(jnp.asarray(y0f), 0.0, span, args)
        rng = np.random.default_rng(7)
        acc_ct = [np.full(B, 1.0 / B)] + ([np.full(2 * B, 1e-2 / B)] if nacc == 3 else [])
        g_yf = np.concatenate([rng.normal(0.0, 0.1, B * dz)] + acc_ct).astype(np.float32)
        dt_warm = float(fst.dt_last)
        bwd = jfull.adjoint(yTf, jnp.asarray(g_yf), args, span, 0.0, dt_warm=dt_warm)
        cache[(net, mode)] = types.SimpleNamespace(
            dims=dims, span=span, ps_np=ps_np, ys=ys, eps=eps, y0f=y0f, yTf=np.array(yTf), fst=fst, g_yf=g_yf,
            dt_warm=dt_warm, bwd=bwd)
        return cache[(net, mode)]

    return get


def _targs(ref):
    return {"ps": tcnf.params_from_numpy(ref.ps_np), "eps": None if ref.eps is None else torch.from_numpy(ref.eps),
            "ys": torch.from_numpy(ref.ys)}


_TWIN_CASES = [("two-layer", "test"), ("two-layer", "train"), ("three-layer", "train")]
# mode -> (the forward wrapper the fused solve calls, its twin)
_FORWARD_TWINS = {"test": ("run_stream_cond_test2_solve_kernel", "solve_test_plain"),
                  "train": ("run_stream_cond_train_solve_kernel", "solve_train_plain")}


def _hold_steps(st, st_r, unfused_steps, witness_steps):
    """Equal attempted and accepted steps and NFE or, where the two part by
    one attempted and one accepted step, the JAX package's own unfused path
    on the same inputs taking the port's count (`unfused_steps()`: the JAX
    kernel sums in another order than the plain path) or the port's twin
    taking the JAX kernel's count under one-ulp moves of its inputs
    (`witness_steps()`, `near_tie.witness`), as
    tests/test_torch_wide_cond_probes.py holds its forwards."""
    if int(st.steps) != int(st_r.steps):
        assert abs(int(st.steps) - int(st_r.steps)) == 1 and abs(int(st.accepted) - int(st_r.accepted)) == 1
        assert unfused_steps() == int(st.steps) or int(st_r.steps) in witness_steps()
    else:
        assert (int(st.accepted), int(st.nfe)) == (int(st_r.accepted), int(st_r.nfe))


@pytest.mark.parametrize("net,mode", _TWIN_CASES)
def test_stream_cond_forward_twins_match_jax_kernel(monkeypatch, jax_solves, net, mode):
    """The plain versions of streamed K3's COND instance (test: the
    closed-form TEST stage on [z | ys]) and of the streamed K1 chain form's
    (train), through the fused solve on CPU tensors, against the JAX
    package's forward kernel with ys rows in interpret mode from zero
    accumulators: equal attempted and accepted steps and NFE, or a
    one-step parting that the JAX package's unfused path or the twin's own
    roundoff takes (`_hold_steps`); values at 1e-4.  No kernel is
    launched."""
    ref = jax_solves(net, mode)
    calls = []
    name, twin = _FORWARD_TWINS[mode]
    wrapped = getattr(tfs, name)
    monkeypatch.setattr(tfs, name, lambda tab, spec, **kw: calls.append((tab, spec, kw)) or wrapped(tab, spec, **kw))
    tfull = tfs.make_full_solve(_model(tcnf, ref.dims, mode, tspan=(0.0, ref.span)),
                                getattr(tcnf.Mode, MODE_NAMES[mode]), B)
    before = _launch_counts()
    with torch.no_grad():
        yT, st = tfull.forward(torch.from_numpy(ref.y0f), torch.tensor(0.0), torch.tensor(ref.span), _targs(ref))
    assert _launch_counts() == before and len(calls) == 1

    def unfused_steps():
        icnf = _model(cnf, ref.dims, mode, fused=False, steer_rate=0.0, tspan=(0.0, ref.span))
        xs = ref.y0f[: B * ref.dims[-1]].reshape(B, -1)[:, : SPLIT[ref.dims][0]]
        extra = {} if ref.eps is None else {"eps": jnp.asarray(ref.eps)}
        _, _, st_u = cnf.inference(icnf, getattr(cnf.Mode, MODE_NAMES[mode]), jnp.asarray(xs), _jps(ref.ps_np),
                                   ys=jnp.asarray(ref.ys), key=jax.random.PRNGKey(0), **extra)
        return int(st_u.steps)

    def witness_steps():
        tab, spec, kw = calls[0]
        return near_tie.witness(getattr(tfs, twin), tab, spec, kw, "z0", n=8)[0]

    _hold_steps(st, ref.fst, unfused_steps, witness_steps)
    np.testing.assert_allclose(yT.numpy(), ref.yTf, **TOL)


@pytest.mark.parametrize("net,mode", _TWIN_CASES,
                         ids=["K5-COND-two-layer", "K2-COND-two-layer", "K2-COND-three-layer"])
def test_stream_cond_adjoint_twins_match_jax_kernel(jax_solves, net, mode):
    """The plain versions of streamed K5's COND instance (the TEST
    backsolve, ct_m folded into g over W1's z rows) and of the streamed K2
    chain form's (the Hutchinson backsolve), through the fused solve's
    backward member on CPU tensors, against the JAX package's adjoint kernel
    in interpret mode at one tile, from the same final state, cotangent and
    warm start: equal steps, accepted steps and NFE; the states, a_ys0 and
    the gradients (the ys rows of g_W0 among them, which are not zero) at
    1e-4.  No kernel is launched."""
    ref = jax_solves(net, mode)
    dz = ref.dims[-1]
    y0_r, ay0_r, gargs_r, st_r = ref.bwd
    tfull = tfs.make_full_solve(_model(tcnf, ref.dims, mode, tspan=(0.0, ref.span)),
                                getattr(tcnf.Mode, MODE_NAMES[mode]), B)
    assert tfull.adjoint is not None
    before = _launch_counts()
    y0, ay0, gargs, st = tfull.adjoint(torch.from_numpy(ref.yTf), torch.from_numpy(ref.g_yf), _targs(ref),
                                       torch.tensor(ref.span), torch.tensor(0.0), dt_warm=ref.dt_warm)
    assert _launch_counts() == before
    assert (int(st.steps), int(st.accepted), int(st.nfe)) == (int(st_r.steps), int(st_r.accepted), int(st_r.nfe))
    np.testing.assert_allclose(y0.numpy(), np.asarray(y0_r), **TOL)
    np.testing.assert_allclose(ay0.numpy(), np.asarray(ay0_r), **TOL)
    assert gargs["ys"].shape == ref.ys.shape
    np.testing.assert_allclose(gargs["ys"].numpy(), np.asarray(gargs_r["ys"]), **TOL)
    for a, b in zip(_leaves(gargs["ps"]), _leaves(gargs_r["ps"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert float(gargs["ps"][0]["w"][dz:].abs().max()) > 0.0


# (net, mode) -> the forward wrapper the fused solve calls
_FORWARDS = {("two-layer", "test"): "run_stream_cond_test2_solve_kernel",
             ("three-layer", "test"): "run_stream_cond_test_solve_kernel",
             ("two-layer", "train"): "run_stream_cond_train_solve_kernel",
             ("three-layer", "train"): "run_stream_cond_train_solve_kernel"}


@pytest.mark.parametrize("mode", ["test", "train"])
@pytest.mark.parametrize("net", list(NETS))
def test_stream_cond_inference_matches_jax(monkeypatch, net, mode):
    """TEST and TRAIN `inference` with per-sample ys (the JAX probe and
    steering draws handed over) against the JAX package's fused path (its
    kernels in interpret mode), with the same weights, inputs and ys, the
    solve through the forward wrapper the route names (the 3-layer chain's
    TEST forward: streamed K7 TEST's COND instance's twin):
    equal steps, or at a tie of the last step (one solve reaches t1, the
    other stops short and takes the remainder) the JAX package's own
    unfused path on the same draws taking the port's count; values at
    1e-4."""
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
    assert len(calls) == 1 and calls[0]["ys"] is not None
    if int(st.steps) != int(st_r.steps):
        _, _, st_u = cnf.inference(_model(cnf, dims, mode, fused=False), getattr(cnf.Mode, mode_name),
                                   jnp.asarray(xs), _jps(ps_np), ys=jnp.asarray(ys), key=key)
        assert abs(int(st.steps) - int(st_r.steps)) == 1 and abs(int(st.accepted) - int(st_r.accepted)) == 1
        assert int(st_u.steps) == int(st.steps)
    else:
        assert (int(st.accepted), int(st.nfe)) == (int(st_r.accepted), int(st_r.nfe))
    for a, b in ((lp, lp_r), (regs.e, regs_r.e), (regs.n, regs_r.n)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def _grad_case(dims, mode, batch, seeds, **model_kw):
    """The loss and its gradient in the params and ys through the port's
    fused path (the JAX draws handed over; no kernel launched on the CPU)
    and through `jax.grad` of the JAX package's fused loss."""
    mode_name = MODE_NAMES[mode]
    jicnf, ticnf = _model(cnf, dims, mode, **model_kw), _model(tcnf, dims, mode, **model_kw)
    assert tfs.make_full_solve(ticnf, getattr(tcnf.Mode, mode_name), batch).adjoint is not None
    ps_np = _np_params(dims, seeds[0])
    if dims == COND_MB86:
        xs, ys = model_data("cond_miniboone86", np.random.default_rng(seeds[1]), batch)
    else:
        xs, ys = _data(dims, batch, seeds[1])
    key = jax.random.PRNGKey(seeds[2])
    jmode = getattr(cnf.Mode, mode_name)
    l_r, (g_r, gy_r) = jax.value_and_grad(
        lambda p, y: cnf.loss(jicnf, jmode, jnp.asarray(xs), p, ys=y, key=key), argnums=(0, 1)
    )(_jps(ps_np), jnp.asarray(ys))
    extra = {}
    if mode != "test":
        eps, r = _jax_draws(jicnf, key, batch)
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


@pytest.mark.parametrize("net,mode", _TWIN_CASES)
def test_stream_cond_gradients_match_jax_grad(net, mode):
    """The TEST and Hutchinson losses and their gradients in the params and
    in ys (B, n_cond) through the fused BACKSOLVE against `jax.grad` of the
    JAX package's fused loss: the backward members are the twins of streamed
    K5's and the streamed K2 chain form's COND instances, a_ys0 summed back
    to ys's shape."""
    _grad_case(NETS[net], mode, B, (11, 12, 13))


@pytest.mark.parametrize("mode", ["test", "train"])
def test_cond_miniboone86_gradients_match_jax_grad(mode):
    """The whole slice at cond_miniboone86's full width (MLP 87 -> 258 -> 86
    on [z | ys], its data recipe) at B = 8 over tspan (0, 1), as
    tests/test_torch_stream_two_layer.py holds miniboone86's gradients: the
    TEST loss gradient (streamed K3 and K5 COND twins) and the Hutchinson
    loss gradient (the streamed K1 and K2 chain forms' COND twins) in the
    params and ys against `jax.grad` of the JAX package's fused loss."""
    _grad_case(COND_MB86, mode, 8, (31, 32, 33))


@pytest.mark.parametrize("net", ["two-layer", "cond-miniboone86"])
def test_cond_dist_logpdf_matches_jax(net):
    """`CondICNFDist(icnf, TEST, ps, ys).logpdf` of the conditional 2-layer
    net and of cond_miniboone86 (its data recipe, its own span (0, 13), at
    B = 8) against the JAX package's, the TEST solve through streamed K3's
    COND twin."""
    dims = TWO if net == "two-layer" else COND_MB86
    extra = {} if net == "two-layer" else {"tspan": (0.0, 13.0)}
    jicnf, ticnf = _model(cnf, dims, "test", **extra), _model(tcnf, dims, "test", **extra)
    ps_np = _np_params(dims, 14)
    if net == "two-layer":
        xs, ys = _data(dims, B, 15)
    else:
        xs, ys = model_data("cond_miniboone86", np.random.default_rng(15), 8)
    ref = cnf.CondICNFDist(jicnf, cnf.Mode.TEST, _jps(ps_np), jnp.asarray(ys)).logpdf(jnp.asarray(xs))
    with torch.no_grad():
        got = tcnf.CondICNFDist(ticnf, tcnf.Mode.TEST, tcnf.params_from_numpy(ps_np), torch.from_numpy(ys)).logpdf(xs)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


# ---- coverage, routing, refusals ----


# name -> (dims, n_cond, probes, jvp, the refusal (None: the streamed COND instances take it))
_COVERAGE = {
    "two-layer": (TWO, 1, 1, False, None),
    "three-layer": (THREE, 2, 1, False, None),
    "cond-miniboone86": (COND_MB86, 1, 1, False, None),
    "cond-miniboone860": ((44, 860, 860, 43), 1, 1, False, None),
    "hidden129": ((44, 129, 43), 1, 1, False, None),
    "cond-bsds126": ((127, 378, 126), 1, 1, False, None),
    "two-layer-K2": (TWO, 1, 2, False, None),
    "three-layer-jvp": (THREE, 2, 1, True, None),
    "cond-miniboone86-K4": (COND_MB86, 1, 4, False, None),
    "dz129": ((130, 387, 129), 1, 1, False, "state width 129 > 128"),
    "five-layer": ((44, 860, 860, 860, 860, 43), 1, 1, False, "5-layer chains"),
}


@pytest.mark.parametrize("name", list(_COVERAGE))
def test_stream_cond_coverage(name):
    """The streamed K1 and K2 chain forms' COND instances take conditional
    chains past the wide limits (state width past 64, hidden width past 128
    or the wide forms' shared memory) with one VJP probe, and their probe
    COND instances with K probes or JVP (row (d6)), up to state width 128
    and 4 layers; the wide forms alone refuse them; past state width 128 or
    4 layers they are refused as before."""
    dims, nc, k, jvp, why = _COVERAGE[name]
    spec = _spec(dims, nc)
    msg = tfs._kernel_covers(TSIT5, spec, k, chain=True, jvp=jvp)
    if why is None:
        assert msg is None and tfs._stream_chain(spec) and tfs._stream_chain(spec, k != 1 or jvp)
        assert tfs._kernel_covers(TSIT5, spec, k, chain=True, jvp=jvp, stream=False) is not None
        return
    assert msg is not None and why in msg and "ROADMAP queue 2" in msg
    assert not tfs._stream_chain(spec, k != 1 or jvp)


def test_cond_stream_shared_memory_rule():
    """A conditional chain that the wide COND instances keep with one probe
    stays there; enough ys columns take it past the wide forms' shared
    memory, and the streamed COND instances take it with one probe, their
    probe COND instances with two (d6)."""
    base = (64, 128, 128, 120, 64)
    wide = next(nc for nc in range(1, 64) if tfs._wide_limit(_spec((64 + nc,) + base[1:], nc)) is not None)
    kept, past = _spec((64 + wide - 1,) + base[1:], wide - 1), _spec((64 + wide,) + base[1:], wide)
    assert tfs._kernel_covers(TSIT5, kept, chain=True) is None and not tfs._stream_chain(kept)
    assert tfs._kernel_covers(TSIT5, past, chain=True) is None and tfs._stream_chain(past)
    assert tfs._kernel_covers(TSIT5, past, 2, chain=True) is None and tfs._stream_chain(past, True)


def _fake_cuda():
    """A stand-in for a CUDA tensor: the coverage checks read its device."""
    return types.SimpleNamespace(device=torch.device("cuda", 0))


# name -> (check, dims, n_cond, keyword arguments, the row or reason the refusal names)
_REFUSED = {
    "K7-TEST-three-layer": ("chain", THREE, 2, dict(stream=True), "unconditional instance"),
    "K7-exact-cond-miniboone86": ("chain", COND_MB86, 1, dict(stream=True), "unconditional instance"),
    "K4-adjoint-cond-miniboone86": ("exact", COND_MB86, 1, {}, "unconditional instance"),
    "K4-adjoint-hidden130": ("exact", (44, 130, 43), 1, {}, "unconditional instance"),
    "probes-K4": ("chain", COND_MB86, 1, dict(stream=True, k_probes=4), "unconditional instance"),
    "probes-jvp": ("chain", THREE, 2, dict(stream=True, jvp=True), "unconditional instance"),
    "probes-wide-cond-instance": ("chain", (65, 128, 128, 120, 64), 1, dict(wide=True, cond=True, k_probes=2),
                                  "their streamed forms take the chain"),
    "unconditional-streamed-K1": ("chain", COND_MB86, 1, dict(stream=True), "unconditional instance"),
    "unconditional-streamed-K3": ("two", COND_MB86, 1, dict(stream=True), "unconditional instance"),
    "cond-instance-unconditional": ("two", (86, 258, 86), 0, dict(stream=True, cond=True), "COND instance"),
    "wide-cond-instance": ("chain", COND_MB86, 1, dict(wide=True, cond=True), "their streamed forms take the chain"),
}


@pytest.mark.parametrize("name", list(_REFUSED))
def test_stream_cond_refusals_on_the_card_name_their_row(name):
    """What the instances refuse of conditional nets past the wide limits
    raises NotImplementedError through the wrappers' checks, naming the
    instance that takes them: no unconditional streamed instance takes a
    conditional net, with one probe, K probes or JVP (streamed K7's and the
    streamed K4 adjoint's included: their COND instances, (d5), and the
    chain forms' probe COND instances, (d6), take the "K7-", "K4-" and
    "probes-" cases, `test_stream_cond_instances_accept_what_they_cover`),
    nor a COND instance an unconditional one, nor the wide COND instances a
    chain past the wide limits (with K probes, past the wide probe COND
    instances' shared memory)."""
    check, dims, nc, kw, why = _REFUSED[name]
    spec = _spec(dims, nc)
    with pytest.raises(NotImplementedError) as err:
        if check == "chain":
            k = kw.pop("k_probes", 1)
            tfs._cuda_only("streamed K1", _fake_cuda(), TSIT5, spec, k, chain=True, **kw)
        elif check == "two":
            tfs._cuda_only_wide_two_layer("streamed K3", _fake_cuda(), TSIT5, spec, **kw)
        else:
            tfs._cuda_only_stream_exact("the streamed K4 adjoint", _fake_cuda(), TSIT5, spec, **kw)
    assert why in str(err.value)
    if why.startswith("conditional chains past"):
        assert "ROADMAP queue 2, shape variants (d), part (d" in str(err.value)


# name -> (label, check, dims, n_cond[, probes, JVP?])
_ACCEPTED = {
    "K1-K2-two-layer": ("streamed K1", "chain", TWO, 1),
    "K1-K2-three-layer": ("streamed K2", "chain", THREE, 2),
    "K1-K2-cond-miniboone860": ("streamed K1", "chain", (44, 860, 860, 43), 1),
    "K3-K5-two-layer": ("streamed K3", "two", TWO, 1),
    "K3-K5-cond-miniboone86": ("streamed K5", "two", COND_MB86, 1),
    "K7-TEST-three-layer": ("streamed K7", "chain", THREE, 2),
    "K7-exact-cond-miniboone86": ("streamed K7", "chain", COND_MB86, 1),
    "K4-adjoint-cond-miniboone86": ("the streamed K4 adjoint", "exact", COND_MB86, 1),
    "K4-adjoint-hidden130": ("the streamed K4 adjoint", "exact", (44, 130, 43), 1),
    "probes-K4": ("streamed K1", "chain", COND_MB86, 1, 4, False),
    "probes-jvp": ("streamed K2", "chain", THREE, 2, 1, True),
    "probes-wide-cond-instance": ("streamed K1", "chain", (65, 128, 128, 120, 64), 1, 2, False),
}


@pytest.mark.parametrize("name", list(_ACCEPTED))
def test_stream_cond_instances_accept_what_they_cover(name):
    """The same checks pass the configurations the streamed COND instances
    take (one VJP probe), streamed K7's and the streamed K4 adjoint's (d5)
    included, and those the chain forms' probe COND instances take (K VJP
    or JVP probes, (d6))."""
    label, check, dims, nc, k, jvp = _ACCEPTED[name] + (1, False)[len(_ACCEPTED[name]) - 4:]
    spec = _spec(dims, nc)
    if check == "chain":
        tfs._cuda_only(label, _fake_cuda(), TSIT5, spec, k, chain=True, jvp=jvp, stream=True, cond=True)
    elif check == "exact":
        tfs._cuda_only_stream_exact(label, _fake_cuda(), TSIT5, spec, cond=True)
    else:
        tfs._cuda_only_wide_two_layer(label, _fake_cuda(), TSIT5, spec, stream=True, cond=True)


# route -> (dims, mode, probes, JVP?, the wrappers the loss and its gradient call, in order)
_ROUTES = {
    "two-layer-test": (TWO, "test", 1, False, ["run_stream_cond_test2_solve_kernel",
                                                "run_stream_cond_test_adjoint_kernel"]),
    "two-layer-train": (TWO, "train", 1, False, ["run_stream_cond_train_solve_kernel",
                                                  "run_stream_cond_adjoint_kernel"]),
    "two-layer-exact": (TWO, "exact", 1, False, ["run_stream_cond_exact_solve_kernel",
                                                  "run_stream_cond_exact_adjoint_kernel"]),
    "two-layer-train-K2": (TWO, "train", 2, False, ["run_stream_cond_train_solve_kernel",
                                                    "run_stream_cond_adjoint_kernel"]),
    "three-layer-test": (THREE, "test", 1, False, ["run_stream_cond_test_solve_kernel"]),
    "three-layer-train": (THREE, "train", 1, False, ["run_stream_cond_train_solve_kernel",
                                                      "run_stream_cond_adjoint_kernel"]),
    "three-layer-exact": (THREE, "exact", 1, False, ["run_stream_cond_exact_solve_kernel"]),
}


@pytest.mark.parametrize("route", list(_ROUTES))
def test_fused_solve_takes_the_stream_cond_instances(monkeypatch, route):
    """`make_full_solve` runs a conditional net past the wide limits through
    the streamed forms' COND instances: a 2-layer tanh net through streamed
    K3's and K5's (TEST) and the streamed K1 and K2 chain forms'
    (Hutchinson), a 3-layer chain through the chain forms' (Hutchinson);
    its TEST forward past 2 layers and its exact training through streamed
    K7's COND instances and, for a 2-layer net, the streamed K4 adjoint's
    (d5); K probes reach the streamed COND instances, which run them in
    their probe COND instances on the card (d6).  On the CPU each runs its
    twin; no wide or unconditional wrapper is called."""
    dims, mode, k, jvp, want = _ROUTES[route]
    called = []
    names = {n for v in _ROUTES.values() for n in v[4]} | {
        "run_stream_train_solve_kernel", "run_stream_adjoint_kernel", "run_stream_test2_solve_kernel",
        "run_stream_test_adjoint_kernel", "run_stream_test_solve_kernel", "run_stream_exact_solve_kernel",
        "run_stream_exact_adjoint_kernel", "run_wide_cond_train_solve_kernel", "run_wide_cond_adjoint_kernel",
        "run_wide_cond_test2_solve_kernel", "run_wide_cond_test_adjoint_kernel", "run_wide_cond_test_solve_kernel",
        "run_wide_cond_exact_solve_kernel", "run_wide_cond_exact_adjoint_kernel"}
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
    eps = np.random.default_rng(23).normal(size=(k, 8, dims[-1])).astype(np.float32)
    extra = {"eps": eps} if mode == "train" else {}
    torch.autograd.grad(tcnf.loss(icnf, getattr(tcnf.Mode, MODE_NAMES[mode]), xs, ps, ys=ys, **extra), leaves)
    assert [c[0] for c in called] == want
    assert all(c[1] for c in called)
    if mode == "train":
        assert [c[2] for c in called] == [(k, 8, dims[-1])] * 2


def test_stream_cond_wrappers_run_the_twins_on_the_cpu_without_counting():
    """On CPU tensors the four COND wrappers run their twins, bit for bit
    (a_ys0 last from the two adjoints), and count no launch; they are in
    KERNEL_WRAPPERS under `<source>/cond`, so `reset_launches` covers them,
    and the chain forms' are in PROBE_WRAPPERS."""
    keys = {tfs.K1S_KERNEL + "/cond": "run_stream_cond_train_solve_kernel",
            tfs.K2S_KERNEL + "/cond": "run_stream_cond_adjoint_kernel",
            tfs.K3S_KERNEL + "/cond": "run_stream_cond_test2_solve_kernel",
            tfs.K5S_KERNEL + "/cond": "run_stream_cond_test_adjoint_kernel"}
    assert all(tfs.KERNEL_WRAPPERS[k] is getattr(tfs, n) for k, n in keys.items())
    assert {tfs.run_stream_cond_train_solve_kernel, tfs.run_stream_cond_adjoint_kernel} <= set(tfs.PROBE_WRAPPERS)
    spec = tfs.chain_spec(tcnf.MLP(TWO), 66)
    ps = tcnf.params_from_numpy(_np_params(TWO, 24))
    rng = np.random.default_rng(25)
    T = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    ys = T(rng.uniform(-1.0, 1.0, (8, 1)))
    base = dict(rtol=1e-3, atol=1e-6, max_steps=100, ws=[p["w"] for p in ps], bs=[p["b"] for p in ps], ys=ys)
    tfs.reset_launches()
    fwd_kw = dict(base, z0=T(rng.normal(size=(8, 66))), t0=torch.tensor(0.0), t1=torch.tensor(1.0),
                  dt_init=torch.tensor(0.05))
    kw = dict(fwd_kw, dlogp0=T(rng.normal(size=8)))
    fwd = tfs.solve_test_plain(TSIT5, spec, **kw)
    assert all(torch.equal(a, b) for a, b in zip(tfs.run_stream_cond_test2_solve_kernel(TSIT5, spec, **kw), fwd))
    train = dict(fwd_kw, norm_z=True, norm_j=True, eps=T(rng.normal(size=(1, 8, 66))), acc0=T(rng.normal(size=(3, 8))))
    fwd_t = tfs.solve_train_plain(TSIT5, spec, **train)
    assert all(torch.equal(a, b) for a, b in zip(tfs.run_stream_cond_train_solve_kernel(TSIT5, spec, **train), fwd_t))
    adj = dict(base, azT=T(rng.normal(size=(8, 66))), t_hi=torch.tensor(1.0), t_lo=torch.tensor(0.0),
               dt_init=torch.tensor(-0.05))
    for wrapper, twin, extra in ((tfs.run_stream_cond_test_adjoint_kernel, tfs.adjoint_test_plain,
                                  dict(zT=fwd[0], accT=fwd[1][None], aaccT=T(rng.normal(size=(1, 8))))),
                                 (tfs.run_stream_cond_adjoint_kernel, tfs.adjoint_train_plain,
                                  dict(norm_z=True, norm_j=True, eps=train["eps"], zT=fwd_t[0], accT=fwd_t[1],
                                       aaccT=T(rng.normal(size=(3, 8)))))):
        got, ref = wrapper(TSIT5, spec, **dict(adj, **extra)), twin(TSIT5, spec, **dict(adj, **extra))
        assert len(got) == len(ref) == 8
        assert all(torch.equal(a, b) for a, b in zip(got[:3] + got[5:], ref[:3] + ref[5:]))
        assert all(torch.equal(a, b) for a, b in zip(got[3] + got[4], ref[3] + ref[4]))
    assert all(w.launches == 0 for w in tfs.KERNEL_WRAPPERS.values())
    assert all(w.probe_launches == {} for w in tfs.PROBE_WRAPPERS)


def test_cond_miniboone86_fit_on_cpu():
    """`fit(CondICNFModel(...), X, Y)` on the fused cond_miniboone86 model
    (its span (0, 13)) for two Lion steps at B = 8: finite losses, moving
    parameters, and no kernel launched on the CPU."""
    ps_np = _np_params(COND_MB86, 17)
    X, Y = model_data("cond_miniboone86", np.random.default_rng(18), 16)
    before = _launch_counts()
    icnf = _model(tcnf, COND_MB86, "train", tspan=(0.0, 13.0))
    model = tcnf.CondICNFModel(icnf, n_epochs=1, batch_size=8)
    res = tcnf.fit(model, X, Y, ps=tcnf.params_from_numpy(ps_np), seed=0)
    assert _launch_counts() == before
    assert res.epochs == 1 and np.isfinite(res.losses).all()
    moved = [float((a - torch.from_numpy(b)).abs().max()) for a, b in zip(_leaves(res.ps), _leaves(ps_np))]
    assert min(moved) > 0.0
