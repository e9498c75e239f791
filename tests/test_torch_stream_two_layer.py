"""2-layer tanh nets past the wide 2-layer kernels' limits in the port against
the JAX package on the CPU: the README net family MLP((n_in, 3 n_in, n_in))
at the MINIBOONE width, `MLP((86, 258, 86))` (miniboone86: RNODE, nvars =
naug = 43, the flagship recipe of bench.py), and `MLP((72, 80, 72))`, a
state width past 64 with a hidden width the wide forms would keep.  On the
card they run streamed K3 and K5 (TEST), the streamed K1 and K2 chain forms
(Hutchinson TRAIN) and streamed K7 exact with the streamed K4 adjoint (exact
TRAIN).  Their plain versions, through the fused solve on CPU tensors,
against the JAX package's kernels in interpret mode (the TEST and TRAIN
forwards, the TEST, Hutchinson and exact adjoints); TEST and TRAIN
`inference`; the Hutchinson, exact and TEST losses and their gradients
against `jax.grad`; the `miniboone86` and `bsds126` configurations; the
coverage rule at state widths 64, 65, 128 and 129; the fused solve's choice
of wrappers; the wrappers' CPU branch; `fit`, Hutchinson and exact.

Tolerances as in tests/test_torch_wide_two_layer.py: values within 1e-4
(rtol and atol: float32 sums in another order over a few steps), losses and
gradients rtol 1e-4 / atol 1e-5.  Inputs come from numpy seeds at B = 8,
where the JAX package runs one tile; the JAX probe and steering draws are
reproduced from its key split (`core/icnf.py:485`) and handed to the port."""

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
from continuousnf_tpu_torch.utils.configs import MODELS, glorot_params, model_data, tabular_data

# The port's entry points default to the CUDA card; these tests run it on the CPU.
tcnf.set_default_device("cpu")

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
MB86 = MODELS["miniboone86"]["dims"]
NETS = {"miniboone86": MB86, "dz72": (72, 80, 72)}
B = 8
MODE_NAMES = {"train": "TRAIN", "test": "TEST", "exact": "TRAIN"}
STREAM2 = ("run_stream_test2_solve_kernel", "run_stream_test_adjoint_kernel")
_FORWARDS = {"test": ("run_stream_test2_solve_kernel", "solve_test_plain"),
             "train": ("run_stream_train_solve_kernel", "solve_train_plain")}


def _cm(m, mode, fused=True):
    return m.VecJacMode(fused=fused, exact_trace=mode == "exact")


def _model(m, dims, mode="train", fused=True, **kw):
    """The flagship recipe (bench.py:142-177) at n_in = dims[0]: RNODE,
    nvars = naug = n_in / 2, steer_rate 0.1, lambda3 = 1e-2, tspan (0, 1)
    unless given."""
    kw = {"tspan": (0.0, 1.0), "steer_rate": 0.1, "lam3": 1e-2, **kw}
    n = dims[0] // 2
    return m.construct(m.RNODE, m.MLP(dims), n, dims[0] - n, compute_mode=_cm(m, mode, fused), **kw)


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


def _record_forward(monkeypatch, mode):
    """The keyword arguments of each call the fused solve makes to the
    mode's streamed forward wrapper."""
    calls = []
    name = _FORWARDS[mode][0]
    wrapper = getattr(tfs, name)
    monkeypatch.setattr(tfs, name, lambda tab, spec, **kw: calls.append(kw) or wrapper(tab, spec, **kw))
    return calls


def _hold_steps(st, st_r, mode, dims, calls):
    """Equal attempted and accepted steps and NFE or, at a near-tie of the
    step controller (the twin sums in another order than the JAX kernel), a
    step count that the twin's own solve reaches under one-ulp moves of its
    inputs (`utils/near_tie.witness`), as tests/test_torch_stream.py holds
    the streamed forwards."""
    if int(st.steps) == int(st_r.steps):
        assert (int(st.accepted), int(st.nfe)) == (int(st_r.accepted), int(st_r.nfe))
        return
    kw = {k: v for k, v in calls[0].items() if k != "ys"}
    steps, _ = near_tie.witness(getattr(tfs, _FORWARDS[mode][1]), TSIT5, _spec(dims), kw, "z0", n=8)
    assert int(st_r.steps) in steps


def _spec(dims, n_cond=0):
    ins = (dims[0] + n_cond,) + tuple(dims[1:-1])
    return tfs.ChainSpec(ins, tuple(dims[1:]), (True,) * (len(dims) - 1), n_cond)


# name -> (dims, nvars, batch): the README net family past the wide limits
_CONFIGS = {"miniboone86": ((86, 258, 86), 43, None), "bsds126": ((126, 378, 126), 63, 2048)}


@pytest.mark.parametrize("name", list(_CONFIGS))
def test_readme_family_configurations(name):
    """miniboone86 and bsds126: the README net family at 43 and 63
    variables, as many augmented dimensions, the flagship's steering,
    lambda3 and tspan (0, 13); bsds126 at batch 2048 (the JAX forward
    kernel's VMEM guard).  Both are 2-layer tanh chains past the wide
    2-layer kernels' state width that streamed K3 and K5 and the streamed
    chain forms take; the data recipe gives finite float32 rows of nvars."""
    dims, nvars, batch = _CONFIGS[name]
    cfg = MODELS[name]
    assert (cfg["dims"], cfg["nvars"], cfg["naug"], cfg["tspan"], cfg["extra"], cfg.get("batch")) == (
        dims, nvars, nvars, (0.0, 13.0), {"steer_rate": 0.1, "lam3": 1e-2}, batch)
    spec = tfs.chain_spec(tcnf.MLP(dims), dims[-1])
    assert tfs._stream_two_layer(spec) and tfs._stream_two_layer_covers(TSIT5, spec) is None
    assert tfs._kernel_covers(TSIT5, spec, chain=True) is None and tfs._stream_exact_covers(TSIT5, spec) is None
    assert f"state width {dims[-1]} > 64" in tfs._wide_two_layer_covers(TSIT5, spec)
    xs = model_data(name, np.random.default_rng(0), 32)
    assert xs.shape == (32, nvars) and xs.dtype == np.float32 and np.isfinite(xs).all()


@pytest.mark.parametrize("mode", ["test", "train"])
@pytest.mark.parametrize("net", list(NETS))
def test_stream_two_layer_forward_twins_match_jax_kernel(monkeypatch, net, mode):
    """The plain versions of streamed K3 (test: the closed-form TEST stage)
    and of the streamed K1 chain form (train), through the fused solve on
    CPU tensors, against the JAX package's forward kernel in interpret mode
    from zero accumulators: equal attempted and accepted steps (`_hold_steps`:
    or a near-tie the twin shows), values at 1e-4.  No kernel is
    launched."""
    dims = NETS[net]
    ps_np = _np_params(dims, 1)
    xs = _data(dims, B, 2)
    nacc = 1 if mode == "test" else 3
    y0f = _y0(dims, xs, nacc)
    eps = np.random.default_rng(3).normal(size=(1, B, dims[-1])).astype(np.float32) if mode == "train" else None
    jfull = jfs.make_full_solve(_model(cnf, dims, mode), getattr(cnf.Mode, MODE_NAMES[mode]), B)
    jargs = {"ps": _jps(ps_np), "eps": None if eps is None else jnp.asarray(eps), "ys": None}
    yT_r, st_r = jfull.forward(jnp.asarray(y0f), 0.0, 1.0, jargs)
    calls = _record_forward(monkeypatch, mode)
    tfull = tfs.make_full_solve(_model(tcnf, dims, mode), getattr(tcnf.Mode, MODE_NAMES[mode]), B)
    targs = {"ps": tcnf.params_from_numpy(ps_np), "eps": None if eps is None else torch.from_numpy(eps), "ys": None}
    before = _launch_counts()
    with torch.no_grad():
        yT, st = tfull.forward(torch.from_numpy(y0f), torch.tensor(0.0), torch.tensor(1.0), targs)
    assert _launch_counts() == before and len(calls) == 1
    _hold_steps(st, st_r, mode, dims, calls)
    np.testing.assert_allclose(yT.numpy(), np.asarray(yT_r), **TOL)


@pytest.mark.parametrize("mode", ["test", "train", "exact"], ids=["K5", "K2", "K4"])
@pytest.mark.parametrize("net", list(NETS))
def test_stream_two_layer_adjoint_twins_match_jax_kernel(net, mode):
    """The plain versions of streamed K5 (the TEST backsolve, ct_m folded
    into g), of the streamed K2 chain form (the Hutchinson backsolve) and of
    the streamed K4 adjoint (the exact backsolve, g_pm in the state and in
    the error norm, chained into W1 and W2 after), through the fused solve's
    backward member on CPU tensors, against the JAX package's adjoint kernel
    in interpret mode at one tile, from the same final state, cotangent and
    warm start: equal steps, accepted steps and NFE, states and gradients at
    1e-4.  No kernel is launched."""
    dims = NETS[net]
    span = 2.0
    seed = 4
    ps_np = _np_params(dims, seed)
    xs = _data(dims, B, seed + 1)
    nacc = 1 if mode == "test" else 3
    rng = np.random.default_rng(seed + 2)
    eps = rng.normal(size=(1, B, dims[-1])).astype(np.float32) if mode == "train" else None
    mode_j, mode_t = getattr(cnf.Mode, MODE_NAMES[mode]), getattr(tcnf.Mode, MODE_NAMES[mode])
    jfull = jfs.make_full_solve(_model(cnf, dims, mode, tspan=(0.0, span)), mode_j, B)
    assert jfull.adjoint is not None
    args = {"ps": _jps(ps_np), "eps": None if eps is None else jnp.asarray(eps), "ys": None}
    yTf, fst = jfull.forward(jnp.asarray(_y0(dims, xs, nacc)), 0.0, span, args)
    acc_ct = [np.full(B, 1.0 / B)] + ([np.full(2 * B, 1e-2 / B)] if nacc == 3 else [])
    g_yf = np.concatenate([rng.normal(0.0, 0.1, B * dims[-1])] + acc_ct).astype(np.float32)
    dt_warm = float(fst.dt_last)
    y0_r, ay0_r, gargs_r, st_r = jfull.adjoint(yTf, jnp.asarray(g_yf), args, span, 0.0, dt_warm=dt_warm)
    tfull = tfs.make_full_solve(_model(tcnf, dims, mode, tspan=(0.0, span)), mode_t, B)
    targs = {"ps": tcnf.params_from_numpy(ps_np), "eps": None if eps is None else torch.from_numpy(eps), "ys": None}
    before = _launch_counts()
    with torch.no_grad():
        y0, ay0, gargs, st = tfull.adjoint(torch.from_numpy(np.array(yTf)), torch.from_numpy(g_yf), targs,
                                           torch.tensor(span), torch.tensor(0.0), dt_warm=dt_warm)
    assert _launch_counts() == before
    assert (int(st.steps), int(st.accepted), int(st.nfe)) == (int(st_r.steps), int(st_r.accepted), int(st_r.nfe))
    np.testing.assert_allclose(y0.numpy(), np.asarray(y0_r), **TOL)
    np.testing.assert_allclose(ay0.numpy(), np.asarray(ay0_r), **TOL)
    for a, b in zip(_leaves(gargs["ps"]), _leaves(gargs_r["ps"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("mode", ["test", "train"])
@pytest.mark.parametrize("net", list(NETS))
def test_stream_two_layer_inference_matches_jax(monkeypatch, net, mode):
    """TEST and TRAIN `inference` (Hutchinson, with the JAX probe and
    steering draws handed over) against the JAX package's fused path (its
    kernels in interpret mode), with the same weights and inputs: the steps
    held by `_hold_steps` (dz72's TEST input sits at a near-tie: the JAX
    kernel takes 12 attempted steps where the JAX package's own plain path
    and the port take 11), the values at 1e-4."""
    dims = NETS[net]
    mode_name = MODE_NAMES[mode]
    jicnf, ticnf = _model(cnf, dims, mode), _model(tcnf, dims, mode)
    ps_np = _np_params(dims, 8)
    xs = _data(dims, B, 9)
    key = jax.random.PRNGKey(10)
    lp_r, regs_r, st_r = cnf.inference(jicnf, getattr(cnf.Mode, mode_name), jnp.asarray(xs), _jps(ps_np), key=key)
    extra = {}
    if mode == "train":
        eps, r = _jax_draws(jicnf, key, B)
        extra = {"eps": eps, "steer_r": r}
    calls = _record_forward(monkeypatch, mode)
    with torch.no_grad():
        lp, regs, st = tcnf.inference(ticnf, getattr(tcnf.Mode, mode_name), xs, tcnf.params_from_numpy(ps_np), **extra)
    _hold_steps(st, st_r, mode, dims, calls)
    for a, b in ((lp, lp_r), (regs.e, regs_r.e), (regs.n, regs_r.n)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("mode", ["test", "train", "exact"])
@pytest.mark.parametrize("net", list(NETS))
def test_stream_two_layer_gradients_match_jax_grad(net, mode):
    """The TEST, Hutchinson and exact losses and their gradients through the
    fused BACKSOLVE against `jax.grad` of the JAX package's fused loss: the
    backward members are streamed K5's, the streamed K2 chain form's and the
    streamed K4 adjoint's twins."""
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


# name -> (dims, the forms that take it: "wide" (the wide 2-layer kernels and
# wide chain forms), "stream" (streamed K3 and K5 and the streamed chain
# forms) or None (refused, naming ROADMAP queue 2's shape variants (e)))
_COVERAGE = {
    "dz64": ((64, 128, 64), "wide"),
    "dz64-hidden192": ((64, 192, 64), "stream"),
    "dz65": ((65, 195, 65), "stream"),
    "dz65-hidden66": ((65, 66, 65), "stream"),
    "dz40-hidden160": ((40, 160, 40), "stream"),
    "dz128": ((128, 384, 128), "stream"),
    "dz129": ((129, 387, 129), None),
}


@pytest.mark.parametrize("name", list(_COVERAGE))
def test_stream_two_layer_coverage_at_the_state_width_limits(name):
    """State widths to 64 within the wide forms' hidden and shared-memory
    limits stay in the wide forms; past 64 (whatever the hidden width), or
    past hidden 128, and to 128 the streamed forms take the net, streamed K3
    and K5 its TEST stages and the streamed K4 adjoint its exact backward
    member; past 128 every form refuses it, naming shape variants (e)."""
    dims, form = _COVERAGE[name]
    spec = _spec(dims)
    chain = tfs._kernel_covers(TSIT5, spec, chain=True)
    wide2 = tfs._wide_two_layer_covers(TSIT5, spec)
    stream2 = tfs._stream_two_layer_covers(TSIT5, spec)
    exact = tfs._stream_exact_covers(TSIT5, spec)
    if form is None:
        for msg in (chain, wide2, stream2, exact):
            assert f"state width {dims[0]} > 128" in msg and "ROADMAP queue 2, shape variants (e)" in msg
        return
    assert chain is None
    assert tfs._stream_chain(spec) == tfs._stream_two_layer(spec) == (form == "stream")
    assert (wide2 is None) == (form == "wide") and (stream2 is None) == (form == "stream")
    assert exact == stream2
    if dims[0] > 64:
        assert f"state width {dims[0]} > 64" in wide2 and "ROADMAP queue 2, shape variants (e)" in wide2


@pytest.mark.parametrize("tab", ["bosh3", "dopri5", "verner65", "dop853"])
def test_stream_exact_adjoint_takes_every_embedded_tableau(tab):
    """The streamed K4 adjoint takes miniboone86 under every embedded
    tableau (K9), as streamed K3 and K5 do, and refuses a fixed-step one."""
    from continuousnf_tpu_torch.ode.tableaus import get_tableau

    spec = _spec(MB86)
    assert tfs._stream_exact_covers(get_tableau(tab, 1e-3), spec) is None
    assert "no embedded error estimate" in tfs._stream_exact_covers(get_tableau("rk4", 1e-3), spec)


@pytest.mark.parametrize("kind", ["conditional", "identity-output", "three-layer"])
def test_stream_exact_adjoint_refuses_other_nets(kind):
    """A conditional 2-layer net is refused by the streamed K4 adjoint's
    unconditional instance, which names its COND instance (K8, which the
    rule admits); a 2-layer net with an identity layer (the JAX package's
    exact stage assumes tanh layers) and a 3-layer chain (no exact backward
    member, as in the JAX package) are refused by the streamed K4 adjoint's
    rule, and its wrapper raises ValueError for them on any device."""
    if kind == "conditional":
        spec = _spec(MB86, n_cond=1)
    elif kind == "identity-output":
        spec = tfs.ChainSpec((86, 258), (258, 86), (True, False), 0)
    else:
        spec = tfs.ChainSpec((86, 258, 258), (258, 258, 86), (True, True, True), 0)
    why = tfs._stream_exact_covers(TSIT5, spec)
    if kind == "conditional":
        assert why is None
        fake = types.SimpleNamespace(device=torch.device("cuda", 0))
        with pytest.raises(NotImplementedError, match="unconditional instance of the streamed K4 adjoint"):
            tfs._cuda_only_stream_exact("the streamed K4 adjoint", fake, TSIT5, spec)
        return
    assert why is not None
    with pytest.raises(ValueError):
        tfs.run_stream_exact_adjoint_kernel(TSIT5, spec, norm_z=True, norm_j=True, rtol=1e-3, atol=1e-6,
                                            max_steps=10, ws=[], bs=[], zT=torch.zeros(2, 86),
                                            accT=torch.zeros(3, 2), azT=torch.zeros(2, 86), aaccT=torch.zeros(3, 2),
                                            t_hi=torch.tensor(1.0), t_lo=torch.tensor(0.0),
                                            dt_init=torch.tensor(-0.1))


# (net, mode) -> the wrappers the loss and its gradient call, in order
_ROUTES = {
    ("miniboone86", "test"): ["run_stream_test2_solve_kernel", "run_stream_test_adjoint_kernel"],
    ("miniboone86", "train"): ["run_stream_train_solve_kernel", "run_stream_adjoint_kernel"],
    ("miniboone86", "exact"): ["run_stream_exact_solve_kernel", "run_stream_exact_adjoint_kernel"],
    ("dz72", "test"): ["run_stream_test2_solve_kernel", "run_stream_test_adjoint_kernel"],
    ("dz72", "train"): ["run_stream_train_solve_kernel", "run_stream_adjoint_kernel"],
    ("dz72", "exact"): ["run_stream_exact_solve_kernel", "run_stream_exact_adjoint_kernel"],
}


@pytest.mark.parametrize("route", list(_ROUTES), ids=[f"{n}-{m}" for n, m in _ROUTES])
def test_fused_solve_takes_the_streamed_forms_past_the_wide_limits(monkeypatch, route):
    """`make_full_solve` runs a 2-layer tanh net past the wide limits
    through streamed K3 and streamed K5 (TEST), the streamed K1 and K2 chain
    forms (Hutchinson TRAIN) and streamed K7 exact with the streamed K4
    adjoint (exact TRAIN), forward and backward, and no other wrapper (the
    wide K4 adjoint among them)."""
    net, mode = route
    called = []
    names = {n for v in _ROUTES.values() for n in v} | {
        "run_solve_kernel", "run_train_solve_kernel", "run_adjoint_kernel", "run_exact_solve_kernel",
        "run_exact_adjoint_kernel", "run_test_adjoint_kernel", "run_wide_test2_solve_kernel",
        "run_wide_test_adjoint_kernel", "run_wide_train_solve_kernel", "run_wide_adjoint_kernel",
        "run_wide_exact_solve_kernel", "run_stream_test_solve_kernel", "run_wide_exact_adjoint_kernel"}
    for name in names:
        wrapped = getattr(tfs, name)
        monkeypatch.setattr(tfs, name, lambda *a, _n=name, _f=wrapped, **kw: called.append(_n) or _f(*a, **kw))
    dims = NETS[net]
    icnf = _model(tcnf, dims, mode)
    ps = tcnf.params_from_numpy(_np_params(dims, 21))
    xs = _data(dims, 4, 22)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    extra = {"eps": np.random.default_rng(23).normal(size=(1, 4, dims[0])).astype(np.float32)} if mode == "train" else {}
    torch.autograd.grad(tcnf.loss(icnf, getattr(tcnf.Mode, MODE_NAMES[mode]), xs, ps, **extra), leaves)
    assert called == _ROUTES[route]


def test_stream_two_layer_wrappers_run_the_twins_on_the_cpu_without_counting():
    """On CPU tensors streamed K3 and K5 run their twins, bit for bit, and
    count no launch; `reset_launches` covers them."""
    assert {getattr(tfs, n) for n in STREAM2} <= set(tfs.KERNEL_WRAPPERS.values())
    dims = NETS["dz72"]
    spec = tfs.chain_spec(tcnf.MLP(dims), dims[-1])
    ps = tcnf.params_from_numpy(_np_params(dims, 24))
    rng = np.random.default_rng(25)
    T = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    base = dict(rtol=1e-3, atol=1e-6, max_steps=100, ws=[p["w"] for p in ps], bs=[p["b"] for p in ps])
    tfs.reset_launches()
    kw = dict(base, z0=T(rng.normal(size=(4, 72))), dlogp0=T(rng.normal(size=4)), t0=torch.tensor(0.0),
              t1=torch.tensor(1.0), dt_init=torch.tensor(0.05))
    got = tfs.run_stream_test2_solve_kernel(TSIT5, spec, **kw)
    fwd = tfs.solve_test_plain(TSIT5, spec, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, fwd))
    adj = dict(base, zT=fwd[0], accT=fwd[1][None], azT=T(rng.normal(size=(4, 72))), aaccT=T(rng.normal(size=(1, 4))),
               t_hi=torch.tensor(1.0), t_lo=torch.tensor(0.0), dt_init=torch.tensor(-0.05))
    got, ref = tfs.run_stream_test_adjoint_kernel(TSIT5, spec, **adj), tfs.adjoint_test_plain(TSIT5, spec, **adj)
    assert all(torch.equal(a, b) for a, b in zip(got[:3] + got[5:], ref[:3] + ref[5:]))
    assert all(torch.equal(a, b) for a, b in zip(got[3] + got[4], ref[3] + ref[4]))
    assert all(w.launches == 0 for w in tfs.KERNEL_WRAPPERS.values())


def test_stream_exact_adjoint_runs_its_twin_on_the_cpu_without_counting():
    """On CPU tensors the streamed K4 adjoint runs `adjoint_train_exact_plain`,
    bit for bit, and counts no launch; `reset_launches` covers it."""
    assert tfs.KERNEL_WRAPPERS[tfs.K4SA_KERNEL] is tfs.run_stream_exact_adjoint_kernel
    dims = NETS["dz72"]
    spec = tfs.chain_spec(tcnf.MLP(dims), dims[-1])
    ps = tcnf.params_from_numpy(_np_params(dims, 26))
    rng = np.random.default_rng(27)
    T = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    tfs.run_stream_exact_adjoint_kernel.launches = 5
    tfs.reset_launches()
    assert tfs.run_stream_exact_adjoint_kernel.launches == 0
    adj = dict(rtol=1e-3, atol=1e-6, max_steps=100, ws=[p["w"] for p in ps], bs=[p["b"] for p in ps], norm_z=True,
               norm_j=True, zT=T(rng.uniform(size=(4, 72))), accT=T(rng.normal(size=(3, 4))),
               azT=T(rng.normal(size=(4, 72))), aaccT=T(rng.normal(0.0, 0.25, (3, 4))), t_hi=torch.tensor(1.0),
               t_lo=torch.tensor(0.0), dt_init=torch.tensor(-0.05))
    got, ref = tfs.run_stream_exact_adjoint_kernel(TSIT5, spec, **adj), tfs.adjoint_train_exact_plain(TSIT5, spec, **adj)
    assert all(torch.equal(a, b) for a, b in zip(got[:3] + got[5:], ref[:3] + ref[5:]))
    assert all(torch.equal(a, b) for a, b in zip(got[3] + got[4], ref[3] + ref[4]))
    assert all(w.launches == 0 for w in tfs.KERNEL_WRAPPERS.values())


def test_stream_two_layer_exact_fit_on_cpu():
    """`fit` on the fused exact-trace miniboone86 model for two Lion steps
    (streamed K7 exact's and the streamed K4 adjoint's twins): finite losses,
    moving parameters, and no kernel launched on the CPU."""
    ps_np = _np_params(MB86, 19)
    X = _data(MB86, 2 * B, 20)
    before = _launch_counts()
    res = tcnf.fit(tcnf.ICNFModel(_model(tcnf, MB86, "exact"), n_epochs=1, batch_size=B), X,
                   ps=tcnf.params_from_numpy(ps_np), seed=0)
    assert _launch_counts() == before
    assert res.epochs == 1 and np.isfinite(res.losses).all()
    moved = [float((a - torch.from_numpy(b)).abs().max()) for a, b in zip(_leaves(res.ps), _leaves(ps_np))]
    assert min(moved) > 0.0


def test_stream_two_layer_fit_on_cpu():
    """`fit` on the fused miniboone86 model for two Lion steps: finite
    losses, moving parameters, and no kernel launched on the CPU."""
    ps_np = _np_params(MB86, 17)
    X = _data(MB86, 2 * B, 18)
    before = _launch_counts()
    res = tcnf.fit(tcnf.ICNFModel(_model(tcnf, MB86), n_epochs=1, batch_size=B), X,
                   ps=tcnf.params_from_numpy(ps_np), seed=0)
    assert _launch_counts() == before
    assert res.epochs == 1 and np.isfinite(res.losses).all()
    moved = [float((a - torch.from_numpy(b)).abs().max()) for a, b in zip(_leaves(res.ps), _leaves(ps_np))]
    assert min(moved) > 0.0
