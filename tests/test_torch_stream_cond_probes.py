"""Conditional K-probe and JVP training past the wide limits in the port
against the JAX package on the CPU (K6 x K8 in the streamed forms: the probe
COND instances of the streamed K1 and K2 chain forms): the conditional
2-layer net `MLP((67, 80, 66))` on [z | ys] with one ys column, past state
width 64, and the conditional 3-layer chain `MLP((10, 136, 136, 8))` with
two, past hidden width 128, under `VecJacMode(2)` and `JacVecMode(1)`; and
cond_miniboone86 (CondRNODE at the MINIBOONE width, `MLP((87, 258, 86))`)
under `VecJacMode(4)` as a whole slice.  The twins through the fused solve
on CPU tensors against the JAX package's forward and adjoint kernels in
interpret mode at one tile (the adjoint with a_ys0 and layer 0's ys
gradient rows); the K-probe and JVP losses' gradients in the params and in
ys against `jax.grad`, through the streamed COND wrappers with every probe
plane and the direction; the coverage rule and the routing; the wrappers'
CPU branch; a two-probe `fit` of `CondICNFModel`.

Inputs come from numpy seeds at B = 16 (cond_miniboone86: 8), where the JAX
package runs one tile (its VMEM estimates with K probes are asserted within
budget, so it runs its kernels in interpret mode); the JAX probe and
steering draws are reproduced from its key split (`core/icnf.py:485`) and
handed to the port.  The JAX package's solves and gradients are computed
once per module in fixtures.  Tolerances as in
tests/test_torch_stream_cond.py: values at rtol = atol = 1e-4 (float32 sums
in another order), gradients at rtol 1e-4, atol 1e-5; a one-step parting of
the forward held by `_hold_steps` (the JAX package's unfused path, or the
twin's own roundoff witness, taking the other count)."""

import types

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
from continuousnf_tpu_torch.utils import near_tie
from continuousnf_tpu_torch.utils.configs import MODELS, glorot_params, model_data

# The port's entry points default to the CUDA card; these tests run it on the CPU.
tcnf.set_default_device("cpu")

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
TWO, THREE = (67, 80, 66), (10, 136, 136, 8)
COND_MB86 = MODELS["cond_miniboone86"]["dims"]
# dims -> (nvars, naug, n_cond)
SPLIT = {TWO: (33, 33, 1), THREE: (4, 4, 2), COND_MB86: (43, 43, 1)}
NETS = {"two-layer": TWO, "three-layer": THREE, "cond-miniboone86": COND_MB86}
# name -> (K, jvp)
PROBES = {"K2": (2, False), "jvp": (1, True), "K4": (4, False)}
CASES = [("two-layer", "K2"), ("two-layer", "jvp"), ("three-layer", "K2"), ("three-layer", "jvp")]
IDS = [f"{net}-{probes}" for net, probes in CASES]
B = 16
WRAPPERS = ("run_stream_cond_train_solve_kernel", "run_stream_cond_adjoint_kernel")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's solves here are at B <= 16: on one thread each, since the
    six test workers of a full run share the machine's cores and a thread
    pool of tiny products a solve then costs more than it gains (the
    near-tie witness's sixteen twin solves took 200 s so, 1 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(m, dims, k, jvp, fused=True, **kw):
    """CondRNODE on [z | ys] with miniboone86's recipe (steer_rate 0.1,
    lambda3 = 1e-2) under K VJP or JVP probes, tspan (0, 1) unless given."""
    kw = {"tspan": (0.0, 1.0), "steer_rate": 0.1, "lam3": 1e-2, **kw}
    nvars, naug, _ = SPLIT[dims]
    cm = (m.JacVecMode if jvp else m.VecJacMode)(k, fused=fused)
    return m.construct(m.CondRNODE, m.MLP(dims), nvars, naug, compute_mode=cm, **kw)


def _np_params(dims, seed):
    return glorot_params(np.random.default_rng(seed), dims)


def _data(dims, n, seed):
    """(xs (n, nvars), ys (n, n_cond)): cond_miniboone86's recipe, else
    x ~ N(0, 1) next to y ~ U(-1, 1)."""
    if dims == COND_MB86:
        return model_data("cond_miniboone86", np.random.default_rng(seed), n)
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
    """The probes (K, batch, dz) and the steering r JAX `inference` draws
    from `key`."""
    eps_key, steer_key = jax.random.split(key)
    r = float(jax.random.uniform(steer_key, (), jnp.float32, -icnf.steer_rate, icnf.steer_rate))
    return np.array(icnf.draw_eps(eps_key, batch)), r


def _y0(dims, xs):
    z0 = np.concatenate([xs, np.zeros((xs.shape[0], dims[-1] - xs.shape[1]), np.float32)], axis=1)
    return np.concatenate([z0.ravel(), np.zeros(3 * xs.shape[0], np.float32)])


def _spec(dims, n_cond):
    return tfs.ChainSpec((dims[0],) + tuple(dims[1:-1]), tuple(dims[1:]), (True,) * (len(dims) - 1), n_cond)


def _assert_jax_kernels_run(dims, k, batch):
    """The JAX package's VMEM estimates with k probes stay within budget at
    `batch`, so its fused solve runs its kernels (in interpret mode on the
    CPU)."""
    jspec = jfs.chain_spec(cnf.MLP(dims), dims[-1])
    assert jspec.n_cond == SPLIT[dims][2]
    assert jfs._vmem_estimate_forward(JTSIT5, jspec, batch, 3, k, False) <= jfs._VMEM_BUDGET_BYTES
    assert jfs._vmem_estimate_adjoint(JTSIT5, jspec, batch, 3, k, False) <= jfs._VMEM_BUDGET_BYTES // 2


def _spy(monkeypatch, calls):
    """Record (name, tab, spec, kw) of every call of the two streamed COND
    wrappers, which still run."""
    for name in WRAPPERS:
        wrapped = getattr(tfs, name)
        monkeypatch.setattr(tfs, name, lambda tab, spec, _n=name, _f=wrapped, **kw: calls.append(
            (_n, tab, spec, kw)) or _f(tab, spec, **kw))


def _hold_steps(st, st_r, unfused_steps, witness_steps):
    """Equal attempted and accepted steps and NFE or, where the two part by
    one attempted and one accepted step, the port's twin taking the JAX
    kernel's count under one-ulp moves of its inputs (`witness_steps()`,
    `near_tie.witness`) or the JAX package's own unfused path on the same
    inputs taking the port's count (`unfused_steps()`), as
    tests/test_torch_stream_cond.py holds its forwards; the witness, a few
    twin solves, is asked first, the unfused path's compile only when it
    does not settle the parting (the 3-layer K = 2 forward parts so: JAX
    kernel and unfused 13 steps, the twin 14, and 13 under one-ulp moves)."""
    if int(st.steps) != int(st_r.steps):
        assert abs(int(st.steps) - int(st_r.steps)) == 1 and abs(int(st.accepted) - int(st_r.accepted)) == 1
        assert int(st_r.steps) in witness_steps() or unfused_steps() == int(st.steps)
    else:
        assert (int(st.accepted), int(st.nfe)) == (int(st_r.accepted), int(st_r.nfe))


def test_the_streamed_probe_cond_instances_take_the_slice():
    """cond_miniboone86 and cond_miniboone860 (CondRNODE, MLP 44 -> 860 ->
    860 -> 43 on [z | ys]) with K VJP probes or JVP probes run the streamed
    probe COND instances: the streamed forms take them, the wide forms do
    not."""
    for name in ("cond_miniboone86", "cond_miniboone860"):
        cfg = MODELS[name]
        spec = _spec(cfg["dims"], cfg["n_cond"])
        for k, jvp in ((2, False), (4, False), (1, True), (2, True)):
            assert tfs._kernel_covers(TSIT5, spec, k, chain=True, jvp=jvp) is None
            assert tfs._stream_chain(spec, True)
            assert tfs._kernel_covers(TSIT5, spec, k, chain=True, jvp=jvp, stream=False) is not None


# ---- the twins against the JAX package's kernels (interpret mode) ----


@pytest.fixture(scope="module")
def jax_solves():
    """The JAX package's fused forward and backward solves per (net,
    probes), computed once: the forward from zero accumulators over (0, 1),
    then its adjoint from the forward's final state with a loss-like
    cotangent and the forward's last step as warm start."""
    cache = {}

    def get(net, probes):
        if (net, probes) in cache:
            return cache[(net, probes)]
        dims, (k, jvp) = NETS[net], PROBES[probes]
        dz, span = dims[-1], 1.0
        _assert_jax_kernels_run(dims, k, B)
        ps_np = _np_params(dims, 51)
        xs, ys = _data(dims, B, 52)
        eps = np.random.default_rng(53).normal(size=(k, B, dz)).astype(np.float32)
        y0f = _y0(dims, xs)
        jfull = jfs.make_full_solve(_model(cnf, dims, k, jvp, tspan=(0.0, span)), cnf.Mode.TRAIN, B)
        assert jfull.adjoint is not None
        args = {"ps": _jps(ps_np), "eps": jnp.asarray(eps), "ys": jnp.asarray(ys)}
        yTf, fst = jfull.forward(jnp.asarray(y0f), 0.0, span, args)
        rng = np.random.default_rng(54)
        g_yf = np.concatenate([rng.normal(0.0, 0.1, B * dz), np.full(B, 1.0 / B), np.full(2 * B, 1e-2 / B)])
        g_yf = g_yf.astype(np.float32)
        dt_warm = float(fst.dt_last)
        bwd = jfull.adjoint(yTf, jnp.asarray(g_yf), args, span, 0.0, dt_warm=dt_warm)
        cache[(net, probes)] = types.SimpleNamespace(
            dims=dims, k=k, jvp=jvp, span=span, ps_np=ps_np, xs=xs, ys=ys, eps=eps, y0f=y0f, yTf=np.array(yTf),
            fst=fst, g_yf=g_yf, dt_warm=dt_warm, bwd=bwd)
        return cache[(net, probes)]

    return get


def _targs(ref):
    return {"ps": tcnf.params_from_numpy(ref.ps_np), "eps": torch.from_numpy(ref.eps), "ys": torch.from_numpy(ref.ys)}


@pytest.mark.parametrize("net,probes", CASES, ids=IDS)
def test_stream_cond_probe_forward_twin_matches_jax_kernel(monkeypatch, jax_solves, net, probes):
    """The plain version of the streamed K1 chain form's probe COND
    instance, through the fused solve on CPU tensors (the streamed COND
    wrapper given every probe plane and the direction), against the JAX
    package's forward kernel with ys rows and K probe planes in interpret
    mode from zero accumulators: equal attempted and accepted steps and NFE
    or a one-step parting (`_hold_steps`); values at 1e-4.  No kernel is
    launched."""
    ref = jax_solves(net, probes)
    calls = []
    _spy(monkeypatch, calls)
    tfull = tfs.make_full_solve(_model(tcnf, ref.dims, ref.k, ref.jvp, tspan=(0.0, ref.span)), tcnf.Mode.TRAIN, B)
    before = _launch_counts()
    with torch.no_grad():
        yT, st = tfull.forward(torch.from_numpy(ref.y0f), torch.tensor(0.0), torch.tensor(ref.span), _targs(ref))
    assert _launch_counts() == before
    assert [(c[0], tuple(c[3]["eps"].shape), c[3]["jvp"]) for c in calls] == [
        (WRAPPERS[0], (ref.k, B, ref.dims[-1]), ref.jvp)]

    def unfused_steps():
        icnf = _model(cnf, ref.dims, ref.k, ref.jvp, fused=False, steer_rate=0.0, tspan=(0.0, ref.span))
        _, _, st_u = cnf.inference(icnf, cnf.Mode.TRAIN, jnp.asarray(ref.xs), _jps(ref.ps_np), ys=jnp.asarray(ref.ys),
                                   eps=jnp.asarray(ref.eps), key=jax.random.PRNGKey(0))
        return int(st_u.steps)

    def witness_steps():
        _, tab, spec, kw = calls[0]
        return near_tie.witness(tfs.solve_train_plain, tab, spec, kw, "z0", n=8)[0]

    _hold_steps(st, ref.fst, unfused_steps, witness_steps)
    np.testing.assert_allclose(yT.numpy(), ref.yTf, **TOL)


@pytest.mark.parametrize("net,probes", CASES, ids=IDS)
def test_stream_cond_probe_adjoint_twin_matches_jax_kernel(jax_solves, net, probes):
    """The plain version of the streamed K2 chain form's probe COND
    instance, through the fused solve's backward member on CPU tensors,
    against the JAX package's adjoint kernel in interpret mode at one tile,
    from the same final state, cotangent and warm start: equal steps,
    accepted steps and NFE; the states, a_ys0 and the gradients at 1e-4,
    layer 0's ys rows of g_W among them, which are not zero; the probes get
    no cotangent.  No kernel is launched."""
    ref = jax_solves(net, probes)
    dz = ref.dims[-1]
    y0_r, ay0_r, gargs_r, st_r = ref.bwd
    tfull = tfs.make_full_solve(_model(tcnf, ref.dims, ref.k, ref.jvp, tspan=(0.0, ref.span)), tcnf.Mode.TRAIN, B)
    targs = _targs(ref)
    before = _launch_counts()
    y0, ay0, gargs, st = tfull.adjoint(torch.from_numpy(ref.yTf), torch.from_numpy(ref.g_yf), targs,
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
    assert torch.equal(gargs["eps"], torch.zeros_like(targs["eps"]))


# ---- the losses' gradients against jax.grad ----


@pytest.fixture(scope="module")
def jax_grads():
    """`jax.value_and_grad` of the JAX package's fused K-probe or JVP loss
    in the params and ys per (net, probes, batch), computed once, with the
    probe and steering draws of its key."""
    cache = {}

    def get(net, probes, batch):
        if (net, probes, batch) in cache:
            return cache[(net, probes, batch)]
        dims, (k, jvp) = NETS[net], PROBES[probes]
        _assert_jax_kernels_run(dims, k, batch)
        jicnf = _model(cnf, dims, k, jvp)
        ps_np = _np_params(dims, 58)
        xs, ys = _data(dims, batch, 59)
        key = jax.random.PRNGKey(60)
        l_r, (g_r, gy_r) = jax.value_and_grad(
            lambda p, y: cnf.loss(jicnf, cnf.Mode.TRAIN, jnp.asarray(xs), p, ys=y, key=key), argnums=(0, 1)
        )(_jps(ps_np), jnp.asarray(ys))
        eps, r = _jax_draws(jicnf, key, batch)
        assert eps.shape == (k, batch, dims[-1])
        cache[(net, probes, batch)] = types.SimpleNamespace(
            dims=dims, k=k, jvp=jvp, ps_np=ps_np, xs=xs, ys=ys, eps=eps, r=r, l=float(l_r),
            g=[np.asarray(x) for x in _leaves(g_r)] + [np.asarray(gy_r)])
        return cache[(net, probes, batch)]

    return get


@pytest.mark.parametrize("net,probes", [CASES[0], CASES[3], ("cond-miniboone86", "K4")],
                         ids=["two-layer-K2", "three-layer-jvp", "cond-miniboone86-K4"])
def test_stream_cond_probe_gradients_match_jax_grad(monkeypatch, jax_grads, net, probes):
    """The K-probe and JVP losses and their gradients in the params and in ys
    (B, n_cond) through the fused BACKSOLVE against `jax.grad` of the JAX
    package's fused loss (the JAX probe and steering draws handed over):
    the forward through the streamed K1 chain form's COND wrapper and the
    backward member through the streamed K2 chain form's, each given every
    probe plane and the direction, a_ys0 summed back to ys's shape;
    cond_miniboone86 at its full width with four probes at B = 8.  No
    kernel is launched."""
    batch = 8 if net == "cond-miniboone86" else B
    ref = jax_grads(net, probes, batch)
    calls = []
    _spy(monkeypatch, calls)
    ticnf = _model(tcnf, ref.dims, ref.k, ref.jvp)
    ps = tcnf.params_from_numpy(ref.ps_np)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    ys_t = torch.from_numpy(ref.ys).requires_grad_()
    before = _launch_counts()
    l = tcnf.loss(ticnf, tcnf.Mode.TRAIN, ref.xs, ps, ys=ys_t, eps=ref.eps, steer_r=ref.r)
    g = torch.autograd.grad(l, leaves + [ys_t])
    assert _launch_counts() == before
    got = [(c[0], tuple(c[3]["eps"].shape), c[3]["jvp"], c[3]["ys"] is not None) for c in calls]
    want = (ref.k, batch, ref.dims[-1]), ref.jvp, True
    assert got == [(WRAPPERS[0],) + want, (WRAPPERS[1],) + want]
    np.testing.assert_allclose(float(l.detach()), ref.l, **GRAD_TOL)
    for a, b in zip(g, ref.g):
        np.testing.assert_allclose(a.numpy(), b, **GRAD_TOL)
    assert float(g[0][ref.dims[-1]:].abs().max()) > 0.0


# ---- coverage, routing, the wrappers' CPU branch, fit ----


# name -> (dims, n_cond, probes, JVP?, the refusal (None: the streamed probe COND instances take it))
_COVERAGE = {
    "two-layer-K2": (TWO, 1, 2, False, None),
    "two-layer-jvp": (TWO, 1, 1, True, None),
    "three-layer-K3": (THREE, 2, 3, False, None),
    "cond-miniboone860-K2": ((44, 860, 860, 43), 1, 2, False, None),
    "cond-bsds126-jvp-K2": ((127, 378, 126), 1, 2, True, None),
    "dz128-K2": ((129, 384, 128), 1, 2, False, None),
    "probe-shared-memory-K2": ((65, 128, 128, 120, 64), 1, 2, False, None),
    "four-layer-jvp": ((44, 200, 200, 200, 43), 1, 1, True, None),
    "dz129-K2": ((130, 387, 129), 1, 2, False, "state width 129 > 128"),
    "five-layer-jvp": ((44, 860, 860, 860, 860, 43), 1, 1, True, "5-layer chains"),
    "offsets-K2": ((44, 50000, 50000, 43), 1, 2, False, "offsets are 32-bit ints"),
}


@pytest.mark.parametrize("name", list(_COVERAGE))
def test_stream_cond_probe_coverage(name):
    """`_kernel_covers(..., chain=True)` takes conditional chains of 2 to 4
    layers up to state width 128 past the wide limits (or past the wide
    probe COND instances' shared memory) with any K VJP probes or JVP
    probes, which the streamed forms count as theirs and the wide forms
    alone refuse; past state width 128, 4 layers or the 32-bit offsets it
    still refuses by the same rows."""
    dims, nc, k, jvp, why = _COVERAGE[name]
    spec = _spec(dims, nc)
    msg = tfs._kernel_covers(TSIT5, spec, k, chain=True, jvp=jvp)
    if why is None:
        assert msg is None and tfs._stream_chain(spec, True)
        assert tfs._kernel_covers(TSIT5, spec, k, chain=True, jvp=jvp, stream=False) is not None
        tfs._cuda_only("streamed K1", types.SimpleNamespace(device=torch.device("cuda", 0)), TSIT5, spec, k,
                       chain=True, jvp=jvp, stream=True, cond=True)
        return
    assert msg is not None and why in msg and "ROADMAP queue 2" in msg


# route -> (dims, probes, the wrappers the K-probe or JVP loss and its gradient call)
_ROUTES = {
    "two-layer-K2": (TWO, "K2", list(WRAPPERS)),
    "three-layer-jvp": (THREE, "jvp", list(WRAPPERS)),
    "probe-shared-memory-K2": ((65, 128, 128, 120, 64), "K2", list(WRAPPERS)),
    "wide-cond-K2": ((35, 72, 34), "K2", ["run_wide_cond_train_solve_kernel", "run_wide_cond_adjoint_kernel"]),
}


@pytest.mark.parametrize("route", list(_ROUTES))
def test_fused_solve_takes_the_stream_probe_cond_instances(monkeypatch, route):
    """`make_full_solve` runs the K-probe and JVP training of a conditional
    chain past the wide limits through the streamed K1 and K2 chain forms'
    COND wrappers, given every probe plane, the direction and ys; so does a
    wide conditional chain past the wide probe COND instances' shared
    memory, whose one-probe training stays on the wide COND instances; a
    conditional chain the wide probe COND instances keep stays there.  On
    the CPU each runs its twin; no other wrapper is called."""
    dims, probes, want = _ROUTES[route]
    k, jvp = PROBES[probes]
    called = []
    names = {"run_stream_cond_train_solve_kernel", "run_stream_cond_adjoint_kernel", "run_stream_train_solve_kernel",
             "run_stream_adjoint_kernel", "run_wide_cond_train_solve_kernel", "run_wide_cond_adjoint_kernel",
             "run_wide_train_solve_kernel", "run_wide_adjoint_kernel"}
    for name in names:
        wrapped = getattr(tfs, name)

        def spy(*a, _n=name, _f=wrapped, **kw):
            called.append((_n, kw.get("ys") is not None, tuple(kw["eps"].shape), kw["jvp"]))
            return _f(*a, **kw)

        monkeypatch.setattr(tfs, name, spy)
    nc = 1 if dims != THREE else 2
    icnf = tcnf.construct(tcnf.CondRNODE, tcnf.MLP(dims), dims[-1] // 2, dims[-1] - dims[-1] // 2, tspan=(0.0, 0.5),
                          compute_mode=(tcnf.JacVecMode if jvp else tcnf.VecJacMode)(k, fused=True))
    assert dims[0] - dims[-1] == nc
    ps = tcnf.params_from_numpy(_np_params(dims, 21))
    rng = np.random.default_rng(22)
    xs = rng.normal(size=(4, dims[-1] // 2)).astype(np.float32)
    ys = rng.uniform(-1.0, 1.0, (4, nc)).astype(np.float32)
    eps = rng.normal(size=(k, 4, dims[-1])).astype(np.float32)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    torch.autograd.grad(tcnf.loss(icnf, tcnf.Mode.TRAIN, xs, ps, ys=ys, eps=eps), leaves)
    assert [c[0] for c in called] == want
    assert all(c[1:] == (True, (k, 4, dims[-1]), jvp) for c in called)


def test_stream_cond_probe_wrappers_run_the_twins_on_the_cpu_without_counting():
    """On CPU tensors the streamed K1 and K2 chain forms' COND wrappers run
    their twins with K VJP or JVP probes, bit for bit (a_ys0 last from the
    adjoint), and count no launch, neither in `.launches` nor in
    `.probe_launches`."""
    spec = tfs.chain_spec(tcnf.MLP(TWO), 66)
    ps = tcnf.params_from_numpy(_np_params(TWO, 24))
    rng = np.random.default_rng(25)
    T = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    base = dict(rtol=1e-3, atol=1e-6, max_steps=100, ws=[p["w"] for p in ps], bs=[p["b"] for p in ps],
                ys=T(rng.uniform(-1.0, 1.0, (4, 1))), norm_z=True, norm_j=True)
    tfs.reset_launches()
    for k, jvp in ((3, False), (2, True)):
        fwd_kw = dict(base, z0=T(rng.normal(size=(4, 66))), t0=torch.tensor(0.0), t1=torch.tensor(0.5),
                      dt_init=torch.tensor(0.05), eps=T(rng.normal(size=(k, 4, 66))), acc0=T(rng.normal(size=(3, 4))),
                      jvp=jvp)
        fwd = tfs.solve_train_plain(TSIT5, spec, **fwd_kw)
        got = tfs.run_stream_cond_train_solve_kernel(TSIT5, spec, **fwd_kw)
        assert all(torch.equal(a, b) for a, b in zip(got, fwd))
        adj = dict(base, eps=fwd_kw["eps"], jvp=jvp, zT=fwd[0], accT=fwd[1], azT=T(rng.normal(size=(4, 66))),
                   aaccT=T(rng.normal(size=(3, 4))), t_hi=torch.tensor(0.5), t_lo=torch.tensor(0.0),
                   dt_init=torch.tensor(-0.05))
        got, ref = tfs.run_stream_cond_adjoint_kernel(TSIT5, spec, **adj), tfs.adjoint_train_plain(TSIT5, spec, **adj)
        assert len(got) == len(ref) == 8
        assert all(torch.equal(a, b) for a, b in zip(got[:3] + got[5:], ref[:3] + ref[5:]))
        assert all(torch.equal(a, b) for a, b in zip(got[3] + got[4], ref[3] + ref[4]))
    assert all(w.launches == 0 for w in tfs.KERNEL_WRAPPERS.values())
    assert all(w.probe_launches == {} for w in tfs.PROBE_WRAPPERS)


def test_stream_cond_probe_fit_on_cpu():
    """`fit(CondICNFModel(...), X, Y)` with two VJP probes on the
    conditional 2-layer net past state width 64 for two Lion steps at
    B = 16: finite losses, moving parameters, and no kernel launched on the
    CPU."""
    ps_np = _np_params(TWO, 61)
    X, Y = _data(TWO, 2 * B, 62)
    before = _launch_counts()
    model = tcnf.CondICNFModel(_model(tcnf, TWO, 2, False, tspan=(0.0, 0.5)), n_epochs=1, batch_size=B)
    res = tcnf.fit(model, X, Y, ps=tcnf.params_from_numpy(ps_np), seed=0)
    assert _launch_counts() == before
    assert res.epochs == 1 and len(res.losses) >= 1 and np.isfinite(res.losses).all()
    moved = [float((a - torch.from_numpy(b)).abs().max()) for a, b in zip(_leaves(res.ps), _leaves(ps_np))]
    assert min(moved) > 0.0
