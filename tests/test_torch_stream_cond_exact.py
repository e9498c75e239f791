"""Conditional exact training and conditional deep-chain serving past the
wide limits in the port against the JAX package on the CPU (K8 in streamed
K7 and in the streamed K4 adjoint): the conditional 2-layer net
`MLP((67, 80, 66))` on [z | ys] with one ys column, past state width 64,
whose exact forward runs streamed K7 exact's COND instance on the card and
whose exact backward the streamed K4 adjoint's; `MLP((44, 130, 43))` with
one ys column, past hidden width 128, through the same two; the conditional
3-layer chain `MLP((10, 136, 136, 8))` with two ys columns, whose TEST and
exact forwards run streamed K7's COND instances (its exact gradient runs the
plain BACKSOLVE, as in the JAX package); and cond_miniboone86 (CondRNODE at
the MINIBOONE width, `MLP((87, 258, 86))`) as a whole slice.  The COND
twins through the fused solve on CPU tensors against the JAX package's
kernels in interpret mode at one tile (the exact forwards, the 3-layer TEST
forward, the exact adjoint with a_ys0 after the pm chaining, W1's ys rows
getting no pm part); the streamed K4 adjoint's CUDA branch with a stand-in
library (the pm chaining into W1's z rows); TEST and exact `inference`; the
exact losses' gradients in the params and in ys against `jax.grad` with the
route checked; `CondICNFDist.logpdf` and `sample` of the 3-layer chain with
the JAX base draw injected; the coverage rule and the routing; the wrappers'
CPU branch; the cond_miniboone860 configuration; an exact `fit`.

Inputs come from numpy seeds at B = 16 (cond_miniboone86: 8), where the JAX
package runs one tile (its VMEM estimates are asserted within budget, so it
runs its kernels in interpret mode); the JAX steering and base draws are
reproduced from its key split (`core/icnf.py:485`, `:616`) and handed to
the port.  The JAX package's fused solves are shared between the tests
through a module-scoped fixture.  Tolerances as in
tests/test_torch_wide_cond_exact.py: values at rtol = atol = 1e-4 (float32
sums in another order), gradients at rtol 1e-4, atol 1e-5."""

import ctypes
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
from continuousnf_tpu_torch.utils.configs import MODELS, glorot_params, model_data

# The port's entry points default to the CUDA card; these tests run it on the CPU.
tcnf.set_default_device("cpu")

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
TWO, WIDE_H, THREE = (67, 80, 66), (44, 130, 43), (10, 136, 136, 8)
COND_MB86 = MODELS["cond_miniboone86"]["dims"]
# dims -> (nvars, naug, n_cond)
SPLIT = {TWO: (33, 33, 1), WIDE_H: (43, 0, 1), THREE: (4, 4, 2), COND_MB86: (43, 43, 1)}
NETS = {"two-layer": TWO, "hidden130": WIDE_H, "three-layer": THREE}
B = 16
MODE_NAMES = {"test": "TEST", "exact": "TRAIN"}
# (net, mode) -> the forward wrapper the fused solve calls
_FORWARDS = {("two-layer", "exact"): "run_stream_cond_exact_solve_kernel",
             ("three-layer", "exact"): "run_stream_cond_exact_solve_kernel",
             ("three-layer", "test"): "run_stream_cond_test_solve_kernel"}
# The unconditional instances, which a conditional net must not reach.
_UNCONDITIONAL = ("run_stream_test_solve_kernel", "run_stream_exact_solve_kernel", "run_stream_exact_adjoint_kernel")


def _model(m, dims, mode, fused=True, **kw):
    """CondRNODE on [z | ys] with miniboone86's recipe (steer_rate 0.1,
    lambda3 = 1e-2), tspan (0, 1) unless given."""
    kw = {"tspan": (0.0, 1.0), "steer_rate": 0.1, "lam3": 1e-2, **kw}
    nvars, naug, _ = SPLIT[dims]
    cm = m.VecJacMode(fused=fused, exact_trace=mode == "exact")
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


def _y0(dims, xs, nacc):
    z0 = np.concatenate([xs, np.zeros((xs.shape[0], dims[-1] - xs.shape[1]), np.float32)], axis=1)
    return np.concatenate([z0.ravel(), np.zeros(nacc * xs.shape[0], np.float32)])


def _spec(dims, n_cond):
    return tfs.ChainSpec((dims[0],) + tuple(dims[1:-1]), tuple(dims[1:]), (True,) * (len(dims) - 1), n_cond)


def _steer_r(icnf, key):
    """The steering r JAX TRAIN `inference` draws from `key` (no probes
    under exact trace)."""
    _, steer_key = jax.random.split(key)
    return float(jax.random.uniform(steer_key, (), jnp.float32, -icnf.steer_rate, icnf.steer_rate))


def _hold_steps(st, st_r, unfused_steps):
    """Equal attempted and accepted steps and NFE or, at a tie of the last
    step (one solve reaches t1, the other stops short and takes the
    remainder: one attempted and one accepted step more), the JAX package's
    own unfused path on the same inputs taking the port's count
    (`unfused_steps()`)."""
    if int(st.steps) != int(st_r.steps):
        assert abs(int(st.steps) - int(st_r.steps)) == 1 and abs(int(st.accepted) - int(st_r.accepted)) == 1
        assert unfused_steps() == int(st.steps)
    else:
        assert (int(st.accepted), int(st.nfe)) == (int(st_r.accepted), int(st_r.nfe))


def _assert_jax_kernels_run(dims, mode, batch=B, adjoint=False):
    """The JAX package's VMEM estimates stay within budget at `batch`, so
    its fused solve runs its kernels (in interpret mode on the CPU)."""
    jspec = jfs.chain_spec(cnf.MLP(dims), dims[-1])
    nacc, exact = (3, True) if mode == "exact" else (1, False)
    assert jfs._vmem_estimate_forward(JTSIT5, jspec, batch, nacc, 1, exact) <= jfs._VMEM_BUDGET_BYTES
    if adjoint:
        assert jfs._vmem_estimate_adjoint(JTSIT5, jspec, batch, nacc, 1, exact) <= jfs._VMEM_BUDGET_BYTES // 2


def _fake_cuda():
    """A stand-in for a CUDA tensor: the coverage checks read its device."""
    return types.SimpleNamespace(device=torch.device("cuda", 0))


@pytest.fixture(scope="module")
def jax_adjoints():
    """The JAX package's exact forward and adjoint per 2-layer net, computed
    once: the forward from zero accumulators over (0, 2), then its adjoint
    from the forward's final state with a loss-like cotangent and the
    forward's last step as warm start."""
    cache = {}

    def get(net):
        if net in cache:
            return cache[net]
        dims, span = NETS[net], 2.0
        dz = dims[-1]
        _assert_jax_kernels_run(dims, "exact", adjoint=True)
        ps_np = _np_params(dims, 33)
        xs, ys = _data(dims, B, 34)
        jfull = jfs.make_full_solve(_model(cnf, dims, "exact", tspan=(0.0, span)), cnf.Mode.TRAIN, B)
        assert jfull.adjoint is not None
        args = {"ps": _jps(ps_np), "eps": None, "ys": jnp.asarray(ys)}
        yTf, fst = jfull.forward(jnp.asarray(_y0(dims, xs, 3)), 0.0, span, args)
        rng = np.random.default_rng(35)
        g_yf = np.concatenate([rng.normal(0.0, 0.1, B * dz), np.full(B, 1.0 / B), np.full(2 * B, 1e-2 / B)])
        g_yf = g_yf.astype(np.float32)
        dt_warm = float(fst.dt_last)
        ref = jfull.adjoint(yTf, jnp.asarray(g_yf), args, span, 0.0, dt_warm=dt_warm)
        cache[net] = (ps_np, ys, np.array(yTf), g_yf, dt_warm, span, ref)
        return cache[net]

    return get


def test_cond_miniboone860_configuration():
    """The conditional miniboone860: CondRNODE, 43 variables, no augmented
    dimension, one conditioning column, MLP 44 -> 860 -> 860 -> 43 on
    [z | ys], miniboone860's tspan, extra settings and batch; ys and xs by
    cond_miniboone86's recipe (the standardised MiniBooNE label, xs shifted
    by 0.5 ys).  The streamed COND instances take it (streamed K7 TEST and
    exact), the wide forms do not; its exact gradient has no kernel backward
    member, as the JAX package's deep exact chains have none."""
    cfg, twin = MODELS["cond_miniboone860"], MODELS["miniboone860"]
    assert (cfg["dims"], cfg["nvars"], cfg["naug"], cfg["n_cond"]) == ((44, 860, 860, 43), 43, 0, 1)
    assert (cfg["tspan"], cfg["extra"], cfg["batch"]) == (twin["tspan"], twin["extra"], twin["batch"])
    xs, ys = model_data("cond_miniboone860", np.random.default_rng(0), 1024)
    xs86, ys86 = model_data("cond_miniboone86", np.random.default_rng(0), 1024)
    assert xs.shape == (1024, 43) and ys.shape == (1024, 1) and xs.dtype == ys.dtype == np.float32
    assert np.array_equal(xs, xs86) and np.array_equal(ys, ys86)
    icnf = tcnf.construct(tcnf.CondRNODE, tcnf.MLP(cfg["dims"]), 43, 0)
    spec = tfs.chain_spec(icnf.nn, icnf.zdim)
    assert spec.n_cond == 1 and tfs._stream_chain(spec) and not tfs._wide_two_layer(spec)
    assert tfs._kernel_covers(TSIT5, spec, chain=True) is None
    assert tfs._kernel_covers(TSIT5, spec, chain=True, stream=False) is not None
    tfs._cuda_only("streamed K7", _fake_cuda(), TSIT5, spec, chain=True, stream=True, cond=True)
    exact = tfs.make_full_solve(tcnf.construct(tcnf.CondRNODE, tcnf.MLP(cfg["dims"]), 43, 0,
                                               compute_mode=tcnf.VecJacMode(fused=True, exact_trace=True)),
                                tcnf.Mode.TRAIN, 8)
    assert exact is not None and exact.adjoint is None


@pytest.mark.parametrize("net,mode", list(_FORWARDS), ids=[f"{n}-{m}" for n, m in _FORWARDS])
def test_stream_cond_exact_and_chain_test_forward_twins_match_jax_kernel(net, mode):
    """The plain versions of streamed K7 exact's COND instance (both nets)
    and of streamed K7 TEST's (the 3-layer chain), through the fused solve
    on CPU tensors, against the JAX package's forward kernel with ys rows in
    interpret mode from zero accumulators: equal attempted and accepted
    steps and NFE or, at a last-step tie (`_hold_steps`), the JAX package's
    unfused path over the same span taking the port's count; values at
    1e-4.  No kernel is launched."""
    dims = NETS[net]
    _assert_jax_kernels_run(dims, mode)
    ps_np = _np_params(dims, 31)
    xs, ys = _data(dims, B, 32)
    nacc = 3 if mode == "exact" else 1
    y0f = _y0(dims, xs, nacc)
    jfull = jfs.make_full_solve(_model(cnf, dims, mode), getattr(cnf.Mode, MODE_NAMES[mode]), B)
    yT_r, st_r = jfull.forward(jnp.asarray(y0f), 0.0, 1.0, {"ps": _jps(ps_np), "eps": None, "ys": jnp.asarray(ys)})
    tfull = tfs.make_full_solve(_model(tcnf, dims, mode), getattr(tcnf.Mode, MODE_NAMES[mode]), B)
    before = _launch_counts()
    with torch.no_grad():
        yT, st = tfull.forward(torch.from_numpy(y0f), torch.tensor(0.0), torch.tensor(1.0),
                               {"ps": tcnf.params_from_numpy(ps_np), "eps": None, "ys": torch.from_numpy(ys)})
    assert _launch_counts() == before

    def unfused_steps():
        jicnf = _model(cnf, dims, mode, fused=False, steer_rate=0.0)
        _, _, st_u = cnf.inference(jicnf, getattr(cnf.Mode, MODE_NAMES[mode]), jnp.asarray(xs), _jps(ps_np),
                                   ys=jnp.asarray(ys), key=jax.random.PRNGKey(0))
        return int(st_u.steps)

    _hold_steps(st, st_r, unfused_steps)
    np.testing.assert_allclose(yT.numpy(), np.asarray(yT_r), **TOL)


@pytest.mark.parametrize("net", ["two-layer", "hidden130"])
def test_stream_cond_exact_adjoint_twin_matches_jax_kernel(jax_adjoints, net):
    """The plain version of the streamed K4 adjoint's COND instance, through
    the fused solve's backward member on CPU tensors, against the JAX
    package's adjoint kernel in interpret mode at one tile after its pm
    chaining, from the same final state, cotangent and warm start: equal
    steps, accepted steps and NFE; the states, a_ys0 and the gradients at
    1e-4 (the ys rows of g_W1 among them, which are not zero).  The pm
    chaining adds to W1's z rows only: its ys rows are the unchained
    solve's, ys (x) ct_pre1.  No kernel is launched."""
    dims = NETS[net]
    dz = dims[-1]
    ps_np, ys, yTf, g_yf, dt_warm, span, (y0_r, ay0_r, gargs_r, st_r) = jax_adjoints(net)
    ticnf = _model(tcnf, dims, "exact", tspan=(0.0, span))
    tfull = tfs.make_full_solve(ticnf, tcnf.Mode.TRAIN, B)
    ps = tcnf.params_from_numpy(ps_np)
    targs = {"ps": ps, "eps": None, "ys": torch.from_numpy(ys)}
    before = _launch_counts()
    y0, ay0, gargs, st = tfull.adjoint(torch.from_numpy(yTf), torch.from_numpy(g_yf), targs,
                                       torch.tensor(span), torch.tensor(0.0), dt_warm=dt_warm)
    assert _launch_counts() == before
    assert (int(st.steps), int(st.accepted), int(st.nfe)) == (int(st_r.steps), int(st_r.accepted), int(st_r.nfe))
    np.testing.assert_allclose(y0.numpy(), np.asarray(y0_r), **TOL)
    np.testing.assert_allclose(ay0.numpy(), np.asarray(ay0_r), **TOL)
    assert gargs["ys"].shape == ys.shape
    np.testing.assert_allclose(gargs["ys"].numpy(), np.asarray(gargs_r["ys"]), **TOL)
    for a, b in zip(_leaves(gargs["ps"]), _leaves(gargs_r["ps"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    g_w1 = gargs["ps"][0]["w"]
    assert float(g_w1[dz:].abs().max()) > 0.0

    # The unchained solve (g_W1 before g_pm is chained in) from the same state.
    spec = tfs.chain_spec(tcnf.MLP(dims), dz)
    ws, bs = [p["w"] for p in ps], [p["b"] for p in ps]
    yT = torch.from_numpy(yTf)
    zT, accT = yT[: B * dz].reshape(B, dz), yT[B * dz :].reshape(3, B)
    azT, aaccT = torch.from_numpy(g_yf[: B * dz]).reshape(B, dz), torch.from_numpy(g_yf[B * dz :]).reshape(3, B)
    pm = tfs._exact_pm(spec, ws)
    ysb = torch.from_numpy(ys)
    stage = tfs._exact_adjoint_stage(spec, ws, bs, pm, True, True, aaccT, ysb)
    _, _, _, blocks, _, _ = tfs._adjoint_plain(
        stage, tfs._block_shapes(ws, bs, ysb, [pm.shape]), TSIT5, rtol=ticnf.solver.rtol, atol=ticnf.solver.atol,
        max_steps=ticnf.solver.max_steps, zT=zT, accT=accT, azT=azT, aaccT=aaccT, t_hi=torch.tensor(span),
        t_lo=torch.tensor(0.0), dt_init=-torch.tensor(abs(dt_warm)))
    raw_w1 = blocks[1]
    assert torch.equal(g_w1[dz:], raw_w1[dz:])
    assert float((g_w1[:dz] - raw_w1[:dz]).abs().max()) > 0.0


class _StandInK4:
    """A stand-in for the streamed K4 adjoint's library: its COND entry
    writes the twin's unchained outputs (z0, acc0, a_z0, a_ys0, g =
    [W1 (dz + nc, H) | b1 | W2 | b2 | g_pm (dz^2, H)] and the steps) where
    the kernel writes them."""

    def __init__(self, out):
        self.out, self.calls = out, []

    def cnf_k4sc_shape(self, n, widths, B, shape):
        shape[0], shape[1], shape[2], shape[3], shape[4] = 256, 1, 16, 200_000, 0
        self.calls.append(("shape", tuple(widths)))
        return 0

    def cnf_k4s_cond_exact_adjoint(self, *a):
        self.calls.append(("adjoint", len(a)))
        for i, x in zip((7, 8, 9, 10, 11, 12), self.out):
            ctypes.memmove(a[i].value, x.data_ptr(), x.numel() * x.element_size())
        return 0


def test_stream_k4_cond_wrapper_chains_pm_into_the_z_rows(monkeypatch):
    """The streamed K4 adjoint's CUDA branch (`_launch_stream_exact_adjoint`
    with ys), here over a stand-in library that writes the twin's unchained
    outputs: it asks the COND instance's shape and entry, chains g_pm into
    W1's z rows (through W1's z rows) and W2, leaves W1's ys rows as the
    kernel gives them (zero rows of the chained pm), and returns a_ys0
    last: the twin's chained result, bit for bit in the steps, the ys rows
    and a_ys0, at 1e-6 elsewhere."""
    dims = TWO
    dz, H, nc = dims[-1], dims[1], SPLIT[dims][2]
    ps = tcnf.params_from_numpy(_np_params(dims, 36))
    spec = tfs.chain_spec(tcnf.MLP(dims), dz)
    rng = np.random.default_rng(37)
    T = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    ws, bs = [p["w"] for p in ps], [p["b"] for p in ps]
    ys = T(rng.uniform(-1.0, 1.0, (B, nc)))
    kw = dict(rtol=1e-3, atol=1e-6, max_steps=100, ws=ws, bs=bs, norm_z=True, norm_j=True,
              zT=T(rng.normal(size=(B, dz))), accT=T(rng.normal(size=(3, B))),
              azT=T(rng.normal(0.0, 0.1, (B, dz))), aaccT=T(rng.normal(0.0, 0.1, (3, B))),
              t_hi=torch.tensor(1.0), t_lo=torch.tensor(0.0), dt_init=torch.tensor(-0.05), ys=ys)
    ref = tfs.adjoint_train_exact_plain(TSIT5, spec, **kw)
    pm = tfs._exact_pm(spec, ws)
    stage = tfs._exact_adjoint_stage(spec, ws, bs, pm, True, True, kw["aaccT"], ys)
    plain = {k: kw[k] for k in ("rtol", "atol", "max_steps", "zT", "accT", "azT", "aaccT", "t_hi", "t_lo",
                                "dt_init")}
    z0, acc0, az0, blocks, steps, accepted = tfs._adjoint_plain(
        stage, tfs._block_shapes(ws, bs, ys, [pm.shape]), TSIT5, **plain)
    a_ys, w1, w2, b1, b2, g_pm = blocks
    g = torch.cat([w1.reshape(-1), b1, w2.reshape(-1), b2, g_pm.reshape(-1)])
    assert g.numel() == (dz + nc) * H + H + H * dz + dz + dz * dz * H
    stats = torch.tensor([int(steps), int(accepted)], dtype=torch.int32)
    lib = _StandInK4([z0, acc0, az0, a_ys.contiguous(), g, stats])
    monkeypatch.setattr(tfs, "_library", lambda name: lib)
    monkeypatch.setattr(tfs, "_stream", lambda device: ctypes.c_void_p(0))
    got = tfs._launch_stream_exact_adjoint(TSIT5, spec, **kw)
    assert lib.calls == [("shape", dims), ("adjoint", 37)]
    assert len(got) == len(ref) == 8
    assert (int(got[5]), int(got[6])) == (int(ref[5]), int(ref[6]))
    assert torch.equal(got[3][0][dz:], ref[3][0][dz:]) and torch.equal(got[7], ref[7])
    assert torch.equal(got[3][0][dz:], w1[dz:])
    for a, b in zip(got[:3] + tuple(got[3]) + tuple(got[4]), ref[:3] + tuple(ref[3]) + tuple(ref[4])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("net,mode", list(_FORWARDS), ids=[f"{n}-{m}" for n, m in _FORWARDS])
def test_stream_cond_exact_and_chain_test_inference_matches_jax(monkeypatch, net, mode):
    """Exact and TEST `inference` with per-sample ys (the JAX steering draw
    handed over) against the JAX package's fused path (its kernels in
    interpret mode), with the same weights, inputs and ys, the solve through
    the forward wrapper the route names: equal steps or, at a last-step tie
    (`_hold_steps`), the JAX package's own unfused path on the same draws
    taking the port's count; values at 1e-4."""
    calls = []
    name = _FORWARDS[(net, mode)]
    wrapper = getattr(tfs, name)
    monkeypatch.setattr(tfs, name, lambda tab, spec, **kw: calls.append(kw) or wrapper(tab, spec, **kw))
    dims = NETS[net]
    mode_name = MODE_NAMES[mode]
    jicnf, ticnf = _model(cnf, dims, mode), _model(tcnf, dims, mode)
    ps_np = _np_params(dims, 38)
    xs, ys = _data(dims, B, 39)
    key = jax.random.PRNGKey(40)
    lp_r, regs_r, st_r = cnf.inference(jicnf, getattr(cnf.Mode, mode_name), jnp.asarray(xs), _jps(ps_np),
                                       ys=jnp.asarray(ys), key=key)
    extra = {"steer_r": _steer_r(jicnf, key)} if mode == "exact" else {}
    with torch.no_grad():
        lp, regs, st = tcnf.inference(ticnf, getattr(tcnf.Mode, mode_name), xs, tcnf.params_from_numpy(ps_np),
                                      ys=ys, **extra)
    assert len(calls) == 1 and calls[0]["ys"] is not None

    def unfused_steps():
        _, _, st_u = cnf.inference(_model(cnf, dims, mode, fused=False), getattr(cnf.Mode, mode_name),
                                   jnp.asarray(xs), _jps(ps_np), ys=jnp.asarray(ys), key=key)
        return int(st_u.steps)

    _hold_steps(st, st_r, unfused_steps)
    for a, b in ((lp, lp_r), (regs.e, regs_r.e), (regs.n, regs_r.n)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# net -> the wrappers the exact loss and its gradient call, in order
_EXACT_ROUTES = {"two-layer": ["run_stream_cond_exact_solve_kernel", "run_stream_cond_exact_adjoint_kernel"],
                 "hidden130": ["run_stream_cond_exact_solve_kernel", "run_stream_cond_exact_adjoint_kernel"],
                 "three-layer": ["run_stream_cond_exact_solve_kernel"],
                 "cond-miniboone86": ["run_stream_cond_exact_solve_kernel", "run_stream_cond_exact_adjoint_kernel"]}


def _exact_gradients_match_jax(monkeypatch, dims, net, batch, seed):
    """The exact loss and its gradients in the params and in ys through the
    fused solve against `jax.grad` of the JAX package's fused loss, the
    wrappers called recorded: the route `_EXACT_ROUTES[net]` and no
    unconditional instance."""
    called = []
    for name in set(_EXACT_ROUTES["two-layer"]) | set(_UNCONDITIONAL):
        wrapped = getattr(tfs, name)
        monkeypatch.setattr(tfs, name, lambda *a, _n=name, _f=wrapped, **kw: called.append(_n) or _f(*a, **kw))
    jicnf, ticnf = _model(cnf, dims, "exact"), _model(tcnf, dims, "exact")
    full = tfs.make_full_solve(ticnf, tcnf.Mode.TRAIN, batch)
    assert (full.adjoint is not None) == (len(dims) == 3)
    ps_np = _np_params(dims, seed)
    xs, ys = model_data("cond_miniboone86", np.random.default_rng(seed + 1), batch) if dims == COND_MB86 else \
        _data(dims, batch, seed + 1)
    key = jax.random.PRNGKey(seed + 2)
    l_r, (g_r, gy_r) = jax.value_and_grad(
        lambda p, y: cnf.loss(jicnf, cnf.Mode.TRAIN, jnp.asarray(xs), p, ys=y, key=key), argnums=(0, 1)
    )(_jps(ps_np), jnp.asarray(ys))
    ps = tcnf.params_from_numpy(ps_np)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    ys_t = torch.from_numpy(ys).requires_grad_()
    before = _launch_counts()
    l = tcnf.loss(ticnf, tcnf.Mode.TRAIN, xs, ps, ys=ys_t, steer_r=_steer_r(jicnf, key))
    g = torch.autograd.grad(l, leaves + [ys_t])
    assert _launch_counts() == before
    assert called == _EXACT_ROUTES[net]
    np.testing.assert_allclose(float(l.detach()), float(l_r), **GRAD_TOL)
    for a, b in zip(g, _leaves(g_r) + [gy_r]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


@pytest.mark.parametrize("net", list(NETS))
def test_stream_cond_exact_gradients_match_jax_grad(monkeypatch, net):
    """The exact loss and its gradients in the params and in ys (B, n_cond)
    against `jax.grad` of the JAX package's fused loss: the 2-layer nets'
    backward member is the streamed K4 adjoint COND instance's twin, a_ys0
    summed back to ys's shape; the 3-layer chain's gradient runs the plain
    BACKSOLVE behind streamed K7 exact's COND twin, as the JAX package's
    deep exact chains do."""
    _exact_gradients_match_jax(monkeypatch, NETS[net], net, B, 41)


def test_cond_miniboone86_exact_gradient_matches_jax_grad(monkeypatch):
    """The whole slice at full width: cond_miniboone86 (MLP 87 -> 258 -> 86
    on [z | ys], its recipe's data) at B = 8 over tspan (0, 1), its exact
    loss and the gradient in the params and ys through streamed K7 exact's
    and the streamed K4 adjoint's COND twins against `jax.grad` of the JAX
    package's fused loss (its kernels in interpret mode)."""
    _assert_jax_kernels_run(COND_MB86, "exact", batch=8, adjoint=True)
    _exact_gradients_match_jax(monkeypatch, COND_MB86, "cond-miniboone86", 8, 51)


@pytest.mark.parametrize("what", ["logpdf", "sample"])
def test_cond_stream_chain_dist_matches_jax(what):
    """`CondICNFDist(icnf, TEST, ps, ys)` of the conditional 3-layer chain
    past hidden 128 against the JAX package's: `logpdf` and `sample(B)` (the
    JAX base draw injected as `z1`), the TEST solve through streamed K7
    TEST's COND twin."""
    dims = THREE
    jicnf, ticnf = _model(cnf, dims, "test"), _model(tcnf, dims, "test")
    ps_np = _np_params(dims, 44)
    xs, ys = _data(dims, B, 45)
    jd = cnf.CondICNFDist(jicnf, cnf.Mode.TEST, _jps(ps_np), jnp.asarray(ys))
    td = tcnf.CondICNFDist(ticnf, tcnf.Mode.TEST, tcnf.params_from_numpy(ps_np), torch.from_numpy(ys))
    before = _launch_counts()
    if what == "logpdf":
        ref = jd.logpdf(jnp.asarray(xs))
        with torch.no_grad():
            got = td.logpdf(xs)
    else:
        key = jax.random.PRNGKey(46)
        ref = jd.sample(key, B)
        z1 = np.array(jicnf.base_sample(jax.random.split(key, 3)[0], (B,)))
        with torch.no_grad():
            got = td.sample(B, z1=z1)
    assert _launch_counts() == before
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


# name -> (check, dims, n_cond)
_COVERED = {
    "K7-TEST-three-layer": ("chain", THREE, 2),
    "K7-exact-cond-miniboone86": ("chain", COND_MB86, 1),
    "K7-cond-miniboone860": ("chain", (44, 860, 860, 43), 1),
    "K4-adjoint-cond-miniboone86": ("exact", COND_MB86, 1),
    "K4-adjoint-hidden130": ("exact", WIDE_H, 1),
    "K4-adjoint-two-layer": ("exact", TWO, 1),
}


@pytest.mark.parametrize("name", list(_COVERED))
def test_stream_cond_exact_coverage(name):
    """The card's checks take what ROADMAP row (d5) refused: streamed K7's
    COND instances take conditional chains past the wide limits, the
    streamed K4 adjoint's COND instance conditional 2-layer tanh nets
    (`_stream_exact_covers` None, its gradient's offsets counting the ys
    rows); the unconditional instances refuse them, naming the COND
    instance, and the COND instances refuse unconditional nets."""
    check, dims, nc = _COVERED[name]
    spec, bare = _spec(dims, nc), _spec((dims[-1],) + tuple(dims[1:]), 0)
    if check == "chain":
        tfs._cuda_only("streamed K7", _fake_cuda(), TSIT5, spec, chain=True, stream=True, cond=True)
        with pytest.raises(NotImplementedError, match="unconditional instance"):
            tfs._cuda_only("streamed K7", _fake_cuda(), TSIT5, spec, chain=True, stream=True)
        return
    assert tfs._stream_exact_covers(TSIT5, spec) is None
    tfs._cuda_only_stream_exact("the streamed K4 adjoint", _fake_cuda(), TSIT5, spec, cond=True)
    with pytest.raises(NotImplementedError, match="unconditional instance"):
        tfs._cuda_only_stream_exact("the streamed K4 adjoint", _fake_cuda(), TSIT5, spec)
    with pytest.raises(NotImplementedError, match="COND instance"):
        tfs._cuda_only_stream_exact("the streamed K4 adjoint", _fake_cuda(), TSIT5, bare, cond=True)


def test_stream_cond_exact_offset_limit_counts_the_ys_rows():
    """The streamed K4 adjoint's 32-bit gradient offsets count W1's ys rows
    in P: the widest hidden layer an unconditional net of state width 128
    keeps within the limit passes it with one ys column, and the refusal
    names the gradient's size."""
    dz = 128
    H = (tfs.STREAM_MAX_PARAMS - dz) // (2 * dz + 1 + dz * dz)
    kept, past = _spec((dz, H, dz), 0), _spec((dz + 1, H, dz), 1)
    assert tfs._stream_exact_covers(TSIT5, kept) is None
    why = tfs._stream_exact_covers(TSIT5, past)
    assert why is not None and "gradient entries with g_pm" in why


def test_stream_cond_exact_wrappers_run_the_twins_on_the_cpu_without_counting():
    """On CPU tensors the three new COND wrappers run their twins, bit for
    bit (a_ys0 last from the adjoint), and count no launch; they are in
    KERNEL_WRAPPERS under `<source>/test/cond`, `/exact/cond` and `/cond`,
    so `reset_launches` covers them."""
    keys = {tfs.K7S_KERNEL + "/test/cond": "run_stream_cond_test_solve_kernel",
            tfs.K7S_KERNEL + "/exact/cond": "run_stream_cond_exact_solve_kernel",
            tfs.K4SA_KERNEL + "/cond": "run_stream_cond_exact_adjoint_kernel"}
    assert all(tfs.KERNEL_WRAPPERS[k] is getattr(tfs, n) for k, n in keys.items())
    spec = tfs.chain_spec(tcnf.MLP(TWO), 66)
    ps = tcnf.params_from_numpy(_np_params(TWO, 24))
    rng = np.random.default_rng(25)
    T = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    ys = T(rng.uniform(-1.0, 1.0, (8, 1)))
    base = dict(rtol=1e-3, atol=1e-6, max_steps=100, ws=[p["w"] for p in ps], bs=[p["b"] for p in ps], ys=ys)
    tfs.reset_launches()
    fwd_kw = dict(base, z0=T(rng.normal(size=(8, 66))), t0=torch.tensor(0.0), t1=torch.tensor(1.0),
                  dt_init=torch.tensor(0.05))
    test_kw = dict(fwd_kw, dlogp0=T(rng.normal(size=8)))
    ref = tfs.solve_test_plain(TSIT5, spec, **test_kw)
    assert all(torch.equal(a, b) for a, b in zip(tfs.run_stream_cond_test_solve_kernel(TSIT5, spec, **test_kw), ref))
    exact = dict(fwd_kw, norm_z=True, norm_j=True, acc0=T(rng.normal(size=(3, 8))))
    fwd = tfs.solve_train_exact_plain(TSIT5, spec, **exact)
    assert all(torch.equal(a, b) for a, b in zip(tfs.run_stream_cond_exact_solve_kernel(TSIT5, spec, **exact), fwd))
    adj = dict(base, norm_z=True, norm_j=True, zT=fwd[0], accT=fwd[1], azT=T(rng.normal(size=(8, 66))),
               aaccT=T(rng.normal(size=(3, 8))), t_hi=torch.tensor(1.0), t_lo=torch.tensor(0.0),
               dt_init=torch.tensor(-0.05))
    got = tfs.run_stream_cond_exact_adjoint_kernel(TSIT5, spec, **adj)
    want = tfs.adjoint_train_exact_plain(TSIT5, spec, **adj)
    assert len(got) == len(want) == 8
    assert all(torch.equal(a, b) for a, b in zip(got[:3] + got[5:], want[:3] + want[5:]))
    assert all(torch.equal(a, b) for a, b in zip(got[3] + got[4], want[3] + want[4]))
    assert all(w.launches == 0 for w in tfs.KERNEL_WRAPPERS.values())


def test_stream_cond_exact_fit_on_cpu():
    """`fit(CondICNFModel(...), X, Y)` under exact trace on the conditional
    2-layer net past state width 64, two Lion steps at B = 16 in one epoch: finite
    losses, moving parameters, and no kernel launched on the CPU."""
    ps_np = _np_params(TWO, 47)
    X, Y = _data(TWO, 2 * B, 48)
    before = _launch_counts()
    model = tcnf.CondICNFModel(_model(tcnf, TWO, "exact"), n_epochs=1, batch_size=B)
    res = tcnf.fit(model, X, Y, ps=tcnf.params_from_numpy(ps_np), seed=0)
    assert _launch_counts() == before
    assert res.epochs == 1 and len(res.losses) >= 1 and np.isfinite(res.losses).all()
    moved = [float((a - torch.from_numpy(b)).abs().max()) for a, b in zip(_leaves(res.ps), _leaves(ps_np))]
    assert min(moved) > 0.0
