"""K-probe and forward-mode (JVP) Hutchinson training past the wide limits
(K6 in the streamed forms) against the JAX package on the CPU: the plain
twins of the streamed K1 and K2 chain forms' probe instances, through the
fused solve on CPU tensors, against the JAX package's forward and adjoint
kernels in interpret mode at three nets: a 3-layer chain streamed for its
hidden width, `MLP((6, 160, 160, 6))`; a 2-layer net streamed for its state
width, `MLP((72, 80, 72))`; and a 4-layer chain that the wide forms keep
with one probe but whose probe instance passes a block's shared memory,
`MLP((64, 128, 128, 120, 64))`, so that only the streamed probe instances
take it with K probes.  The JAX package's `make_full_solve` takes all three
at B = 8 with these probes, so every twin is held against its kernels (no
`fused=False` stand-in).  Also TRAIN `inference`, the loss and its gradients
under `VecJacMode(2, fused=True)` and `JacVecMode(2, fused=True)` against
`jax.grad`; the coverage rule with probes at miniboone860, miniboone86 and
bsds126 and its refusals; the fused solve handing every probe plane and the
direction to the streamed wrappers; the wrappers' CPU branch; and `fit`
with two probes.

Inputs come from numpy seeds; the JAX probe draws are reproduced from its
key split (`core/icnf.py:485`) and handed to the port."""

import importlib

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
from continuousnf_tpu_torch.utils.configs import MODELS, glorot_params, tabular_data

# The port's entry points default to the CUDA card; these tests run it on the CPU.
tcnf.set_default_device("cpu")

tfit = importlib.import_module("continuousnf_tpu_torch.train.fit")

# The twins against the JAX kernels: f32 sums in another order.
TOL = dict(rtol=1e-4, atol=1e-4)
# Losses and gradients against jax.grad.
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
B = 8
PROBE_ONLY = (64, 128, 128, 120, 64)
# name -> the chain's widths (state width first and last)
NETS = {"hidden160": (6, 160, 160, 6), "dz72": (72, 80, 72), "probe-only": PROBE_ONLY}
# name -> (K, jvp)
PROBES = {"vjp-K3": (3, False), "jvp-K2": (2, True)}


def _mode(m, k, jvp, fused=True):
    return (m.JacVecMode if jvp else m.VecJacMode)(k, fused=fused)


def _model(m, dims, k, jvp, fused=True, **kw):
    """The tabular family of benchmarks/tabular.py:69 at these widths: RNODE,
    nvars = dims[0], no augmentation, tspan (0, 1)."""
    return m.construct(m.RNODE, m.MLP(dims), dims[-1], 0, compute_mode=_mode(m, k, jvp, fused), **kw)


def _np_params(dims, seed):
    return glorot_params(np.random.default_rng(seed), dims)


def _data(dims, n, seed):
    return tabular_data(np.random.default_rng(seed), n, dims[0])


def _jps(ps_np):
    return jax.tree.map(jnp.asarray, ps_np)


def _leaves(ps):
    return [p[k] for p in ps for k in ("w", "b")]


def _launch_counts():
    return {name: w.launches for name, w in tfs.KERNEL_WRAPPERS.items()}


def _jax_eps(icnf, key, batch):
    """The probes JAX `inference` draws from `key`."""
    eps_key, _ = jax.random.split(key)
    return np.array(icnf.draw_eps(eps_key, batch))


def _spec(dims, n_cond=0):
    n = len(dims) - 1
    ins = (dims[0] + n_cond,) + tuple(dims[1:-1])
    return tfs.ChainSpec(ins, tuple(dims[1:]), (True,) * n, n_cond)


@pytest.mark.parametrize("probes", list(PROBES))
@pytest.mark.parametrize("net", list(NETS))
def test_stream_probe_twins_match_jax_kernels(monkeypatch, net, probes):
    """The streamed K1 and K2 chain forms' plain versions with K probes, VJP
    or JVP, through the fused solve on CPU tensors (which hands them to the
    streamed wrappers), against the JAX package's forward kernel (from zero
    accumulators) and adjoint kernel in interpret mode, the adjoint from the
    forward's output with its last step as the warm start: equal attempted
    and accepted steps, values at TOL, no kernel launched."""
    dims, (k, jvp) = NETS[net], PROBES[probes]
    dz = dims[-1]
    spec = tfs.chain_spec(tcnf.MLP(dims), dz)
    assert tfs._stream_chain(spec, True) and tfs._kernel_covers(TSIT5, spec, k, chain=True, jvp=jvp) is None
    ps_np = _np_params(dims, 1)
    rng = np.random.default_rng(2)
    xs = _data(dims, B, 3)
    eps = rng.normal(size=(k, B, dz)).astype(np.float32)
    y0f = np.concatenate([xs.ravel(), np.zeros(3 * B)]).astype(np.float32)
    jfull = jfs.make_full_solve(_model(cnf, dims, k, jvp), cnf.Mode.TRAIN, B)
    assert jfull is not None
    jargs = {"ps": _jps(ps_np), "eps": jnp.asarray(eps), "ys": None}
    yT_r, fst_r = jfull.forward(jnp.asarray(y0f), 0.0, 1.0, jargs)
    calls = []
    for name in ("run_stream_train_solve_kernel", "run_stream_adjoint_kernel"):
        wrapped = getattr(tfs, name)
        monkeypatch.setattr(tfs, name, lambda *a, _n=name, _f=wrapped, **kw: calls.append(_n) or _f(*a, **kw))
    tfull = tfs.make_full_solve(_model(tcnf, dims, k, jvp), tcnf.Mode.TRAIN, B)
    targs = {"ps": tcnf.params_from_numpy(ps_np), "eps": torch.from_numpy(eps), "ys": None}
    before = _launch_counts()
    with torch.no_grad():
        yT, fst = tfull.forward(torch.from_numpy(y0f), torch.tensor(0.0), torch.tensor(1.0), targs)
    assert (int(fst.steps), int(fst.accepted), int(fst.nfe)) == (int(fst_r.steps), int(fst_r.accepted),
                                                                 int(fst_r.nfe))
    np.testing.assert_allclose(yT.numpy(), np.asarray(yT_r), **TOL)

    g_yf = np.concatenate(
        [rng.normal(0.0, 0.1, B * dz), np.full(B, 1.0 / B), np.full(2 * B, 1e-2 / B)]
    ).astype(np.float32)
    dt_warm = float(fst_r.dt_last)
    y0_r, ay0_r, gargs_r, st_r = jfull.adjoint(yT_r, jnp.asarray(g_yf), jargs, 1.0, 0.0, dt_warm=dt_warm)
    y0, ay0, gargs, st = tfull.adjoint(torch.from_numpy(np.array(yT_r)), torch.from_numpy(g_yf), targs,
                                       torch.tensor(1.0), torch.tensor(0.0), dt_warm=dt_warm)
    assert _launch_counts() == before
    assert calls == ["run_stream_train_solve_kernel", "run_stream_adjoint_kernel"]
    assert (int(st.steps), int(st.accepted), int(st.nfe)) == (int(st_r.steps), int(st_r.accepted), int(st_r.nfe))
    np.testing.assert_allclose(y0.numpy(), np.asarray(y0_r), **TOL)
    np.testing.assert_allclose(ay0.numpy(), np.asarray(ay0_r), **TOL)
    for a, b in zip(_leaves(gargs["ps"]), _leaves(gargs_r["ps"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert torch.equal(gargs["eps"], torch.zeros_like(targs["eps"]))


@pytest.mark.parametrize("probes", ["vjp-K2", "jvp-K2"])
def test_stream_probe_gradients_match_jax_grad(probes):
    """TRAIN `inference`, the loss and its gradients through the fused
    BACKSOLVE (the streamed probe twins) at a net streamed for its state
    width, `MLP((72, 80, 72))`, with two VJP or two JVP probes, against the
    JAX package's fused path and `jax.grad` of its loss, with its probe
    draws fed in."""
    jvp = probes.startswith("jvp")
    dims = NETS["dz72"]
    jicnf, ticnf = _model(cnf, dims, 2, jvp), _model(tcnf, dims, 2, jvp)
    ps_np = _np_params(dims, 11)
    xs = _data(dims, B, 12)
    key = jax.random.PRNGKey(13)
    lp_r, regs_r, st_r = cnf.inference(jicnf, cnf.Mode.TRAIN, jnp.asarray(xs), _jps(ps_np), key=key)
    eps = _jax_eps(jicnf, key, B)
    assert eps.shape == (2, B, dims[-1])
    with torch.no_grad():
        lp, regs, st = tcnf.inference(ticnf, tcnf.Mode.TRAIN, xs, tcnf.params_from_numpy(ps_np), eps=eps)
    assert (int(st.steps), int(st.accepted), int(st.nfe)) == (int(st_r.steps), int(st_r.accepted), int(st_r.nfe))
    for a, b in ((lp, lp_r), (regs.e, regs_r.e), (regs.n, regs_r.n)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)

    l_r, g_r = jax.value_and_grad(lambda p: cnf.loss(jicnf, cnf.Mode.TRAIN, jnp.asarray(xs), p, key=key))(_jps(ps_np))
    ps = tcnf.params_from_numpy(ps_np)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    l = tcnf.loss(ticnf, tcnf.Mode.TRAIN, xs, ps, eps=eps)
    g = torch.autograd.grad(l, leaves)
    np.testing.assert_allclose(float(l.detach()), float(l_r), **GRAD_TOL)
    for a, b in zip(g, _leaves(g_r)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


_PROBE_CONFIGS = {"K2": (2, False), "K4": (4, False), "jvp": (1, True)}


@pytest.mark.parametrize("probes", list(_PROBE_CONFIGS))
@pytest.mark.parametrize("model", ["miniboone860", "miniboone86", "bsds126"])
def test_stream_forms_cover_probes_at_the_configurations(model, probes):
    """The streamed chain forms take K VJP probes and JVP probes at
    miniboone860, miniboone86 and bsds126, whose chains only they run; the
    wide forms refuse them."""
    k, jvp = _PROBE_CONFIGS[probes]
    spec = _spec(MODELS[model]["dims"])
    assert tfs._stream_chain(spec) and tfs._stream_chain(spec, True)
    assert tfs._kernel_covers(TSIT5, spec, k, chain=True, jvp=jvp) is None
    assert tfs._kernel_covers(TSIT5, spec, k, chain=True, jvp=jvp, stream=False) is not None


# name -> (dims, n_cond, what the refusal names)
_REFUSED = {
    "conditional": ((129, 387, 129), 1, "state width 129 > 128"),
    "dz129": ((129, 387, 129), 0, "state width 129 > 128"),
    "five-layer": ((43,) + (860,) * 8 + (43,), 0, "9-layer chains"),
}


@pytest.mark.parametrize("probes", ["K2", "jvp"])
@pytest.mark.parametrize("name", list(_REFUSED))
def test_stream_probe_refusals_name_their_roadmap_row(name, probes):
    """With K probes or JVP, state widths past 128, of conditional chains
    too (the streamed probe COND instances take conditional chains up to
    128: tests/test_torch_stream_cond_probes.py), and chains past 8 layers
    (5-layer chains run since shape variants (b): the "five-layer" case
    holds a 9-layer chain) are still refused, with the reason and its
    ROADMAP queue 2 row."""
    k, jvp = _PROBE_CONFIGS[probes]
    dims, n_cond, why = _REFUSED[name]
    msg = tfs._kernel_covers(TSIT5, _spec(dims, n_cond), k, chain=True, jvp=jvp)
    assert msg is not None and why in msg and "ROADMAP queue 2" in msg


@pytest.mark.parametrize("dims", [PROBE_ONLY, (60, 128, 128, 128, 60)], ids=["dz64-out120", "dz60-hidden128"])
def test_probe_only_chains_stream_with_probes(dims):
    """A chain whose weights leave room for the wide forms' one-probe tile
    but not for their probe instance's runs the wide forms with one probe and
    the streamed probe instances with K probes or JVP (`_stream_chain(spec,
    probes=True)`)."""
    spec = _spec(dims)
    assert tfs._wide_chain(spec) and not tfs._stream_chain(spec) and tfs._stream_chain(spec, probes=True)
    assert tfs._kernel_covers(TSIT5, spec, chain=True, stream=False) is None
    assert "shared memory" in tfs._kernel_covers(TSIT5, spec, 2, chain=True, stream=False)


# name -> (dims, K, jvp, the wrappers the fused solve calls)
_ROUTES = {
    "stream-K3": ((5, 160, 7, 5), 3, False, ("run_stream_train_solve_kernel", "run_stream_adjoint_kernel")),
    "stream-jvp-K2": ((5, 160, 7, 5), 2, True, ("run_stream_train_solve_kernel", "run_stream_adjoint_kernel")),
    "probe-only-K2": (PROBE_ONLY, 2, False, ("run_stream_train_solve_kernel", "run_stream_adjoint_kernel")),
    "probe-only-jvp": (PROBE_ONLY, 1, True, ("run_stream_train_solve_kernel", "run_stream_adjoint_kernel")),
    "probe-only-one-probe": (PROBE_ONLY, 1, False, ("run_wide_train_solve_kernel", "run_wide_adjoint_kernel")),
}
_WRAPPERS = ("run_stream_train_solve_kernel", "run_stream_adjoint_kernel", "run_wide_train_solve_kernel",
             "run_wide_adjoint_kernel")


@pytest.mark.parametrize("route", list(_ROUTES))
def test_fused_solve_hands_every_probe_to_the_streamed_wrappers(monkeypatch, route):
    """`make_full_solve` runs a streamed chain's K-probe or JVP Hutchinson
    solves through the streamed wrappers with all K probe planes and the
    direction, forward and backward; a chain that only the streamed probe
    instances keep goes there with probes and stays on the wide forms with
    one probe."""
    dims, k, jvp, want = _ROUTES[route]
    calls = []
    for name in _WRAPPERS:
        wrapped = getattr(tfs, name)

        def spy(*a, _n=name, _f=wrapped, **kw):
            calls.append((_n, tuple(kw["eps"].shape), kw["jvp"]))
            return _f(*a, **kw)

        monkeypatch.setattr(tfs, name, spy)
    dz = dims[-1]
    icnf = _model(tcnf, dims, k, jvp)
    ps = tcnf.params_from_numpy(_np_params(dims, 21))
    xs = np.random.default_rng(22).normal(size=(4, dz)).astype(np.float32)
    eps = np.random.default_rng(23).normal(size=(k, 4, dz)).astype(np.float32)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    torch.autograd.grad(tcnf.loss(icnf, tcnf.Mode.TRAIN, xs, ps, eps=eps), leaves)
    assert calls == [(want[0], (k, 4, dz), jvp), (want[1], (k, 4, dz), jvp)]


def test_stream_wrappers_run_the_twins_on_the_cpu_without_counting():
    """On CPU tensors the streamed Hutchinson wrappers run their twins with
    K probes and JVP, bit for bit, and count no launch; both are among the
    probe wrappers whose probe launches `reset_launches` clears."""
    assert {tfs.run_stream_train_solve_kernel, tfs.run_stream_adjoint_kernel} <= set(tfs.PROBE_WRAPPERS)
    dims = NETS["hidden160"]
    spec = tfs.chain_spec(tcnf.MLP(dims), 6)
    ps = tcnf.params_from_numpy(_np_params(dims, 24))
    rng = np.random.default_rng(25)
    T = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    kw = dict(norm_z=True, norm_j=True, rtol=1e-3, atol=1e-6, max_steps=100, ws=[p["w"] for p in ps],
              bs=[p["b"] for p in ps], z0=T(rng.normal(size=(4, 6))), eps=T(rng.normal(size=(3, 4, 6))),
              acc0=T(rng.normal(size=(3, 4))), t0=torch.tensor(0.0), t1=torch.tensor(1.0),
              dt_init=torch.tensor(0.05), jvp=True)
    tfs.reset_launches()
    got = tfs.run_stream_train_solve_kernel(TSIT5, spec, **kw)
    ref = tfs.solve_train_plain(TSIT5, spec, **kw)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    adj = {k: kw[k] for k in ("norm_z", "norm_j", "rtol", "atol", "max_steps", "ws", "bs", "eps", "jvp")}
    adj.update(zT=got[0], accT=got[1], azT=T(rng.normal(size=(4, 6))), aaccT=T(rng.normal(size=(3, 4))),
               t_hi=torch.tensor(1.0), t_lo=torch.tensor(0.0), dt_init=torch.tensor(-0.05))
    got = tfs.run_stream_adjoint_kernel(TSIT5, spec, **adj)
    ref = tfs.adjoint_train_plain(TSIT5, spec, **adj)
    for a, b in zip(got[:3] + got[5:], ref[:3] + ref[5:]):
        assert torch.equal(a, b)
    for a, b in zip(got[3] + got[4], ref[3] + ref[4]):
        assert torch.equal(a, b)
    assert all(w.launches == 0 and w.probe_launches == {} for w in tfs.PROBE_WRAPPERS)


@pytest.mark.parametrize("ad", ["vjp", "jvp"])
def test_fit_two_lion_steps_with_two_probes_past_the_wide_limits(monkeypatch, ad):
    """`fit` at a net streamed for its state width, `MLP((72, 80, 72))`,
    with two probes for two Lion steps (the fused path: the streamed probe
    twins on the CPU): each step's weighted loss equals the JAX package's
    `loss` on the same batch, params and probes, and no kernel is
    launched."""
    jvp = ad == "jvp"
    dims = NETS["dz72"]
    ps_np = _np_params(dims, 26)
    X = _data(dims, 2 * B, 27)
    records = []
    body = tfit.make_train_step_body

    def spy(icnf, optimizer, mesh=None):
        step = body(icnf, optimizer, mesh)

        def wrapped(ps, xs, generator=None, weights=None, **kw):
            record = ([{k: v.detach().numpy().copy() for k, v in p.items()} for p in ps],
                      xs.numpy().copy(), weights.numpy().copy(), generator.get_state())
            m = step(ps, xs, generator, weights=weights, **kw)
            records.append(record + (float(m["loss"]),))
            return m

        return wrapped

    monkeypatch.setattr(tfit, "make_train_step_body", spy)
    icnf = _model(tcnf, dims, 2, jvp)
    before = _launch_counts()
    res = tcnf.fit(tcnf.ICNFModel(icnf, n_epochs=1, batch_size=B), X, ps=tcnf.params_from_numpy(ps_np), seed=4)
    assert _launch_counts() == before
    assert len(records) == 2 and np.isfinite(res.losses).all()
    for ps_k, xb, wb, gen_state, loss_k in records:
        eps = icnf.draw_eps(torch.Generator().set_state(gen_state), B).numpy()
        assert eps.shape == (2, B, dims[-1])
        ref = cnf.loss(_model(cnf, dims, 2, jvp), cnf.Mode.TRAIN, jnp.asarray(xb), _jps(tuple(ps_k)),
                       key=jax.random.PRNGKey(0), weights=jnp.asarray(wb), eps=jnp.asarray(eps))
        np.testing.assert_allclose(loss_k, float(ref), **TOL)
    assert not np.array_equal(records[0][0][0]["w"], records[1][0][0]["w"])
