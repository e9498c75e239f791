"""K-probe and forward-mode (JVP) Hutchinson training at the wide chain
widths (K6 in the wide forms) against the JAX package on the CPU: the plain
twins of the wide K1 and K2 chain forms' probe instances, through the fused
solve on CPU tensors, against the JAX package's forward and adjoint kernels
in interpret mode at a 2-layer chain of state width 40 and at the tabular
MINIBOONE model (RNODE, MLP 43 -> 128 -> 128 -> 43, benchmarks/tabular.py:58);
TRAIN `inference`, the loss and its gradients under `VecJacMode(3,
fused=True)` and `JacVecMode(2, fused=True)` against `jax.grad`; the
coverage rule with probes; the fused solve handing every probe plane and the
direction to the wide wrappers; and `fit` with two probes.

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
from continuousnf_tpu_torch.utils.configs import MODELS, glorot_params, model_data

# The port's entry points default to the CUDA card; these tests run it on the CPU.
tcnf.set_default_device("cpu")

tfit = importlib.import_module("continuousnf_tpu_torch.train.fit")

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
MINIBOONE = MODELS["miniboone43"]["dims"]
B = 16
# name -> the chain's widths (state width first and last)
NETS = {"dz40": (40, 48, 40), "miniboone": MINIBOONE}
# name -> (K, jvp)
PROBES = {"vjp-K3": (3, False), "jvp-K2": (2, True)}


def _mode(m, k, jvp, fused=True):
    return (m.JacVecMode if jvp else m.VecJacMode)(k, fused=fused)


def _model(m, dims, k, jvp, fused=True, **kw):
    return m.construct(m.RNODE, m.MLP(dims), dims[-1], 0, compute_mode=_mode(m, k, jvp, fused), **kw)


def _np_params(dims, seed):
    return glorot_params(np.random.default_rng(seed), dims)


def _data(dims, n, seed):
    if dims == MINIBOONE:
        return model_data("miniboone43", np.random.default_rng(seed), n)
    return np.random.default_rng(seed).normal(size=(n, dims[-1])).astype(np.float32)


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


@pytest.mark.parametrize("probes", list(PROBES))
@pytest.mark.parametrize("net", list(NETS))
def test_wide_probe_twins_match_jax_kernels(net, probes):
    """The wide K1 and K2 chain forms' plain versions with K probes, VJP or
    JVP, through the fused solve on CPU tensors, against the JAX package's
    forward kernel (from zero accumulators: it starts its own at zero) and
    adjoint kernel in interpret mode, the adjoint from the forward's output
    with its last step as the warm start: equal attempted and accepted
    steps, values at 1e-4, no kernel launched."""
    dims, (k, jvp) = NETS[net], PROBES[probes]
    dz = dims[-1]
    spec = tfs.chain_spec(tcnf.MLP(dims), dz)
    assert tfs._wide_chain(spec) and tfs._kernel_covers(TSIT5, spec, k, chain=True, jvp=jvp) is None
    ps_np = _np_params(dims, 1)
    rng = np.random.default_rng(2)
    xs = _data(dims, B, 3)
    eps = rng.normal(size=(k, B, dz)).astype(np.float32)
    y0f = np.concatenate([xs.ravel(), np.zeros(3 * B)]).astype(np.float32)
    jfull = jfs.make_full_solve(_model(cnf, dims, k, jvp), cnf.Mode.TRAIN, B)
    jargs = {"ps": _jps(ps_np), "eps": jnp.asarray(eps), "ys": None}
    yT_r, fst_r = jfull.forward(jnp.asarray(y0f), 0.0, 1.0, jargs)
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
    assert (int(st.steps), int(st.accepted), int(st.nfe)) == (int(st_r.steps), int(st_r.accepted), int(st_r.nfe))
    np.testing.assert_allclose(y0.numpy(), np.asarray(y0_r), **TOL)
    np.testing.assert_allclose(ay0.numpy(), np.asarray(ay0_r), **TOL)
    for a, b in zip(_leaves(gargs["ps"]), _leaves(gargs_r["ps"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert torch.equal(gargs["eps"], torch.zeros_like(targs["eps"]))


@pytest.mark.parametrize("probes", list(PROBES))
def test_wide_probe_gradients_match_jax_grad(probes):
    """TRAIN `inference`, the MINIBOONE loss and its gradients through the
    fused BACKSOLVE (the wide K1 and K2 chain forms' probe twins) against
    the JAX package's fused path and `jax.grad` of its loss, with its probe
    draws fed in."""
    k, jvp = PROBES[probes]
    jicnf, ticnf = _model(cnf, MINIBOONE, k, jvp), _model(tcnf, MINIBOONE, k, jvp)
    ps_np = _np_params(MINIBOONE, 11)
    xs = _data(MINIBOONE, B, 12)
    key = jax.random.PRNGKey(13)
    lp_r, regs_r, st_r = cnf.inference(jicnf, cnf.Mode.TRAIN, jnp.asarray(xs), _jps(ps_np), key=key)
    eps = _jax_eps(jicnf, key, B)
    assert eps.shape == (k, B, MINIBOONE[-1])
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


def _spec(dims, n_cond=0):
    n = len(dims) - 1
    ins = (dims[0] + n_cond,) + tuple(dims[1:-1])
    return tfs.ChainSpec(ins, tuple(dims[1:]), (True,) * n, n_cond)


_COVERED = {"miniboone": MINIBOONE, "dz64-hidden128": (64, 128, 128, 64), "two-layer-chain-dz40": (40, 48, 40)}
_PROBE_CONFIGS = {"K2": (2, False), "K4": (4, False), "K8": (8, False), "jvp-K1": (1, True), "jvp-K2": (2, True)}


@pytest.mark.parametrize("probes", list(_PROBE_CONFIGS))
@pytest.mark.parametrize("name", list(_COVERED))
def test_wide_forms_cover_probes(name, probes):
    """The chain kernels' wide forms take K VJP probes and JVP probes (K6 in
    the wide forms) at the wide widths."""
    k, jvp = _PROBE_CONFIGS[probes]
    spec = _spec(_COVERED[name])
    assert tfs._wide_chain(spec)
    assert tfs._kernel_covers(TSIT5, spec, k, chain=True, jvp=jvp) is None


@pytest.mark.parametrize("probes", list(_PROBE_CONFIGS))
def test_conditional_wide_chains_with_probes_stay_refused(probes):
    """A conditional wide chain that the wide probe COND instances keep
    (MINIBOONE with two ys columns) runs them with probes (K6 x K8); one
    whose probe COND instance's shared memory it passes, though the
    one-probe COND instance keeps it, runs the streamed probe COND
    instances with probes (row (d6)), and the wide forms alone still refuse
    it, naming shared memory and its ROADMAP row."""
    k, jvp = _PROBE_CONFIGS[probes]
    assert tfs._kernel_covers(TSIT5, _spec(MINIBOONE, 2), k, chain=True, jvp=jvp) is None
    spec = _spec((64, 128, 128, 120, 64), 1)
    assert tfs._kernel_covers(TSIT5, spec, chain=True) is None and not tfs._stream_chain(spec)
    assert tfs._kernel_covers(TSIT5, spec, k, chain=True, jvp=jvp) is None and tfs._stream_chain(spec, True)
    msg = tfs._kernel_covers(TSIT5, spec, k, chain=True, jvp=jvp, stream=False)
    assert "shared memory" in msg and "ROADMAP queue 2" in msg


def test_probe_instance_shared_memory_rule():
    """The wide K2 probe instance keeps one more dz-vector and hidden block a
    row than the one-probe instance: a chain whose weights leave room for the
    one-probe tile of 4 samples but not for the probe instance's is covered
    by the wide forms with one VJP probe, and with K probes or JVP refused
    by the wide forms, naming shared memory, and taken by the streamed
    forms' probe instances; MINIBOONE fits both with room to spare."""
    spec = _spec((64, 128, 128, 120, 64))
    assert tfs._kernel_covers(TSIT5, spec, 1, chain=True) is None and not tfs._stream_chain(spec)
    for k, jvp in ((2, False), (1, True)):
        msg = tfs._kernel_covers(TSIT5, spec, k, chain=True, jvp=jvp, stream=False)
        assert msg is not None and "shared memory" in msg and "ROADMAP queue 2" in msg
        assert tfs._kernel_covers(TSIT5, spec, k, chain=True, jvp=jvp) is None
    assert tfs._stream_chain(spec, True)
    mb = _spec(MINIBOONE)
    assert 4 * tfs._wide_smem_floats(mb) < 4 * tfs._wide_smem_floats(mb, True) <= tfs.WIDE_SMEM_BYTES


@pytest.mark.parametrize("probes", list(PROBES))
def test_fused_solve_hands_every_probe_to_the_wide_wrappers(monkeypatch, probes):
    """`make_full_solve` runs a 3-layer chain past the narrow widths through
    the wide wrappers with all K probe planes and the direction, forward and
    backward."""
    k, jvp = PROBES[probes]
    calls = []
    for name in ("run_wide_train_solve_kernel", "run_wide_adjoint_kernel"):
        wrapped = getattr(tfs, name)

        def spy(*a, _n=name, _f=wrapped, **kw):
            calls.append((_n, tuple(kw["eps"].shape), kw["jvp"]))
            return _f(*a, **kw)

        monkeypatch.setattr(tfs, name, spy)
    dims = (5, 66, 7, 5)
    icnf = _model(tcnf, dims, k, jvp)
    ps = tcnf.params_from_numpy(_np_params(dims, 21))
    xs = np.random.default_rng(22).normal(size=(8, 5)).astype(np.float32)
    eps = np.random.default_rng(23).normal(size=(k, 8, 5)).astype(np.float32)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    torch.autograd.grad(tcnf.loss(icnf, tcnf.Mode.TRAIN, xs, ps, eps=eps), leaves)
    assert calls == [("run_wide_train_solve_kernel", (k, 8, 5), jvp), ("run_wide_adjoint_kernel", (k, 8, 5), jvp)]


def test_wide_wrappers_run_the_twins_on_the_cpu_without_counting():
    """On CPU tensors the wide Hutchinson wrappers run their twins with K
    probes and JVP, bit for bit, and count no launch; both are among the
    probe wrappers whose probe launches `reset_launches` clears."""
    assert {tfs.run_wide_train_solve_kernel, tfs.run_wide_adjoint_kernel} <= set(tfs.PROBE_WRAPPERS)
    dims = (40, 48, 36, 40)
    spec = tfs.chain_spec(tcnf.MLP(dims), 40)
    ps = tcnf.params_from_numpy(_np_params(dims, 24))
    rng = np.random.default_rng(25)
    T = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    kw = dict(norm_z=True, norm_j=True, rtol=1e-3, atol=1e-6, max_steps=100, ws=[p["w"] for p in ps],
              bs=[p["b"] for p in ps], z0=T(rng.normal(size=(8, 40))), eps=T(rng.normal(size=(3, 8, 40))),
              acc0=T(rng.normal(size=(3, 8))), t0=torch.tensor(0.0), t1=torch.tensor(1.0),
              dt_init=torch.tensor(0.05), jvp=True)
    tfs.reset_launches()
    got = tfs.run_wide_train_solve_kernel(TSIT5, spec, **kw)
    ref = tfs.solve_train_plain(TSIT5, spec, **kw)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    adj = {k: kw[k] for k in ("norm_z", "norm_j", "rtol", "atol", "max_steps", "ws", "bs", "eps", "jvp")}
    adj.update(zT=got[0], accT=got[1], azT=T(rng.normal(size=(8, 40))), aaccT=T(rng.normal(size=(3, 8))),
               t_hi=torch.tensor(1.0), t_lo=torch.tensor(0.0), dt_init=torch.tensor(-0.05))
    got = tfs.run_wide_adjoint_kernel(TSIT5, spec, **adj)
    ref = tfs.adjoint_train_plain(TSIT5, spec, **adj)
    for a, b in zip(got[:3] + got[5:], ref[:3] + ref[5:]):
        assert torch.equal(a, b)
    for a, b in zip(got[3] + got[4], ref[3] + ref[4]):
        assert torch.equal(a, b)
    assert all(w.launches == 0 and w.probe_launches == {} for w in tfs.PROBE_WRAPPERS)


@pytest.mark.parametrize("ad", ["vjp", "jvp"])
def test_fit_two_lion_steps_with_two_probes_at_miniboone(monkeypatch, ad):
    """`fit` at the MINIBOONE widths with two probes for two Lion steps (the
    fused path: the wide probe twins on the CPU): each step's weighted loss
    equals the JAX package's `loss` on the same batch, params and probes,
    and no kernel is launched."""
    jvp = ad == "jvp"
    ps_np = _np_params(MINIBOONE, 26)
    X = _data(MINIBOONE, 2 * B, 27)
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
    icnf = _model(tcnf, MINIBOONE, 2, jvp)
    before = _launch_counts()
    res = tcnf.fit(tcnf.ICNFModel(icnf, n_epochs=1, batch_size=B), X, ps=tcnf.params_from_numpy(ps_np), seed=4)
    assert _launch_counts() == before
    assert len(records) == 2 and np.isfinite(res.losses).all()
    for ps_k, xb, wb, gen_state, loss_k in records:
        eps = icnf.draw_eps(torch.Generator().set_state(gen_state), B).numpy()
        assert eps.shape == (2, B, MINIBOONE[-1])
        ref = cnf.loss(_model(cnf, MINIBOONE, 2, jvp), cnf.Mode.TRAIN, jnp.asarray(xb), _jps(tuple(ps_k)),
                       key=jax.random.PRNGKey(0), weights=jnp.asarray(wb), eps=jnp.asarray(eps))
        np.testing.assert_allclose(loss_k, float(ref), **TOL)
    assert not np.array_equal(records[0][0][0]["w"], records[1][0][0]["w"])
