"""K-probe and forward-mode (JVP) Hutchinson training in the port (K6)
against the JAX package on the CPU: the fused stages `_stage_train` and
`_stage_train_fwdbwd` with K probes and JVP (the math of the K1 and K2
kernels and their chain forms) against the JAX package's, the plain JVP
field, the plain twins of K1 and K2 against the JAX package's megakernel run
in Pallas interpret mode, TRAIN inference and loss gradients under
`JacVecMode` and `VecJacMode(num_probes=3, fused=True)` against `jax.grad`,
and `fit` with two probes.  The JAX package's probe draws are fed in via
`eps=`."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import continuousnf_tpu as cnf
import continuousnf_tpu_torch as tcnf
from continuousnf_tpu.core.dynamics import TrainState as JTrainState
from continuousnf_tpu.core.dynamics import make_augmented_dynamics as jdyn
from continuousnf_tpu.ops import fused_solve as jfs
from continuousnf_tpu_torch.core.dynamics import TrainState as TTrainState
from continuousnf_tpu_torch.core.dynamics import make_augmented_dynamics as tdyn
from continuousnf_tpu_torch.ode.tableaus import TSIT5
from continuousnf_tpu_torch.ops import fused_solve as tfs

# The port's entry points default to the CUDA card; these tests run it on the CPU.
tcnf.set_default_device("cpu")

tfit = importlib.import_module("continuousnf_tpu_torch.train.fit")

STAGE_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# The JAX package's own bound between fused and unfused gradients (their
# backward solves run on different step grids).
FUSED_GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
NVARS, NAUG, B = 3, 2, 16
NETS = {"two-layer": (5, 15, 5), "three-layer": (5, 9, 7, 5)}


def _np_params(dims, seed):
    rng = np.random.default_rng(seed)
    ps = []
    for din, dout in zip(dims[:-1], dims[1:]):
        lim = np.sqrt(6.0 / (din + dout))
        ps.append({
            "w": rng.uniform(-lim, lim, (din, dout)).astype(np.float32),
            "b": rng.normal(0.0, 0.1, (dout,)).astype(np.float32),
        })
    return tuple(ps)


def _leaves(ps):
    return [p[k] for p in ps for k in ("w", "b")]


def _mode(m, ad, k, fused):
    return (m.JacVecMode if ad == "jvp" else m.VecJacMode)(k, fused=fused)


def _model(m, dims, ad="vjp", k=1, fused=False, **kw):
    kw = {"tspan": (0.0, 1.0), "steer_rate": 0.1, "lam3": 1e-2, **kw}
    return m.construct(m.RNODE, m.MLP(dims), dims[-1] - NAUG, NAUG, compute_mode=_mode(m, ad, k, fused), **kw)


def _jax_draws(icnf, key, batch):
    """The probes and the steering draw `inference` makes from `key`."""
    eps_key, steer_key = jax.random.split(key)
    eps = np.array(icnf.draw_eps(eps_key, batch))
    r = float(jax.random.uniform(steer_key, (), jnp.float32, -icnf.steer_rate, icnf.steer_rate))
    return eps, r


# ---- the fused stages (the kernels' math) ----

STAGE_NETS = {
    "two-layer": ((5, 15, 5), 0),
    "three-layer": ((5, 9, 7, 5), 0),
    "conditional": ((5, 9, 7, 5), 2),
}


@pytest.mark.parametrize("jvp", [False, True], ids=["vjp", "jvp"])
@pytest.mark.parametrize("k_probes", [1, 3])
@pytest.mark.parametrize("net", list(STAGE_NETS))
def test_stages_match_jax(net, k_probes, jvp):
    """`_stage_train` and its hand-derived VJP `_stage_train_fwdbwd` with K
    probes, reverse or forward mode, against the JAX package's (f32 dots,
    (rows, B) layout), and the VJP against torch.autograd.grad of the
    port's forward stage; a conditional net's ys rows and their cotangent
    too."""
    widths, n_cond = STAGE_NETS[net]
    dz, N = widths[-1], len(widths) - 1
    ins = (widths[0] + n_cond,) + tuple(widths[1:-1])
    rng = np.random.default_rng(40 + k_probes)
    z = rng.normal(size=(B, dz)).astype(np.float32)
    ys = rng.uniform(-1.0, 1.0, (B, n_cond)).astype(np.float32) if n_cond else None
    eps = rng.normal(size=(k_probes, B, dz)).astype(np.float32)
    ws = [(0.5 * rng.normal(size=(a, b))).astype(np.float32) for a, b in zip(ins, widths[1:])]
    bs = [(0.1 * rng.normal(size=(b,))).astype(np.float32) for b in widths[1:]]
    ct_y = rng.normal(size=(B, dz)).astype(np.float32)
    ct_r = rng.normal(size=(3, B)).astype(np.float32)
    jspec = jfs.ChainSpec(ins, tuple(widths[1:]), (True,) * N, n_cond)
    tspec = tfs.ChainSpec(ins, tuple(widths[1:]), (True,) * N, n_cond)
    jargs = (jnp.asarray(z.T), None if ys is None else jnp.asarray(ys.T),
             jnp.asarray(np.moveaxis(eps, 2, 1).reshape(k_probes * dz, B)),
             [jnp.asarray(w) for w in ws], [jnp.asarray(b[:, None]) for b in bs])
    T = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    targs = (T(z), T(eps), [T(w) for w in ws], [T(b) for b in bs])

    jy, jkr = jfs._stage_train(jspec, *jargs, True, True, "f32", k_probes, jvp=jvp)
    ty, tkr = tfs._stage_train(tspec, *targs, True, True, T(ys), jvp)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy).T, **STAGE_TOL)
    np.testing.assert_allclose(tkr.numpy(), np.asarray(jkr), **STAGE_TOL)

    jy, jkr, jct_zin, jct_ws, jct_bs = jfs._stage_train_fwdbwd(
        jspec, *jargs, True, True, "f32", k_probes, jnp.asarray(ct_y.T), jnp.asarray(ct_r), jvp=jvp
    )
    ty, tkr, tct_zin, tct_ws, tct_bs = tfs._stage_train_fwdbwd(
        tspec, *targs, True, True, T(ct_y), T(ct_r), T(ys), jvp
    )
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy).T, **STAGE_TOL)
    np.testing.assert_allclose(tkr.numpy(), np.asarray(jkr), **STAGE_TOL)
    np.testing.assert_allclose(tct_zin.numpy(), np.asarray(jct_zin).T, **STAGE_TOL)
    for a, b in zip(tct_ws, jct_ws):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **STAGE_TOL)
    for a, b in zip(tct_bs, jct_bs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[:, 0], **STAGE_TOL)

    leaves = [T(z).requires_grad_()] + [T(w).requires_grad_() for w in ws] + [T(b).requires_grad_() for b in bs]
    ys_t = None if ys is None else T(ys).requires_grad_()
    y, kr = tfs._stage_train(tspec, leaves[0], T(eps), leaves[1 : N + 1], leaves[N + 1 :], True, True, ys_t, jvp)
    grads = torch.autograd.grad((y * T(ct_y)).sum() + (kr * T(ct_r)).sum(), leaves + ([] if ys is None else [ys_t]))
    want_zin = grads[0] if ys is None else torch.cat([grads[0], grads[-1]], dim=-1)
    np.testing.assert_allclose(tct_zin.numpy(), want_zin.numpy(), **STAGE_TOL)
    for got, want in zip(tct_ws + tct_bs, grads[1 : 2 * N + 1]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **STAGE_TOL)


@pytest.mark.parametrize("k_probes", [1, 3])
@pytest.mark.parametrize("norm_z,norm_j", [(True, True), (False, True), (True, False)])
def test_jvp_field_matches_jax(norm_z, norm_j, k_probes):
    """The plain JVP field (`torch.func.jvp` per probe) against the JAX
    package's (`jax.linearize`), and differentiable in the params."""
    dims = NETS["three-layer"]
    ps_np = _np_params(dims, 42)
    rng = np.random.default_rng(43)
    z = rng.normal(size=(B, 5)).astype(np.float32)
    eps = rng.normal(size=(k_probes, B, 5)).astype(np.float32)
    zeros = np.zeros(B, np.float32)
    fj = jdyn(cnf.MLP(dims), cnf.Mode.TRAIN, cnf.JacVecMode(k_probes), norm_z, norm_j)
    ft = tdyn(tcnf.MLP(dims), tcnf.Mode.TRAIN, tcnf.JacVecMode(k_probes), norm_z, norm_j)
    ref = fj(0.0, JTrainState(jnp.asarray(z), *(jnp.asarray(zeros),) * 3),
             {"ps": jax.tree.map(jnp.asarray, ps_np), "eps": jnp.asarray(eps)})
    ps = tcnf.params_from_numpy(ps_np)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    got = ft(0.0, TTrainState(torch.from_numpy(z), *(torch.from_numpy(zeros),) * 3),
             {"ps": ps, "eps": torch.from_numpy(eps)})
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **STAGE_TOL)
    g = torch.autograd.grad(sum(x.sum() for x in got), leaves)
    assert all(torch.isfinite(x).all() and x.abs().max() > 0 for x in g)


# ---- the twins against the JAX megakernel in interpret mode ----

SOLVES = {
    "two-layer-K3": ("two-layer", "vjp", 3),
    "two-layer-jvp": ("two-layer", "jvp", 1),
    "two-layer-jvp-K3": ("two-layer", "jvp", 3),
    "three-layer-K3": ("three-layer", "vjp", 3),
    "three-layer-jvp": ("three-layer", "jvp", 1),
    "three-layer-jvp-K2": ("three-layer", "jvp", 2),
}


@pytest.mark.parametrize("case", list(SOLVES))
def test_solve_and_adjoint_match_interpret_kernel(case):
    """The fused TRAIN solve and its backsolve on the CPU (the K1 and K2
    twins and their chain forms' twins) against the JAX package's forward
    and adjoint megakernels in interpret mode, from the same state, probes,
    cotangent and warm start: equal steps, values within 1e-4."""
    net, ad, k = SOLVES[case]
    dims = NETS[net]
    span = 2.0
    jicnf = _model(cnf, dims, ad, k, True, tspan=(0.0, span))
    ticnf = _model(tcnf, dims, ad, k, True, tspan=(0.0, span))
    ps_np = _np_params(dims, 44)
    rng = np.random.default_rng(45)
    xs = rng.uniform(size=(B, NVARS)).astype(np.float32)
    eps = rng.normal(size=(k, B, 5)).astype(np.float32)
    z0 = np.concatenate([xs, np.zeros((B, NAUG), np.float32)], axis=1)
    y0f = np.concatenate([z0.ravel(), np.zeros(3 * B, np.float32)])
    jfull = jfs.make_full_solve(jicnf, cnf.Mode.TRAIN, B)
    jargs = {"ps": jax.tree.map(jnp.asarray, ps_np), "eps": jnp.asarray(eps), "ys": None}
    yTf_r, fst_r = jfull.forward(jnp.asarray(y0f), 0.0, span, jargs)
    tfull = tfs.make_full_solve(ticnf, tcnf.Mode.TRAIN, B)
    targs = {"ps": tcnf.params_from_numpy(ps_np), "eps": torch.from_numpy(eps), "ys": None}
    yTf, fst = tfull.forward(torch.from_numpy(y0f), torch.tensor(0.0), torch.tensor(span), targs)
    assert (int(fst.steps), int(fst.accepted), int(fst.nfe)) == (int(fst_r.steps), int(fst_r.accepted),
                                                                 int(fst_r.nfe))
    np.testing.assert_allclose(yTf.numpy(), np.asarray(yTf_r), **TOL)

    g_yf = np.concatenate([rng.normal(0.0, 0.1, B * 5), np.full(B, 1.0 / B), np.full(2 * B, 1e-2 / B)]).astype(
        np.float32)
    dt_warm = float(fst_r.dt_last)
    y0_r, ay0_r, gargs_r, st_r = jfull.adjoint(yTf_r, jnp.asarray(g_yf), jargs, span, 0.0, dt_warm=dt_warm)
    y0, ay0, gargs, st = tfull.adjoint(torch.from_numpy(np.array(yTf_r)), torch.from_numpy(g_yf), targs,
                                       torch.tensor(span), torch.tensor(0.0), dt_warm=dt_warm)
    assert (int(st.steps), int(st.accepted), int(st.nfe)) == (int(st_r.steps), int(st_r.accepted), int(st_r.nfe))
    np.testing.assert_allclose(y0.numpy(), np.asarray(y0_r), **TOL)
    np.testing.assert_allclose(ay0.numpy(), np.asarray(ay0_r), **TOL)
    for a, b in zip(_leaves(gargs["ps"]), _leaves(gargs_r["ps"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert torch.equal(gargs["eps"], torch.zeros_like(targs["eps"]))


# ---- inference, loss gradients and fit ----

GRADS = {
    "jvp-plain": ("two-layer", "jvp", 1, False),
    "jvp-plain-K2": ("two-layer", "jvp", 2, False),
    "jvp-plain-three-layer": ("three-layer", "jvp", 1, False),
    "vjp-K3-fused": ("two-layer", "vjp", 3, True),
    "vjp-K3-fused-three-layer": ("three-layer", "vjp", 3, True),
    "jvp-fused": ("two-layer", "jvp", 1, True),
    "jvp-K2-fused-three-layer": ("three-layer", "jvp", 2, True),
}


@pytest.mark.parametrize("case", list(GRADS))
def test_train_gradients_match_jax_grad(case):
    """TRAIN inference and the loss gradient through the BACKSOLVE adjoint
    (plain, or fused: the twins of K1 and K2 or their chain forms on the
    CPU) against `jax.grad` of the JAX package's loss on the same
    configuration, with its probe and steering draws fed in (the JAX
    package's own check, tests/test_fused_chain.py:340-360).  Over the span
    (0, 1) the two-layer K = 3 input is a last-step tie (the JAX package's
    own fused solve takes 13 steps, its plain one 14 with a last step of
    0.009), so the span is (0, 2)."""
    net, ad, k, fused = GRADS[case]
    dims = NETS[net]
    span = (0.0, 2.0)
    jicnf, ticnf = (_model(m, dims, ad, k, fused, tspan=span) for m in (cnf, tcnf))
    ps_np = _np_params(dims, 46)
    xs = np.random.default_rng(47).uniform(size=(B, NVARS)).astype(np.float32)
    key = jax.random.PRNGKey(48)
    jps = jax.tree.map(jnp.asarray, ps_np)
    lp_r, regs_r, st_r = cnf.inference(jicnf, cnf.Mode.TRAIN, jnp.asarray(xs), jps, key=key)
    eps, r = _jax_draws(jicnf, key, B)
    assert eps.shape == (k, B, 5)
    lp, regs, st = tcnf.inference(ticnf, tcnf.Mode.TRAIN, xs, tcnf.params_from_numpy(ps_np), eps=eps, steer_r=r)
    assert int(st.steps) == int(st_r.steps)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_r), **TOL)
    np.testing.assert_allclose(regs.n.numpy(), np.asarray(regs_r.n), **TOL)

    l_r, g_r = jax.value_and_grad(lambda p: cnf.loss(jicnf, cnf.Mode.TRAIN, jnp.asarray(xs), p, key=key))(jps)
    ps = tcnf.params_from_numpy(ps_np)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    l = tcnf.loss(ticnf, tcnf.Mode.TRAIN, xs, ps, eps=eps, steer_r=r)
    g = torch.autograd.grad(l, leaves)
    np.testing.assert_allclose(float(l.detach()), float(l_r), **TOL)
    for a, b in zip(g, _leaves(g_r)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **(FUSED_GRAD_TOL if fused else GRAD_TOL))


def test_fused_probe_gradients_match_the_ports_plain_path():
    """The fused K-probe JVP gradient (the twins) against the port's plain
    BACKSOLVE on the same draws, at the JAX package's fused-vs-plain bound."""
    dims = NETS["three-layer"]
    ps_np = _np_params(dims, 49)
    xs = np.random.default_rng(50).uniform(size=(B, NVARS)).astype(np.float32)
    eps = np.random.default_rng(51).normal(size=(2, B, 5)).astype(np.float32)

    def grads(fused):
        ps = tcnf.params_from_numpy(ps_np)
        leaves = [x.requires_grad_() for x in _leaves(ps)]
        l = tcnf.loss(_model(tcnf, dims, "jvp", 2, fused), tcnf.Mode.TRAIN, xs, ps, eps=eps, steer_r=0.05)
        return float(l.detach()), torch.autograd.grad(l, leaves)

    (l_f, g_f), (l_p, g_p) = grads(True), grads(False)
    np.testing.assert_allclose(l_f, l_p, **TOL)
    for a, b in zip(g_f, g_p):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **FUSED_GRAD_TOL)


@pytest.mark.parametrize("ad", ["vjp", "jvp"])
def test_fit_two_lion_steps_with_two_probes(monkeypatch, ad):
    """`fit` with two probes for two Lion steps (the fused path: the twins
    on the CPU): each step's weighted loss equals the JAX package's `loss`
    on the same batch, params and probes."""
    dims = NETS["two-layer"]
    ps_np = _np_params(dims, 52)
    X = np.random.default_rng(53).uniform(size=(32, NVARS)).astype(np.float32)
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
    icnf = _model(tcnf, dims, ad, 2, True, steer_rate=0.0)
    res = tcnf.fit(tcnf.ICNFModel(icnf, n_epochs=1, batch_size=16), X, ps=tcnf.params_from_numpy(ps_np), seed=4)
    assert len(records) == 2 and np.isfinite(res.losses).all()
    for ps_k, xb, wb, gen_state, loss_k in records:
        eps = icnf.draw_eps(torch.Generator().set_state(gen_state), 16).numpy()
        assert eps.shape == (2, 16, 5)
        ref = cnf.loss(_model(cnf, dims, ad, 2, True, steer_rate=0.0), cnf.Mode.TRAIN, jnp.asarray(xb),
                       jax.tree.map(jnp.asarray, tuple(ps_k)), key=jax.random.PRNGKey(0),
                       weights=jnp.asarray(wb), eps=jnp.asarray(eps))
        np.testing.assert_allclose(loss_k, float(ref), **TOL)
    assert not np.array_equal(records[0][0][0]["w"], records[1][0][0]["w"])


def test_wrappers_run_the_twins_on_the_cpu_without_counting():
    """On CPU tensors the Hutchinson wrappers run their twins with K probes
    and JVP, bit for bit, and count no launch."""
    spec = tfs.chain_spec(tcnf.MLP(NETS["three-layer"]), 5)
    ps = tcnf.params_from_numpy(_np_params(NETS["three-layer"], 54))
    rng = np.random.default_rng(55)
    T = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    kw = dict(norm_z=True, norm_j=True, rtol=1e-3, atol=1e-6, max_steps=100, ws=[p["w"] for p in ps],
              bs=[p["b"] for p in ps], z0=T(rng.normal(size=(8, 5))), eps=T(rng.normal(size=(3, 8, 5))),
              acc0=T(rng.normal(size=(3, 8))), t0=torch.tensor(0.0), t1=torch.tensor(1.0),
              dt_init=torch.tensor(0.05), jvp=True)
    tfs.reset_launches()
    got = tfs.run_chain_train_solve_kernel(TSIT5, spec, **kw)
    ref = tfs.solve_train_plain(TSIT5, spec, **kw)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    adj = {k: kw[k] for k in ("norm_z", "norm_j", "rtol", "atol", "max_steps", "ws", "bs", "eps", "jvp")}
    adj.update(zT=got[0], accT=got[1], azT=T(rng.normal(size=(8, 5))), aaccT=T(rng.normal(size=(3, 8))),
               t_hi=torch.tensor(1.0), t_lo=torch.tensor(0.0), dt_init=torch.tensor(-0.05))
    got = tfs.run_chain_adjoint_kernel(TSIT5, spec, **adj)
    ref = tfs.adjoint_train_plain(TSIT5, spec, **adj)
    for a, b in zip(got[:3] + got[5:], ref[:3] + ref[5:]):
        assert torch.equal(a, b)
    assert all(w.launches == 0 and w.probe_launches == {} for w in tfs.PROBE_WRAPPERS)
