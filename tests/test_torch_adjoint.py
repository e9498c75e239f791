"""Gradients and training in the port against the JAX package on the CPU:
the K2 twin against the JAX package's adjoint kernel (interpret mode) with
the same warm start, the BACKSOLVE adjoint's gradients (unfused against
`jax.grad` of the unfused loss, fused against the fused one), the end-time
and probe cotangents, Lion against `optax.lion`, one training step against
the JAX step body, and `fit` (padding weights, resumption)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import continuousnf_tpu as cnf
import continuousnf_tpu_torch as tcnf
from continuousnf_tpu.core.dynamics import TrainState as JTrainState
from continuousnf_tpu.core.dynamics import make_augmented_dynamics as jdyn
from continuousnf_tpu.ode.solve import odeint_with_stats as jodeint
from continuousnf_tpu.ops import fused_solve as jfs
from continuousnf_tpu.parallel.sharding import make_train_step_body as jstep_body
from continuousnf_tpu_torch.core.dynamics import TrainState as TTrainState
from continuousnf_tpu_torch.core.dynamics import make_augmented_dynamics as tdyn
from continuousnf_tpu_torch.ode.solve import odeint_with_stats as todeint
from continuousnf_tpu_torch.ode.tableaus import TSIT5
from continuousnf_tpu_torch.ops import fused_solve as tfs
from continuousnf_tpu_torch.parallel import make_train_step_body

# The port's entry points default to the CUDA card; these tests run it on the CPU.
tcnf.set_default_device("cpu")

tfit = importlib.import_module("continuousnf_tpu_torch.train.fit")

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# The JAX package's own bound between its fused and unfused gradients
# (tests/test_fused_solve.py::test_grad_parity): the two backward solves run
# on different step grids (warm-started vs Hairer-picked first step).
FUSED_GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
DIMS, NVARS, NAUG, B = (5, 15, 5), 3, 2, 16


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


def _model(m, fused=False, **kw):
    kw = {"tspan": (0.0, 1.0), "steer_rate": 0.1, "lam3": 1e-2, **kw}
    return m.construct(m.RNODE, m.MLP(DIMS), NVARS, NAUG, compute_mode=m.VecJacMode(fused=fused), **kw)


def _jax_draws(icnf, key, batch):
    eps_key, steer_key = jax.random.split(key)
    eps = np.array(icnf.draw_eps(eps_key, batch))
    r = float(jax.random.uniform(steer_key, (), jnp.float32, -icnf.steer_rate, icnf.steer_rate))
    return eps, r


def _leaves(ps):
    return [p[k] for p in ps for k in ("w", "b")]


def _torch_grads(icnf, ps_np, xs, **kw):
    ps = tcnf.params_from_numpy(ps_np)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    l = tcnf.loss(icnf, tcnf.Mode.TRAIN, xs, ps, **kw)
    return float(l.detach()), [g.numpy() for g in torch.autograd.grad(l, leaves)]


def _jax_grads(icnf, ps_np, xs, key):
    l, g = jax.value_and_grad(lambda p: cnf.loss(icnf, cnf.Mode.TRAIN, jnp.asarray(xs), p, key=key))(
        jax.tree.map(jnp.asarray, ps_np)
    )
    return float(l), [np.asarray(x) for x in _leaves(g)]


@pytest.fixture(scope="module")
def problem():
    ps_np = _np_params(DIMS, 21)
    xs = np.random.default_rng(22).uniform(size=(B, NVARS)).astype(np.float32)
    return ps_np, xs, jax.random.PRNGKey(23)


@pytest.mark.parametrize("warm", [True, False], ids=["dt-warm", "hairer"])
def test_adjoint_twin_matches_reference_adjoint(problem, warm):
    """The port's fused adjoint (the K2 twin on the CPU) against the JAX
    package's adjoint kernel in interpret mode, from the same final state,
    cotangent and first step: equal steps, results within 1e-4.  Over the
    span (0, 1) these inputs are a near tie (the reference's third backward
    step ends 6e-4 short of t0 in float64 and past it in its float32 sum
    order), so the span is (0, 2)."""
    ps_np, xs, key = problem
    span = 2.0
    jicnf = _model(cnf, True, tspan=(0.0, span))
    jps = jax.tree.map(jnp.asarray, ps_np)
    eps, _ = _jax_draws(jicnf, key, B)
    jfull = jfs.make_full_solve(jicnf, cnf.Mode.TRAIN, B)
    z0 = np.concatenate([xs, np.zeros((B, NAUG), np.float32)], axis=1)
    y0f = np.concatenate([z0.ravel(), np.zeros(3 * B, np.float32)])
    args = {"ps": jps, "eps": jnp.asarray(eps), "ys": None}
    yTf, fst = jfull.forward(jnp.asarray(y0f), 0.0, span, args)
    rng = np.random.default_rng(24)
    g_yf = np.concatenate([rng.normal(0.0, 0.1, B * 5), np.full(B, 1.0 / B), np.full(2 * B, 1e-2 / B)]).astype(np.float32)
    dt_warm = float(fst.dt_last) if warm else None
    y0_r, ay0_r, gargs_r, st_r = jfull.adjoint(yTf, jnp.asarray(g_yf), args, span, 0.0, dt_warm=dt_warm)

    tfull = tfs.make_full_solve(_model(tcnf, True, tspan=(0.0, span)), tcnf.Mode.TRAIN, B)
    targs = {"ps": tcnf.params_from_numpy(ps_np), "eps": torch.from_numpy(eps), "ys": None}
    y0, ay0, gargs, st = tfull.adjoint(
        torch.from_numpy(np.array(yTf)), torch.from_numpy(g_yf), targs, torch.tensor(span), torch.tensor(0.0),
        dt_warm=dt_warm,
    )
    assert (int(st.steps), int(st.accepted), int(st.nfe)) == (int(st_r.steps), int(st_r.accepted), int(st_r.nfe))
    np.testing.assert_allclose(y0.numpy(), np.asarray(y0_r), **TOL)
    np.testing.assert_allclose(ay0.numpy(), np.asarray(ay0_r), **TOL)
    for a, b in zip(_leaves(gargs["ps"]), _leaves(gargs_r["ps"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert torch.equal(gargs["eps"], torch.zeros_like(targs["eps"]))


def test_adjoint_wrapper_runs_plain_version_on_cpu(problem):
    ps_np, xs, _ = problem
    ps = tcnf.params_from_numpy(ps_np)
    rng = np.random.default_rng(25)
    T = lambda a: torch.from_numpy(a.astype(np.float32))
    kw = dict(
        norm_z=True, norm_j=True, rtol=1e-3, atol=1e-6, max_steps=100,
        ws=[p["w"] for p in ps], bs=[p["b"] for p in ps], eps=T(rng.normal(size=(1, B, 5))),
        zT=T(rng.normal(size=(B, 5))), accT=T(rng.normal(size=(3, B))), azT=T(rng.normal(size=(B, 5))),
        aaccT=T(rng.normal(size=(3, B))), t_hi=torch.tensor(1.0), t_lo=torch.tensor(0.0),
        dt_init=torch.tensor(-0.1),
    )
    spec = tfs.chain_spec(tcnf.MLP(DIMS), 5)
    before = tfs.run_adjoint_kernel.launches
    got = tfs.run_adjoint_kernel(TSIT5, spec, **kw)
    ref = tfs.adjoint_train_plain(TSIT5, spec, **kw)
    assert tfs.run_adjoint_kernel.launches == before
    for a, b in zip(got, ref):
        for x, y in zip(a if isinstance(a, list) else [a], b if isinstance(b, list) else [b]):
            assert torch.equal(x, y)
    with pytest.raises(NotImplementedError, match="not differentiable"):
        tfs.run_adjoint_kernel(TSIT5, spec, **{**kw, "zT": kw["zT"].clone().requires_grad_()})


@pytest.mark.parametrize("steer", [0.0, 0.1], ids=["unsteered", "steered"])
def test_unfused_gradients_match_jax_grad(problem, steer):
    ps_np, xs, key = problem
    jicnf = _model(cnf, False, steer_rate=steer)
    l_r, g_r = _jax_grads(jicnf, ps_np, xs, key)
    eps, r = _jax_draws(jicnf, key, B)
    l, g = _torch_grads(_model(tcnf, False, steer_rate=steer), ps_np, xs, eps=eps, steer_r=r if steer else None)
    np.testing.assert_allclose(l, l_r, **GRAD_TOL)
    for a, b in zip(g, g_r):
        np.testing.assert_allclose(a, b, **GRAD_TOL)


def test_fused_gradients_match_jax_fused_gradients(problem):
    ps_np, xs, key = problem
    jicnf = _model(cnf, True)
    l_r, g_r = _jax_grads(jicnf, ps_np, xs, key)
    eps, r = _jax_draws(jicnf, key, B)
    l, g = _torch_grads(_model(tcnf, True), ps_np, xs, eps=eps, steer_r=r)
    np.testing.assert_allclose(l, l_r, **TOL)
    for a, b in zip(g, g_r):
        np.testing.assert_allclose(a, b, **FUSED_GRAD_TOL)
    # ... and the port's fused against its unfused gradients, at the same bound.
    _, g_p = _torch_grads(_model(tcnf, False), ps_np, xs, eps=eps, steer_r=r)
    for a, b in zip(g, g_p):
        np.testing.assert_allclose(a, b, **FUSED_GRAD_TOL)


def test_end_time_and_probe_cotangents_match_jax(problem):
    """dL/dt0 and dL/dt1 (computed only when asked for) and the probe
    cotangent, which BACKSOLVE defines as zero."""
    ps_np, xs, _ = problem
    rng = np.random.default_rng(26)
    z0 = rng.normal(size=(B, 5)).astype(np.float32)
    eps = rng.normal(size=(1, B, 5)).astype(np.float32)
    zeros = np.zeros(B, np.float32)
    fj = jdyn(cnf.MLP(DIMS), cnf.Mode.TRAIN, cnf.VecJacMode(), True, True)
    args_j = {"ps": jax.tree.map(jnp.asarray, ps_np), "eps": jnp.asarray(eps)}

    def obj_j(t0, t1, eps_):
        yT, _ = jodeint(fj, JTrainState(jnp.asarray(z0), *(jnp.asarray(zeros),) * 3), t0, t1,
                        dict(args_j, eps=eps_), cnf.SolverOptions())
        return jnp.sum(yT.z ** 2) + jnp.sum(yT.dlogp) + jnp.sum(yT.reg_n)

    g_r = jax.grad(obj_j, argnums=(0, 1, 2))(0.0, 1.0, jnp.asarray(eps))
    ft = tdyn(tcnf.MLP(DIMS), tcnf.Mode.TRAIN, tcnf.VecJacMode(), True, True)
    t0 = torch.tensor(0.0, requires_grad=True)
    t1 = torch.tensor(1.0, requires_grad=True)
    eps_t = torch.from_numpy(eps).requires_grad_()
    yT, _ = todeint(ft, TTrainState(torch.from_numpy(z0), *(torch.from_numpy(zeros),) * 3), t0, t1,
                    {"ps": tcnf.params_from_numpy(ps_np), "eps": eps_t})
    obj = torch.sum(yT.z ** 2) + torch.sum(yT.dlogp) + torch.sum(yT.reg_n)
    g = torch.autograd.grad(obj, (t0, t1, eps_t))
    np.testing.assert_allclose(float(g[0]), float(g_r[0]), **TOL)
    np.testing.assert_allclose(float(g[1]), float(g_r[1]), **TOL)
    assert float(g[2].abs().max()) == 0.0 and float(jnp.abs(g_r[2]).max()) == 0.0


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_test_mode_gradients_on_cpu_match_jax(problem, fused):
    """TEST-mode gradients: the plain path (the generic backward) against
    `jax.grad` of the JAX package's unfused loss; the fused path (K3's twin
    forward, K5's twin backward) against `jax.grad` of the JAX package's
    fused loss (its TEST adjoint kernel in interpret mode), and against the
    unfused one at the JAX package's own bound between the two."""
    ps_np, xs, _ = problem

    def jgrad(jfused):
        jl = lambda p: cnf.loss(_model(cnf, jfused), cnf.Mode.TEST, jnp.asarray(xs), p)  # noqa: E731
        return _leaves(jax.grad(jl)(jax.tree.map(jnp.asarray, ps_np)))

    ps = tcnf.params_from_numpy(ps_np)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    g = torch.autograd.grad(tcnf.loss(_model(tcnf, fused), tcnf.Mode.TEST, xs, ps), leaves)
    for a, b in zip(g, jgrad(fused)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)
    if fused:
        for a, b in zip(g, jgrad(False)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **FUSED_GRAD_TOL)


def test_direct_adjoint_gradients_raise(problem):
    """DIRECT gradients (the recorded solve, K10's field where fused) of the
    steered TRAIN loss in the params and the probes against `jax.grad` of
    the JAX package's DIRECT loss with the same draws: equal NFE, the loss
    within 1e-4 and the gradients within GRAD_TOL; the probe gradient is
    nonzero (BACKSOLVE's is zero)."""
    ps_np, xs, key = problem
    for fused in (False, True):
        _hold_direct_gradients(ps_np, xs, key, fused)


def _hold_direct_gradients(ps_np, xs, key, fused):
    opts = dict(adjoint="direct", direct_max_steps=64)
    jicnf = _model(cnf, fused, solver=cnf.SolverOptions(**dict(opts, adjoint=cnf.Adjoint.DIRECT)))
    eps, r = _jax_draws(jicnf, key, B)

    def jl(p, e):
        return cnf.loss_and_metrics(jicnf, cnf.Mode.TRAIN, jnp.asarray(xs), p, key=key, eps=e)

    (l_r, m_r), g_r = jax.value_and_grad(jl, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, ps_np), jnp.asarray(eps))
    icnf = _model(tcnf, fused, solver=tcnf.SolverOptions(**dict(opts, adjoint=tcnf.Adjoint.DIRECT)))
    ps = tcnf.params_from_numpy(ps_np)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    e = torch.from_numpy(eps).requires_grad_()
    l, m = tcnf.loss_and_metrics(icnf, tcnf.Mode.TRAIN, xs, ps, eps=e, steer_r=r)
    g = torch.autograd.grad(l, leaves + [e])
    assert int(m["nfe"]) == int(m_r["nfe"])
    np.testing.assert_allclose(float(l.detach()), float(l_r), **TOL)
    for a, b in zip(g, _leaves(g_r[0]) + [g_r[1]]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)
    assert float(g[-1].abs().max()) > 1e-3


def test_lion_matches_optax():
    rng = np.random.default_rng(27)
    ps_np = _np_params(DIMS, 28)
    opt = optax.lion(1e-3)
    jps = jax.tree.map(jnp.asarray, ps_np)
    state = opt.init(jps)
    leaves = [x.requires_grad_() for x in _leaves(tcnf.params_from_numpy(ps_np))]
    topt = tcnf.Lion(leaves, lr=1e-3)
    for _ in range(3):
        g_np = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), ps_np)
        updates, state = opt.update(jax.tree.map(jnp.asarray, g_np), state, jps)
        jps = optax.apply_updates(jps, updates)
        for p, g in zip(leaves, _leaves(g_np)):
            p.grad = torch.from_numpy(g)
        topt.step()
    for a, b in zip(leaves, _leaves(jps)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0, atol=1e-6)


def test_train_step_matches_jax_step(problem):
    ps_np, xs, key = problem
    jicnf = _model(cnf, True)
    opt = optax.lion(1e-3)
    jps = jax.tree.map(jnp.asarray, ps_np)
    w = np.concatenate([np.ones(12), np.zeros(4)]).astype(np.float32)
    jps1, _, m_r = jstep_body(jicnf, opt)(jps, opt.init(jps), jnp.asarray(xs), key, weights=jnp.asarray(w))
    # The step body's key splits: probes from the first key, the loss's
    # steering draw from the second.
    eps_key, loss_key = jax.random.split(key)
    eps = np.array(jicnf.draw_eps(eps_key, B))
    _, r = _jax_draws(jicnf, loss_key, B)
    ps = tcnf.params_from_numpy(ps_np)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    step = make_train_step_body(_model(tcnf, True), tcnf.Lion(leaves, lr=1e-3))
    m = step(ps, xs, weights=w, eps=eps, steer_r=r)
    for k in ("loss", "e", "n"):
        np.testing.assert_allclose(float(m[k]), float(m_r[k]), **TOL)
    assert int(m["nfe"]) == int(m_r["nfe"])
    # Equal parameters, except where the Lion sign argument 0.1 g (zero
    # momentum) lies within roundoff of 0.
    g_r = _leaves(jax.grad(lambda p: cnf.loss(jicnf, cnf.Mode.TRAIN, jnp.asarray(xs), p, key=loss_key,
                                              weights=jnp.asarray(w), eps=jnp.asarray(eps)))(jps))
    for p, want, g in zip(leaves, _leaves(jps1), g_r):
        g = np.asarray(g)
        sure = np.abs(g) > 1e-4 * np.abs(g).max()
        np.testing.assert_allclose(p.detach().numpy()[sure], np.asarray(want)[sure], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="optimizer's parameters"):
        step(tcnf.params_from_numpy(ps_np), xs, eps=eps, steer_r=r)


def test_fit_pads_with_zero_weights_and_matches_jax_loss(monkeypatch):
    """fit on 50 samples at batch 16: four steps per epoch, the last padded
    with 14 repeated samples of weight 0; its weighted loss equals the JAX
    package's `loss(weights=)` on the same batch and probes."""
    ps_np = _np_params(DIMS, 29)
    X = np.random.default_rng(30).uniform(size=(50, NVARS)).astype(np.float32)
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
    icnf = _model(tcnf, True, steer_rate=0.0)
    res = tcnf.fit(tcnf.ICNFModel(icnf, n_epochs=1, batch_size=16), X, ps=tcnf.params_from_numpy(ps_np), seed=3)
    assert len(records) == 4 and res.epochs == 1 and np.isfinite(res.losses).all()
    assert set(res.metrics) == {"loss", "e", "n", "nfe", "samples_per_s"}
    ps_last, xb, wb, gen_state, loss_last = records[-1]
    assert wb.sum() == 2.0 and (wb[2:] == 0.0).all()
    eps = icnf.draw_eps(torch.Generator().set_state(gen_state), 16).numpy()
    ref = cnf.loss(_model(cnf, True, steer_rate=0.0), cnf.Mode.TRAIN, jnp.asarray(xb),
                   jax.tree.map(jnp.asarray, tuple(ps_last)), key=jax.random.PRNGKey(0),
                   weights=jnp.asarray(wb), eps=jnp.asarray(eps))
    np.testing.assert_allclose(loss_last, float(ref), **TOL)


def test_fit_resumes_with_the_same_draws():
    icnf = _model(tcnf, True)
    X = np.random.default_rng(31).uniform(size=(24, NVARS)).astype(np.float32)
    model = tcnf.ICNFModel(icnf, n_epochs=2, batch_size=16)
    full = tcnf.fit(model, X, seed=5)
    saved = {}
    first = tcnf.fit(tcnf.ICNFModel(icnf, n_epochs=1, batch_size=16), X, seed=5,
                     state_callback=lambda e, ps, st: saved.update(st=st))
    resumed = tcnf.fit(model, X, seed=5, ps=first.ps, opt_state=saved["st"], epoch_start=1)
    assert resumed.epochs == 2 and len(resumed.losses) == 1
    np.testing.assert_array_equal(resumed.losses, full.losses[1:])
    for a, b in zip(_leaves(resumed.ps), _leaves(full.ps)):
        assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="item 18"):
        tcnf.fit(model, X.tolist())
