"""The per-stage fused TRAIN field (K10's op) and gradients through the
DIRECT and fixed-step solves, in the port against the JAX package on the
CPU: the op's forward and all six cotangents against the JAX package's
interpreted kernel (float32 and float64), its gradient and gradient of the
gradient, the analytic gradients of `tests/test_ode.py`, the RNODE TRAIN
loss and gradient (eps included) against `jax.grad` with the field fused
(K10's plain version) and unfused, K10's count on the DIRECT path, `fit`,
`generate`'s TEST gradient under DIRECT, and the refusal of `Adjoint.NONE`
gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import continuousnf_tpu as cnf
import continuousnf_tpu_torch as tcnf
from continuousnf_tpu.ode.solve import odeint as jodeint
from continuousnf_tpu.ops import fused_dynamics as jfd
from continuousnf_tpu_torch.ops import fused_dynamics as tfd
from continuousnf_tpu_torch.ops import fused_solve as tfs

# The port's entry points default to the CUDA card; these tests run it on the CPU.
tcnf.set_default_device("cpu")

DIMS, NVARS, NAUG, B = (5, 15, 5), 3, 2, 16
# Losses and gradients against jax.grad: the same discrete solve in both, so
# float32 roundoff only (equal step counts are asserted beside them).
LOSS_TOL = 1e-5
GRAD_REL = 1e-4
DIRECT = dict(adjoint="direct", direct_max_steps=64)
FIXED = dict(method="rk4", fixed_num_steps=8)


def _np_params(dims, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    ps = []
    for din, dout in zip(dims[:-1], dims[1:]):
        lim = np.sqrt(6.0 / (din + dout))
        ps.append({"w": rng.uniform(-lim, lim, (din, dout)).astype(dtype),
                   "b": rng.normal(0.0, 0.1, (dout,)).astype(dtype)})
    return tuple(ps)


def _leaves(ps):
    return [p[k] for p in ps for k in ("w", "b")]


def _solver(m, kw):
    kw = dict(kw)
    if "adjoint" in kw:
        kw["adjoint"] = m.Adjoint(kw["adjoint"])
    return m.SolverOptions(**kw)


def _model(m, fused, solver_kw, **kw):
    kw = {"tspan": (0.0, 1.0), "steer_rate": 0.1, "lam3": 1e-2, **kw}
    return m.construct(m.RNODE, m.MLP(DIMS), NVARS, NAUG, compute_mode=m.VecJacMode(fused=fused),
                       solver=_solver(m, solver_kw), **kw)


def _field_inputs(dtype, seed=3, batch=37):
    ps_np = _np_params(DIMS, seed, dtype)
    rng = np.random.default_rng(seed + 1)
    z = rng.normal(size=(batch, DIMS[0])).astype(dtype)
    eps = rng.normal(size=(batch, DIMS[0])).astype(dtype)
    return [ps_np[0]["w"], ps_np[0]["b"], ps_np[1]["w"], ps_np[1]["b"], z, eps]


def _jax_op(*xs):
    ps = ({"w": xs[0], "b": xs[1]}, {"w": xs[2], "b": xs[3]})
    return jfd.fused_tanh_mlp_dynamics(ps, xs[4], xs[5], interpret=True)


# The JAX package's kernel takes its dots in float32 (preferred_element_type)
# and fails to store them into float64 outputs, so its float64 op is held
# through its plain reference, the function its VJP differentiates.
_JAX_OPS = {np.float32: _jax_op, np.float64: jfd._reference_impl}


def _torch_op(*xs):
    return tfd.fused_tanh_mlp_dynamics(({"w": xs[0], "b": xs[1]}, {"w": xs[2], "b": xs[3]}), xs[4], xs[5])


def _rel(got, ref) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max() / max(np.abs(np.asarray(ref)).max(), 1e-30))


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6), (np.float64, 1e-12)], ids=["f32", "f64"])
def test_k10_op_and_its_vjp_match_the_interpreted_kernel(dtype, tol):
    """Forward outputs and the cotangents of all six inputs (eps included)
    against `jax.vjp` of the JAX package's op (its Pallas kernel in interpret
    mode; in float64 its plain reference), relative to each output's
    largest entry; B = 37 is no tile multiple."""
    xs = _field_inputs(dtype)
    cts = [np.random.default_rng(9).normal(size=s).astype(dtype) for s in ((37, 5), (37,), (37,), (37,))]
    with jax.enable_x64(dtype == np.float64):
        out_r, vjp_fn = jax.vjp(_JAX_OPS[dtype], *map(jnp.asarray, xs))
        g_r = vjp_fn(tuple(map(jnp.asarray, cts)))
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    out = _torch_op(*ts)
    g = torch.autograd.grad(out, ts, [torch.from_numpy(c) for c in cts])
    for a, b in zip(out, out_r):
        assert a.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
        assert _rel(a.detach().numpy(), b) <= tol
    for a, b in zip(g, g_r):
        assert _rel(a.numpy(), b) <= tol


def test_k10_op_gradcheck_and_second_order():
    """The Function's backward (the plain version's VJP) against finite
    differences, and its own gradient (double backward) too."""
    xs = [torch.from_numpy(x).requires_grad_() for x in _field_inputs(np.float64, batch=6)]
    assert torch.autograd.gradcheck(_torch_op, xs)
    assert torch.autograd.gradgradcheck(_torch_op, xs)


def test_k10_wrapper_on_cpu_runs_the_plain_version():
    xs = [torch.from_numpy(x) for x in _field_inputs(np.float32)]
    before = tfd.run_fused_field_kernel.launches
    got = tfd.run_fused_field_kernel(*xs)
    ref = tfd.fused_field_plain(*xs)
    assert tfd.run_fused_field_kernel.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert tfs.KERNEL_WRAPPERS[tfd.K10_KERNEL] is tfd.run_fused_field_kernel


_DECAY = lambda t, y, args: -args["rate"] * y  # noqa: E731


@pytest.mark.parametrize(
    "opts",
    [dict(), dict(adjoint="direct", direct_max_steps=64), dict(method="rk4", fixed_num_steps=50, adjoint="direct")],
    ids=["backsolve", "direct", "fixed-rk4"],
)
def test_analytic_gradients_wrt_y0_rate_t1(opts):
    """y(t1) = y0 exp(-rate t1): the three partials, as in the JAX package's
    tests/test_ode.py::test_gradients_wrt_params_y0_t1."""
    y0, rate, t1 = (torch.tensor(v, requires_grad=True) for v in (2.0, 1.5, 0.8))
    yT = tcnf.odeint(_DECAY, y0, 0.0, t1, {"rate": rate}, _solver(tcnf, opts))
    g = torch.autograd.grad(yT, (y0, rate, t1))
    f = float(np.exp(-1.5 * 0.8))
    np.testing.assert_allclose(float(g[0]), f, rtol=1e-3)
    np.testing.assert_allclose(float(g[1]), -0.8 * 2.0 * f, rtol=1e-3)
    np.testing.assert_allclose(float(g[2]), -1.5 * 2.0 * f, rtol=1e-3)


def test_direct_and_backsolve_agree_on_a_nonlinear_field():
    """tests/test_ode.py::test_gradients_match_between_adjoints: the two
    adjoints within 1e-2, and the DIRECT gradient against the JAX package's
    DIRECT one (the same discrete solve) within 1e-5."""
    field = lambda t, y, args: torch.tanh(args["a"] * y) - 0.5 * y  # noqa: E731
    y0 = torch.tensor([0.3, -0.7, 1.1])

    def grad(opts):
        a = torch.tensor(0.9, requires_grad=True)
        return float(torch.autograd.grad(torch.sum(tcnf.odeint(field, y0, 0.0, 2.0, {"a": a}, opts) ** 2), a)[0])

    g_back = grad(tcnf.SolverOptions())
    g_dir = grad(tcnf.SolverOptions(adjoint=tcnf.Adjoint.DIRECT, direct_max_steps=128))
    np.testing.assert_allclose(g_back, g_dir, rtol=1e-2)
    jfield = lambda t, y, args: jnp.tanh(args["a"] * y) - 0.5 * y  # noqa: E731
    jopts = cnf.SolverOptions(adjoint=cnf.Adjoint.DIRECT, direct_max_steps=128)
    g_r = jax.grad(lambda a: jnp.sum(jodeint(jfield, jnp.asarray(y0.numpy()), 0.0, 2.0, {"a": a}, jopts) ** 2))(0.9)
    np.testing.assert_allclose(g_dir, float(g_r), rtol=1e-5)


@pytest.fixture(scope="module")
def problem():
    ps_np = _np_params(DIMS, 21)
    xs = np.random.default_rng(22).uniform(size=(B, NVARS)).astype(np.float32)
    key = jax.random.PRNGKey(23)
    eps_key, steer_key = jax.random.split(key)
    jicnf = _model(cnf, False, DIRECT)
    eps = np.array(jicnf.draw_eps(eps_key, B))
    r = float(jax.random.uniform(steer_key, (), jnp.float32, -0.1, 0.1))
    return ps_np, xs, key, eps, r


def _jax_loss_grad(jicnf, ps_np, xs, key, eps):
    def f(p, e):
        return cnf.loss_and_metrics(jicnf, cnf.Mode.TRAIN, jnp.asarray(xs), p, key=key, eps=e)

    (l, m), (g_p, g_e) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, ps_np), jnp.asarray(eps))
    return float(l), [np.asarray(x) for x in _leaves(g_p)] + [np.asarray(g_e)], int(m["nfe"])


def _torch_loss_grad(ticnf, ps_np, xs, eps, r):
    ps = tcnf.params_from_numpy(ps_np)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    e = torch.from_numpy(eps).requires_grad_()
    l, m = tcnf.loss_and_metrics(ticnf, tcnf.Mode.TRAIN, xs, ps, eps=e, steer_r=r)
    return float(l.detach()), [x.numpy() for x in torch.autograd.grad(l, leaves + [e])], int(m["nfe"])


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("solver_kw", [DIRECT, FIXED], ids=["direct", "fixed-rk4"])
def test_train_loss_and_gradient_match_jax_grad(problem, fused, solver_kw):
    """The steered RNODE TRAIN loss and its gradient in the params and the
    probes through the recorded solve, against `jax.grad` of the JAX
    package's loss with the same draws: fused=True runs the K10 field (its
    plain version here, the interpreted kernel in the JAX package),
    fused=False the Hutchinson field.  Equal NFE, the loss within 1e-5 and
    each gradient within 1e-4 of its largest entry; the probe gradient is
    nonzero (BACKSOLVE defines it as zero)."""
    ps_np, xs, key, eps, r = problem
    l_r, g_r, nfe_r = _jax_loss_grad(_model(cnf, fused, solver_kw), ps_np, xs, key, eps)
    l, g, nfe = _torch_loss_grad(_model(tcnf, fused, solver_kw), ps_np, xs, eps, r)
    assert nfe == nfe_r
    assert abs(l - l_r) <= LOSS_TOL * max(1.0, abs(l_r))
    for a, b in zip(g, g_r):
        assert _rel(a, b) <= GRAD_REL
    assert np.abs(g[-1]).max() > 1e-3


def test_direct_train_solve_evaluates_k10_at_every_stage(problem, monkeypatch):
    """Under DIRECT with fused=True no whole-solve kernel is built and every
    field evaluation goes through K10's wrapper: 6 per attempted tsit5 step
    plus the first evaluation and the Hairer pick's second."""
    ps_np, xs, _, eps, r = problem
    calls = []
    wrapper = tfd.run_fused_field_kernel

    def counting(*a):
        calls.append(a[4].shape)
        return wrapper(*a)

    monkeypatch.setattr(tfd, "run_fused_field_kernel", counting)
    icnf = _model(tcnf, True, DIRECT)
    assert tfs.make_full_solve(icnf, tcnf.Mode.TRAIN, B) is None
    with torch.no_grad():
        _, _, st = tcnf.inference(icnf, tcnf.Mode.TRAIN, xs, tcnf.params_from_numpy(ps_np), eps=eps, steer_r=r)
    assert len(calls) == 6 * int(st.steps) + 2 == int(st.nfe)
    assert all(s == (B, NVARS + NAUG) for s in calls)


def test_fit_under_direct_matches_the_unfused_field():
    """`fit` for two epochs of two Lion steps under DIRECT: the K10 field
    and the Hutchinson field give the same losses and params (the same
    math)."""
    X = np.random.default_rng(30).uniform(size=(2 * B, NVARS)).astype(np.float32)
    ps_np = _np_params(DIMS, 31)
    res = []
    for fused in (True, False):
        model = tcnf.ICNFModel(_model(tcnf, fused, DIRECT), n_epochs=2, batch_size=B)
        res.append(tcnf.fit(model, X, ps=tcnf.params_from_numpy(ps_np), seed=0))
    assert len(res[0].losses) == 2 and np.isfinite(res[0].losses).all()
    np.testing.assert_allclose(res[0].losses, res[1].losses, rtol=1e-5)
    for a, b in zip(_leaves(res[0].ps), _leaves(res[1].ps)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0, atol=1e-6)
    assert not np.allclose(_leaves(res[0].ps)[0].detach().numpy(), ps_np[0]["w"])


def test_fit_pads_a_batch_more_than_twice_the_data():
    """Five samples at batch 16: one step over the five and eleven
    zero-weight repeats, with the loss of the five alone (the step's loss is
    taken before its update; the exact trace draws nothing)."""
    X = np.random.default_rng(32).uniform(size=(5, NVARS)).astype(np.float32)
    ps_np = _np_params(DIMS, 33)
    icnf = tcnf.construct(tcnf.RNODE, tcnf.MLP(DIMS), NVARS, NAUG, compute_mode=tcnf.VecJacMode(exact_trace=True),
                          solver=_solver(tcnf, FIXED))
    res = tcnf.fit(tcnf.ICNFModel(icnf, n_epochs=1, batch_size=16), X, ps=tcnf.params_from_numpy(ps_np), seed=0)
    assert res.losses.shape == (1,) and np.isfinite(res.losses).all()
    unpadded = tcnf.fit(tcnf.ICNFModel(icnf, n_epochs=1, batch_size=5), X, ps=tcnf.params_from_numpy(ps_np), seed=0)
    np.testing.assert_allclose(res.losses, unpadded.losses, rtol=1e-5)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_generate_gradient_under_direct_matches_jax(fused):
    """The params-gradient of a weighted sum of TEST-mode samples under
    DIRECT (the plain forward, recorded, whatever `fused` says) against
    `jax.grad` of the JAX package's `generate` from the same base draw."""
    ps_np = _np_params(DIMS, 41)
    key = jax.random.PRNGKey(42)
    jicnf = _model(cnf, fused, DIRECT, steer_rate=0.0)
    z1 = np.array(jicnf.base_sample(jax.random.split(key, 3)[0], (B,)))
    w = np.random.default_rng(43).normal(size=(B, NVARS)).astype(np.float32)
    g_r = jax.grad(lambda p: jnp.sum(cnf.generate(jicnf, cnf.Mode.TEST, p, B, key=key) * w))(
        jax.tree.map(jnp.asarray, ps_np))
    ps = tcnf.params_from_numpy(ps_np)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    s = tcnf.generate(_model(tcnf, fused, DIRECT, steer_rate=0.0), tcnf.Mode.TEST, ps, B, z1=z1)
    g = torch.autograd.grad(torch.sum(s * torch.from_numpy(w)), leaves)
    for a, b in zip(g, _leaves(g_r)):
        assert _rel(a.numpy(), b) <= GRAD_REL


def test_none_adjoint_still_raises_under_grad(problem):
    ps_np, xs, _, eps, r = problem
    icnf = _model(tcnf, True, dict(adjoint="none"))
    ps = tcnf.params_from_numpy(ps_np)
    [x.requires_grad_() for x in _leaves(ps)]
    with pytest.raises(NotImplementedError, match="Adjoint.NONE"):
        tcnf.loss(icnf, tcnf.Mode.TRAIN, xs, ps, eps=eps, steer_r=r)
    with torch.no_grad():
        assert torch.isfinite(tcnf.loss(icnf, tcnf.Mode.TRAIN, xs, ps, eps=eps, steer_r=r))
