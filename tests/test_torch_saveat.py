"""tstops, trajectories (`odeint_saveat`, `inference(..., trajectory=True)`)
and the statistics of the backward solve (`backsolve_stats`,
`adjoint_stats`) in the port against the JAX package on the CPU.

The JAX package's fused forward kernel restarts its accumulators at zero in
every segment, so its fused tstops and trajectory solves lose the dlogp of
every segment but the last; the port's fused solves seed them, and are held
against the JAX package's unfused path.  Its `_solve_saveat` integrates over
`saveat` itself; the port's grid is t0, the points of `saveat` strictly
inside the span, t1, which is the same grid wherever `saveat` holds both
ends (the trajectory example's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import continuousnf_tpu as cnf
import continuousnf_tpu_torch as tcnf
from continuousnf_tpu.core.dynamics import TestState as JTestState
from continuousnf_tpu.core.dynamics import make_augmented_dynamics as jdyn
from continuousnf_tpu.ode import solve as jsolve
from continuousnf_tpu_torch.core.dynamics import TestState as TState
from continuousnf_tpu_torch.core.dynamics import make_augmented_dynamics as tdyn
from continuousnf_tpu_torch.ode import solve as tsolve
from continuousnf_tpu_torch.ops import fused_solve as tfs

# The port's entry points default to the CUDA card; these tests run it on the CPU.
tcnf.set_default_device("cpu")

DIMS, NVARS, NAUG, B = (5, 15, 5), 3, 2, 16
TRAJ_DIMS = (2, 8, 8, 2)  # the trajectory example's 3-layer FFJORD net, narrowed
VAL_REL = 1e-5  # values against the JAX package: the same solve, f32 roundoff
GRAD_REL = 1e-4
# The port's fused gradient against its plain one: two backward step grids
# (the JAX package's own bound, tests/test_fused_solve.py::test_grad_parity).
FUSED_GRAD_TOL = dict(rtol=2e-3, atol=2e-4)


def _np_params(dims, seed):
    rng = np.random.default_rng(seed)
    ps = []
    for din, dout in zip(dims[:-1], dims[1:]):
        lim = np.sqrt(6.0 / (din + dout))
        ps.append({"w": rng.uniform(-lim, lim, (din, dout)).astype(np.float32),
                   "b": rng.normal(0.0, 0.1, (dout,)).astype(np.float32)})
    return tuple(ps)


def _leaves(ps):
    return [p[k] for p in ps for k in ("w", "b")]


def _close(got, ref, rel=VAL_REL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * max(1.0, np.abs(ref).max())


def _counts(st):
    return int(st.steps), int(st.accepted), int(st.nfe)


def _rnode(m, fused, **solver):
    if "adjoint" in solver:
        solver["adjoint"] = m.Adjoint(solver["adjoint"])
    return m.construct(m.RNODE, m.MLP(DIMS), NVARS, NAUG, tspan=(0.0, 1.0), steer_rate=0.1, lam3=1e-2,
                       compute_mode=m.VecJacMode(fused=fused), solver=m.SolverOptions(**solver))


@pytest.fixture(scope="module")
def problem():
    ps_np = _np_params(DIMS, 51)
    xs = np.random.default_rng(52).uniform(size=(B, NVARS)).astype(np.float32)
    key = jax.random.PRNGKey(53)
    eps_key, steer_key = jax.random.split(key)
    eps = np.array(_rnode(cnf, False).draw_eps(eps_key, B))
    r = float(jax.random.uniform(steer_key, (), jnp.float32, -0.1, 0.1))
    return ps_np, xs, key, eps, r


@pytest.mark.parametrize("mode", ["test", "train"])
def test_tstops_inference_matches_jax_unfused(problem, mode):
    """`inference` with tstops through the port's plain and fused paths (K3
    or K1's twin per segment, from the previous segment's accumulators)
    against the JAX package's unfused path: logp and the regularizers within
    1e-5, equal summed steps, accepted steps and NFE."""
    ps_np, xs, key, eps, r = problem
    jmode, tmode = (cnf.Mode.TEST, tcnf.Mode.TEST) if mode == "test" else (cnf.Mode.TRAIN, tcnf.Mode.TRAIN)
    lp_r, regs_r, st_r = cnf.inference(_rnode(cnf, False, tstops=(0.3, 0.7)), jmode, jnp.asarray(xs),
                                       jax.tree.map(jnp.asarray, ps_np), key=key)
    kw = dict(eps=eps, steer_r=r) if mode == "train" else {}
    for fused in (False, True):
        with torch.no_grad():
            lp, regs, st = tcnf.inference(_rnode(tcnf, fused, tstops=(0.3, 0.7)), tmode, xs,
                                          tcnf.params_from_numpy(ps_np), **kw)
        _close(lp, lp_r)
        for a, b in zip(regs, regs_r):
            _close(a, b)
        assert _counts(st) == _counts(st_r)


def test_tstops_gradients(problem):
    """BACKSOLVE through tstops segments: the port's plain gradient against
    `jax.grad` of the JAX package's unfused one within 1e-4, the fused one
    (K1 and K2's twins per segment) against the plain one at the JAX
    package's fused/plain bound; DIRECT through tstops with the K10 field
    against the JAX package's (its interpreted K10) within 1e-4."""
    ps_np, xs, key, eps, r = problem
    jps = jax.tree.map(jnp.asarray, ps_np)

    def jgrad(icnf):
        g = jax.grad(lambda p: cnf.loss(icnf, cnf.Mode.TRAIN, jnp.asarray(xs), p, key=key))(jps)
        return [np.asarray(x) for x in _leaves(g)]

    def tgrad(icnf):
        ps = tcnf.params_from_numpy(ps_np)
        leaves = [x.requires_grad_() for x in _leaves(ps)]
        return [g.numpy() for g in torch.autograd.grad(
            tcnf.loss(icnf, tcnf.Mode.TRAIN, xs, ps, eps=eps, steer_r=r), leaves)]

    g_r = jgrad(_rnode(cnf, False, tstops=(0.3, 0.7)))
    g_p = tgrad(_rnode(tcnf, False, tstops=(0.3, 0.7)))
    g_k = tgrad(_rnode(tcnf, True, tstops=(0.3, 0.7)))
    for a, b, c in zip(g_p, g_r, g_k):
        _close(a, b, GRAD_REL)
        np.testing.assert_allclose(c, a, **FUSED_GRAD_TOL)
    direct = dict(tstops=(0.3, 0.7), adjoint="direct", direct_max_steps=32)
    for a, b in zip(tgrad(_rnode(tcnf, True, **direct)), jgrad(_rnode(cnf, True, **direct))):
        _close(a, b, GRAD_REL)


def test_odeint_saveat_matches_jax():
    """`odeint_saveat` over a five-point grid on the TEST field: the stacked
    states (the first is y0) within 1e-5 and the summed counts, against the
    JAX package's."""
    ps_np = _np_params(DIMS, 54)
    rng = np.random.default_rng(55)
    z0 = rng.normal(size=(B, 5)).astype(np.float32)
    dlogp0 = rng.normal(size=(B,)).astype(np.float32)
    grid = [0.0, 0.2, 0.5, 0.6, 1.0]
    fj = jdyn(cnf.MLP(DIMS), cnf.Mode.TEST, cnf.VecJacMode(), False, False)
    states_r, st_r = jsolve.odeint_saveat(fj, JTestState(jnp.asarray(z0), jnp.asarray(dlogp0)), grid,
                                          {"ps": jax.tree.map(jnp.asarray, ps_np)})
    ft = tdyn(tcnf.MLP(DIMS), tcnf.Mode.TEST, tcnf.VecJacMode(), False, False)
    states, st = tsolve.odeint_saveat(ft, TState(torch.from_numpy(z0), torch.from_numpy(dlogp0)), grid,
                                      {"ps": tcnf.params_from_numpy(ps_np)})
    assert isinstance(states, TState) and tuple(states.z.shape) == (5, B, 5)
    assert torch.equal(states.z[0], torch.from_numpy(z0))
    for a, b in zip(states, states_r):
        _close(a, b)
    assert _counts(st) == _counts(st_r)
    # A bare tensor state stacks to one tensor.
    decay = lambda t, y, args: -y  # noqa: E731
    ys, _ = tsolve.odeint_saveat(decay, torch.ones(3), grid)
    _close(ys, np.exp(-np.asarray(grid))[:, None] * np.ones((1, 3)), 1e-3)


def _ffjord(m, fused, saveat=None):
    return m.construct(m.FFJORD, m.MLP(TRAJ_DIMS), 2, 0, tspan=(0.0, 1.0), compute_mode=m.VecJacMode(fused=fused),
                       solver=m.SolverOptions(saveat=saveat))


@pytest.mark.parametrize("saveat", [tuple(np.linspace(0.0, 1.0, 9)), None], ids=["linspace", "default-17"])
def test_trajectory_matches_jax_unfused(saveat):
    """`inference(..., trajectory=True)` on a narrowed form of the trajectory
    example (FFJORD, a 3-layer tanh net; the port's fused path runs K7
    TEST's twin per segment): ts, zs, logp and the summed counts against the
    JAX package's unfused path; a single sample squeezes zs to (T, zdim)."""
    ps_np = _np_params(TRAJ_DIMS, 56)
    xs = np.random.default_rng(57).normal(size=(12, 2)).astype(np.float32)
    lp_r, _, st_r, (ts_r, zs_r) = cnf.inference(_ffjord(cnf, False, saveat), cnf.Mode.TEST, jnp.asarray(xs),
                                                jax.tree.map(jnp.asarray, ps_np), trajectory=True)
    ps = tcnf.params_from_numpy(ps_np)
    for fused in (False, True):
        with torch.no_grad():
            lp, _, st, (ts, zs) = tcnf.inference(_ffjord(tcnf, fused, saveat), tcnf.Mode.TEST, xs, ps,
                                                 trajectory=True)
        _close(ts, ts_r)
        _close(zs, zs_r)
        _close(lp, lp_r)
        assert _counts(st) == _counts(st_r)
    with torch.no_grad():
        lp1, _, _, (ts1, zs1) = tcnf.inference(_ffjord(tcnf, True, saveat), tcnf.Mode.TEST, xs[0], ps,
                                               trajectory=True)
    assert lp1.shape == () and tuple(zs1.shape) == (len(ts1), 2)
    _close(zs1, zs_r[:, 0])


def test_saveat_without_the_span_ends_integrates_the_whole_span():
    """A `saveat` that omits t0 and t1: the port's grid adds them, so the
    trajectory ends at t1 with the logp of the same grid given with its
    ends, and within the solver's tolerance of the one-segment solve."""
    ps_np = _np_params(TRAJ_DIMS, 58)
    xs = np.random.default_rng(59).normal(size=(12, 2)).astype(np.float32)
    ps = tcnf.params_from_numpy(ps_np)
    with torch.no_grad():
        lp, _, _, (ts, zs) = tcnf.inference(_ffjord(tcnf, True, (0.25, 0.5, 0.75, 3.0)), tcnf.Mode.TEST, xs, ps,
                                            trajectory=True)
        lp_ends, _, _, (ts_ends, _) = tcnf.inference(_ffjord(tcnf, True, (0.0, 0.25, 0.5, 0.75, 1.0)), tcnf.Mode.TEST,
                                                     xs, ps, trajectory=True)
        lp_one, _, _ = tcnf.inference(_ffjord(tcnf, True), tcnf.Mode.TEST, xs, ps)
    assert ts.tolist() == ts_ends.tolist() == [0.0, 0.25, 0.5, 0.75, 1.0]
    assert torch.equal(lp, lp_ends)
    _close(lp, lp_one, 1e-3)


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_adjoint_stats_match_jax(problem, mode, fused):
    """`adjoint_stats`: the forward's and the backward integration's counts
    against the JAX package's with the same fused setting (its kernels in
    interpret mode where fused), and the backward's against the backward
    that the port's gradient actually ran (the fused adjoint wrapper's, or
    the plain backward's)."""
    ps_np, xs, key, eps, r = problem
    train = mode == "train"
    jmode, tmode = (cnf.Mode.TRAIN, tcnf.Mode.TRAIN) if train else (cnf.Mode.TEST, tcnf.Mode.TEST)
    kw = dict(eps=eps, steer_r=r) if train else {}
    fwd_r, bwd_r = cnf.adjoint_stats(_rnode(cnf, fused), jmode, jnp.asarray(xs), jax.tree.map(jnp.asarray, ps_np),
                                     key=key)
    icnf = _rnode(tcnf, fused)
    fwd, bwd = tcnf.adjoint_stats(icnf, tmode, xs, tcnf.params_from_numpy(ps_np), **kw)
    assert _counts(fwd) == _counts(fwd_r)
    assert _counts(bwd) == _counts(bwd_r)

    ran = []
    if fused:
        name = "run_adjoint_kernel" if train else "run_test_adjoint_kernel"
        wrapper = getattr(tfs, name)

        def recording(*a, **k):
            out = wrapper(*a, **k)
            ran.append(int(out[5]))
            return out

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tfs, name, recording)
            _grad_steps(icnf, tmode, xs, ps_np, kw)
    else:
        from continuousnf_tpu_torch.ode import adjoint as tadj

        real = tadj._backward_integrate

        def recording(*a, **k):
            out = real(*a, **k)
            ran.append(int(out[4].steps))
            return out

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tadj, "_backward_integrate", recording)
            _grad_steps(icnf, tmode, xs, ps_np, kw)
    assert ran == [int(bwd.steps)]


def _grad_steps(icnf, mode, xs, ps_np, kw):
    ps = tcnf.params_from_numpy(ps_np)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    torch.autograd.grad(tcnf.loss(icnf, mode, xs, ps, **kw), leaves)


def test_backsolve_stats_matches_jax():
    """`backsolve_stats` on the decay ODE: the final state and both solves'
    counts against the JAX package's."""
    decay_t = lambda t, y, args: -args["rate"] * y  # noqa: E731
    decay_j = lambda t, y, args: -args["rate"] * y  # noqa: E731
    yT_r, fwd_r, bwd_r = jsolve.backsolve_stats(decay_j, jnp.asarray([2.0, 1.0]), 0.0, 0.8,
                                                {"rate": jnp.asarray(1.5)}, lambda y: jnp.sum(y ** 2))
    yT, fwd, bwd = tsolve.backsolve_stats(decay_t, torch.tensor([2.0, 1.0]), 0.0, 0.8, {"rate": torch.tensor(1.5)},
                                          lambda y: torch.sum(y ** 2))
    _close(yT, yT_r)
    assert _counts(fwd) == _counts(fwd_r) and _counts(bwd) == _counts(bwd_r)
