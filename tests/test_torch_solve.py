"""Parity of the PyTorch port's ODE layer with the JAX package: tableaus,
the adaptive solve on the TEST field (final state and exact step counts),
the solver options, and the seeded accumulator."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import continuousnf_tpu as cnf
import continuousnf_tpu_torch as tcnf
from continuousnf_tpu.core.dynamics import TestState as JTestState
from continuousnf_tpu.core.dynamics import make_augmented_dynamics as jdyn
from continuousnf_tpu.ode import tableaus as jtab
from continuousnf_tpu.ode.solve import odeint_with_stats as jodeint
from continuousnf_tpu.ops.fused_solve import make_full_solve as jfull
from continuousnf_tpu_torch.core.dynamics import TestState as TState
from continuousnf_tpu_torch.core.dynamics import make_augmented_dynamics as tdyn
from continuousnf_tpu_torch.ode import tableaus as ttab
from continuousnf_tpu_torch.ode.solve import odeint_with_stats as todeint
from continuousnf_tpu_torch.ops.fused_solve import make_full_solve as tfull

# The port's entry points default to the CUDA card; these tests run it on the CPU.
tcnf.set_default_device("cpu")

TOL = dict(rtol=1e-4, atol=1e-4)


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


def _problem(dims=(5, 15, 5), B=16, seed=0, dlogp_scale=0.0):
    rng = np.random.default_rng(seed + 100)
    z0 = rng.normal(size=(B, dims[-1])).astype(np.float32)
    dlogp0 = (dlogp_scale * rng.normal(size=(B,))).astype(np.float32)
    return _np_params(dims, seed), z0, dlogp0


def _run_jax(dims, ps_np, z0, dlogp0, t0, t1, opts, fused=False):
    nn = cnf.MLP(dims)
    f = jdyn(nn, cnf.Mode.TEST, cnf.VecJacMode(), False, False)
    args = {"ps": jax.tree.map(jnp.asarray, ps_np)}
    fs = None
    if fused:
        icnf = cnf.construct(cnf.FFJORD, nn, dims[-1], compute_mode=cnf.VecJacMode(fused=True), solver=opts)
        fs = jfull(icnf, cnf.Mode.TEST, z0.shape[0])
    yT, st = jodeint(f, JTestState(jnp.asarray(z0), jnp.asarray(dlogp0)), t0, t1, args, opts, full_solve=fs)
    return np.asarray(yT.z), np.asarray(yT.dlogp), st


def _run_torch(dims, ps_np, z0, dlogp0, t0, t1, opts, fused=False):
    nn = tcnf.MLP(dims)
    f = tdyn(nn, tcnf.Mode.TEST, tcnf.VecJacMode(), False, False)
    args = {"ps": tcnf.params_from_numpy(ps_np)}
    fs = None
    if fused:
        icnf = tcnf.construct(tcnf.FFJORD, nn, dims[-1], compute_mode=tcnf.VecJacMode(fused=True), solver=opts)
        fs = tfull(icnf, tcnf.Mode.TEST, z0.shape[0])
        assert fs is not None
    yT, st = todeint(
        f, TState(torch.from_numpy(z0), torch.from_numpy(dlogp0)), t0, t1, args, opts, full_solve=fs
    )
    return yT.z.numpy(), yT.dlogp.numpy(), st


def _assert_match(ref, got, dt_last=True):
    z_r, l_r, st_r = ref
    z_t, l_t, st_t = got
    np.testing.assert_allclose(z_t, z_r, **TOL)
    np.testing.assert_allclose(l_t, l_r, **TOL)
    assert int(st_t.steps) == int(st_r.steps)
    assert int(st_t.accepted) == int(st_r.accepted)
    assert int(st_t.nfe) == int(st_r.nfe)
    if dt_last:
        # The last step size comes from an eest at f32 roundoff level just
        # above the 1e-4 floor (the field is smooth and the steps are long),
        # so any other order of f32 sums moves it: the JAX package's own XLA
        # path and its interpret-mode kernel differ by up to 9% on these
        # problems.  Exact equality holds between the port's two paths
        # (test_fused_solve_matches_plain_exactly_on_cpu).
        assert float(st_t.dt_last) == pytest.approx(float(st_r.dt_last), rel=0.1)


@pytest.mark.parametrize("name", sorted(ttab.TABLEAUS))
def test_tableaus_equal_reference(name):
    assert dataclasses.asdict(ttab.TABLEAUS[name]) == dataclasses.asdict(jtab.TABLEAUS[name])
    for rtol in (1e-3, 1e-5, 1e-8):
        assert ttab.select_method(rtol) == jtab.select_method(rtol)


def test_trbdf2_not_ported():
    assert set(jtab.TABLEAUS) - set(ttab.TABLEAUS) == {"trbdf2"}
    with pytest.raises(NotImplementedError, match="item 17"):
        ttab.get_tableau("trbdf2", 1e-3)


@pytest.mark.parametrize(
    "dims,B,span",
    [((5, 15, 5), 16, (0.0, 1.0)), ((16, 48, 16), 32, (0.0, 13.0)), ((5, 15, 5), 16, (1.0, 0.0))],
    ids=["small", "flagship-width", "reverse-time"],
)
def test_odeint_test_field_matches_jax(dims, B, span):
    ps_np, z0, dlogp0 = _problem(dims, B)
    opts = cnf.SolverOptions()
    ref = _run_jax(dims, ps_np, z0, dlogp0, *span, opts)
    got = _run_torch(dims, ps_np, z0, dlogp0, *span, tcnf.SolverOptions())
    _assert_match(ref, got)


@pytest.mark.parametrize(
    "kw",
    [
        dict(method="dopri5"),
        dict(method="bosh3"),
        dict(method="verner65", rtol=1e-5),
        dict(method="dop853", rtol=1e-6),
        dict(method="auto", rtol=1e-5),
        dict(dt0=0.05),
        dict(method="rk4", fixed_num_steps=7),
        dict(adjoint="direct"),
    ],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()),
)
def test_solver_options_match_jax(kw):
    dims = (5, 15, 5)
    ps_np, z0, dlogp0 = _problem(dims, 8, seed=1)
    jkw, tkw = dict(kw), dict(kw)
    if "adjoint" in kw:
        jkw["adjoint"], tkw["adjoint"] = cnf.Adjoint.DIRECT, tcnf.Adjoint.DIRECT
    ref = _run_jax(dims, ps_np, z0, dlogp0, 0.0, 2.0, cnf.SolverOptions(**jkw))
    got = _run_torch(dims, ps_np, z0, dlogp0, 0.0, 2.0, tcnf.SolverOptions(**tkw))
    _assert_match(ref, got, dt_last=False)
    if "adjoint" in kw or "fixed_num_steps" in kw:
        assert got[2].dt_last is None


def test_max_steps_caps_the_solve():
    """A capped solve stops at the same count; where it stops in time depends
    on step sizes set by a roundoff-level eest, so only counts are compared."""
    dims = (5, 15, 5)
    ps_np, z0, dlogp0 = _problem(dims, 8, seed=1)
    _, _, st_r = _run_jax(dims, ps_np, z0, dlogp0, 0.0, 2.0, cnf.SolverOptions(max_steps=3))
    z, dlogp, st = _run_torch(dims, ps_np, z0, dlogp0, 0.0, 2.0, tcnf.SolverOptions(max_steps=3))
    assert (int(st.steps), int(st.accepted), int(st.nfe)) == (3, int(st_r.accepted), int(st_r.nfe))
    assert np.isfinite(z).all() and np.isfinite(dlogp).all()


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_nonzero_initial_dlogp_is_carried(fused):
    """The accumulator starts from the incoming dlogp on both port paths;
    the JAX package's unfused solve is the reference (its TPU kernel starts
    the accumulator at zero)."""
    dims = (5, 15, 5)
    ps_np, z0, dlogp0 = _problem(dims, 16, seed=2, dlogp_scale=3.0)
    ref = _run_jax(dims, ps_np, z0, dlogp0, 0.0, 1.0, cnf.SolverOptions())
    got = _run_torch(dims, ps_np, z0, dlogp0, 0.0, 1.0, tcnf.SolverOptions(), fused=fused)
    _assert_match(ref, got)
    assert np.abs(got[1]).min() > 0.0


def test_tstops_not_ported():
    """Forced stops chain segment solves: the port's plain solve and its
    fused one (the K3 twin per segment, each seeded with the incoming dlogp)
    against the JAX package's unfused solve (its kernel restarts dlogp at
    zero each segment): equal summed steps and NFE, the last segment's
    dt_last, values within 1e-4."""
    dims = (5, 15, 5)
    ps_np, z0, dlogp0 = _problem(dims, 16, seed=5, dlogp_scale=1.0)
    ref = _run_jax(dims, ps_np, z0, dlogp0, 0.0, 1.0, cnf.SolverOptions(tstops=(0.3, 0.6)))
    for fused in (False, True):
        got = _run_torch(dims, ps_np, z0, dlogp0, 0.0, 1.0, tcnf.SolverOptions(tstops=(0.3, 0.6)), fused=fused)
        _assert_match(ref, got)
    one = _run_torch(dims, ps_np, z0, dlogp0, 0.0, 1.0, tcnf.SolverOptions())
    assert int(got[2].steps) > int(one[2].steps)


def test_gradients_raise_instead_of_recording_a_graph():
    """An Adjoint.NONE solve has no backward: it raises when its inputs
    require grad (and runs under no_grad).  The DIRECT and fixed-step solves
    record a graph, as BACKSOLVE records its adjoint."""
    dims = (5, 15, 5)
    ps_np, z0, dlogp0 = _problem(dims, 4)
    nn = tcnf.MLP(dims)
    f = tdyn(nn, tcnf.Mode.TEST, tcnf.VecJacMode(), False, False)
    ps = tuple({k: v.requires_grad_() for k, v in p.items()} for p in tcnf.params_from_numpy(ps_np))
    y0 = TState(torch.from_numpy(z0), torch.from_numpy(dlogp0))
    none = tcnf.SolverOptions(adjoint=tcnf.Adjoint.NONE)
    with pytest.raises(NotImplementedError, match="Adjoint.NONE"):
        todeint(f, y0, 0.0, 1.0, {"ps": ps}, none)
    with torch.no_grad():
        yT, _ = todeint(f, y0, 0.0, 1.0, {"ps": ps}, none)
    assert not yT.z.requires_grad
    for opts in (tcnf.SolverOptions(adjoint=tcnf.Adjoint.DIRECT), tcnf.SolverOptions(fixed_num_steps=4),
                 tcnf.SolverOptions()):
        yT, _ = todeint(f, y0, 0.0, 1.0, {"ps": ps}, opts)
        assert yT.z.requires_grad and yT.dlogp.requires_grad
