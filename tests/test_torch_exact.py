"""The port's exact-trace TRAIN slice against the JAX package on the CPU: the
closed forms, the exact TRAIN field, the exact fused stages and their
hand-derived VJP, the K4 forward and adjoint twins against the JAX package's
kernels in interpret mode, TRAIN `inference`, the loss and its gradients,
the eligibility of the fused exact solve, and `fit`.

Inputs come from numpy seeds; the exact field draws no probes, and the
JAX steering draw is reproduced from its key split (`core/icnf.py:485`)
and handed to the port as `steer_r`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import continuousnf_tpu as cnf
import continuousnf_tpu_torch as tcnf
from continuousnf_tpu.core.dynamics import TrainState as JTrainState
from continuousnf_tpu.core.dynamics import exact_tanh_mlp_trace_fro as jtrace_fro
from continuousnf_tpu.core.dynamics import make_augmented_dynamics as jdyn
from continuousnf_tpu.ode.solve import odeint_with_stats as jodeint
from continuousnf_tpu.ode.tableaus import TSIT5 as JTSIT5
from continuousnf_tpu.ops import fused_solve as jfs
from continuousnf_tpu.ops.fused_dynamics import exact_dense_chain_jacobian as jchain_jac
from continuousnf_tpu_torch.core.dynamics import TrainState as TTrainState
from continuousnf_tpu_torch.core.dynamics import exact_tanh_mlp_trace_fro as ttrace_fro
from continuousnf_tpu_torch.core.dynamics import make_augmented_dynamics as tdyn
from continuousnf_tpu_torch.ode.tableaus import TSIT5
from continuousnf_tpu_torch.ops import fused_solve as tfs
from continuousnf_tpu_torch.ops.fused_dynamics import exact_dense_chain_jacobian as tchain_jac

# The port's entry points default to the CUDA card; these tests run it on the CPU.
tcnf.set_default_device("cpu")

TOL = dict(rtol=1e-4, atol=1e-4)
FIELD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
DIMS, DEEP, NVARS, NAUG, B = (5, 15, 5), (5, 9, 7, 5), 3, 2, 16


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


def _jps(ps_np):
    return jax.tree.map(jnp.asarray, ps_np)


def _model(m, fused=False, dims=DIMS, **kw):
    kw = {"tspan": (0.0, 1.0), "steer_rate": 0.1, "lam3": 1e-2, **kw}
    cm = kw.pop("compute_mode", m.VecJacMode(fused=fused, exact_trace=True))
    return m.construct(m.RNODE, m.MLP(dims), dims[-1] - NAUG, NAUG, compute_mode=cm, **kw)


def _steer_draw(icnf, key):
    """The steering r that JAX `inference` draws from `key`."""
    _, steer_key = jax.random.split(key)
    return float(jax.random.uniform(steer_key, (), jnp.float32, -icnf.steer_rate, icnf.steer_rate))


def _leaves(ps):
    return [p[k] for p in ps for k in ("w", "b")]


@pytest.mark.parametrize("dims", [(16, 48, 16), DIMS, DEEP], ids=["flagship", "small", "three-layer"])
def test_closed_forms_match_jax(dims):
    """exact_tanh_mlp_trace_fro (2-layer) and exact_dense_chain_jacobian
    against the JAX package at the flagship widths and on a 3-layer chain."""
    ps_np = _np_params(dims, 1)
    z = np.random.default_rng(2).normal(size=(B, dims[0])).astype(np.float32)
    tps = tcnf.params_from_numpy(ps_np)
    y_r, J_r = jchain_jac(cnf.MLP(dims), _jps(ps_np), jnp.asarray(z))
    y, J = tchain_jac(tcnf.MLP(dims), tps, torch.from_numpy(z))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **FIELD_TOL)
    np.testing.assert_allclose(J.numpy(), np.asarray(J_r), **FIELD_TOL)
    if len(dims) == 3:
        for a, b in zip(ttrace_fro(tps, torch.from_numpy(z)), jtrace_fro(_jps(ps_np), jnp.asarray(z))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **FIELD_TOL)
        # ... and the closed form agrees with the chain Jacobian.
        _, tr, fro = ttrace_fro(tps, torch.from_numpy(z))
        torch.testing.assert_close(tr, torch.diagonal(J, dim1=1, dim2=2).sum(-1), **FIELD_TOL)
        torch.testing.assert_close(fro, torch.linalg.matrix_norm(J), **FIELD_TOL)


@pytest.mark.parametrize("ad", ["vjp", "jvp"])
@pytest.mark.parametrize("norm_z,norm_j", [(True, True), (False, True), (True, False)])
@pytest.mark.parametrize("dims", [DIMS, DEEP], ids=["two-layer", "three-layer"])
def test_exact_train_field_matches_jax(dims, norm_z, norm_j, ad):
    """f_train_exact (closed form or chain Jacobian) against the JAX field;
    the AD direction does not matter for the closed forms."""
    ps_np = _np_params(dims, 3)
    z = np.random.default_rng(4).normal(size=(B, dims[-1])).astype(np.float32)
    zeros = np.zeros(B, np.float32)
    mode = lambda m: (m.VecJacMode if ad == "vjp" else m.JacVecMode)(exact_trace=True)
    fj = jdyn(cnf.MLP(dims), cnf.Mode.TRAIN, mode(cnf), norm_z, norm_j)
    ft = tdyn(tcnf.MLP(dims), tcnf.Mode.TRAIN, mode(tcnf), norm_z, norm_j)
    ref = fj(0.0, JTrainState(*(jnp.asarray(x) for x in (z, zeros, zeros, zeros))), {"ps": _jps(ps_np)})
    with torch.no_grad():
        got = ft(0.0, TTrainState(torch.from_numpy(z), *(torch.from_numpy(zeros),) * 3),
                 {"ps": tcnf.params_from_numpy(ps_np), "eps": None})
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FIELD_TOL)


def test_generic_exact_field_raises():
    from continuousnf_tpu_torch.nets.modules import Dense

    with pytest.raises(NotImplementedError, match="item 16"):
        tdyn(Dense(5, 5, torch.tanh), tcnf.Mode.TRAIN, tcnf.VecJacMode(exact_trace=True), True, True)


def _stage_inputs(widths, seed):
    dz, N = widths[-1], len(widths) - 1
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B, dz)).astype(np.float32)
    ws = [(0.5 * rng.normal(size=(widths[i], widths[i + 1]))).astype(np.float32) for i in range(N)]
    bs = [(0.1 * rng.normal(size=(widths[i + 1],))).astype(np.float32) for i in range(N)]
    ct_y = rng.normal(size=(B, dz)).astype(np.float32)
    ct_r = rng.normal(size=(3, B)).astype(np.float32)
    jspec = jfs.ChainSpec(tuple(widths[:-1]), tuple(widths[1:]), (True,) * N, 0)
    tspec = tfs.ChainSpec(tuple(widths[:-1]), tuple(widths[1:]), (True,) * N, 0)
    return z, ws, bs, ct_y, ct_r, jspec, tspec


@pytest.mark.parametrize("norm_z,norm_j", [(True, True), (False, True), (True, False)])
@pytest.mark.parametrize("widths", [(5, 15, 5), (16, 48, 16)], ids=["small", "flagship"])
def test_exact_stages_match_jax_and_autograd(widths, norm_z, norm_j):
    """pm and its chain rule, the exact stage and its hand-derived VJP (the
    math of the K4 kernels) against the JAX package's, and the VJP against
    torch.autograd.grad of the port's forward stage, the pm cotangent
    included."""
    z, ws, bs, ct_y, ct_r, jspec, tspec = _stage_inputs(widths, 5)
    T = torch.from_numpy
    jws, jbs = [jnp.asarray(w) for w in ws], [jnp.asarray(b[:, None]) for b in bs]
    jpm = jfs.exact_stage_consts(jws[0], jws[1])
    pm = tfs.exact_stage_consts(T(ws[0]), T(ws[1]))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jpm))
    g_pm = np.random.default_rng(6).normal(size=pm.shape).astype(np.float32)
    for a, b in zip(tfs.exact_pm_chain(T(g_pm), T(ws[0]), T(ws[1])),
                    jfs.exact_pm_chain(jnp.asarray(g_pm), jws[0], jws[1])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FIELD_TOL)

    jy, jkr = jfs._stage_train_exact(jspec, jnp.asarray(z.T), None, jws, jbs, jpm, norm_z, norm_j, "f32")
    ty, tkr = tfs._stage_train_exact(tspec, T(z), [T(w) for w in ws], [T(b) for b in bs], pm, norm_z, norm_j)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy).T, **FIELD_TOL)
    np.testing.assert_allclose(tkr.numpy(), np.asarray(jkr), **FIELD_TOL)

    ref = jfs._stage_train_exact_fwdbwd(
        jspec, jnp.asarray(z.T), None, jws, jbs, jpm, norm_z, norm_j, "f32", jnp.asarray(ct_y.T), jnp.asarray(ct_r)
    )
    got = tfs._stage_train_exact_fwdbwd(
        tspec, T(z), [T(w) for w in ws], [T(b) for b in bs], pm, norm_z, norm_j, T(ct_y), T(ct_r)
    )
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]).T, **FIELD_TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), **FIELD_TOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]).T, **FIELD_TOL)
    for a, b in zip(got[3], ref[3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FIELD_TOL)
    for a, b in zip(got[4], ref[4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[:, 0], **FIELD_TOL)
    np.testing.assert_allclose(got[5].numpy(), np.asarray(ref[5]), **FIELD_TOL)

    leaves = [T(z).requires_grad_()] + [T(w).requires_grad_() for w in ws] + [T(b).requires_grad_() for b in bs]
    pm_leaf = pm.clone().requires_grad_()
    y, kr = tfs._stage_train_exact(tspec, leaves[0], leaves[1:3], leaves[3:], pm_leaf, norm_z, norm_j)
    grads = torch.autograd.grad((y * T(ct_y)).sum() + (kr * T(ct_r)).sum(), leaves + [pm_leaf])
    for a, want in zip([got[2]] + got[3] + got[4] + [got[5]], grads):
        np.testing.assert_allclose(a.numpy(), want.numpy(), **FIELD_TOL)


@pytest.mark.parametrize("norm_z,norm_j", [(True, True), (False, True)])
def test_exact_chain_stage_matches_jax(norm_z, norm_j):
    z, ws, bs, _, _, jspec, tspec = _stage_inputs(DEEP, 7)
    jy, jkr = jfs._stage_train_exact_chain(
        jspec, jnp.asarray(z.T), None, [jnp.asarray(w) for w in ws], [jnp.asarray(b[:, None]) for b in bs],
        norm_z, norm_j, "f32",
    )
    T = torch.from_numpy
    ty, tkr = tfs._stage_train_exact_chain(tspec, T(z), [T(w) for w in ws], [T(b) for b in bs], norm_z, norm_j)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy).T, **FIELD_TOL)
    np.testing.assert_allclose(tkr.numpy(), np.asarray(jkr), **FIELD_TOL)


@pytest.mark.parametrize("dims", [DIMS, DEEP], ids=["two-layer", "three-layer"])
def test_exact_forward_twin_matches_jax_kernel(dims):
    """The K4 forward's plain version (through the wrapper on CPU tensors)
    against the JAX package's forward kernel in interpret mode, from zero
    accumulators (the JAX kernel zeroes them): equal attempted and accepted
    steps, values at 1e-4."""
    ps_np = _np_params(dims, 8)
    xs = np.random.default_rng(9).uniform(size=(B, NVARS)).astype(np.float32)
    z0 = np.concatenate([xs, np.zeros((B, NAUG), np.float32)], axis=1)
    y0f = np.concatenate([z0.ravel(), np.zeros(3 * B, np.float32)])
    jfull = jfs.make_full_solve(_model(cnf, True, dims=dims), cnf.Mode.TRAIN, B)
    yT_r, st_r = jfull.forward(jnp.asarray(y0f), 0.0, 1.0, {"ps": _jps(ps_np), "eps": None, "ys": None})
    tfull = tfs.make_full_solve(_model(tcnf, True, dims=dims), tcnf.Mode.TRAIN, B)
    before = tfs.run_exact_solve_kernel.launches
    with torch.no_grad():
        yT, st = tfull.forward(torch.from_numpy(y0f), torch.tensor(0.0), torch.tensor(1.0),
                               {"ps": tcnf.params_from_numpy(ps_np), "eps": None, "ys": None})
    assert tfs.run_exact_solve_kernel.launches == before
    assert (int(st.steps), int(st.accepted), int(st.nfe)) == (int(st_r.steps), int(st_r.accepted), int(st_r.nfe))
    np.testing.assert_allclose(yT.numpy(), np.asarray(yT_r), **TOL)


def test_exact_forward_twin_seeds_accumulators():
    """From nonzero dlogp / reg_e / reg_n rows, against the JAX package's
    unfused solve (its kernel would start them at zero)."""
    ps_np = _np_params(DIMS, 10)
    rng = np.random.default_rng(11)
    z0 = rng.normal(size=(B, 5)).astype(np.float32)
    acc0 = rng.normal(0.0, 2.0, size=(3, B)).astype(np.float32)
    f = jdyn(cnf.MLP(DIMS), cnf.Mode.TRAIN, cnf.VecJacMode(exact_trace=True), True, True)
    yT, st_r = jodeint(f, JTrainState(jnp.asarray(z0), *(jnp.asarray(a) for a in acc0)), 0.0, 1.0,
                       {"ps": _jps(ps_np)}, cnf.SolverOptions())
    ps = tcnf.params_from_numpy(ps_np)
    spec = tfs.chain_spec(tcnf.MLP(DIMS), 5)
    kw = dict(norm_z=True, norm_j=True, rtol=1e-3, atol=1e-6, max_steps=10_000,
              ws=[p["w"] for p in ps], bs=[p["b"] for p in ps], z0=torch.from_numpy(z0),
              acc0=torch.from_numpy(acc0), t0=torch.tensor(0.0), t1=torch.tensor(1.0), dt_init=None)
    zT, accT, steps, accepted, *_ = tfs.run_exact_solve_kernel(TSIT5, spec, **kw)
    plain = tfs.solve_train_exact_plain(TSIT5, spec, **kw)
    assert torch.equal(zT, plain[0]) and torch.equal(accT, plain[1])
    assert (int(steps), int(accepted)) == (int(st_r.steps), int(st_r.accepted))
    np.testing.assert_allclose(zT.numpy(), np.asarray(yT.z), **TOL)
    for row, ref in zip(accT, (yT.dlogp, yT.reg_e, yT.reg_n)):
        np.testing.assert_allclose(row.numpy(), np.asarray(ref), **TOL)


def test_exact_adjoint_twin_matches_jax_kernel():
    """The K4 adjoint's plain version against the JAX package's adjoint kernel
    in interpret mode, at a batch where the JAX package runs one tile (its
    single-tile numerics are what the port keeps), from the same final state,
    cotangent and warm start: equal steps, chained gradients at 1e-4."""
    ps_np = _np_params(DIMS, 12)
    xs = np.random.default_rng(13).uniform(size=(B, NVARS)).astype(np.float32)
    jspec = jfs.chain_spec(cnf.MLP(DIMS), 5)
    assert jfs._vmem_estimate_adjoint(JTSIT5, jspec, B, 3, 1, True) <= jfs._VMEM_BUDGET_BYTES // 2
    span = 2.0
    jfull = jfs.make_full_solve(_model(cnf, True, tspan=(0.0, span)), cnf.Mode.TRAIN, B)
    z0 = np.concatenate([xs, np.zeros((B, NAUG), np.float32)], axis=1)
    y0f = np.concatenate([z0.ravel(), np.zeros(3 * B, np.float32)])
    args = {"ps": _jps(ps_np), "eps": None, "ys": None}
    yTf, fst = jfull.forward(jnp.asarray(y0f), 0.0, span, args)
    rng = np.random.default_rng(14)
    g_yf = np.concatenate([rng.normal(0.0, 0.1, B * 5), np.full(B, 1.0 / B), np.full(2 * B, 1e-2 / B)]).astype(np.float32)
    dt_warm = float(fst.dt_last)
    y0_r, ay0_r, gargs_r, st_r = jfull.adjoint(yTf, jnp.asarray(g_yf), args, span, 0.0, dt_warm=dt_warm)

    tfull = tfs.make_full_solve(_model(tcnf, True, tspan=(0.0, span)), tcnf.Mode.TRAIN, B)
    targs = {"ps": tcnf.params_from_numpy(ps_np), "eps": None, "ys": None}
    before = tfs.run_exact_adjoint_kernel.launches
    y0, ay0, gargs, st = tfull.adjoint(
        torch.from_numpy(np.array(yTf)), torch.from_numpy(g_yf), targs, torch.tensor(span), torch.tensor(0.0),
        dt_warm=dt_warm,
    )
    assert tfs.run_exact_adjoint_kernel.launches == before
    assert (int(st.steps), int(st.accepted), int(st.nfe)) == (int(st_r.steps), int(st_r.accepted), int(st_r.nfe))
    np.testing.assert_allclose(y0.numpy(), np.asarray(y0_r), **TOL)
    np.testing.assert_allclose(ay0.numpy(), np.asarray(ay0_r), **TOL)
    for a, b in zip(_leaves(gargs["ps"]), _leaves(gargs_r["ps"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert gargs["eps"] is None


def test_exact_adjoint_without_warm_start_picks_over_the_whole_state():
    """Without dt_warm the fused adjoint makes Hairer's pick over the state
    it integrates, g_pm included: the twin with dt_init=None, bit for bit."""
    ps_np = _np_params(DIMS, 15)
    rng = np.random.default_rng(16)
    T = lambda a: torch.from_numpy(a.astype(np.float32))
    zT, azT = T(rng.normal(size=(B, 5))), T(rng.normal(0.0, 0.1, (B, 5)))
    accT, aaccT = T(rng.normal(size=(3, B))), T(rng.normal(0.0, 0.1, (3, B)))
    ps = tcnf.params_from_numpy(ps_np)
    tfull = tfs.make_full_solve(_model(tcnf, True), tcnf.Mode.TRAIN, B)
    y0, ay0, gargs, st = tfull.adjoint(
        torch.cat([zT.reshape(-1), accT.reshape(-1)]), torch.cat([azT.reshape(-1), aaccT.reshape(-1)]),
        {"ps": ps, "eps": None, "ys": None}, torch.tensor(1.0), torch.tensor(0.0),
    )
    ref = tfs.adjoint_train_exact_plain(
        TSIT5, tfs.chain_spec(tcnf.MLP(DIMS), 5), norm_z=True, norm_j=True, rtol=1e-3, atol=1e-6,
        max_steps=10_000, ws=[p["w"] for p in ps], bs=[p["b"] for p in ps], zT=zT, accT=accT, azT=azT,
        aaccT=aaccT, t_hi=torch.tensor(1.0), t_lo=torch.tensor(0.0), dt_init=None,
    )
    assert int(st.steps) == int(ref[5]) and int(st.nfe) == int(ref[5]) * 6 + 2
    assert torch.equal(y0[: B * 5], ref[0].reshape(-1)) and torch.equal(ay0[: B * 5], ref[2].reshape(-1))
    for a, b in zip(_leaves(gargs["ps"]), ref[3][:1] + ref[4][:1] + ref[3][1:] + ref[4][1:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_exact_train_inference_matches_jax(fused):
    """TRAIN `inference` under exact trace against the JAX package's path of
    the same kind (unfused XLA, or its kernel in interpret mode)."""
    ps_np = _np_params(DIMS, 17)
    xs = np.random.default_rng(18).uniform(size=(B, NVARS)).astype(np.float32)
    jicnf = _model(cnf, fused)
    key = jax.random.PRNGKey(19)
    lp_r, regs_r, st_r = cnf.inference(jicnf, cnf.Mode.TRAIN, jnp.asarray(xs), _jps(ps_np), key=key)
    with torch.no_grad():
        lp, regs, st = tcnf.inference(_model(tcnf, fused), tcnf.Mode.TRAIN, xs, tcnf.params_from_numpy(ps_np),
                                      steer_r=_steer_draw(jicnf, key))
    assert (int(st.steps), int(st.accepted), int(st.nfe)) == (int(st_r.steps), int(st_r.accepted), int(st_r.nfe))
    for a, b in ((lp, lp_r), (regs.e, regs_r.e), (regs.n, regs_r.n), (regs.a, regs_r.a)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert float(regs.e.min()) > 0.0 and float(regs.n.min()) > 0.0


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_exact_gradients_match_jax_grad(fused):
    """The loss and its gradients through BACKSOLVE against `jax.grad` of the
    JAX package's loss on the path of the same kind.  Unfused, the adjoint
    takes its stage VJPs from torch.autograd.grad of f_train_exact with no
    probe leaf; fused, it runs the K4 adjoint's twin."""
    ps_np = _np_params(DIMS, 20)
    xs = np.random.default_rng(21).uniform(size=(B, NVARS)).astype(np.float32)
    jicnf = _model(cnf, fused)
    key = jax.random.PRNGKey(22)
    l_r, g_r = jax.value_and_grad(lambda p: cnf.loss(jicnf, cnf.Mode.TRAIN, jnp.asarray(xs), p, key=key))(_jps(ps_np))
    icnf = _model(tcnf, fused)
    assert (tfs.make_full_solve(icnf, tcnf.Mode.TRAIN, B) is None) == (not fused)
    ps = tcnf.params_from_numpy(ps_np)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    l = tcnf.loss(icnf, tcnf.Mode.TRAIN, xs, ps, steer_r=_steer_draw(jicnf, key))
    g = torch.autograd.grad(l, leaves)
    np.testing.assert_allclose(float(l.detach()), float(l_r), **GRAD_TOL)
    for a, b in zip(g, _leaves(g_r)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


def test_eps_rejected_under_exact_trace():
    icnf = _model(tcnf)
    xs = np.zeros((B, NVARS), np.float32)
    with pytest.raises(ValueError, match="exact_trace"):
        tcnf.inference(icnf, tcnf.Mode.TRAIN, xs, tcnf.params_from_numpy(_np_params(DIMS, 1)),
                       eps=np.zeros((B, 5), np.float32))


def test_exact_draws_only_the_steering():
    """No probes are drawn: the generator's first draw is the steering r."""
    icnf = _model(tcnf)
    ps = tcnf.params_from_numpy(_np_params(DIMS, 1))
    xs = np.random.default_rng(23).uniform(size=(B, NVARS)).astype(np.float32)
    with torch.no_grad():
        lp = tcnf.inference(icnf, tcnf.Mode.TRAIN, xs, ps, generator=torch.Generator().manual_seed(0))[0]
        r = (2.0 * torch.rand((), generator=torch.Generator().manual_seed(0)) - 1.0) * icnf.steer_rate
        assert torch.equal(lp, tcnf.inference(icnf, tcnf.Mode.TRAIN, xs, ps, steer_r=r)[0])


@pytest.mark.parametrize("dims", [DIMS, DEEP], ids=["two-layer", "three-layer"])
def test_exact_eligibility(dims):
    """The fused exact solve applies where the JAX package's does; 2-layer
    tanh chains have the backward member, deeper chains none (both
    packages)."""
    ref = jfs.make_full_solve(_model(cnf, True, dims=dims), cnf.Mode.TRAIN, B)
    got = tfs.make_full_solve(_model(tcnf, True, dims=dims), tcnf.Mode.TRAIN, B)
    assert ref is not None and got is not None
    assert (ref.adjoint is None) == (got.adjoint is None) == (len(dims) != 3)


def test_exact_step_body_and_fit():
    """The step body draws no probes; `fit` runs two epochs on the exact
    configuration with finite losses and moving params."""
    ps_np = _np_params(DIMS, 24)
    X = np.random.default_rng(25).uniform(size=(32, NVARS)).astype(np.float32)
    icnf = _model(tcnf, True)
    ps = tcnf.params_from_numpy(ps_np)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    step = tcnf.parallel.make_train_step_body(icnf, tcnf.Lion(leaves, lr=1e-3))
    m = step(ps, X[:B], torch.Generator().manual_seed(0))
    assert np.isfinite(float(m["loss"])) and float(m["n"]) > 0.0
    res = tcnf.fit(tcnf.ICNFModel(icnf, n_epochs=2, batch_size=B), X, ps=tcnf.params_from_numpy(ps_np), seed=1)
    assert res.epochs == 2 and len(res.losses) == 2 and np.isfinite(res.losses).all()
    moved = [float((a - torch.from_numpy(b)).abs().max()) for a, b in zip(_leaves(res.ps), _leaves(ps_np))]
    assert min(moved) > 0.0
