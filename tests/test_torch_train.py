"""The port's TRAIN slice against the JAX package on the CPU: the probe draw,
the TRAIN field, the fused TRAIN stage and its hand-derived VJP, TRAIN
`inference` (plain and fused, against the JAX unfused path and its
interpret-mode kernel), the K1 twin with seeded accumulators, the weighted
loss, the eligibility of the fused TRAIN solve, and the package without JAX.

Inputs come from numpy seeds; the JAX probe and steering draws are
reproduced from its key splits (`core/icnf.py:485`) and handed to the port."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import continuousnf_tpu as cnf
import continuousnf_tpu_torch as tcnf
from continuousnf_tpu.core.dynamics import TrainState as JTrainState
from continuousnf_tpu.core.dynamics import make_augmented_dynamics as jdyn
from continuousnf_tpu.ode.solve import odeint_with_stats as jodeint
from continuousnf_tpu.ops import fused_solve as jfs
from continuousnf_tpu_torch.core.dynamics import TrainState as TTrainState
from continuousnf_tpu_torch.core.dynamics import make_augmented_dynamics as tdyn
from continuousnf_tpu_torch.ode.tableaus import TSIT5
from continuousnf_tpu_torch.ops import fused_solve as tfs

# The port's entry points default to the CUDA card; these tests run it on the CPU.
tcnf.set_default_device("cpu")

TOL = dict(rtol=1e-4, atol=1e-4)
FIELD_TOL = dict(rtol=1e-5, atol=1e-5)
REPO = Path(__file__).resolve().parents[1]
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


def _model(m, fused=False, dims=DIMS, **kw):
    kw = {"tspan": (0.0, 1.0), "steer_rate": 0.1, "lam3": 1e-2, **kw}
    cm = kw.pop("compute_mode", m.VecJacMode(fused=fused))
    return m.construct(m.RNODE, m.MLP(dims), dims[-1] - NAUG, NAUG, compute_mode=cm, **kw)


def _jax_draws(icnf, key, batch):
    """The probes and the steering draw `inference` makes from `key`."""
    eps_key, steer_key = jax.random.split(key)
    eps = np.array(icnf.draw_eps(eps_key, batch))
    r = float(jax.random.uniform(steer_key, (), jnp.float32, -icnf.steer_rate, icnf.steer_rate))
    return eps, r


def test_sample_eps_draws():
    g = torch.Generator().manual_seed(0)
    gauss = tcnf.distributions.sample_eps(g, (4000,), tcnf.EpsDist.GAUSSIAN)
    rad = tcnf.distributions.sample_eps(g, (4000,), tcnf.EpsDist.RADEMACHER)
    assert abs(float(gauss.mean())) < 0.1 and abs(float(gauss.std()) - 1.0) < 0.1
    assert set(rad.unique().tolist()) == {-1.0, 1.0} and abs(float(rad.mean())) < 0.1
    icnf = _model(tcnf, compute_mode=tcnf.VecJacMode(num_probes=3))
    eps = icnf.draw_eps(torch.Generator().manual_seed(1), 7)
    assert eps.shape == (3, 7, 5) and torch.equal(eps, icnf.draw_eps(torch.Generator().manual_seed(1), 7))


@pytest.mark.parametrize("num_probes", [1, 2])
@pytest.mark.parametrize("norm_z,norm_j", [(True, True), (True, False), (False, True), (False, False)])
def test_train_field_matches_jax(norm_z, norm_j, num_probes):
    ps_np = _np_params(DIMS, 3)
    rng = np.random.default_rng(4)
    z = rng.normal(size=(B, 5)).astype(np.float32)
    eps = rng.normal(size=(num_probes, B, 5)).astype(np.float32)
    zeros = np.zeros(B, np.float32)
    fj = jdyn(cnf.MLP(DIMS), cnf.Mode.TRAIN, cnf.VecJacMode(num_probes), norm_z, norm_j)
    ft = tdyn(tcnf.MLP(DIMS), tcnf.Mode.TRAIN, tcnf.VecJacMode(num_probes), norm_z, norm_j)
    ref = fj(0.0, JTrainState(*(jnp.asarray(x) for x in (z, zeros, zeros, zeros))),
             {"ps": jax.tree.map(jnp.asarray, ps_np), "eps": jnp.asarray(eps)})
    z_t = torch.from_numpy(z)
    with torch.no_grad():
        got = ft(0.0, TTrainState(z_t, *(torch.from_numpy(zeros),) * 3),
                 {"ps": tcnf.params_from_numpy(ps_np), "eps": torch.from_numpy(eps)})
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FIELD_TOL)


@pytest.mark.parametrize("norm_z,norm_j", [(True, True), (False, True), (True, False)])
@pytest.mark.parametrize("widths,k_probes", [((5, 15, 5), 1), ((5, 15, 5), 2), ((5, 9, 7, 5), 1)])
def test_stage_train_fwdbwd_matches_jax_and_autograd(widths, k_probes, norm_z, norm_j):
    """The hand-derived stage VJP (the math of K2) against the JAX package's
    and against torch.autograd.grad of the port's forward stage."""
    dz, N = widths[-1], len(widths) - 1
    rng = np.random.default_rng(5)
    z = rng.normal(size=(B, dz)).astype(np.float32)
    eps = rng.normal(size=(k_probes, B, dz)).astype(np.float32)
    ws = [(0.5 * rng.normal(size=(widths[i], widths[i + 1]))).astype(np.float32) for i in range(N)]
    bs = [(0.1 * rng.normal(size=(widths[i + 1],))).astype(np.float32) for i in range(N)]
    ct_y = rng.normal(size=(B, dz)).astype(np.float32)
    ct_r = rng.normal(size=(3, B)).astype(np.float32)
    jspec = jfs.ChainSpec(tuple(widths[:-1]), tuple(widths[1:]), (True,) * N, 0)
    tspec = tfs.ChainSpec(tuple(widths[:-1]), tuple(widths[1:]), (True,) * N, 0)

    jy, jkr, jct_z, jct_ws, jct_bs = jfs._stage_train_fwdbwd(
        jspec, jnp.asarray(z.T), None, jnp.asarray(np.moveaxis(eps, 2, 1).reshape(k_probes * dz, B)),
        [jnp.asarray(w) for w in ws], [jnp.asarray(b[:, None]) for b in bs],
        norm_z, norm_j, "f32", k_probes, jnp.asarray(ct_y.T), jnp.asarray(ct_r),
    )
    T = lambda a: torch.from_numpy(a)
    ty, tkr, tct_z, tct_ws, tct_bs = tfs._stage_train_fwdbwd(
        tspec, T(z), T(eps), [T(w) for w in ws], [T(b) for b in bs], norm_z, norm_j, T(ct_y), T(ct_r)
    )
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy).T, **FIELD_TOL)
    np.testing.assert_allclose(tkr.numpy(), np.asarray(jkr), **FIELD_TOL)
    np.testing.assert_allclose(tct_z.numpy(), np.asarray(jct_z).T, **FIELD_TOL)
    for a, b in zip(tct_ws, jct_ws):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FIELD_TOL)
    for a, b in zip(tct_bs, jct_bs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[:, 0], **FIELD_TOL)

    leaves = [T(z).requires_grad_()] + [T(w).requires_grad_() for w in ws] + [T(b).requires_grad_() for b in bs]
    y, kr = tfs._stage_train(tspec, leaves[0], T(eps), leaves[1 : N + 1], leaves[N + 1 :], norm_z, norm_j)
    grads = torch.autograd.grad((y * T(ct_y)).sum() + (kr * T(ct_r)).sum(), leaves)
    for got, want in zip([tct_z] + tct_ws + tct_bs, grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **FIELD_TOL)


@pytest.mark.parametrize("jax_fused", [False, True], ids=["jax-xla", "jax-kernel"])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_train_inference_matches_jax(fused, jax_fused):
    ps_np = _np_params(DIMS, 1)
    xs = np.random.default_rng(2).uniform(size=(B, NVARS)).astype(np.float32)
    jicnf = _model(cnf, jax_fused)
    key = jax.random.PRNGKey(3)
    lp_r, regs_r, st_r = cnf.inference(
        jicnf, cnf.Mode.TRAIN, jnp.asarray(xs), jax.tree.map(jnp.asarray, ps_np), key=key
    )
    eps, r = _jax_draws(jicnf, key, B)
    lp, regs, st = tcnf.inference(
        _model(tcnf, fused), tcnf.Mode.TRAIN, xs, tcnf.params_from_numpy(ps_np), eps=eps, steer_r=r
    )
    assert (int(st.steps), int(st.accepted), int(st.nfe)) == (
        int(st_r.steps), int(st_r.accepted), int(st_r.nfe)
    )
    for a, b in ((lp, lp_r), (regs.e, regs_r.e), (regs.n, regs_r.n), (regs.a, regs_r.a)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert float(regs.e.min()) > 0.0 and float(regs.n.min()) > 0.0


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_train_solve_seeded_accumulators_match_jax_unfused(fused):
    """The K1 twin (and the fused path's flat layout) starting from nonzero
    dlogp / reg_e / reg_n rows, against the JAX package's unfused solve (its
    kernel starts the accumulators at zero)."""
    ps_np = _np_params(DIMS, 6)
    rng = np.random.default_rng(7)
    z0 = rng.normal(size=(B, 5)).astype(np.float32)
    acc0 = rng.normal(0.0, 2.0, size=(3, B)).astype(np.float32)
    eps = rng.normal(size=(1, B, 5)).astype(np.float32)
    f = jdyn(cnf.MLP(DIMS), cnf.Mode.TRAIN, cnf.VecJacMode(), True, True)
    yT, st_r = jodeint(
        f, JTrainState(jnp.asarray(z0), *(jnp.asarray(a) for a in acc0)), 0.0, 1.0,
        {"ps": jax.tree.map(jnp.asarray, ps_np), "eps": jnp.asarray(eps)}, cnf.SolverOptions(),
    )
    ps = tcnf.params_from_numpy(ps_np)
    icnf = _model(tcnf, fused)
    if fused:
        fs = tfs.make_full_solve(icnf, tcnf.Mode.TRAIN, B)
        y0f = torch.from_numpy(np.concatenate([z0.ravel(), acc0.ravel()]))
        with torch.no_grad():
            yf, st = fs.forward(y0f, torch.tensor(0.0), torch.tensor(1.0), {"ps": ps, "eps": torch.from_numpy(eps)})
        zT, accT = yf[: B * 5].reshape(B, 5), yf[B * 5 :].reshape(3, B)
    else:
        before = tfs.run_train_solve_kernel.launches
        spec = tfs.chain_spec(icnf.nn, 5)
        kw = dict(
            norm_z=True, norm_j=True, rtol=1e-3, atol=1e-6, max_steps=10_000,
            ws=[p["w"] for p in ps], bs=[p["b"] for p in ps], z0=torch.from_numpy(z0),
            eps=torch.from_numpy(eps), acc0=torch.from_numpy(acc0), t0=torch.tensor(0.0),
            t1=torch.tensor(1.0), dt_init=None,
        )
        zT, accT, steps, accepted, *_ = tfs.run_train_solve_kernel(TSIT5, spec, **kw)
        plain = tfs.solve_train_plain(TSIT5, spec, **kw)
        assert tfs.run_train_solve_kernel.launches == before
        assert torch.equal(zT, plain[0]) and torch.equal(accT, plain[1])
        st = tcnf.SolveStats(steps, accepted, None)
    assert (int(st.steps), int(st.accepted)) == (int(st_r.steps), int(st_r.accepted))
    np.testing.assert_allclose(zT.numpy(), np.asarray(yT.z), **TOL)
    for row, ref in zip(accT, (yT.dlogp, yT.reg_e, yT.reg_n)):
        np.testing.assert_allclose(row.numpy(), np.asarray(ref), **TOL)
    assert float(accT.abs().min()) > 0.0


def test_weighted_loss_and_metrics_match_jax():
    ps_np = _np_params(DIMS, 8)
    rng = np.random.default_rng(9)
    xs = rng.uniform(size=(B, NVARS)).astype(np.float32)
    w = np.concatenate([np.ones(11), np.zeros(5)]).astype(np.float32)
    jicnf = _model(cnf)
    key = jax.random.PRNGKey(10)
    l_r, m_r = cnf.loss_and_metrics(
        jicnf, cnf.Mode.TRAIN, jnp.asarray(xs), jax.tree.map(jnp.asarray, ps_np), key=key, weights=jnp.asarray(w)
    )
    eps, r = _jax_draws(jicnf, key, B)
    l, m = tcnf.loss_and_metrics(
        _model(tcnf), tcnf.Mode.TRAIN, xs, tcnf.params_from_numpy(ps_np), weights=w, eps=eps, steer_r=r
    )
    for k in ("loss", "e", "n"):
        np.testing.assert_allclose(float(m[k]), float(m_r[k]), **TOL)
    assert int(m["nfe"]) == int(m_r["nfe"]) and float(l) == float(m["loss"])
    l_test = tcnf.loss(_model(tcnf), tcnf.Mode.TEST, xs, tcnf.params_from_numpy(ps_np))
    l_test_r = cnf.loss(jicnf, cnf.Mode.TEST, jnp.asarray(xs), jax.tree.map(jnp.asarray, ps_np))
    np.testing.assert_allclose(float(l_test), float(l_test_r), **TOL)


def test_train_draws_come_from_the_generator():
    icnf = _model(tcnf)
    ps = tcnf.params_from_numpy(_np_params(DIMS, 1))
    xs = np.random.default_rng(2).uniform(size=(B, NVARS)).astype(np.float32)
    run = lambda seed: tcnf.inference(icnf, tcnf.Mode.TRAIN, xs, ps, generator=torch.Generator().manual_seed(seed))[0]
    assert torch.equal(run(0), run(0)) and not torch.equal(run(0), run(1))
    # The generator gives the probes first, then the steering draw.
    g = torch.Generator().manual_seed(0)
    eps = icnf.draw_eps(g, B)
    r = (2.0 * torch.rand((), generator=g) - 1.0) * icnf.steer_rate
    assert torch.equal(run(0), tcnf.inference(icnf, tcnf.Mode.TRAIN, xs, ps, eps=eps, steer_r=r)[0])


@pytest.mark.parametrize(
    "kw,err,match",
    [
        ({"eps": np.zeros((2, B, 5), np.float32)}, ValueError, "eps must have shape"),
        ({"steer_r": 0.5}, ValueError, "steer_r"),
        ({"model": {"compute_mode": "jvp"}}, None, None),
        ({"model": {"compute_mode": "exact"}}, None, None),
        ({"model": {"x_jitter": 0.1}, "jitter": np.zeros((B, NVARS + 1), np.float32)}, ValueError,
         "jitter must have shape"),
        ({"model": {"aug_noise": 0.1}, "aug": np.zeros((B + 1, 2), np.float32)}, ValueError, "aug must have shape"),
        ({"model": {"aug_passive": True}}, NotImplementedError, "item 14"),
    ],
    ids=["eps-shape", "steer-range", "jvp", "exact-trace", "x-jitter", "aug-noise", "aug-passive"],
)
def test_train_inputs_are_validated(kw, err, match):
    """Bad inputs raise (wrongly shaped injected draws among them), and
    configurations not ported yet raise naming their ROADMAP item; JVP
    probes and exact trace (err None) run."""
    mkw = dict(kw.pop("model", {}))
    cm = mkw.pop("compute_mode", None)
    if cm == "jvp":
        mkw["compute_mode"] = tcnf.JacVecMode()
    elif cm == "exact":
        mkw["compute_mode"] = tcnf.VecJacMode(exact_trace=True)
    icnf = _model(tcnf, **mkw)
    xs = np.zeros((B, NVARS), np.float32)
    if err is None:
        lp, regs, _ = tcnf.inference(icnf, tcnf.Mode.TRAIN, xs, tcnf.params_from_numpy(_np_params(DIMS, 1)), **kw)
        assert lp.shape == (B,) and torch.isfinite(lp).all() and torch.isfinite(regs.n).all()
        return
    with pytest.raises(err, match=match):
        tcnf.inference(icnf, tcnf.Mode.TRAIN, xs, tcnf.params_from_numpy(_np_params(DIMS, 1)), **kw)


@pytest.mark.parametrize(
    "name,expect",
    [
        ("fused-off", None),
        ("fused", "adjoint"),
        ("k2-probes", "adjoint"),
        ("three-layer", "adjoint"),
        ("dopri5", "adjoint"),
        ("jvp", "adjoint"),
        ("exact", "K4"),
        ("bf16", "adjoint"),
        ("bf16-exact", "bf16 stage dots"),
    ],
)
def test_train_eligibility(name, expect):
    """The fused TRAIN solve applies where the JAX package's does; what the
    port has not reached raises, naming its kernel or ROADMAP's row.  K
    probes and JVP probes (K6), exact trace (K4) and bf16 stage matmuls
    (the bf16 twins on the CPU) have the backward member, as in the JAX
    package; bf16 exact trace has no bf16 twin yet."""
    base = dict(nvars=3, naugmented=2)
    make = {
        "fused-off": lambda m: m.construct(m.RNODE, m.MLP(DIMS), **base),
        "fused": lambda m: m.construct(m.RNODE, m.MLP(DIMS), **base, compute_mode=m.VecJacMode(fused=True)),
        "k2-probes": lambda m: m.construct(m.RNODE, m.MLP(DIMS), **base, compute_mode=m.VecJacMode(2, fused=True)),
        "three-layer": lambda m: m.construct(m.RNODE, m.MLP((5, 9, 7, 5)), **base, compute_mode=m.VecJacMode(fused=True)),
        "dopri5": lambda m: m.construct(
            m.RNODE, m.MLP(DIMS), **base, compute_mode=m.VecJacMode(fused=True), solver=m.SolverOptions(method="dopri5")
        ),
        "jvp": lambda m: m.construct(m.RNODE, m.MLP(DIMS), **base, compute_mode=m.JacVecMode(fused=True)),
        "exact": lambda m: m.construct(m.RNODE, m.MLP(DIMS), **base, compute_mode=m.VecJacMode(fused=True, exact_trace=True)),
        "bf16": lambda m: m.construct(m.RNODE, m.MLP(DIMS), **base, compute_mode=m.VecJacMode(fused=True, bf16=True)),
        "bf16-exact": lambda m: m.construct(
            m.RNODE, m.MLP(DIMS), **base, compute_mode=m.VecJacMode(fused=True, exact_trace=True, bf16=True)
        ),
    }[name]
    ref = jfs.make_full_solve(make(cnf), cnf.Mode.TRAIN, B)
    if expect is None:
        assert ref is None and tfs.make_full_solve(make(tcnf), tcnf.Mode.TRAIN, B) is None
    elif expect in ("adjoint", "K4"):
        got = tfs.make_full_solve(make(tcnf), tcnf.Mode.TRAIN, B)
        assert ref is not None and got is not None and got.adjoint is not None
    else:
        assert ref is not None
        with pytest.raises(NotImplementedError, match=expect):
            tfs.make_full_solve(make(tcnf), tcnf.Mode.TRAIN, B)


@pytest.mark.parametrize("name", ["k2-probes", "three-layer"])
def test_fused_train_variants_match_jax_on_cpu(name):
    """On the CPU the fused TRAIN path runs the twins, which cover what the
    CUDA kernels leave to later PRs (K > 1 probes, deeper chains)."""
    dims = (5, 9, 7, 5) if name == "three-layer" else DIMS
    cm = lambda m: m.VecJacMode(2 if name == "k2-probes" else 1, fused=True)
    jicnf = _model(cnf, dims=dims, compute_mode=cm(cnf))
    ps_np = _np_params(dims, 11)
    xs = np.random.default_rng(12).uniform(size=(B, NVARS)).astype(np.float32)
    key = jax.random.PRNGKey(13)
    lp_r, _, st_r = cnf.inference(jicnf, cnf.Mode.TRAIN, jnp.asarray(xs), jax.tree.map(jnp.asarray, ps_np), key=key)
    eps, r = _jax_draws(jicnf, key, B)
    lp, _, st = tcnf.inference(
        _model(tcnf, dims=dims, compute_mode=cm(tcnf)), tcnf.Mode.TRAIN, xs, tcnf.params_from_numpy(ps_np),
        eps=eps, steer_r=r,
    )
    assert int(st.steps) == int(st_r.steps)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_r), **TOL)


def test_package_trains_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np, torch, continuousnf_tpu_torch as t\n"
        "t.set_default_device('cpu')\n"
        "icnf = t.construct(t.RNODE, t.MLP((5, 15, 5)), 3, 2, steer_rate=0.1, compute_mode=t.VecJacMode(fused=True))\n"
        "ps = icnf.init(torch.Generator().manual_seed(0))\n"
        "leaves = [p[k].requires_grad_() for p in ps for k in ('w', 'b')]\n"
        "xs = np.random.default_rng(0).uniform(size=(8, 3)).astype(np.float32)\n"
        "l = t.loss(icnf, t.Mode.TRAIN, xs, ps, generator=torch.Generator().manual_seed(1))\n"
        "g = torch.autograd.grad(l, leaves)\n"
        "assert torch.isfinite(l) and all(torch.isfinite(x).all() for x in g)\n"
        "import importlib, pkgutil\n"
        "for m in pkgutil.walk_packages(t.__path__, 'continuousnf_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'continuousnf_tpu_torch.utils.near_tie' in sys.modules\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m, v in sys.modules.items() if v is not None)\n"
        "assert not any(m == 'continuousnf_tpu' or m.startswith('continuousnf_tpu.') for m in sys.modules)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
