"""The port's fused TEST solve (`make_full_solve`, K3's wrapper) against the
JAX package's megakernel run in Pallas interpret mode, and the eligibility
rules of both.  On the CPU the wrapper runs its plain PyTorch version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import continuousnf_tpu as cnf
import continuousnf_tpu_torch as tcnf
from continuousnf_tpu.ops.fused_solve import make_full_solve as jfull
from continuousnf_tpu_torch.ops import fused_solve as tfs
from continuousnf_tpu_torch.ode.tableaus import TSIT5

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


def _fused(m, nn, nvars, naug, **kw):
    return m.construct(m.RNODE, nn, nvars, naug, compute_mode=m.VecJacMode(fused=True), **kw)


ELIGIBILITY = {
    "fused-off": lambda m: m.construct(m.RNODE, m.MLP((5, 15, 5)), 3, 2),
    "fused": lambda m: _fused(m, m.MLP((5, 15, 5)), 3, 2),
    "k2-probes": lambda m: m.construct(
        m.RNODE, m.MLP((5, 15, 5)), 3, 2, compute_mode=m.VecJacMode(num_probes=2, fused=True)
    ),
    "jvp": lambda m: m.construct(m.RNODE, m.MLP((5, 15, 5)), 3, 2, compute_mode=m.JacVecMode(fused=True)),
    "flagship": lambda m: _fused(
        m, m.MLP((16, 48, 16)), 8, 8, tspan=(0.0, 13.0), steer_rate=0.1, lam3=1e-2
    ),
    "fixed-steps": lambda m: _fused(m, m.MLP((5, 15, 5)), 3, 2, solver=m.SolverOptions(fixed_num_steps=8)),
    "no-error-estimate": lambda m: _fused(m, m.MLP((5, 15, 5)), 3, 2, solver=m.SolverOptions(method="rk4")),
    "trbdf2": lambda m: _fused(m, m.MLP((5, 15, 5)), 3, 2, solver=m.SolverOptions(method="trbdf2")),
    "three-layer": lambda m: _fused(m, m.MLP((5, 9, 7, 5)), 3, 2),
    "identity-out": lambda m: _fused(m, m.MLP((5, 15, 5), final_activation=None), 3, 2),
    "identity-hidden": lambda m: _fused(m, m.MLP((5, 15, 5), activation=None), 3, 2),
    "dopri5": lambda m: _fused(m, m.MLP((5, 15, 5)), 3, 2, solver=m.SolverOptions(method="dopri5")),
    "verner65": lambda m: _fused(m, m.MLP((5, 15, 5)), 3, 2, solver=m.SolverOptions(method="verner65")),
    "dop853": lambda m: _fused(m, m.MLP((5, 15, 5)), 3, 2, solver=m.SolverOptions(method="dop853")),
    "aug-passive": lambda m: _fused(m, m.MLP((5, 15, 5)), 3, 2, aug_passive=True),
    "bare-dense": lambda m: _fused(m, m.Dense(5, 5, None), 3, 2),
    "no-bias": lambda m: _fused(m, m.Chain((m.Dense(5, 15, None, False), m.Dense(15, 5))), 3, 2),
    "wrong-width": lambda m: _fused(m, m.MLP((6, 15, 6)), 3, 2),
}


@pytest.mark.parametrize("name", sorted(ELIGIBILITY))
def test_eligibility_matches_reference(name):
    make = ELIGIBILITY[name]
    ref = jfull(make(cnf), cnf.Mode.TEST, 16)
    got = tfs.make_full_solve(make(tcnf), tcnf.Mode.TEST, 16)
    assert (got is None) == (ref is None)
    if got is not None:
        assert got.adjoint is None  # gradients are not ported yet


def test_train_and_bf16_raise():
    assert jfull(ELIGIBILITY["fused"](cnf), cnf.Mode.TRAIN, 16) is not None
    with pytest.raises(NotImplementedError, match="items 4-7"):
        tfs.make_full_solve(ELIGIBILITY["fused"](tcnf), tcnf.Mode.TRAIN, 16)
    bf16 = lambda m: m.construct(m.RNODE, m.MLP((5, 15, 5)), 3, 2, compute_mode=m.VecJacMode(fused=True, bf16=True))
    assert jfull(bf16(cnf), cnf.Mode.TEST, 16) is not None
    with pytest.raises(NotImplementedError, match="bf16"):
        tfs.make_full_solve(bf16(tcnf), tcnf.Mode.TEST, 16)


@pytest.mark.parametrize(
    "name,nvars,naug,B,span",
    [
        ("fused", 3, 2, 16, (0.0, 1.0)),
        ("flagship", 8, 8, 32, (0.0, 13.0)),
        ("fused", 3, 2, 16, (1.0, 0.0)),
        ("three-layer", 3, 2, 16, (0.0, 1.0)),
    ],
    ids=["small", "flagship-width", "reverse-time", "three-layer"],
)
def test_forward_matches_interpret_kernel(name, nvars, naug, B, span):
    jicnf, ticnf = ELIGIBILITY[name](cnf), ELIGIBILITY[name](tcnf)
    dims = tuple([l.in_dim for l in jicnf.nn.layers] + [jicnf.nn.layers[-1].out_dim])
    ps_np = _np_params(dims, seed=7)
    # The slice's initial state: data in [0, 1) and zeroed augmented dims.
    # (On N(0, 1) states at flagship width the JAX package's own XLA path
    # and interpret-mode kernel differ by 7e-4: their step sizes come from a
    # roundoff-level eest and drift apart, so their truncation errors do.)
    xs = np.random.default_rng(8).uniform(size=(B, nvars)).astype(np.float32)
    z0 = np.concatenate([xs, np.zeros((B, naug), np.float32)], axis=1)
    # The JAX kernel starts its accumulator at zero, so dlogp0 = 0 here.
    y0f = np.concatenate([z0.ravel(), np.zeros(B, np.float32)])

    yj, stj = jfull(jicnf, cnf.Mode.TEST, B).forward(
        jnp.asarray(y0f), *span, {"ps": jax.tree.map(jnp.asarray, ps_np)}
    )
    fs = tfs.make_full_solve(ticnf, tcnf.Mode.TEST, B)
    t0, t1 = (torch.tensor(t) for t in span)
    yt, stt = fs.forward(torch.from_numpy(y0f), t0, t1, {"ps": tcnf.params_from_numpy(ps_np)})
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    assert int(stt.steps) == int(stj.steps)
    assert int(stt.accepted) == int(stj.accepted)
    assert int(stt.nfe) == int(stj.nfe)


@pytest.mark.parametrize("name", ["flagship", "identity-out", "identity-hidden"])
def test_fused_solve_matches_plain_exactly_on_cpu(name):
    """On the CPU the fused path runs the kernel's plain version: the same
    numbers as the port's unfused path, to the bit."""
    ticnf = ELIGIBILITY[name](tcnf)
    plain = tcnf.construct(
        tcnf.RNODE, ticnf.nn, ticnf.nvars, ticnf.naugmented, tspan=ticnf.tspan, lam3=ticnf.lam3
    )
    dims = tuple([l.in_dim for l in ticnf.nn.layers] + [ticnf.nn.layers[-1].out_dim])
    ps = tcnf.params_from_numpy(_np_params(dims, seed=9))
    xs = torch.from_numpy(np.random.default_rng(10).uniform(size=(24, ticnf.nvars)).astype(np.float32))
    lp_f, regs_f, st_f = tcnf.inference(ticnf, tcnf.Mode.TEST, xs, ps)
    lp_p, regs_p, st_p = tcnf.inference(plain, tcnf.Mode.TEST, xs, ps)
    assert torch.equal(lp_f, lp_p) and torch.equal(regs_f.a, regs_p.a)
    for a, b in zip(st_f, st_p):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["identity-out", "identity-hidden"])
def test_identity_layers_match_jax_plain_path(name):
    """2-layer chains with an identity layer: the port's fused path (plain
    version on the CPU) against the JAX package's unfused solve."""
    jicnf = cnf.construct(cnf.RNODE, ELIGIBILITY[name](cnf).nn, 3, 2)
    ticnf = ELIGIBILITY[name](tcnf)
    ps_np = _np_params((5, 15, 5), seed=11)
    xs = np.random.default_rng(12).normal(size=(16, 3)).astype(np.float32)
    lp_j, _, st_j = cnf.inference(jicnf, cnf.Mode.TEST, jnp.asarray(xs), jax.tree.map(jnp.asarray, ps_np))
    lp_t, _, st_t = tcnf.inference(ticnf, tcnf.Mode.TEST, xs, tcnf.params_from_numpy(ps_np))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), **TOL)
    assert int(st_t.steps) == int(st_j.steps)


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    spec = tfs.chain_spec(tcnf.MLP((5, 15, 5)), 5)
    ps = tcnf.params_from_numpy(_np_params((5, 15, 5), seed=13))
    rng = np.random.default_rng(14)
    kw = dict(
        rtol=1e-3, atol=1e-6, max_steps=100, ws=[p["w"] for p in ps], bs=[p["b"] for p in ps],
        z0=torch.from_numpy(rng.normal(size=(8, 5)).astype(np.float32)),
        dlogp0=torch.from_numpy(rng.normal(size=8).astype(np.float32)),
        t0=torch.tensor(0.0), t1=torch.tensor(1.0), dt_init=torch.tensor(0.05),
    )
    before = tfs.run_solve_kernel.launches
    got = tfs.run_solve_kernel(TSIT5, spec, **kw)
    ref = tfs.solve_test_plain(TSIT5, spec, **kw)
    assert tfs.run_solve_kernel.launches == before
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="item 6"):
        tfs.run_solve_kernel(TSIT5, spec, **{**kw, "z0": kw["z0"].clone().requires_grad_()})
