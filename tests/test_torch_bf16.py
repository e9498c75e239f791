"""bf16 stage matmuls in the port (`VecJacMode(fused=True, bf16=True)`)
against the JAX package on the CPU: the stages `_stage_train`,
`_stage_train_fwdbwd` (K = 1 and 2, VJP and JVP, 2 and 3 layers) and the
2-layer TEST stage against the JAX package's called with "bf16" (the math
of bf16 K1, K2 and K3), each also apart from the float32 stage; TEST and
TRAIN inference, `ICNFDist.logpdf`, `sample` with an injected z1 and the
TRAIN loss gradient against the JAX package's fused path in Pallas
interpret mode, whose bf16 dots round as the kernel's; the refusals of
what has no bf16 twin, the CUDA coverage rule, and the wrappers' CPU
branch.

Tolerances.  Both packages sum the exact products of bf16 operands in
float32, in other orders, so a stage's results part at float32 roundoff
(TIGHT).  Where such a part moves an intermediate across a bf16 rounding
boundary, the next product sees that operand one bf16 ulp away, 2^-7 of its
magnitude at most (FLIP); that moves one sample's results, so a stage holds
if at most one element in eight misses TIGHT and each within FLIP of the
result's scale.  A whole solve under bf16 sits at the rounding's noise
floor (the JAX package's own 16x step inflation at rtol 1e-3,
`continuousnf_tpu/types.py:180-194`): its step grid follows roundoff.  So
the port's solve is held to the JAX package's by the rule of
`utils/near_tie.within_bf16_noise`: attempted steps within max(2, steps /
20) and each value within max(TOL, 4x the port's own move when its inputs
move by one float32 ulp)."""

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
from continuousnf_tpu_torch.utils import near_tie
from continuousnf_tpu_torch.utils.configs import MODELS

# The port's entry points default to the CUDA card; these tests run it on the CPU.
tcnf.set_default_device("cpu")

TIGHT = dict(rtol=1e-5, atol=1e-5)  # float32 sums of the same exact products in another order
FLIP = 2.0 ** -7  # bf16's largest relative spacing: one operand rounded the other way
TOL = 1e-4
DIMS, NVARS, NAUG, B = (5, 15, 5), 3, 2, 16
MICRO = MODELS["microbench"]


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


def _missed(got, want):
    return np.abs(got - want) > TIGHT["atol"] + TIGHT["rtol"] * np.abs(want)


def assert_bf16_close(got, want):
    """got within TIGHT of want but for at most one element in eight, which
    a flipped bf16 operand moved: each of those within FLIP * max(1,
    max|want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    missed = _missed(got, want)
    assert missed.mean() <= 1 / 8, f"{missed.sum()} of {missed.size} elements beyond float32 roundoff"
    assert np.abs(got - want).max() <= FLIP * max(1.0, np.abs(want).max())


def assert_apart(bf16, f32):
    """The bf16 result misses the float32 one beyond TIGHT in most elements:
    a rounding left out shows as a stage that agrees with the float32 one."""
    assert _missed(np.asarray(bf16), np.asarray(f32)).mean() > 1 / 2


# ---- the stages (the kernels' math) ----

STAGES = {
    "two-layer": ((5, 15, 5), 1, False),
    "flagship-width": ((16, 48, 16), 1, False),
    "two-probes": ((5, 15, 5), 2, False),
    "jvp": ((5, 15, 5), 1, True),
    "three-layer": ((5, 9, 7, 5), 1, False),
    "three-layer-two-jvp": ((5, 9, 7, 5), 2, True),
}


def _stage_inputs(widths, k_probes, seed, batch=32):
    rng = np.random.default_rng(seed)
    dz = widths[-1]
    z = rng.normal(size=(batch, dz)).astype(np.float32)
    eps = rng.normal(size=(k_probes, batch, dz)).astype(np.float32)
    ps = _np_params(widths, seed + 1)
    ct_y = rng.normal(size=(batch, dz)).astype(np.float32)
    ct_r = rng.normal(size=(3, batch)).astype(np.float32)
    return z, eps, [p["w"] for p in ps], [p["b"] for p in ps], ct_y, ct_r


@pytest.mark.parametrize("net", list(STAGES))
def test_train_stages_match_jax(net):
    """`_stage_train` and `_stage_train_fwdbwd` under bf16 against the JAX
    package's with "bf16" ((rows, B) layout), and apart from the port's
    float32 stages."""
    widths, k_probes, jvp = STAGES[net]
    N, dz, batch = len(widths) - 1, widths[-1], 32
    z, eps, ws, bs, ct_y, ct_r = _stage_inputs(widths, k_probes, 60 + len(net))
    jspec = jfs.ChainSpec(tuple(widths[:-1]), tuple(widths[1:]), (True,) * N, 0)
    tspec = tfs.ChainSpec(tuple(widths[:-1]), tuple(widths[1:]), (True,) * N, 0)
    jargs = (jnp.asarray(z.T), None, jnp.asarray(np.moveaxis(eps, 2, 1).reshape(k_probes * dz, batch)),
             [jnp.asarray(w) for w in ws], [jnp.asarray(b[:, None]) for b in bs])
    T = torch.from_numpy
    targs = (T(z), T(eps), [T(w) for w in ws], [T(b) for b in bs])

    jy, jkr = jfs._stage_train(jspec, *jargs, True, True, "bf16", k_probes, jvp=jvp)
    ty, tkr = tfs._stage_train(tspec, *targs, True, True, None, jvp, True)
    fy, fkr = tfs._stage_train(tspec, *targs, True, True, None, jvp, False)
    assert_bf16_close(ty.numpy(), np.asarray(jy).T)
    assert_bf16_close(tkr.numpy(), np.asarray(jkr))
    assert_apart(ty.numpy(), fy.numpy())
    assert_apart(tkr[0].numpy(), fkr[0].numpy())

    jout = jfs._stage_train_fwdbwd(jspec, *jargs, True, True, "bf16", k_probes, jnp.asarray(ct_y.T),
                                   jnp.asarray(ct_r), jvp=jvp)
    tout = tfs._stage_train_fwdbwd(tspec, *targs, True, True, T(ct_y), T(ct_r), None, jvp, True)
    fout = tfs._stage_train_fwdbwd(tspec, *targs, True, True, T(ct_y), T(ct_r), None, jvp, False)
    want = [np.asarray(jout[0]).T, np.asarray(jout[1]), np.asarray(jout[2]).T] + [np.asarray(w) for w in jout[3]] \
        + [np.asarray(b)[:, 0] for b in jout[4]]
    got = [tout[0], tout[1], tout[2]] + list(tout[3]) + list(tout[4])
    f32 = [fout[0], fout[1], fout[2]] + list(fout[3]) + list(fout[4])
    for g, w, f in zip(got, want, f32):
        assert_bf16_close(g.numpy(), w)
    for g, f in zip(got[2 : 3 + N], f32[2 : 3 + N]):  # ct_z and the weight gradients
        assert_apart(g.numpy(), f.numpy())


@pytest.mark.parametrize("widths", [(5, 15, 5), (16, 48, 16)], ids=["small", "flagship-width"])
def test_test_stage_matches_jax(widths):
    """The 2-layer TEST stage under bf16 (m = W1z * W2^T in float32, then
    rounded) against the JAX package's `_stage_test` with "bf16", apart
    from the float32 closed form, and apart from the same stage built from
    the product of the rounded weights (the rounding placed wrong)."""
    z, _, ws, bs, _, _ = _stage_inputs(widths, 1, 70 + widths[0])
    jspec = jfs.ChainSpec(tuple(widths[:-1]), tuple(widths[1:]), (True, True), 0)
    tspec = tfs.ChainSpec(tuple(widths[:-1]), tuple(widths[1:]), (True, True), 0)
    jy, jr = jfs._stage_test(jspec, jnp.asarray(z.T), None, [jnp.asarray(w) for w in ws],
                             [jnp.asarray(b[:, None]) for b in bs], "bf16")
    tw, tb = [torch.from_numpy(w) for w in ws], [torch.from_numpy(b) for b in bs]
    ty, ttr = tfs._test_stage_bf16(tspec, tw, tb, torch.from_numpy(z))
    assert_bf16_close(ty.numpy(), np.asarray(jy).T)
    assert_bf16_close(-ttr.numpy(), np.asarray(jr)[0])
    fy, ftr = tfs._test_stage(tspec, tw, tb, torch.from_numpy(z))
    assert_apart(ty.numpy(), fy.numpy())
    assert_apart(ttr.numpy(), ftr.numpy())
    r = [w.to(torch.bfloat16).float() for w in tw]
    wrong = torch.sum((1 - ty**2) * tfs._mm_bf16(1 - torch.tanh(tfs._mm_bf16(torch.from_numpy(z), tw[0]) + tb[0]) ** 2,
                                                 (r[0] * r[1].T).T), dim=-1)
    assert_apart(ttr.numpy(), wrong.numpy())


def test_mm_bf16_rounds_both_operands_to_nearest_even():
    a = torch.tensor([[1.0 + 2.0**-8, 1.0 + 3 * 2.0**-8]])  # ties: to 1.0 and to 1 + 2^-6
    b = torch.tensor([[1.0], [1.0]])
    assert float(tfs._mm_bf16(a, b)) == 1.0 + (1.0 + 2.0**-6)
    assert float(tfs._mm_bf16(b.T, a.T)) == 1.0 + (1.0 + 2.0**-6)


# ---- whole solves against the JAX package's fused interpret path ----


def _models(m, dims=DIMS, nvars=NVARS, naug=NAUG, k=1, jvp=False, span=(0.0, 1.0)):
    cm = (m.JacVecMode if jvp else m.VecJacMode)(k, fused=True, bf16=True)
    return m.construct(m.RNODE, m.MLP(dims), nvars, naug, compute_mode=cm, tspan=span, steer_rate=0.1, lam3=1e-2)


def _spread(fn, xs, ps_np, n=4):
    """The port's own largest move (`near_tie.rel`) of fn(xs, ps)'s tensors
    when every element of the data xs and of the params moves one float32
    ulp at random (`near_tie.nudge`), over n draws."""
    ps = tcnf.params_from_numpy(ps_np)
    ref = fn(torch.from_numpy(xs), ps)
    out = [0.0] * len(ref)
    for seed in range(n):
        gen = torch.Generator().manual_seed(seed)
        x = near_tie.nudge(torch.from_numpy(xs), gen)
        moved = fn(x, tuple({k: near_tie.nudge(v, gen) for k, v in layer.items()} for layer in ps))
        out = [max(d, near_tie.rel(a, b)) for d, a, b in zip(out, moved, ref)]
    return out


def hold_noise(got, want, spreads, steps_got=None, steps_want=None, tol=TOL):
    """The rule of `near_tie.within_bf16_noise` on (port, JAX) tensors."""
    if steps_want is not None:
        assert abs(steps_got - steps_want) <= near_tie.bf16_step_gate(steps_want), (steps_got, steps_want)
    for g, w, d in zip(got, want, spreads):
        e = near_tie.rel(g, torch.from_numpy(np.asarray(w, np.float32)))
        assert e <= max(tol, 4.0 * d), (e, d)


CASES = {
    "small": dict(),
    "microbench-width": dict(dims=MICRO["dims"], nvars=MICRO["nvars"], naug=MICRO["naug"], span=MICRO["tspan"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_test_inference_and_logpdf_match_jax(case):
    """TEST inference and `ICNFDist.logpdf` through the fused solve (bf16
    K3's twin) against the JAX package's bf16 kernel in interpret mode."""
    kw = CASES[case]
    dims, nvars = kw.get("dims", DIMS), kw.get("nvars", NVARS)
    ps_np = _np_params(dims, 7)
    xs = np.random.default_rng(8).uniform(size=(32 if case != "small" else B, nvars)).astype(np.float32)
    jicnf, ticnf = _models(cnf, **kw), _models(tcnf, **kw)
    lp_j, _, st_j = cnf.inference(jicnf, cnf.Mode.TEST, jnp.asarray(xs), jax.tree.map(jnp.asarray, ps_np))
    ps = tcnf.params_from_numpy(ps_np)
    lp_t, _, st_t = tcnf.inference(ticnf, tcnf.Mode.TEST, torch.from_numpy(xs), ps)
    spreads = _spread(lambda x, p: [tcnf.inference(ticnf, tcnf.Mode.TEST, x, p)[0]], xs, ps_np)
    hold_noise([lp_t], [lp_j], spreads, int(st_t.steps), int(st_j.steps))
    f32 = tcnf.construct(tcnf.RNODE, ticnf.nn, nvars, ticnf.naugmented, tspan=ticnf.tspan, steer_rate=0.1,
                         lam3=1e-2, compute_mode=tcnf.VecJacMode(fused=True))
    _, _, st_f = tcnf.inference(f32, tcnf.Mode.TEST, torch.from_numpy(xs), ps)
    assert int(st_t.steps) > 3 * int(st_f.steps)  # the bf16 noise floor inflates the steps
    td = tcnf.ICNFDist(ticnf, tcnf.Mode.TEST, ps)
    assert torch.equal(td.logpdf(xs), lp_t)


@pytest.mark.parametrize("k,jvp,dims", [(1, False, DIMS), (2, True, DIMS), (1, False, (5, 9, 7, 5))],
                         ids=["one-probe", "two-jvp-probes", "three-layer"])
def test_train_inference_matches_jax(k, jvp, dims):
    """TRAIN inference through the fused solve (bf16 K1's twin; K probes,
    JVP probes and 3-layer chains in the twin alone) against the JAX
    package's bf16 kernel in interpret mode, its probes and steering draw
    injected."""
    ps_np = _np_params(dims, 9)
    xs = np.random.default_rng(10).uniform(size=(B, NVARS)).astype(np.float32)
    jicnf, ticnf = _models(cnf, dims, k=k, jvp=jvp), _models(tcnf, dims, k=k, jvp=jvp)
    key = jax.random.PRNGKey(11)
    lp_j, regs_j, st_j = cnf.inference(jicnf, cnf.Mode.TRAIN, jnp.asarray(xs), jax.tree.map(jnp.asarray, ps_np),
                                       key=key)
    eps_key, steer_key = jax.random.split(key)
    eps = torch.from_numpy(np.array(jicnf.draw_eps(eps_key, B)))
    r = float(jax.random.uniform(steer_key, (), jnp.float32, -jicnf.steer_rate, jicnf.steer_rate))
    ps = tcnf.params_from_numpy(ps_np)

    def run(x, p):
        lp, regs, _ = tcnf.inference(ticnf, tcnf.Mode.TRAIN, x, p, eps=eps, steer_r=r)
        return [lp, regs.e, regs.n]

    lp_t, regs_t, st_t = tcnf.inference(ticnf, tcnf.Mode.TRAIN, torch.from_numpy(xs), ps, eps=eps, steer_r=r)
    hold_noise([lp_t, regs_t.e, regs_t.n], [lp_j, regs_j.e, regs_j.n], _spread(run, xs, ps_np), int(st_t.steps),
               int(st_j.steps))


def test_sample_with_injected_z1_matches_jax():
    """`sample(n, z1=...)` (the TEST solve backward in time) against the JAX
    package's `sample` from the same base draw."""
    ps_np = _np_params(DIMS, 12)
    jd = cnf.ICNFDist(_models(cnf), cnf.Mode.TEST, jax.tree.map(jnp.asarray, ps_np))
    td = tcnf.ICNFDist(_models(tcnf), tcnf.Mode.TEST, tcnf.params_from_numpy(ps_np))
    key = jax.random.PRNGKey(13)
    z1 = np.array(jax.random.normal(jax.random.split(key, 3)[0], (B, jd.icnf.zdim), jnp.float32))
    s_j = jd.sample(key, B)
    s_t = td.sample(B, z1=z1)
    spreads = _spread(lambda z, p: [tcnf.ICNFDist(_models(tcnf), tcnf.Mode.TEST, p).sample(B, z1=z)], z1, ps_np)
    hold_noise([s_t], [s_j], spreads)


def test_loss_gradient_matches_jax():
    """The TRAIN loss and its gradient (bf16 K1 forward, bf16 K2's twin
    backward, warm-started from the forward) against `jax.grad` of the JAX
    package's bf16 fused loss, the probe and steering draw injected; and
    apart from the float32 gradient."""
    ps_np = _np_params(DIMS, 14)
    xs = np.random.default_rng(15).uniform(size=(B, NVARS)).astype(np.float32)
    jicnf, ticnf = _models(cnf), _models(tcnf)
    key = jax.random.PRNGKey(16)
    jps = jax.tree.map(jnp.asarray, ps_np)
    l_j, g_j = jax.value_and_grad(lambda p: cnf.loss(jicnf, cnf.Mode.TRAIN, jnp.asarray(xs), p, key=key))(jps)
    eps_key, steer_key = jax.random.split(key)
    eps = torch.from_numpy(np.array(jicnf.draw_eps(eps_key, B)))
    r = float(jax.random.uniform(steer_key, (), jnp.float32, -jicnf.steer_rate, jicnf.steer_rate))

    def grad(x, ps, icnf=ticnf):
        leaves = [v.requires_grad_() for p in ps for v in (p["w"], p["b"])]
        loss = tcnf.loss(icnf, tcnf.Mode.TRAIN, x, ps, eps=eps, steer_r=r)
        return [loss.detach()] + list(torch.autograd.grad(loss, leaves))

    got = grad(torch.from_numpy(xs), tcnf.params_from_numpy(ps_np))
    want = [l_j] + [x for p in g_j for x in (p["w"], p["b"])]
    hold_noise(got, want, _spread(grad, xs, ps_np))
    f32 = tcnf.construct(tcnf.RNODE, ticnf.nn, NVARS, NAUG, tspan=(0.0, 1.0), steer_rate=0.1, lam3=1e-2,
                         compute_mode=tcnf.VecJacMode(fused=True))
    for a, b in zip(got[1:], grad(torch.from_numpy(xs), tcnf.params_from_numpy(ps_np), f32)[1:]):
        assert near_tie.rel(a, b) > TOL


# ---- what the fused solve builds and refuses ----


@pytest.mark.parametrize("name,mode,k,jvp,dims", [
    ("test", "TEST", 1, False, DIMS),
    ("train", "TRAIN", 1, False, DIMS),
    ("train-two-probes", "TRAIN", 2, False, DIMS),
    ("train-jvp", "TRAIN", 1, True, DIMS),
    ("train-three-layer", "TRAIN", 1, False, (5, 9, 7, 5)),
])
def test_cpu_builds_bf16_solve(name, mode, k, jvp, dims):
    """On the CPU the fused solve under bf16 exists wherever a bf16 twin
    runs its stages, with the TRAIN backward member (bf16 K2's twin) and a
    TEST backward member that refuses (K5 has no bf16 twin); the JAX
    package builds it too."""
    jfull = jfs.make_full_solve(_models(cnf, dims, k=k, jvp=jvp), getattr(cnf.Mode, mode), B)
    got = tfs.make_full_solve(_models(tcnf, dims, k=k, jvp=jvp), getattr(tcnf.Mode, mode), B)
    assert jfull is not None and got is not None and got.adjoint is not None


def test_refusals_name_the_bf16_row():
    """What has no bf16 twin raises on the CPU too, naming ROADMAP's bf16
    row: the exact-trace stages, the deep exact chain (TEST past 2-layer
    tanh nets), and the TEST backward stage (K5) once a gradient needs it."""
    match = "bf16 stage dots"
    exact = tcnf.construct(tcnf.RNODE, tcnf.MLP(DIMS), NVARS, NAUG,
                           compute_mode=tcnf.VecJacMode(fused=True, exact_trace=True, bf16=True))
    with pytest.raises(NotImplementedError, match=match):
        tfs.make_full_solve(exact, tcnf.Mode.TRAIN, B)
    with pytest.raises(NotImplementedError, match=match):
        tfs.make_full_solve(_models(tcnf, (5, 9, 7, 5)), tcnf.Mode.TEST, B)
    ps = tcnf.params_from_numpy(_np_params(DIMS, 17))
    leaves = [v.requires_grad_() for p in ps for v in (p["w"], p["b"])]
    xs = np.random.default_rng(18).uniform(size=(B, NVARS)).astype(np.float32)
    loss = tcnf.loss(_models(tcnf), tcnf.Mode.TEST, xs, ps)
    with pytest.raises(NotImplementedError, match=match):
        torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("dims,k,jvp,cond,expect", [
    ((16, 48, 16), 1, False, 0, None),
    ((5, 15, 5), 1, False, 0, None),
    ((32, 64, 32), 1, False, 0, None),
    ((16, 48, 16), 2, False, 0, "2 VJP probes"),
    ((16, 48, 16), 1, True, 0, "JVP"),
    ((5, 9, 7, 5), 1, False, 0, "3-layer"),
    ((42, 126, 42), 1, False, 0, "state width 42"),
    ((16, 96, 16), 1, False, 0, "hidden width 96"),
    ((17, 48, 16), 1, False, 1, "conditional"),
])
def test_cuda_coverage_rule(dims, k, jvp, cond, expect):
    """The bf16 kernels take unconditional 2-layer tanh nets of state width
    up to 32 and hidden width up to BF16_MAX_WIDTH with one VJP probe; the
    rest is named (the card raises with it and BF16_ROW)."""
    N = len(dims) - 1
    spec = tfs.ChainSpec(tuple(dims[:-1]), tuple(dims[1:]), (True,) * N, cond)
    why = tfs._bf16_covers(TSIT5, spec, k, jvp)
    assert (why is None) == (expect is None)
    if expect is not None:
        assert expect in why


def test_fused_solve_routes_bf16_wrappers(monkeypatch):
    """Under bf16 the fused solve calls the bf16 wrappers and no f32 one."""
    calls = []
    for name in ("run_bf16_solve_kernel", "run_bf16_train_solve_kernel", "run_bf16_adjoint_kernel",
                 "run_solve_kernel", "run_train_solve_kernel", "run_adjoint_kernel"):
        fn = getattr(tfs, name)
        monkeypatch.setattr(tfs, name, lambda *a, _fn=fn, _n=name, **kw: calls.append(_n) or _fn(*a, **kw))
    ps = tcnf.params_from_numpy(_np_params(DIMS, 19))
    xs = np.random.default_rng(20).uniform(size=(B, NVARS)).astype(np.float32)
    tcnf.inference(_models(tcnf), tcnf.Mode.TEST, xs, ps)
    leaves = [v.requires_grad_() for p in ps for v in (p["w"], p["b"])]
    torch.autograd.grad(tcnf.loss(_models(tcnf), tcnf.Mode.TRAIN, xs, ps, generator=torch.Generator().manual_seed(0)),
                        leaves)
    assert calls == ["run_bf16_solve_kernel", "run_bf16_train_solve_kernel", "run_bf16_adjoint_kernel"]


def test_wrappers_run_bf16_twins_on_cpu_without_counting():
    spec = tfs.chain_spec(tcnf.MLP(DIMS), 5)
    ps = tcnf.params_from_numpy(_np_params(DIMS, 21))
    rng = np.random.default_rng(22)
    T = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    base = dict(rtol=1e-3, atol=1e-6, max_steps=1000, ws=[p["w"] for p in ps], bs=[p["b"] for p in ps])
    fwd = dict(base, z0=T(rng.normal(size=(8, 5))), t0=torch.tensor(0.0), t1=torch.tensor(1.0),
               dt_init=torch.tensor(0.05))
    train = dict(fwd, norm_z=True, norm_j=True, eps=T(rng.normal(size=(1, 8, 5))), acc0=T(rng.normal(size=(3, 8))))
    counts = [w.launches for w in (tfs.run_bf16_solve_kernel, tfs.run_bf16_train_solve_kernel,
                                   tfs.run_bf16_adjoint_kernel)]
    dlogp0 = T(rng.normal(size=8))
    pairs = [(tfs.run_bf16_solve_kernel(TSIT5, spec, **fwd, dlogp0=dlogp0),
              tfs.solve_test_plain(TSIT5, spec, **fwd, dlogp0=dlogp0, bf16=True)),
             (tfs.run_bf16_train_solve_kernel(TSIT5, spec, **train),
              tfs.solve_train_plain(TSIT5, spec, **train, bf16=True))]
    out = pairs[1][0]
    adj = dict(base, norm_z=True, norm_j=True, eps=train["eps"], zT=out[0], accT=out[1],
               azT=T(rng.normal(size=(8, 5))), aaccT=T(rng.normal(size=(3, 8))), t_hi=torch.tensor(1.0),
               t_lo=torch.tensor(0.0), dt_init=-out[4].abs())
    pairs.append((tfs.run_bf16_adjoint_kernel(TSIT5, spec, **adj), tfs.adjoint_train_plain(TSIT5, spec, **adj,
                                                                                           bf16=True)))
    assert counts == [w.launches for w in (tfs.run_bf16_solve_kernel, tfs.run_bf16_train_solve_kernel,
                                           tfs.run_bf16_adjoint_kernel)]
    for got, ref in pairs:
        for a, b in zip(near_tie.split(got)[1], near_tie.split(ref)[1]):
            assert torch.equal(a, b)
    assert tfs.KERNEL_WRAPPERS[tfs.K3B_KERNEL] is tfs.run_bf16_solve_kernel
    assert tfs.KERNEL_WRAPPERS[tfs.K2B_KERNEL] is tfs.run_bf16_adjoint_kernel
    with pytest.raises(NotImplementedError, match="not differentiable"):
        tfs.run_bf16_solve_kernel(TSIT5, spec, **{**fwd, "z0": fwd["z0"].clone().requires_grad_()},
                                  dlogp0=T(np.zeros(8)))


def test_microbench_config_is_the_flagship_at_tspan_one():
    assert MODELS["microbench"] == dict(MODELS["flagship"], tspan=(0.0, 1.0))
    from continuousnf_tpu_torch.utils.configs import make_icnf

    icnf = make_icnf("microbench", "cpu", bf16=True)
    assert icnf.compute_mode.bf16 and icnf.compute_mode.fused and icnf.tspan == (0.0, 1.0)
