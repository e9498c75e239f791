"""TEST-mode gradients of 2-layer nets in the port against the JAX package on
the CPU: K5's plain version (`adjoint_test_plain`, through the fused solve's
backward member) against the JAX package's TEST adjoint kernel in interpret
mode, unconditional and conditional, under tsit5, verner65 and dop853; the
hand-derived stage VJP against autograd; and the gradients that run it (the
TEST loss in params, xs and ys, `generate`, `ICNFDist.logpdf`) against
`jax.grad` of the JAX package's fused ones.

Widths: `MLP((5, 15, 5))` (nvars 3, naug 2) and its conditional form
`MLP((7, 15, 5))` on [z | ys] with two conditioning inputs (CondRNODE), at
B = 16 (one adjoint tile in the JAX kernel); inputs from numpy seeds."""

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
from continuousnf_tpu_torch.utils.configs import glorot_params

# The port's entry points default to the CUDA card; these tests run it on the CPU.
tcnf.set_default_device("cpu")

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
DIMS, COND_DIMS = (5, 15, 5), (7, 15, 5)
NVARS, NAUG, NC, B = 3, 2, 2, 16


def _dims(cond):
    return COND_DIMS if cond else DIMS


def _model(m, cond=False, method="tsit5", fused=True, **kw):
    kw = {"tspan": (0.0, 1.0), **kw}
    variant = m.CondRNODE if cond else m.RNODE
    return m.construct(variant, m.MLP(_dims(cond)), NVARS, NAUG, compute_mode=m.VecJacMode(fused=fused),
                       solver=m.SolverOptions(method=method), **kw)


def _np_params(cond, seed):
    return glorot_params(np.random.default_rng(seed), _dims(cond))


def _data(cond, seed, n=B):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(size=(n, NVARS)).astype(np.float32)
    return xs, (rng.uniform(-1.0, 1.0, (n, NC)).astype(np.float32) if cond else None)


def _leaves(ps):
    return [p[k] for p in ps for k in ("w", "b")]


def _launch_counts():
    return {name: w.launches for name, w in tfs.KERNEL_WRAPPERS.items()}


@pytest.mark.parametrize(
    "method,warm", [("tsit5", True), ("verner65", True), ("dop853", True), ("tsit5", False)],
    ids=["tsit5", "verner65", "dop853", "tsit5-hairer"],
)
@pytest.mark.parametrize("cond", [False, True], ids=["plain", "conditional"])
def test_test_adjoint_twin_matches_reference_adjoint(cond, method, warm):
    """The port's fused TEST adjoint (K5's twin on the CPU) against the JAX
    package's TEST adjoint kernel in interpret mode at one tile, from the
    same final state, cotangent and first step (the forward's last step, or
    Hairer's pick over the whole augmented state): equal steps, accepted
    steps and NFE, the states, the gradients and (conditional) the ys
    cotangent within 1e-4.  No kernel is launched."""
    span = 2.0
    ps_np = _np_params(cond, 21)
    xs, ys = _data(cond, 22)
    jfull = jfs.make_full_solve(_model(cnf, cond, method, tspan=(0.0, span)), cnf.Mode.TEST, B)
    assert jfull.adjoint is not None
    z0 = np.concatenate([xs, np.zeros((B, NAUG), np.float32)], axis=1)
    y0f = np.concatenate([z0.ravel(), np.zeros(B, np.float32)])
    args = {"ps": jax.tree.map(jnp.asarray, ps_np), "ys": None if ys is None else jnp.asarray(ys)}
    yTf, fst = jfull.forward(jnp.asarray(y0f), 0.0, span, args)
    rng = np.random.default_rng(23)
    g_yf = np.concatenate([rng.normal(0.0, 0.1, B * DIMS[-1]), np.full(B, 1.0 / B)]).astype(np.float32)
    dt_warm = float(fst.dt_last) if warm else None
    y0_r, ay0_r, gargs_r, st_r = jfull.adjoint(yTf, jnp.asarray(g_yf), args, span, 0.0, dt_warm=dt_warm)

    tfull = tfs.make_full_solve(_model(tcnf, cond, method, tspan=(0.0, span)), tcnf.Mode.TEST, B)
    targs = {"ps": tcnf.params_from_numpy(ps_np), "ys": None if ys is None else torch.from_numpy(ys)}
    before = _launch_counts()
    y0, ay0, gargs, st = tfull.adjoint(
        torch.from_numpy(np.array(yTf)), torch.from_numpy(g_yf), targs, torch.tensor(span), torch.tensor(0.0),
        dt_warm=dt_warm,
    )
    assert _launch_counts() == before
    assert (int(st.steps), int(st.accepted), int(st.nfe)) == (int(st_r.steps), int(st_r.accepted), int(st_r.nfe))
    np.testing.assert_allclose(y0.numpy(), np.asarray(y0_r), **TOL)
    np.testing.assert_allclose(ay0.numpy(), np.asarray(ay0_r), **TOL)
    for a, b in zip(_leaves(gargs["ps"]), _leaves(gargs_r["ps"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    if cond:
        assert gargs["ys"].shape == ys.shape
        np.testing.assert_allclose(gargs["ys"].numpy(), np.asarray(gargs_r["ys"]), **TOL)
        assert float(gargs["ps"][0]["w"][DIMS[-1]:].abs().max()) > 0.0  # the ys rows of g_W1
    else:
        assert gargs["ys"] is None


@pytest.mark.parametrize("cond", [False, True], ids=["plain", "conditional"])
def test_stage_vjp_matches_autograd_and_jax_stage(cond):
    """`_stage_test_fwdbwd` against `torch.func.vjp` of the plain TEST field
    (the closed form, or the chain trace with ys) in float64, and against
    the JAX package's `_stage_test_fwdbwd` in float32 (its layout is
    (rows, B))."""
    dims = _dims(cond)
    dz = dims[-1]
    spec = tfs.chain_spec(tcnf.MLP(dims), dz)
    rng = np.random.default_rng(24)
    ps_np = _np_params(cond, 25)
    z = rng.normal(size=(B, dz)).astype(np.float32)
    ys = rng.uniform(-1.0, 1.0, (B, NC)).astype(np.float32) if cond else None
    ct_y = rng.normal(size=(B, dz)).astype(np.float32)
    ct_r = rng.normal(size=(1, B)).astype(np.float32)
    T = lambda a: None if a is None else torch.from_numpy(a).double()  # noqa: E731
    ws = [T(p["w"]) for p in ps_np]
    bs = [T(p["b"]) for p in ps_np]
    y, kr, ct_zin, ct_ws, ct_bs = tfs._stage_test_fwdbwd(spec, T(z), ws, bs, T(ct_y), T(ct_r), T(ys))

    def field(z_, ws_, bs_, ys_):
        y_, tr = tfs._test_stage(spec, ws_, bs_, z_, ys_)
        return y_, -tr[None]

    primals = (T(z), ws, bs) + ((T(ys),) if cond else ())
    (y_a, kr_a), vjp = torch.func.vjp(lambda z_, ws_, bs_, *y_: field(z_, ws_, bs_, y_[0] if y_ else None), *primals)
    grads = vjp((T(ct_y), T(ct_r)))
    ct_z_a, ct_ws_a, ct_bs_a = grads[:3]
    close = dict(rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(y, y_a, **close)
    torch.testing.assert_close(kr, kr_a, **close)
    torch.testing.assert_close(ct_zin[:, :dz], ct_z_a, **close)
    if cond:
        torch.testing.assert_close(ct_zin[:, dz:], grads[3], **close)
    for a, b in zip(ct_ws + ct_bs, list(ct_ws_a) + list(ct_bs_a)):
        torch.testing.assert_close(a, b, **close)

    jspec = jfs.chain_spec(cnf.MLP(dims), dz)
    jws = [jnp.asarray(p["w"]) for p in ps_np]
    jbs = [jnp.asarray(p["b"])[:, None] for p in ps_np]
    out_j = jfs._stage_test_fwdbwd(jspec, jnp.asarray(z.T), None if ys is None else jnp.asarray(ys.T), jws, jbs,
                                   "f32", jnp.asarray(ct_y.T), jnp.asarray(ct_r))
    y_j, kr_j, ct_zin_j, ct_ws_j, ct_bs_j = out_j
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j).T, **GRAD_TOL)
    np.testing.assert_allclose(kr.numpy(), np.asarray(kr_j), **GRAD_TOL)
    np.testing.assert_allclose(ct_zin.numpy(), np.asarray(ct_zin_j).T, **GRAD_TOL)
    for a, b in zip(ct_ws + ct_bs, list(ct_ws_j) + [np.asarray(x)[:, 0] for x in ct_bs_j]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


@pytest.mark.parametrize("cond", [False, True], ids=["plain", "conditional"])
def test_fused_test_gradients_match_jax_fused_gradients(cond):
    """The TEST loss (the exact-trace maximum likelihood) and its gradient in
    the params, in xs and (conditional) in ys through the port's fused solve
    (the K3 or K7 TEST twin forward, K5's twin backward) against `jax.grad`
    of the JAX package's fused loss (its forward and TEST adjoint kernels in
    interpret mode)."""
    ps_np = _np_params(cond, 26)
    xs, ys = _data(cond, 27)

    def jloss(p, x, y):
        return cnf.loss(_model(cnf, cond), cnf.Mode.TEST, x, p, ys=y)

    argnums = (0, 1, 2) if cond else (0, 1)
    l_r = float(jloss(jax.tree.map(jnp.asarray, ps_np), jnp.asarray(xs), None if ys is None else jnp.asarray(ys)))
    g_r = jax.grad(jloss, argnums=argnums)(jax.tree.map(jnp.asarray, ps_np), jnp.asarray(xs),
                                           None if ys is None else jnp.asarray(ys))
    want = _leaves(g_r[0]) + [g_r[1]] + ([g_r[2]] if cond else [])

    ps = tcnf.params_from_numpy(ps_np)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    x_t = torch.from_numpy(xs).requires_grad_()
    y_t = None if ys is None else torch.from_numpy(ys).requires_grad_()
    before = _launch_counts()
    l = tcnf.loss(_model(tcnf, cond), tcnf.Mode.TEST, x_t, ps, ys=y_t)
    got = torch.autograd.grad(l, leaves + [x_t] + ([y_t] if cond else []))
    assert _launch_counts() == before
    np.testing.assert_allclose(float(l.detach()), l_r, **TOL)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


def test_generate_gradient_matches_jax():
    """The gradient in the params of a weighted sum of TEST `generate`'s
    samples (the reverse-time solve t1 -> t0, so its backward runs t0 -> t1
    through K5's twin) against JAX's, with its base draw injected."""
    ps_np = _np_params(False, 28)
    key = jax.random.PRNGKey(29)
    w = np.random.default_rng(30).normal(size=(B, NVARS)).astype(np.float32)

    def jobj(p):
        return jnp.sum(cnf.generate(_model(cnf), cnf.Mode.TEST, p, B, key=key) * jnp.asarray(w))

    g_r = _leaves(jax.grad(jobj)(jax.tree.map(jnp.asarray, ps_np)))
    z1 = np.array(_model(cnf).base_sample(jax.random.split(key, 3)[0], (B,)))
    ps = tcnf.params_from_numpy(ps_np)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    obj = torch.sum(tcnf.generate(_model(tcnf), tcnf.Mode.TEST, ps, B, z1=z1) * torch.from_numpy(w))
    np.testing.assert_allclose(float(obj.detach()), float(jobj(jax.tree.map(jnp.asarray, ps_np))), **TOL)
    for a, b in zip(torch.autograd.grad(obj, leaves), g_r):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


def test_logpdf_gradients_match_jax():
    """`ICNFDist.logpdf`'s gradients: in the params of the summed log-density,
    and in x (the score), against the JAX package's fused ones."""
    ps_np = _np_params(False, 31)
    xs, _ = _data(False, 32)

    def jobj(p, x):
        return jnp.sum(cnf.ICNFDist(_model(cnf), cnf.Mode.TEST, p).logpdf(x))

    g_r = jax.grad(jobj, argnums=(0, 1))(jax.tree.map(jnp.asarray, ps_np), jnp.asarray(xs))
    ps = tcnf.params_from_numpy(ps_np)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    x_t = torch.from_numpy(xs).requires_grad_()
    lp = tcnf.ICNFDist(_model(tcnf), tcnf.Mode.TEST, ps).logpdf(x_t)
    got = torch.autograd.grad(torch.sum(lp), leaves + [x_t])
    for a, b in zip(got, _leaves(g_r[0]) + [g_r[1]]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


def test_test_adjoint_wrapper_runs_plain_version_on_cpu():
    """On CPU tensors `run_test_adjoint_kernel` is its twin, bit for bit, and
    counts no launch; it refuses inputs that need a gradient and chains
    other than 2 tanh layers (no TEST adjoint there, as in the JAX
    package)."""
    ps = tcnf.params_from_numpy(_np_params(True, 33))
    rng = np.random.default_rng(34)
    T = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    kw = dict(
        rtol=1e-3, atol=1e-6, max_steps=100, ws=[p["w"] for p in ps], bs=[p["b"] for p in ps],
        zT=T(rng.normal(size=(B, 5))), accT=T(rng.normal(size=(1, B))), azT=T(rng.normal(size=(B, 5))),
        aaccT=T(rng.normal(size=(1, B))), t_hi=torch.tensor(1.0), t_lo=torch.tensor(0.0),
        dt_init=torch.tensor(-0.1), ys=T(rng.uniform(-1.0, 1.0, (B, NC))),
    )
    spec = tfs.chain_spec(tcnf.MLP(COND_DIMS), 5)
    before = tfs.run_test_adjoint_kernel.launches
    got = tfs.run_test_adjoint_kernel(TSIT5, spec, **kw)
    ref = tfs.adjoint_test_plain(TSIT5, spec, **kw)
    assert tfs.run_test_adjoint_kernel.launches == before
    assert len(got) == len(ref) == 8 and got[7].shape == (B, NC)
    for a, b in zip(got, ref):
        for x, y in zip(a if isinstance(a, list) else [a], b if isinstance(b, list) else [b]):
            assert torch.equal(x, y)
    with pytest.raises(NotImplementedError, match="not differentiable"):
        tfs.run_test_adjoint_kernel(TSIT5, spec, **{**kw, "zT": kw["zT"].clone().requires_grad_()})
    deep = tfs.chain_spec(tcnf.MLP((5, 9, 7, 5)), 5)
    with pytest.raises(ValueError, match="2-layer tanh"):
        tfs.run_test_adjoint_kernel(TSIT5, deep, **{**kw, "ys": None})


@pytest.mark.parametrize(
    "dims,final,cond,covered",
    [((5, 15, 5), True, False, True), ((7, 15, 5), True, True, True), ((5, 15, 5), False, False, False),
     ((5, 9, 7, 5), True, False, False)],
    ids=["two-layer", "two-layer-conditional", "identity-out", "three-layer"],
)
def test_test_backward_member_exists_for_two_layer_tanh_nets(dims, final, cond, covered):
    """The fused TEST solve's backward member (K5) exists for 2-layer tanh
    nets, conditional or not; deeper chains have none (as in the JAX
    package), and nor do 2-layer nets with an identity layer (the JAX
    package's 2-layer TEST stage assumes tanh layers)."""
    variant = tcnf.CondRNODE if cond else tcnf.RNODE
    icnf = tcnf.construct(variant, tcnf.MLP(dims, final_activation=torch.tanh if final else None), NVARS, NAUG,
                          compute_mode=tcnf.VecJacMode(fused=True))
    assert (tfs.make_full_solve(icnf, tcnf.Mode.TEST, B).adjoint is not None) == covered
