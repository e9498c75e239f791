"""The port's conditional slice against the JAX package on the CPU: CondLayer
and CondWrap, the conditional TEST, Hutchinson and exact fields, the chain
kernels' plain versions with conditioning rows (the K1 and K2 chain forms,
K7 TEST and exact; for a 2-layer net the COND instances of K3 and of the K4
forward and adjoint) against the JAX
package's kernels in interpret mode at one tile, TEST and TRAIN `inference`,
the loss and its gradients in the params and in ys, `generate`,
`CondICNFDist`, the conditional `fit` and the conditioning checks.

Widths: the conditional recipe (`continuousnf_tpu/recipes.py:254-289`,
CondRNODE, MLP 2 -> 64 -> 64 -> 1 on [x | y]), a narrow 3-layer chain with
two conditioning inputs (MLP 5 -> 9 -> 7 -> 3, nvars 2, naug 1) and a 2-layer
conditional net (MLP 4 -> 16 -> 2, two conditioning inputs).  Inputs come
from numpy seeds; the JAX probe and steering draws are reproduced from its
key split (`core/icnf.py:485`) and handed to the port."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import continuousnf_tpu as cnf
import continuousnf_tpu_torch as tcnf
from continuousnf_tpu.core.dynamics import TestState as JTestState
from continuousnf_tpu.core.dynamics import TrainState as JTrainState
from continuousnf_tpu.core.dynamics import make_augmented_dynamics as jdyn
from continuousnf_tpu.ode.tableaus import TSIT5 as JTSIT5
from continuousnf_tpu.ops import fused_solve as jfs
from continuousnf_tpu_torch.core.dynamics import TestState as TTestState
from continuousnf_tpu_torch.core.dynamics import TrainState as TTrainState
from continuousnf_tpu_torch.core.dynamics import make_augmented_dynamics as tdyn
from continuousnf_tpu_torch.ops import fused_solve as tfs
from continuousnf_tpu_torch.utils.configs import MODELS, cond_gaussian_data, glorot_params

# The port's entry points default to the CUDA card; these tests run it on the CPU.
tcnf.set_default_device("cpu")

tfit = importlib.import_module("continuousnf_tpu_torch.train.fit")

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
FIELD_TOL = dict(rtol=1e-4, atol=1e-5)
# The JAX package's own bound between its fused and unfused gradients
# (tests/test_fused_chain.py:23): the backward solves run on different step
# grids (warm-started vs Hairer-picked first step).
FUSED_GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
RECIPE, NARROW, TWO = (2, 64, 64, 1), (5, 9, 7, 3), (4, 16, 2)
# dims -> (nvars, naug, n_cond)
SPLIT = {RECIPE: (1, 0, 1), NARROW: (2, 1, 2), TWO: (2, 0, 2)}
DIMS = {"recipe": RECIPE, "narrow": NARROW, "two-layer": TWO}
B = 32
MODE_NAMES = {"train": "TRAIN", "test": "TEST", "exact": "TRAIN"}


def _cm(m, mode, fused=True):
    return m.ComputeMode(ad=m.ADMode.VJP, fused=fused, exact_trace=mode == "exact")


def _np_params(dims, seed):
    return glorot_params(np.random.default_rng(seed), dims)


def _model(m, dims, compute_mode=None, **kw):
    nvars, naug, _ = SPLIT[dims]
    cm = compute_mode if compute_mode is not None else m.VecJacMode(fused=True)
    return m.construct(m.CondRNODE, m.MLP(dims), nvars, naug, compute_mode=cm, **kw)


def _recipe(m, compute_mode, tspan=(0.0, 1.0), **kw):
    """The conditional recipe's model (steer_rate 0.1) over `tspan`.  The
    float32 parity tests run it over (0, 1): over the recipe's (0, 13) the
    random weights amplify float32 roundoff until the step controller sits
    at a near-tie, and the JAX package's own fused and unfused paths take
    different step counts on the same inputs (22 and 23).  The float64 test
    holds the recipe's own span."""
    return _model(m, RECIPE, compute_mode, tspan=tspan, **MODELS["cond_gaussian"]["extra"], **kw)


def _data(dims, n, seed):
    """(xs (n, nvars), ys (n, n_cond)): the recipe's y ~ U(-1, 1),
    x | y ~ N(0.7 y, 0.3^2), or for the other widths x ~ N(0, 1) next to
    y ~ U(-1, 1)."""
    rng = np.random.default_rng(seed)
    if dims == RECIPE:
        return cond_gaussian_data(rng, n)
    nvars, _, nc = SPLIT[dims]
    return rng.normal(size=(n, nvars)).astype(np.float32), rng.uniform(-1.0, 1.0, (n, nc)).astype(np.float32)


def _jps(ps_np):
    return jax.tree.map(jnp.asarray, ps_np)


def _leaves(ps):
    return [p[k] for p in ps for k in ("w", "b")]


def _y0(dims, xs, nacc):
    naug = SPLIT[dims][1]
    z0 = np.concatenate([xs, np.zeros((xs.shape[0], naug), np.float32)], axis=1)
    return np.concatenate([z0.ravel(), np.zeros(nacc * xs.shape[0], np.float32)])


def _jax_draws(icnf, key, batch):
    """The probes and the steering r JAX TRAIN `inference` draws from `key`."""
    eps_key, steer_key = jax.random.split(key)
    eps = None if icnf.compute_mode.exact_trace else np.array(icnf.draw_eps(eps_key, batch))
    r = float(jax.random.uniform(steer_key, (), icnf.dtype, -icnf.steer_rate, icnf.steer_rate))
    return eps, r


def _launch_counts():
    return {name: w.launches for name, w in tfs.KERNEL_WRAPPERS.items()}


@pytest.mark.parametrize("rank", [2, 1])
def test_cond_layer_and_wrap_match_jax(rank):
    ps_np = _np_params(NARROW, 1)
    xs, ys = _data(NARROW, 6, 2)
    ys = ys if rank == 2 else ys[0]
    z = np.concatenate([xs, np.ones((6, 1), np.float32)], axis=1)
    ref = cnf.nets.modules.CondWrap(cnf.MLP(NARROW), jnp.asarray(ys))(_jps(ps_np), jnp.asarray(z))
    ps = tcnf.params_from_numpy(ps_np)
    got = tcnf.CondWrap(tcnf.MLP(NARROW), torch.from_numpy(ys))(ps, torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    layer = tcnf.CondLayer(tcnf.MLP(NARROW), SPLIT[NARROW][2])
    assert torch.equal(layer.apply_with_cond(ps, torch.from_numpy(z), torch.from_numpy(ys)), got)
    assert layer.out_dim == 3 and len(layer.init()) == 3
    with pytest.raises(TypeError, match="requires conditioning"):
        layer.apply(ps, torch.from_numpy(z))


@pytest.mark.parametrize("rank", [2, 1], ids=["ys-rows", "ys-one-row"])
@pytest.mark.parametrize("dims", list(DIMS.values()), ids=list(DIMS))
@pytest.mark.parametrize("mode", ["test", "train", "exact"])
def test_cond_fields_match_jax(mode, dims, rank):
    """The conditional TEST, Hutchinson and exact TRAIN fields (the chain
    product with the z rows of the first layer) against the JAX package's
    generic identity-basis fields (`_exact_field`, `_hutchinson_field`,
    `_exact_train_field`).  The Hutchinson field is built fused: for a
    2-layer net that is the per-stage kernel's field, which falls back to
    the plain one for conditional calls."""
    mode_name = MODE_NAMES[mode]
    ps_np = _np_params(dims, 3)
    dz = dims[-1]
    rng = np.random.default_rng(4)
    z = rng.normal(size=(B, dz)).astype(np.float32)
    _, ys = _data(dims, B, 5)
    ys = ys if rank == 2 else ys[0]
    eps = rng.normal(size=(1, B, dz)).astype(np.float32)
    zeros = np.zeros(B, np.float32)
    fj = jdyn(cnf.MLP(dims), getattr(cnf.Mode, mode_name), _cm(cnf, mode), True, True)
    ft = tdyn(tcnf.MLP(dims), getattr(tcnf.Mode, mode_name), _cm(tcnf, mode), True, True)
    if mode == "test":
        sj, st = JTestState(jnp.asarray(z), jnp.asarray(zeros)), TTestState(torch.from_numpy(z), torch.from_numpy(zeros))
    else:
        sj = JTrainState(*(jnp.asarray(x) for x in (z, zeros, zeros, zeros)))
        st = TTrainState(torch.from_numpy(z), *(torch.from_numpy(zeros),) * 3)
    ref = fj(0.0, sj, {"ps": _jps(ps_np), "ys": jnp.asarray(ys), "eps": jnp.asarray(eps)})
    with torch.no_grad():
        got = ft(0.0, st, {"ps": tcnf.params_from_numpy(ps_np), "ys": torch.from_numpy(ys),
                           "eps": torch.from_numpy(eps)})
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FIELD_TOL)


@pytest.mark.parametrize("dims", list(DIMS.values()), ids=list(DIMS))
@pytest.mark.parametrize("mode", ["train", "test", "exact"])
def test_cond_forward_twins_match_jax_kernel(mode, dims):
    """The plain versions of the K1 chain form (train), K7 TEST (test) and K7
    exact (exact) with conditioning rows, through the fused solve on CPU
    tensors (for the 2-layer net, whose TEST and exact forwards run the COND
    instances of K3 and the K4 forward, theirs), against the JAX package's
    forward kernel with ys rows in interpret mode (for the 2-layer net its
    K1, K3 and K4 forms) from zero accumulators: equal attempted and
    accepted steps, values at 1e-4.  No kernel is launched."""
    mode_name = MODE_NAMES[mode]
    ps_np = _np_params(dims, 6)
    xs, ys = _data(dims, B, 7)
    nacc = 1 if mode == "test" else 3
    y0f = _y0(dims, xs, nacc)
    eps = np.random.default_rng(8).normal(size=(1, B, dims[-1])).astype(np.float32) if mode == "train" else None
    span = 2.0
    jfull = jfs.make_full_solve(_model(cnf, dims, _cm(cnf, mode)), getattr(cnf.Mode, mode_name), B)
    jargs = {"ps": _jps(ps_np), "eps": None if eps is None else jnp.asarray(eps), "ys": jnp.asarray(ys)}
    yT_r, st_r = jfull.forward(jnp.asarray(y0f), 0.0, span, jargs)
    tfull = tfs.make_full_solve(_model(tcnf, dims, _cm(tcnf, mode)), getattr(tcnf.Mode, mode_name), B)
    targs = {"ps": tcnf.params_from_numpy(ps_np), "eps": None if eps is None else torch.from_numpy(eps),
             "ys": torch.from_numpy(ys)}
    before = _launch_counts()
    with torch.no_grad():
        yT, st = tfull.forward(torch.from_numpy(y0f), torch.tensor(0.0), torch.tensor(span), targs)
    assert _launch_counts() == before
    assert (int(st.steps), int(st.accepted), int(st.nfe)) == (int(st_r.steps), int(st_r.accepted), int(st_r.nfe))
    np.testing.assert_allclose(yT.numpy(), np.asarray(yT_r), **TOL)


@pytest.mark.parametrize(
    "dims,mode", [(RECIPE, "train"), (NARROW, "train"), (TWO, "train"), (TWO, "exact")],
    ids=["recipe", "narrow", "two-layer", "two-layer-exact"],
)
def test_cond_adjoint_twin_matches_jax_kernel(dims, mode):
    """The K2 chain form's plain version with the ys block (and, for the
    2-layer exact net, the K4 adjoint COND instance's) against the JAX
    package's adjoint kernel in interpret mode at one tile, from the same
    final state, cotangent and warm start: equal steps, the states, a_ys0
    and the gradients (the ys rows of g_W0 among them, which are not zero)
    at 1e-4."""
    exact = mode == "exact"
    jspec = jfs.chain_spec(cnf.MLP(dims), dims[-1])
    assert jfs._vmem_estimate_adjoint(JTSIT5, jspec, B, 3, 1, exact) <= jfs._VMEM_BUDGET_BYTES // 2
    ps_np = _np_params(dims, 9)
    xs, ys = _data(dims, B, 10)
    dz = dims[-1]
    eps = None if exact else np.random.default_rng(11).normal(size=(1, B, dz)).astype(np.float32)
    span = 2.0
    jfull = jfs.make_full_solve(_model(cnf, dims, _cm(cnf, mode), tspan=(0.0, span)), cnf.Mode.TRAIN, B)
    args = {"ps": _jps(ps_np), "eps": None if eps is None else jnp.asarray(eps), "ys": jnp.asarray(ys)}
    yTf, fst = jfull.forward(jnp.asarray(_y0(dims, xs, 3)), 0.0, span, args)
    rng = np.random.default_rng(12)
    g_yf = np.concatenate(
        [rng.normal(0.0, 0.1, B * dz), np.full(B, 1.0 / B), np.full(2 * B, 1e-2 / B)]
    ).astype(np.float32)
    dt_warm = float(fst.dt_last)
    y0_r, ay0_r, gargs_r, st_r = jfull.adjoint(yTf, jnp.asarray(g_yf), args, span, 0.0, dt_warm=dt_warm)

    tfull = tfs.make_full_solve(_model(tcnf, dims, _cm(tcnf, mode), tspan=(0.0, span)), tcnf.Mode.TRAIN, B)
    targs = {"ps": tcnf.params_from_numpy(ps_np), "eps": None if eps is None else torch.from_numpy(eps),
             "ys": torch.from_numpy(ys)}
    before = _launch_counts()
    y0, ay0, gargs, st = tfull.adjoint(
        torch.from_numpy(np.array(yTf)), torch.from_numpy(g_yf), targs, torch.tensor(span), torch.tensor(0.0),
        dt_warm=dt_warm,
    )
    assert _launch_counts() == before
    assert (int(st.steps), int(st.accepted), int(st.nfe)) == (int(st_r.steps), int(st_r.accepted), int(st_r.nfe))
    np.testing.assert_allclose(y0.numpy(), np.asarray(y0_r), **TOL)
    np.testing.assert_allclose(ay0.numpy(), np.asarray(ay0_r), **TOL)
    assert gargs["ys"].shape == ys.shape
    np.testing.assert_allclose(gargs["ys"].numpy(), np.asarray(gargs_r["ys"]), **TOL)
    for a, b in zip(_leaves(gargs["ps"]), _leaves(gargs_r["ps"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert float(gargs["ps"][0]["w"][dz:].abs().max()) > 0.0


def test_cond_adjoint_without_warm_start_picks_over_the_ys_block():
    """Without dt_warm the fused adjoint picks its first step by Hairer's
    rule over the whole state it integrates, a zero a_ys block included:
    the twin with dt_init=None, bit for bit."""
    dims = NARROW
    ps_np = _np_params(dims, 13)
    _, ys = _data(dims, B, 14)
    rng = np.random.default_rng(15)
    T = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    zT, azT, eps = T(rng.normal(size=(B, 3))), T(rng.normal(0.0, 0.1, (B, 3))), T(rng.normal(size=(1, B, 3)))
    accT, aaccT = T(rng.normal(size=(3, B))), T(rng.normal(0.0, 0.1, (3, B)))
    ps = tcnf.params_from_numpy(ps_np)
    tfull = tfs.make_full_solve(_model(tcnf, dims), tcnf.Mode.TRAIN, B)
    y0, ay0, gargs, st = tfull.adjoint(
        torch.cat([zT.reshape(-1), accT.reshape(-1)]), torch.cat([azT.reshape(-1), aaccT.reshape(-1)]),
        {"ps": ps, "eps": eps, "ys": torch.from_numpy(ys)}, torch.tensor(1.0), torch.tensor(0.0),
    )
    ref = tfs.adjoint_train_plain(
        tfs.TSIT5, tfs.chain_spec(tcnf.MLP(dims), 3), norm_z=True, norm_j=True, rtol=1e-3, atol=1e-6,
        max_steps=10_000, ws=[p["w"] for p in ps], bs=[p["b"] for p in ps], eps=eps, zT=zT, accT=accT, azT=azT,
        aaccT=aaccT, t_hi=torch.tensor(1.0), t_lo=torch.tensor(0.0), dt_init=None, ys=torch.from_numpy(ys),
    )
    assert len(ref) == 8 and int(st.steps) == int(ref[5]) and int(st.nfe) == int(ref[5]) * 6 + 2
    assert torch.equal(y0[: B * 3], ref[0].reshape(-1)) and torch.equal(gargs["ys"], ref[7])


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("mode", ["test", "train", "exact"])
def test_cond_inference_matches_jax(mode, fused):
    """TEST and TRAIN `inference` of the conditional recipe against the JAX
    package's path of the same kind (unfused, or its kernels in interpret
    mode), with the same weights, inputs, ys, probes and steering draw."""
    mode_name = MODE_NAMES[mode]
    jicnf, ticnf = _recipe(cnf, _cm(cnf, mode, fused)), _recipe(tcnf, _cm(tcnf, mode, fused))
    ps_np = _np_params(RECIPE, 16)
    xs, ys = _data(RECIPE, B, 17)
    key = jax.random.PRNGKey(18)
    lp_r, regs_r, st_r = cnf.inference(jicnf, getattr(cnf.Mode, mode_name), jnp.asarray(xs), _jps(ps_np),
                                       ys=jnp.asarray(ys), key=key)
    extra = {}
    if mode_name == "TRAIN":
        eps, r = _jax_draws(jicnf, key, B)
        extra = {"steer_r": r} if eps is None else {"steer_r": r, "eps": eps}
    with torch.no_grad():
        lp, regs, st = tcnf.inference(ticnf, getattr(tcnf.Mode, mode_name), xs, tcnf.params_from_numpy(ps_np),
                                      ys=ys, **extra)
    assert (int(st.steps), int(st.accepted), int(st.nfe)) == (int(st_r.steps), int(st_r.accepted), int(st_r.nfe))
    for a, b in ((lp, lp_r), (regs.e, regs_r.e), (regs.n, regs_r.n)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def _grads(jicnf, ticnf, xs, ys, ps_np, key):
    """The TRAIN loss and its gradients in (params, ys) through both
    packages, with JAX's draws handed to the port."""
    l_r, (g_r, gy_r) = jax.value_and_grad(
        lambda p, y: cnf.loss(jicnf, cnf.Mode.TRAIN, jnp.asarray(xs), p, ys=y, key=key), argnums=(0, 1)
    )(_jps(ps_np), jnp.asarray(ys))
    eps, r = _jax_draws(jicnf, key, xs.shape[0])
    ps = tcnf.params_from_numpy(ps_np)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    ys_t = torch.from_numpy(ys).requires_grad_()
    extra = {} if eps is None else {"eps": eps}
    l = tcnf.loss(ticnf, tcnf.Mode.TRAIN, xs, ps, ys=ys_t, steer_r=r, **extra)
    g = torch.autograd.grad(l, leaves + [ys_t])
    return (float(l.detach()), [x.numpy() for x in g]), (float(l_r), [np.asarray(x) for x in _leaves(g_r)]
                                                          + [np.asarray(gy_r)])


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("mode", ["train", "exact"])
def test_cond_gradients_match_jax_grad(mode, fused):
    """The recipe's loss and its gradients in the params and in ys (B, 1)
    through BACKSOLVE against `jax.grad` of the JAX package's loss on the
    path of the same kind.  Fused, the Hutchinson gradient runs the K1 and
    K2 chain forms' twins (a_ys in the backward state), the exact one the K7
    forward's twin and the plain backward (forward-only, as in the JAX
    package)."""
    jicnf, ticnf = _recipe(cnf, _cm(cnf, mode, fused)), _recipe(tcnf, _cm(tcnf, mode, fused))
    full = tfs.make_full_solve(ticnf, tcnf.Mode.TRAIN, B)
    assert (full is None) == (not fused)
    if fused:
        assert (full.adjoint is None) == (mode == "exact")
    xs, ys = _data(RECIPE, B, 19)
    (l, g), (l_r, g_r) = _grads(jicnf, ticnf, xs, ys, _np_params(RECIPE, 20), jax.random.PRNGKey(21))
    np.testing.assert_allclose(l, l_r, **GRAD_TOL)
    for a, b in zip(g, g_r):
        np.testing.assert_allclose(a, b, **GRAD_TOL)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_cond_gradient_of_a_single_ys_row(fused):
    """A 1-D ys (n_cond,) shared by the batch: its gradient comes back with
    its own shape, summed over the batch, against the JAX package's unfused
    path (fused within the bound between the JAX package's fused and
    unfused gradients)."""
    jicnf = _recipe(cnf, _cm(cnf, "train", False))
    ticnf = _recipe(tcnf, _cm(tcnf, "train", fused))
    xs, ys = _data(RECIPE, B, 22)
    (l, g), (l_r, g_r) = _grads(jicnf, ticnf, xs, ys[0], _np_params(RECIPE, 23), jax.random.PRNGKey(24))
    assert g[-1].shape == (1,)
    tol = FUSED_GRAD_TOL if fused else GRAD_TOL
    np.testing.assert_allclose(l, l_r, **TOL)
    for a, b in zip(g, g_r):
        np.testing.assert_allclose(a, b, **tol)


@pytest.mark.parametrize("mode", ["test", "train", "exact"])
def test_cond_recipe_in_float64_matches_jax(mode):
    """The conditional recipe itself (tspan (0, 13), steer_rate 0.1) on the
    plain path in float64 against the JAX package's in float64: equal step
    counts, log-densities within 1e-10 and, in TRAIN mode, the gradients in
    the params and in ys within 1e-8."""
    mode_name = MODE_NAMES[mode]
    cfg = MODELS["cond_gaussian"]
    ps_np = jax.tree.map(lambda a: a.astype(np.float64), _np_params(RECIPE, 36))
    xs, ys = (a.astype(np.float64) for a in _data(RECIPE, B, 37))
    key = jax.random.PRNGKey(38)
    with jax.enable_x64():
        jicnf = _recipe(cnf, _cm(cnf, mode, False), cfg["tspan"], dtype=jnp.float64)
        jps = jax.tree.map(jnp.asarray, ps_np)
        lp_r, _, st_r = cnf.inference(jicnf, getattr(cnf.Mode, mode_name), jnp.asarray(xs), jps, ys=jnp.asarray(ys),
                                      key=key)
        extra = {}
        if mode_name == "TRAIN":
            eps, r = _jax_draws(jicnf, key, B)
            extra = {"steer_r": r} if eps is None else {"steer_r": r, "eps": eps}
            _, (g_r, gy_r) = jax.value_and_grad(
                lambda p, y: cnf.loss(jicnf, cnf.Mode.TRAIN, jnp.asarray(xs), p, ys=y, key=key), argnums=(0, 1)
            )(jps, jnp.asarray(ys))
            g_r = [np.asarray(x) for x in _leaves(g_r)] + [np.asarray(gy_r)]
    ticnf = _recipe(tcnf, _cm(tcnf, mode, False), cfg["tspan"], dtype=torch.float64)
    ps = tcnf.params_from_numpy(ps_np)
    with torch.no_grad():
        lp, _, st = tcnf.inference(ticnf, getattr(tcnf.Mode, mode_name), xs, ps, ys=ys, **extra)
    assert int(st.steps) == int(st_r.steps) >= 14
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_r), rtol=1e-10, atol=1e-10)
    if mode_name == "TRAIN":
        leaves = [x.requires_grad_() for x in _leaves(ps)]
        ys_t = torch.from_numpy(ys).requires_grad_()
        g = torch.autograd.grad(tcnf.loss(ticnf, tcnf.Mode.TRAIN, xs, ps, ys=ys_t, **extra), leaves + [ys_t])
        for a, b in zip(g, g_r):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("rank", [2, 1], ids=["one-row", "vector"])
def test_cond_generate_matches_jax(rank):
    """`generate` through K7 TEST's twin with the JAX package's base draw
    injected and one row of ys for every sample, against its generate."""
    ticnf, jicnf = _recipe(tcnf, _cm(tcnf, "test")), _recipe(cnf, _cm(cnf, "test"))
    ps_np = _np_params(RECIPE, 25)
    ys = np.array([[0.4]], np.float32) if rank == 2 else np.array([0.4], np.float32)
    key = jax.random.PRNGKey(26)
    ref, st_r = cnf.generate(jicnf, cnf.Mode.TEST, _jps(ps_np), B, ys=jnp.asarray(ys), key=key, with_stats=True)
    z_key, _, _ = jax.random.split(key, 3)
    z1 = np.array(jicnf.base_sample(z_key, (B,)))
    with torch.no_grad():
        got, st = tcnf.generate(ticnf, tcnf.Mode.TEST, tcnf.params_from_numpy(ps_np), B, ys=ys, z1=z1,
                                with_stats=True)
    assert int(st.steps) == int(st_r.steps)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    with torch.no_grad():
        one = tcnf.generate(ticnf, tcnf.Mode.TEST, tcnf.params_from_numpy(ps_np), ys=ys, z1=z1[0])
    assert one.shape == (1,)


def test_cond_dist_slices_ys_to_batch():
    """`CondICNFDist` slices stored rows of ys to the query batch (as
    tests/test_dist.py holds the JAX package's), matches the JAX package's
    CondICNFDist, and samples with the first rows or a shared row."""
    ticnf, jicnf = _recipe(tcnf, _cm(tcnf, "test")), _recipe(cnf, _cm(cnf, "test"))
    ps_np = _np_params(RECIPE, 27)
    xs, ys = _data(RECIPE, 10, 28)
    ps = tcnf.params_from_numpy(ps_np)
    d = tcnf.CondICNFDist(ticnf, tcnf.Mode.TEST, ps, torch.from_numpy(ys))
    assert len(d) == 1
    with torch.no_grad():
        lp = d.logpdf(xs[:4])
        lp_direct, _, _ = tcnf.inference(ticnf, tcnf.Mode.TEST, xs[:4], ps, ys=ys[:4])
        assert torch.equal(lp, lp_direct)
        ref = cnf.CondICNFDist(jicnf, cnf.Mode.TEST, _jps(ps_np), jnp.asarray(ys)).logpdf(jnp.asarray(xs[:4]))
        np.testing.assert_allclose(lp.numpy(), np.asarray(ref), **TOL)
        np.testing.assert_allclose(d.pdf(xs[:4]).numpy(), np.exp(np.asarray(ref)), **TOL)
        z1 = np.random.default_rng(29).normal(size=(4, 1)).astype(np.float32)
        s = d.sample(4, z1=z1)
        assert s.shape == (4, 1)
        assert torch.equal(s, tcnf.generate(ticnf, tcnf.Mode.TEST, ps, 4, ys=ys[:4], z1=z1))
        shared = tcnf.CondICNFDist(ticnf, tcnf.Mode.TEST, ps, torch.tensor([0.2]))
        assert shared.logpdf(xs).shape == (10,) and shared.logpdf(xs[0]).shape == ()
        assert shared.sample(3, generator=torch.Generator().manual_seed(0)).shape == (3, 1)


def _spy_steps(monkeypatch, records):
    body = tfit.make_train_step_body

    def spy(icnf, optimizer, mesh=None):
        step = body(icnf, optimizer, mesh)

        def wrapped(ps, xs, generator=None, weights=None, ys=None, **kw):
            record = ([{k: v.detach().numpy().copy() for k, v in p.items()} for p in ps], xs.numpy().copy(),
                      ys.numpy().copy(), weights.numpy().copy(), generator.get_state())
            m = step(ps, xs, generator, weights=weights, ys=ys, **kw)
            records.append(record + (float(m["loss"]),))
            return m

        return wrapped

    monkeypatch.setattr(tfit, "make_train_step_body", spy)


def test_cond_fit_permutes_x_and_y_alike_and_matches_jax_loss(monkeypatch):
    """`fit(CondICNFModel(...), X, Y)` on 50 samples at batch 16: four steps,
    each batch's rows of X and Y from the same samples (the permutation
    applied to both, the padded tail repeating rows of both with weight 0),
    the last step's weighted loss equal to the JAX package's
    `loss(weights=, ys=)` on the same batch and probes, and two fits of the
    same seed equal."""
    dims = NARROW
    ps_np = _np_params(dims, 30)
    X, _ = _data(dims, 50, 31)
    Y = np.stack([np.arange(50) / 50.0, np.linspace(-1.0, 1.0, 50)], axis=1).astype(np.float32)
    records = []
    _spy_steps(monkeypatch, records)
    icnf = _model(tcnf, dims, tspan=(0.0, 1.0))
    model = tcnf.CondICNFModel(icnf, n_epochs=1, batch_size=16)
    res = tcnf.fit(model, X, Y, ps=tcnf.params_from_numpy(ps_np), seed=3)
    assert len(records) == 4 and res.epochs == 1 and np.isfinite(res.losses).all()
    for _, xb, yb, wb, _, _ in records:
        rows = np.rint(yb[:, 0] * 50).astype(int)
        np.testing.assert_array_equal(xb, X[rows])
        np.testing.assert_array_equal(yb, Y[rows])
    ps_last, xb, yb, wb, gen_state, loss_last = records[-1]
    assert wb.sum() == 2.0 and (wb[2:] == 0.0).all()
    first_rows = np.concatenate([r[2] for r in records[:-1]])[:14]
    np.testing.assert_array_equal(yb[2:], first_rows)
    eps = icnf.draw_eps(torch.Generator().set_state(gen_state), 16).numpy()
    ref = cnf.loss(_model(cnf, dims, tspan=(0.0, 1.0)), cnf.Mode.TRAIN, jnp.asarray(xb),
                   jax.tree.map(jnp.asarray, tuple(ps_last)), ys=jnp.asarray(yb), key=jax.random.PRNGKey(0),
                   weights=jnp.asarray(wb), eps=jnp.asarray(eps))
    np.testing.assert_allclose(loss_last, float(ref), **TOL)
    again = tcnf.fit(model, X, torch.from_numpy(Y), ps=tcnf.params_from_numpy(ps_np), seed=3)
    np.testing.assert_array_equal(again.losses, res.losses)
    for a, b in zip(_leaves(again.ps), _leaves(res.ps)):
        assert torch.equal(a, b)


def test_cond_fit_checks_y():
    icnf = _model(tcnf, NARROW)
    X, Y = _data(NARROW, 8, 32)
    model = tcnf.CondICNFModel(icnf, n_epochs=1, batch_size=4)
    assert tcnf.CondICNFModel is tcnf.ICNFModel
    with pytest.raises(ValueError, match="requires Y"):
        tcnf.fit(model, X)
    with pytest.raises(ValueError, match="rows"):
        tcnf.fit(model, X, Y[:5])
    with pytest.raises(NotImplementedError, match="item 18"):
        tcnf.fit(model, X, Y.tolist())
    plain = tcnf.construct(tcnf.RNODE, tcnf.MLP((3, 8, 3)), 2, 1)
    with pytest.raises(ValueError, match="non-conditional model got Y"):
        tcnf.fit(tcnf.ICNFModel(plain, n_epochs=1, batch_size=4), X, Y)


def test_check_cond_errors():
    """`_check_cond` as in the JAX package: a conditional model without ys
    and an unconditional one with ys raise ValueError, in every entry
    point."""
    cond = _model(tcnf, NARROW)
    plain = tcnf.construct(tcnf.RNODE, tcnf.MLP((3, 8, 3)), 2, 1)
    ps_c = tcnf.params_from_numpy(_np_params(NARROW, 33))
    ps_p = tcnf.params_from_numpy(_np_params((3, 8, 3), 34))
    xs, ys = _data(NARROW, 4, 35)
    for call in (lambda: tcnf.inference(cond, tcnf.Mode.TEST, xs, ps_c),
                 lambda: tcnf.loss(cond, tcnf.Mode.TRAIN, xs, ps_c),
                 lambda: tcnf.generate(cond, tcnf.Mode.TEST, ps_c, 4)):
        with pytest.raises(ValueError, match="requires ys"):
            call()
    for call in (lambda: tcnf.inference(plain, tcnf.Mode.TEST, xs, ps_p, ys=ys),
                 lambda: tcnf.loss(plain, tcnf.Mode.TRAIN, xs, ps_p, ys=ys),
                 lambda: tcnf.generate(plain, tcnf.Mode.TEST, ps_p, 4, ys=ys)):
        with pytest.raises(ValueError, match="got ys"):
            call()
    with pytest.raises(ValueError, match="rank"):
        tcnf.inference(cond, tcnf.Mode.TEST, xs, ps_c, ys=ys[None])
