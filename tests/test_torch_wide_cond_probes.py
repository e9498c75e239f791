"""Conditional K-probe and JVP training past the narrow widths in the port
against the JAX package on the CPU (K6 x K8: the probe COND instances of the
wide K1 and K2 chain forms): the conditional 2-layer net `MLP((35, 72, 34))`
on [z | ys] with one ys column and the conditional 3-layer chain
`MLP((10, 72, 72, 8))` with two, under `VecJacMode(K)` at K = 2 and 4 and
`JacVecMode(K)` at K = 1 and 2.  The twins through the fused solve on CPU
tensors against the JAX package's forward and adjoint kernels in interpret
mode at one tile (the adjoint with a_ys0 and layer 0's ys gradient rows);
TRAIN `inference` and the loss with the JAX probe and steering draws
injected; the gradients in the params and in ys against `jax.grad`; a K = 2
`fit` of `CondICNFModel`.

Inputs come from numpy seeds at B = 16, where the JAX package runs one tile
(its VMEM estimates are asserted within budget, so it runs its kernels in
interpret mode); the JAX probe and steering draws are reproduced from its key
split (`core/icnf.py:485`) and handed to the port.  Tolerances: values at
rtol = atol = 1e-4 (float32 sums in another order), gradients at rtol 1e-4,
atol 1e-5; a tie of the last step held by `_hold_steps` (the JAX package's
unfused path, or the twin's own roundoff witness, taking the other count)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import continuousnf_tpu as cnf
import continuousnf_tpu_torch as tcnf
from continuousnf_tpu.ode.tableaus import TSIT5 as JTSIT5
from continuousnf_tpu.ops import fused_solve as jfs
from continuousnf_tpu_torch.ode.tableaus import TSIT5
from continuousnf_tpu_torch.ops import fused_solve as tfs
from continuousnf_tpu_torch.utils import near_tie
from continuousnf_tpu_torch.utils.configs import glorot_params

# The port's entry points default to the CUDA card; these tests run it on the CPU.
tcnf.set_default_device("cpu")

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
TWO, THREE = (35, 72, 34), (10, 72, 72, 8)
# dims -> (nvars, naug, n_cond)
SPLIT = {TWO: (17, 17, 1), THREE: (4, 4, 2)}
NETS = {"two-layer": TWO, "three-layer": THREE}
# name -> (K, jvp)
PROBES = {"K2": (2, False), "K4": (4, False), "jvp-K1": (1, True), "jvp-K2": (2, True)}
CASES = [(net, probes) for net in NETS for probes in PROBES]
IDS = [f"{net}-{probes}" for net, probes in CASES]
B = 16


def _model(m, dims, k, jvp, fused=True, **kw):
    """CondRNODE on [z | ys] with hepmass42's recipe (steer_rate 0.1,
    lambda3 = 1e-2) under K VJP or JVP probes, tspan (0, 1) unless given."""
    kw = {"tspan": (0.0, 1.0), "steer_rate": 0.1, "lam3": 1e-2, **kw}
    nvars, naug, _ = SPLIT[dims]
    cm = (m.JacVecMode if jvp else m.VecJacMode)(k, fused=fused)
    return m.construct(m.CondRNODE, m.MLP(dims), nvars, naug, compute_mode=cm, **kw)


def _np_params(dims, seed):
    return glorot_params(np.random.default_rng(seed), dims)


def _data(dims, n, seed):
    """(xs (n, nvars), ys (n, n_cond)): x ~ N(0, 1) next to y ~ U(-1, 1)."""
    rng = np.random.default_rng(seed)
    nvars, _, nc = SPLIT[dims]
    return rng.normal(size=(n, nvars)).astype(np.float32), rng.uniform(-1.0, 1.0, (n, nc)).astype(np.float32)


def _jps(ps_np):
    return jax.tree.map(jnp.asarray, ps_np)


def _leaves(ps):
    return [p[k] for p in ps for k in ("w", "b")]


def _launch_counts():
    return {name: w.launches for name, w in tfs.KERNEL_WRAPPERS.items()}


def _jax_draws(icnf, key, batch):
    """The probes (K, batch, dz) and the steering r JAX `inference` draws
    from `key`."""
    eps_key, steer_key = jax.random.split(key)
    r = float(jax.random.uniform(steer_key, (), jnp.float32, -icnf.steer_rate, icnf.steer_rate))
    return np.array(icnf.draw_eps(eps_key, batch)), r


def _y0(dims, xs):
    z0 = np.concatenate([xs, np.zeros((xs.shape[0], dims[-1] - xs.shape[1]), np.float32)], axis=1)
    return np.concatenate([z0.ravel(), np.zeros(3 * xs.shape[0], np.float32)])


def _spy_forward(monkeypatch, calls):
    """Record (tab, spec, kw) of every call of the wide K1 chain form's COND
    wrapper, which still runs."""
    wrapped = tfs.run_wide_cond_train_solve_kernel
    monkeypatch.setattr(tfs, "run_wide_cond_train_solve_kernel",
                        lambda tab, spec, **kw: calls.append((tab, spec, kw)) or wrapped(tab, spec, **kw))


def _twin_witness(call):
    """The attempted step counts of the forward twin under one-ulp moves of
    its inputs (`near_tie.witness`: z0 alone, then every input) on the
    recorded call."""
    tab, spec, kw = call
    steps, _ = near_tie.witness(tfs.solve_train_plain, tab, spec, kw, "z0")
    return steps


def _hold_steps(st, st_r, unfused_steps, witness_steps):
    """Equal attempted and accepted steps and NFE or, at a tie of the last
    step (one solve reaches t1, the other stops short and takes the
    remainder: one attempted and one accepted step more), the JAX package's
    own unfused path on the same inputs taking the port's count
    (`unfused_steps()`) or the port's twin taking the JAX kernel's count
    under one-ulp moves of its inputs (`witness_steps()`: the count is
    roundoff's)."""
    if int(st.steps) != int(st_r.steps):
        assert abs(int(st.steps) - int(st_r.steps)) == 1 and abs(int(st.accepted) - int(st_r.accepted)) == 1
        assert unfused_steps() == int(st.steps) or int(st_r.steps) in witness_steps()
    else:
        assert (int(st.accepted), int(st.nfe)) == (int(st_r.accepted), int(st_r.nfe))


def _assert_jax_kernels_run(dims, k):
    """The JAX package's VMEM estimates with k probes stay within budget at
    B, so its fused solve runs its kernels (in interpret mode on the CPU)."""
    jspec = jfs.chain_spec(cnf.MLP(dims), dims[-1])
    assert jspec.n_cond == SPLIT[dims][2]
    assert jfs._vmem_estimate_forward(JTSIT5, jspec, B, 3, k, False) <= jfs._VMEM_BUDGET_BYTES
    assert jfs._vmem_estimate_adjoint(JTSIT5, jspec, B, 3, k, False) <= jfs._VMEM_BUDGET_BYTES // 2


def _covered(dims, k, jvp):
    """The card runs the configuration in the probe COND instances."""
    spec = tfs.chain_spec(tcnf.MLP(dims), dims[-1])
    assert spec.n_cond and tfs._wide_chain(spec) and not tfs._stream_chain(spec, True)
    assert tfs._kernel_covers(TSIT5, spec, k, chain=True, jvp=jvp) is None
    assert k != 1 or jvp


@pytest.mark.parametrize("net,probes", CASES, ids=IDS)
def test_wide_cond_probe_forward_twin_matches_jax_kernel(monkeypatch, net, probes):
    """The plain version of the wide K1 chain form's probe COND instance,
    through the fused solve on CPU tensors, against the JAX package's
    forward kernel with ys rows and K probe planes in interpret mode from
    zero accumulators: equal attempted and accepted steps and NFE or a
    last-step tie (`_hold_steps`); values at 1e-4.  No kernel is launched."""
    dims, (k, jvp) = NETS[net], PROBES[probes]
    _covered(dims, k, jvp)
    _assert_jax_kernels_run(dims, k)
    ps_np = _np_params(dims, 51)
    xs, ys = _data(dims, B, 52)
    eps = np.random.default_rng(53).normal(size=(k, B, dims[-1])).astype(np.float32)
    y0f = _y0(dims, xs)
    jfull = jfs.make_full_solve(_model(cnf, dims, k, jvp), cnf.Mode.TRAIN, B)
    yT_r, st_r = jfull.forward(jnp.asarray(y0f), 0.0, 1.0,
                               {"ps": _jps(ps_np), "eps": jnp.asarray(eps), "ys": jnp.asarray(ys)})
    twin_calls = []
    _spy_forward(monkeypatch, twin_calls)
    tfull = tfs.make_full_solve(_model(tcnf, dims, k, jvp), tcnf.Mode.TRAIN, B)
    before = _launch_counts()
    with torch.no_grad():
        yT, st = tfull.forward(torch.from_numpy(y0f), torch.tensor(0.0), torch.tensor(1.0),
                               {"ps": tcnf.params_from_numpy(ps_np), "eps": torch.from_numpy(eps),
                                "ys": torch.from_numpy(ys)})
    assert _launch_counts() == before

    def unfused_steps():
        icnf = _model(cnf, dims, k, jvp, fused=False, steer_rate=0.0)
        _, _, st_u = cnf.inference(icnf, cnf.Mode.TRAIN, jnp.asarray(xs), _jps(ps_np), ys=jnp.asarray(ys),
                                   eps=jnp.asarray(eps), key=jax.random.PRNGKey(0))
        return int(st_u.steps)

    assert len(twin_calls) == 1
    _hold_steps(st, st_r, unfused_steps, lambda: _twin_witness(twin_calls[0]))
    np.testing.assert_allclose(yT.numpy(), np.asarray(yT_r), **TOL)


@pytest.mark.parametrize("net,probes", CASES, ids=IDS)
def test_wide_cond_probe_adjoint_twin_matches_jax_kernel(net, probes):
    """The plain version of the wide K2 chain form's probe COND instance,
    through the fused solve's backward member on CPU tensors, against the
    JAX package's adjoint kernel in interpret mode at one tile, from the
    same final state, cotangent and warm start: equal steps, accepted steps
    and NFE; the states, a_ys0 and the gradients at 1e-4, layer 0's ys rows
    of g_W among them, which are not zero, and a_ys0 moves with K and the
    direction (the probes' -2 h gate terms reach ca); the probes get no
    cotangent.  No kernel is launched."""
    dims, (k, jvp) = NETS[net], PROBES[probes]
    dz, span = dims[-1], 2.0
    _assert_jax_kernels_run(dims, k)
    ps_np = _np_params(dims, 54)
    xs, ys = _data(dims, B, 55)
    eps = np.random.default_rng(56).normal(size=(k, B, dz)).astype(np.float32)
    jfull = jfs.make_full_solve(_model(cnf, dims, k, jvp, tspan=(0.0, span)), cnf.Mode.TRAIN, B)
    assert jfull.adjoint is not None
    args = {"ps": _jps(ps_np), "eps": jnp.asarray(eps), "ys": jnp.asarray(ys)}
    yTf, fst = jfull.forward(jnp.asarray(_y0(dims, xs)), 0.0, span, args)
    rng = np.random.default_rng(57)
    g_yf = np.concatenate([rng.normal(0.0, 0.1, B * dz), np.full(B, 1.0 / B), np.full(2 * B, 1e-2 / B)])
    g_yf = g_yf.astype(np.float32)
    dt_warm = float(fst.dt_last)
    y0_r, ay0_r, gargs_r, st_r = jfull.adjoint(yTf, jnp.asarray(g_yf), args, span, 0.0, dt_warm=dt_warm)
    tfull = tfs.make_full_solve(_model(tcnf, dims, k, jvp, tspan=(0.0, span)), tcnf.Mode.TRAIN, B)
    targs = {"ps": tcnf.params_from_numpy(ps_np), "eps": torch.from_numpy(eps), "ys": torch.from_numpy(ys)}
    before = _launch_counts()
    y0, ay0, gargs, st = tfull.adjoint(torch.from_numpy(np.array(yTf)), torch.from_numpy(g_yf), targs,
                                       torch.tensor(span), torch.tensor(0.0), dt_warm=dt_warm)
    assert _launch_counts() == before
    assert (int(st.steps), int(st.accepted), int(st.nfe)) == (int(st_r.steps), int(st_r.accepted), int(st_r.nfe))
    np.testing.assert_allclose(y0.numpy(), np.asarray(y0_r), **TOL)
    np.testing.assert_allclose(ay0.numpy(), np.asarray(ay0_r), **TOL)
    assert gargs["ys"].shape == ys.shape
    np.testing.assert_allclose(gargs["ys"].numpy(), np.asarray(gargs_r["ys"]), **TOL)
    for a, b in zip(_leaves(gargs["ps"]), _leaves(gargs_r["ps"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert float(gargs["ps"][0]["w"][dz:].abs().max()) > 0.0
    assert torch.equal(gargs["eps"], torch.zeros_like(targs["eps"]))

    # a_ys0 depends on the probes: one VJP probe (the COND instance's twin)
    # on the first probe plane gives another one.
    one = dict(targs, eps=targs["eps"][:1])
    tone = tfs.make_full_solve(_model(tcnf, dims, 1, False, tspan=(0.0, span)), tcnf.Mode.TRAIN, B)
    _, _, gargs_1, _ = tone.adjoint(torch.from_numpy(np.array(yTf)), torch.from_numpy(g_yf), one,
                                    torch.tensor(span), torch.tensor(0.0), dt_warm=dt_warm)
    assert float((gargs_1["ys"] - gargs["ys"]).abs().max()) > 1e-6


@pytest.mark.parametrize("net,probes", CASES, ids=IDS)
def test_wide_cond_probe_inference_and_gradients_match_jax(monkeypatch, net, probes):
    """TRAIN `inference` with per-sample ys (the JAX probe and steering
    draws handed over) against the JAX package's fused path (its kernels in
    interpret mode): equal steps or a last-step tie (`_hold_steps`), values
    at 1e-4; then the loss and its gradients in the params and in ys
    (B, n_cond) through the fused BACKSOLVE against `jax.grad` of the JAX
    package's fused loss, the solves through the COND wrappers with all K
    probe planes and the direction, a_ys0 summed back to ys's shape."""
    dims, (k, jvp) = NETS[net], PROBES[probes]
    twin_calls, calls = [], []
    _spy_forward(monkeypatch, twin_calls)
    for name in ("run_wide_cond_train_solve_kernel", "run_wide_cond_adjoint_kernel"):
        wrapped = getattr(tfs, name)
        monkeypatch.setattr(tfs, name, lambda *a, _n=name, _f=wrapped, **kw: calls.append(
            (_n, tuple(kw["eps"].shape), kw["jvp"], kw["ys"] is not None)) or _f(*a, **kw))
    jicnf, ticnf = _model(cnf, dims, k, jvp), _model(tcnf, dims, k, jvp)
    ps_np = _np_params(dims, 58)
    xs, ys = _data(dims, B, 59)
    key = jax.random.PRNGKey(60)
    lp_r, regs_r, st_r = cnf.inference(jicnf, cnf.Mode.TRAIN, jnp.asarray(xs), _jps(ps_np), ys=jnp.asarray(ys),
                                       key=key)
    eps, r = _jax_draws(jicnf, key, B)
    assert eps.shape == (k, B, dims[-1])
    before = _launch_counts()
    with torch.no_grad():
        lp, regs, st = tcnf.inference(ticnf, tcnf.Mode.TRAIN, xs, tcnf.params_from_numpy(ps_np), ys=ys, eps=eps,
                                      steer_r=r)

    def unfused_steps():
        _, _, st_u = cnf.inference(_model(cnf, dims, k, jvp, fused=False), cnf.Mode.TRAIN, jnp.asarray(xs),
                                   _jps(ps_np), ys=jnp.asarray(ys), key=key)
        return int(st_u.steps)

    _hold_steps(st, st_r, unfused_steps, lambda: _twin_witness(twin_calls[0]))
    for a, b in ((lp, lp_r), (regs.e, regs_r.e), (regs.n, regs_r.n)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)

    l_r, (g_r, gy_r) = jax.value_and_grad(
        lambda p, y: cnf.loss(jicnf, cnf.Mode.TRAIN, jnp.asarray(xs), p, ys=y, key=key), argnums=(0, 1)
    )(_jps(ps_np), jnp.asarray(ys))
    ps = tcnf.params_from_numpy(ps_np)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    ys_t = torch.from_numpy(ys).requires_grad_()
    l = tcnf.loss(ticnf, tcnf.Mode.TRAIN, xs, ps, ys=ys_t, eps=eps, steer_r=r)
    g = torch.autograd.grad(l, leaves + [ys_t])
    assert _launch_counts() == before
    fwd = ("run_wide_cond_train_solve_kernel", (k, B, dims[-1]), jvp, True)
    assert calls == [fwd, fwd, ("run_wide_cond_adjoint_kernel",) + fwd[1:]]
    np.testing.assert_allclose(float(l.detach()), float(l_r), **GRAD_TOL)
    for a, b in zip(g, _leaves(g_r) + [gy_r]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


def test_wide_cond_probe_fit_on_cpu():
    """`fit(CondICNFModel(...), X, Y)` with two VJP probes on the
    conditional 2-layer net for two Lion steps at B = 16: finite losses,
    moving parameters, and no kernel launched on the CPU."""
    ps_np = _np_params(TWO, 61)
    X, Y = _data(TWO, 2 * B, 62)
    before = _launch_counts()
    model = tcnf.CondICNFModel(_model(tcnf, TWO, 2, False), n_epochs=1, batch_size=B)
    res = tcnf.fit(model, X, Y, ps=tcnf.params_from_numpy(ps_np), seed=0)
    assert _launch_counts() == before
    assert res.epochs == 1 and len(res.losses) >= 1 and np.isfinite(res.losses).all()
    moved = [float((a - torch.from_numpy(b)).abs().max()) for a, b in zip(_leaves(res.ps), _leaves(ps_np))]
    assert min(moved) > 0.0
