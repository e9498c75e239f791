"""Conditional 2-layer nets within state width 32 in the port against the JAX
package on the CPU (K8 in the 2-layer kernels): the COND instances of K3 (the
TEST forward), the K4 forward and the K4 adjoint (exact training), which run
the JAX package's closed-form stages with `_zin` (`_stage_test`,
`_stage_train_exact` and its fwdbwd), beside K5's COND instance (the TEST
backward) and the K1 and K2 chain forms' COND and probe COND instances
(Hutchinson training: the JAX package runs one `_stage_train` for every
depth).  Nets: `MLP((4, 16, 2))` with two ys columns, `MLP((9, 24, 8))` with
one, and `MLP((10, 72, 8))` with two (a hidden width past the narrow chain
kernels', whose Hutchinson stages run the wide chain forms' COND instances);
the configuration cond_flagship (the README net in conditional form,
`MLP((17, 48, 16))`).

What is held: the fused solve's choice of wrappers in TEST, Hutchinson TRAIN
(one probe, K = 2, JVP) and exact TRAIN, no kernel launched on the CPU; the
COND twins through the fused solve against the JAX package's kernels in
interpret mode at one tile (the TEST and exact forwards, the exact adjoint
with a_ys0 after the pm chaining); TEST and exact `inference`, fused and
plain, against the JAX package's fused (interpret) and unfused paths; the
TEST and exact losses' gradients in the params and ys against `jax.grad`;
the COND wrappers' CPU branch and, over stand-in libraries, their CUDA
branch's arguments (the K4 adjoint's pm chaining into W1's z rows, a_ys0
last); the coverage rule and refusals; cond_flagship against the JAX
package at B = 8.

Inputs come from numpy seeds at B = 16 (the JAX package's VMEM estimates
are asserted within budget, so it runs its kernels); the JAX steering draws
are reproduced from its key split (`core/icnf.py:485`) and handed to the
port.  Tolerances: values at rtol = atol = 1e-4 (float32 sums in another
order), gradients at rtol 1e-4, atol 1e-5."""

import ctypes
import types

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
from continuousnf_tpu_torch.utils.configs import MODELS, glorot_params, make_icnf, model_data

# The port's entry points default to the CUDA card; these tests run it on the CPU.
tcnf.set_default_device("cpu")

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
TWO, EIGHT, HIDDEN72 = (4, 16, 2), (9, 24, 8), (10, 72, 8)
# dims -> (nvars, naug, n_cond)
SPLIT = {TWO: (2, 0, 2), EIGHT: (4, 4, 1), HIDDEN72: (4, 4, 2)}
NETS = {"ncond2": TWO, "dz8": EIGHT}
B = 16
MODE_NAMES = {"test": "TEST", "train": "TRAIN", "exact": "TRAIN"}
COND_WRAPPERS = ("run_cond_solve_kernel", "run_cond_exact_solve_kernel", "run_cond_exact_adjoint_kernel")


def _model(m, dims, mode, fused=True, k=1, jvp=False, **kw):
    """CondRNODE on [z | ys] with the flagship recipe (steer_rate 0.1,
    lambda3 = 1e-2), tspan (0, 1) unless given."""
    kw = {"tspan": (0.0, 1.0), "steer_rate": 0.1, "lam3": 1e-2, **kw}
    nvars, naug, _ = SPLIT[dims]
    cm = (m.JacVecMode if jvp else m.VecJacMode)(num_probes=k, fused=fused, exact_trace=mode == "exact")
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


def _y0(dims, xs, nacc):
    z0 = np.concatenate([xs, np.zeros((xs.shape[0], dims[-1] - xs.shape[1]), np.float32)], axis=1)
    return np.concatenate([z0.ravel(), np.zeros(nacc * xs.shape[0], np.float32)])


def _steer_r(icnf, key):
    """The steering r JAX TRAIN `inference` draws from `key` (no probes
    under exact trace)."""
    _, steer_key = jax.random.split(key)
    return float(jax.random.uniform(steer_key, (), jnp.float32, -icnf.steer_rate, icnf.steer_rate))


def _assert_jax_kernels_run(dims, mode, adjoint=False):
    """The JAX package's VMEM estimates stay within budget at B, so its
    fused solve runs its kernels (in interpret mode on the CPU)."""
    jspec = jfs.chain_spec(cnf.MLP(dims), dims[-1])
    nacc, exact = (3, True) if mode == "exact" else (1, False)
    assert jfs._vmem_estimate_forward(JTSIT5, jspec, B, nacc, 1, exact) <= jfs._VMEM_BUDGET_BYTES
    if adjoint:
        assert jfs._vmem_estimate_adjoint(JTSIT5, jspec, B, nacc, 1, exact) <= jfs._VMEM_BUDGET_BYTES // 2


# ---- routing ----

_CHAIN_TRAIN = ["run_chain_train_solve_kernel", "run_chain_adjoint_kernel"]
# case -> (dims, mode, probes K, JVP, the wrappers the loss and its gradient call, in order)
_ROUTES = {
    "test": (TWO, "test", 1, False, ["run_cond_solve_kernel", "run_test_adjoint_kernel"]),
    "train-one-probe": (TWO, "train", 1, False, _CHAIN_TRAIN),
    "train-two-probes": (TWO, "train", 2, False, _CHAIN_TRAIN),
    "train-jvp": (TWO, "train", 1, True, _CHAIN_TRAIN),
    "exact": (TWO, "exact", 1, False, ["run_cond_exact_solve_kernel", "run_cond_exact_adjoint_kernel"]),
    "hidden72-test": (HIDDEN72, "test", 1, False, ["run_cond_solve_kernel", "run_test_adjoint_kernel"]),
    "hidden72-train": (HIDDEN72, "train", 1, False, ["run_wide_cond_train_solve_kernel",
                                                      "run_wide_cond_adjoint_kernel"]),
    "hidden72-exact": (HIDDEN72, "exact", 1, False, ["run_cond_exact_solve_kernel",
                                                      "run_cond_exact_adjoint_kernel"]),
}
_SPIED = {n for v in _ROUTES.values() for n in v[4]} | {
    "run_solve_kernel", "run_exact_solve_kernel", "run_exact_adjoint_kernel", "run_train_solve_kernel",
    "run_adjoint_kernel", "run_chain_test_solve_kernel", "run_chain_exact_solve_kernel",
    "run_wide_cond_test_solve_kernel", "run_wide_cond_exact_solve_kernel", "run_wide_cond_exact_adjoint_kernel"}


@pytest.mark.parametrize("route", list(_ROUTES))
def test_fused_solve_takes_the_two_layer_cond_instances(monkeypatch, route):
    """`make_full_solve` runs a conditional 2-layer tanh net within state
    width 32 through the COND instances of the 2-layer kernels where the
    JAX package runs its closed-form stages with `_zin`: K3's forward and
    K5's backward in TEST mode, the K4 forward's and the K4 adjoint's under
    exact trace, whatever the hidden width; under Hutchinson TRAIN (one
    probe, K = 2, JVP) the K1 and K2 chain forms' COND and probe COND
    instances (the wide ones past hidden width 64), each handed ys and every
    probe plane.  No other wrapper is called, and on the CPU no kernel is
    launched."""
    dims, mode, k, jvp, want = _ROUTES[route]
    called = []
    for name in _SPIED:
        wrapped = getattr(tfs, name)

        def spy(*a, _n=name, _f=wrapped, **kw):
            called.append((_n, kw.get("ys") is not None, tuple(kw["eps"].shape) if kw.get("eps") is not None else None))
            return _f(*a, **kw)

        monkeypatch.setattr(tfs, name, spy)
    icnf = _model(tcnf, dims, mode, k=k, jvp=jvp)
    ps = tcnf.params_from_numpy(_np_params(dims, 1))
    xs, ys = _data(dims, 8, 2)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    eps = np.random.default_rng(3).normal(size=(k, 8, dims[-1])).astype(np.float32)
    extra = {"eps": eps} if mode == "train" else {}
    before = _launch_counts()
    torch.autograd.grad(tcnf.loss(icnf, getattr(tcnf.Mode, MODE_NAMES[mode]), xs, ps, ys=ys, **extra), leaves)
    assert _launch_counts() == before
    assert [c[0] for c in called] == want
    assert all(c[1] for c in called)
    if mode == "train":
        assert [c[2] for c in called] == [(k, 8, dims[-1])] * 2


def test_bf16_keeps_refusing_conditional_nets():
    """Under bf16 stage matmuls a conditional 2-layer net's TEST solve runs
    the bf16 K3 wrapper, whose twin takes it on the CPU and whose check
    refuses it on the card, naming ROADMAP's bf16 row; exact trace under
    bf16 raises on both devices."""
    calls = []
    wrapped = tfs.run_bf16_solve_kernel
    icnf = tcnf.construct(tcnf.CondRNODE, tcnf.MLP(TWO), 2, 0, compute_mode=tcnf.VecJacMode(fused=True, bf16=True))
    spec = tfs.chain_spec(icnf.nn, 2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfs, "run_bf16_solve_kernel", lambda *a, **kw: calls.append(kw) or wrapped(*a, **kw))
        xs, ys = _data(TWO, 8, 4)
        with torch.no_grad():
            tcnf.inference(icnf, tcnf.Mode.TEST, xs, tcnf.params_from_numpy(_np_params(TWO, 5)), ys=ys)
    assert len(calls) == 1 and calls[0]["ys"] is not None
    with pytest.raises(NotImplementedError, match="bf16 stage dots"):
        tfs._cuda_only_bf16("bf16 K3", _fake_cuda(), TSIT5, spec)
    exact = tcnf.construct(tcnf.CondRNODE, tcnf.MLP(TWO), 2, 0,
                           compute_mode=tcnf.VecJacMode(fused=True, bf16=True, exact_trace=True))
    with pytest.raises(NotImplementedError, match="bf16 stage dots"):
        tfs.make_full_solve(exact, tcnf.Mode.TRAIN, 8)


# ---- inference and gradients ----


def _ids(cases):
    return [f"{n}-{m}-{'fused' if f else 'plain'}" for n, m, f in cases]


# (net, mode, fused) of `inference`: the fused path in both modes and the
# plain path in TEST mode on one net (the other net's exact forward, and the
# plain exact forward, run in the gradients below).
_PATHS = [("ncond2", "test", True), ("ncond2", "exact", True), ("ncond2", "test", False)]


@pytest.mark.parametrize("net,mode,fused", _PATHS, ids=_ids(_PATHS))
def test_cond_two_layer_inference_matches_jax(net, mode, fused):
    """TEST and exact `inference` with per-sample ys (the JAX steering draw
    handed over), the port's fused path (the COND twins) and its plain path,
    against the JAX package's path of the same kind (its kernels in
    interpret mode, or its unfused solve): equal steps, logp and the
    regularisers at 1e-4."""
    dims = NETS[net]
    mode_name = MODE_NAMES[mode]
    jicnf, ticnf = _model(cnf, dims, mode, fused=fused), _model(tcnf, dims, mode, fused=fused)
    ps_np = _np_params(dims, 16)
    xs, ys = _data(dims, B, 17)
    key = jax.random.PRNGKey(18)
    lp_r, regs_r, st_r = cnf.inference(jicnf, getattr(cnf.Mode, mode_name), jnp.asarray(xs), _jps(ps_np),
                                       ys=jnp.asarray(ys), key=key)
    extra = {"steer_r": _steer_r(jicnf, key)} if mode == "exact" else {}
    with torch.no_grad():
        lp, regs, st = tcnf.inference(ticnf, getattr(tcnf.Mode, mode_name), xs, tcnf.params_from_numpy(ps_np),
                                      ys=ys, **extra)
    assert (int(st.steps), int(st.accepted)) == (int(st_r.steps), int(st_r.accepted))
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_r), **TOL)
    if mode == "exact":
        for a, b in ((regs.e, regs_r.e), (regs.n, regs_r.n)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# The gradients: the fused path in TEST mode on one net and under exact trace
# on the other (the exact adjoint's twin at two ys columns is held to the JAX
# kernel by tests/test_torch_cond.py), the plain path under exact trace.
_GRADS = [("ncond2", "test", True), ("dz8", "exact", True), ("ncond2", "exact", False)]


@pytest.mark.parametrize("net,mode,fused", _GRADS, ids=_ids(_GRADS))
def test_cond_two_layer_gradients_match_jax_grad(net, mode, fused):
    """The TEST loss (the exact-trace maximum likelihood) and the exact TRAIN
    loss and their gradients in the params and in ys (B, n_cond), through
    the port's fused solve (the COND twins of K3 and K5, of the K4 forward
    and the K4 adjoint; a_ys0 summed back to ys's shape) and through its
    plain BACKSOLVE, against `jax.grad` of the JAX package's loss of the
    same kind (its kernels in interpret mode, or its unfused path)."""
    dims = NETS[net]
    mode_name = MODE_NAMES[mode]
    jicnf, ticnf = _model(cnf, dims, mode, fused=fused), _model(tcnf, dims, mode, fused=fused)
    ps_np = _np_params(dims, 19)
    xs, ys = _data(dims, B, 20)
    key = jax.random.PRNGKey(21)
    kw = {"key": key} if mode == "exact" else {}
    l_r, (g_r, gy_r) = jax.value_and_grad(
        lambda p, y: cnf.loss(jicnf, getattr(cnf.Mode, mode_name), jnp.asarray(xs), p, ys=y, **kw), argnums=(0, 1)
    )(_jps(ps_np), jnp.asarray(ys))
    ps = tcnf.params_from_numpy(ps_np)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    ys_t = torch.from_numpy(ys).requires_grad_()
    extra = {"steer_r": _steer_r(jicnf, key)} if mode == "exact" else {}
    before = _launch_counts()
    l = tcnf.loss(ticnf, getattr(tcnf.Mode, mode_name), xs, ps, ys=ys_t, **extra)
    g = torch.autograd.grad(l, leaves + [ys_t])
    assert _launch_counts() == before
    np.testing.assert_allclose(float(l.detach()), float(l_r), **GRAD_TOL)
    for a, b in zip(g, _leaves(g_r) + [gy_r]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


def test_cond_flagship_config_matches_jax():
    """cond_flagship (utils/configs.py: CondRNODE, MLP 17 -> 48 -> 16 on
    [z | ys], the flagship recipe over tspan (0, 13), cond_refbench16's data)
    builds, under exact trace too, and its plain path at B = 8 matches the
    JAX package's unfused path on the same net: TEST `inference`, equal
    steps and logp at 1e-4."""
    cfg = MODELS["cond_flagship"]
    assert cfg["dims"] == (17, 48, 16) and cfg["n_cond"] == 1 and cfg["tspan"] == (0.0, 13.0)
    n = 8
    rng = np.random.default_rng(22)
    ps_np = glorot_params(rng, cfg["dims"])
    xs, ys = model_data("cond_flagship", rng, n)
    assert xs.shape == (n, 8) and ys.shape == (n, 1)
    ticnf, tex = make_icnf("cond_flagship", "cpu", fused=False), make_icnf("cond_flagship", "cpu", fused=False,
                                                                            exact=True)
    assert ticnf.steer_rate == 0.1 and ticnf.lam3 == 1e-2 and tex.compute_mode.exact_trace
    spec = tfs.chain_spec(ticnf.nn, ticnf.zdim)
    assert spec.n_cond == 1 and tfs._kernel_covers(TSIT5, spec, cond=True) is None and not tfs._wide_two_layer(spec)

    jicnf = cnf.construct(cnf.CondRNODE, cnf.MLP(cfg["dims"]), 8, 8, tspan=cfg["tspan"], **cfg["extra"],
                          compute_mode=cnf.VecJacMode(fused=False))
    lp_r, _, st_r = cnf.inference(jicnf, cnf.Mode.TEST, jnp.asarray(xs), _jps(ps_np), ys=jnp.asarray(ys))
    ps = tcnf.params_from_numpy(ps_np)
    with torch.no_grad():
        lp, _, st = tcnf.inference(ticnf, tcnf.Mode.TEST, xs, ps, ys=ys)
    assert int(st.steps) == int(st_r.steps)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_r), **TOL)


# ---- the wrappers ----


def test_cond_wrappers_run_the_twins_on_the_cpu_without_counting():
    """On CPU tensors the three COND wrappers run their twins, bit for bit
    (a_ys0 last from the K4 adjoint's), and count no launch; they are in
    KERNEL_WRAPPERS, under the 2-layer kernels' names with "/cond"."""
    assert {getattr(tfs, n) for n in COND_WRAPPERS} == {
        tfs.KERNEL_WRAPPERS[k + "/cond"] for k in (tfs.K3_KERNEL, tfs.K4_KERNEL, tfs.K4A_KERNEL)}
    dims = EIGHT
    spec = tfs.chain_spec(tcnf.MLP(dims), 8)
    ps = tcnf.params_from_numpy(_np_params(dims, 24))
    rng = np.random.default_rng(25)
    T = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    ys = T(rng.uniform(-1.0, 1.0, (8, 1)))
    base = dict(rtol=1e-3, atol=1e-6, max_steps=100, ws=[p["w"] for p in ps], bs=[p["b"] for p in ps], ys=ys)
    before = _launch_counts()
    fwd_kw = dict(base, z0=T(rng.normal(size=(8, 8))), t0=torch.tensor(0.0), t1=torch.tensor(1.0),
                  dt_init=torch.tensor(0.05))
    kw = dict(fwd_kw, dlogp0=T(rng.normal(size=8)))
    assert all(torch.equal(a, b) for a, b in zip(tfs.run_cond_solve_kernel(TSIT5, spec, **kw),
                                                 tfs.solve_test_plain(TSIT5, spec, **kw)))
    exact = dict(fwd_kw, norm_z=True, norm_j=True, acc0=T(rng.normal(size=(3, 8))))
    fwd_e = tfs.solve_train_exact_plain(TSIT5, spec, **exact)
    assert all(torch.equal(a, b) for a, b in zip(tfs.run_cond_exact_solve_kernel(TSIT5, spec, **exact), fwd_e))
    adj = dict(base, norm_z=True, norm_j=True, zT=fwd_e[0], accT=fwd_e[1], azT=T(rng.normal(size=(8, 8))),
               aaccT=T(rng.normal(size=(3, 8))), t_hi=torch.tensor(1.0), t_lo=torch.tensor(0.0),
               dt_init=torch.tensor(-0.05))
    got, ref = tfs.run_cond_exact_adjoint_kernel(TSIT5, spec, **adj), tfs.adjoint_train_exact_plain(TSIT5, spec, **adj)
    assert len(got) == len(ref) == 8
    assert all(torch.equal(a, b) for a, b in zip(got[:3] + got[5:], ref[:3] + ref[5:]))
    assert all(torch.equal(a, b) for a, b in zip(got[3] + got[4], ref[3] + ref[4]))
    assert _launch_counts() == before


class _StandInK4:
    """A stand-in for the K4 adjoint's library: its COND entry writes the
    twin's unchained outputs (z0, acc0, a_z0, a_ys0, the parameter
    gradients with W1's ys rows, g_pm and the steps) where the kernel
    writes them."""

    def __init__(self, out):
        self.out, self.calls = out, []

    def cnf_k4ac_max_grid(self, dz, H, nc, block, cap):
        self.calls.append(("grid", dz, H, nc, block))
        cap._obj.value = 4
        return 0

    def cnf_k4_cond_adjoint(self, *a):
        self.calls.append(("adjoint", len(a), a[28]))
        # z0, acc0, az0, ays0, gw1, gb1, gw2, gb2, gpm, stats
        for i, x in zip((10, 11, 12, 13, 14, 15, 16, 17, 18, 19), self.out):
            ctypes.memmove(a[i].value, x.data_ptr(), x.numel() * x.element_size())
        return 0


def test_k4_cond_wrapper_chains_pm_into_the_z_rows(monkeypatch):
    """The K4 adjoint's CUDA branch with ys (`_launch_k4_adjoint`), here over
    a stand-in library that writes the twin's unchained outputs: it asks the
    COND instance's grid and entry with n_cond, chains g_pm into W1's z rows
    (through W1's z rows) and W2, leaves W1's ys rows as the kernel gives
    them, and returns a_ys0 last: the twin's chained result, bit for bit in
    the steps and the ys rows, at 1e-6 elsewhere."""
    dims = EIGHT
    dz, H, nc = dims[-1], dims[1], SPLIT[dims][2]
    ps = tcnf.params_from_numpy(_np_params(dims, 26))
    spec = tfs.chain_spec(tcnf.MLP(dims), dz)
    rng = np.random.default_rng(27)
    T = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    ws, bs = [p["w"] for p in ps], [p["b"] for p in ps]
    ys = T(rng.uniform(-1.0, 1.0, (B, nc)))
    kw = dict(rtol=1e-3, atol=1e-6, max_steps=100, ws=ws, bs=bs, norm_z=True, norm_j=True,
              zT=T(rng.normal(size=(B, dz))), accT=T(rng.normal(size=(3, B))),
              azT=T(rng.normal(0.0, 0.1, (B, dz))), aaccT=T(rng.normal(0.0, 0.1, (3, B))),
              t_hi=torch.tensor(1.0), t_lo=torch.tensor(0.0), dt_init=torch.tensor(-0.05), ys=ys)
    ref = tfs.adjoint_train_exact_plain(TSIT5, spec, **kw)
    pm = tfs._exact_pm(spec, ws)
    stage = tfs._exact_adjoint_stage(spec, ws, bs, pm, True, True, kw["aaccT"], ys)
    plain = {k: kw[k] for k in ("rtol", "atol", "max_steps", "zT", "accT", "azT", "aaccT", "t_hi", "t_lo",
                                "dt_init")}
    z0, acc0, az0, blocks, steps, accepted = tfs._adjoint_plain(
        stage, tfs._block_shapes(ws, bs, ys, [pm.shape]), TSIT5, **plain)
    a_ys, w1, w2, b1, b2, g_pm = blocks
    stats = torch.tensor([int(steps), int(accepted)], dtype=torch.int32)
    lib = _StandInK4([z0, acc0, az0, a_ys.contiguous(), w1, b1, w2, b2, g_pm, stats])
    monkeypatch.setattr(tfs, "_library", lambda name: lib)
    monkeypatch.setattr(tfs, "_stream", lambda device: ctypes.c_void_p(0))
    got = tfs._launch_k4_adjoint(TSIT5, spec, **kw)
    assert lib.calls == [("grid", dz, H, nc, 128), ("adjoint", 41, nc)]
    assert len(got) == len(ref) == 8
    assert (int(got[5]), int(got[6])) == (int(ref[5]), int(ref[6]))
    assert torch.equal(got[3][0][dz:], ref[3][0][dz:]) and torch.equal(got[7], ref[7])
    for a, b in zip(got[:3] + tuple(got[3]) + tuple(got[4]), ref[:3] + tuple(ref[3]) + tuple(ref[4])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


class _StandInForward:
    """A stand-in for K3's or the K4 forward's library: the COND entries
    record their arguments and write the twin's outputs."""

    def __init__(self, out):
        self.out, self.calls = out, []

    def grid(self, dz, H, nc, block, cap):
        self.calls.append(("grid", dz, H, nc, block))
        cap._obj.value = 4
        return 0

    def entry(self, *a):
        self.calls.append(("entry", len(a), a[14:19]))
        for i, x in zip((8, 9, 10, 11), self.out):  # zT, accT, stats, dt_last
            ctypes.memmove(a[i].value, x.data_ptr(), x.numel() * x.element_size())
        return 0


@pytest.mark.parametrize("kernel", ["K3", "K4"])
def test_forward_cond_wrappers_pass_ys_and_n_cond(monkeypatch, kernel):
    """K3's and the K4 forward's CUDA branch with ys (`_launch_two_layer_forward`),
    over a stand-in library: w1 (dz + n_cond, H) accepted, the COND grid
    asked with n_cond, ys passed after b2 and n_cond after H (then
    max_steps and, for the K4 forward, the norms), and the twin's outputs
    returned."""
    dims = EIGHT
    dz, H, nc = dims[-1], dims[1], SPLIT[dims][2]
    ps = tcnf.params_from_numpy(_np_params(dims, 28))
    spec = tfs.chain_spec(tcnf.MLP(dims), dz)
    rng = np.random.default_rng(29)
    T = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    ys = T(rng.uniform(-1.0, 1.0, (B, nc)))
    kw = dict(rtol=1e-3, atol=1e-6, max_steps=77, ws=[p["w"] for p in ps], bs=[p["b"] for p in ps],
              z0=T(rng.normal(size=(B, dz))), t0=torch.tensor(0.0), t1=torch.tensor(1.0), dt_init=torch.tensor(0.05),
              ys=ys)
    if kernel == "K3":
        kw["acc0"] = T(rng.normal(size=B))
        twin = tfs.solve_test_plain(TSIT5, spec, **{("dlogp0" if k == "acc0" else k): v for k, v in kw.items()})
        names, norms = ("cnf_k3c_max_grid", "cnf_k3_cond_solve"), None
    else:
        kw["acc0"] = T(rng.normal(size=(3, B)))
        twin = tfs.solve_train_exact_plain(TSIT5, spec, norm_z=True, norm_j=False, **kw)
        names, norms = ("cnf_k4c_max_grid", "cnf_k4_cond_solve"), (True, False)
    stats = torch.tensor([int(twin[2]), int(twin[3])], dtype=torch.int32)
    lib = _StandInForward([twin[0], twin[1], stats, torch.stack([twin[4], twin[5]]).float()])
    monkeypatch.setattr(tfs, "_library", lambda name: types.SimpleNamespace(**{names[0]: lib.grid,
                                                                                names[1]: lib.entry}))
    monkeypatch.setattr(tfs, "_stream", lambda device: ctypes.c_void_p(0))
    monkeypatch.setattr(tfs, "_forward_blocks", lambda B, device: (128,))
    got = tfs._launch_two_layer_forward(kernel, None, names[1], names[0], TSIT5, spec, norms=norms, **kw)
    n_args = 14 + 5 + (2 if norms else 0) + 9
    assert lib.calls[0] == ("grid", dz, H, nc, 128)
    assert lib.calls[1] == ("entry", n_args, (B, dz, H, nc, 77))
    assert torch.equal(got[0], twin[0]) and torch.equal(got[1], twin[1])
    assert (int(got[2]), int(got[3])) == (int(twin[2]), int(twin[3]))


# ---- coverage ----


def _fake_cuda():
    """A stand-in for a CUDA tensor: the coverage checks read its device."""
    return types.SimpleNamespace(device=torch.device("cuda", 0))


# name -> (dims, n_cond, the label and keyword arguments of `_cuda_only`, the reason the refusal names or None)
_COVERAGE = {
    "K3-COND": ((17, 48, 16), 1, ("K3", dict(cond=True)), None),
    "K4-COND-dz32-hidden96": ((35, 96, 32), 3, ("K4", dict(cond=True)), None),
    "K5-COND": ((17, 48, 16), 1, ("K5", dict(cond=True)), None),
    "K1-conditional": ((17, 48, 16), 1, ("K1", {}), "the K1 and K2 chain forms"),
    "K2-conditional-two-probes": ((17, 48, 16), 1, ("K2", dict(k_probes=2)), "the K1 and K2 chain forms"),
    "K3-unconditional-instance": ((17, 48, 16), 1, ("K3", {}), "their COND instances take them"),
    "K4-COND-unconditional": ((16, 48, 16), 0, ("K4", dict(cond=True)), "COND instance"),
    "K3-COND-dz33": ((34, 48, 33), 1, ("K3", dict(cond=True)), "state width 33 > 32"),
    "K4-COND-three-layer": ((9, 16, 16, 8), 1, ("K4", dict(cond=True)), "K3, K1, K2 and K4 take 2 layers"),
}


@pytest.mark.parametrize("name", list(_COVERAGE))
def test_two_layer_cond_coverage(name):
    """The 2-layer kernels' rule with conditioning: K3, the K4 forward, the
    K4 adjoint and K5 take conditional 2-layer tanh nets of state width up
    to 32 in their COND instances (`cond`, the explicit argument of
    `_kernel_covers` and `_cuda_only`), to hidden width 96 and three ys
    columns among them; K1 and K2 refuse ys, naming the chain forms whose
    COND instances take the net, and the unconditional instances refuse it
    naming the COND instances; a COND instance refuses an unconditional
    net, and past state width 32 or 2 layers the COND instances refuse as
    the unconditional ones do."""
    dims, n_cond, (label, kw), why = _COVERAGE[name]
    spec = tfs.chain_spec(tcnf.MLP(dims), dims[-1])
    assert spec.n_cond == n_cond
    if why is None:
        assert tfs._kernel_covers(TSIT5, spec, cond=True) is None
        tfs._cuda_only(label, _fake_cuda(), TSIT5, spec, **kw)
        return
    with pytest.raises(NotImplementedError, match=why):
        tfs._cuda_only(label, _fake_cuda(), TSIT5, spec, **kw)


def test_cond_exact_fit_on_cpu():
    """`fit(CondICNFModel(...), X, Y)` under exact trace on a conditional
    2-layer net for two Lion steps at B = 16 (the COND twins of the K4
    forward and adjoint on the CPU): finite losses, moving parameters, and
    no kernel launched."""
    ps_np = _np_params(EIGHT, 30)
    X, Y = _data(EIGHT, 2 * B, 31)
    before = _launch_counts()
    model = tcnf.CondICNFModel(_model(tcnf, EIGHT, "exact"), n_epochs=1, batch_size=B)
    res = tcnf.fit(model, X, Y, ps=tcnf.params_from_numpy(ps_np), seed=0)
    assert _launch_counts() == before
    assert res.epochs == 1 and len(res.losses) >= 1 and np.isfinite(res.losses).all()
    moved = [float((a - torch.from_numpy(b)).abs().max()) for a, b in zip(_leaves(res.ps), _leaves(ps_np))]
    assert min(moved) > 0.0
