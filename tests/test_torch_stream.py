"""The port's streamed chain path against the JAX package on the CPU: chains
whose weights the wide forms do not keep in shared memory, which the chain
kernels' streamed forms (the streamed K1 and K2 chain forms, streamed K7
TEST and exact) take on the card.  Three nets: a 3-layer chain past hidden
width 128, `MLP((6, 160, 160, 6))`; a 4-layer chain within width 128 whose
weights overflow a block's shared memory, `MLP((64, 128, 128, 128, 64))`; a
2-layer net past hidden 128 and state width 32, `MLP((40, 160, 40))`; and
FFJORD's MINIBOONE model itself (miniboone860, `MLP((43, 860, 860, 43))`)
at B = 4.  Their plain versions, through the fused solve on CPU tensors,
against the JAX package's kernels in interpret mode (the forwards and the
Hutchinson adjoint); the fused solve's choice of wrappers; the coverage
rule and its refusals; `fit`; and the interval union of
`utils/profile_step.py`'s idle share.  TEST and TRAIN `inference` and the
losses' gradients of the same nets are in
tests/test_torch_stream_grads.py (the two files run on two workers).

Inputs come from numpy seeds; the JAX probe draws are reproduced from its
key split (`core/icnf.py:485`) and handed to the port."""

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
from continuousnf_tpu_torch.utils.configs import MODELS, glorot_params, model_data, tabular_data
from continuousnf_tpu_torch.utils.profile_step import interval_union

# The port's entry points default to the CUDA card; these tests run it on the CPU.
tcnf.set_default_device("cpu")

TOL = dict(rtol=1e-4, atol=1e-4)
NETS = {"hidden160": (6, 160, 160, 6), "four-layer": (64, 128, 128, 128, 64), "two-layer": (40, 160, 40)}
MB860 = MODELS["miniboone860"]["dims"]
B = 8
MODE_NAMES = {"train": "TRAIN", "test": "TEST", "exact": "TRAIN"}


def _cm(m, mode, fused=True):
    return m.ComputeMode(ad=m.ADMode.VJP, fused=fused, exact_trace=mode == "exact")


def _model(m, dims, mode="train", fused=True, **kw):
    """The tabular family of benchmarks/tabular.py:69 at these widths: RNODE,
    nvars = dims[0], no augmentation, tspan (0, 1), no steering."""
    return m.construct(m.RNODE, m.MLP(dims), dims[0], 0, compute_mode=_cm(m, mode, fused), **kw)


def _np_params(dims, seed):
    return glorot_params(np.random.default_rng(seed), dims)


def _data(dims, n, seed):
    return tabular_data(np.random.default_rng(seed), n, dims[0])


def _jps(ps_np):
    return jax.tree.map(jnp.asarray, ps_np)


def _leaves(ps):
    return [p[k] for p in ps for k in ("w", "b")]


def _launch_counts():
    return {name: w.launches for name, w in tfs.KERNEL_WRAPPERS.items()}


def _y0(xs, nacc):
    return np.concatenate([xs.ravel(), np.zeros(nacc * xs.shape[0], np.float32)])


_TWINS = {"train": "solve_train_plain", "test": "solve_test_plain", "exact": "solve_train_exact_plain"}
_STREAM_FORWARDS = {"train": "run_stream_train_solve_kernel", "test": "run_stream_test_solve_kernel",
                    "exact": "run_stream_exact_solve_kernel"}


def _spec(dims, n_cond=0, acts=None):
    n = len(dims) - 1
    ins = (dims[0] + n_cond,) + tuple(dims[1:-1])
    return tfs.ChainSpec(ins, tuple(dims[1:]), acts or (True,) * n, n_cond)


def test_miniboone860_configuration():
    """FFJORD's MINIBOONE widths in the repo's tabular family: 43 variables,
    no augmentation, MLP 43 -> 860 -> 860 -> 43 (hidden 20 x d), tspan
    (0, 1), batch 1024, miniboone43's data recipe; a chain the wide forms
    refuse (hidden 860 > 128) and the streamed forms take."""
    cfg = MODELS["miniboone860"]
    assert (cfg["dims"], cfg["nvars"], cfg["naug"], cfg["tspan"], cfg["batch"], cfg["extra"]) == (
        (43, 860, 860, 43), 43, 0, (0.0, 1.0), 1024, {})
    xs = model_data("miniboone860", np.random.default_rng(0), 64)
    np.testing.assert_array_equal(xs, model_data("miniboone43", np.random.default_rng(0), 64))
    spec = tfs.chain_spec(tcnf.MLP(MB860), 43)
    assert tfs._stream_chain(spec) and tfs._kernel_covers(TSIT5, spec, chain=True) is None
    assert "hidden width 860 > 128" in tfs._kernel_covers(TSIT5, spec, chain=True, stream=False)
    assert tfs._param_count(spec) == 815_323


@pytest.mark.parametrize("net", list(NETS))
@pytest.mark.parametrize("mode", ["train", "test", "exact"])
def test_stream_forward_twins_match_jax_kernel(monkeypatch, mode, net):
    """The plain versions of the streamed K1 chain form (train), streamed K7
    TEST (test; streamed K3 for the 2-layer net) and streamed K7 exact
    (exact), through the fused solve on CPU
    tensors, against the JAX package's forward kernel in interpret mode from
    zero accumulators: equal attempted and accepted steps (or, at a
    near-tie of the step controller, a step count the twin reaches under
    one-ulp moves of its inputs, `utils/near_tie.witness`), values at 1e-4.
    No kernel is launched."""
    dims = NETS[net]
    dz = dims[0]
    mode_name = MODE_NAMES[mode]
    ps_np = _np_params(dims, 1)
    xs = _data(dims, B, 2)
    nacc = 1 if mode == "test" else 3
    y0f = _y0(xs, nacc)
    eps = np.random.default_rng(3).normal(size=(1, B, dz)).astype(np.float32) if mode == "train" else None
    jfull = jfs.make_full_solve(_model(cnf, dims, mode), getattr(cnf.Mode, mode_name), B)
    jargs = {"ps": _jps(ps_np), "eps": None if eps is None else jnp.asarray(eps), "ys": None}
    yT_r, st_r = jfull.forward(jnp.asarray(y0f), 0.0, 1.0, jargs)
    calls = []
    name = "run_stream_test2_solve_kernel" if mode == "test" and len(dims) == 3 else _STREAM_FORWARDS[mode]
    wrapper = getattr(tfs, name)
    monkeypatch.setattr(tfs, name, lambda tab, spec, **kw: calls.append(kw) or wrapper(tab, spec, **kw))
    tfull = tfs.make_full_solve(_model(tcnf, dims, mode), getattr(tcnf.Mode, mode_name), B)
    targs = {"ps": tcnf.params_from_numpy(ps_np), "eps": None if eps is None else torch.from_numpy(eps), "ys": None}
    before = _launch_counts()
    with torch.no_grad():
        yT, st = tfull.forward(torch.from_numpy(y0f), torch.tensor(0.0), torch.tensor(1.0), targs)
    assert _launch_counts() == before and len(calls) == 1
    if int(st.steps) != int(st_r.steps):
        # A near-tie of the step controller (the twin sums in another
        # order): the twin's own solve reaches the JAX package's count under
        # one-ulp moves of its inputs.
        kw = {k: v for k, v in calls[0].items() if k != "ys"}
        steps, _ = near_tie.witness(getattr(tfs, _TWINS[mode]), TSIT5, _spec(dims), kw, "z0", n=8)
        assert int(st_r.steps) in steps
    else:
        assert (int(st.accepted), int(st.nfe)) == (int(st_r.accepted), int(st_r.nfe))
    np.testing.assert_allclose(yT.numpy(), np.asarray(yT_r), **TOL)


@pytest.mark.parametrize("net", list(NETS))
def test_stream_adjoint_twin_matches_jax_kernel(net):
    """The streamed K2 chain form's plain version against the JAX package's
    adjoint kernel in interpret mode (one tile at this batch), from the same
    final state, cotangent and warm start: equal steps, results at 1e-4."""
    dims = NETS[net]
    dz = dims[0]
    ps_np = _np_params(dims, 4)
    xs = _data(dims, B, 5)
    eps = np.random.default_rng(6).normal(size=(1, B, dz)).astype(np.float32)
    jfull = jfs.make_full_solve(_model(cnf, dims), cnf.Mode.TRAIN, B)
    args = {"ps": _jps(ps_np), "eps": jnp.asarray(eps), "ys": None}
    yTf, fst = jfull.forward(jnp.asarray(_y0(xs, 3)), 0.0, 1.0, args)
    rng = np.random.default_rng(7)
    g_yf = np.concatenate(
        [rng.normal(0.0, 0.1, B * dz), np.full(B, 1.0 / B), np.full(2 * B, 1e-2 / B)]
    ).astype(np.float32)
    dt_warm = float(fst.dt_last)
    y0_r, ay0_r, gargs_r, st_r = jfull.adjoint(yTf, jnp.asarray(g_yf), args, 1.0, 0.0, dt_warm=dt_warm)

    tfull = tfs.make_full_solve(_model(tcnf, dims), tcnf.Mode.TRAIN, B)
    targs = {"ps": tcnf.params_from_numpy(ps_np), "eps": torch.from_numpy(eps), "ys": None}
    before = _launch_counts()
    y0, ay0, gargs, st = tfull.adjoint(
        torch.from_numpy(np.array(yTf)), torch.from_numpy(g_yf), targs, torch.tensor(1.0), torch.tensor(0.0),
        dt_warm=dt_warm,
    )
    assert _launch_counts() == before
    assert (int(st.steps), int(st.accepted), int(st.nfe)) == (int(st_r.steps), int(st_r.accepted), int(st_r.nfe))
    np.testing.assert_allclose(y0.numpy(), np.asarray(y0_r), **TOL)
    np.testing.assert_allclose(ay0.numpy(), np.asarray(ay0_r), **TOL)
    for a, b in zip(_leaves(gargs["ps"]), _leaves(gargs_r["ps"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# name -> (dims, streamed forms?)
_STREAM_COVERED = {
    "miniboone860": (MB860, True),
    "hidden160": (NETS["hidden160"], True),
    "hidden129": ((43, 129, 128, 43), True),
    "four-layer-past-shared-memory": (NETS["four-layer"], True),
    "two-layer-hidden160": (NETS["two-layer"], True),
    "dz64-hidden4096": ((64, 4096, 64), True),
    "dz72-hidden80": ((72, 80, 72), True),
    "dz128-four-layer": ((128, 64, 64, 64, 128), True),
    "miniboone43": ((43, 128, 128, 43), False),
    "hepmass42": ((42, 126, 42), False),
    "power6": ((6, 64, 64, 6), False),
}


@pytest.mark.parametrize("name", list(_STREAM_COVERED))
def test_stream_coverage(name):
    """The chain kernels take every unconditional chain of state width up to
    128: the streamed forms exactly where the wide forms refuse it for its
    state width past 64, its hidden widths or its weights' shared memory,
    the narrow and wide forms the rest as before."""
    dims, stream = _STREAM_COVERED[name]
    spec = _spec(dims)
    assert tfs._kernel_covers(TSIT5, spec, chain=True) is None
    assert tfs._stream_chain(spec) == stream
    assert (tfs._kernel_covers(TSIT5, spec, chain=True, stream=False) is not None) == stream


# name -> (dims, probes, jvp)
_STREAM_PROBES = {
    "two-probes": (MB860, 2, False),
    "jvp": (MB860, 1, True),
    "four-layer-two-probes": (NETS["four-layer"], 2, False),
}


@pytest.mark.parametrize("name", list(_STREAM_PROBES))
def test_stream_forms_cover_probes(name):
    """The streamed forms cover K probes and JVP (K6 in the streamed forms,
    their probe instances) at the chains they run with one probe."""
    dims, k, jvp = _STREAM_PROBES[name]
    spec = _spec(dims)
    assert tfs._stream_chain(spec) and tfs._stream_chain(spec, True)
    assert tfs._kernel_covers(TSIT5, spec, k, chain=True, jvp=jvp) is None


# name -> (dims, n_cond, probes, jvp, what the refusal names)
_STREAM_REFUSED = {
    "conditional": ((130, 860, 129), 1, 2, False, "state width 129 > 128"),
    "dz129": ((129, 860, 129), 0, 1, False, "state width 129 > 128"),
    "five-layer": ((43,) + (860,) * 8 + (43,), 0, 1, False, "9-layer chains"),
}


@pytest.mark.parametrize("name", list(_STREAM_REFUSED))
def test_stream_refusals_name_their_roadmap_row(name):
    """State widths past 128, conditional nets among them with K probes (at
    the miniboone860 widths the streamed probe COND instances take those,
    row (d6): tests/test_torch_stream_cond_probes.py), and chains past 8
    layers (the "five-layer" case holds a 9-layer chain since 5-layer chains
    run, shape variants (b)) are refused with the reason and its ROADMAP
    queue 2 row."""
    dims, n_cond, k, jvp, why = _STREAM_REFUSED[name]
    msg = tfs._kernel_covers(TSIT5, _spec(dims, n_cond), k, chain=True, jvp=jvp)
    assert msg is not None and why in msg and "ROADMAP queue 2" in msg


def test_two_layer_backward_members_refuse_past_hidden_128():
    """A 2-layer net past hidden 128 runs the streamed forms for its
    Hutchinson and exact forwards, streamed K3 and K5 for its TEST forward
    and backward, and the streamed K4 adjoint for its exact backward; the
    wide K4 adjoint, whose wide 2-layer layout stops at hidden 128, refuses
    it, naming shape variants (e)."""
    spec = _spec(NETS["two-layer"])
    assert tfs._stream_chain(spec) and tfs._kernel_covers(TSIT5, spec, chain=True) is None
    assert tfs._stream_two_layer(spec) and tfs._stream_two_layer_covers(TSIT5, spec) is None
    assert tfs._stream_exact_covers(TSIT5, spec) is None
    msg = tfs._wide_two_layer_covers(TSIT5, spec)
    assert "hidden width 160 > 128" in msg and "ROADMAP queue 2, shape variants (e)" in msg


# (dims, mode) -> the wrappers the fused solve calls
_ROUTES = {
    ("narrow", "test"): ((5, 9, 7, 5), ["run_chain_test_solve_kernel"]),
    ("wide", "test"): ((5, 66, 7, 5), ["run_wide_test_solve_kernel"]),
    ("stream", "test"): ((5, 160, 7, 5), ["run_stream_test_solve_kernel"]),
    ("narrow", "train"): ((5, 9, 7, 5), ["run_chain_train_solve_kernel", "run_chain_adjoint_kernel"]),
    ("wide", "train"): ((5, 66, 7, 5), ["run_wide_train_solve_kernel", "run_wide_adjoint_kernel"]),
    ("stream", "train"): ((5, 160, 7, 5), ["run_stream_train_solve_kernel", "run_stream_adjoint_kernel"]),
    ("narrow", "exact"): ((5, 9, 7, 5), ["run_chain_exact_solve_kernel"]),
    ("wide", "exact"): ((5, 66, 7, 5), ["run_wide_exact_solve_kernel"]),
    ("stream", "exact"): ((5, 160, 7, 5), ["run_stream_exact_solve_kernel"]),
    ("wide2", "test"): ((34, 48, 34), ["run_wide_test2_solve_kernel", "run_wide_test_adjoint_kernel"]),
    ("stream2", "test"): ((34, 160, 34), ["run_stream_test2_solve_kernel", "run_stream_test_adjoint_kernel"]),
    ("wide2", "train"): ((34, 48, 34), ["run_wide_train_solve_kernel", "run_wide_adjoint_kernel"]),
    ("stream2", "train"): ((34, 160, 34), ["run_stream_train_solve_kernel", "run_stream_adjoint_kernel"]),
    ("wide2", "exact"): ((34, 48, 34), ["run_wide_exact_solve_kernel", "run_wide_exact_adjoint_kernel"]),
    ("stream2", "exact"): ((34, 160, 34), ["run_stream_exact_solve_kernel", "run_stream_exact_adjoint_kernel"]),
    ("dz70-stream2", "test"): ((70, 80, 70), ["run_stream_test2_solve_kernel", "run_stream_test_adjoint_kernel"]),
    ("dz70-stream2", "train"): ((70, 80, 70), ["run_stream_train_solve_kernel", "run_stream_adjoint_kernel"]),
    ("dz70-stream2", "exact"): ((70, 80, 70), ["run_stream_exact_solve_kernel", "run_stream_exact_adjoint_kernel"]),
    ("dz70-stream", "test"): ((70, 48, 32, 70), ["run_stream_test_solve_kernel"]),
}
_ALL_WRAPPERS = sorted({n for _, names in _ROUTES.values() for n in names})


@pytest.mark.parametrize("route", list(_ROUTES), ids=[f"{f}-{m}" for f, m in _ROUTES])
def test_fused_solve_takes_the_forms_by_width(monkeypatch, route):
    """`make_full_solve` runs a chain through the streamed wrappers exactly
    where the wide forms refuse it, and keeps the narrow and wide choices: a
    3-layer chain (TEST inference; the Hutchinson and exact losses'
    gradients), a 2-layer net past dz 32 (the TEST loss gradient too: past
    hidden 128 or dz 64 through streamed K3 and K5, and its exact backward
    member through the streamed K4 adjoint) and a 3-layer chain past dz
    64."""
    dims, want = _ROUTES[route]
    form, mode = route
    called = []
    for name in _ALL_WRAPPERS:
        wrapped = getattr(tfs, name)
        monkeypatch.setattr(tfs, name, lambda *a, _n=name, _f=wrapped, **kw: called.append(_n) or _f(*a, **kw))
    dz = dims[0]
    icnf = tcnf.construct(tcnf.RNODE, tcnf.MLP(dims), dz, compute_mode=_cm(tcnf, mode))
    ps = tcnf.params_from_numpy(glorot_params(np.random.default_rng(21), dims))
    xs = np.random.default_rng(22).normal(size=(4, dz)).astype(np.float32)
    if mode == "test" and not form.endswith("2"):
        with torch.no_grad():
            tcnf.inference(icnf, tcnf.Mode.TEST, xs, ps)
    else:
        leaves = [x.requires_grad_() for x in _leaves(ps)]
        extra = {"eps": np.random.default_rng(23).normal(size=(1, 4, dz)).astype(np.float32)} if mode == "train" else {}
        run = tcnf.Mode.TEST if mode == "test" else tcnf.Mode.TRAIN
        torch.autograd.grad(tcnf.loss(icnf, run, xs, ps, **extra), leaves)
    assert called == want


@pytest.mark.parametrize("kind", ["test", "exact", "train"])
def test_stream_wrappers_run_their_twins_on_the_cpu(kind):
    """On CPU tensors each streamed wrapper returns its plain version's
    solve, bit for bit, and counts no launch."""
    dims = NETS["hidden160"]
    spec = _spec(dims)
    rng = np.random.default_rng(24)
    ps = tcnf.params_from_numpy(_np_params(dims, 25))
    T = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    base = dict(rtol=1e-3, atol=1e-6, max_steps=100, ws=[p["w"] for p in ps], bs=[p["b"] for p in ps],
                t0=torch.tensor(0.0), t1=torch.tensor(1.0), dt_init=torch.tensor(0.05))
    z0 = T(rng.normal(size=(4, 6)))
    if kind == "test":
        pairs = [(tfs.run_stream_test_solve_kernel, tfs.solve_test_plain, dict(base, z0=z0, dlogp0=T(np.zeros(4))))]
    else:
        kw = dict(base, norm_z=True, norm_j=True, z0=z0, acc0=T(np.zeros((3, 4))))
        if kind == "exact":
            pairs = [(tfs.run_stream_exact_solve_kernel, tfs.solve_train_exact_plain, kw)]
        else:
            kw = dict(kw, eps=T(rng.normal(size=(1, 4, 6))))
            out = tfs.solve_train_plain(TSIT5, spec, **kw)
            akw = {k: v for k, v in kw.items() if k not in ("z0", "acc0", "t0", "t1", "dt_init")}
            akw.update(zT=out[0], accT=out[1], azT=T(rng.normal(size=(4, 6))), aaccT=T(np.full((3, 4), 0.25)),
                       t_hi=base["t1"], t_lo=base["t0"], dt_init=-out[4].abs())
            pairs = [(tfs.run_stream_train_solve_kernel, tfs.solve_train_plain, kw),
                     (tfs.run_stream_adjoint_kernel, tfs.adjoint_train_plain, akw)]
    before = _launch_counts()
    with torch.no_grad():
        for wrapper, twin, kw in pairs:
            got, ref = wrapper(TSIT5, spec, **kw), twin(TSIT5, spec, **kw)
            flat = lambda o: [x for v in o for x in (v if isinstance(v, list) else [v])]  # noqa: E731
            for a, b in zip(flat(got), flat(ref)):
                assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    assert _launch_counts() == before


def test_stream_fit_on_cpu():
    """`fit` on the fused 3-layer chain past hidden 128: finite losses,
    moving parameters, and no kernel launched on the CPU."""
    dims = NETS["hidden160"]
    ps_np = _np_params(dims, 26)
    X = _data(dims, 2 * B, 27)
    before = _launch_counts()
    res = tcnf.fit(tcnf.ICNFModel(_model(tcnf, dims), n_epochs=1, batch_size=B), X,
                   ps=tcnf.params_from_numpy(ps_np), seed=0)
    assert _launch_counts() == before
    assert res.epochs == 1 and np.isfinite(res.losses).all()
    moved = [float((a - torch.from_numpy(b)).abs().max()) for a, b in zip(_leaves(res.ps), _leaves(ps_np))]
    assert min(moved) > 0.0


# name -> (intervals, window, union)
_UNIONS = {
    "disjoint": ([(1.0, 2.0), (3.0, 5.0)], (0.0, 10.0), 3.0),
    "overlapping": ([(1.0, 4.0), (2.0, 3.0), (3.5, 6.0)], (0.0, 10.0), 5.0),
    "unsorted-touching": ([(5.0, 7.0), (1.0, 3.0), (3.0, 5.0)], (0.0, 10.0), 6.0),
    "clipped": ([(-2.0, 1.0), (9.0, 12.0), (4.0, 4.5)], (0.0, 10.0), 2.5),
    "outside": ([(-3.0, -1.0), (11.0, 12.0)], (0.0, 10.0), 0.0),
    "covering": ([(-1.0, 11.0), (2.0, 3.0)], (0.0, 10.0), 10.0),
    "empty": ([], (0.0, 10.0), 0.0),
}


@pytest.mark.parametrize("name", list(_UNIONS))
def test_profile_step_interval_union(name):
    """`profile_step`'s busy time: the union of the device intervals within
    the profiled window, overlaps counted once, never past the window (so
    the idle share 1 - busy / window stays in [0, 1])."""
    intervals, (lo, hi), want = _UNIONS[name]
    got = interval_union(intervals, lo, hi)
    assert got == pytest.approx(want) and 0.0 <= got <= hi - lo
