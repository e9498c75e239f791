"""The CUDA kernels (K3, K1, K2, the K4 forward and adjoint, K5 with and
without conditioning rows, and the chain kernels: the K1 and K2 chain forms,
the K7 TEST and exact forwards, with and
without conditioning rows, under every embedded explicit tableau and with
identity layers, the probe instances of K1, K2 and their chain forms with K
VJP or JVP probes (K6), and their wide forms at the MINIBOONE width; wide
K3, wide K5 and the wide K4 adjoint for 2-layer nets past state width 32,
the HEPMASS width of the README net family; the streamed forms of the
chain kernels for chains whose weights pass a block's shared memory, FFJORD's
MINIBOONE width 43 -> 860 -> 860 -> 43, and for state widths 65 to 128;
streamed K3 and K5 and the streamed K4 adjoint for 2-layer nets past the
wide limits, the README net family at the MINIBOONE width 86 -> 258 -> 86
and the BSDS300 width 126 -> 378 -> 126, and the COND instances of the wide
and streamed forms for conditional nets past the narrow and the wide
limits, streamed K7's and the streamed K4 adjoint's included, and the
probe COND instances of the wide and streamed chain forms) against their
plain PyTorch
versions, on the card, and the configurations they do not cover.

These tests need a CUDA device and skip elsewhere.  On a machine with a card
(and without JAX, whose conftest this file does not need):

    python -m pytest --noconftest -o addopts='' -m gpu tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import continuousnf_tpu_torch as tcnf
from continuousnf_tpu_torch.ode.tableaus import BOSH3, DOP853, DOPRI5, TSIT5, VERNER65
from continuousnf_tpu_torch.ops import fused_solve as tfs
from continuousnf_tpu_torch.utils import near_tie
from continuousnf_tpu_torch.utils.configs import glorot_params

pytestmark = pytest.mark.gpu

# Kernel and plain version sum in other orders (f32): a relative bound.
REL = 1e-4
# K2's parameter gradients are sums over the batch taken in another order.
GRAD_REL = 1e-3
POWER6 = (6, 64, 64, 6)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _np_params(dims, seed):
    return glorot_params(np.random.default_rng(seed), dims)


def _kernel_args(dims, B, span, dev, seed=0):
    ps = tcnf.params_from_numpy(_np_params(dims, seed), dev)
    rng = np.random.default_rng(seed + 1)
    z0 = rng.uniform(size=(B, dims[-1])).astype(np.float32)
    dlogp0 = rng.normal(0.0, 0.5, B).astype(np.float32)
    return dict(
        rtol=1e-3, atol=1e-6, max_steps=10_000,
        ws=[p["w"] for p in ps], bs=[p["b"] for p in ps],
        z0=torch.from_numpy(z0).to(dev), dlogp0=torch.from_numpy(dlogp0).to(dev),
        t0=torch.tensor(span[0], device=dev), t1=torch.tensor(span[1], device=dev),
        dt_init=torch.tensor(0.05 if span[1] > span[0] else -0.05, device=dev),
    )


def _close(got, ref):
    return float((got - ref).abs().max()) <= REL * max(1.0, float(ref.abs().max()))


@pytest.mark.parametrize(
    "dims,B,span",
    [
        ((5, 15, 5), 16, (0.0, 1.0)),
        ((3, 7, 3), 37, (0.0, 2.0)),
        ((16, 48, 16), 4096, (0.0, 13.0)),
        ((16, 48, 16), 4096, (13.0, 0.0)),
        ((32, 64, 32), 256, (0.0, 3.0)),
        ((16, 48, 16), 131072, (0.0, 13.0)),
    ],
    ids=["small", "dz3-ragged", "flagship", "flagship-reverse", "dz32", "strided"],
)
def test_kernel_matches_plain(dev, dims, B, span):
    spec = tfs.chain_spec(tcnf.MLP(dims), dims[-1])
    kw = _kernel_args(dims, B, span, dev)
    before = tfs.run_solve_kernel.launches
    with torch.no_grad():
        zk, lk, sk, ak, dk, _ = tfs.run_solve_kernel(TSIT5, spec, **kw)
        zp, lp, sp, ap, dp, _ = tfs.solve_test_plain(TSIT5, spec, **kw)
    torch.cuda.synchronize()
    assert tfs.run_solve_kernel.launches == before + 1
    assert (int(sk), int(ak)) == (int(sp), int(ap))
    assert torch.isfinite(zk).all() and torch.isfinite(lk).all()
    assert _close(zk, zp) and _close(lk, lp)
    assert float(dk) == pytest.approx(float(dp), rel=0.1)


def test_slice_through_kernel_matches_plain(dev):
    """logpdf and sample through K3 against the plain path.  Step counts are
    compared exactly; they agreed on all 40 inputs of a seed sweep, and
    PERF.md records one near-tie input on which they differ by one."""
    dims = (16, 48, 16)
    mk = lambda fused: tcnf.construct(
        tcnf.RNODE, tcnf.MLP(dims, device=dev), 8, 8, tspan=(0.0, 13.0),
        compute_mode=tcnf.VecJacMode(fused=fused),
    )
    ps = tcnf.params_from_numpy(_np_params(dims, 0), dev)
    xs = torch.from_numpy(np.random.default_rng(1000).uniform(size=(512, 8)).astype(np.float32)).to(dev)
    z1 = torch.from_numpy(np.random.default_rng(5).normal(size=(512, 16)).astype(np.float32)).to(dev)
    before = tfs.run_solve_kernel.launches
    with torch.no_grad():
        lp_k, _, st_k = tcnf.inference(mk(True), tcnf.Mode.TEST, xs, ps)
        lp_p, _, st_p = tcnf.inference(mk(False), tcnf.Mode.TEST, xs, ps)
        s_k = tcnf.generate(mk(True), tcnf.Mode.TEST, ps, 512, z1=z1)
        s_p = tcnf.generate(mk(False), tcnf.Mode.TEST, ps, 512, z1=z1)
    assert tfs.run_solve_kernel.launches == before + 2
    assert int(st_k.steps) == int(st_p.steps) and int(st_k.nfe) == int(st_p.nfe)
    assert _close(lp_k, lp_p) and _close(s_k, s_p)


@pytest.mark.parametrize(
    "dims,final,tab",
    [
        ((5,) + (9,) * 8 + (5,), torch.tanh, TSIT5),
        ((5, 80, 7, 5), torch.tanh, TSIT5),
        ((40, 48, 40), torch.tanh, TSIT5),
    ],
    ids=["five-layer", "wide-hidden", "dz40"],
)
def test_uncovered_configs_raise_on_cuda(dev, dims, final, tab):
    spec = tfs.chain_spec(tcnf.MLP(dims, final_activation=final), dims[-1])
    kw = _kernel_args(dims, 8, (0.0, 1.0), dev)
    run = tfs.run_chain_test_solve_kernel if spec.n_layers > 2 else tfs.run_solve_kernel
    before = run.launches
    with pytest.raises(NotImplementedError):
        run(tab, spec, **kw)
    assert run.launches == before


@pytest.mark.parametrize("case", ["cap", "empty-span", "single-sample"])
def test_kernel_edge_cases_match_plain(dev, case):
    dims = (16, 48, 16)
    spec = tfs.chain_spec(tcnf.MLP(dims), dims[-1])
    kw = _kernel_args(dims, 1 if case == "single-sample" else 64, (0.0, 13.0), dev)
    if case == "cap":
        kw["max_steps"] = 5
    if case == "empty-span":
        kw["t1"] = kw["t0"].clone()
    with torch.no_grad():
        zk, lk, sk, ak, *_ = tfs.run_solve_kernel(TSIT5, spec, **kw)
        zp, lp, sp, ap, *_ = tfs.solve_test_plain(TSIT5, spec, **kw)
    assert (int(sk), int(ak)) == (int(sp), int(ap))
    if case == "cap":
        # Where a capped solve stops in time follows step sizes set by an
        # eest at f32 roundoff level, so only the counts are compared.
        assert int(sk) == 5 and torch.isfinite(zk).all() and torch.isfinite(lk).all()
    else:
        assert _close(zk, zp) and _close(lk, lp)
    if case == "empty-span":
        assert int(sk) == 0 and torch.equal(zk, kw["z0"]) and torch.equal(lk, kw["dlogp0"])


def _train_args(dims, B, span, dev, seed=0):
    """K1 inputs (nonzero accumulators) and the K2 inputs built from them."""
    kw = _kernel_args(dims, B, span, dev, seed)
    rng = np.random.default_rng(seed + 2)
    T = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    dz = dims[-1]
    kw.pop("dlogp0")
    kw.update(norm_z=True, norm_j=True, eps=T(rng.normal(size=(1, B, dz))), acc0=T(rng.normal(0.0, 0.5, (3, B))))
    adj = dict(
        {k: kw[k] for k in ("rtol", "atol", "max_steps", "ws", "bs", "eps", "norm_z", "norm_j")},
        azT=T(rng.normal(0.0, 1.0 / B, (B, dz))), aaccT=T(rng.normal(0.0, 1.0 / B, (3, B))),
        t_hi=kw["t1"], t_lo=kw["t0"],
    )
    return kw, adj


def _grad_close(got, ref):
    return float((got - ref).abs().max()) <= GRAD_REL * max(1.0, float(ref.abs().max()))


def _rel(got, ref):
    return float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))


def _twin64(twin, spec, adj, tab=TSIT5):
    """A plain twin run in float64."""
    to64 = lambda v: v.double() if torch.is_tensor(v) else [x.double() for x in v] if isinstance(v, list) else v
    return twin(tab, spec, **{k: to64(v) for k, v in adj.items()})


def _state_close(got, ref32, ref64):
    """The backward-reconstructed state is ill-conditioned (its float32 twin
    can sit more than 1e-4 from the float64 one): within 1e-4 of the
    float64 twin or within 4x the float32 twin's own distance from it."""
    return _rel(got, ref64) <= max(REL, 4.0 * _rel(ref32, ref64))


@pytest.mark.parametrize(
    "dims,B",
    [((16, 48, 16), 1), ((16, 48, 16), 37), ((16, 48, 16), 512), ((16, 48, 16), 4096), ((5, 15, 5), 37)],
    ids=["flagship-B1", "flagship-B37", "flagship-B512", "flagship-B4096", "dz5-B37"],
)
def test_train_kernels_match_twins(dev, dims, B):
    spec = tfs.chain_spec(tcnf.MLP(dims), dims[-1])
    span = (0.0, 13.0) if dims[0] == 16 else (0.0, 2.0)
    kw, adj = _train_args(dims, B, span, dev)
    n1, n2 = tfs.run_train_solve_kernel.launches, tfs.run_adjoint_kernel.launches
    with torch.no_grad():
        zk, ak, sk, ck, dk, _ = tfs.run_train_solve_kernel(TSIT5, spec, **kw)
        zp, ap, sp, cp, dp, _ = tfs.solve_train_plain(TSIT5, spec, **kw)
        adj.update(zT=zk, accT=ak, dt_init=-dk.abs())
        out_k = tfs.run_adjoint_kernel(TSIT5, spec, **adj)
        out_p = tfs.adjoint_train_plain(TSIT5, spec, **adj)
        out_64 = _twin64(tfs.adjoint_train_plain, spec, adj)
    torch.cuda.synchronize()
    assert (tfs.run_train_solve_kernel.launches, tfs.run_adjoint_kernel.launches) == (n1 + 1, n2 + 1)
    assert (int(sk), int(ck)) == (int(sp), int(cp))
    assert _close(zk, zp) and all(_close(ak[r], ap[r]) for r in range(3))
    # dt_last is not compared: it follows a roundoff-level eest and drifts
    # by up to 16 % between K1 and its twin (B = 37); K2 and its twin start
    # from the same step.
    assert (int(out_k[5]), int(out_k[6])) == (int(out_p[5]), int(out_p[6]))
    for i in range(3):  # z0, acc0, a_z0
        assert _state_close(out_k[i], out_p[i], out_64[i])
    for a, b in zip(out_k[3] + out_k[4], out_p[3] + out_p[4]):
        assert torch.isfinite(a).all() and _grad_close(a, b)


@pytest.mark.parametrize("case", ["cap", "empty-span", "single-sample"])
def test_train_kernel_edge_cases_match_twins(dev, case):
    dims = (16, 48, 16)
    spec = tfs.chain_spec(tcnf.MLP(dims), dims[-1])
    kw, adj = _train_args(dims, 1 if case == "single-sample" else 64, (0.0, 13.0), dev)
    if case == "cap":
        kw["max_steps"] = adj["max_steps"] = 5
    if case == "empty-span":
        kw["t1"] = kw["t0"].clone()
        adj["t_hi"] = adj["t_lo"].clone()
    with torch.no_grad():
        zk, ak, sk, ck, *_ = tfs.run_train_solve_kernel(TSIT5, spec, **kw)
        zp, ap, sp, cp, *_ = tfs.solve_train_plain(TSIT5, spec, **kw)
        adj.update(zT=zp, accT=ap, dt_init=torch.tensor(-0.05, device=dev))
        out_k = tfs.run_adjoint_kernel(TSIT5, spec, **adj)
        out_p = tfs.adjoint_train_plain(TSIT5, spec, **adj)
        out_64 = _twin64(tfs.adjoint_train_plain, spec, adj)
    assert (int(sk), int(ck)) == (int(sp), int(cp))
    assert (int(out_k[5]), int(out_k[6])) == (int(out_p[5]), int(out_p[6]))
    if case == "cap":
        # As for K3: where a capped solve stops follows step sizes set by an
        # eest at f32 roundoff level, so only the counts are compared.
        assert int(sk) == 5 and int(out_k[5]) == 5
        assert torch.isfinite(zk).all() and all(torch.isfinite(g).all() for g in out_k[3] + out_k[4])
        return
    assert _close(zk, zp) and _close(ak, ap)
    assert all(_state_close(out_k[i], out_p[i], out_64[i]) for i in range(3))
    for a, b in zip(out_k[3] + out_k[4], out_p[3] + out_p[4]):
        assert _grad_close(a, b)
    if case == "empty-span":
        assert int(sk) == 0 and int(out_k[5]) == 0
        assert torch.equal(zk, kw["z0"]) and torch.equal(ak, kw["acc0"])
        assert all(float(g.abs().max()) == 0.0 for g in out_k[3] + out_k[4])


def test_train_step_on_the_card_matches_the_twins_on_the_cpu(dev):
    """The fused TRAIN loss and gradient through K1 and K2 against the same
    step on the CPU, where the fused path runs the kernels' twins."""
    dims = (16, 48, 16)
    ps_np = _np_params(dims, 3)
    xs = np.random.default_rng(4).uniform(size=(512, 8)).astype(np.float32)
    eps = np.random.default_rng(5).normal(size=(1, 512, 16)).astype(np.float32)

    def run(device):
        icnf = tcnf.construct(
            tcnf.RNODE, tcnf.MLP(dims, device=device), 8, 8, tspan=(0.0, 13.0), steer_rate=0.1,
            lam3=1e-2, compute_mode=tcnf.VecJacMode(fused=True),
        )
        ps = tcnf.params_from_numpy(ps_np, device)
        leaves = [x.requires_grad_() for p in ps for x in (p["w"], p["b"])]
        l, m = tcnf.loss_and_metrics(icnf, tcnf.Mode.TRAIN, xs, ps, eps=eps, steer_r=0.03)
        return l.detach().cpu(), [g.cpu() for g in torch.autograd.grad(l, leaves)], int(m["nfe"])

    n1, n2 = tfs.run_train_solve_kernel.launches, tfs.run_adjoint_kernel.launches
    l_k, g_k, nfe_k = run(dev)
    assert (tfs.run_train_solve_kernel.launches, tfs.run_adjoint_kernel.launches) == (n1 + 1, n2 + 1)
    l_c, g_c, nfe_c = run(torch.device("cpu"))
    assert nfe_k == nfe_c and _close(l_k, l_c)
    for a, b in zip(g_k, g_c):
        assert _grad_close(a, b)


def _small(fused=True, **kw):
    cm = kw.pop("compute_mode", tcnf.VecJacMode(fused=fused))
    return tcnf.construct(tcnf.RNODE, tcnf.MLP((5, 15, 5)), 3, 2, compute_mode=cm, **kw)


@pytest.mark.parametrize(
    "kernel",
    ["K5-test-gradients", "K6-wide-forms", "K8-conditional", "K10-per-stage-field"],
)
def test_uncovered_train_configs_raise_on_cuda(dev, kernel):
    name = kernel.split("-")[0]
    ps_np = _np_params((5, 15, 5), 6)
    xs = torch.from_numpy(np.random.default_rng(7).uniform(size=(8, 3)).astype(np.float32)).to(dev)
    if kernel == "K6-wide-forms":
        # K probes or JVP probes on a chain past the narrow widths, which the
        # wide forms' probe instances took over from this refusal: each runs
        # and holds to its twin, counted under its (K, jvp), and a K-probe
        # TRAIN inference launches the wide K1 chain form's probe instance.
        dims = (43, 64, 64, 43)
        spec = tfs.chain_spec(tcnf.MLP(dims, device=dev), dims[-1])
        kw, adj = _train_args(dims, 8, (0.0, 1.0), dev)
        runs = (tfs.run_wide_train_solve_kernel, tfs.run_wide_adjoint_kernel)
        for k, jvp in ((2, False), (1, True)):
            kw["eps"] = adj["eps"] = torch.randn(k, 8, dims[-1], device=dev)
            before = [w.probe_launches.get((k, jvp), 0) for w in runs]
            with torch.no_grad():
                out_k = runs[0](TSIT5, spec, **kw, jvp=jvp)
                out_p = tfs.solve_train_plain(TSIT5, spec, **kw, jvp=jvp)
                adj.update(zT=out_k[0], accT=out_k[1], dt_init=-out_k[4].abs())
                adj_k = runs[1](TSIT5, spec, **adj, jvp=jvp)
                adj_p = tfs.adjoint_train_plain(TSIT5, spec, **adj, jvp=jvp)
                adj_64 = _twin64(tfs.adjoint_train_plain, spec, dict(adj, jvp=jvp))
            torch.cuda.synchronize()
            assert [w.probe_launches.get((k, jvp), 0) for w in runs] == [n + 1 for n in before]
            assert _forward_matches(out_k, out_p) and _adjoint_matches(adj_k, adj_p, adj_64)
        icnf = tcnf.construct(tcnf.RNODE, tcnf.MLP(dims, device=dev), 43, 0, compute_mode=tcnf.VecJacMode(2, fused=True))
        ps = tcnf.params_from_numpy(_np_params(dims, 6), dev)
        xs43 = torch.from_numpy(np.random.default_rng(7).normal(size=(8, 43)).astype(np.float32)).to(dev)
        before = runs[0].probe_launches.get((2, False), 0)
        with torch.no_grad():
            lp, _, _ = tcnf.inference(icnf, tcnf.Mode.TRAIN, xs43, ps, generator=torch.Generator(dev).manual_seed(0))
        assert runs[0].probe_launches[(2, False)] == before + 1 and bool(torch.isfinite(lp).all())
        return
    if kernel == "K8-conditional":
        # A 2-layer conditional exact-TRAIN gradient: its forward runs in K7
        # exact, its backward would need the K4 adjoint with ys rows.
        icnf = tcnf.construct(tcnf.CondRNODE, tcnf.MLP((7, 15, 5), device=dev), 3, 2,
                              compute_mode=tcnf.VecJacMode(fused=True, exact_trace=True))
        ps = tcnf.params_from_numpy(_np_params((7, 15, 5), 6), dev)
        leaves = [x.requires_grad_() for p in ps for x in p.values()]
        ys = torch.zeros((8, 2), device=dev)
        n7, n4 = tfs.run_chain_exact_solve_kernel.launches, tfs.run_exact_adjoint_kernel.launches
        with pytest.raises(NotImplementedError, match="K8 in the 2-layer kernels"):
            torch.autograd.grad(tcnf.loss(icnf, tcnf.Mode.TRAIN, xs, ps, ys=ys), leaves)
        assert tfs.run_chain_exact_solve_kernel.launches == n7 + 1
        assert tfs.run_exact_adjoint_kernel.launches == n4
        return
    if kernel == "K5-test-gradients":
        # K5 covers every 2-layer tanh net of state width up to 32 and refuses
        # a wider one naming the shape variants (a), launching nothing; the
        # fused solve takes a wider net's TEST gradient to wide K3 and wide
        # K5, once each.
        dims = (40, 64, 40)
        spec = tfs.chain_spec(tcnf.MLP(dims, device=dev), dims[-1])
        icnf = tcnf.construct(tcnf.RNODE, tcnf.MLP(dims, device=dev), 40, 0, compute_mode=tcnf.VecJacMode(fused=True))
        ps = tcnf.params_from_numpy(_np_params(dims, 6), dev)
        leaves = [x.requires_grad_() for p in ps for x in p.values()]
        xs40 = torch.from_numpy(np.random.default_rng(7).normal(size=(8, 40)).astype(np.float32)).to(dev)
        before = _launches()
        g = torch.autograd.grad(tcnf.loss(icnf, tcnf.Mode.TEST, xs40, ps), leaves)
        after = _launches()
        assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {tfs.K3W_KERNEL: 1,
                                                                                     tfs.K5W_KERNEL: 1}
        assert all(bool(torch.isfinite(x).all()) for x in g)
        before = after
        z = torch.zeros((8, 40), device=dev)
        acc = torch.zeros((1, 8), device=dev)
        with pytest.raises(NotImplementedError, match=r"shape variants \(a\)"):
            tfs.run_test_adjoint_kernel(TSIT5, spec, rtol=1e-3, atol=1e-6, max_steps=10, ws=[p["w"].detach() for p in ps],
                                        bs=[p["b"].detach() for p in ps], zT=z, accT=acc, azT=z, aaccT=acc,
                                        t_hi=torch.tensor(1.0, device=dev), t_lo=torch.tensor(0.0, device=dev),
                                        dt_init=torch.tensor(-0.05, device=dev))
        assert _launches() == before
        return
    assert kernel == "K10-per-stage-field"
    # K10 against its plain version on the card, float32 and float64, at a
    # small net, the flagship and an odd batch; then the nets whose weights
    # overflow a block's shared memory raise naming the shape variants, and
    # nothing launches.
    from continuousnf_tpu_torch.ops import fused_dynamics as tfd

    for dims, B in (((5, 15, 5), 37), ((16, 48, 16), 4096), ((16, 48, 16), 4097), ((43, 128, 43), 300)):
        for dtype, rel in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
            xs10 = _k10_inputs(dims, B, dev, dtype)
            before = tfd.run_fused_field_kernel.launches
            got = tfd.run_fused_field_kernel(*xs10)
            ref = tfd.fused_field_plain(*xs10)
            torch.cuda.synchronize()
            assert tfd.run_fused_field_kernel.launches == before + 1
            for a, b in zip(got, ref):
                assert a.dtype == dtype and a.shape == b.shape and torch.isfinite(a).all()
                assert float((a - b).abs().max()) <= rel * max(1.0, float(b.abs().max()))
    before = tfd.run_fused_field_kernel.launches
    with pytest.raises(NotImplementedError, match="K10 shape variants"):
        tfd.run_fused_field_kernel(*_k10_inputs((64, 512, 64), 8, dev, torch.float32))
    with pytest.raises(NotImplementedError, match="K10 shape variants"):
        tfd.run_fused_field_kernel(*_k10_inputs((32, 512, 32), 8, dev, torch.float64))
    assert tfd.run_fused_field_kernel.launches == before


def _k10_inputs(dims, B, dev, dtype):
    ps = _np_params(dims, 11)
    rng = np.random.default_rng(12)
    T = lambda a: torch.from_numpy(np.asarray(a)).to(dev, dtype)  # noqa: E731
    return [T(ps[0]["w"]), T(ps[0]["b"]), T(ps[1]["w"]), T(ps[1]["b"]), T(rng.normal(size=(B, dims[0]))),
            T(rng.normal(size=(B, dims[0])))]


@pytest.mark.parametrize("solver", ["direct", "fixed-rk4", "backsolve-f64"])
def test_k10_paths_on_the_card_match_the_cpu(dev, solver):
    """The K10 field's paths on the card against the same calls on the CPU
    (K10's plain version): the DIRECT and fixed-step TRAIN loss gradients
    (eps included) and the float64 BACKSOLVE gradient, whose forward and
    backward solves evaluate the field stage by stage; K10 launched and no
    solve kernel."""
    dims = (5, 15, 5)
    opts = {"direct": tcnf.SolverOptions(adjoint=tcnf.Adjoint.DIRECT, direct_max_steps=64),
            "fixed-rk4": tcnf.SolverOptions(method="rk4", fixed_num_steps=8),
            "backsolve-f64": tcnf.SolverOptions()}[solver]
    dtype = torch.float64 if solver == "backsolve-f64" else torch.float32
    ps_np = _np_params(dims, 13)
    rng = np.random.default_rng(14)
    xs_np, eps_np = rng.uniform(size=(64, 3)), rng.normal(size=(1, 64, 5))

    def run(device):
        icnf = tcnf.construct(tcnf.RNODE, tcnf.MLP(dims, device=device, dtype=dtype), 3, 2, tspan=(0.0, 1.0),
                              steer_rate=0.1, lam3=1e-2, compute_mode=tcnf.VecJacMode(fused=True), solver=opts,
                              dtype=dtype)
        ps = tuple({k: v.to(dtype).requires_grad_() for k, v in p.items()}
                   for p in tcnf.params_from_numpy(ps_np, device))
        leaves = [x for p in ps for x in p.values()]
        eps = torch.from_numpy(eps_np).to(device, dtype).requires_grad_()
        l, m = tcnf.loss_and_metrics(icnf, tcnf.Mode.TRAIN, torch.from_numpy(xs_np).to(device, dtype), ps,
                                     eps=eps, steer_r=0.05)
        grads = torch.autograd.grad(l, leaves + [eps], allow_unused=True)
        return float(l.detach()), [g.cpu() for g in grads if g is not None], int(m["nfe"])

    before = _launches()
    l_k, g_k, nfe_k = run(dev)
    torch.cuda.synchronize()
    after = _launches()
    moved = {k for k in after if after[k] != before[k]}
    assert moved == {"k10_fused_field"} and after["k10_fused_field"] - before["k10_fused_field"] >= nfe_k
    l_c, g_c, nfe_c = run(torch.device("cpu"))
    assert nfe_k == nfe_c and abs(l_k - l_c) <= 1e-5 * max(1.0, abs(l_c))
    rel = 1e-10 if dtype == torch.float64 else 1e-4
    for a, b in zip(g_k, g_c):
        assert float((a - b).abs().max()) <= rel * max(1.0, float(b.abs().max()))


# K6: name -> (dims, B, probes K, JVP?, the chain forms?, span); a dims[0]
# wider than dims[-1] is a conditional chain (ys (B, n_cond)).
_K6_CASES = {
    "K6-probes": ((5, 15, 5), 37, 2, False, False, (0.0, 2.0)),
    "K6-jvp": ((5, 15, 5), 37, 1, True, False, (0.0, 2.0)),
    "K6-chain-probes": ((5, 9, 7, 5), 300, 2, False, True, (0.0, 2.0)),
    "K6-chain-jvp": ((5, 9, 7, 5), 300, 3, True, True, (0.0, 2.0)),
    "flagship-K8": ((16, 48, 16), 4096, 8, False, False, (0.0, 13.0)),
    "flagship-jvp-K2": ((16, 48, 16), 4096, 2, True, False, (0.0, 13.0)),
    "flagship-K4-chain-forms": ((16, 48, 16), 512, 4, False, True, (0.0, 13.0)),
    "power6-K4": (POWER6, 4096, 4, False, True, (0.0, 1.0)),
    "power6-jvp": (POWER6, 4096, 1, True, True, (0.0, 1.0)),
    "power6-jvp-reverse": (POWER6, 1000, 2, True, True, (1.0, 0.0)),
    "conditional-K2": ((5, 16, 16, 3), 300, 2, False, True, (0.0, 2.0)),
    "conditional-jvp-K2": ((5, 16, 16, 3), 300, 2, True, True, (0.0, 2.0)),
    "miniboone-K2": ((43, 128, 128, 43), 300, 2, False, True, (0.0, 1.0)),
    "miniboone-jvp": ((43, 128, 128, 43), 300, 1, True, True, (0.0, 1.0)),
    "miniboone860-K2": ((43, 860, 860, 43), 256, 2, False, True, (0.0, 1.0)),
    "miniboone860-jvp-reverse": ((43, 860, 860, 43), 37, 2, True, True, (1.0, 0.0)),
    "miniboone86-K4": ((86, 258, 86), 512, 4, False, True, (0.0, 1.0)),
    "bsds126-jvp": ((126, 378, 126), 256, 1, True, True, (0.0, 1.0)),
    "probe-only-shared-memory-K3": ((64, 128, 128, 120, 64), 128, 3, False, True, (0.0, 1.0)),
    "probe-only-shared-memory-jvp": ((60, 128, 128, 128, 60), 128, 1, True, True, (0.0, 1.0)),
    "one-layer-K2": ((6, 6), 300, 2, False, True, (0.0, 2.0)),
    "refbench16-K4": ((16, 16), 4096, 4, False, True, (0.0, 13.0)),
    "one-layer-jvp-reverse": ((16, 16), 512, 2, True, True, (2.0, 0.0)),
    "cond-one-layer-jvp": ((17, 16), 512, 1, True, True, (0.0, 13.0)),
    "eight-layer-narrow-K2": ((6,) + (32,) * 7 + (6,), 512, 2, False, True, (0.0, 1.0)),
    "eight-layer-power6-jvp": ((6,) + (64,) * 7 + (6,), 256, 1, True, True, (0.0, 1.0)),
    "five-layer-miniboone860-K2": ((43,) + (860,) * 4 + (43,), 64, 2, False, True, (0.0, 1.0)),
}


@pytest.mark.parametrize("case", list(_K6_CASES))
def test_probe_kernels_match_twins(dev, case):
    """K6: the probe instances of K1 and K2 (or of their chain forms, narrow,
    wide past the narrow widths, or streamed where the wide probe instances
    do not keep the chain) with K VJP or JVP probes against their twins: the
    forward from nonzero
    accumulators (equal steps, values within REL), the adjoint from its
    output with its last step as the warm start (equal steps, z0 and a_z0
    held to the float64 twin, gradients and a_ys0 within GRAD_REL), each
    launch counted under its (K, jvp).  A forward that parts from its twin
    only at the last step passes under the last-step rule, and a solve that
    misses the twin's bound otherwise under the near-tie rule."""
    dims, B, k, jvp, chain, span = _K6_CASES[case]
    n_cond = dims[0] - dims[-1]
    net = tcnf.MLP((dims[0],) + dims[1:], device=dev)
    spec = tfs.chain_spec(net, dims[-1])
    kw, adj = _train_args((dims[0],) + dims[1:], B, span, dev)
    dz = dims[-1]
    rng = np.random.default_rng(11)
    T = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    kw.update(z0=T(rng.uniform(size=(B, dz))), eps=T(rng.normal(size=(k, B, dz))), jvp=jvp)
    adj.update(eps=kw["eps"], jvp=jvp, azT=T(rng.normal(0.0, 1.0 / B, (B, dz))))
    if n_cond:
        kw["ys"] = adj["ys"] = _ys(B, n_cond, dev)
    if chain and tfs._stream_chain(spec, True):
        run1, run2 = tfs.run_stream_train_solve_kernel, tfs.run_stream_adjoint_kernel
    elif chain and tfs._wide_chain(spec):
        run1, run2 = tfs.run_wide_train_solve_kernel, tfs.run_wide_adjoint_kernel
    elif chain:
        run1, run2 = tfs.run_chain_train_solve_kernel, tfs.run_chain_adjoint_kernel
    else:
        run1, run2 = tfs.run_train_solve_kernel, tfs.run_adjoint_kernel
    before = [w.probe_launches.get((k, jvp), 0) for w in (run1, run2)]
    with torch.no_grad():
        out_k = run1(TSIT5, spec, **kw)
        out_p = tfs.solve_train_plain(TSIT5, spec, **kw)
        tdir = torch.sign(kw["t1"] - kw["t0"])
        adj.update(zT=out_k[0], accT=out_k[1], dt_init=-tdir * out_k[4].abs())
        adj_k = run2(TSIT5, spec, **adj)
        adj_p = tfs.adjoint_train_plain(TSIT5, spec, **adj)
        adj_64 = _twin64(tfs.adjoint_train_plain, spec, adj)
    torch.cuda.synchronize()
    assert [w.probe_launches.get((k, jvp), 0) for w in (run1, run2)] == [n + 1 for n in before]
    if not _forward_matches(out_k, out_p):
        last, line = near_tie.last_step_tie(out_k, out_p, REL)
        if not last:
            _near_tie_holds(out_k, out_p, tfs.solve_train_plain, spec, kw, "z0")
    if not _adjoint_matches(adj_k, adj_p, adj_64):
        _near_tie_holds(adj_k, adj_p, tfs.adjoint_train_plain, spec, adj, "zT")


def _exact_args(dims, B, span, dev, seed=0):
    """K4 forward inputs (nonzero accumulators) and the K4 adjoint inputs
    built from them (no probes)."""
    kw, adj = _train_args(dims, B, span, dev, seed)
    kw.pop("eps")
    adj.pop("eps")
    return kw, adj


@pytest.mark.parametrize(
    "dims,B,span",
    [
        ((16, 48, 16), 37, (0.0, 13.0)),
        ((16, 48, 16), 512, (0.0, 13.0)),
        ((16, 48, 16), 4096, (0.0, 13.0)),
        ((16, 48, 16), 256, (13.0, 0.0)),
        ((5, 15, 5), 37, (0.0, 2.0)),
        ((32, 64, 32), 64, (0.0, 3.0)),
    ],
    ids=["flagship-B37", "flagship-B512", "flagship-B4096", "flagship-reverse", "dz5-B37", "dz32-B64"],
)
def test_exact_kernels_match_twins(dev, dims, B, span):
    """The K4 forward from nonzero accumulators and the K4 adjoint from its
    output, warm-started from its last step, against their plain versions."""
    spec = tfs.chain_spec(tcnf.MLP(dims), dims[-1])
    kw, adj = _exact_args(dims, B, span, dev)
    n4 = (tfs.run_exact_solve_kernel.launches, tfs.run_exact_adjoint_kernel.launches)
    with torch.no_grad():
        zk, ak, sk, ck, dk, _ = tfs.run_exact_solve_kernel(TSIT5, spec, **kw)
        zp, ap, sp, cp, *_ = tfs.solve_train_exact_plain(TSIT5, spec, **kw)
        adj.update(zT=zk, accT=ak, dt_init=-torch.sign(kw["t1"] - kw["t0"]) * dk.abs())
        out_k = tfs.run_exact_adjoint_kernel(TSIT5, spec, **adj)
        out_p = tfs.adjoint_train_exact_plain(TSIT5, spec, **adj)
        out_64 = _twin64(tfs.adjoint_train_exact_plain, spec, adj)
    torch.cuda.synchronize()
    assert (tfs.run_exact_solve_kernel.launches, tfs.run_exact_adjoint_kernel.launches) == (n4[0] + 1, n4[1] + 1)
    assert (int(sk), int(ck)) == (int(sp), int(cp))
    assert torch.isfinite(zk).all() and torch.isfinite(ak).all()
    assert _close(zk, zp) and all(_close(ak[r], ap[r]) for r in range(3))
    assert (int(out_k[5]), int(out_k[6])) == (int(out_p[5]), int(out_p[6]))
    for i in range(3):  # z0, acc0, a_z0
        assert _state_close(out_k[i], out_p[i], out_64[i])
    for a, b in zip(out_k[3] + out_k[4], out_p[3] + out_p[4]):
        assert torch.isfinite(a).all() and _grad_close(a, b)


@pytest.mark.parametrize("case", ["cap", "empty-span", "single-sample"])
def test_exact_kernel_edge_cases_match_twins(dev, case):
    dims = (16, 48, 16)
    spec = tfs.chain_spec(tcnf.MLP(dims), dims[-1])
    kw, adj = _exact_args(dims, 1 if case == "single-sample" else 64, (0.0, 13.0), dev)
    if case == "cap":
        kw["max_steps"] = adj["max_steps"] = 5
    if case == "empty-span":
        kw["t1"] = kw["t0"].clone()
        adj["t_hi"] = adj["t_lo"].clone()
    with torch.no_grad():
        zk, ak, sk, ck, *_ = tfs.run_exact_solve_kernel(TSIT5, spec, **kw)
        zp, ap, sp, cp, *_ = tfs.solve_train_exact_plain(TSIT5, spec, **kw)
        adj.update(zT=zp, accT=ap, dt_init=torch.tensor(-0.05, device=dev))
        out_k = tfs.run_exact_adjoint_kernel(TSIT5, spec, **adj)
        out_p = tfs.adjoint_train_exact_plain(TSIT5, spec, **adj)
        out_64 = _twin64(tfs.adjoint_train_exact_plain, spec, adj)
    assert (int(sk), int(ck)) == (int(sp), int(cp))
    if case == "single-sample":
        # With one sample the norm is 13,888 gradient entries of one
        # sample's products against 38 state entries, and the error
        # estimate of g sits at roundoff: the twin takes 18 steps in float32
        # and 16 in float64 (the kernel 20).  So the adjoint's counts are
        # held to that spread and its results to the float64 twin.
        spread = abs(int(out_p[5]) - int(out_64[5]))
        assert abs(int(out_k[5]) - int(out_p[5])) <= 2 * max(spread, 1)
        assert _close(zk, zp) and _close(ak, ap)
        for a, b in zip(out_k[3] + out_k[4], out_64[3] + out_64[4]):
            assert _grad_close(a.double(), b)
        return
    assert (int(out_k[5]), int(out_k[6])) == (int(out_p[5]), int(out_p[6]))
    if case == "cap":
        # As for K3: where a capped solve stops follows step sizes set by an
        # eest at f32 roundoff level, so only the counts are compared.
        assert int(sk) == 5 and int(out_k[5]) == 5
        assert torch.isfinite(zk).all() and all(torch.isfinite(g).all() for g in out_k[3] + out_k[4])
        return
    assert _close(zk, zp) and _close(ak, ap)
    assert all(_state_close(out_k[i], out_p[i], out_64[i]) for i in range(3))
    for a, b in zip(out_k[3] + out_k[4], out_p[3] + out_p[4]):
        assert _grad_close(a, b)
    if case == "empty-span":
        assert int(sk) == 0 and int(out_k[5]) == 0
        assert torch.equal(zk, kw["z0"]) and torch.equal(ak, kw["acc0"])
        assert all(float(g.abs().max()) == 0.0 for g in out_k[3] + out_k[4])


def test_exact_train_step_on_the_card_matches_the_twins_on_the_cpu(dev):
    """The exact fused TRAIN loss and gradient through the K4 forward and
    adjoint against the same step on the CPU, where the fused path runs the
    kernels' twins."""
    dims = (16, 48, 16)
    ps_np = _np_params(dims, 3)
    xs = np.random.default_rng(4).uniform(size=(512, 8)).astype(np.float32)

    def run(device):
        icnf = tcnf.construct(
            tcnf.RNODE, tcnf.MLP(dims, device=device), 8, 8, tspan=(0.0, 13.0), steer_rate=0.1,
            lam3=1e-2, compute_mode=tcnf.VecJacMode(fused=True, exact_trace=True),
        )
        ps = tcnf.params_from_numpy(ps_np, device)
        leaves = [x.requires_grad_() for p in ps for x in (p["w"], p["b"])]
        l, m = tcnf.loss_and_metrics(icnf, tcnf.Mode.TRAIN, xs, ps, steer_r=0.03)
        return l.detach().cpu(), [g.cpu() for g in torch.autograd.grad(l, leaves)], int(m["nfe"])

    n4 = (tfs.run_exact_solve_kernel.launches, tfs.run_exact_adjoint_kernel.launches)
    l_k, g_k, nfe_k = run(dev)
    assert (tfs.run_exact_solve_kernel.launches, tfs.run_exact_adjoint_kernel.launches) == (n4[0] + 1, n4[1] + 1)
    l_c, g_c, nfe_c = run(torch.device("cpu"))
    assert nfe_k == nfe_c and _close(l_k, l_c)
    for a, b in zip(g_k, g_c):
        assert _grad_close(a, b)


# ---- the chain kernels: 2, 3 and 4 layers ----

def _launches():
    return {name: w.launches for name, w in tfs.KERNEL_WRAPPERS.items()}


# The chain kernels' narrow and wide forms: (K1 chain form, K2 chain form,
# K7 TEST, K7 exact) wrappers and their KERNEL_WRAPPERS names.
_FORMS = {
    False: (("run_chain_train_solve_kernel", "run_chain_adjoint_kernel", "run_chain_test_solve_kernel",
             "run_chain_exact_solve_kernel"),
            {tfs.K1C_KERNEL, tfs.K2C_KERNEL, tfs.K7_KERNEL + "/test", tfs.K7_KERNEL + "/exact"}),
    True: (("run_wide_train_solve_kernel", "run_wide_adjoint_kernel", "run_wide_test_solve_kernel",
            "run_wide_exact_solve_kernel"),
           {tfs.K1W_KERNEL, tfs.K2W_KERNEL, tfs.K7W_KERNEL + "/test", tfs.K7W_KERNEL + "/exact"}),
    "stream": (("run_stream_train_solve_kernel", "run_stream_adjoint_kernel", "run_stream_test_solve_kernel",
                "run_stream_exact_solve_kernel"),
               {tfs.K1S_KERNEL, tfs.K2S_KERNEL, tfs.K7S_KERNEL + "/test", tfs.K7S_KERNEL + "/exact"}),
}


def _chain_case(dims, B, span, dev, norms=(True, True), seed=0, ys=None, wide=False):
    """All four chain kernels (their wide forms when `wide`, their streamed
    forms when it is "stream") against their
    twins on one input: the K1 chain form and K7 exact from nonzero
    accumulators, the K2 chain form from the K1 chain form's output
    warm-started from its last step, K7 TEST from a nonzero dlogp; a
    conditional chain (dims[0] > dims[-1]) with the conditioning ys
    (B, n_cond).  Returns the outputs, the K1 chain form's inputs and the K2
    chain form's."""
    (run1, run2, run7t, run7e), names = _FORMS[wide]
    run1, run2, run7t, run7e = (getattr(tfs, n) for n in (run1, run2, run7t, run7e))
    spec = tfs.chain_spec(tcnf.MLP(dims, device=dev), dims[-1])
    kw, adj = _train_args(dims, B, span, dev, seed)
    kw.update(norm_z=norms[0], norm_j=norms[1], ys=ys)
    adj.update(norm_z=norms[0], norm_j=norms[1], ys=ys)
    test_kw = dict(_kernel_args(dims, B, span, dev, seed), ys=ys)
    exact_kw = {k: v for k, v in kw.items() if k != "eps"}
    before = _launches()
    with torch.no_grad():
        out_k = run1(TSIT5, spec, **kw)
        out_p = tfs.solve_train_plain(TSIT5, spec, **kw)
        tdir = torch.sign(kw["t1"] - kw["t0"])
        adj.update(zT=out_k[0], accT=out_k[1], dt_init=-tdir * out_k[4].abs())
        adj_k = run2(TSIT5, spec, **adj)
        adj_p = tfs.adjoint_train_plain(TSIT5, spec, **adj)
        adj_64 = _twin64(tfs.adjoint_train_plain, spec, adj)
        test_k = run7t(TSIT5, spec, **test_kw)
        test_p = tfs.solve_test_plain(TSIT5, spec, **test_kw)
        ex_k = run7e(TSIT5, spec, **exact_kw)
        ex_p = tfs.solve_train_exact_plain(TSIT5, spec, **exact_kw)
    torch.cuda.synchronize()
    after = _launches()
    ran = {k for k in after if after[k] != before[k]}
    assert ran == names
    assert all(after[k] == before[k] + 1 for k in ran)
    return (out_k, out_p), (adj_k, adj_p, adj_64), (test_k, test_p), (ex_k, ex_p), kw, adj


def _hold_forward(out_k, out_p):
    """Equal steps; z and each accumulator row within REL."""
    assert (int(out_k[2]), int(out_k[3])) == (int(out_p[2]), int(out_p[3]))
    assert torch.isfinite(out_k[0]).all() and torch.isfinite(out_k[1]).all()
    assert _close(out_k[0], out_p[0])
    B = out_k[0].shape[0]
    assert all(_close(a, b) for a, b in zip(out_k[1].reshape(-1, B), out_p[1].reshape(-1, B)))


@pytest.mark.parametrize(
    "dims,B,span",
    [
        (POWER6, 4096, (0.0, 1.0)),
        (POWER6, 4096, (1.0, 0.0)),
        (POWER6, 37, (0.0, 1.0)),
        ((5, 9, 7, 5), 300, (0.0, 2.0)),
        ((6, 32, 32, 32, 6), 512, (0.0, 1.0)),
        ((16, 64, 64, 64, 16), 256, (0.0, 1.0)),
        ((32, 64, 64, 32), 128, (0.0, 1.0)),
        ((1, 64, 64, 1), 1000, (0.0, 1.0)),
        ((16, 48, 16), 4096, (0.0, 13.0)),
    ],
    ids=["power6-B4096", "power6-reverse", "power6-ragged-B37", "small-B300", "four-layer", "four-layer-dz16-w64",
         "dz32", "beta-shape", "two-layer-flagship"],
)
def test_chain_kernels_match_twins(dev, dims, B, span):
    (out_k, out_p), (adj_k, adj_p, adj_64), test, exact, _, _ = _chain_case(dims, B, span, dev)
    _hold_forward(out_k, out_p)
    _hold_forward(*test)
    _hold_forward(*exact)
    assert (int(adj_k[5]), int(adj_k[6])) == (int(adj_p[5]), int(adj_p[6]))
    for i in range(3):  # z0, acc0, a_z0
        assert _state_close(adj_k[i], adj_p[i], adj_64[i])
    for a, b in zip(adj_k[3] + adj_k[4], adj_p[3] + adj_p[4]):
        assert torch.isfinite(a).all() and _grad_close(a, b)


def test_chain_kernels_toy2d_with_both_norms_off(dev):
    """The toy2d shape MLP 2 -> 32 -> 32 -> 2 under FFJORD's rates (no
    kinetic-energy or Jacobian-norm rate)."""
    (out_k, out_p), (adj_k, adj_p, adj_64), test, exact, kw, _ = _chain_case(
        (2, 32, 32, 2), 2048, (0.0, 1.0), dev, norms=(False, False)
    )
    _hold_forward(out_k, out_p)
    _hold_forward(*test)
    _hold_forward(*exact)
    # Both norm rates are off: reg_e and reg_n keep their seeds exactly.
    for acc in (out_k[1], exact[0][1]):
        assert torch.equal(acc[1:], kw["acc0"][1:])
    assert (int(adj_k[5]), int(adj_k[6])) == (int(adj_p[5]), int(adj_p[6]))
    for a, b in zip(adj_k[3] + adj_k[4], adj_p[3] + adj_p[4]):
        assert _grad_close(a, b)


@pytest.mark.parametrize("case", ["cap", "single-sample"])
def test_chain_kernel_edge_cases_match_twins(dev, case):
    dims = POWER6
    spec = tfs.chain_spec(tcnf.MLP(dims, device=dev), dims[-1])
    kw, adj = _train_args(dims, 1 if case == "single-sample" else 64, (0.0, 1.0), dev)
    test_kw = _kernel_args(dims, 1 if case == "single-sample" else 64, (0.0, 1.0), dev)
    if case == "cap":
        kw["max_steps"] = adj["max_steps"] = test_kw["max_steps"] = 5
    exact_kw = {k: v for k, v in kw.items() if k != "eps"}
    with torch.no_grad():
        outs = [
            (tfs.run_chain_train_solve_kernel(TSIT5, spec, **kw), tfs.solve_train_plain(TSIT5, spec, **kw)),
            (tfs.run_chain_test_solve_kernel(TSIT5, spec, **test_kw), tfs.solve_test_plain(TSIT5, spec, **test_kw)),
            (tfs.run_chain_exact_solve_kernel(TSIT5, spec, **exact_kw),
             tfs.solve_train_exact_plain(TSIT5, spec, **exact_kw)),
        ]
        adj.update(zT=outs[0][1][0], accT=outs[0][1][1], dt_init=torch.tensor(-0.05, device=dev))
        adj_k = tfs.run_chain_adjoint_kernel(TSIT5, spec, **adj)
        adj_p = tfs.adjoint_train_plain(TSIT5, spec, **adj)
        adj_64 = _twin64(tfs.adjoint_train_plain, spec, adj)
    for k, p in outs:
        assert (int(k[2]), int(k[3])) == (int(p[2]), int(p[3]))
        if case == "cap":
            # Where a capped solve stops follows step sizes set by an eest at
            # f32 roundoff level, so only the counts are compared.
            assert int(k[2]) == 5 and torch.isfinite(k[0]).all() and torch.isfinite(k[1]).all()
        else:
            _hold_forward(k, p)
    if case == "cap":
        assert int(adj_k[5]) == 5 and all(torch.isfinite(g).all() for g in adj_k[3] + adj_k[4])
        return
    # One sample: the g error estimate sits at roundoff (PERF.md §6), so
    # the step count is held to the twin's own float32/float64 spread and
    # the gradients to the float64 twin.
    spread = abs(int(adj_p[5]) - int(adj_64[5]))
    assert abs(int(adj_k[5]) - int(adj_p[5])) <= 2 * max(spread, 1)
    for a, b in zip(adj_k[3] + adj_k[4], adj_64[3] + adj_64[4]):
        assert _grad_close(a.double(), b)


def test_chain_paths_on_the_card_match_the_twins_on_the_cpu(dev):
    """The power6 model on the card and on the CPU: logpdf through K7 TEST,
    the Hutchinson loss and gradient through the K1 and K2 chain forms, and
    the exact loss and gradient through K7 exact and the plain backward."""
    xs = np.random.default_rng(4).normal(size=(512, 6)).astype(np.float32)
    eps = np.random.default_rng(5).normal(size=(1, 512, 6)).astype(np.float32)
    ps_np = _np_params(POWER6, 3)

    def run(device, exact):
        icnf = tcnf.construct(tcnf.RNODE, tcnf.MLP(POWER6, device=device), 6,
                              compute_mode=tcnf.VecJacMode(fused=True, exact_trace=exact))
        ps = tcnf.params_from_numpy(ps_np, device)
        with torch.no_grad():
            lp = tcnf.ICNFDist(icnf, tcnf.Mode.TEST, ps).logpdf(xs)
        leaves = [x.requires_grad_() for p in ps for x in (p["w"], p["b"])]
        kw = {} if exact else {"eps": eps}
        l, m = tcnf.loss_and_metrics(icnf, tcnf.Mode.TRAIN, xs, ps, **kw)
        return lp.cpu(), l.detach().cpu(), [g.cpu() for g in torch.autograd.grad(l, leaves)], int(m["nfe"])

    for exact in (False, True):
        before = _launches()
        lp_k, l_k, g_k, nfe_k = run(dev, exact)
        after = _launches()
        ran = {k for k in after if after[k] != before[k]}
        want = {tfs.K7_KERNEL + "/test"} | ({tfs.K7_KERNEL + "/exact"} if exact else {tfs.K1C_KERNEL, tfs.K2C_KERNEL})
        assert ran == want
        lp_c, l_c, g_c, nfe_c = run(torch.device("cpu"), exact)
        assert nfe_k == nfe_c and _close(lp_k, lp_c) and _close(l_k, l_c)
        for a, b in zip(g_k, g_c):
            assert _grad_close(a, b)


# ---- the chain kernels' wide forms ----

MINIBOONE = (43, 128, 128, 43)


@pytest.mark.parametrize(
    "dims,B,span",
    [
        (MINIBOONE, 256, (0.0, 1.0)),
        (MINIBOONE, 2048, (0.0, 1.0)),
        (MINIBOONE, 37, (1.0, 0.0)),
        ((40, 48, 40), 300, (0.0, 2.0)),
        ((6, 96, 80, 32, 6), 128, (0.0, 1.0)),
        (POWER6, 256, (0.0, 1.0)),
    ],
    ids=["miniboone-B256", "miniboone-B2048", "miniboone-reverse-B37", "two-layer-dz40", "four-layer-w96",
         "power6-through-the-wide-forms"],
)
def test_wide_chain_kernels_match_twins(dev, dims, B, span):
    """The wide forms of the K1 and K2 chain forms and of K7 TEST and exact
    against their twins, as the narrow forms are held."""
    (out_k, out_p), (adj_k, adj_p, adj_64), test, exact, _, _ = _chain_case(dims, B, span, dev, wide=True)
    _hold_forward(out_k, out_p)
    _hold_forward(*test)
    _hold_forward(*exact)
    assert (int(adj_k[5]), int(adj_k[6])) == (int(adj_p[5]), int(adj_p[6]))
    for i in range(3):  # z0, acc0, a_z0
        assert _state_close(adj_k[i], adj_p[i], adj_64[i])
    for a, b in zip(adj_k[3] + adj_k[4], adj_p[3] + adj_p[4]):
        assert torch.isfinite(a).all() and _grad_close(a, b)


@pytest.mark.parametrize(
    "dims,wrapper",
    [
        (MINIBOONE, "run_chain_test_solve_kernel"),
        ((6, 65, 64, 6), "run_chain_test_solve_kernel"),
        ((65, 128, 128, 65), "run_wide_test_solve_kernel"),
        ((43, 129, 128, 43), "run_wide_test_solve_kernel"),
        ((43,) + (64,) * 8 + (43,), "run_wide_test_solve_kernel"),
    ],
    ids=["narrow-form-miniboone", "narrow-form-hidden65", "wide-dz65", "wide-hidden129", "wide-five-layer"],
)
def test_wide_limits_raise_on_cuda(dev, dims, wrapper):
    """The narrow forms refuse the wide chains, the wide forms what is past
    their widths or depth (the "wide-five-layer" case holds a 9-layer chain:
    5-layer chains run since shape variants (b)); nothing is launched."""
    spec = tfs.chain_spec(tcnf.MLP(dims), dims[-1])
    kw = _kernel_args(dims, 8, (0.0, 1.0), dev)
    run = getattr(tfs, wrapper)
    before = run.launches
    with pytest.raises(NotImplementedError):
        run(TSIT5, spec, **kw)
    assert run.launches == before


def test_wide_paths_on_the_card_match_the_twins_on_the_cpu(dev):
    """The MINIBOONE model on the card and on the CPU at B = 256: logpdf
    through wide K7 TEST, the Hutchinson loss and gradient through the wide
    K1 and K2 chain forms, and the exact loss and gradient through wide K7
    exact and the plain backward; no narrow chain kernel is launched."""
    xs = np.random.default_rng(4).normal(size=(256, 43)).astype(np.float32)
    eps = np.random.default_rng(5).normal(size=(1, 256, 43)).astype(np.float32)
    ps_np = _np_params(MINIBOONE, 3)

    def run(device, exact):
        icnf = tcnf.construct(tcnf.RNODE, tcnf.MLP(MINIBOONE, device=device), 43,
                              compute_mode=tcnf.VecJacMode(fused=True, exact_trace=exact))
        ps = tcnf.params_from_numpy(ps_np, device)
        with torch.no_grad():
            lp = tcnf.ICNFDist(icnf, tcnf.Mode.TEST, ps).logpdf(xs)
        leaves = [x.requires_grad_() for p in ps for x in (p["w"], p["b"])]
        kw = {} if exact else {"eps": eps}
        l, m = tcnf.loss_and_metrics(icnf, tcnf.Mode.TRAIN, xs, ps, **kw)
        return lp.cpu(), l.detach().cpu(), [g.cpu() for g in torch.autograd.grad(l, leaves)], int(m["nfe"])

    for exact in (False, True):
        before = _launches()
        lp_k, l_k, g_k, nfe_k = run(dev, exact)
        after = _launches()
        ran = {k for k in after if after[k] != before[k]}
        want = {tfs.K7W_KERNEL + "/test"} | ({tfs.K7W_KERNEL + "/exact"} if exact else {tfs.K1W_KERNEL, tfs.K2W_KERNEL})
        assert ran == want
        lp_c, l_c, g_c, nfe_c = run(torch.device("cpu"), exact)
        assert nfe_k == nfe_c and _close(lp_k, lp_c) and _close(l_k, l_c)
        for a, b in zip(g_k, g_c):
            assert _grad_close(a, b)


# ---- the chain kernels' streamed forms (weights past shared memory) ----

MINIBOONE860 = (43, 860, 860, 43)


@pytest.mark.parametrize(
    "dims,B,span",
    [
        (MINIBOONE860, 1024, (0.0, 1.0)),
        (MINIBOONE860, 37, (1.0, 0.0)),
        ((6, 160, 160, 6), 300, (0.0, 1.0)),
        ((64, 128, 128, 128, 64), 128, (0.0, 1.0)),
        ((40, 160, 40), 64, (0.0, 2.0)),
        ((8, 2500, 2500, 8), 64, (0.0, 1.0)),
    ],
    ids=["miniboone860-B1024", "miniboone860-reverse-B37", "hidden160-B300", "four-layer-past-shared-memory",
         "two-layer-hidden160", "hidden2500-global-tiles"],
)
def test_stream_chain_kernels_match_twins(dev, dims, B, span):
    """The streamed forms of the K1 and K2 chain forms and of K7 TEST and
    exact against their twins, as the wide forms are held (the last case's
    tile arrays of K2 and K7 pass shared memory and go to global
    scratch)."""
    (out_k, out_p), (adj_k, adj_p, adj_64), test, exact, _, _ = _chain_case(dims, B, span, dev, wide="stream")
    _hold_forward(out_k, out_p)
    _hold_forward(*test)
    _hold_forward(*exact)
    assert (int(adj_k[5]), int(adj_k[6])) == (int(adj_p[5]), int(adj_p[6]))
    for i in range(3):  # z0, acc0, a_z0
        assert _state_close(adj_k[i], adj_p[i], adj_64[i])
    for a, b in zip(adj_k[3] + adj_k[4], adj_p[3] + adj_p[4]):
        assert torch.isfinite(a).all() and _grad_close(a, b)


@pytest.mark.parametrize(
    "dims,wrapper,kind",
    [
        (MINIBOONE860, "run_wide_train_solve_kernel", "two-probes"),
        (MINIBOONE860, "run_wide_train_solve_kernel", "jvp"),
        ((64, 128, 128, 120, 64), "run_wide_train_solve_kernel", "two-probes"),
        ((64, 128, 128, 120, 64), "run_stream_train_solve_kernel", "train"),
        (MINIBOONE, "run_stream_train_solve_kernel", "two-probes"),
        (MINIBOONE, "run_stream_test_solve_kernel", "test"),
        (MINIBOONE860, "run_wide_test_solve_kernel", "test"),
        ((40, 160, 40), "run_wide_test_adjoint_kernel", "test-adjoint"),
    ],
    ids=["wide-two-probes-miniboone860", "wide-jvp-miniboone860", "wide-two-probes-probe-only",
         "stream-one-probe-probe-only", "stream-two-probes-miniboone43", "stream-form-miniboone43",
         "wide-form-miniboone860", "two-layer-test-adjoint-hidden160"],
)
def test_stream_limits_raise_on_cuda(dev, dims, wrapper, kind):
    """The streamed forms take only the chains the wide forms refuse (with K
    probes or JVP, those the wide probe instances refuse: the one-probe
    solve of such a chain stays on the wide forms); the wide forms refuse
    the streamed chains, and with probes the chains only the streamed probe
    instances keep; wide K5 refuses a 2-layer net past hidden 128 (streamed
    K5 takes it).  Nothing is launched."""
    spec = tfs.chain_spec(tcnf.MLP(dims), dims[-1])
    kw = _kernel_args(dims, 8, (0.0, 1.0), dev)
    dz = dims[-1]
    if kind in ("train", "two-probes", "jvp"):
        kw = {k: v for k, v in kw.items() if k != "dlogp0"}
        kw.update(norm_z=True, norm_j=True, acc0=torch.zeros((3, 8), device=dev),
                  eps=torch.ones((2 if kind == "two-probes" else 1, 8, dz), device=dev), jvp=kind == "jvp")
    elif kind == "test-adjoint":
        z = kw["z0"]
        acc = torch.zeros((1, 8), device=dev)
        kw = {k: kw[k] for k in ("rtol", "atol", "max_steps", "ws", "bs")}
        kw.update(zT=z, accT=acc, azT=z, aaccT=acc, t_hi=torch.tensor(1.0, device=dev),
                  t_lo=torch.tensor(0.0, device=dev), dt_init=torch.tensor(-0.05, device=dev))
    run = getattr(tfs, wrapper)
    before = _launches()
    with pytest.raises(NotImplementedError):
        run(TSIT5, spec, **kw)
    assert _launches() == before


def test_stream_paths_on_the_card_match_the_twins_on_the_cpu(dev):
    """FFJORD's MINIBOONE widths (miniboone860) on the card and on the CPU at
    B = 64: logpdf through streamed K7 TEST, the Hutchinson loss and
    gradient through the streamed K1 and K2 chain forms, and the exact loss
    and gradient through streamed K7 exact and the plain backward; no other
    chain kernel is launched.  Where the card's and the CPU's solves take
    equal steps they agree within REL (GRAD_REL for the gradients).  This
    input's Hutchinson forward starts from a small Hairer step with zero
    accumulators, whose error scale is then rtol times a rate times dt, the
    order of the roundoff of the btilde sums: on an NVIDIA H100 the kernel,
    its twin on the card and its twin on the CPU take 14, 12 and 13
    attempted steps on the same arguments (the float64 twin 12), and the
    kernel 13 with its first step moved by 1e-6.  Where the counts differ, both paths are held as
    `chip_smoke.py` holds the training paths: losses within 1e-4 of each
    other, each gradient within 2e-2 max|g| of a float64 rtol 1e-7 solve
    (the plain path on the card), logpdf within 1e-4 of it."""
    xs = np.random.default_rng(4).normal(size=(64, 43)).astype(np.float32)
    eps = np.random.default_rng(5).normal(size=(1, 64, 43)).astype(np.float32)
    ps_np = _np_params(MINIBOONE860, 3)

    def run(device, exact, fused=True, dtype=torch.float32, solver=None):
        kw = {} if solver is None else {"solver": solver}
        icnf = tcnf.construct(tcnf.RNODE, tcnf.MLP(MINIBOONE860, device=device, dtype=dtype), 43, dtype=dtype,
                              compute_mode=tcnf.VecJacMode(fused=fused, exact_trace=exact), **kw)
        leaves = [v.to(dtype).requires_grad_() for p in tcnf.params_from_numpy(ps_np, device) for v in (p["w"], p["b"])]
        ps = tuple({"w": w, "b": b} for w, b in zip(leaves[::2], leaves[1::2]))
        x = torch.from_numpy(xs).to(device=device, dtype=dtype)
        with torch.no_grad():
            lp, _, st = tcnf.inference(icnf, tcnf.Mode.TEST, x, ps)
        kw = {} if exact else {"eps": torch.from_numpy(eps).to(device=device, dtype=dtype)}
        l, m = tcnf.loss_and_metrics(icnf, tcnf.Mode.TRAIN, x, ps, **kw)
        grads = [g.cpu().float() for g in torch.autograd.grad(l, leaves)]
        return lp.cpu().float(), int(st.nfe), l.detach().cpu().float(), grads, int(m["nfe"])

    for exact in (False, True):
        before = _launches()
        lp_k, tnfe_k, l_k, g_k, nfe_k = run(dev, exact)
        after = _launches()
        ran = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        want = {tfs.K7S_KERNEL + "/test": 1}
        want.update({tfs.K7S_KERNEL + "/exact": 1} if exact else {tfs.K1S_KERNEL: 1, tfs.K2S_KERNEL: 1})
        assert ran == want
        lp_c, tnfe_c, l_c, g_c, nfe_c = run(torch.device("cpu"), exact)
        truth = None
        if (tnfe_k, nfe_k) != (tnfe_c, nfe_c):
            truth = run(dev, exact, fused=False, dtype=torch.float64, solver=tcnf.SolverOptions(rtol=1e-7, atol=1e-9))
        if tnfe_k == tnfe_c:
            assert _close(lp_k, lp_c)
        else:
            assert _close(lp_k, truth[0]) and _close(lp_c, truth[0])
        if nfe_k == nfe_c:
            assert _close(l_k, l_c)
            for a, b in zip(g_k, g_c):
                assert _grad_close(a, b)
        else:
            assert float((l_k - l_c).abs()) <= 1e-4 * max(1.0, float(l_c.abs()))
            for a, b, t in zip(g_k, g_c, truth[3]):
                bound = 2e-2 * float(t.abs().max())
                assert float((a - t).abs().max()) <= bound and float((b - t).abs().max()) <= bound


# ---- the 2-layer kernels' wide forms (2-layer tanh nets past dz 32) ----

HEPMASS = (42, 126, 42)


@pytest.mark.parametrize(
    "dims,B,span",
    [
        (HEPMASS, 4096, (0.0, 13.0)),
        (HEPMASS, 37, (13.0, 0.0)),
        ((40, 48, 40), 300, (0.0, 2.0)),
        ((64, 128, 64), 256, (0.0, 1.0)),
        ((33, 99, 33), 1, (0.0, 1.0)),
    ],
    ids=["hepmass42-B4096", "hepmass42-reverse-B37", "dz40-B300", "dz64-hidden128", "dz33-B1"],
)
def test_wide_two_layer_kernels_match_twins(dev, dims, B, span):
    """Wide K3 against `solve_test_plain` from a nonzero dlogp (equal steps,
    values within REL), wide K5 against `adjoint_test_plain` from its output
    and the wide K4 adjoint against `adjoint_train_exact_plain` from the
    exact forward's twin, each warm-started from its forward's last step:
    equal steps, z0, acc0 and a_z0 held to the float64 twin
    (`_state_close`), finite gradients within GRAD_REL.  One launch each."""
    spec = tfs.chain_spec(tcnf.MLP(dims, device=dev), dims[-1])
    kw = _kernel_args(dims, B, span, dev)
    dz = dims[-1]
    rng = np.random.default_rng(11)
    T = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    runs = (tfs.run_wide_test2_solve_kernel, tfs.run_wide_test_adjoint_kernel, tfs.run_wide_exact_adjoint_kernel)
    before = [w.launches for w in runs]
    tdir = 1.0 if span[1] > span[0] else -1.0
    base = {k: kw[k] for k in ("rtol", "atol", "max_steps", "ws", "bs")}
    with torch.no_grad():
        out_k = tfs.run_wide_test2_solve_kernel(TSIT5, spec, **kw)
        out_p = tfs.solve_test_plain(TSIT5, spec, **kw)
        test_adj = dict(base, zT=out_p[0], accT=out_p[1][None], azT=T(rng.normal(0.0, 1.0 / B, (B, dz))),
                        aaccT=T(np.full((1, B), 1.0 / B)), t_hi=kw["t1"], t_lo=kw["t0"], dt_init=-tdir * out_p[4].abs())
        k5 = [tfs.run_wide_test_adjoint_kernel(TSIT5, spec, **test_adj), tfs.adjoint_test_plain(TSIT5, spec, **test_adj),
              _twin64(tfs.adjoint_test_plain, spec, test_adj)]
        ex = dict(base, norm_z=True, norm_j=True, z0=kw["z0"], acc0=T(rng.normal(0.0, 0.5, (3, B))), t0=kw["t0"],
                  t1=kw["t1"], dt_init=kw["dt_init"])
        fo = tfs.solve_train_exact_plain(TSIT5, spec, **ex)
        ex_adj = dict(base, norm_z=True, norm_j=True, zT=fo[0], accT=fo[1], azT=T(rng.normal(0.0, 1.0 / B, (B, dz))),
                      aaccT=T(rng.normal(0.0, 1.0 / B, (3, B))), t_hi=kw["t1"], t_lo=kw["t0"],
                      dt_init=-tdir * fo[4].abs())
        k4 = [tfs.run_wide_exact_adjoint_kernel(TSIT5, spec, **ex_adj),
              tfs.adjoint_train_exact_plain(TSIT5, spec, **ex_adj), _twin64(tfs.adjoint_train_exact_plain, spec, ex_adj)]
    torch.cuda.synchronize()
    assert [w.launches for w in runs] == [n + 1 for n in before]
    _hold_forward(out_k, out_p)
    for adj_k, adj_p, adj_64 in (k5, k4):
        assert (int(adj_k[5]), int(adj_k[6])) == (int(adj_p[5]), int(adj_p[6]))
        for i in range(3):  # z0, acc0, a_z0
            assert _state_close(adj_k[i], adj_p[i], adj_64[i])
        for a, b in zip(adj_k[3] + adj_k[4], adj_p[3] + adj_p[4]):
            assert torch.isfinite(a).all() and _grad_close(a, b)


def test_wide_two_layer_paths_on_the_card_match_the_twins_on_the_cpu(dev):
    """The hepmass42 model (RNODE, nvars = naug = 21, MLP 42 -> 126 -> 42,
    steer_rate 0.1; tspan (0, 1) here) on the card and on the CPU at
    B = 256: logpdf through wide K3; the TEST loss gradient through wide K3
    and wide K5; the Hutchinson loss and gradient through the wide K1 and K2
    chain forms; the exact one through wide K7 exact and the wide K4
    adjoint; each launching those kernels once and no other."""
    xs = np.random.default_rng(4).normal(size=(256, 21)).astype(np.float32)
    eps = np.random.default_rng(5).normal(size=(1, 256, 42)).astype(np.float32)
    ps_np = _np_params(HEPMASS, 3)

    def run(device, mode):
        icnf = tcnf.construct(tcnf.RNODE, tcnf.MLP(HEPMASS, device=device), 21, 21, tspan=(0.0, 1.0), steer_rate=0.1,
                              lam3=1e-2, compute_mode=tcnf.VecJacMode(fused=True, exact_trace=mode == "exact"))
        ps = tcnf.params_from_numpy(ps_np, device)
        leaves = [x.requires_grad_() for p in ps for x in (p["w"], p["b"])]
        if mode == "test":
            with torch.no_grad():
                lp = tcnf.ICNFDist(icnf, tcnf.Mode.TEST, ps).logpdf(xs)
            l = tcnf.loss(icnf, tcnf.Mode.TEST, xs, ps)
            return lp.cpu(), l.detach().cpu(), [g.cpu() for g in torch.autograd.grad(l, leaves)]
        kw = {"steer_r": 0.05} if mode == "exact" else {"eps": eps, "steer_r": 0.05}
        l = tcnf.loss(icnf, tcnf.Mode.TRAIN, xs, ps, **kw)
        return None, l.detach().cpu(), [g.cpu() for g in torch.autograd.grad(l, leaves)]

    wants = {"test": {tfs.K3W_KERNEL: 2, tfs.K5W_KERNEL: 1}, "train": {tfs.K1W_KERNEL: 1, tfs.K2W_KERNEL: 1},
             "exact": {tfs.K7W_KERNEL + "/exact": 1, tfs.K4WA_KERNEL: 1}}
    for mode, want in wants.items():
        before = _launches()
        lp_k, l_k, g_k = run(dev, mode)
        after = _launches()
        assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == want
        lp_c, l_c, g_c = run(torch.device("cpu"), mode)
        assert _close(l_k, l_c) and (lp_k is None or _close(lp_k, lp_c))
        for a, b in zip(g_k, g_c):
            assert _grad_close(a, b)


# ---- the COND instances of the wide forms (K8: conditional nets past the narrow widths) ----

COND_HEPMASS = (43, 126, 42)


def _cond_ys(B, nc, dev, seed=12):
    return torch.from_numpy(np.random.default_rng(seed).uniform(-1.0, 1.0, (B, nc)).astype(np.float32)).to(dev)


def _hold_cond_adjoint(adj_k, adj_p, adj_64):
    """Equal steps; z0, acc0, a_z0 and a_ys0 held to the float64 twin
    (`_state_close`); finite gradients within GRAD_REL."""
    assert len(adj_k) == len(adj_p) == 8
    assert (int(adj_k[5]), int(adj_k[6])) == (int(adj_p[5]), int(adj_p[6]))
    for i in (0, 1, 2, 7):  # z0, acc0, a_z0, a_ys0
        assert torch.isfinite(adj_k[i]).all() and _state_close(adj_k[i], adj_p[i], adj_64[i])
    for a, b in zip(adj_k[3] + adj_k[4], adj_p[3] + adj_p[4]):
        assert torch.isfinite(a).all() and _grad_close(a, b)


@pytest.mark.parametrize(
    "dims,B,span",
    [
        (COND_HEPMASS, 4096, (0.0, 13.0)),
        ((35, 72, 34), 37, (2.0, 0.0)),
        ((10, 72, 72, 8), 300, (0.0, 2.0)),
        ((36, 40, 33), 1, (0.0, 1.0)),
        ((10, 72, 72, 72, 72, 8), 256, (0.0, 1.0)),
    ],
    ids=["cond-hepmass42-B4096", "two-layer-reverse-B37", "three-layer-ncond2-B300", "ncond3-B1",
         "five-layer-ncond2-B256"],
)
def test_wide_cond_kernels_match_twins(dev, dims, B, span):
    """The COND instances of the wide K1 and K2 chain forms (and, for 2-layer
    nets, of wide K3 and wide K5) against their twins with the conditioning
    ys (B, n_cond): the forwards from nonzero accumulators (equal steps,
    values within REL), the adjoints from their forward's output
    warm-started from its last step (equal steps; z0, acc0, a_z0 and a_ys0
    held to the float64 twin; gradients within GRAD_REL).  One launch
    each."""
    spec = tfs.chain_spec(tcnf.MLP(dims, device=dev), dims[-1])
    nc, dz = dims[0] - dims[-1], dims[-1]
    ys = _cond_ys(B, nc, dev)
    kw, adj = _train_args(dims, B, span, dev)
    kw["ys"], adj["ys"] = ys, ys
    two = len(dims) == 3
    runs = [tfs.run_wide_cond_train_solve_kernel, tfs.run_wide_cond_adjoint_kernel]
    if two:
        runs += [tfs.run_wide_cond_test2_solve_kernel, tfs.run_wide_cond_test_adjoint_kernel]
    before = [w.launches for w in runs]
    tdir = 1.0 if span[1] > span[0] else -1.0
    rng = np.random.default_rng(13)
    T = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    with torch.no_grad():
        out_k = tfs.run_wide_cond_train_solve_kernel(TSIT5, spec, **kw)
        out_p = tfs.solve_train_plain(TSIT5, spec, **kw)
        adj.update(zT=out_k[0], accT=out_k[1], dt_init=-tdir * out_k[4].abs())
        k2 = [tfs.run_wide_cond_adjoint_kernel(TSIT5, spec, **adj), tfs.adjoint_train_plain(TSIT5, spec, **adj),
              _twin64(tfs.adjoint_train_plain, spec, adj)]
        if two:
            test_kw = dict(_kernel_args(dims, B, span, dev), ys=ys)
            t_k = tfs.run_wide_cond_test2_solve_kernel(TSIT5, spec, **test_kw)
            t_p = tfs.solve_test_plain(TSIT5, spec, **test_kw)
            test_adj = dict({k: test_kw[k] for k in ("rtol", "atol", "max_steps", "ws", "bs", "ys")}, zT=t_p[0],
                            accT=t_p[1][None], azT=T(rng.normal(0.0, 1.0 / B, (B, dz))),
                            aaccT=T(np.full((1, B), 1.0 / B)), t_hi=test_kw["t1"], t_lo=test_kw["t0"],
                            dt_init=-tdir * t_p[4].abs())
            k5 = [tfs.run_wide_cond_test_adjoint_kernel(TSIT5, spec, **test_adj),
                  tfs.adjoint_test_plain(TSIT5, spec, **test_adj), _twin64(tfs.adjoint_test_plain, spec, test_adj)]
    torch.cuda.synchronize()
    assert [w.launches for w in runs] == [n + 1 for n in before]
    _hold_forward(out_k, out_p)
    _hold_cond_adjoint(*k2)
    if two:
        _hold_forward(t_k, t_p)
        _hold_cond_adjoint(*k5)


def test_wide_cond_paths_on_the_card_match_the_twins_on_the_cpu(dev):
    """cond_hepmass42 (CondRNODE, nvars = naug = 21, MLP 43 -> 126 -> 42 on
    [z | ys], steer_rate 0.1; tspan (0, 1) here) on the card and on the CPU
    at B = 256: `CondICNFDist.logpdf` through wide K3's COND instance; the
    TEST loss gradient in the params and ys through wide K3's and wide K5's;
    the Hutchinson loss gradient through the wide K1 and K2 chain forms';
    the exact one through wide K7 exact's and the wide K4 adjoint's; each
    launching those kernels and no other."""
    rng = np.random.default_rng(4)
    xs = rng.normal(size=(256, 21)).astype(np.float32)
    ys = rng.choice([-1.414, -0.707, 0.0, 0.707, 1.414], size=(256, 1)).astype(np.float32)
    eps = np.random.default_rng(5).normal(size=(1, 256, 42)).astype(np.float32)
    ps_np = _np_params(COND_HEPMASS, 3)

    def run(device, mode):
        icnf = tcnf.construct(tcnf.CondRNODE, tcnf.MLP(COND_HEPMASS, device=device), 21, 21, tspan=(0.0, 1.0),
                              steer_rate=0.1, lam3=1e-2,
                              compute_mode=tcnf.VecJacMode(fused=True, exact_trace=mode == "exact"))
        ps = tcnf.params_from_numpy(ps_np, device)
        y = torch.from_numpy(ys).to(device).requires_grad_()
        leaves = [x.requires_grad_() for p in ps for x in (p["w"], p["b"])] + [y]
        lp = None
        if mode == "test":
            with torch.no_grad():
                lp = tcnf.CondICNFDist(icnf, tcnf.Mode.TEST, ps, y.detach()).logpdf(xs).cpu()
            l = tcnf.loss(icnf, tcnf.Mode.TEST, xs, ps, ys=y)
        elif mode == "exact":
            l = tcnf.loss(icnf, tcnf.Mode.TRAIN, xs, ps, ys=y, steer_r=0.05)
        else:
            l = tcnf.loss(icnf, tcnf.Mode.TRAIN, xs, ps, ys=y, eps=eps, steer_r=0.05)
        return lp, l.detach().cpu(), [g.cpu() for g in torch.autograd.grad(l, leaves)]

    wants = {"test": {tfs.K3W_KERNEL + "/cond": 2, tfs.K5W_KERNEL + "/cond": 1},
             "train": {tfs.K1W_KERNEL + "/cond": 1, tfs.K2W_KERNEL + "/cond": 1},
             "exact": {tfs.K7W_KERNEL + "/exact/cond": 1, tfs.K4WA_KERNEL + "/cond": 1}}
    for mode, want in wants.items():
        before = _launches()
        lp_k, l_k, g_k = run(dev, mode)
        after = _launches()
        assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == want
        lp_c, l_c, g_c = run(torch.device("cpu"), mode)
        assert _close(l_k, l_c) and (lp_k is None or _close(lp_k, lp_c))
        for a, b in zip(g_k, g_c):
            assert _grad_close(a, b)


@pytest.mark.parametrize(
    "dims,B,span",
    [
        (COND_HEPMASS, 4096, (0.0, 13.0)),
        ((35, 72, 34), 37, (2.0, 0.0)),
        ((10, 72, 72, 8), 300, (0.0, 2.0)),
        ((44, 128, 128, 43), 2048, (0.0, 1.0)),
        ((36, 40, 33), 1, (0.0, 1.0)),
    ],
    ids=["cond-hepmass42-B4096", "two-layer-reverse-B37", "three-layer-ncond2-B300", "three-layer-hidden128-B2048",
         "ncond3-B1"],
)
def test_wide_cond_k7_and_k4_kernels_match_twins(dev, dims, B, span):
    """The COND instances of wide K7 TEST and wide K7 exact (and, for 2-layer
    nets, of the wide K4 adjoint) against their twins with the conditioning
    ys (B, n_cond): the forwards from nonzero accumulators (equal steps,
    values within REL), the adjoint from wide K7 exact COND's output
    warm-started from its last step (equal steps; z0, acc0, a_z0 and a_ys0
    held to the float64 twin; gradients within GRAD_REL, W1's ys rows not
    zero).  One launch each."""
    spec = tfs.chain_spec(tcnf.MLP(dims, device=dev), dims[-1])
    nc, dz = dims[0] - dims[-1], dims[-1]
    ys = _cond_ys(B, nc, dev)
    kw, adj = _train_args(dims, B, span, dev)
    exact_kw = dict({k: v for k, v in kw.items() if k != "eps"}, ys=ys)
    test_kw = dict(_kernel_args(dims, B, span, dev), ys=ys)
    two = len(dims) == 3
    runs = [tfs.run_wide_cond_test_solve_kernel, tfs.run_wide_cond_exact_solve_kernel]
    if two:
        runs.append(tfs.run_wide_cond_exact_adjoint_kernel)
    before = [w.launches for w in runs]
    tdir = 1.0 if span[1] > span[0] else -1.0
    with torch.no_grad():
        t_k = tfs.run_wide_cond_test_solve_kernel(TSIT5, spec, **test_kw)
        t_p = tfs.solve_test_plain(TSIT5, spec, **test_kw)
        e_k = tfs.run_wide_cond_exact_solve_kernel(TSIT5, spec, **exact_kw)
        e_p = tfs.solve_train_exact_plain(TSIT5, spec, **exact_kw)
        if two:
            adj = dict({k: v for k, v in adj.items() if k != "eps"}, zT=e_k[0], accT=e_k[1],
                       dt_init=-tdir * e_k[4].abs(), ys=ys)
            k4 = [tfs.run_wide_cond_exact_adjoint_kernel(TSIT5, spec, **adj),
                  tfs.adjoint_train_exact_plain(TSIT5, spec, **adj), _twin64(tfs.adjoint_train_exact_plain, spec, adj)]
    torch.cuda.synchronize()
    assert [w.launches for w in runs] == [n + 1 for n in before]
    _hold_forward(t_k, t_p)
    _hold_forward(e_k, e_p)
    if two:
        _hold_cond_adjoint(*k4)
        assert float(k4[0][3][0][dz:].abs().max()) > 0.0


def test_wide_cond_chain_paths_on_the_card_match_the_twins_on_the_cpu(dev):
    """A conditional 3-layer chain past hidden 64 (CondRNODE, MLP 44 -> 128
    -> 128 -> 43, one ys column, nvars 43; tspan (0, 1)) on the card and on
    the CPU at B = 256: `CondICNFDist.logpdf` and `sample` (the base draw
    injected) through wide K7 TEST's COND instance; the exact loss gradient
    in the params and ys through wide K7 exact's and the plain BACKSOLVE;
    each launching that kernel once and no other."""
    dims, B = (44, 128, 128, 43), 256
    rng = np.random.default_rng(6)
    xs = rng.normal(size=(B, 43)).astype(np.float32)
    ys = rng.uniform(-1.0, 1.0, (B, 1)).astype(np.float32)
    z1 = rng.normal(size=(B, 43)).astype(np.float32)
    ps_np = _np_params(dims, 7)

    def run(device, mode):
        icnf = tcnf.construct(tcnf.CondRNODE, tcnf.MLP(dims, device=device), 43, 0, tspan=(0.0, 1.0),
                              compute_mode=tcnf.VecJacMode(fused=True, exact_trace=mode == "exact"))
        ps = tcnf.params_from_numpy(ps_np, device)
        y = torch.from_numpy(ys).to(device)
        if mode == "test":
            d = tcnf.CondICNFDist(icnf, tcnf.Mode.TEST, ps, y)
            with torch.no_grad():
                return [d.logpdf(xs).cpu(), d.sample(B, z1=z1).cpu()]
        y.requires_grad_()
        leaves = [x.requires_grad_() for p in ps for x in (p["w"], p["b"])] + [y]
        l = tcnf.loss(icnf, tcnf.Mode.TRAIN, xs, ps, ys=y, steer_r=0.05)
        return [l.detach().cpu()] + [g.cpu() for g in torch.autograd.grad(l, leaves)]

    wants = {"test": {tfs.K7W_KERNEL + "/test/cond": 2}, "exact": {tfs.K7W_KERNEL + "/exact/cond": 1}}
    for mode, want in wants.items():
        before = _launches()
        got = run(dev, mode)
        after = _launches()
        assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == want
        ref = run(torch.device("cpu"), mode)
        close = _close if mode == "test" else _grad_close
        assert all(torch.isfinite(a).all() and close(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize(
    "case",
    ["streamed", "unconditional-instance", "unconditional-K7", "unconditional-K4", "K4-hidden130",
     "probe-shared-memory"],
)
def test_wide_cond_refusals_raise_on_cuda(dev, case):
    """What the kernels refuse of conditional nets past the narrow widths
    raises on the card, naming its ROADMAP row or the instance that takes
    it, and launches nothing: the wide K1 chain form's COND instance takes
    no chain whose wide probe COND instance's shared memory it passes with
    K probes ("probe-shared-memory": the streamed probe COND instance, row
    (d6), then runs it, one launch); the unconditional wide K1 chain form,
    wide K7 and the wide K4 adjoint take no conditional net, nor the
    unconditional streamed K7 and streamed K4 adjoint the deep chain's TEST
    forward at the miniboone860 width or the exact backward past hidden 128
    ("streamed", "K4-hidden130"), which their COND instances (row (d5)) then
    run, one launch each."""
    dims = {"streamed": (44, 860, 860, 43), "unconditional-K7": (10, 72, 72, 8),
            "K4-hidden130": (44, 130, 43), "probe-shared-memory": (65, 128, 128, 120, 64)}.get(case, COND_HEPMASS)
    spec = tfs.chain_spec(tcnf.MLP(dims, device=dev), dims[-1])
    nc, dz, B = dims[0] - dims[-1], dims[-1], 64
    ys = _cond_ys(B, nc, dev)
    kw, adj = _train_args(dims, B, (0.0, 1.0), dev)
    kw["ys"] = ys
    if case == "probe-shared-memory":
        kw["eps"] = torch.randn(2, B, dz, device=dev)
    k4_call = dict({k: v for k, v in adj.items() if k != "eps"}, zT=kw["z0"], accT=kw["acc0"],
                   dt_init=torch.tensor(-0.05, device=dev), ys=ys)
    wrapper, why, call = {
        "unconditional-K7": ("run_wide_test_solve_kernel", "unconditional instance",
                             dict(_kernel_args(dims, B, (0.0, 1.0), dev), ys=ys)),
        "unconditional-K4": ("run_wide_exact_adjoint_kernel", "unconditional instance", k4_call),
        "K4-hidden130": ("run_stream_exact_adjoint_kernel", "unconditional instance", k4_call),
        "probe-shared-memory": ("run_wide_cond_train_solve_kernel", "their streamed forms take the chain", kw),
        "streamed": ("run_stream_test_solve_kernel", "unconditional instance",
                     dict(_kernel_args(dims, B, (0.0, 1.0), dev), ys=ys)),
        "unconditional-instance": ("run_wide_train_solve_kernel", "unconditional instance", kw),
    }[case]
    tfs.reset_launches()
    with pytest.raises(NotImplementedError) as err:
        getattr(tfs, wrapper)(TSIT5, spec, **call)
    assert why in str(err.value)
    assert not any(w.launches for w in tfs.KERNEL_WRAPPERS.values())
    cond = {"streamed": ("run_stream_cond_test_solve_kernel", "k7_stream_solve/test/cond"),
            "K4-hidden130": ("run_stream_cond_exact_adjoint_kernel", "k4_stream_adjoint/cond"),
            "probe-shared-memory": ("run_stream_cond_train_solve_kernel", "k1_stream_solve/cond")}
    if case in cond:
        with torch.no_grad():
            out = getattr(tfs, cond[case][0])(TSIT5, spec, **call)
        torch.cuda.synchronize()
        assert all(bool(torch.isfinite(x).all()) for x in out[:2])
        assert {k: w.launches for k, w in tfs.KERNEL_WRAPPERS.items() if w.launches} == {cond[case][1]: 1}


# K6 x K8: (K, JVP?) of the probe COND instances' holds
_COND_PROBES = ((2, False), (4, False), (8, False), (1, True), (2, True))


@pytest.mark.parametrize("probes", _COND_PROBES, ids=[f"{'jvp-' if j else ''}K{k}" for k, j in _COND_PROBES])
@pytest.mark.parametrize(
    "dims,B,span",
    [(COND_HEPMASS, 4096, (0.0, 13.0)), ((44, 128, 128, 43), 2048, (0.0, 1.0))],
    ids=["cond-hepmass42-B4096", "three-layer-hidden128-B2048"],
)
def test_wide_cond_probe_kernels_match_twins(dev, dims, B, span, probes):
    """The probe COND instances of the wide K1 and K2 chain forms (K6 x K8)
    against their twins with the conditioning ys (B, n_cond) and K VJP or
    JVP probes: the forward from nonzero accumulators (equal steps, values
    within REL), the adjoint from its output warm-started from its last step
    (equal steps; z0, acc0, a_z0 and a_ys0 held to the float64 twin;
    gradients within GRAD_REL, layer 0's ys rows not zero).  One launch
    each, counted under (K, jvp)."""
    k, jvp = probes
    spec = tfs.chain_spec(tcnf.MLP(dims, device=dev), dims[-1])
    nc, dz = dims[0] - dims[-1], dims[-1]
    ys = _cond_ys(B, nc, dev)
    kw, adj = _train_args(dims, B, span, dev)
    eps = torch.from_numpy(np.random.default_rng(14).normal(size=(k, B, dz)).astype(np.float32)).to(dev)
    kw.update(ys=ys, eps=eps, jvp=jvp)
    adj.update(ys=ys, eps=eps, jvp=jvp)
    runs = (tfs.run_wide_cond_train_solve_kernel, tfs.run_wide_cond_adjoint_kernel)
    before = [w.probe_launches.get((k, jvp), 0) for w in runs]
    tdir = 1.0 if span[1] > span[0] else -1.0
    with torch.no_grad():
        out_k = runs[0](TSIT5, spec, **kw)
        out_p = tfs.solve_train_plain(TSIT5, spec, **kw)
        adj.update(zT=out_k[0], accT=out_k[1], dt_init=-tdir * out_k[4].abs())
        k2 = [runs[1](TSIT5, spec, **adj), tfs.adjoint_train_plain(TSIT5, spec, **adj),
              _twin64(tfs.adjoint_train_plain, spec, adj)]
    torch.cuda.synchronize()
    assert [w.probe_launches.get((k, jvp), 0) for w in runs] == [n + 1 for n in before]
    _hold_forward(out_k, out_p)
    _hold_cond_adjoint(*k2)
    assert float(k2[0][3][0][dz:].abs().max()) > 0.0


def test_wide_cond_probe_path_on_the_card_matches_the_twins_on_the_cpu(dev):
    """cond_hepmass42 (CondRNODE, MLP 43 -> 126 -> 42 on [z | ys]; tspan
    (0, 1) here) with four VJP probes on the card and on the CPU at B = 256:
    the loss and its gradient in the params and ys through the probe COND
    instances of the wide K1 and K2 chain forms, each launching once under
    (4, False) and no other kernel."""
    rng = np.random.default_rng(15)
    xs = rng.normal(size=(256, 21)).astype(np.float32)
    ys = rng.choice([-1.414, -0.707, 0.0, 0.707, 1.414], size=(256, 1)).astype(np.float32)
    eps = np.random.default_rng(16).normal(size=(4, 256, 42)).astype(np.float32)
    ps_np = _np_params(COND_HEPMASS, 17)

    def run(device):
        icnf = tcnf.construct(tcnf.CondRNODE, tcnf.MLP(COND_HEPMASS, device=device), 21, 21, tspan=(0.0, 1.0),
                              steer_rate=0.1, lam3=1e-2, compute_mode=tcnf.VecJacMode(4, fused=True))
        ps = tcnf.params_from_numpy(ps_np, device)
        y = torch.from_numpy(ys).to(device).requires_grad_()
        leaves = [x.requires_grad_() for p in ps for x in (p["w"], p["b"])] + [y]
        l = tcnf.loss(icnf, tcnf.Mode.TRAIN, xs, ps, ys=y, eps=eps, steer_r=0.05)
        return l.detach().cpu(), [g.cpu() for g in torch.autograd.grad(l, leaves)]

    runs = (tfs.run_wide_cond_train_solve_kernel, tfs.run_wide_cond_adjoint_kernel)
    before, probes = _launches(), [w.probe_launches.get((4, False), 0) for w in runs]
    l_k, g_k = run(dev)
    after = _launches()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        tfs.K1W_KERNEL + "/cond": 1, tfs.K2W_KERNEL + "/cond": 1}
    assert [w.probe_launches.get((4, False), 0) for w in runs] == [n + 1 for n in probes]
    l_c, g_c = run(torch.device("cpu"))
    assert _close(l_k, l_c)
    for a, b in zip(g_k, g_c):
        assert _grad_close(a, b)


# ---- streamed K3 and K5, and the streamed chain forms to state width 128 ----

MINIBOONE86 = (86, 258, 86)
BSDS126 = (126, 378, 126)


@pytest.mark.parametrize(
    "dims,B,span",
    [
        (MINIBOONE86, 4096, (0.0, 13.0)),
        (MINIBOONE86, 4000, (0.0, 13.0)),
        (MINIBOONE86, 37, (1.0, 0.0)),
        ((72, 80, 72), 300, (0.0, 2.0)),
        ((128, 384, 128), 256, (0.0, 1.0)),
        (BSDS126, 2048, (0.0, 1.0)),
        ((40, 160, 40), 64, (0.0, 2.0)),
    ],
    ids=["miniboone86-B4096", "miniboone86-ragged-B4000", "miniboone86-reverse-B37", "dz72-hidden80",
         "dz128-hidden384", "bsds126-B2048", "dz40-hidden160"],
)
def test_stream_two_layer_kernels_match_twins(dev, dims, B, span):
    """Streamed K3 against `solve_test_plain` from a nonzero dlogp (equal
    steps, values within REL) and streamed K5 against `adjoint_test_plain`
    from its output, warm-started from its last step (equal steps, z0, acc0
    and a_z0 held to the float64 twin, finite gradients within GRAD_REL);
    the streamed K1 and K2 chain forms and streamed K7 at the same widths,
    held as `test_stream_chain_kernels_match_twins` holds them.  One launch
    each."""
    spec = tfs.chain_spec(tcnf.MLP(dims, device=dev), dims[-1])
    assert tfs._stream_two_layer(spec)
    (out_k, out_p), (adj_k, adj_p, adj_64), test, exact, _, _ = _chain_case(dims, B, span, dev, wide="stream")
    _hold_forward(out_k, out_p)
    _hold_forward(*test)
    _hold_forward(*exact)
    k2 = (adj_k, adj_p, adj_64)
    kw = _kernel_args(dims, B, span, dev)
    dz = dims[-1]
    rng = np.random.default_rng(11)
    T = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    runs = (tfs.run_stream_test2_solve_kernel, tfs.run_stream_test_adjoint_kernel)
    before = [w.launches for w in runs]
    tdir = 1.0 if span[1] > span[0] else -1.0
    with torch.no_grad():
        t3_k = tfs.run_stream_test2_solve_kernel(TSIT5, spec, **kw)
        t3_p = tfs.solve_test_plain(TSIT5, spec, **kw)
        test_adj = dict({k: kw[k] for k in ("rtol", "atol", "max_steps", "ws", "bs")}, zT=t3_p[0],
                        accT=t3_p[1][None], azT=T(rng.normal(0.0, 1.0 / B, (B, dz))),
                        aaccT=T(np.full((1, B), 1.0 / B)), t_hi=kw["t1"], t_lo=kw["t0"],
                        dt_init=-tdir * t3_p[4].abs())
        k5 = (tfs.run_stream_test_adjoint_kernel(TSIT5, spec, **test_adj),
              tfs.adjoint_test_plain(TSIT5, spec, **test_adj), _twin64(tfs.adjoint_test_plain, spec, test_adj))
    torch.cuda.synchronize()
    assert [w.launches for w in runs] == [n + 1 for n in before]
    _hold_forward(t3_k, t3_p)
    for a_k, a_p, a_64 in (k2, k5):
        assert (int(a_k[5]), int(a_k[6])) == (int(a_p[5]), int(a_p[6]))
        for i in range(3):  # z0, acc0, a_z0
            assert _state_close(a_k[i], a_p[i], a_64[i])
        for a, b in zip(a_k[3] + a_k[4], a_p[3] + a_p[4]):
            assert torch.isfinite(a).all() and _grad_close(a, b)


@pytest.mark.parametrize(
    "dims,wrapper,kind,why",
    [
        ((129, 387, 129), "run_stream_test2_solve_kernel", "test", "state width 129 > 128"),
        ((129, 387, 129), "run_stream_test_adjoint_kernel", "test-adjoint", "state width 129 > 128"),
        ((129, 387, 129), "run_stream_train_solve_kernel", "train", "state width 129 > 128"),
        ((129, 387, 129), "run_stream_exact_adjoint_kernel", "exact-adjoint", "state width 129 > 128"),
        (MINIBOONE86, "run_wide_exact_adjoint_kernel", "exact-adjoint", "state width 86 > 64"),
        ((129, 387, 129), "run_stream_train_solve_kernel", "two-probes", "state width 129 > 128"),
        ((129, 387, 129), "run_stream_train_solve_kernel", "jvp", "state width 129 > 128"),
        ((42, 126, 42), "run_stream_test2_solve_kernel", "test", "wide forms take the net"),
    ],
    ids=["dz129-test", "dz129-test-adjoint", "dz129-train", "dz129-exact-adjoint", "miniboone86-exact-adjoint",
         "dz129-two-probes", "dz129-jvp", "hepmass42-in-streamed-K3"],
)
def test_stream_two_layer_limits_raise_on_cuda(dev, dims, wrapper, kind, why):
    """A 2-layer net past state width 128 (the streamed K4 adjoint
    included, and K > 1 or JVP probes in the streamed probe instances), the
    wide K4 adjoint past its own limits (the streamed K4 adjoint takes
    miniboone86's exact backward), and a net the wide 2-layer kernels take, raise
    NotImplementedError on the card naming their reason and, past the
    kernels' widths, ROADMAP queue 2's shape variants (e).  Nothing is
    launched."""
    spec = tfs.chain_spec(tcnf.MLP(dims), dims[-1])
    kw = _kernel_args(dims, 8, (0.0, 1.0), dev)
    dz = dims[-1]
    z = kw["z0"]
    base = {k: kw[k] for k in ("rtol", "atol", "max_steps", "ws", "bs")}
    adj = dict(base, zT=z, azT=z, t_hi=torch.tensor(1.0, device=dev), t_lo=torch.tensor(0.0, device=dev),
               dt_init=torch.tensor(-0.05, device=dev))
    if kind in ("train", "two-probes", "jvp"):
        kw = {k: v for k, v in kw.items() if k != "dlogp0"}
        kw.update(norm_z=True, norm_j=True, acc0=torch.zeros((3, 8), device=dev),
                  eps=torch.ones((2 if kind == "two-probes" else 1, 8, dz), device=dev), jvp=kind == "jvp")
    elif kind == "test-adjoint":
        kw = dict(adj, accT=torch.zeros((1, 8), device=dev), aaccT=torch.zeros((1, 8), device=dev))
    elif kind == "exact-adjoint":
        kw = dict(adj, norm_z=True, norm_j=True, accT=torch.zeros((3, 8), device=dev),
                  aaccT=torch.zeros((3, 8), device=dev))
    before = _launches()
    with pytest.raises(NotImplementedError) as err:
        getattr(tfs, wrapper)(TSIT5, spec, **kw)
    assert why in str(err.value)
    if why.startswith("state width"):
        assert "ROADMAP queue 2, shape variants (e)" in str(err.value)
    assert _launches() == before


def test_stream_two_layer_paths_on_the_card_match_the_twins_on_the_cpu(dev):
    """The miniboone86 model (RNODE, nvars = naug = 43, MLP 86 -> 258 -> 86,
    steer_rate 0.1; tspan (0, 1) here) on the card and on the CPU at
    B = 256: logpdf through streamed K3; the TEST loss gradient and the score
    through streamed K3 and K5; the Hutchinson loss and gradient through the
    streamed K1 and K2 chain forms; the exact loss and gradient through
    streamed K7 exact and the streamed K4 adjoint; each launching those
    kernels once and no other."""
    xs = np.random.default_rng(4).normal(size=(256, 43)).astype(np.float32)
    eps = np.random.default_rng(5).normal(size=(1, 256, 86)).astype(np.float32)
    ps_np = _np_params(MINIBOONE86, 3)

    def model(device, exact=False):
        return tcnf.construct(tcnf.RNODE, tcnf.MLP(MINIBOONE86, device=device), 43, 43, tspan=(0.0, 1.0),
                              steer_rate=0.1, lam3=1e-2, compute_mode=tcnf.VecJacMode(fused=True, exact_trace=exact))

    def run(device, mode):
        icnf = model(device, exact=mode == "exact")
        ps = tcnf.params_from_numpy(ps_np, device)
        leaves = [x.requires_grad_() for p in ps for x in (p["w"], p["b"])]
        if mode == "test":
            with torch.no_grad():
                lp = tcnf.ICNFDist(icnf, tcnf.Mode.TEST, ps).logpdf(xs)
            l = tcnf.loss(icnf, tcnf.Mode.TEST, xs, ps)
            return lp.cpu(), l.detach().cpu(), [g.cpu() for g in torch.autograd.grad(l, leaves)]
        if mode == "score":
            x = torch.from_numpy(xs).to(device).requires_grad_()
            lp = tcnf.ICNFDist(icnf, tcnf.Mode.TEST, ps).logpdf(x)
            return None, lp.detach().cpu(), [torch.autograd.grad(lp.sum(), x)[0].cpu()]
        kw = {"steer_r": 0.05} if mode == "exact" else {"eps": eps, "steer_r": 0.05}
        l = tcnf.loss(icnf, tcnf.Mode.TRAIN, xs, ps, **kw)
        return None, l.detach().cpu(), [g.cpu() for g in torch.autograd.grad(l, leaves)]

    wants = {"test": {tfs.K3S_KERNEL: 2, tfs.K5S_KERNEL: 1}, "score": {tfs.K3S_KERNEL: 1, tfs.K5S_KERNEL: 1},
             "train": {tfs.K1S_KERNEL: 1, tfs.K2S_KERNEL: 1},
             "exact": {tfs.K7S_KERNEL + "/exact": 1, tfs.K4SA_KERNEL: 1}}
    for mode, want in wants.items():
        before = _launches()
        lp_k, l_k, g_k = run(dev, mode)
        after = _launches()
        assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == want
        lp_c, l_c, g_c = run(torch.device("cpu"), mode)
        assert _close(l_k, l_c) and (lp_k is None or _close(lp_k, lp_c))
        for a, b in zip(g_k, g_c):
            assert _grad_close(a, b)


# id -> (dims, B, span, tableau, rtol, atol)
_K4S_CASES = {
    "miniboone86-B4000": (MINIBOONE86, 4000, (0.0, 13.0), TSIT5, 1e-3, 1e-6),
    "miniboone86-reverse-B37": (MINIBOONE86, 37, (1.0, 0.0), TSIT5, 1e-3, 1e-6),
    "dz72-B1": ((72, 80, 72), 1, (0.0, 1.0), TSIT5, 1e-3, 1e-6),
    "bsds126-B37": (BSDS126, 37, (0.0, 1.0), TSIT5, 1e-3, 1e-6),
    "dz128-B1": ((128, 384, 128), 1, (0.0, 1.0), TSIT5, 1e-3, 1e-6),
    "dz40-hidden160-B300": ((40, 160, 40), 300, (0.0, 2.0), TSIT5, 1e-3, 1e-6),
    "dz72-dopri5": ((72, 80, 72), 256, (0.0, 2.0), DOPRI5, 1e-3, 1e-6),
    "miniboone86-verner65": (MINIBOONE86, 256, (0.0, 13.0), VERNER65, 3.452669831108329e-4, 1.1920929e-7),
    "dz40-hidden160-dop853": ((40, 160, 40), 256, (0.0, 1.0), DOP853, 1e-6, 1e-8),
}


@pytest.mark.parametrize("case", list(_K4S_CASES))
def test_stream_exact_adjoint_matches_twin(dev, case):
    """The streamed K4 adjoint against `adjoint_train_exact_plain` from
    the exact forward twin's output, warm-started from its last step: equal
    steps, z0, acc0 and a_z0 held to the float64 twin (`_state_close`),
    finite gradients (g_pm chained into W1 and W2) within GRAD_REL; under
    dop853 at rtol 1e-6, where the float32 error estimate is roundoff (its
    second error sum in the kernel's slices), attempted steps within
    max(2, steps / 20) of the twin's and the same value bounds, else the
    near-tie rule.  B = 1, 37 and ragged 4000, state widths 40 to 128; one
    launch each."""
    dims, B, span, tab, rtol, atol = _K4S_CASES[case]
    spec = tfs.chain_spec(tcnf.MLP(dims, device=dev), dims[-1])
    assert tfs._stream_exact_covers(tab, spec) is None
    kw, adj = _train_args(dims, B, span, dev)
    ex = {k: v for k, v in kw.items() if k != "eps"}
    ex.update(rtol=rtol, atol=atol)
    adj = {k: v for k, v in adj.items() if k != "eps"}
    adj.update(rtol=rtol, atol=atol)
    n = tfs.run_stream_exact_adjoint_kernel.launches
    with torch.no_grad():
        fo = tfs.solve_train_exact_plain(tab, spec, **ex)
        adj.update(zT=fo[0], accT=fo[1], dt_init=-torch.sign(ex["t1"] - ex["t0"]) * fo[4].abs())
        out_k = tfs.run_stream_exact_adjoint_kernel(tab, spec, **adj)
        out_p = tfs.adjoint_train_exact_plain(tab, spec, **adj)
        out_64 = _twin64(tfs.adjoint_train_exact_plain, spec, adj, tab)
    torch.cuda.synchronize()
    assert tfs.run_stream_exact_adjoint_kernel.launches == n + 1
    assert all(bool(torch.isfinite(g).all()) for g in out_k[3] + out_k[4])
    assert [tuple(g.shape) for g in out_k[3] + out_k[4]] == [tuple(g.shape) for g in out_p[3] + out_p[4]]
    if _adjoint_matches(out_k, out_p, out_64):
        return
    if tab is DOP853:
        s_k, s_p = int(out_k[5]), int(out_p[5])
        if abs(s_k - s_p) <= max(2, s_p // 20) and all(
                _state_close(out_k[i], out_p[i], out_64[i]) for i in range(3)) and all(
                _grad_close(a, b) for a, b in zip(out_k[3] + out_k[4], out_p[3] + out_p[4])):
            return
    _near_tie_holds(out_k, out_p, tfs.adjoint_train_exact_plain, spec, adj, "zT", tab)


# ---- the COND instances of the streamed forms (K8: conditional nets past the wide limits) ----

COND_MINIBOONE86 = (87, 258, 86)


@pytest.mark.parametrize(
    "dims,B,span",
    [
        (COND_MINIBOONE86, 4096, (0.0, 13.0)),
        ((67, 80, 66), 37, (2.0, 0.0)),
        ((10, 136, 136, 8), 300, (0.0, 2.0)),
        ((44, 860, 860, 43), 256, (0.0, 1.0)),
        ((87, 4000, 86), 16, (0.0, 1.0)),
        ((36, 200, 33), 1, (0.0, 1.0)),
        ((44,) + (860,) * 4 + (43,), 64, (0.0, 1.0)),
    ],
    ids=["cond-miniboone86-B4096", "dz66-reverse-B37", "three-layer-hidden136-ncond2-B300", "cond-miniboone860-B256",
         "hidden4000-global-tiles-B16", "ncond3-B1", "cond-five-layer-miniboone860-B64"],
)
def test_stream_cond_kernels_match_twins(dev, dims, B, span):
    """The COND instances of the streamed K1 and K2 chain forms (and, for
    2-layer nets, of streamed K3 and streamed K5) against their twins with
    the conditioning ys (B, n_cond): the forwards from nonzero accumulators
    (equal steps, values within REL), the adjoints from their forward's
    output warm-started from its last step (equal steps; z0, acc0, a_z0 and
    a_ys0 held to the float64 twin; gradients within GRAD_REL).  Hidden
    width 4000 sends the tile arrays of K2, K3 and K5 to the global scratch.
    One launch each."""
    spec = tfs.chain_spec(tcnf.MLP(dims, device=dev), dims[-1])
    assert tfs._stream_chain(spec)
    nc, dz = dims[0] - dims[-1], dims[-1]
    ys = _cond_ys(B, nc, dev)
    kw, adj = _train_args(dims, B, span, dev)
    kw["ys"], adj["ys"] = ys, ys
    two = len(dims) == 3
    runs = [tfs.run_stream_cond_train_solve_kernel, tfs.run_stream_cond_adjoint_kernel]
    if two:
        runs += [tfs.run_stream_cond_test2_solve_kernel, tfs.run_stream_cond_test_adjoint_kernel]
    before = [w.launches for w in runs]
    tdir = 1.0 if span[1] > span[0] else -1.0
    rng = np.random.default_rng(13)
    T = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    with torch.no_grad():
        out_k = tfs.run_stream_cond_train_solve_kernel(TSIT5, spec, **kw)
        out_p = tfs.solve_train_plain(TSIT5, spec, **kw)
        adj.update(zT=out_k[0], accT=out_k[1], dt_init=-tdir * out_k[4].abs())
        k2 = [tfs.run_stream_cond_adjoint_kernel(TSIT5, spec, **adj), tfs.adjoint_train_plain(TSIT5, spec, **adj),
              _twin64(tfs.adjoint_train_plain, spec, adj)]
        if two:
            test_kw = dict(_kernel_args(dims, B, span, dev), ys=ys)
            t_k = tfs.run_stream_cond_test2_solve_kernel(TSIT5, spec, **test_kw)
            t_p = tfs.solve_test_plain(TSIT5, spec, **test_kw)
            test_adj = dict({k: test_kw[k] for k in ("rtol", "atol", "max_steps", "ws", "bs", "ys")}, zT=t_p[0],
                            accT=t_p[1][None], azT=T(rng.normal(0.0, 1.0 / B, (B, dz))),
                            aaccT=T(np.full((1, B), 1.0 / B)), t_hi=test_kw["t1"], t_lo=test_kw["t0"],
                            dt_init=-tdir * t_p[4].abs())
            k5 = [tfs.run_stream_cond_test_adjoint_kernel(TSIT5, spec, **test_adj),
                  tfs.adjoint_test_plain(TSIT5, spec, **test_adj), _twin64(tfs.adjoint_test_plain, spec, test_adj)]
    torch.cuda.synchronize()
    assert [w.launches for w in runs] == [n + 1 for n in before]
    _hold_forward(out_k, out_p)
    _hold_cond_adjoint(*k2)
    assert float(k2[0][3][0][dz:].abs().max()) > 0.0
    if two:
        _hold_forward(t_k, t_p)
        _hold_cond_adjoint(*k5)


def _cond_miniboone86(device, mode="test", dtype=torch.float32, solver=None, span=(0.0, 1.0), fused=True):
    """cond_miniboone86 (CondRNODE, nvars = naug = 43, MLP 87 -> 258 -> 86 on
    [z | ys], steer_rate 0.1, lambda3 = 1e-2) on `device`."""
    kw = {} if solver is None else {"solver": solver}
    return tcnf.construct(tcnf.CondRNODE, tcnf.MLP(COND_MINIBOONE86, device=device, dtype=dtype), 43, 43,
                          tspan=span, steer_rate=0.1, lam3=1e-2, dtype=dtype,
                          compute_mode=tcnf.VecJacMode(fused=fused, exact_trace=mode == "exact"), **kw)


def _cond_miniboone86_inputs(B, seed):
    from continuousnf_tpu_torch.utils.configs import model_data

    xs, ys = model_data("cond_miniboone86", np.random.default_rng(seed), B)
    eps = np.random.default_rng(seed + 1).normal(size=(1, B, 86)).astype(np.float32)
    return xs, ys, eps, _np_params(COND_MINIBOONE86, seed + 2)


def test_stream_cond_paths_on_the_card_match_the_twins_on_the_cpu(dev):
    """cond_miniboone86 (tspan (0, 1) here) on the card and on the CPU at
    B = 256: `CondICNFDist.logpdf` through streamed K3's COND instance; the
    TEST loss gradient in the params and ys through streamed K3's and
    streamed K5's; the Hutchinson loss gradient through the streamed K1 and
    K2 chain forms'; each launching those kernels and no other."""
    xs, ys, eps, ps_np = _cond_miniboone86_inputs(256, 4)

    def run(device, mode):
        icnf = _cond_miniboone86(device, mode)
        ps = tcnf.params_from_numpy(ps_np, device)
        y = torch.from_numpy(ys).to(device).requires_grad_()
        leaves = [x.requires_grad_() for p in ps for x in (p["w"], p["b"])] + [y]
        lp = None
        if mode == "test":
            with torch.no_grad():
                lp = tcnf.CondICNFDist(icnf, tcnf.Mode.TEST, ps, y.detach()).logpdf(xs).cpu()
            l = tcnf.loss(icnf, tcnf.Mode.TEST, xs, ps, ys=y)
        else:
            l = tcnf.loss(icnf, tcnf.Mode.TRAIN, xs, ps, ys=y, eps=eps, steer_r=0.05)
        return lp, l.detach().cpu(), [g.cpu() for g in torch.autograd.grad(l, leaves)]

    wants = {"test": {tfs.K3S_KERNEL + "/cond": 2, tfs.K5S_KERNEL + "/cond": 1},
             "train": {tfs.K1S_KERNEL + "/cond": 1, tfs.K2S_KERNEL + "/cond": 1}}
    for mode, want in wants.items():
        before = _launches()
        lp_k, l_k, g_k = run(dev, mode)
        after = _launches()
        assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == want
        lp_c, l_c, g_c = run(torch.device("cpu"), mode)
        assert _close(l_k, l_c) and (lp_k is None or _close(lp_k, lp_c))
        for a, b in zip(g_k, g_c):
            assert _grad_close(a, b)


@pytest.mark.parametrize("mode", ["test", "train"])
def test_stream_cond_gradients_match_a_float64_solve(dev, mode):
    """cond_miniboone86 at its own span (0, 13), B = 64: the TEST and the
    Hutchinson loss gradients in the params and ys through the streamed
    COND instances within 2e-2 max|g| of a float64 rtol 1e-7 solve (the
    plain path on the card), the losses within 1e-4 of it."""
    xs, ys, eps, ps_np = _cond_miniboone86_inputs(64, 6)
    truth = tcnf.SolverOptions(rtol=1e-7, atol=1e-9)

    def run(dtype, fused, solver=None):
        icnf = _cond_miniboone86(dev, "test" if mode == "test" else "train", dtype, solver, (0.0, 13.0), fused)
        leaves = [v.to(dtype).requires_grad_() for p in tcnf.params_from_numpy(ps_np, dev) for v in (p["w"], p["b"])]
        ps = tuple({"w": w, "b": b} for w, b in zip(leaves[::2], leaves[1::2]))
        y = torch.from_numpy(ys).to(device=dev, dtype=dtype).requires_grad_()
        x = torch.from_numpy(xs).to(device=dev, dtype=dtype)
        if mode == "test":
            l = tcnf.loss(icnf, tcnf.Mode.TEST, x, ps, ys=y)
        else:
            l = tcnf.loss(icnf, tcnf.Mode.TRAIN, x, ps, ys=y, eps=torch.from_numpy(eps).to(device=dev, dtype=dtype),
                          steer_r=0.05)
        return l.detach().cpu().double(), [g.cpu().double() for g in torch.autograd.grad(l, leaves + [y])]

    before = _launches()
    l_k, g_k = run(torch.float32, True)
    after = _launches()
    want = ({tfs.K3S_KERNEL + "/cond": 1, tfs.K5S_KERNEL + "/cond": 1} if mode == "test"
            else {tfs.K1S_KERNEL + "/cond": 1, tfs.K2S_KERNEL + "/cond": 1})
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == want
    l_t, g_t = run(torch.float64, False, truth)
    assert float((l_k - l_t).abs()) <= 1e-4 * max(1.0, float(l_t.abs()))
    for a, t in zip(g_k, g_t):
        assert torch.isfinite(a).all() and float((a - t).abs().max()) <= 2e-2 * float(t.abs().max())


@pytest.mark.parametrize("case", ["exact", "two-probes", "jvp", "three-layer-test"])
def test_stream_cond_refusals_raise_on_cuda(dev, case):
    """Through the loss on the card, what rows (d5) and (d6) refused of
    conditional nets past the wide limits now runs, finite: exact training
    ("exact": streamed K7 exact's and the streamed K4 adjoint's COND
    instances, one launch each), the TEST forward of a conditional 3-layer
    chain past hidden 128 ("three-layer-test": streamed K7 TEST's COND
    instance, one launch), and K probes and JVP probes at cond_miniboone86
    ("two-probes", "jvp": the streamed probe COND instances, one launch
    each, counted under (K, jvp))."""
    dims = (10, 136, 136, 8) if case == "three-layer-test" else COND_MINIBOONE86
    nvars = 4 if case == "three-layer-test" else 43
    cm = {"exact": tcnf.VecJacMode(fused=True, exact_trace=True), "two-probes": tcnf.VecJacMode(2, fused=True),
          "jvp": tcnf.JacVecMode(fused=True)}.get(case, tcnf.VecJacMode(fused=True))
    icnf = tcnf.construct(tcnf.CondRNODE, tcnf.MLP(dims, device=dev), nvars, dims[-1] - nvars, tspan=(0.0, 1.0),
                          compute_mode=cm)
    ps = tcnf.params_from_numpy(_np_params(dims, 9), dev)
    xs = torch.from_numpy(np.random.default_rng(10).normal(size=(64, nvars)).astype(np.float32)).to(dev)
    ys = _cond_ys(64, dims[0] - dims[-1], dev)
    tfs.reset_launches()
    if case == "three-layer-test":
        with torch.no_grad():
            out = tcnf.inference(icnf, tcnf.Mode.TEST, xs, ps, ys=ys)
        assert all(bool(torch.isfinite(x).all()) for x in out[:2] if torch.is_tensor(x))
        assert _launches() == dict(dict.fromkeys(_launches(), 0), **{tfs.K7S_KERNEL + "/test/cond": 1})
        return
    if case == "exact":
        leaves = [x.requires_grad_() for p in ps for x in (p["w"], p["b"])]
        grads = torch.autograd.grad(tcnf.loss(icnf, tcnf.Mode.TRAIN, xs, ps, ys=ys), leaves)
        assert all(bool(torch.isfinite(g).all()) for g in grads)
        assert _launches() == dict(dict.fromkeys(_launches(), 0),
                                   **{tfs.K7S_KERNEL + "/exact/cond": 1, tfs.K4SA_KERNEL + "/cond": 1})
        return
    leaves = [x.requires_grad_() for p in ps for x in (p["w"], p["b"])]
    grads = torch.autograd.grad(tcnf.loss(icnf, tcnf.Mode.TRAIN, xs, ps, ys=ys), leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert _launches() == dict(dict.fromkeys(_launches(), 0), **{tfs.K1S_KERNEL + "/cond": 1,
                                                                 tfs.K2S_KERNEL + "/cond": 1})
    key = (2, False) if case == "two-probes" else (1, True)
    assert [w.probe_launches for w in (tfs.run_stream_cond_train_solve_kernel, tfs.run_stream_cond_adjoint_kernel)] \
        == [{key: 1}] * 2


# ---- K8 in streamed K7 and the streamed K4 adjoint (row (d5)) ----

COND_MINIBOONE860 = (44, 860, 860, 43)


def _tile_scratch_floats(kernel, entry, dims, B):
    """out[4] of a streamed shape entry: the floats of global tile scratch a
    block (0: the tile arrays fit in shared memory)."""
    import ctypes

    out = (ctypes.c_int * 5)()
    widths = (ctypes.c_int * len(dims))(*dims)
    assert getattr(tfs._library(kernel), entry)(len(dims) - 1, widths, B, out) == 0
    return out[4]


@pytest.mark.parametrize(
    "dims,B,span,tab",
    [
        (COND_MINIBOONE86, 4096, (0.0, 13.0), TSIT5),
        ((67, 80, 66), 37, (2.0, 0.0), TSIT5),
        ((67, 80, 66), 64, (1.0, 0.0), VERNER65),
        ((10, 136, 136, 8), 300, (0.0, 2.0), TSIT5),
        (COND_MINIBOONE860, 256, (0.0, 1.0), TSIT5),
        ((44, 130, 43), 256, (0.0, 1.0), TSIT5),
        ((87, 4000, 86), 16, (0.0, 1.0), TSIT5),
        ((36, 200, 33), 1, (0.0, 1.0), TSIT5),
    ],
    ids=["cond-miniboone86-B4096", "dz66-reverse-B37", "dz66-verner65-reverse-B64", "three-layer-hidden136-ncond2-B300",
         "cond-miniboone860-B256", "hidden130-B256", "hidden4000-global-tiles-B16", "ncond3-B1"],
)
def test_stream_cond_k7_and_k4_kernels_match_twins(dev, dims, B, span, tab):
    """The COND instances of streamed K7 TEST and streamed K7 exact (and, for
    2-layer nets, of the streamed K4 adjoint) against their twins with the
    conditioning ys (B, n_cond): the forwards from nonzero accumulators
    (equal steps, values within REL), the adjoint from streamed K7 exact
    COND's output warm-started from its last step (equal steps; z0, acc0,
    a_z0 and a_ys0 held to the float64 twin; gradients within GRAD_REL,
    W1's ys rows not zero).  Hidden width 4000 sends the tile arrays of both
    to the global scratch (the shape entries say so).  One launch each."""
    spec = tfs.chain_spec(tcnf.MLP(dims, device=dev), dims[-1])
    assert tfs._stream_chain(spec)
    nc, dz = dims[0] - dims[-1], dims[-1]
    two = len(dims) == 3
    if dims[1] == 4000:
        assert _tile_scratch_floats(tfs.K7S_KERNEL, "cnf_k7sc_exact_shape", dims, B) > 0
        assert _tile_scratch_floats(tfs.K4SA_KERNEL, "cnf_k4sc_shape", dims, B) > 0
    ys = _cond_ys(B, nc, dev)
    kw, adj = _train_args(dims, B, span, dev)
    exact_kw = dict({k: v for k, v in kw.items() if k != "eps"}, ys=ys)
    test_kw = dict(_kernel_args(dims, B, span, dev), ys=ys)
    if tab is VERNER65:
        exact_kw.update(rtol=3.452669831108329e-4, atol=1.1920929e-7)
        test_kw.update(rtol=3.452669831108329e-4, atol=1.1920929e-7)
    runs = [tfs.run_stream_cond_test_solve_kernel, tfs.run_stream_cond_exact_solve_kernel]
    if two:
        runs.append(tfs.run_stream_cond_exact_adjoint_kernel)
    before = [w.launches for w in runs]
    tdir = 1.0 if span[1] > span[0] else -1.0
    with torch.no_grad():
        t_k = tfs.run_stream_cond_test_solve_kernel(tab, spec, **test_kw)
        t_p = tfs.solve_test_plain(tab, spec, **test_kw)
        e_k = tfs.run_stream_cond_exact_solve_kernel(tab, spec, **exact_kw)
        e_p = tfs.solve_train_exact_plain(tab, spec, **exact_kw)
        if two:
            adj = dict({k: v for k, v in adj.items() if k != "eps"}, zT=e_k[0], accT=e_k[1],
                       dt_init=-tdir * e_k[4].abs(), ys=ys, rtol=exact_kw["rtol"], atol=exact_kw["atol"])
            k4 = [tfs.run_stream_cond_exact_adjoint_kernel(tab, spec, **adj),
                  tfs.adjoint_train_exact_plain(tab, spec, **adj),
                  _twin64(tfs.adjoint_train_exact_plain, spec, adj, tab)]
    torch.cuda.synchronize()
    assert [w.launches for w in runs] == [n + 1 for n in before]
    _hold_forward(t_k, t_p)
    _hold_forward(e_k, e_p)
    if two:
        _hold_cond_adjoint(*k4)
        assert float(k4[0][3][0][dz:].abs().max()) > 0.0


def test_stream_cond_exact_paths_on_the_card_match_the_twins_on_the_cpu(dev):
    """On the card and on the CPU: cond_miniboone86 (tspan (0, 1), B = 256)
    the exact loss gradient in the params and ys through streamed K7
    exact's and the streamed K4 adjoint's COND instances; the conditional
    miniboone860 chain (CondRNODE, MLP 44 -> 860 -> 860 -> 43, nvars 43,
    tspan (0, 1), B = 64) `CondICNFDist.logpdf` and `sample` (the base draw
    injected) through streamed K7 TEST's COND instance and the exact loss
    gradient through streamed K7 exact's and the plain BACKSOLVE; each
    launching those kernels and no other."""
    xs86, ys86, _, ps86 = _cond_miniboone86_inputs(256, 14)
    rng = np.random.default_rng(15)
    xs860 = rng.normal(size=(64, 43)).astype(np.float32)
    ys860 = rng.uniform(-1.0, 1.0, (64, 1)).astype(np.float32)
    z1 = rng.normal(size=(64, 43)).astype(np.float32)
    ps860 = _np_params(COND_MINIBOONE860, 16)

    def run(device, case):
        if case == "mb86-exact":
            icnf, ps_np, xs, ys = _cond_miniboone86(device, "exact"), ps86, xs86, ys86
        else:
            icnf = tcnf.construct(tcnf.CondRNODE, tcnf.MLP(COND_MINIBOONE860, device=device), 43, 0,
                                  tspan=(0.0, 1.0),
                                  compute_mode=tcnf.VecJacMode(fused=True, exact_trace=case == "mb860-exact"))
            ps_np, xs, ys = ps860, xs860, ys860
        ps = tcnf.params_from_numpy(ps_np, device)
        y = torch.from_numpy(ys).to(device)
        if case == "mb860-test":
            d = tcnf.CondICNFDist(icnf, tcnf.Mode.TEST, ps, y)
            with torch.no_grad():
                return [d.logpdf(xs).cpu(), d.sample(64, z1=z1).cpu()]
        y.requires_grad_()
        leaves = [x.requires_grad_() for p in ps for x in (p["w"], p["b"])] + [y]
        l = tcnf.loss(icnf, tcnf.Mode.TRAIN, xs, ps, ys=y, steer_r=0.05)
        return [l.detach().cpu()] + [g.cpu() for g in torch.autograd.grad(l, leaves)]

    wants = {"mb86-exact": {tfs.K7S_KERNEL + "/exact/cond": 1, tfs.K4SA_KERNEL + "/cond": 1},
             "mb860-test": {tfs.K7S_KERNEL + "/test/cond": 2},
             "mb860-exact": {tfs.K7S_KERNEL + "/exact/cond": 1}}
    for case, want in wants.items():
        before = _launches()
        got = run(dev, case)
        after = _launches()
        assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == want
        ref = run(torch.device("cpu"), case)
        close = _close if case == "mb860-test" else _grad_close
        assert all(torch.isfinite(a).all() and close(a, b) for a, b in zip(got, ref))


def test_stream_cond_exact_gradient_matches_a_float64_solve(dev):
    """cond_miniboone86 at its own span (0, 13), B = 64: the exact loss
    gradient in the params and ys through streamed K7 exact's and the
    streamed K4 adjoint's COND instances (one launch each) within
    2e-2 max|g| of a float64 rtol 1e-7 solve (the plain path on the card),
    the loss within 1e-4 of it."""
    xs, ys, _, ps_np = _cond_miniboone86_inputs(64, 6)
    truth = tcnf.SolverOptions(rtol=1e-7, atol=1e-9)

    def run(dtype, fused, solver=None):
        icnf = _cond_miniboone86(dev, "exact", dtype, solver, (0.0, 13.0), fused)
        leaves = [v.to(dtype).requires_grad_() for p in tcnf.params_from_numpy(ps_np, dev) for v in (p["w"], p["b"])]
        ps = tuple({"w": w, "b": b} for w, b in zip(leaves[::2], leaves[1::2]))
        y = torch.from_numpy(ys).to(device=dev, dtype=dtype).requires_grad_()
        x = torch.from_numpy(xs).to(device=dev, dtype=dtype)
        l = tcnf.loss(icnf, tcnf.Mode.TRAIN, x, ps, ys=y, steer_r=0.05)
        return l.detach().cpu().double(), [g.cpu().double() for g in torch.autograd.grad(l, leaves + [y])]

    before = _launches()
    l_k, g_k = run(torch.float32, True)
    after = _launches()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        tfs.K7S_KERNEL + "/exact/cond": 1, tfs.K4SA_KERNEL + "/cond": 1}
    l_t, g_t = run(torch.float64, False, truth)
    assert float((l_k - l_t).abs()) <= 1e-4 * max(1.0, float(l_t.abs()))
    for a, t in zip(g_k, g_t):
        assert torch.isfinite(a).all() and float((a - t).abs().max()) <= 2e-2 * float(t.abs().max())


# ---- K6 x K8 in the streamed forms: the probe COND instances (row (d6)) ----


@pytest.mark.parametrize(
    "dims,B,span,tab,probes",
    [
        (COND_MINIBOONE86, 4096, (0.0, 13.0), TSIT5, (4, False)),
        (COND_MINIBOONE86, 4096, (0.0, 13.0), TSIT5, (1, True)),
        (COND_MINIBOONE860, 256, (0.0, 1.0), TSIT5, (4, False)),
        ((10, 136, 136, 8), 300, (0.0, 2.0), TSIT5, (2, True)),
        ((67, 80, 66), 64, (1.0, 0.0), VERNER65, (3, False)),
        ((65, 128, 128, 120, 64), 256, (0.0, 1.0), TSIT5, (2, False)),
        ((87, 8000, 86), 16, (0.0, 1.0), TSIT5, (2, False)),
        ((87, 8000, 86), 16, (0.0, 1.0), TSIT5, (1, True)),
        ((36, 200, 33), 1, (0.0, 1.0), TSIT5, (2, True)),
    ],
    ids=["cond-miniboone86-K4-B4096", "cond-miniboone86-jvp-B4096", "cond-miniboone860-K4-B256",
         "three-layer-hidden136-ncond2-jvp-K2-B300", "dz66-verner65-reverse-K3-B64", "probe-shared-memory-K2-B256",
         "hidden8000-global-tiles-K2-B16", "hidden8000-global-tiles-jvp-B16", "ncond3-jvp-K2-B1"],
)
def test_stream_cond_probe_kernels_match_twins(dev, dims, B, span, tab, probes):
    """The probe COND instances of the streamed K1 and K2 chain forms (K6 x
    K8) against their twins with the conditioning ys (B, n_cond) and K VJP
    or JVP probes: the forward from nonzero accumulators (equal steps,
    values within REL), the adjoint from its output warm-started from its
    last step (equal steps; z0, acc0, a_z0 and a_ys0 held to the float64
    twin; gradients within GRAD_REL, layer 0's ys rows not zero).  Hidden
    width 8000 sends both instances' tile arrays to the global scratch (the
    shape entries say so); `MLP((65, 128, 128, 120, 64))` with one ys column
    is a wide chain whose wide probe COND instance's shared memory it
    passes.  One launch each, counted under (K, jvp)."""
    k, jvp = probes
    spec = tfs.chain_spec(tcnf.MLP(dims, device=dev), dims[-1])
    assert tfs._stream_chain(spec, True) and tfs._kernel_covers(tab, spec, k, chain=True, jvp=jvp) is None
    nc, dz = dims[0] - dims[-1], dims[-1]
    if dims[1] == 8000:
        assert _tile_scratch_floats(tfs.K1S_KERNEL, "cnf_k1spc_shape", dims, B) > 0
        assert _tile_scratch_floats(tfs.K2S_KERNEL, "cnf_k2spc_shape", dims, B) > 0
    ys = _cond_ys(B, nc, dev)
    kw, adj = _train_args(dims, B, span, dev)
    eps = torch.from_numpy(np.random.default_rng(14).normal(size=(k, B, dz)).astype(np.float32)).to(dev)
    kw.update(ys=ys, eps=eps, jvp=jvp)
    adj.update(ys=ys, eps=eps, jvp=jvp)
    if tab is VERNER65:
        for d in (kw, adj):
            d.update(rtol=3.452669831108329e-4, atol=1.1920929e-7)
    runs = (tfs.run_stream_cond_train_solve_kernel, tfs.run_stream_cond_adjoint_kernel)
    before = [w.probe_launches.get((k, jvp), 0) for w in runs]
    tdir = 1.0 if span[1] > span[0] else -1.0
    with torch.no_grad():
        out_k = runs[0](tab, spec, **kw)
        out_p = tfs.solve_train_plain(tab, spec, **kw)
        adj.update(zT=out_k[0], accT=out_k[1], dt_init=-tdir * out_k[4].abs())
        k2 = [runs[1](tab, spec, **adj), tfs.adjoint_train_plain(tab, spec, **adj),
              _twin64(tfs.adjoint_train_plain, spec, adj, tab)]
    torch.cuda.synchronize()
    assert [w.probe_launches.get((k, jvp), 0) for w in runs] == [n + 1 for n in before]
    _hold_forward(out_k, out_p)
    _hold_cond_adjoint(*k2)
    assert float(k2[0][3][0][dz:].abs().max()) > 0.0


def test_stream_cond_probe_paths_on_the_card_match_the_twins_on_the_cpu(dev):
    """cond_miniboone86 (tspan (0, 1) here) with four VJP probes and with
    one JVP probe on the card and on the CPU at B = 256: the loss and its
    gradient in the params and ys through the probe COND instances of the
    streamed K1 and K2 chain forms, each launching once under (K, jvp) and
    no other kernel."""
    xs, ys, _, ps_np = _cond_miniboone86_inputs(256, 24)

    def run(device, k, jvp):
        icnf = tcnf.construct(tcnf.CondRNODE, tcnf.MLP(COND_MINIBOONE86, device=device), 43, 43, tspan=(0.0, 1.0),
                              steer_rate=0.1, lam3=1e-2,
                              compute_mode=(tcnf.JacVecMode if jvp else tcnf.VecJacMode)(k, fused=True))
        eps = np.random.default_rng(25 + k).normal(size=(k, 256, 86)).astype(np.float32)
        ps = tcnf.params_from_numpy(ps_np, device)
        y = torch.from_numpy(ys).to(device).requires_grad_()
        leaves = [x.requires_grad_() for p in ps for x in (p["w"], p["b"])] + [y]
        l = tcnf.loss(icnf, tcnf.Mode.TRAIN, xs, ps, ys=y, eps=eps, steer_r=0.05)
        return l.detach().cpu(), [g.cpu() for g in torch.autograd.grad(l, leaves)]

    runs = (tfs.run_stream_cond_train_solve_kernel, tfs.run_stream_cond_adjoint_kernel)
    for k, jvp in ((4, False), (1, True)):
        before, probes = _launches(), [w.probe_launches.get((k, jvp), 0) for w in runs]
        l_k, g_k = run(dev, k, jvp)
        after = _launches()
        assert {n: after[n] - before[n] for n in after if after[n] != before[n]} == {
            tfs.K1S_KERNEL + "/cond": 1, tfs.K2S_KERNEL + "/cond": 1}
        assert [w.probe_launches.get((k, jvp), 0) for w in runs] == [n + 1 for n in probes]
        l_c, g_c = run(torch.device("cpu"), k, jvp)
        assert _close(l_k, l_c)
        for a, b in zip(g_k, g_c):
            assert _grad_close(a, b)


def test_stream_cond_probe_gradient_matches_a_float64_solve(dev):
    """cond_miniboone86 at its own span (0, 13), B = 64, four VJP probes: the
    loss gradient in the params and ys through the streamed probe COND
    instances (one launch each) within 2e-2 max|g| of a float64 rtol 1e-7
    solve (the plain path on the card), the loss within 1e-4 of it."""
    xs, ys, _, ps_np = _cond_miniboone86_inputs(64, 26)
    eps = np.random.default_rng(27).normal(size=(4, 64, 86))
    truth = tcnf.SolverOptions(rtol=1e-7, atol=1e-9)

    def run(dtype, fused, solver=None):
        kw = {} if solver is None else {"solver": solver}
        icnf = tcnf.construct(tcnf.CondRNODE, tcnf.MLP(COND_MINIBOONE86, device=dev, dtype=dtype), 43, 43,
                              tspan=(0.0, 13.0), steer_rate=0.1, lam3=1e-2, dtype=dtype,
                              compute_mode=tcnf.VecJacMode(4, fused=fused), **kw)
        leaves = [v.to(dtype).requires_grad_() for p in tcnf.params_from_numpy(ps_np, dev) for v in (p["w"], p["b"])]
        ps = tuple({"w": w, "b": b} for w, b in zip(leaves[::2], leaves[1::2]))
        y = torch.from_numpy(ys).to(device=dev, dtype=dtype).requires_grad_()
        x = torch.from_numpy(xs).to(device=dev, dtype=dtype)
        l = tcnf.loss(icnf, tcnf.Mode.TRAIN, x, ps, ys=y, eps=torch.from_numpy(eps).to(device=dev, dtype=dtype),
                      steer_r=0.05)
        return l.detach().cpu().double(), [g.cpu().double() for g in torch.autograd.grad(l, leaves + [y])]

    before = _launches()
    l_k, g_k = run(torch.float32, True)
    after = _launches()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        tfs.K1S_KERNEL + "/cond": 1, tfs.K2S_KERNEL + "/cond": 1}
    l_t, g_t = run(torch.float64, False, truth)
    assert float((l_k - l_t).abs()) <= 1e-4 * max(1.0, float(l_t.abs()))
    for a, t in zip(g_k, g_t):
        assert torch.isfinite(a).all() and float((a - t).abs().max()) <= 2e-2 * float(t.abs().max())


# ---- the chain kernels with conditioning rows (K8) ----

COND = (2, 64, 64, 1)  # the conditional recipe: x (1) and y (1) in, a 1-wide field


def _ys(B, n_cond, dev, rows=None, seed=9):
    """Conditioning ys (B, n_cond) ~ U(-1, 1); with `rows` = 1 one row
    broadcast to all B samples (a non-contiguous view)."""
    ys = np.random.default_rng(seed).uniform(-1.0, 1.0, (rows or B, n_cond)).astype(np.float32)
    return torch.from_numpy(ys).to(dev).expand(B, n_cond)


def _forward_matches(out_k, out_p):
    """Equal steps; finite z and accumulators within REL of the twin's."""
    B = out_k[0].shape[0]
    return (
        (int(out_k[2]), int(out_k[3])) == (int(out_p[2]), int(out_p[3]))
        and bool(torch.isfinite(out_k[0]).all() and torch.isfinite(out_k[1]).all())
        and _close(out_k[0], out_p[0])
        and all(_close(a, b) for a, b in zip(out_k[1].reshape(-1, B), out_p[1].reshape(-1, B)))
    )


def _adjoint_matches(adj_k, adj_p, adj_64):
    """Equal steps; z0, acc0, a_z0 and (conditional) a_ys0 held to the
    float64 twin (`_state_close`); finite gradients within GRAD_REL of the
    twin's."""
    return (
        (int(adj_k[5]), int(adj_k[6])) == (int(adj_p[5]), int(adj_p[6]))
        and all(_state_close(adj_k[i], adj_p[i], adj_64[i]) for i in (0, 1, 2, 7)[: len(adj_k) - 4])
        and all(bool(torch.isfinite(a).all()) and _grad_close(a, b)
                for a, b in zip(adj_k[3] + adj_k[4], adj_p[3] + adj_p[4]))
    )


def _near_tie_holds(out_k, out_p, twin, spec, kw, state, tab=TSIT5):
    """For a solve that misses its twin's bound: the twin must show a
    near-tie of the step controller under roundoff (`near_tie.witness`: its
    own steps or values move when its inputs move by one float32 ulp), and
    the kernel must meet the near-tie rule (`near_tie.within_near_tie`:
    steps within the twin's own range, each value within 4x the twin's own
    move of it)."""
    steps, spreads = near_tie.witness(twin, tab, spec, kw, state, ref=out_p)
    tol = REL if near_tie.is_forward(out_p) else GRAD_REL
    assert near_tie.shows_near_tie(near_tie.split(out_p)[0], steps, spreads, tol), (
        f"the kernel misses its twin, and the twin shows no near-tie: steps {steps}, spreads {spreads}")
    holds, line = near_tie.within_near_tie(out_k, out_p, steps, spreads, REL, GRAD_REL)
    assert holds, line


# id -> (dims, B, span, rows of ys).
_COND_CASES = {
    "recipe-B1": (COND, 1, (0.0, 13.0), None),
    "recipe-B128": (COND, 128, (0.0, 13.0), None),
    "recipe-B4096": (COND, 4096, (0.0, 13.0), None),
    "recipe-reverse": (COND, 4096, (13.0, 0.0), None),
    "recipe-broadcast-row": (COND, 512, (0.0, 13.0), 1),
    "narrow-ncond2": ((5, 9, 7, 3), 300, (0.0, 2.0), None),
    "two-layer": ((3, 16, 1), 256, (0.0, 4.0), None),
}


@pytest.mark.parametrize("case", list(_COND_CASES))
def test_cond_chain_kernels_match_twins(dev, case):
    """The conditional chain kernels against their twins: forwards with equal
    steps and values within REL, the K2 chain form's steps, states (a_ys0
    among them) and gradients (the ys rows of g_W0 among them) as for the
    unconditional chains.  With one state dimension the norm rates |f| and
    |eps^T J| have kinks, and at a step across one the next step size can
    move with float32 roundoff (near_tie.py); a solve that misses the
    twin's bound is held to the near-tie rule, on an input whose twin shows
    that move."""
    dims, B, span, rows = _COND_CASES[case]
    ys = _ys(B, dims[0] - dims[-1], dev, rows)
    (out_k, out_p), (adj_k, adj_p, adj_64), test, exact, kw, adj = _chain_case(dims, B, span, dev, ys=ys)
    assert len(adj_k) == len(adj_p) == 8
    assert float(adj_k[3][0][dims[-1]:].abs().max()) > 0.0  # the ys rows of g_W0
    spec = tfs.chain_spec(tcnf.MLP(dims, device=dev), dims[-1])
    test_kw = dict(_kernel_args(dims, B, span, dev), ys=ys)
    exact_kw = {k: v for k, v in kw.items() if k != "eps"}
    for (k, p), twin, args in (((out_k, out_p), tfs.solve_train_plain, kw), (test, tfs.solve_test_plain, test_kw),
                               (exact, tfs.solve_train_exact_plain, exact_kw)):
        if not _forward_matches(k, p):
            _near_tie_holds(k, p, twin, spec, args, "z0")
    if not _adjoint_matches(adj_k, adj_p, adj_64):
        _near_tie_holds(adj_k, adj_p, tfs.adjoint_train_plain, spec, adj, "zT")


# ---- chains of every depth: 1-layer nets and 5 to 8 layers ----

# id -> (dims, B, span, form: False narrow, True wide, "stream" streamed);
# a dims[0] wider than dims[-1] is a conditional chain (ys (B, n_cond)).
_DEPTH_CASES = {
    "refbench16-B4096": ((16, 16), 4096, (0.0, 13.0), False),
    "refbench16-B64": ((16, 16), 64, (0.0, 13.0), False),
    "one-layer-dz6-reverse-B37": ((6, 6), 37, (2.0, 0.0), False),
    "one-layer-dz32-B300": ((32, 32), 300, (0.0, 1.0), False),
    "cond-refbench16-B512": ((17, 16), 512, (0.0, 13.0), False),
    "cond-one-layer-ncond2-B300": ((7, 5), 300, (0.0, 2.0), False),
    "five-layer-narrow-B512": ((6, 48, 48, 48, 48, 6), 512, (0.0, 1.0), False),
    "eight-layer-narrow-B1024": ((6,) + (32,) * 7 + (6,), 1024, (0.0, 1.0), False),
    "cond-eight-layer-narrow-B256": ((8,) + (32,) * 7 + (6,), 256, (0.0, 1.0), False),
    "five-layer-power6-wide-B256": ((6, 64, 64, 64, 64, 6), 256, (0.0, 1.0), True),
    "eight-layer-power6-wide-B256": ((6,) + (64,) * 7 + (6,), 256, (0.0, 1.0), True),
    "five-layer-miniboone43-wide-B256": ((43, 64, 64, 64, 64, 43), 256, (0.0, 1.0), True),
    "five-layer-streamed-B128": ((43, 128, 128, 128, 128, 43), 128, (0.0, 1.0), "stream"),
    "five-layer-miniboone860-B64": ((43,) + (860,) * 4 + (43,), 64, (0.0, 1.0), "stream"),
}


@pytest.mark.parametrize("case", list(_DEPTH_CASES))
def test_depth_chain_kernels_match_twins(dev, case):
    """1-layer nets (the reference benchmark suite's Dense(16 => 16, tanh)
    among them) and chains of 5 to 8 layers through the four chain kernels
    of their form, against their twins as the other chains are held; the
    routing agrees with the form (a 5- or 8-layer chain at power6's widths
    passes the narrow forms' shared memory and runs the wide ones).  A
    solve that misses the twin's bound passes under the near-tie rule, on
    an input whose twin shows that move."""
    dims, B, span, form = _DEPTH_CASES[case]
    n_cond = dims[0] - dims[-1]
    spec = tfs.chain_spec(tcnf.MLP(dims, device=dev), dims[-1])
    assert tfs._kernel_covers(TSIT5, spec, chain=True) is None
    assert tfs._wide_chain(spec) == bool(form) and tfs._stream_chain(spec) == (form == "stream")
    ys = _ys(B, n_cond, dev) if n_cond else None
    (out_k, out_p), (adj_k, adj_p, adj_64), test, exact, kw, adj = _chain_case(dims, B, span, dev, ys=ys, wide=form)
    test_kw = dict(_kernel_args(dims, B, span, dev), ys=ys)
    exact_kw = {k: v for k, v in kw.items() if k != "eps"}
    for (k, p), twin, args in (((out_k, out_p), tfs.solve_train_plain, kw), (test, tfs.solve_test_plain, test_kw),
                               (exact, tfs.solve_train_exact_plain, exact_kw)):
        if not _forward_matches(k, p):
            _near_tie_holds(k, p, twin, spec, args, "z0")
    if not _adjoint_matches(adj_k, adj_p, adj_64):
        _near_tie_holds(adj_k, adj_p, tfs.adjoint_train_plain, spec, adj, "zT")


@pytest.mark.parametrize("dims", [(6,) + (16,) * 8 + (6,), (33, 33)], ids=["nine-layer", "one-layer-dz33"])
def test_depth_refusals_raise_on_cuda(dev, dims):
    """Chains past 8 layers (shape variants (b2)) and 1-layer nets past
    state width 32 (shape variants (c2)) raise on the card, naming their
    ROADMAP row; nothing is launched."""
    spec = tfs.chain_spec(tcnf.MLP(dims, device=dev), dims[-1])
    kw = _kernel_args(dims, 8, (0.0, 1.0), dev)
    run = tfs.run_chain_test_solve_kernel
    before = run.launches
    with pytest.raises(NotImplementedError, match="shape variants \\([bc]2\\)"):
        run(TSIT5, spec, **kw)
    assert run.launches == before


def test_refbench16_paths_on_the_card_match_the_twins_on_the_cpu(dev):
    """refbench16 (RNODE 8 + 8, Dense(16 => 16, tanh)) on the card and on
    the CPU at the reference suite's n = 64: logpdf through K7 TEST, the
    Hutchinson loss and gradient through the K1 and K2 chain forms, and the
    exact loss and gradient through K7 exact and the plain backward.  Over
    tspan (0, 13) the backward solve can sit at a near-tie of the step
    controller; a gradient that misses GRAD_REL passes only if the CPU
    path's own gradients move by more than GRAD_REL under one-ulp moves of
    xs (`near_tie.nudge`, four runs) and the card's is within 4x that
    move."""
    dims = (16, 16)
    xs = np.random.default_rng(4).uniform(size=(64, 8)).astype(np.float32)
    eps = np.random.default_rng(5).normal(size=(1, 64, 16)).astype(np.float32)
    ps_np = _np_params(dims, 3)

    def run_at(device, exact, x):
        icnf = tcnf.construct(tcnf.RNODE, tcnf.MLP(dims, device=device), 8, 8, tspan=(0.0, 13.0), steer_rate=0.1,
                              lam3=1e-2, compute_mode=tcnf.VecJacMode(fused=True, exact_trace=exact))
        ps = tcnf.params_from_numpy(ps_np, device)
        with torch.no_grad():
            lp = tcnf.ICNFDist(icnf, tcnf.Mode.TEST, ps).logpdf(x)
        leaves = [x.requires_grad_() for p in ps for x in (p["w"], p["b"])]
        kw = {"steer_r": 0.05} if exact else {"eps": eps, "steer_r": 0.05}
        l, m = tcnf.loss_and_metrics(icnf, tcnf.Mode.TRAIN, x, ps, **kw)
        return lp.cpu(), l.detach().cpu(), [g.cpu() for g in torch.autograd.grad(l, leaves)], int(m["nfe"])

    def run(device, exact):
        return run_at(device, exact, xs)

    for exact in (False, True):
        before = _launches()
        lp_k, l_k, g_k, nfe_k = run(dev, exact)
        after = _launches()
        ran = {k for k in after if after[k] != before[k]}
        want = {tfs.K7_KERNEL + "/test"} | ({tfs.K7_KERNEL + "/exact"} if exact else {tfs.K1C_KERNEL, tfs.K2C_KERNEL})
        assert ran == want
        lp_c, l_c, g_c, nfe_c = run(torch.device("cpu"), exact)
        assert nfe_k == nfe_c and _close(lp_k, lp_c) and _close(l_k, l_c)
        if all(_grad_close(a, b) for a, b in zip(g_k, g_c)):
            continue
        gen = torch.Generator().manual_seed(0)
        spreads = [0.0] * len(g_c)
        for _ in range(4):
            xs_moved = near_tie.nudge(torch.from_numpy(xs), gen).numpy()
            _, _, g_n, _ = run_at(torch.device("cpu"), exact, xs_moved)
            spreads = [max(d, _rel(a, b)) for d, a, b in zip(spreads, g_n, g_c)]
        assert max(spreads) > GRAD_REL, f"no near-tie: the CPU gradients move by {spreads}"
        for a, b, d in zip(g_k, g_c, spreads):
            assert _rel(a, b) <= max(GRAD_REL, 4.0 * d)


def test_cond_paths_on_the_card_match_the_twins_on_the_cpu(dev):
    """The conditional recipe on the card and on the CPU: CondICNFDist.logpdf
    and sample through K7 TEST, the Hutchinson loss and its gradient in the
    params and ys through the K1 and K2 chain forms, and the exact loss and
    gradient through K7 exact and the plain backward."""
    B = 512
    rng = np.random.default_rng(4)
    ys_np = rng.uniform(-1.0, 1.0, (B, 1)).astype(np.float32)
    xs = (0.7 * ys_np + 0.3 * rng.normal(size=(B, 1))).astype(np.float32)
    eps = rng.normal(size=(1, B, 1)).astype(np.float32)
    z1 = rng.normal(size=(B, 1)).astype(np.float32)
    ps_np = _np_params(COND, 3)

    def run(device, exact):
        icnf = tcnf.construct(tcnf.CondRNODE, tcnf.MLP(COND, device=device), 1, tspan=(0.0, 13.0), steer_rate=0.1,
                              compute_mode=tcnf.VecJacMode(fused=True, exact_trace=exact))
        ps = tcnf.params_from_numpy(ps_np, device)
        with torch.no_grad():
            dist = tcnf.CondICNFDist(icnf, tcnf.Mode.TEST, ps, torch.from_numpy(ys_np).to(device))
            lp, smp = dist.logpdf(xs), dist.sample(B, z1=z1)
        ys = torch.from_numpy(ys_np).to(device).requires_grad_()
        leaves = [x.requires_grad_() for p in ps for x in (p["w"], p["b"])]
        kw = {} if exact else {"eps": eps}
        l, m = tcnf.loss_and_metrics(icnf, tcnf.Mode.TRAIN, xs, ps, ys=ys, steer_r=0.03, **kw)
        grads = torch.autograd.grad(l, leaves + [ys])
        return lp.cpu(), smp.cpu(), l.detach().cpu(), [g.cpu() for g in grads], int(m["nfe"])

    for exact in (False, True):
        before = _launches()
        lp_k, s_k, l_k, g_k, nfe_k = run(dev, exact)
        after = _launches()
        ran = {k for k in after if after[k] != before[k]}
        want = {tfs.K7_KERNEL + "/test"} | ({tfs.K7_KERNEL + "/exact"} if exact else {tfs.K1C_KERNEL, tfs.K2C_KERNEL})
        assert ran == want
        lp_c, s_c, l_c, g_c, nfe_c = run(torch.device("cpu"), exact)
        assert nfe_k == nfe_c and _close(lp_k, lp_c) and _close(s_k, s_c) and _close(l_k, l_c)
        for a, b in zip(g_k, g_c):
            assert _grad_close(a, b)


def test_deep_exact_adjoint_is_refused_on_the_card(dev):
    """K7 is forward-only, as in the JAX package: the exact adjoint wrapper
    refuses a 3-layer chain on the card, and the fused exact model has no
    backward member."""
    dims = (5, 9, 7, 5)
    icnf = tcnf.construct(tcnf.RNODE, tcnf.MLP(dims, device=dev), 3, 2,
                          compute_mode=tcnf.VecJacMode(fused=True, exact_trace=True))
    assert tfs.make_full_solve(icnf, tcnf.Mode.TRAIN, 8).adjoint is None
    spec = tfs.chain_spec(icnf.nn, 5)
    kw, adj = _exact_args(dims, 8, (0.0, 1.0), dev)
    adj.update(zT=kw["z0"], accT=kw["acc0"], dt_init=torch.tensor(-0.05, device=dev))
    with pytest.raises(ValueError, match="forward-only"):
        tfs.run_exact_adjoint_kernel(TSIT5, spec, **adj)


# ---- K9: every embedded explicit tableau, identity layers ----

# id -> (dims, last activation, tableau, rtol, atol, B, span)
_K9_CASES = {
    "identity-out": ((5, 15, 5), None, TSIT5, 1e-3, 1e-6, 64, (0.0, 2.0)),
    "dopri5": ((5, 15, 5), torch.tanh, DOPRI5, 1e-3, 1e-6, 64, (0.0, 2.0)),
    "bosh3": ((5, 15, 5), torch.tanh, BOSH3, 1e-3, 1e-6, 64, (0.0, 2.0)),
    "K9-tableau": ((16, 48, 16), torch.tanh, VERNER65, 3.452669831108329e-4, 1.1920929e-7, 512, (0.0, 13.0)),
    "K9-identity-layer": ((16, 48, 16), None, VERNER65, 3.452669831108329e-4, 1.1920929e-7, 512, (0.0, 13.0)),
    "K9-chain-identity-layer": ((5, 9, 7, 5), None, TSIT5, 1e-3, 1e-6, 300, (0.0, 2.0)),
    "verner65-power6": (POWER6, torch.tanh, VERNER65, 3.452669831108329e-4, 1.1920929e-7, 4096, (0.0, 1.0)),
    "dop853-power6": (POWER6, torch.tanh, DOP853, 1e-6, 1e-8, 256, (0.0, 1.0)),
}


def _k9_hold(out_k, out_p, twin, tab, spec, kw, state, adj_64=None):
    """A K9 solve against its twin: the twin's bound (equal steps; values
    within REL, an adjoint's state as `_state_close` and gradients within
    GRAD_REL), else a forward's last-step tie (`near_tie.last_step_tie`),
    else the near-tie rule on an input whose twin shows a near-tie."""
    if near_tie.is_forward(out_k):
        if _forward_matches(out_k, out_p) or near_tie.last_step_tie(out_k, out_p, REL)[0]:
            return
    elif _adjoint_matches(out_k, out_p, adj_64):
        return
    _near_tie_holds(out_k, out_p, twin, spec, kw, state, tab)


@pytest.mark.parametrize("case", list(_K9_CASES))
def test_k9_kernels_match_twins(dev, case):
    """Every kernel family under each embedded tableau (bosh3, dopri5, tsit5,
    verner65 with its non-FSAL refresh, dop853 with its stretched estimate)
    and with identity layers, against its twin, each launch counted.  Nets
    with an identity layer run only the chain kernels; the 2-layer kernels
    refuse them.  dop853 at rtol 1e-6 sits where the float32 error estimate
    is roundoff (the float64 twin takes a third of the steps), so its
    solves are held to the near-tie rule where they miss the bound."""
    dims, final, tab, rtol, atol, B, span = _K9_CASES[case]
    mlp = tcnf.MLP(dims, final_activation=final, device=dev)
    spec = tfs.chain_spec(mlp, dims[-1])
    kw, adj = _train_args(dims, B, span, dev)
    test_kw = _kernel_args(dims, B, span, dev)
    for d in (kw, adj, test_kw):
        d.update(rtol=rtol, atol=atol)
    exact_kw = {k: v for k, v in kw.items() if k != "eps"}
    tdir = torch.sign(kw["t1"] - kw["t0"])
    two_layer = spec.n_layers == 2 and all(spec.acts)
    families = [(tfs.run_chain_train_solve_kernel, tfs.solve_train_plain, tfs.run_chain_adjoint_kernel,
                 tfs.run_chain_test_solve_kernel, tfs.run_chain_exact_solve_kernel, None)]
    if two_layer:
        families.append((tfs.run_train_solve_kernel, tfs.solve_train_plain, tfs.run_adjoint_kernel,
                         tfs.run_solve_kernel, tfs.run_exact_solve_kernel, tfs.run_exact_adjoint_kernel))
    elif spec.n_layers == 2:
        for run, args in ((tfs.run_solve_kernel, test_kw), (tfs.run_train_solve_kernel, kw)):
            with pytest.raises(NotImplementedError, match="identity"):
                run(tab, spec, **args)
    for run_train, _, run_adj, run_test, run_exact, run_exact_adj in families:
        wrappers = [w for w in (run_train, run_adj, run_test, run_exact, run_exact_adj) if w is not None]
        before = [w.launches for w in wrappers]
        with torch.no_grad():
            out_k = run_train(tab, spec, **kw)
            out_p = tfs.solve_train_plain(tab, spec, **kw)
            a = dict(adj, zT=out_k[0], accT=out_k[1], dt_init=-tdir * out_k[4].abs())
            adj_k, adj_p = run_adj(tab, spec, **a), tfs.adjoint_train_plain(tab, spec, **a)
            adj_64 = _twin64(tfs.adjoint_train_plain, spec, a, tab)
            test_k, test_p = run_test(tab, spec, **test_kw), tfs.solve_test_plain(tab, spec, **test_kw)
            ex_k, ex_p = run_exact(tab, spec, **exact_kw), tfs.solve_train_exact_plain(tab, spec, **exact_kw)
        torch.cuda.synchronize()
        assert [w.launches for w in wrappers[:4]] == [n + 1 for n in before[:4]]
        assert all(len(o) == 6 and float(o[5]) != 0.0 for o in (out_k, test_k, ex_k))
        _k9_hold(out_k, out_p, tfs.solve_train_plain, tab, spec, kw, "z0")
        _k9_hold(adj_k, adj_p, tfs.adjoint_train_plain, tab, spec, a, "zT", adj_64)
        _k9_hold(test_k, test_p, tfs.solve_test_plain, tab, spec, test_kw, "z0")
        _k9_hold(ex_k, ex_p, tfs.solve_train_exact_plain, tab, spec, exact_kw, "z0")
        if run_exact_adj is not None:
            e = {k: v for k, v in adj.items() if k != "eps"}
            e.update(zT=ex_k[0], accT=ex_k[1], dt_init=-tdir * ex_k[4].abs())
            with torch.no_grad():
                e_k, e_p = run_exact_adj(tab, spec, **e), tfs.adjoint_train_exact_plain(tab, spec, **e)
                e_64 = _twin64(tfs.adjoint_train_exact_plain, spec, e, tab)
            assert run_exact_adj.launches == before[4] + 1
            _k9_hold(e_k, e_p, tfs.adjoint_train_exact_plain, tab, spec, e, "zT", e_64)


@pytest.mark.parametrize("mode", ["test", "train", "exact"])
def test_identity_nets_run_the_chain_kernels(dev, mode):
    """`make_full_solve` runs a 2-layer net with an identity layer through
    the chain kernels, forward and (Hutchinson TRAIN) backward, and no
    2-layer kernel; its exact gradient runs K7 exact and the plain
    backward.  The result matches the same path on the CPU."""
    dims = (5, 15, 5)
    ps_np = _np_params(dims, 6)
    xs = np.random.default_rng(7).uniform(size=(64, 3)).astype(np.float32)
    eps = np.random.default_rng(8).normal(size=(1, 64, 5)).astype(np.float32)
    cm = tcnf.VecJacMode(fused=True, exact_trace=mode == "exact")

    def run(device):
        icnf = tcnf.construct(tcnf.RNODE, tcnf.MLP(dims, final_activation=None, device=device), 3, 2,
                              compute_mode=cm)
        ps = tcnf.params_from_numpy(ps_np, device)
        if mode == "test":
            with torch.no_grad():
                return [tcnf.inference(icnf, tcnf.Mode.TEST, xs, ps)[0].cpu()]
        leaves = [x.requires_grad_() for p in ps for x in (p["w"], p["b"])]
        l = tcnf.loss(icnf, tcnf.Mode.TRAIN, xs, ps, steer_r=0.0, **({} if mode == "exact" else {"eps": eps}))
        return [l.detach().cpu()] + [g.cpu() for g in torch.autograd.grad(l, leaves)]

    before = _launches()
    got = run(dev)
    after = _launches()
    ran = {k for k in after if after[k] != before[k]}
    want = {"test": {tfs.K7_KERNEL + "/test"}, "train": {tfs.K1C_KERNEL, tfs.K2C_KERNEL},
            "exact": {tfs.K7_KERNEL + "/exact"}}[mode]
    assert ran == want
    ref = run(torch.device("cpu"))
    assert _close(got[0], ref[0])
    for a, b in zip(got[1:], ref[1:]):
        assert _grad_close(a, b)


def test_deep_test_gradient_runs_k7_and_the_plain_backward(dev):
    """The power6 TEST loss and its gradient on the card: K7 TEST forward,
    then the plain BACKSOLVE backward (the JAX package has no TEST backward
    kernel for deeper chains), against a float64 solve on the card within
    2e-2 max|g|."""
    xs = np.random.default_rng(4).normal(size=(512, 6)).astype(np.float32)
    ps_np = _np_params(POWER6, 3)

    def run(dtype, fused):
        icnf = tcnf.construct(tcnf.RNODE, tcnf.MLP(POWER6, device=dev, dtype=dtype), 6, dtype=dtype,
                              compute_mode=tcnf.VecJacMode(fused=fused))
        ps = [{k: v.to(dtype).requires_grad_() for k, v in p.items()} for p in tcnf.params_from_numpy(ps_np, dev)]
        l = tcnf.loss(icnf, tcnf.Mode.TEST, xs, ps)
        return l.detach(), torch.autograd.grad(l, [x for p in ps for x in (p["w"], p["b"])])

    before = _launches()
    l_k, g_k = run(torch.float32, True)
    after = _launches()
    assert {k for k in after if after[k] != before[k]} == {tfs.K7_KERNEL + "/test"}
    assert after[tfs.K7_KERNEL + "/test"] == before[tfs.K7_KERNEL + "/test"] + 1
    l_64, g_64 = run(torch.float64, False)
    assert _close(l_k.double(), l_64)
    for a, b in zip(g_k, g_64):
        assert float((a.double() - b).abs().max()) <= 2e-2 * float(b.abs().max())


def test_last_step_tie_of_the_recipe(dev):
    """The conditional recipe at B = 4096, norm rates off: the K1 chain form
    once took 11 steps against its twin's 10 with every value within 6e-6,
    a move no one-ulp nudge of the inputs reproduced.  The kernels return
    the last step taken, so such a solve is held to the last-step rule (one
    solve reaches t1 at once, the other stops short and takes one more,
    shorter step); otherwise the twin's bound or the near-tie rule holds."""
    dims, B, span = near_tie.CASES["recipe-B4096"]
    spec = tfs.chain_spec(tcnf.MLP(dims, device=dev), dims[-1])
    train, _, _ = near_tie.case_inputs(dims, B, span, dev)
    train.update(norm_z=False, norm_j=False)
    n = tfs.run_chain_train_solve_kernel.launches
    with torch.no_grad():
        out_k = tfs.run_chain_train_solve_kernel(TSIT5, spec, **train)
        out_p = tfs.solve_train_plain(TSIT5, spec, **train)
    assert tfs.run_chain_train_solve_kernel.launches == n + 1
    assert float(out_k[5]) > 0.0  # the last step taken, forward in time
    if _forward_matches(out_k, out_p):
        return
    holds, line = near_tie.last_step_tie(out_k, out_p, REL)
    if not holds:
        _near_tie_holds(out_k, out_p, tfs.solve_train_plain, spec, train, "z0")


# ---- K5: the TEST backward of 2-layer nets, conditional or not ----

# id -> (dims, n_cond, B, tableau, rtol, atol, span)
_K5_CASES = {
    "flagship-B4096": ((16, 48, 16), 0, 4096, TSIT5, 1e-3, 1e-6, (0.0, 13.0)),
    "flagship-B37": ((16, 48, 16), 0, 37, TSIT5, 1e-3, 1e-6, (0.0, 13.0)),
    "dz5-B1": ((5, 15, 5), 0, 1, TSIT5, 1e-3, 1e-6, (0.0, 2.0)),
    "dz5-reverse": ((5, 15, 5), 0, 300, TSIT5, 1e-3, 1e-6, (2.0, 0.0)),
    "dz32": ((32, 40, 32), 0, 512, TSIT5, 1e-3, 1e-6, (0.0, 1.0)),
    "readme-verner65": ((2, 6, 2), 0, 1024, VERNER65, 3.452669831108329e-4, 1.1920929e-7, (0.0, 13.0)),
    "dz5-dop853": ((5, 15, 5), 0, 256, DOP853, 1e-6, 1e-8, (0.0, 2.0)),
    "cond-flagship-B4096": ((17, 48, 16), 1, 4096, TSIT5, 1e-3, 1e-6, (0.0, 13.0)),
    "cond-ncond2": ((7, 15, 5), 2, 300, TSIT5, 1e-3, 1e-6, (0.0, 2.0)),
}


def _k5_inputs(dims, n_cond, B, tab, rtol, atol, span, dev, seed=0):
    """The TEST forward's twin from [x | 0] and nonzero dlogp0, then K5's
    arguments from its output: a loss-like cotangent and its last step as
    the warm start."""
    ps = tcnf.params_from_numpy(_np_params(dims, seed), dev)
    rng = np.random.default_rng(seed + 1)
    T = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    dz = dims[-1]
    spec = tfs.chain_spec(tcnf.MLP(dims, device=dev), dz)
    ys = _ys(B, n_cond, dev) if n_cond else None
    kw = dict(rtol=rtol, atol=atol, max_steps=10_000, ws=[p["w"] for p in ps], bs=[p["b"] for p in ps], ys=ys)
    t0, t1 = torch.tensor(span[0], device=dev), torch.tensor(span[1], device=dev)
    with torch.no_grad():
        zT, lT, *_, dt_last, _ = tfs.solve_test_plain(
            tab, spec, **kw, z0=T(rng.uniform(size=(B, dz))), dlogp0=T(rng.normal(0.0, 0.1, B)), t0=t0, t1=t1,
            dt_init=torch.sign(t1 - t0) * 0.05,
        )
    adj = dict(kw, zT=zT, accT=lT[None], azT=T(rng.normal(0.0, 1.0 / B, (B, dz))), aaccT=T(np.full((1, B), 1.0 / B)),
               t_hi=t1, t_lo=t0, dt_init=-dt_last)
    return spec, adj


@pytest.mark.parametrize("case", list(_K5_CASES))
def test_test_adjoint_kernel_matches_twin(dev, case):
    """K5 (its COND instance for a conditional net) against its twin from the
    same final state, cotangent and warm start: equal steps, z0, dlogp0,
    a_z0 and a_ys0 held to the float64 twin (`_state_close`), finite
    gradients within GRAD_REL (the batch sums in another order); a solve
    that misses that bound passes only under the near-tie rule, on an input
    whose twin shows a near-tie.  One launch each."""
    dims, n_cond, B, tab, rtol, atol, span = _K5_CASES[case]
    spec, adj = _k5_inputs(dims, n_cond, B, tab, rtol, atol, span, dev)
    n = tfs.run_test_adjoint_kernel.launches
    with torch.no_grad():
        out_k = tfs.run_test_adjoint_kernel(tab, spec, **adj)
        out_p = tfs.adjoint_test_plain(tab, spec, **adj)
        out_64 = _twin64(tfs.adjoint_test_plain, spec, adj, tab)
    torch.cuda.synchronize()
    assert tfs.run_test_adjoint_kernel.launches == n + 1
    assert len(out_k) == len(out_p) == (8 if n_cond else 7)
    if n_cond:
        assert out_k[7].shape == (B, n_cond) and float(out_k[3][0][dims[-1]:].abs().max()) > 0.0
    if not _adjoint_matches(out_k, out_p, out_64):
        _near_tie_holds(out_k, out_p, tfs.adjoint_test_plain, spec, adj, "zT", tab)


@pytest.mark.parametrize("case", ["cap", "empty-span"])
def test_test_adjoint_kernel_edge_cases_match_twin(dev, case):
    """K5 capped at five steps (counts only, as for K2) and over an empty
    span (no step, the state and zero gradients returned)."""
    spec, adj = _k5_inputs((16, 48, 16), 0, 64, TSIT5, 1e-3, 1e-6, (0.0, 13.0), dev)
    if case == "cap":
        adj["max_steps"] = 5
    else:
        adj["t_hi"] = adj["t_lo"].clone()
    with torch.no_grad():
        out_k = tfs.run_test_adjoint_kernel(TSIT5, spec, **adj)
        out_p = tfs.adjoint_test_plain(TSIT5, spec, **adj)
    assert (int(out_k[5]), int(out_k[6])) == (int(out_p[5]), int(out_p[6]))
    if case == "cap":
        assert int(out_k[5]) == 5 and all(torch.isfinite(g).all() for g in out_k[3] + out_k[4])
        return
    assert int(out_k[5]) == 0 and torch.equal(out_k[0], adj["zT"]) and torch.equal(out_k[2], adj["azT"])
    assert all(float(g.abs().max()) == 0.0 for g in out_k[3] + out_k[4])


@pytest.mark.parametrize("cond", [False, True], ids=["flagship", "conditional"])
def test_test_gradient_on_the_card_matches_the_twins_on_the_cpu(dev, cond):
    """The TEST loss and its gradient in the params, xs and (conditional) ys
    on the card, the forward in K3 (K7 TEST with ys for a conditional net)
    and the backward in K5, against the same call on the CPU, where the
    fused path runs the kernels' twins; then the params-gradient of
    `generate`'s samples (the reverse-time solve) the same way."""
    dims = (17, 48, 16) if cond else (16, 48, 16)
    ps_np = _np_params(dims, 3)
    rng = np.random.default_rng(4)
    B = 512
    xs = rng.uniform(size=(B, 8)).astype(np.float32)
    ys_np = rng.uniform(-1.0, 1.0, (B, 1)).astype(np.float32) if cond else None
    z1 = rng.normal(size=(B, 16)).astype(np.float32)

    def run(device):
        icnf = tcnf.construct(tcnf.CondRNODE if cond else tcnf.RNODE, tcnf.MLP(dims, device=device), 8, 8,
                              tspan=(0.0, 13.0), compute_mode=tcnf.VecJacMode(fused=True))
        ps = tcnf.params_from_numpy(ps_np, device)
        leaves = [x.requires_grad_() for p in ps for x in (p["w"], p["b"])]
        x = torch.from_numpy(xs).to(device).requires_grad_()
        extra = []
        kw = {}
        if cond:
            kw["ys"] = torch.from_numpy(ys_np).to(device).requires_grad_()
            extra = [kw["ys"]]
        l = tcnf.loss(icnf, tcnf.Mode.TEST, x, ps, **kw)
        grads = torch.autograd.grad(l, leaves + [x] + extra)
        s = tcnf.generate(icnf, tcnf.Mode.TEST, ps, B, z1=z1, **({"ys": kw["ys"].detach()} if cond else {}))
        g_gen = torch.autograd.grad(torch.sum(s * s), leaves)
        return l.detach().cpu(), [g.cpu() for g in grads + g_gen]

    before = _launches()
    l_k, g_k = run(dev)
    after = _launches()
    forward = tfs.K7_KERNEL + "/test" if cond else tfs.K3_KERNEL
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {forward: 2, tfs.K5_KERNEL: 2}
    l_c, g_c = run(torch.device("cpu"))
    assert _close(l_k, l_c)
    for a, b in zip(g_k, g_c):
        assert torch.isfinite(a).all() and _grad_close(a, b)


# ---- bf16 stage matmuls: bf16 K3, K1 and K2 (tensor cores) ----

def _bf16_one_step_holds(out_k, out_p, dt):
    """One attempted step of a bf16 kernel against its twin.  The tensor
    core's sums part from the twin's at float32 roundoff (more where a sum
    cancels), and where that moves a value across a bf16 rounding boundary
    the next product sees one operand a bf16 ulp away, 2^-7 of it at most:
    that moves the samples that hold it, a few of a batch.  So each
    sample's state and accumulators (an adjoint's z and a_z) within REL but
    for at most one sample in eight, each within 7 stages x 2^-7 x |dt| of
    max(1, max|.|); an adjoint's gradients (batch sums) within
    max(GRAD_REL, that bound).  A fault in the field's layout moves every
    sample."""
    (s_k, vk), (_, vp) = near_tie.split(out_k), near_tie.split(out_p)
    assert s_k == 1
    bound, B = 7 * 2.0**-7 * abs(dt), out_p[0].shape[0]
    rows = len(vk) if near_tie.is_forward(out_k) else 2
    apart = torch.zeros(B, dtype=torch.bool, device=out_p[0].device)
    for a, b in zip(vk[:rows], vp[:rows]):
        d = (a - b).abs().reshape(B, -1).amax(dim=1) / max(1.0, float(b.abs().max()))
        assert float(d.max()) <= bound
        apart |= d > REL
    assert int(apart.sum()) <= B // 8
    for a, b in zip(vk[rows:], vp[rows:]):
        assert near_tie.rel(a, b) <= max(GRAD_REL, bound)


def _bf16_holds(out_k, out_p, twin, spec, kw):
    """A bf16 kernel against its bf16 twin under `near_tie.within_bf16_noise`:
    at bf16's noise floor the step grid and the values follow roundoff, so
    the kernel is held to max(2, steps / 20) steps or the twin's own range
    and to 4x the twin's own spread under one-ulp moves of its inputs (4
    runs; 16 below 1024 samples, whose error norm averages fewer)."""
    n = 4 if near_tie.split(out_p)[1][0].shape[0] >= 1024 else 16
    steps, spreads = near_tie.roundoff_witness(twin, TSIT5, spec, kw, ref=out_p, n=n)
    holds, line = near_tie.within_bf16_noise(out_k, out_p, spreads, REL, GRAD_REL, steps)
    assert holds, line


@pytest.mark.parametrize(
    "dims,B,span",
    [
        ((16, 48, 16), 4096, (0.0, 13.0)),
        ((16, 48, 16), 4096, (0.0, 1.0)),
        ((16, 48, 16), 4000, (0.0, 1.0)),
        ((16, 48, 16), 4003, (0.0, 1.0)),
        ((5, 15, 5), 37, (0.0, 1.0)),
        ((32, 64, 32), 256, (0.0, 1.0)),
    ],
    ids=["flagship", "microbench", "B4000", "ragged-warp", "padded", "dz32"],
)
def test_bf16_kernels_match_twins(dev, dims, B, span):
    """bf16 K3 and K1 from nonzero accumulators and bf16 K2 from bf16 K1's
    output against their bf16 twins on the card, each launched once: one
    attempted step (the field itself, padding included;
    `_bf16_one_step_holds`), then the whole solve under the bf16 rule; B = 4000 fills its
    last tile in part and B = 4003 and 37 end in a ragged warp; the f32
    kernel on the same input takes another step grid or another result."""
    import functools

    spec = tfs.chain_spec(tcnf.MLP(dims), dims[-1])
    test = _kernel_args(dims, B, span, dev)
    rng = np.random.default_rng(7)
    T = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    train = {k: v for k, v in test.items() if k != "dlogp0"}
    train.update(norm_z=True, norm_j=True, eps=T(rng.normal(size=(1, B, dims[-1]))),
                 acc0=T(rng.normal(0.0, 0.5, (3, B))))
    pairs = ((tfs.run_bf16_solve_kernel, tfs.solve_test_plain, tfs.run_solve_kernel, test),
             (tfs.run_bf16_train_solve_kernel, tfs.solve_train_plain, tfs.run_train_solve_kernel, train),
             (tfs.run_bf16_adjoint_kernel, tfs.adjoint_train_plain, tfs.run_adjoint_kernel, None))
    out_train = None
    for kernel, twin, f32, kw in pairs:
        if kw is None:
            kw = {k: v for k, v in train.items() if k not in ("z0", "acc0", "t0", "t1", "dt_init")}
            kw.update(zT=out_train[0], accT=out_train[1], azT=T(rng.normal(0.0, 1.0 / B, (B, dims[-1]))),
                      aaccT=T(rng.normal(0.0, 1.0 / B, (3, B))), t_hi=test["t1"], t_lo=test["t0"],
                      dt_init=-out_train[4].abs())
        twin = functools.partial(twin, bf16=True)
        with torch.no_grad():
            one_k, one_p = (fn(TSIT5, spec, **dict(kw, max_steps=1)) for fn in (kernel, twin))
        _bf16_one_step_holds(one_k, one_p, float(kw["dt_init"]))
        before = kernel.launches
        with torch.no_grad():
            out_k = kernel(TSIT5, spec, **kw)
            out_p = twin(TSIT5, spec, **kw)
            out_f = f32(TSIT5, spec, **kw)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        _bf16_holds(out_k, out_p, twin, spec, kw)
        (s_k, v_k), (s_f, v_f) = near_tie.split(out_k), near_tie.split(out_f)
        assert s_k != s_f or max(near_tie.rel(a, b) for a, b in zip(v_k, v_f)) > REL
        if out_train is None and kernel is tfs.run_bf16_train_solve_kernel:
            out_train = out_k


def test_bf16_paths_launch_only_the_bf16_kernels(dev):
    """Under `VecJacMode(fused=True, bf16=True)` (microbench: the flagship
    at tspan (0, 1)) logpdf and sample launch bf16 K3 once each, the loss
    gradient bf16 K1 and K2 once each, `fit` (two Lion steps) each at least
    twice, and nothing else launches: no f32 kernel stands in."""
    from continuousnf_tpu_torch.utils.configs import MODELS, make_icnf, model_data

    icnf = make_icnf("microbench", dev, bf16=True)
    rng = np.random.default_rng(8)
    ps_np = _np_params(MODELS["microbench"]["dims"], 8)
    ps = tcnf.params_from_numpy(ps_np, dev)
    xs = torch.from_numpy(model_data("microbench", rng, 512)).to(dev)

    def launched(fn):
        tfs.reset_launches()
        fn()
        torch.cuda.synchronize()
        return {k: w.launches for k, w in tfs.KERNEL_WRAPPERS.items() if w.launches}

    dist = tcnf.ICNFDist(icnf, tcnf.Mode.TEST, ps)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        assert launched(lambda: dist.logpdf(xs)) == {tfs.K3B_KERNEL: 1}
        assert launched(lambda: dist.sample(512, generator=gen)) == {tfs.K3B_KERNEL: 1}
    leaves = [x.requires_grad_() for p in ps for x in (p["w"], p["b"])]
    grads = []
    assert launched(lambda: grads.extend(torch.autograd.grad(
        tcnf.loss(icnf, tcnf.Mode.TRAIN, xs, ps, generator=gen), leaves))) == {tfs.K1B_KERNEL: 1, tfs.K2B_KERNEL: 1}
    assert all(torch.isfinite(g).all() for g in grads)
    model = tcnf.ICNFModel(icnf, n_epochs=1, batch_size=256)
    X = torch.from_numpy(model_data("microbench", rng, 512)).to(dev)
    fitted = launched(lambda: tcnf.fit(model, X, ps=tcnf.params_from_numpy(ps_np, dev)))
    assert set(fitted) == {tfs.K1B_KERNEL, tfs.K2B_KERNEL} and min(fitted.values()) >= 2


@pytest.mark.parametrize(
    "case",
    ["three-layer", "two-probes", "jvp", "state-42", "hidden-96", "conditional", "exact", "test-gradient"],
)
def test_bf16_refusals_name_the_row_on_the_card(dev, case):
    """The bf16 configurations the kernels do not cover raise on the card,
    naming ROADMAP's bf16 row, before any f32 kernel runs."""
    dims = {"three-layer": (6, 64, 64, 6), "state-42": (42, 126, 42), "hidden-96": (16, 96, 16),
            "conditional": (17, 48, 16)}.get(case, (16, 48, 16))
    nvars = {"three-layer": 6, "state-42": 21}.get(case, 8)
    mode = dict(num_probes=2 if case == "two-probes" else 1, fused=True, bf16=True, exact_trace=case == "exact")
    cm = (tcnf.JacVecMode if case == "jvp" else tcnf.VecJacMode)(**mode)
    icnf = tcnf.construct(tcnf.CondRNODE if case == "conditional" else tcnf.RNODE, tcnf.MLP(dims, device=dev), nvars,
                          dims[-1] - nvars, tspan=(0.0, 1.0), compute_mode=cm)
    ps = tcnf.params_from_numpy(_np_params(dims, 9), dev)
    leaves = [x.requires_grad_() for p in ps for x in (p["w"], p["b"])]
    xs = torch.from_numpy(np.random.default_rng(10).uniform(size=(64, nvars)).astype(np.float32)).to(dev)
    kw = {"ys": torch.zeros(64, 1, device=dev)} if case == "conditional" else {}
    mode = tcnf.Mode.TEST if case in ("conditional", "test-gradient") else tcnf.Mode.TRAIN
    tfs.reset_launches()
    with pytest.raises(NotImplementedError, match="bf16 stage dots"):
        torch.autograd.grad(tcnf.loss(icnf, mode, xs, ps, **kw), leaves)
    assert not {k for k, w in tfs.KERNEL_WRAPPERS.items() if w.launches} - {tfs.K3B_KERNEL}
