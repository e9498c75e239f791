"""The K3 CUDA kernel against its plain PyTorch version, on the card.

These tests need a CUDA device and skip elsewhere.  On a machine with a card
(and without JAX, whose conftest this file does not need):

    python -m pytest --noconftest -o addopts='' -m gpu tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import continuousnf_tpu_torch as tcnf
from continuousnf_tpu_torch.ode.tableaus import DOPRI5, TSIT5
from continuousnf_tpu_torch.ops import fused_solve as tfs

pytestmark = pytest.mark.gpu

# Kernel and plain version sum in other orders (f32): a relative bound.
REL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _np_params(dims, seed):
    rng = np.random.default_rng(seed)
    ps = []
    for din, dout in zip(dims[:-1], dims[1:]):
        lim = np.sqrt(6.0 / (din + dout))
        ps.append({
            "w": rng.uniform(-lim, lim, (din, dout)).astype(np.float32),
            "b": rng.normal(0.0, 0.05, (dout,)).astype(np.float32),
        })
    return tuple(ps)


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
        zk, lk, sk, ak, dk = tfs.run_solve_kernel(TSIT5, spec, **kw)
        zp, lp, sp, ap, dp = tfs.solve_test_plain(TSIT5, spec, **kw)
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
        ((5, 9, 7, 5), torch.tanh, TSIT5),
        ((5, 15, 5), None, TSIT5),
        ((5, 15, 5), torch.tanh, DOPRI5),
        ((40, 48, 40), torch.tanh, TSIT5),
    ],
    ids=["three-layer", "identity-out", "dopri5", "dz40"],
)
def test_uncovered_configs_raise_on_cuda(dev, dims, final, tab):
    spec = tfs.chain_spec(tcnf.MLP(dims, final_activation=final), dims[-1])
    kw = _kernel_args(dims, 8, (0.0, 1.0), dev)
    before = tfs.run_solve_kernel.launches
    with pytest.raises(NotImplementedError):
        tfs.run_solve_kernel(tab, spec, **kw)
    assert tfs.run_solve_kernel.launches == before


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
        zk, lk, sk, ak, _ = tfs.run_solve_kernel(TSIT5, spec, **kw)
        zp, lp, sp, ap, _ = tfs.solve_test_plain(TSIT5, spec, **kw)
    assert (int(sk), int(ak)) == (int(sp), int(ap))
    if case == "cap":
        # Where a capped solve stops in time follows step sizes set by an
        # eest at f32 roundoff level, so only the counts are compared.
        assert int(sk) == 5 and torch.isfinite(zk).all() and torch.isfinite(lk).all()
    else:
        assert _close(zk, zp) and _close(lk, lp)
    if case == "empty-span":
        assert int(sk) == 0 and torch.equal(zk, kw["z0"]) and torch.equal(lk, kw["dlogp0"])
