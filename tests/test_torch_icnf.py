"""The port's slice end to end against the JAX package: TEST-mode
`inference`, `generate` and `ICNFDist`, with the same numpy params, inputs and
base draws, against the JAX unfused path and its interpret-mode kernel."""

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

TOL = dict(rtol=1e-4, atol=1e-4)
REPO = Path(__file__).resolve().parents[1]

# (dims, nvars, naug, batch, tspan): the small config of the JAX package's
# fused-solve tests, and the flagship widths at a small batch.
CONFIGS = {
    "small": ((5, 15, 5), 3, 2, 16, (0.0, 1.0)),
    "flagship": ((16, 48, 16), 8, 8, 32, (0.0, 13.0)),
}


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


def _models(m, name, fused, **kw):
    dims, nvars, naug, _, tspan = CONFIGS[name]
    return m.construct(
        m.RNODE, m.MLP(dims), nvars, naug, tspan=tspan, steer_rate=0.1, lam3=1e-2,
        compute_mode=m.VecJacMode(fused=fused), **kw,
    )


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request):
    name = request.param
    dims, nvars, naug, B, _ = CONFIGS[name]
    ps_np = _np_params(dims, seed=1)
    xs = np.random.default_rng(2).uniform(size=(B, nvars)).astype(np.float32)
    return name, ps_np, xs


@pytest.mark.parametrize("jax_fused", [False, True], ids=["jax-xla", "jax-kernel"])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_inference_matches_jax(case, fused, jax_fused):
    name, ps_np, xs = case
    lp_r, regs_r, st_r = cnf.inference(
        _models(cnf, name, jax_fused), cnf.Mode.TEST, jnp.asarray(xs), jax.tree.map(jnp.asarray, ps_np)
    )
    lp, regs, st = tcnf.inference(
        _models(tcnf, name, fused), tcnf.Mode.TEST, xs, tcnf.params_from_numpy(ps_np)
    )
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_r), **TOL)
    np.testing.assert_allclose(regs.a.numpy(), np.asarray(regs_r.a), **TOL)
    assert float(regs.e.abs().max()) == 0.0 and float(regs.n.abs().max()) == 0.0
    assert (int(st.steps), int(st.accepted), int(st.nfe)) == (
        int(st_r.steps), int(st_r.accepted), int(st_r.nfe)
    )


@pytest.mark.parametrize("jax_fused", [False, True], ids=["jax-xla", "jax-kernel"])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_generate_matches_jax(case, fused, jax_fused):
    name, ps_np, xs = case
    jicnf = _models(cnf, name, jax_fused)
    B = xs.shape[0]
    key = jax.random.PRNGKey(3)
    s_r, st_r = cnf.generate(jicnf, cnf.Mode.TEST, jax.tree.map(jnp.asarray, ps_np), B, key=key, with_stats=True)
    # The reference's base draw: the first of three keys split from `key`.
    z1 = np.array(jax.random.normal(jax.random.split(key, 3)[0], (B, jicnf.zdim), jnp.float32))
    s, st = tcnf.generate(
        _models(tcnf, name, fused), tcnf.Mode.TEST, tcnf.params_from_numpy(ps_np), B, z1=z1, with_stats=True
    )
    assert s.shape == (B, jicnf.nvars)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_r), **TOL)
    assert (int(st.steps), int(st.accepted), int(st.nfe)) == (
        int(st_r.steps), int(st_r.accepted), int(st_r.nfe)
    )


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_icnfdist_matches_jax(case, fused):
    name, ps_np, xs = case
    jd = cnf.ICNFDist(_models(cnf, name, False), cnf.Mode.TEST, jax.tree.map(jnp.asarray, ps_np))
    td = tcnf.ICNFDist(_models(tcnf, name, fused), tcnf.Mode.TEST, tcnf.params_from_numpy(ps_np))
    assert len(td) == len(jd)
    np.testing.assert_allclose(td.logpdf(xs).numpy(), np.asarray(jd.logpdf(jnp.asarray(xs))), **TOL)
    np.testing.assert_allclose(td.pdf(xs).numpy(), np.asarray(jd.pdf(jnp.asarray(xs))), rtol=1e-3, atol=1e-30)
    key = jax.random.PRNGKey(4)
    n = 8
    z1 = np.array(jax.random.normal(jax.random.split(key, 3)[0], (n, jd.icnf.zdim), jnp.float32))
    np.testing.assert_allclose(td.sample(n, z1=z1).numpy(), np.asarray(jd.sample(key, n)), **TOL)
    # A generator draw: right shape, finite, reproducible.
    a = td.sample(n, generator=torch.Generator().manual_seed(5))
    b = td.rand(n, generator=torch.Generator().manual_seed(5))
    assert a.shape == (n, jd.icnf.nvars) and torch.isfinite(a).all() and torch.equal(a, b)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_rank1_input_and_single_sample_squeeze(fused):
    ps_np = _np_params(CONFIGS["small"][0], seed=1)
    x = np.random.default_rng(6).uniform(size=(3,)).astype(np.float32)
    jicnf = _models(cnf, "small", False)
    lp_r, regs_r, _ = cnf.inference(jicnf, cnf.Mode.TEST, jnp.asarray(x), jax.tree.map(jnp.asarray, ps_np))
    ticnf = _models(tcnf, "small", fused)
    ps = tcnf.params_from_numpy(ps_np)
    lp, regs, _ = tcnf.inference(ticnf, tcnf.Mode.TEST, x, ps)
    assert lp.shape == () and regs.a.shape == ()
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_r), **TOL)
    key = jax.random.PRNGKey(7)
    s_r = cnf.generate(jicnf, cnf.Mode.TEST, jax.tree.map(jnp.asarray, ps_np), key=key)
    z1 = np.array(jax.random.normal(jax.random.split(key, 3)[0], (1, 5), jnp.float32))[0]
    s = tcnf.generate(ticnf, tcnf.Mode.TEST, ps, z1=z1)
    assert s.shape == (3,)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_r), **TOL)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_logit_bijector_matches_jax(fused):
    ps_np = _np_params(CONFIGS["small"][0], seed=8)
    xs = np.random.default_rng(9).uniform(0.05, 0.95, size=(16, 3)).astype(np.float32)
    jicnf = _models(cnf, "small", False, input_bijector="logit")
    ticnf = _models(tcnf, "small", fused, input_bijector="logit")
    lp_r, _, _ = cnf.inference(jicnf, cnf.Mode.TEST, jnp.asarray(xs), jax.tree.map(jnp.asarray, ps_np))
    lp, _, _ = tcnf.inference(ticnf, tcnf.Mode.TEST, xs, tcnf.params_from_numpy(ps_np))
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_r), **TOL)
    key = jax.random.PRNGKey(10)
    s_r = cnf.generate(jicnf, cnf.Mode.TEST, jax.tree.map(jnp.asarray, ps_np), 8, key=key)
    z1 = np.array(jax.random.normal(jax.random.split(key, 3)[0], (8, 5), jnp.float32))
    s = tcnf.generate(ticnf, tcnf.Mode.TEST, tcnf.params_from_numpy(ps_np), 8, z1=z1)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_r), **TOL)
    assert float(s.min()) > 0.0 and float(s.max()) < 1.0


def test_basedist_mvstdnormal_matches_default():
    ps = tcnf.params_from_numpy(_np_params(CONFIGS["small"][0], seed=1))
    xs = np.random.default_rng(11).uniform(size=(8, 3)).astype(np.float32)
    plain = _models(tcnf, "small", True)
    with_base = _models(tcnf, "small", True, basedist=tcnf.distributions.MvStdNormal(5))
    assert torch.equal(
        tcnf.inference(plain, tcnf.Mode.TEST, xs, ps)[0], tcnf.inference(with_base, tcnf.Mode.TEST, xs, ps)[0]
    )
    z = torch.from_numpy(np.random.default_rng(12).normal(size=(4, 5)).astype(np.float32))
    np.testing.assert_allclose(
        tcnf.distributions.std_normal_logpdf(z).numpy(),
        np.asarray(cnf.distributions.std_normal_logpdf(jnp.asarray(z.numpy()))),
        rtol=1e-6,
    )


def test_out_of_slice_calls_raise():
    ps = tcnf.params_from_numpy(_np_params(CONFIGS["small"][0], seed=1))
    xs = np.zeros((4, 3), np.float32)
    icnf = _models(tcnf, "small", True)
    with pytest.raises(NotImplementedError, match="items 4-6"):
        tcnf.inference(icnf, tcnf.Mode.TRAIN, xs, ps)
    with pytest.raises(NotImplementedError, match="items 4-6"):
        tcnf.generate(icnf, tcnf.Mode.TRAIN, ps, 4)
    with pytest.raises(NotImplementedError, match="item 15"):
        tcnf.inference(icnf, tcnf.Mode.TEST, xs, ps, trajectory=True)
    cond = tcnf.construct(tcnf.CondRNODE, tcnf.MLP((7, 15, 5)), 3, 2)
    with pytest.raises(NotImplementedError, match="item 13"):
        tcnf.inference(cond, tcnf.Mode.TEST, xs, ps, ys=np.zeros((4, 2), np.float32))
    with pytest.raises(ValueError, match="got ys"):
        tcnf.inference(icnf, tcnf.Mode.TEST, xs, ps, ys=np.zeros((4, 2), np.float32))
    with pytest.raises(ValueError, match="trailing dim"):
        tcnf.inference(icnf, tcnf.Mode.TEST, np.zeros((4, 2), np.float32), ps)
    with pytest.raises(ValueError, match="expected 4"):
        tcnf.generate(icnf, tcnf.Mode.TEST, ps, 4, z1=np.zeros((3, 5), np.float32))


def test_import_leaves_jax_out_and_builds_nothing():
    code = (
        "import sys, continuousnf_tpu_torch\n"
        "from continuousnf_tpu_torch.ops import _build\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert _build.load_library.cache_info().currsize == 0, 'a kernel was loaded'\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
