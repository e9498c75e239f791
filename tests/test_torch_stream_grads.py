"""The port's streamed chain path against the JAX package on the CPU, the
inference and gradient half of tests/test_torch_stream.py (the two files
run on two workers): TEST and TRAIN `inference` of `MLP((6, 160, 160, 6))`,
the Hutchinson loss and its gradient of it, of `MLP((64, 128, 128, 128,
64))` and of `MLP((40, 160, 40))` against `jax.grad`, the exact-trace
loss's gradient of the 4-layer chain (streamed K7 exact's twin forward, the
plain backward), and FFJORD's MINIBOONE model (miniboone860, `MLP((43, 860,
860, 43))`) at B = 4: TEST `inference` and the Hutchinson gradient.  The
fused solves run the streamed forms' plain versions on CPU tensors; the JAX
package runs its kernels in interpret mode.

Inputs come from numpy seeds; the JAX probe draws are reproduced from its
key split (`core/icnf.py:485`) and handed to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import continuousnf_tpu as cnf
import continuousnf_tpu_torch as tcnf
from continuousnf_tpu_torch.ops import fused_solve as tfs
from continuousnf_tpu_torch.utils.configs import MODELS, glorot_params, model_data, tabular_data

# The port's entry points default to the CUDA card; these tests run it on the CPU.
tcnf.set_default_device("cpu")

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
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


def _jax_eps(icnf, key, batch):
    """The probes JAX `inference` draws from `key`."""
    eps_key, _ = jax.random.split(key)
    return np.array(icnf.draw_eps(eps_key, batch))


@pytest.mark.parametrize("mode", ["test", "train", "exact"])
def test_stream_inference_matches_jax(mode):
    """TEST and TRAIN `inference` of the 3-layer chain past hidden 128
    through its fused solve against the JAX package's kernel in interpret
    mode, with the same weights, inputs and probes."""
    dims = NETS["hidden160"]
    mode_name = MODE_NAMES[mode]
    jicnf, ticnf = _model(cnf, dims, mode), _model(tcnf, dims, mode)
    ps_np = _np_params(dims, 8)
    xs = _data(dims, B, 9)
    key = jax.random.PRNGKey(10)
    lp_r, regs_r, st_r = cnf.inference(jicnf, getattr(cnf.Mode, mode_name), jnp.asarray(xs), _jps(ps_np), key=key)
    extra = {"eps": _jax_eps(jicnf, key, B)} if mode == "train" else {}
    with torch.no_grad():
        lp, regs, st = tcnf.inference(ticnf, getattr(tcnf.Mode, mode_name), xs, tcnf.params_from_numpy(ps_np), **extra)
    assert (int(st.steps), int(st.accepted), int(st.nfe)) == (int(st_r.steps), int(st_r.accepted), int(st_r.nfe))
    for a, b in ((lp, lp_r), (regs.e, regs_r.e), (regs.n, regs_r.n)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("net", list(NETS))
def test_stream_hutchinson_gradients_match_jax_grad(net):
    """The Hutchinson loss and its gradients through the fused BACKSOLVE
    (the streamed K1 and K2 chain forms' twins) against `jax.grad` of the
    JAX package's fused loss."""
    dims = NETS[net]
    jicnf, ticnf = _model(cnf, dims), _model(tcnf, dims)
    ps_np = _np_params(dims, 11)
    xs = _data(dims, B, 12)
    key = jax.random.PRNGKey(13)
    l_r, g_r = jax.value_and_grad(lambda p: cnf.loss(jicnf, cnf.Mode.TRAIN, jnp.asarray(xs), p, key=key))(_jps(ps_np))
    ps = tcnf.params_from_numpy(ps_np)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    l = tcnf.loss(ticnf, tcnf.Mode.TRAIN, xs, ps, eps=_jax_eps(jicnf, key, B))
    g = torch.autograd.grad(l, leaves)
    np.testing.assert_allclose(float(l.detach()), float(l_r), **GRAD_TOL)
    for a, b in zip(g, _leaves(g_r)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


def test_stream_exact_gradient_matches_jax_grad():
    """The exact-trace loss of the 4-layer chain past shared memory and its
    gradient: streamed K7 exact's twin forward and the plain backward
    (forward-only, as in the JAX package) against `jax.grad`."""
    dims = NETS["four-layer"]
    jicnf, ticnf = _model(cnf, dims, "exact"), _model(tcnf, dims, "exact")
    assert tfs.make_full_solve(ticnf, tcnf.Mode.TRAIN, B).adjoint is None
    ps_np = _np_params(dims, 14)
    xs = _data(dims, B, 15)
    key = jax.random.PRNGKey(16)
    l_r, g_r = jax.value_and_grad(lambda p: cnf.loss(jicnf, cnf.Mode.TRAIN, jnp.asarray(xs), p, key=key))(_jps(ps_np))
    ps = tcnf.params_from_numpy(ps_np)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    l = tcnf.loss(ticnf, tcnf.Mode.TRAIN, xs, ps)
    g = torch.autograd.grad(l, leaves)
    np.testing.assert_allclose(float(l.detach()), float(l_r), **GRAD_TOL)
    for a, b in zip(g, _leaves(g_r)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


def test_miniboone860_test_inference_matches_jax():
    """miniboone860 at B = 4: TEST `inference` (streamed K7 TEST's twin)
    against the JAX package's forward kernel in interpret mode."""
    jicnf, ticnf = _model(cnf, MB860, "test"), _model(tcnf, MB860, "test")
    ps_np = _np_params(MB860, 16)
    xs = model_data("miniboone860", np.random.default_rng(17), 4)
    lp_r, _, st_r = cnf.inference(jicnf, cnf.Mode.TEST, jnp.asarray(xs), _jps(ps_np))
    with torch.no_grad():
        lp, _, st = tcnf.inference(ticnf, tcnf.Mode.TEST, xs, tcnf.params_from_numpy(ps_np))
    assert (int(st.steps), int(st.nfe)) == (int(st_r.steps), int(st_r.nfe))
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_r), **TOL)


def test_miniboone860_hutchinson_gradient_matches_jax_grad():
    """miniboone860 at B = 4: the Hutchinson loss and its gradients (the
    streamed K1 and K2 chain forms' twins) against `jax.grad` of the JAX
    package's fused loss (its kernels in interpret mode)."""
    jicnf, ticnf = _model(cnf, MB860), _model(tcnf, MB860)
    ps_np = _np_params(MB860, 18)
    xs = model_data("miniboone860", np.random.default_rng(19), 4)
    key = jax.random.PRNGKey(20)
    l_r, g_r = jax.value_and_grad(lambda p: cnf.loss(jicnf, cnf.Mode.TRAIN, jnp.asarray(xs), p, key=key))(_jps(ps_np))
    ps = tcnf.params_from_numpy(ps_np)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    before = _launch_counts()
    l = tcnf.loss(ticnf, tcnf.Mode.TRAIN, xs, ps, eps=_jax_eps(jicnf, key, 4))
    g = torch.autograd.grad(l, leaves)
    assert _launch_counts() == before
    np.testing.assert_allclose(float(l.detach()), float(l_r), **GRAD_TOL)
    for a, b in zip(g, _leaves(g_r)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)
