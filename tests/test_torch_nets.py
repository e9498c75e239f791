"""Parity of the PyTorch port's nets and closed-form TEST fields with the JAX
package: the same numpy params and inputs go through both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import continuousnf_tpu as cnf
import continuousnf_tpu_torch as tcnf
from continuousnf_tpu.ops import fused_dynamics as jfd
from continuousnf_tpu_torch.ops import fused_dynamics as tfd


def _np_params(dims, seed, bias_scale=0.1):
    rng = np.random.default_rng(seed)
    ps = []
    for din, dout in zip(dims[:-1], dims[1:]):
        lim = np.sqrt(6.0 / (din + dout))
        ps.append({
            "w": rng.uniform(-lim, lim, (din, dout)).astype(np.float32),
            "b": rng.normal(0.0, bias_scale, (dout,)).astype(np.float32),
        })
    return tuple(ps)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_params_from_numpy_round_trip():
    ps_np = jax.tree.map(np.asarray, cnf.MLP((5, 15, 5)).init(jax.random.PRNGKey(0)))
    ps = tcnf.params_from_numpy(ps_np)
    assert isinstance(ps, tuple) and len(ps) == 2
    for p_np, p in zip(ps_np, ps):
        assert set(p) == set(p_np)
        for k in p_np:
            assert p[k].dtype == torch.float32
            np.testing.assert_array_equal(p[k].numpy(), p_np[k])
    net = tcnf.MLP((5, 15, 5))
    net.load_params(ps)
    for p_mod, p in zip(net.params(), ps):
        for k in p:
            np.testing.assert_array_equal(p_mod[k].detach().numpy(), p[k].numpy())


@pytest.mark.parametrize("dims", [(5, 15, 5), (16, 48, 16), (3, 7, 6, 3)])
def test_mlp_forward_matches(dims):
    ps_np = _np_params(dims, seed=1)
    x = _x((11, dims[0]), seed=2)
    y_ref = np.asarray(cnf.MLP(dims).apply(jax.tree.map(jnp.asarray, ps_np), jnp.asarray(x)))
    net = tcnf.MLP(dims)
    ps = tcnf.params_from_numpy(ps_np)
    y_fn = net.apply(ps, torch.from_numpy(x)).numpy()
    net.load_params(ps)
    with torch.no_grad():
        y_mod = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y_fn, y_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(y_mod, y_fn)


def test_init_is_glorot_with_zero_bias():
    net = tcnf.MLP((16, 48, 16))
    ps = net.init(torch.Generator().manual_seed(0))
    ps2 = net.init(torch.Generator().manual_seed(0))
    for (din, dout), p, p2 in zip([(16, 48), (48, 16)], ps, ps2):
        assert p["w"].shape == (din, dout) and p["b"].shape == (dout,)
        assert float(p["w"].abs().max()) <= np.sqrt(6.0 / (din + dout))
        assert float(p["b"].abs().max()) == 0.0
        assert torch.equal(p["w"], p2["w"])


@pytest.mark.parametrize("dims", [(5, 15, 5), (16, 48, 16)])
def test_exact_tanh_mlp_trace_matches(dims):
    ps_np = _np_params(dims, seed=3)
    z = _x((13, dims[0]), seed=4)
    y_ref, tr_ref = jfd.exact_tanh_mlp_trace(jax.tree.map(jnp.asarray, ps_np), jnp.asarray(z))
    y, tr = tfd.exact_tanh_mlp_trace(tcnf.params_from_numpy(ps_np), torch.from_numpy(z))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-5)
    np.testing.assert_allclose(tr.numpy(), np.asarray(tr_ref), atol=1e-5)


@pytest.mark.parametrize(
    "dims,final", [((5, 9, 7, 5), jnp.tanh), ((5, 15, 5), None)], ids=["3-layer", "identity-out"]
)
def test_exact_dense_chain_trace_matches(dims, final):
    ps_np = _np_params(dims, seed=5)
    z = _x((9, dims[0]), seed=6)
    jnet = cnf.MLP(dims, final_activation=final)
    tnet = tcnf.MLP(dims, final_activation=torch.tanh if final is not None else None)
    y_ref, tr_ref = jfd.exact_dense_chain_trace(jnet, jax.tree.map(jnp.asarray, ps_np), jnp.asarray(z))
    y, tr = tfd.exact_dense_chain_trace(tnet, tcnf.params_from_numpy(ps_np), torch.from_numpy(z))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-5)
    np.testing.assert_allclose(tr.numpy(), np.asarray(tr_ref), atol=1e-5)


@pytest.mark.parametrize(
    "make",
    [
        lambda m: m.MLP((5, 15, 5)),
        lambda m: m.MLP((5, 9, 7, 5)),
        lambda m: m.MLP((5, 15, 5), final_activation=None),
        lambda m: m.Chain((m.Dense(5, 5),)),
    ],
    ids=["mlp2", "mlp3", "identity-out", "linear"],
)
def test_fusion_predicates_match(make):
    assert tfd.supports_fusion(make(tcnf)) == jfd.supports_fusion(make(cnf))
    assert tfd.is_dense_tanh_chain(make(tcnf)) == jfd.is_dense_tanh_chain(make(cnf))
