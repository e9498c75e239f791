"""The README workflow (`examples/readme_example.py`) in the port on the CPU,
against the JAX package.

The README model (RNODE, MLP 2 -> 6 -> 2, nvars 1, naug 1, tspan (0, 13),
steer_rate 0.1, lambda1 = lambda2 = lambda3 = 1e-2, calibrated aug noise,
the README tolerances with method "auto", which picks verner65 there; the
example itself names no method and so runs tsit5 at them) through the
fused path (the kernels' plain versions on CPU tensors): its TRAIN loss and
gradient against `jax.grad` of the JAX package's, with the JAX draws (x
jitter, aug inputs, probes, steering) reproduced from its key splits
(`core/icnf.py:466-485`) and injected; the order of the port's own draws;
checkpoints; `fit` with the aug draws; and the queue-3 repairs that the
workflow meets (a `CondICNFDist` given ys as a list, a TEST-mode gradient
of a deeper chain).  Inputs come from numpy seeds; no kernel is launched."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import continuousnf_tpu as cnf
import continuousnf_tpu_torch as tcnf
from continuousnf_tpu_torch.ops import fused_solve as tfs
from continuousnf_tpu_torch.utils.configs import glorot_params

# The port's entry points default to the CUDA card; these tests run it on the CPU.
tcnf.set_default_device("cpu")

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
README = (2, 6, 2)
B = 16


def _readme(m, fused=True, **kw):
    """The README model of `examples/readme_example.py`, with `kw` on top."""
    opts = dict(tspan=(0.0, 13.0), steer_rate=0.1, lam1=1e-2, lam2=1e-2, lam3=1e-2, aug_noise="calibrated")
    opts.update(kw)
    return m.construct(m.RNODE, m.MLP(README), 1, 1, compute_mode=m.VecJacMode(fused=fused),
                       solver=m.SolverOptions(method="auto", **m.README_TOLERANCES), **opts)


def _beta(n, seed):
    return np.random.default_rng(seed).beta(2.0, 4.0, (n, 1)).astype(np.float32)


def _launch_counts():
    return {name: w.launches for name, w in tfs.KERNEL_WRAPPERS.items()}


def _leaves(ps):
    return [p[k] for p in ps for k in ("w", "b")]


def _jax_draws(icnf, key, batch):
    """The TRAIN draws JAX `inference` makes from `key`, in its split order:
    the x jitter, the aug inputs, the probes and the steering r, as the
    port takes them (standard-normal jitter and aug, not yet scaled)."""
    draws = {}
    if icnf.x_jitter > 0.0:
        key, jit_key = jax.random.split(key)
        draws["jitter"] = np.array(jax.random.normal(jit_key, (batch, icnf.nvars), jnp.float32))
    if icnf.aug_noise > 0.0 and icnf.n_aug_input:
        key, aug_key = jax.random.split(key)
        draws["aug"] = np.array(jax.random.normal(aug_key, (batch, icnf.n_aug_input), jnp.float32))
    eps_key, steer_key = jax.random.split(key)
    draws["eps"] = np.array(icnf.draw_eps(eps_key, batch))
    draws["steer_r"] = float(jax.random.uniform(steer_key, (), jnp.float32, -icnf.steer_rate, icnf.steer_rate))
    return draws


def test_readme_model_runs_verner65_in_the_kernels():
    """At the README tolerances method "auto" is verner65, and the fused
    solve takes the README net (a 2-layer tanh MLP) into the 2-layer
    kernels under it, TEST and TRAIN, each with its backward member (K5 for
    TEST, K2 for TRAIN)."""
    icnf = _readme(tcnf)
    assert tfs.get_tableau(icnf.solver.method, icnf.solver.rtol).name == "verner65"
    spec = tfs.chain_spec(icnf.nn, icnf.zdim)
    assert tfs._kernel_covers(tfs.get_tableau("auto", icnf.solver.rtol), spec) is None
    assert tfs.make_full_solve(icnf, tcnf.Mode.TEST, B).adjoint is not None
    assert tfs.make_full_solve(icnf, tcnf.Mode.TRAIN, B).adjoint is not None
    assert icnf.aug_noise == pytest.approx(tcnf.CALIBRATED_AUG_SIGMA)


@pytest.mark.parametrize("jitter", [0.0, 0.05], ids=["readme", "x-jitter"])
def test_readme_loss_and_gradient_match_jax_grad(jitter):
    """The README model's TRAIN loss and its gradient through the fused
    path (K1's and K2's plain versions under verner65) against `jax.grad`
    of the JAX package's fused loss (its kernels in interpret mode), the
    draws injected in the JAX package's split order; with an x jitter
    too.  At these tolerances the float32 gradient is ill-conditioned on
    some inputs: on one of twelve seeds every float32 path, the JAX
    package's own included, sits far from a float64 solve, and on most the
    two packages part at 1e-3 through the backsolve's first step (the
    forward's last step size, a roundoff-level quantity).  Seed 10 is an
    input where they agree."""
    jicnf, ticnf = _readme(cnf, x_jitter=jitter), _readme(tcnf, x_jitter=jitter)
    ps_np = glorot_params(np.random.default_rng(10), README)
    xs = _beta(B, 11)
    key = jax.random.PRNGKey(12)
    l_r, g_r = jax.value_and_grad(lambda p: cnf.loss(jicnf, cnf.Mode.TRAIN, jnp.asarray(xs), p, key=key))(
        jax.tree.map(jnp.asarray, ps_np))
    draws = _jax_draws(jicnf, key, B)
    assert ("jitter" in draws) == (jitter > 0.0) and "aug" in draws
    ps = tcnf.params_from_numpy(ps_np)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    before = _launch_counts()
    l = tcnf.loss(ticnf, tcnf.Mode.TRAIN, xs, ps, **draws)
    g = torch.autograd.grad(l, leaves)
    assert _launch_counts() == before
    np.testing.assert_allclose(float(l.detach()), float(l_r), **GRAD_TOL)
    for a, b in zip(g, _leaves(g_r)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


def test_train_draws_come_in_the_jax_split_order():
    """Without injected draws the port draws, from one generator: the x
    jitter, the aug inputs, the probes, then the steering; TEST mode draws
    none and keeps zero aug inputs; a draw the model does not make is
    refused."""
    icnf = _readme(tcnf, fused=False, x_jitter=0.05)
    ps = tcnf.params_from_numpy(glorot_params(np.random.default_rng(4), README))
    xs = _beta(B, 5)
    with torch.no_grad():
        got = tcnf.inference(icnf, tcnf.Mode.TRAIN, xs, ps, generator=torch.Generator().manual_seed(6))[0]
        g = torch.Generator().manual_seed(6)
        jitter = torch.randn((B, 1), generator=g)
        aug = torch.randn((B, 1), generator=g)
        eps = icnf.draw_eps(g, B)
        r = (2.0 * torch.rand((), generator=g) - 1.0) * icnf.steer_rate
        want = tcnf.inference(icnf, tcnf.Mode.TRAIN, xs, ps, jitter=jitter, aug=aug, eps=eps, steer_r=r)[0]
        assert torch.equal(got, want)
        # The calibrated aug inputs are aug_noise N(0, 1): a given draw is scaled.
        scaled = tcnf.inference(icnf, tcnf.Mode.TRAIN, xs, ps, jitter=jitter, aug=2.0 * aug, eps=eps, steer_r=r)[0]
        assert not torch.equal(scaled, want)
        test = tcnf.inference(icnf, tcnf.Mode.TEST, xs, ps)[0]
        plain = _readme(tcnf, fused=False)
        assert torch.equal(test, tcnf.inference(plain, tcnf.Mode.TEST, xs, ps)[0])
        with pytest.raises(ValueError, match="jitter"):
            tcnf.inference(plain, tcnf.Mode.TRAIN, xs, ps, jitter=jitter)
        with pytest.raises(ValueError, match="aug"):
            tcnf.inference(icnf, tcnf.Mode.TEST, xs, ps, aug=aug)


def test_checkpoint_round_trip(tmp_path):
    """`save_checkpoint` / `load_checkpoint`: params and a Lion state
    round-trip bitwise onto the template's device; the temporary file is
    gone; another structure, shape or dtype raises."""
    ps = tcnf.params_from_numpy(glorot_params(np.random.default_rng(7), README))
    leaves = [x.clone().requires_grad_() for x in _leaves(ps)]
    opt = tcnf.Lion(leaves, lr=3e-4, weight_decay=0.0)
    for p in leaves:
        p.grad = torch.ones_like(p)
    opt.step()
    tree = {"ps": ps, "opt": opt.state_dict()}
    path = str(tmp_path / "fitted.pt")
    tcnf.save_checkpoint(path, tree)
    assert not (tmp_path / "fitted.pt.tmp").exists()
    like = {"ps": type(ps)({k: torch.zeros_like(v) for k, v in p.items()} for p in ps), "opt": opt.state_dict()}
    back = tcnf.load_checkpoint(path, like)
    assert all(torch.equal(a, b) and a.dtype == b.dtype for a, b in zip(_leaves(back["ps"]), _leaves(ps)))
    state, ref = back["opt"]["state"], opt.state_dict()["state"]
    assert all(torch.equal(state[k]["exp_avg"], ref[k]["exp_avg"]) for k in ref)
    assert back["opt"]["param_groups"] == opt.state_dict()["param_groups"]
    wrong_shape = {"ps": type(ps)({"w": torch.zeros(3, 6), "b": p["b"]} if i == 0 else p
                                  for i, p in enumerate(like["ps"])), "opt": like["opt"]}
    with pytest.raises(ValueError, match="tensor 0"):
        tcnf.load_checkpoint(path, wrong_shape)
    wrong_dtype = {"ps": type(ps)({k: v.double() for k, v in p.items()} for p in like["ps"]), "opt": like["opt"]}
    with pytest.raises(ValueError, match="float64"):
        tcnf.load_checkpoint(path, wrong_dtype)
    with pytest.raises(ValueError, match="structure"):
        tcnf.load_checkpoint(path, {"ps": like["ps"]})


def test_readme_fit_checkpoint_and_dist():
    """One epoch of the README fit (Lion at lr 3e-4 without weight decay,
    batch 32) through the fused path with the aug draws, the checkpoint,
    and `ICNFDist.pdf` / `sample` of the reloaded params, as the README
    workflow runs them: finite losses, moved params, the same pdf before
    and after the checkpoint, samples of the right shape."""
    import functools
    import tempfile

    icnf = _readme(tcnf)
    X = _beta(64, 8)
    model = tcnf.ICNFModel(icnf, optimizers=(functools.partial(tcnf.Lion, lr=3e-4, weight_decay=0.0),),
                           n_epochs=1, batch_size=32)
    ps0 = tcnf.params_from_numpy(glorot_params(np.random.default_rng(9), README))
    before = _launch_counts()
    res = tcnf.fit(model, X, ps=ps0, seed=0)
    assert res.epochs == 1 and np.isfinite(res.losses).all()
    # Lion moves every entry by +-lr per step; two steps can bring one back.
    assert max(float((a - b).abs().max()) for a, b in zip(_leaves(res.ps), _leaves(ps0))) > 0.0
    with tempfile.TemporaryDirectory() as d:
        tcnf.save_checkpoint(d + "/fitted.pt", res.ps)
        ps = tcnf.load_checkpoint(d + "/fitted.pt", type(res.ps)({k: torch.zeros_like(v) for k, v in p.items()}
                                                                 for p in res.ps))
    dist = tcnf.ICNFDist(icnf, tcnf.Mode.TEST, ps)
    with torch.no_grad():
        pdf = dist.pdf(X[:B])
        assert torch.equal(pdf, tcnf.ICNFDist(icnf, tcnf.Mode.TEST, res.ps).pdf(X[:B]))
        samples = dist.sample(8, generator=torch.Generator().manual_seed(10))
    assert _launch_counts() == before
    assert pdf.shape == (B,) and bool((pdf > 0).all()) and samples.shape == (8, 1)


def test_cond_dist_takes_ys_as_a_list():
    """`CondICNFDist` given its conditioning as a list (the JAX package
    converts first, `dist.py:75`): rows and a single row, against the JAX
    package's."""
    dims = (2, 8, 1)
    jicnf = cnf.construct(cnf.CondRNODE, cnf.MLP(dims), 1, compute_mode=cnf.VecJacMode(fused=True))
    ticnf = tcnf.construct(tcnf.CondRNODE, tcnf.MLP(dims), 1, compute_mode=tcnf.VecJacMode(fused=True))
    ps_np = glorot_params(np.random.default_rng(11), dims)
    xs = np.random.default_rng(12).normal(size=(6, 1)).astype(np.float32)
    for ys in ([[0.1], [-0.4], [0.7], [0.2], [0.0], [-1.0], [0.5]], [0.3]):
        with torch.no_grad():
            lp = tcnf.CondICNFDist(ticnf, tcnf.Mode.TEST, tcnf.params_from_numpy(ps_np), ys).logpdf(xs)
        ref = cnf.CondICNFDist(jicnf, cnf.Mode.TEST, jax.tree.map(jnp.asarray, ps_np), ys).logpdf(jnp.asarray(xs))
        np.testing.assert_allclose(lp.numpy(), np.asarray(ref), **TOL)


def test_deep_test_gradient_matches_jax_grad():
    """A TEST-mode gradient of a 3-layer chain through the fused path: K7
    TEST's plain version forward, the plain BACKSOLVE backward (the JAX
    package has no TEST backward kernel for deeper chains either), against
    `jax.grad` of the JAX package's fused TEST loss."""
    dims = (5, 9, 7, 5)
    jicnf = cnf.construct(cnf.RNODE, cnf.MLP(dims), 3, 2, compute_mode=cnf.VecJacMode(fused=True))
    ticnf = tcnf.construct(tcnf.RNODE, tcnf.MLP(dims), 3, 2, compute_mode=tcnf.VecJacMode(fused=True))
    ps_np = glorot_params(np.random.default_rng(13), dims)
    xs = np.random.default_rng(14).uniform(size=(B, 3)).astype(np.float32)
    l_r, g_r = jax.value_and_grad(lambda p: cnf.loss(jicnf, cnf.Mode.TEST, jnp.asarray(xs), p))(
        jax.tree.map(jnp.asarray, ps_np))
    ps = tcnf.params_from_numpy(ps_np)
    leaves = [x.requires_grad_() for x in _leaves(ps)]
    assert tfs.make_full_solve(ticnf, tcnf.Mode.TEST, B).adjoint is None
    l = tcnf.loss(ticnf, tcnf.Mode.TEST, xs, ps)
    g = torch.autograd.grad(l, leaves)
    np.testing.assert_allclose(float(l.detach()), float(l_r), **GRAD_TOL)
    for a, b in zip(g, _leaves(g_r)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)
