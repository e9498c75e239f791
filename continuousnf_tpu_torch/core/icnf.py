"""ICNF model: construction, inference (log-density), generation and the loss.

Port of `continuousnf_tpu/core/icnf.py`: the variant tags (:28-60), `Regs`,
`ICNF` (with `draw_eps`, :192-198), `construct`, `init_params`, the steered
`_steer_tspan` (:336-348), `_as_batch`, `_check_cond`, `_prepare_inference`
(:434-526, TEST and TRAIN, with the logit bijector), `_solve`, `_final_regs`,
`inference` with its trajectories (`_solve_saveat`, :388-412, 569-588),
`generate` (TEST), `loss`, `loss_and_metrics` (:643-704) and
`adjoint_stats` (:707-770), conditional models included (the Cond*
variants: the net reads [z | ys]).

The same public signatures and batch-major layouts as the JAX package:
`xs` is (B, nvars), params are the net's params tree (JAX layout).  Where
the JAX package takes a PRNG key the port takes a `torch.Generator`, and
every draw can be given instead: the base draw of `generate` (`z1=`), the
TRAIN-mode input noise of `x_jitter` (`jitter=`) and of `aug_noise`
(`aug=`, :466-484), the Hutchinson probes (`eps=`) and the steering draw
r ~ U(-steer_rate, steer_rate) (`steer_r=`).  Tensors live on the device of
the params.  Gradients flow through the solve by the BACKSOLVE adjoint
(`ode/adjoint.py`), to the conditioning `ys` too, or under
`SolverOptions(adjoint=Adjoint.DIRECT)` and fixed steps through the
recorded solver loop (`ode/solve.py`).  TRAIN-mode generation and passive
augmentation are not ported yet and raise NotImplementedError naming their
ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from ..distributions import sample_eps, std_normal_logpdf, std_normal_sample
from ..ode.solve import SolveStats, backsolve_stats, odeint_saveat, odeint_with_stats
from ..types import ComputeMode, Mode, SolverOptions, resolve_device
from .dynamics import TestState, TrainState, make_augmented_dynamics, safe_norm


class _VariantTag:
    """Base for the six model-variant tags.  They differ only in default
    regularization (RNODE family: lambda1 = lambda2 = 1e-2) and
    conditionality."""


class RNODE(_VariantTag):
    pass


class CondRNODE(_VariantTag):
    pass


class FFJORD(_VariantTag):
    pass


class CondFFJORD(_VariantTag):
    pass


class Planar(_VariantTag):
    pass


class CondPlanar(_VariantTag):
    pass


_COND_VARIANTS = (CondRNODE, CondFFJORD, CondPlanar)
_RNODE_VARIANTS = (RNODE, CondRNODE)

#: Aug-input noise std at which the per-dim Gaussian density at 0 is 1.
CALIBRATED_AUG_SIGMA = 1.0 / math.sqrt(2.0 * math.pi)


class Regs(NamedTuple):
    """Per-sample regularizer integrals returned alongside log-density:
    e (flow kinetic energy) and n (Jacobian norm) are zero in TEST mode,
    a = ||z_aug|| of the final augmented dims."""

    e: torch.Tensor
    n: torch.Tensor
    a: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ICNF:
    """Static model configuration; the same fields as the JAX package's ICNF."""

    nn: Any
    nvars: int
    naugmented: int = 0
    cond: bool = False
    compute_mode: ComputeMode = ComputeMode()
    tspan: Tuple[float, float] = (0.0, 1.0)
    steer_rate: float = 0.0
    lam1: float = 0.0
    lam2: float = 0.0
    lam3: float = 0.0
    solver: SolverOptions = SolverOptions()
    dtype: Any = torch.float32
    aug_passive: bool = False
    basedist: Any = None
    epsdist: Any = None
    aug_noise: float = 0.0
    x_jitter: float = 0.0
    input_bijector: Optional[str] = None

    @property
    def augmented(self) -> bool:
        return self.naugmented > 0

    @property
    def n_aug_input(self) -> int:
        return self.naugmented

    @property
    def steered(self) -> bool:
        return self.steer_rate > 0.0

    @property
    def zdim(self) -> int:
        """Dimensionality of the transported state (nvars + augmented dims)."""
        return self.nvars + self.naugmented

    def init(self, generator: Optional[torch.Generator] = None, device=None) -> Any:
        return init_params(self, generator, device)

    def base_logpdf(self, z: torch.Tensor) -> torch.Tensor:
        if self.basedist is not None:
            return self.basedist.logpdf(z)
        return std_normal_logpdf(z)

    def base_sample(self, generator, batch_shape: Tuple[int, ...], device=None) -> torch.Tensor:
        """Draw (*batch_shape, zdim) base-distribution samples."""
        if self.basedist is not None:
            return self.basedist.sample(generator, batch_shape, self.dtype, device)
        return std_normal_sample(generator, (*batch_shape, self.zdim), self.dtype, device)

    def draw_eps(self, generator, batch: int, device=None) -> torch.Tensor:
        """Draw the (num_probes, batch, zdim) Hutchinson probes from
        `epsdist` if set, else from the `compute_mode.eps_dist` enum."""
        shape = (self.compute_mode.num_probes, batch)
        if self.epsdist is not None:
            return self.epsdist.sample(generator, shape, self.dtype, device)
        return sample_eps(generator, (*shape, self.zdim), self.compute_mode.eps_dist, self.dtype, device)


def construct(
    variant,
    nn,
    nvars: int,
    naugmented: int = 0,
    *,
    compute_mode: ComputeMode = ComputeMode(),
    cond: Optional[bool] = None,
    tspan: Tuple[float, float] = (0.0, 1.0),
    steer_rate: float = 0.0,
    lam1: Optional[float] = None,
    lam2: Optional[float] = None,
    lam3: float = 0.0,
    solver: SolverOptions = SolverOptions(),
    dtype: Any = torch.float32,
    basedist: Any = None,
    epsdist: Any = None,
    aug_passive: bool = False,
    aug_noise: Any = 0.0,
    x_jitter: float = 0.0,
    input_bijector: Optional[str] = None,
) -> ICNF:
    """The public constructor, with the JAX package's defaults: lambda1 =
    lambda2 = 1e-2 for the RNODE family and 0 otherwise; `cond` True for
    the Cond* variants."""
    zdim = int(nvars) + int(naugmented)
    for name, dist in (("basedist", basedist), ("epsdist", epsdist)):
        if dist is not None and getattr(dist, "dim", zdim) != zdim:
            raise ValueError(f"{name}.dim = {dist.dim} must equal nvars + naugmented = {zdim}")
    if aug_noise == "calibrated":
        aug_noise = CALIBRATED_AUG_SIGMA
    if input_bijector not in (None, "logit"):
        raise ValueError(f"unsupported input_bijector: {input_bijector!r}")
    if not (isinstance(variant, type) and issubclass(variant, _VariantTag)):
        raise TypeError(f"variant must be one of the ICNF tags, got {variant!r}")
    is_rnode = issubclass(variant, _RNODE_VARIANTS)
    if lam1 is None:
        lam1 = 1.0e-2 if is_rnode else 0.0
    if lam2 is None:
        lam2 = 1.0e-2 if is_rnode else 0.0
    if cond is None:
        cond = issubclass(variant, _COND_VARIANTS)
    return ICNF(
        nn=nn,
        nvars=int(nvars),
        naugmented=int(naugmented),
        cond=bool(cond),
        compute_mode=compute_mode,
        tspan=(float(tspan[0]), float(tspan[1])),
        steer_rate=float(steer_rate),
        lam1=float(lam1),
        lam2=float(lam2),
        lam3=float(lam3),
        solver=solver,
        dtype=dtype,
        basedist=basedist,
        epsdist=epsdist,
        aug_passive=bool(aug_passive),
        aug_noise=float(aug_noise),
        x_jitter=float(x_jitter),
        input_bijector=input_bijector,
    )


def init_params(icnf: ICNF, generator: Optional[torch.Generator] = None, device=None) -> Any:
    """A fresh params tree for the wrapped net (Glorot weights, zero biases)
    on `device` (None: `types.resolve_device`)."""
    return icnf.nn.init(generator, icnf.dtype, resolve_device(device))


def _device_of(ps) -> torch.device:
    leaf = ps
    while not isinstance(leaf, torch.Tensor):
        leaf = next(iter(leaf.values())) if isinstance(leaf, dict) else leaf[0]
    return leaf.device


def _steer_tspan(icnf: ICNF, mode: Mode, device, generator=None, steer_r=None):
    """(t0, t1) as tensors.  In TRAIN mode on a steered model t1 moves by
    |t1 - t0| * r with r ~ U(-steer_rate, steer_rate), drawn from
    `generator` unless given as `steer_r`."""
    t0 = torch.tensor(icnf.tspan[0], dtype=icnf.dtype, device=device)
    t1 = torch.tensor(icnf.tspan[1], dtype=icnf.dtype, device=device)
    if mode == Mode.TRAIN and icnf.steered:
        if steer_r is None:
            u = torch.rand((), generator=generator, dtype=icnf.dtype, device=device)
            r = (2.0 * u - 1.0) * icnf.steer_rate
        else:
            r = torch.as_tensor(steer_r, dtype=icnf.dtype, device=device)
            if r.ndim or float(r.abs()) > icnf.steer_rate:
                raise ValueError(f"steer_r must be a scalar in [-{icnf.steer_rate}, {icnf.steer_rate}]")
        t1 = t1 + torch.abs(t1 - t0) * r
    return t0, t1


def _as_batch(x: torch.Tensor, name: str) -> Tuple[torch.Tensor, bool]:
    from ..utils.debug import check_array

    check_array(name, x, rank=(1, 2))
    if x.ndim == 1:
        return x[None, :], True
    return x, False


def _check_cond(icnf: ICNF, ys):
    if icnf.cond and ys is None:
        raise ValueError("conditional ICNF requires ys")
    if not icnf.cond and ys is not None:
        raise ValueError("non-conditional ICNF got ys")


def _cond_tensor(icnf: ICNF, ys, device, batch_of_one: bool):
    """ys as a tensor of the model's dtype on `device`: (n_cond,) or
    (B, n_cond); a 1-D ys becomes one row where the call is a single sample
    (`batch_of_one`), as in the JAX package."""
    if ys is None:
        return None
    from ..utils.debug import check_array

    ys = torch.as_tensor(ys, dtype=icnf.dtype, device=device)
    check_array("ys", ys, rank=(1, 2))
    return ys[None, :] if batch_of_one and ys.ndim == 1 else ys


def _field_and_full_solve(icnf: ICNF, mode: Mode, batch: int):
    """The augmented field and the fused solve (or None) of a solve of `batch` samples."""
    f = make_augmented_dynamics(
        icnf.nn,
        mode,
        icnf.compute_mode,
        norm_z=icnf.lam1 != 0.0,
        norm_j=icnf.lam2 != 0.0,
        passive_aug_dims=icnf.n_aug_input if icnf.aug_passive else 0,
    )
    from ..ops.fused_solve import make_full_solve

    return f, make_full_solve(icnf, mode, batch=batch)


def _solve(icnf: ICNF, mode: Mode, state0, args, t0, t1):
    f, full_solve = _field_and_full_solve(icnf, mode, state0.z.shape[0])
    return odeint_with_stats(f, state0, t0, t1, args, icnf.solver, full_solve=full_solve)


def _saveat_grid(icnf: ICNF, t0, t1):
    """The trajectory's time grid: t0, then the points of `solver.saveat`
    strictly inside the span in the direction of integration, then t1;
    without `saveat`, 17 evenly spaced points from t0 to t1.  The JAX
    package integrates over `saveat` itself, so a grid without the span's
    ends stops short (ROADMAP queue 3); where `saveat` holds both ends the
    two grids agree."""
    if icnf.solver.saveat is None:
        return [t0 + (t1 - t0) * (i / 16) for i in range(17)]
    lo, hi = sorted((float(t0), float(t1)))
    inner = sorted((float(t) for t in icnf.solver.saveat if lo < float(t) < hi), reverse=float(t1) < float(t0))
    return [t0] + [torch.tensor(t, dtype=icnf.dtype, device=t0.device) for t in inner] + [t1]


def _solve_saveat(icnf: ICNF, mode: Mode, state0, args, t0, t1):
    """The solve as segments over `_saveat_grid`, each through the fused
    solve where there is one.  Returns (final state, stats, (ts (T,), zs
    (T, B, zdim)))."""
    f, full_solve = _field_and_full_solve(icnf, mode, state0.z.shape[0])
    grid = _saveat_grid(icnf, t0, t1)
    states, stats = odeint_saveat(f, state0, grid, args, icnf.solver, full_solve=full_solve)
    stateT = type(states)(*(x[-1] for x in states))
    return stateT, stats, (torch.stack(grid), states.z)


def _logpx(icnf: ICNF, stateT, ldj):
    """logp(x) = logp_base(z(t1)) - Delta_logp (+ the bijector's log-det)."""
    logpx = icnf.base_logpdf(stateT.z) - stateT.dlogp
    return logpx if ldj is None else logpx + ldj


def _per_sample_loss(icnf: ICNF, mode: Mode, logpx, regs: Regs):
    """TRAIN: -logpx + lam1 E + lam2 N + lam3 A; TEST: -logpx."""
    if mode == Mode.TRAIN:
        return -logpx + icnf.lam1 * regs.e + icnf.lam2 * regs.n + icnf.lam3 * regs.a
    return -logpx


def _weighted_mean(x, weights):
    """The mean of x (B,), or its `weights`-weighted mean."""
    if weights is None:
        return torch.mean(x)
    weights = torch.as_tensor(weights, dtype=x.dtype, device=x.device)
    return torch.sum(x * weights) / torch.clamp(torch.sum(weights), min=1e-12)


def _final_regs(icnf: ICNF, mode: Mode, stateT) -> Regs:
    B = stateT.z.shape[0]
    zero = torch.zeros((B,), dtype=icnf.dtype, device=stateT.z.device)
    if icnf.lam3 != 0.0 and icnf.augmented and not icnf.aug_passive:
        a = safe_norm(stateT.z[:, icnf.zdim - icnf.n_aug_input :])
    else:
        a = zero
    if mode == Mode.TRAIN:
        return Regs(e=stateT.reg_e, n=stateT.reg_n, a=a)
    return Regs(e=zero, n=zero, a=a)


def _train_probes(icnf: ICNF, eps, generator, B: int, device) -> Optional[torch.Tensor]:
    """The (K, B, zdim) probes: validated when given (a (B, zdim) array is
    K = 1 shorthand), else one draw per call, fixed over the trajectory.
    The exact-trace field reads no probes: None, and nothing is drawn."""
    cm = icnf.compute_mode
    if cm.exact_trace:
        if eps is not None:
            # Accepting and ignoring them would hide a configuration mistake.
            raise ValueError(
                "eps= was given but compute_mode.exact_trace=True uses no "
                "Hutchinson probes; drop eps or use a stochastic mode"
            )
        return None
    if eps is None:
        return icnf.draw_eps(generator, B, device)
    eps = torch.as_tensor(eps, dtype=icnf.dtype, device=device)
    if eps.ndim == 2:
        eps = eps[None]
    if tuple(eps.shape) != (cm.num_probes, B, icnf.zdim):
        raise ValueError(
            f"eps must have shape (num_probes={cm.num_probes}, B={B}, "
            f"zdim={icnf.zdim}) or (B, zdim) for K=1; got {tuple(eps.shape)}"
        )
    return eps


def _std_normal(name: str, given, scale: float, generator, shape, icnf: ICNF, device) -> Optional[torch.Tensor]:
    """`scale` times a standard-normal draw of `shape`: `given` (checked)
    or drawn from `generator`; None when `scale` is 0, where a given draw is
    refused (accepting and ignoring it would hide a configuration
    mistake)."""
    if scale == 0.0:
        if given is not None:
            raise ValueError(f"{name}= was given but the model draws no {name} noise in this mode")
        return None
    if given is None:
        return scale * torch.randn(shape, generator=generator, dtype=icnf.dtype, device=device)
    given = torch.as_tensor(given, dtype=icnf.dtype, device=device)
    if tuple(given.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}; got {tuple(given.shape)}")
    return scale * given


def _prepare_inference(icnf: ICNF, mode: Mode, xs, ps, ys, generator=None, eps=None, steer_r=None, jitter=None,
                       aug=None):
    """Input validation and batching, the logit bijector's change of
    variables, the augmented initial state and, in TRAIN mode, its input
    noise, the probes and the steered span.  The draws come from `generator`
    in the JAX package's key-split order (`core/icnf.py:466-485`): the x
    jitter, the aug inputs, the probes, the steering.  Returns
    (state0, args, t0, t1, ldj, squeeze)."""
    _check_cond(icnf, ys)
    device = _device_of(ps)
    xs = torch.as_tensor(xs, dtype=icnf.dtype, device=device)
    xs, squeeze = _as_batch(xs, "xs")
    ys = _cond_tensor(icnf, ys, device, squeeze)
    B = xs.shape[0]
    from ..utils.debug import check_array

    check_array("xs", xs, last_dim=icnf.nvars, dtype=icnf.dtype)

    ldj = None
    if icnf.input_bijector == "logit":
        # The flow works on t = logit(x); log p(x) = log p_flow(t) + sum log|t'|.
        xc = torch.clamp(xs, 1e-6, 1.0 - 1e-6)
        ldj = -torch.sum(torch.log(xc) + torch.log1p(-xc), dim=-1)
        xs = torch.log(xc) - torch.log1p(-xc)

    train = mode == Mode.TRAIN
    if train and icnf.aug_passive and icnf.n_aug_input:
        raise NotImplementedError("passive augmentation is not ported yet (ROADMAP queue 1, item 14)")
    # TRAIN mode: xs + x_jitter N(0, 1) (smoothed MLE) and aug inputs
    # aug_noise N(0, 1) (calibrated transported augmentation); TEST keeps
    # xs and zero aug inputs.
    noise = _std_normal("jitter", jitter, icnf.x_jitter if train else 0.0, generator, xs.shape, icnf, device)
    if noise is not None:
        xs = xs + noise
    a0 = _std_normal("aug", aug, icnf.aug_noise if train and icnf.n_aug_input else 0.0, generator,
                     (B, icnf.n_aug_input), icnf, device)
    z0 = xs
    if icnf.n_aug_input:
        if a0 is None:
            a0 = torch.zeros((B, icnf.n_aug_input), dtype=icnf.dtype, device=device)
        z0 = torch.cat([xs, a0], dim=-1)
    zeros_b = torch.zeros((B,), dtype=icnf.dtype, device=device)
    if train:
        eps = _train_probes(icnf, eps, generator, B, device)
        state0 = TrainState(z=z0, dlogp=zeros_b, reg_e=zeros_b, reg_n=zeros_b)
        args = {"ps": ps, "eps": eps, "ys": ys}
    else:
        state0 = TestState(z=z0, dlogp=zeros_b)
        args = {"ps": ps, "ys": ys}
    t0, t1 = _steer_tspan(icnf, mode, device, generator, steer_r)
    return state0, args, t0, t1, ldj, squeeze


def inference(
    icnf: ICNF,
    mode: Mode,
    xs,
    ps: Any,
    *,
    ys=None,
    generator: Optional[torch.Generator] = None,
    eps=None,
    steer_r=None,
    jitter=None,
    aug=None,
    trajectory: bool = False,
):
    """Transport data to the base distribution and return log-density:
    logp(x) = logp_base(z(t1)) - Delta_logp.

    Returns (logpx (B,), regs: Regs, stats: SolveStats).  Rank-1 `xs` is a
    single sample and is squeezed back.  A conditional model takes `ys`,
    (B, n_cond) or one row (n_cond,) for every sample; gradients reach it
    through the adjoint.

    TRAIN mode draws, from `generator` (torch's default generator of the
    device when None) and in this order: the x jitter (B, nvars) when
    `x_jitter` > 0, the aug inputs (B, n_aug_input) when `aug_noise` > 0
    (TEST mode keeps xs and zero aug inputs), the probes (K, B, zdim) and
    the steering r.  Each can be given instead: `jitter` and `aug` as
    standard-normal draws of those shapes (scaled here by `x_jitter` and
    `aug_noise`), `eps` ((K, B, zdim), or (B, zdim) for K = 1) and
    `steer_r`.  Under BACKSOLVE the probes are Monte-Carlo constants: their
    gradient is zero.  With `compute_mode.exact_trace` no probes are drawn
    and `eps` is rejected; a `jitter` or `aug` the model does not draw is
    rejected too.  Under `Adjoint.DIRECT` the probes get their gradient.

    `trajectory=True` also returns `(ts, zs)`: the transported states on the
    grid t0, the points of `solver.saveat` strictly inside the span, t1
    (without `saveat`, 17 evenly spaced points), ts (T,) and zs
    (T, B, zdim) with zs[0] the initial and zs[-1] the final state; the
    solve runs segment by segment over that grid.
    """
    state0, args, t0, t1, ldj, squeeze = _prepare_inference(
        icnf, mode, xs, ps, ys, generator, eps, steer_r, jitter, aug
    )
    if trajectory:
        stateT, stats, traj = _solve_saveat(icnf, mode, state0, args, t0, t1)
    else:
        stateT, stats = _solve(icnf, mode, state0, args, t0, t1)
    logpx = _logpx(icnf, stateT, ldj)
    regs = _final_regs(icnf, mode, stateT)
    if squeeze:
        logpx = logpx[0]
        regs = Regs(e=regs.e[0], n=regs.n[0], a=regs.a[0])
        if trajectory:
            traj = (traj[0], traj[1][:, 0])
    if trajectory:
        return logpx, regs, stats, traj
    return logpx, regs, stats


def generate(
    icnf: ICNF,
    mode: Mode,
    ps: Any,
    n: Optional[int] = None,
    *,
    ys=None,
    generator: Optional[torch.Generator] = None,
    z1=None,
    with_stats: bool = False,
):
    """Sample by integrating base-distribution draws backward in time and
    keeping the first `nvars` dims.  `n=None` returns a single sample.

    The base draw comes from `generator` on the params' device, or is given
    as `z1` ((n, zdim), or (zdim,) / (1, zdim) with n=None).  A conditional
    model takes `ys`: one row ((n_cond,) or (1, n_cond)) for every sample,
    or (n, n_cond).  TEST mode only.
    """
    if mode != Mode.TEST:
        raise NotImplementedError("TRAIN-mode generate is not ported yet (ROADMAP queue 1, item 12)")
    _check_cond(icnf, ys)
    squeeze = n is None
    B = 1 if squeeze else int(n)
    device = _device_of(ps)
    ys = _cond_tensor(icnf, ys, device, True)
    if z1 is None:
        z1 = icnf.base_sample(generator, (B,), device)
    else:
        from ..utils.debug import check_array

        z1 = torch.as_tensor(z1, dtype=icnf.dtype, device=device)
        if z1.ndim == 1:
            z1 = z1[None, :]
        check_array("z1", z1, rank=(2,), last_dim=icnf.zdim)
        if z1.shape[0] != B:
            raise ValueError(f"z1 holds {z1.shape[0]} draws, expected {B}")
    state1 = TestState(z=z1, dlogp=torch.zeros((B,), dtype=icnf.dtype, device=device))
    args = {"ps": ps, "ys": ys}
    t0, t1 = _steer_tspan(icnf, mode, device)
    state0, stats = _solve(icnf, mode, state1, args, t1, t0)
    samples = state0.z[:, : icnf.nvars]
    if icnf.input_bijector == "logit":
        samples = torch.sigmoid(samples)
    if squeeze:
        samples = samples[0]
    if with_stats:
        return samples, stats
    return samples


def loss(
    icnf: ICNF,
    mode: Mode,
    xs,
    ps: Any,
    *,
    ys=None,
    generator: Optional[torch.Generator] = None,
    weights=None,
    eps=None,
    steer_r=None,
    jitter=None,
    aug=None,
) -> torch.Tensor:
    """Scalar loss: TRAIN mean(-logpx + lam1 E + lam2 N + lam3 A), TEST
    mean(-logpx).  `weights` (B,) gives a weighted mean (the trainer's
    padded samples carry weight 0).  The TRAIN draws (`jitter`, `aug`,
    `eps`, `steer_r`) are as in `inference`."""
    return loss_and_metrics(
        icnf, mode, xs, ps, ys=ys, generator=generator, weights=weights, eps=eps, steer_r=steer_r,
        jitter=jitter, aug=aug,
    )[0]


def loss_and_metrics(
    icnf: ICNF,
    mode: Mode,
    xs,
    ps: Any,
    *,
    ys=None,
    generator: Optional[torch.Generator] = None,
    weights=None,
    eps=None,
    steer_r=None,
    jitter=None,
    aug=None,
):
    """`loss` plus the per-step metrics: loss, mean E (kinetic energy) and
    mean N (Jacobian norm), both detached, and the forward solve's NFE."""
    logpx, regs, stats = inference(
        icnf, mode, xs, ps, ys=ys, generator=generator, eps=eps, steer_r=steer_r, jitter=jitter, aug=aug
    )
    l = _weighted_mean(_per_sample_loss(icnf, mode, logpx, regs), weights)
    e_mean, n_mean = _weighted_mean(regs.e, weights), _weighted_mean(regs.n, weights)
    metrics = {"loss": l, "e": e_mean.detach(), "n": n_mean.detach(), "nfe": stats.nfe}
    return l, metrics


def adjoint_stats(
    icnf: ICNF,
    mode: Mode,
    xs,
    ps: Any,
    *,
    ys=None,
    generator: Optional[torch.Generator] = None,
    weights=None,
    eps=None,
    steer_r=None,
    jitter=None,
    aug=None,
) -> Tuple[SolveStats, SolveStats]:
    """The SolveStats of the forward and of the BACKSOLVE backward solve of
    `loss`'s gradient at these inputs: the backward integration runs again
    on its own from the same final state and loss cotangent (the same
    adaptive grid, through the fused adjoint kernel where the gradient
    would run it), with its stats kept.  The draws are as in `inference`.
    Returns (fwd_stats, bwd_stats)."""
    state0, args, t0, t1, ldj, _ = _prepare_inference(
        icnf, mode, xs, ps, ys, generator, eps, steer_r, jitter, aug
    )
    f, full_solve = _field_and_full_solve(icnf, mode, state0.z.shape[0])

    def cotangent_fn(stateT):
        per = _per_sample_loss(icnf, mode, _logpx(icnf, stateT, ldj), _final_regs(icnf, mode, stateT))
        return _weighted_mean(per, weights)

    _, fwd_stats, bwd_stats = backsolve_stats(f, state0, t0, t1, args, cotangent_fn, icnf.solver, full_solve)
    return fwd_stats, bwd_stats


__all__ = [
    "ICNF",
    "RNODE",
    "FFJORD",
    "Planar",
    "CondRNODE",
    "CondFFJORD",
    "CondPlanar",
    "Regs",
    "CALIBRATED_AUG_SIGMA",
    "construct",
    "init_params",
    "inference",
    "generate",
    "loss",
    "loss_and_metrics",
    "adjoint_stats",
]
