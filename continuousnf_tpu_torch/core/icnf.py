"""ICNF model: construction, TEST-mode inference (log-density) and generation.

Port of `continuousnf_tpu/core/icnf.py`: the variant tags (:28-60), `Regs`,
`ICNF`, `construct`, `init_params`, `_steer_tspan`, `_as_batch`,
`_check_cond`, the TEST branch of `_prepare_inference` (:434-526, with the
logit bijector), `_solve`, `_final_regs`, `inference` and `generate`.

The same public signatures and batch-major layouts as the JAX package:
`xs` is (B, nvars), params are the net's params tree (JAX layout).  Where
the JAX package takes a PRNG key the port takes a `torch.Generator`, and
`generate` accepts the base draw `z1` directly.  Tensors live on the device
of the params.  TRAIN mode, trajectories, conditioning and gradients are not
ported yet and raise NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from ..distributions import std_normal_logpdf, std_normal_sample
from ..ode.solve import odeint_with_stats
from ..types import ComputeMode, Mode, SolverOptions
from .dynamics import TestState, make_augmented_dynamics, safe_norm


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

_TRAIN_TODO = "TRAIN mode is not ported yet (ROADMAP queue 1, items 4-6)"


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
    """A fresh params tree for the wrapped net (Glorot weights, zero biases)."""
    return icnf.nn.init(generator, icnf.dtype, device)


def _device_of(ps) -> torch.device:
    leaf = ps
    while not isinstance(leaf, torch.Tensor):
        leaf = next(iter(leaf.values())) if isinstance(leaf, dict) else leaf[0]
    return leaf.device


def _steer_tspan(icnf: ICNF, device):
    """(t0, t1) as tensors.  TEST mode never steers; TRAIN-mode steering
    comes with the TRAIN slice (ROADMAP queue 1, item 5)."""
    t0 = torch.tensor(icnf.tspan[0], dtype=icnf.dtype, device=device)
    t1 = torch.tensor(icnf.tspan[1], dtype=icnf.dtype, device=device)
    return t0, t1


def _as_batch(x: torch.Tensor, name: str) -> Tuple[torch.Tensor, bool]:
    from ..utils.debug import check_array

    check_array(name, x, rank=(1, 2))
    if x.ndim == 1:
        return x[None, :], True
    return x, False


def _check_cond(icnf: ICNF, ys):
    if icnf.cond:
        raise NotImplementedError("conditional models are not ported yet (ROADMAP queue 1, item 13)")
    if ys is not None:
        raise ValueError("non-conditional ICNF got ys")


def _check_supported(icnf: ICNF, mode: Mode, ys):
    if mode != Mode.TEST:
        raise NotImplementedError(_TRAIN_TODO)
    _check_cond(icnf, ys)


def _solve(icnf: ICNF, mode: Mode, state0, args, t0, t1):
    f = make_augmented_dynamics(
        icnf.nn,
        mode,
        icnf.compute_mode,
        norm_z=icnf.lam1 != 0.0,
        norm_j=icnf.lam2 != 0.0,
        passive_aug_dims=icnf.n_aug_input if icnf.aug_passive else 0,
    )
    from ..ops.fused_solve import make_full_solve

    full_solve = make_full_solve(icnf, mode, batch=state0.z.shape[0])
    return odeint_with_stats(f, state0, t0, t1, args, icnf.solver, full_solve=full_solve)


def _final_regs(icnf: ICNF, mode: Mode, stateT) -> Regs:
    B = stateT.z.shape[0]
    zero = torch.zeros((B,), dtype=icnf.dtype, device=stateT.z.device)
    if icnf.lam3 != 0.0 and icnf.augmented and not icnf.aug_passive:
        a = safe_norm(stateT.z[:, icnf.zdim - icnf.n_aug_input :])
    else:
        a = zero
    return Regs(e=zero, n=zero, a=a)


def _prepare_inference(icnf: ICNF, mode: Mode, xs, ps, ys):
    """Input validation and batching, the logit bijector's change of
    variables and the augmented initial state (TEST mode).  Returns
    (state0, args, t0, t1, ldj, squeeze)."""
    _check_supported(icnf, mode, ys)
    device = _device_of(ps)
    xs = torch.as_tensor(xs, dtype=icnf.dtype, device=device)
    xs, squeeze = _as_batch(xs, "xs")
    B = xs.shape[0]
    from ..utils.debug import check_array

    check_array("xs", xs, last_dim=icnf.nvars, dtype=icnf.dtype)

    ldj = None
    if icnf.input_bijector == "logit":
        # The flow works on t = logit(x); log p(x) = log p_flow(t) + sum log|t'|.
        xc = torch.clamp(xs, 1e-6, 1.0 - 1e-6)
        ldj = -torch.sum(torch.log(xc) + torch.log1p(-xc), dim=-1)
        xs = torch.log(xc) - torch.log1p(-xc)

    z0 = xs
    if icnf.n_aug_input:
        z0 = torch.cat([xs, torch.zeros((B, icnf.n_aug_input), dtype=icnf.dtype, device=device)], dim=-1)
    state0 = TestState(z=z0, dlogp=torch.zeros((B,), dtype=icnf.dtype, device=device))
    args = {"ps": ps, "ys": ys}
    t0, t1 = _steer_tspan(icnf, device)
    return state0, args, t0, t1, ldj, squeeze


def inference(
    icnf: ICNF,
    mode: Mode,
    xs,
    ps: Any,
    *,
    ys=None,
    trajectory: bool = False,
):
    """Transport data to the base distribution and return log-density:
    logp(x) = logp_base(z(t1)) - Delta_logp.

    Returns (logpx (B,), regs: Regs, stats: SolveStats).  Rank-1 `xs` is a
    single sample and is squeezed back.
    """
    if trajectory:
        raise NotImplementedError("trajectory=True is not ported yet (ROADMAP queue 1, item 15)")
    state0, args, t0, t1, ldj, squeeze = _prepare_inference(icnf, mode, xs, ps, ys)
    stateT, stats = _solve(icnf, mode, state0, args, t0, t1)
    logpx = icnf.base_logpdf(stateT.z) - stateT.dlogp
    if ldj is not None:
        logpx = logpx + ldj
    regs = _final_regs(icnf, mode, stateT)
    if squeeze:
        logpx = logpx[0]
        regs = Regs(e=regs.e[0], n=regs.n[0], a=regs.a[0])
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
    as `z1` ((n, zdim), or (zdim,) / (1, zdim) with n=None).
    """
    _check_supported(icnf, mode, ys)
    squeeze = n is None
    B = 1 if squeeze else int(n)
    device = _device_of(ps)
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
    t0, t1 = _steer_tspan(icnf, device)
    state0, stats = _solve(icnf, mode, state1, args, t1, t0)
    samples = state0.z[:, : icnf.nvars]
    if icnf.input_bijector == "logit":
        samples = torch.sigmoid(samples)
    if squeeze:
        samples = samples[0]
    if with_stats:
        return samples, stats
    return samples


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
]
