"""Core type system: modes, compute modes, solver options, and the device
the entry points default to.

PyTorch port of `continuousnf_tpu/types.py:21-215`.  The classes are plain
frozen dataclasses and enums with the same fields and defaults as the JAX
package, so a configuration reads the same in both packages.  Entry points
that make tensors (`Dense`, `MLP`, `Chain.init`, `params_from_numpy`,
`init_params`, `fit` without params) run on the CUDA card unless the caller
names a device or sets one with `set_default_device`.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import torch


class Mode(enum.Enum):
    """Evaluation mode.

    TEST  -> exact trace (deterministic density), no steering jitter.
    TRAIN -> stochastic Hutchinson trace + regularizer accumulators + steering.
    """

    TEST = "test"
    TRAIN = "train"


TestMode = Mode.TEST
TrainMode = Mode.TRAIN


class ADMode(enum.Enum):
    """AD direction for trace probes (VecJac = reverse, JacVec = forward)."""

    VJP = "vjp"
    JVP = "jvp"


class EpsDist(enum.Enum):
    """Distribution of Hutchinson probe vectors."""

    GAUSSIAN = "gaussian"
    RADEMACHER = "rademacher"


@dataclasses.dataclass(frozen=True)
class ComputeMode:
    """Static trace-computation configuration.

    ad:          AD direction for Hutchinson probes.
    num_probes:  number of Hutchinson probes K.
    eps_dist:    probe distribution.
    fused:       run the solve-in-kernel path (`ops/fused_solve.py`) when the
                 network and solver are eligible.
    bf16:        bf16 stage matmuls inside the fused kernels.
    exact_trace: TRAIN with the exact divergence and Jacobian Frobenius norm.
    """

    ad: ADMode = ADMode.VJP
    num_probes: int = 1
    eps_dist: EpsDist = EpsDist.GAUSSIAN
    fused: bool = False
    bf16: bool = False
    exact_trace: bool = False

    def __post_init__(self):
        if self.num_probes < 1:
            raise ValueError(f"num_probes must be >= 1, got {self.num_probes}")


def VecJacMode(num_probes: int = 1, **kw) -> ComputeMode:
    """Reverse-mode probes."""
    return ComputeMode(ad=ADMode.VJP, num_probes=num_probes, **kw)


def JacVecMode(num_probes: int = 1, **kw) -> ComputeMode:
    """Forward-mode probes."""
    return ComputeMode(ad=ADMode.JVP, num_probes=num_probes, **kw)


DIVecJacMatrixMode = VecJacMode
DIJacVecMatrixMode = JacVecMode
DIVecJacVectorMode = VecJacMode
DIJacVecVectorMode = JacVecMode


class Adjoint(enum.Enum):
    """How gradients flow through the ODE solve.

    BACKSOLVE differentiates by the continuous adjoint (`ode/adjoint.py`),
    DIRECT through the recorded solver loop (at most `direct_max_steps`
    attempted steps), and NONE runs the forward solve only.  Fixed-step
    solves are differentiated through their loop under every adjoint.
    """

    BACKSOLVE = "backsolve"
    DIRECT = "direct"
    NONE = "none"


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Static ODE-solver configuration (same fields and defaults as the JAX
    package's `SolverOptions`)."""

    method: str = "tsit5"
    rtol: float = 1.0e-3
    atol: float = 1.0e-6
    max_steps: int = 10_000
    dt0: Optional[float] = None  # None -> automatic initial step (Hairer)
    fixed_num_steps: Optional[int] = None  # set -> fixed-step integration
    adjoint: Adjoint = Adjoint.BACKSOLVE
    direct_max_steps: int = 512
    saveat: Optional[Tuple[float, ...]] = None
    tstops: Optional[Tuple[float, ...]] = None
    # Kept for configuration parity.  The port's stages are f32 on every
    # path: plain f32 matmuls (TF32 off) and f32 FMA in the CUDA kernel.
    stage_precision: str = "auto"


#: rtol threshold of the "auto" stage-precision split.
AUTO_PRECISION_RTOL = 1.0e-3


def resolve_stage_precision(opts: SolverOptions) -> str:
    """The effective stage precision for a solve ("auto" resolved by rtol)."""
    p = getattr(opts, "stage_precision", "auto")
    if p == "auto":
        return "high" if opts.rtol >= AUTO_PRECISION_RTOL else "highest"
    return p


#: Tight tolerances: rtol = sqrt(eps(Float32)), atol = eps(Float32).
README_TOLERANCES = {"rtol": 3.452669831108329e-4, "atol": 1.1920929e-7}


_default_device: Optional[torch.device] = None


def set_default_device(device) -> Optional[torch.device]:
    """The device the entry points use when the caller names none (None:
    the CUDA card).  Returns the previous setting."""
    global _default_device
    previous = _default_device
    _default_device = None if device is None else torch.device(device)
    return previous


def resolve_device(device=None) -> torch.device:
    """The device of an entry point called with `device`: the one named,
    else `set_default_device`'s, else the current CUDA card.  Without a
    card it raises rather than run on the CPU."""
    if device is None:
        device = _default_device
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "continuousnf_tpu_torch runs on the CUDA card by default and none is available; "
            "pass device='cpu' or call continuousnf_tpu_torch.set_default_device('cpu') to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


__all__ = [
    "Mode",
    "README_TOLERANCES",
    "TestMode",
    "TrainMode",
    "ADMode",
    "EpsDist",
    "ComputeMode",
    "VecJacMode",
    "JacVecMode",
    "DIVecJacMatrixMode",
    "DIJacVecMatrixMode",
    "DIVecJacVectorMode",
    "DIJacVecVectorMode",
    "Adjoint",
    "SolverOptions",
    "resolve_stage_precision",
    "set_default_device",
    "resolve_device",
]
