"""Core type system: modes, compute modes, solver options.

PyTorch port of `continuousnf_tpu/types.py:21-215`.  The classes are plain
frozen dataclasses and enums with the same fields and defaults as the JAX
package, so a configuration reads the same in both packages.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


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

    The port is forward-only so far: BACKSOLVE and NONE both run the forward
    solve, DIRECT runs it under the `direct_max_steps` cap.
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
]
