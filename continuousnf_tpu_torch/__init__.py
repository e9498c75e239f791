"""continuousnf_tpu_torch — the PyTorch and CUDA port of continuousnf_tpu.

It grows slice by slice beside the JAX package, which stays the reference.
This slice is density evaluation and sampling: `inference` and `generate` in
TEST mode and `ICNFDist`, with the whole adaptive solve of a 2-layer tanh MLP
field in one hand-written CUDA kernel for the H100 (`ops/csrc/`).  The
package imports torch and numpy, never jax; the kernels are built at first
use on a machine with nvcc, never at import.
"""

from .types import (
    ADMode,
    Adjoint,
    ComputeMode,
    DIJacVecMatrixMode,
    DIJacVecVectorMode,
    DIVecJacMatrixMode,
    DIVecJacVectorMode,
    EpsDist,
    JacVecMode,
    Mode,
    README_TOLERANCES,
    SolverOptions,
    TestMode,
    TrainMode,
    VecJacMode,
)
from .core import (
    CALIBRATED_AUG_SIGMA,
    FFJORD,
    ICNF,
    RNODE,
    CondFFJORD,
    CondPlanar,
    CondRNODE,
    Planar,
    Regs,
    construct,
    generate,
    inference,
    init_params,
)
from .nets import MLP, Chain, Dense, params_from_numpy
from .ode import SolveStats, odeint_with_stats
from .dist import ICNFDist
from . import distributions, ops, utils

__all__ = [
    "ADMode",
    "Adjoint",
    "ComputeMode",
    "EpsDist",
    "JacVecMode",
    "VecJacMode",
    "DIVecJacMatrixMode",
    "DIJacVecMatrixMode",
    "DIVecJacVectorMode",
    "DIJacVecVectorMode",
    "Mode",
    "README_TOLERANCES",
    "SolverOptions",
    "TestMode",
    "TrainMode",
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
    "Chain",
    "Dense",
    "MLP",
    "params_from_numpy",
    "odeint_with_stats",
    "SolveStats",
    "ICNFDist",
    "distributions",
    "ops",
    "utils",
]
