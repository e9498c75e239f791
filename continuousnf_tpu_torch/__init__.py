"""continuousnf_tpu_torch — the PyTorch and CUDA port of continuousnf_tpu.

It grows slice by slice beside the JAX package, which stays the reference.
Ported so far: density evaluation and sampling (`inference` and `generate`
in TEST mode, `ICNFDist`) and training (TRAIN-mode `inference`, `loss`,
`loss_and_metrics` differentiated by the BACKSOLVE adjoint or through the
DIRECT and fixed-step solves, `fit` with the Lion optimizer, and
checkpoints), trajectories (`inference(..., trajectory=True)`, tstops) and
the adjoint's statistics (`adjoint_stats`), for conditional models too
(`CondICNFDist`, `CondICNFModel`).  The whole adaptive solves of a 2-layer
tanh MLP field and of deeper tanh-or-identity chains run in hand-written
CUDA kernels for the H100 (`ops/csrc/`), under every explicit tableau with
an embedded error estimate: the TEST and TRAIN forward solves and the TRAIN
adjoint solve.  Entry points run on the CUDA card unless a device is named or set
with `set_default_device`.  The package imports torch and numpy, never jax;
the kernels are built at first use on a machine with nvcc, never at
import.
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
    resolve_device,
    set_default_device,
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
    TrainState,
    adjoint_stats,
    construct,
    generate,
    inference,
    init_params,
    loss,
    loss_and_metrics,
)
from .nets import MLP, Chain, CondLayer, CondWrap, Dense, params_from_numpy
from .ode import SolveStats, odeint, odeint_with_stats
from .dist import CondICNFDist, ICNFDist
from .train import CondICNFModel, FitResult, ICNFModel, Lion, fit, load_checkpoint, save_checkpoint
from . import distributions, ops, parallel, train, utils

__all__ = [
    "ADMode",
    "Adjoint",
    "ComputeMode",
    "EpsDist",
    "JacVecMode",
    "VecJacMode",
    "resolve_device",
    "set_default_device",
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
    "loss",
    "loss_and_metrics",
    "adjoint_stats",
    "TrainState",
    "ICNFModel",
    "CondICNFModel",
    "FitResult",
    "fit",
    "Lion",
    "save_checkpoint",
    "load_checkpoint",
    "Chain",
    "CondLayer",
    "CondWrap",
    "Dense",
    "MLP",
    "params_from_numpy",
    "odeint",
    "odeint_with_stats",
    "SolveStats",
    "ICNFDist",
    "CondICNFDist",
    "distributions",
    "ops",
    "parallel",
    "train",
    "utils",
]
