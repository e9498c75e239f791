"""Training: the `fit` model wrapper, the Lion optimizer and checkpoints.
`transform` and `fitted_params` are ROADMAP queue 1, item 18."""

from .checkpoint import load_checkpoint, save_checkpoint
from .fit import CondICNFModel, FitResult, ICNFModel, fit
from .lion import Lion

__all__ = ["ICNFModel", "CondICNFModel", "FitResult", "fit", "Lion", "save_checkpoint", "load_checkpoint"]
