"""Training: the `fit` model wrapper and the Lion optimizer.  Checkpoints,
`transform` and `fitted_params` are ROADMAP queue 1, items 8 and 18."""

from .fit import CondICNFModel, FitResult, ICNFModel, fit
from .lion import Lion

__all__ = ["ICNFModel", "CondICNFModel", "FitResult", "fit", "Lion"]
