"""The training step body.  Mesh parallelism (`torch.distributed`) is
ROADMAP queue 1, item 19."""

from .sharding import make_train_step_body

__all__ = ["make_train_step_body"]
