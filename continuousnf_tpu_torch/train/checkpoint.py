"""Checkpoints of parameter and optimizer-state trees.

Port of `continuousnf_tpu/train/checkpoint.py` (:16-33): a tree of dicts,
tuples and lists of tensors (params, an optimizer's `state_dict`, or both)
round-trips bitwise.  The file is written by `torch.save` to `path + ".tmp"`
and published with `os.replace`, so a reader never sees half a file.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from ..ode.adjoint import flatten_tree


def save_checkpoint(path: str, tree: Any) -> None:
    """Write `tree` to `path` (atomically: a temporary file, then a rename)."""
    tmp = path + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def _skeleton(x):
    """The structure of a tree: its containers and keys, each tensor as
    "tensor" and any other leaf as its type name."""
    if isinstance(x, torch.Tensor):
        return "tensor"
    if isinstance(x, dict):
        return {k: _skeleton(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x).__name__, [_skeleton(v) for v in x]
    return type(x).__name__


def load_checkpoint(path: str, like: Any) -> Any:
    """The tree saved at `path` by `save_checkpoint`, with its tensors on
    the devices of `like`'s.  `like` is a template of the same structure
    (e.g. freshly initialized params); a tree of another structure, or a
    tensor of another shape or dtype, raises ValueError."""
    tree = torch.load(path, map_location="cpu", weights_only=True)
    if _skeleton(tree) != _skeleton(like):
        raise ValueError(f"the checkpoint at {path} has another structure than the template")
    leaves, rebuild = flatten_tree(tree)
    like_leaves, _ = flatten_tree(like)
    for i, (got, want) in enumerate(zip(leaves, like_leaves)):
        if got.shape != want.shape or got.dtype != want.dtype:
            raise ValueError(
                f"checkpoint tensor {i}: {tuple(got.shape)} {got.dtype}, the template's "
                f"{tuple(want.shape)} {want.dtype}"
            )
    return rebuild([got.to(want.device) for got, want in zip(leaves, like_leaves)])


__all__ = ["save_checkpoint", "load_checkpoint"]
