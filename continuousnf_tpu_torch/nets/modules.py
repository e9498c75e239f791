"""Dense, Chain and MLP as `nn.Module`s with the JAX package's parameter layout,
and the conditional wrappers CondLayer and CondWrap.

Port of `continuousnf_tpu/nets/modules.py:41-170`.  Arrays are batch-major
`(..., features)`, weights are stored `(d_in, d_out)` and a layer computes
`act(x @ w + b)`, as in the JAX package (not `nn.Linear`'s `(out, in)`).

Each module owns its parameters (`forward(x)` uses them), and every module
also has the functional form of the JAX package: `init(generator)` returns a
fresh params tree, `apply(params, x)` runs the net on a given tree, and
`load_params(params)` copies a tree into the module.  A Chain's params tree
is a tuple of `{"w": (in, out), "b": (out,)}` dicts, one per layer.
Parameters are made on `device`, by default the CUDA card
(`types.resolve_device`).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..types import resolve_device

Params = Any


def _glorot_uniform(shape: Tuple[int, int], generator, dtype, device) -> torch.Tensor:
    fan_in, fan_out = shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    w = torch.empty(shape, dtype=dtype, device=device)
    return w.uniform_(-limit, limit, generator=generator)


class Dense(nn.Module):
    """Affine layer with optional activation: `act(x @ w + b)`."""

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        activation: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        use_bias: bool = True,
        *,
        generator: Optional[torch.Generator] = None,
        dtype=torch.float32,
        device=None,
    ):
        super().__init__()
        self.in_dim = int(in_dim)
        self.out_dim = int(out_dim)
        self.activation = activation
        self.use_bias = bool(use_bias)
        p = self.init(generator, dtype, device)
        self.w = nn.Parameter(p["w"])
        self.b = nn.Parameter(p["b"]) if self.use_bias else None

    def init(self, generator=None, dtype=torch.float32, device=None) -> Params:
        device = resolve_device(device)
        params = {"w": _glorot_uniform((self.in_dim, self.out_dim), generator, dtype, device)}
        if self.use_bias:
            params["b"] = torch.zeros((self.out_dim,), dtype=dtype, device=device)
        return params

    def params(self) -> Params:
        return {"w": self.w, "b": self.b} if self.use_bias else {"w": self.w}

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        y = x @ params["w"]
        if self.use_bias:
            y = y + params["b"]
        if self.activation is not None:
            y = self.activation(y)
        return y

    def load_params(self, params: Params) -> None:
        with torch.no_grad():
            self.w.copy_(params["w"])
            if self.use_bias:
                self.b.copy_(params["b"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(self.params(), x)


class Chain(nn.Module):
    """Sequential composition; its params tree is a tuple, one entry per layer."""

    def __init__(self, layers: Sequence[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.out_dim = getattr(self.layers[-1], "out_dim", None) if len(self.layers) else None

    def init(self, generator=None, dtype=torch.float32, device=None) -> Params:
        device = resolve_device(device)
        return tuple(layer.init(generator, dtype, device) for layer in self.layers)

    def params(self) -> Params:
        return tuple(layer.params() for layer in self.layers)

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        for layer, p in zip(self.layers, params):
            x = layer.apply(p, x)
        return x

    def load_params(self, params: Params) -> None:
        for layer, p in zip(self.layers, params):
            layer.load_params(p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(self.params(), x)


def MLP(
    dims: Tuple[int, ...],
    activation: Callable[[torch.Tensor], torch.Tensor] = torch.tanh,
    final_activation: Optional[Callable[[torch.Tensor], torch.Tensor]] = torch.tanh,
    *,
    generator: Optional[torch.Generator] = None,
    dtype=torch.float32,
    device=None,
) -> Chain:
    """`dims = (in, hidden..., out)`; every layer gets `activation` except the
    last, which gets `final_activation` (tanh by default, like the hidden
    layers)."""
    layers = []
    for i in range(len(dims) - 1):
        act = activation if i < len(dims) - 2 else final_activation
        layers.append(
            Dense(dims[i], dims[i + 1], act, generator=generator, dtype=dtype, device=device)
        )
    return Chain(layers)


def with_cond(z: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """[z | ys] along the last axis, ys broadcast over z's leading axes."""
    return torch.cat([z, ys.expand(*z.shape[:-1], ys.shape[-1])], dim=-1)


class CondLayer(nn.Module):
    """Conditional wrapper: the wrapped net applied to [x | ys], with ys
    given per call (`apply_with_cond`).  The parity surface of the JAX
    package's `CondLayer` (`continuousnf_tpu/nets/modules.py:130-154`); in
    code prefer `CondWrap`."""

    def __init__(self, net: nn.Module, n_cond: int):
        super().__init__()
        self.nn = net
        self.n_cond = int(n_cond)
        self.out_dim = getattr(net, "out_dim", None)

    def init(self, generator=None, dtype=torch.float32, device=None) -> Params:
        return self.nn.init(generator, dtype, device)

    def apply_with_cond(self, params: Params, x: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
        return CondWrap(self.nn, ys)(params, x)

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        raise TypeError("CondLayer requires conditioning; use apply_with_cond(params, x, ys)")


def CondWrap(net, ys: torch.Tensor) -> Callable[[Params, torch.Tensor], torch.Tensor]:
    """`f(params, z) = net.apply(params, [z | ys])`, ys ((n_cond,) or
    (B, n_cond)) broadcast over z's leading axes."""

    def apply(params: Params, z: torch.Tensor) -> torch.Tensor:
        return net.apply(params, with_cond(z, ys))

    return apply


def params_from_numpy(ps_np: Params, device=None) -> Params:
    """Turn a params tree of numpy arrays (e.g. the JAX package's params after
    `jax.tree.map(np.asarray, ps)`) into the same tree of torch tensors on
    `device` (None: `types.resolve_device`).  Tuples, lists and dicts keep
    their structure and keys; dtypes are kept."""
    device = resolve_device(device)
    if isinstance(ps_np, dict):
        return {k: params_from_numpy(v, device) for k, v in ps_np.items()}
    if isinstance(ps_np, (tuple, list)):
        return type(ps_np)(params_from_numpy(v, device) for v in ps_np)
    return torch.from_numpy(np.array(ps_np, copy=True)).to(device)


__all__ = ["Dense", "Chain", "MLP", "CondLayer", "CondWrap", "Params", "params_from_numpy"]
