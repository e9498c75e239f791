"""Closed-form fields of Dense/tanh chains (trace, Jacobian): the plain PyTorch field
that the fused solve (`ops/fused_solve.py`) is held against.

Port of `continuousnf_tpu/ops/fused_dynamics.py`: `exact_tanh_mlp_trace`
(:145-166), `is_dense_tanh_chain` (:169-181), `exact_dense_chain_jacobian`
(:184-214) and `exact_dense_chain_trace` (:217-258) with their conditional
forms (the first layer reads [z | ys]; the Jacobian is in z, so only the z
rows of its weight enter), `supports_fusion` (:261-272), and the plain
version of the per-stage TRAIN kernel `_fused_forward` (K10,
`_reference_impl` :43-54), whose CUDA kernel is not ported yet (ROADMAP
queue 2).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..nets.modules import with_cond


def exact_tanh_mlp_trace(params, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form exact divergence of a 2-layer tanh MLP.

    For f(z) = tanh(tanh(z W1 + b1) W2 + b2) the trace of the Jacobian is
    tr J = sum_i dy_i (M dh)_i with M[i, h] = W1[i, h] W2[h, i],
    dh = 1 - h^2 and dy = 1 - y^2.  Returns (y (B, d), tr (B,)).
    """
    (p1, p2) = params
    w1, b1, w2, b2 = p1["w"], p1["b"], p2["w"], p2["b"]
    h = torch.tanh(z @ w1 + b1)
    y = torch.tanh(h @ w2 + b2)
    dh = 1.0 - h * h
    dy = 1.0 - y * y
    m = w1 * w2.T  # (d, H)
    tr = torch.sum(dy * (dh @ m.T), dim=-1)
    return y, tr


def dense_chain_trace(
    ws: Sequence[torch.Tensor],
    bs: Sequence[Optional[torch.Tensor]],
    acts: Sequence[bool],
    z: torch.Tensor,
    ys: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form (y, tr J) of an N-layer Dense chain without forming the
    final (B, d, d) Jacobian.  `acts[k]` is True for a tanh layer and False
    for an identity layer; `bs[k]` may be None (no bias).  With `ys` the
    first layer reads [z | ys] and J is the Jacobian in z: only the z rows
    of the first weight enter the chain product.

    The chain product C = d h_{N-1} / d z (B, d, H_{N-1}) is carried layer by
    layer; the last factor W_N diag(act'_N) enters only through the trace
    contraction tr = sum_{i,h} C[b,i,h] W_N[h,i] d_N[b,i].
    """
    B, dz = z.shape
    n = len(ws)
    h = z if ys is None else with_cond(z, ys)
    C = None
    tr = None
    for idx, (w, b, act) in enumerate(zip(ws, bs, acts)):
        a = h @ w
        if b is not None:
            a = a + b
        if act:
            h = torch.tanh(a)
            d = 1.0 - h * h
        else:
            h = a
            d = None
        if idx == 0:
            w = w[:dz]
        if idx == n - 1:
            if C is None:
                diag = torch.diagonal(w)
                tr = torch.sum(diag * d, dim=-1) if d is not None else torch.sum(diag) * torch.ones(
                    (B,), dtype=z.dtype, device=z.device
                )
            else:
                t = torch.einsum("bih,hi->bi", C, w)
                tr = torch.sum(t * d, dim=-1) if d is not None else torch.sum(t, dim=-1)
        else:
            C = w.expand(B, *w.shape) if C is None else torch.einsum("bij,jk->bik", C, w)
            if d is not None:
                C = C * d[:, None, :]
    return h, tr


def dense_chain_jacobian(
    ws: Sequence[torch.Tensor],
    bs: Sequence[Optional[torch.Tensor]],
    acts: Sequence[bool],
    z: torch.Tensor,
    ys: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form (y, J) of an N-layer Dense chain, J (B, d, d) with
    J[b, j, i] = d y_i / d z_j: the batched left-to-right chain product of
    the layer factors W_k diag(act'_k).  With `ys` the first layer reads
    [z | ys] and only its z rows enter the product."""
    dz = z.shape[-1]
    h = z if ys is None else with_cond(z, ys)
    J = None
    for w, b, act in zip(ws, bs, acts):
        a = h @ w
        if b is not None:
            a = a + b
        if act:
            h = torch.tanh(a)
            d = 1.0 - h * h
        else:
            h = a
            d = None
        J = w[:dz].expand(z.shape[0], dz, w.shape[1]) if J is None else torch.einsum("bij,jk->bik", J, w)
        if d is not None:
            J = J * d[:, None, :]
    return h, J


def _chain_args(nn, params):
    return (
        [p["w"] for p in params],
        [p.get("b") if layer.use_bias else None for layer, p in zip(nn.layers, params)],
        [layer.activation is torch.tanh for layer in nn.layers],
    )


def exact_dense_chain_trace(nn, params, z: torch.Tensor, ys=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """`dense_chain_trace` for a Chain module and its params tree."""
    return dense_chain_trace(*_chain_args(nn, params), z, ys)


def exact_dense_chain_jacobian(nn, params, z: torch.Tensor, ys=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """`dense_chain_jacobian` for a Chain module and its params tree."""
    return dense_chain_jacobian(*_chain_args(nn, params), z, ys)


def is_dense_tanh_chain(nn) -> bool:
    """True for a Chain of Dense layers with tanh-or-identity activations."""
    from ..nets.modules import Chain, Dense

    if not isinstance(nn, Chain) or not len(nn.layers):
        return False
    return all(
        isinstance(l, Dense) and (l.activation is torch.tanh or l.activation is None)
        for l in nn.layers
    )


def supports_fusion(nn) -> bool:
    """True when `nn` is a 2-layer tanh-MLP Chain with biases."""
    from ..nets.modules import Chain, Dense

    if not isinstance(nn, Chain) or len(nn.layers) != 2:
        return False
    return all(
        isinstance(l, Dense) and l.use_bias and l.activation is torch.tanh for l in nn.layers
    )


def fused_tanh_mlp_dynamics(params, z: torch.Tensor, eps: torch.Tensor):
    """The per-stage TRAIN field of a 2-layer tanh MLP for one (B, dz) probe:
    (y, tr = <eps^T J, eps>, ||y||, ||eps^T J||).  CPU tensors run the plain
    version; the CUDA kernel (K10) is not ported, so CUDA tensors raise."""
    if z.device.type != "cpu":
        raise NotImplementedError(
            "the per-stage TRAIN kernel (K10, ROADMAP queue 2) is not ported; "
            "use the fused solve (K1/K2) or fused=False"
        )
    (p1, p2) = params
    w1, b1, w2, b2 = p1["w"], p1["b"], p2["w"], p2["b"]
    h = torch.tanh(z @ w1 + b1)
    y = torch.tanh(h @ w2 + b2)
    g1 = ((eps * (1.0 - y * y)) @ w2.T) * (1.0 - h * h)
    eJ = g1 @ w1.T
    tr = torch.sum(eJ * eps, dim=-1)
    return y, tr, torch.linalg.vector_norm(y, dim=-1), torch.linalg.vector_norm(eJ, dim=-1)


__all__ = [
    "fused_tanh_mlp_dynamics",
    "exact_tanh_mlp_trace",
    "dense_chain_trace",
    "dense_chain_jacobian",
    "exact_dense_chain_trace",
    "exact_dense_chain_jacobian",
    "is_dense_tanh_chain",
    "supports_fusion",
]
