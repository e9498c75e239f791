"""Closed-form TEST-mode fields of Dense/tanh chains: the plain PyTorch field
that the fused solve (`ops/fused_solve.py`) is held against.

Port of `continuousnf_tpu/ops/fused_dynamics.py`: `exact_tanh_mlp_trace`
(:145-166), `is_dense_tanh_chain` (:169-181), `exact_dense_chain_trace`
(:217-258) and `supports_fusion` (:261-272).  The per-stage TRAIN kernel of
that file (K10, `_fused_forward`) is not ported yet (ROADMAP queue 2).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form (y, tr J) of an N-layer Dense chain without forming the
    final (B, d, d) Jacobian.  `acts[k]` is True for a tanh layer and False
    for an identity layer; `bs[k]` may be None (no bias).

    The chain product C = d h_{N-1} / d z (B, d, H_{N-1}) is carried layer by
    layer; the last factor W_N diag(act'_N) enters only through the trace
    contraction tr = sum_{i,h} C[b,i,h] W_N[h,i] d_N[b,i].
    """
    B = z.shape[0]
    n = len(ws)
    h = z
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


def exact_dense_chain_trace(nn, params, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`dense_chain_trace` for a Chain module and its params tree."""
    return dense_chain_trace(
        [p["w"] for p in params],
        [p.get("b") if layer.use_bias else None for layer, p in zip(nn.layers, params)],
        [layer.activation is torch.tanh for layer in nn.layers],
        z,
    )


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


__all__ = [
    "exact_tanh_mlp_trace",
    "dense_chain_trace",
    "exact_dense_chain_trace",
    "is_dense_tanh_chain",
    "supports_fusion",
]
