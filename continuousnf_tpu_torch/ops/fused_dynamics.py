"""Closed-form fields of Dense/tanh chains (trace, Jacobian), the plain
PyTorch field that the fused solve (`ops/fused_solve.py`) is held against,
and K10, the per-stage fused TRAIN field.

Port of `continuousnf_tpu/ops/fused_dynamics.py`: `exact_tanh_mlp_trace`
(:145-166), `is_dense_tanh_chain` (:169-181), `exact_dense_chain_jacobian`
(:184-214) and `exact_dense_chain_trace` (:217-258) with their conditional
forms (the first layer reads [z | ys]; the Jacobian is in z, so only the z
rows of its weight enter), `supports_fusion` (:261-272), and the per-stage
TRAIN op `fused_tanh_mlp_dynamics` (:126-142, 275-287): a
`torch.autograd.Function` whose forward runs K10 (`csrc/k10_fused_field.cu`,
wrapper `run_fused_field_kernel`, for `_fused_forward` :74-123) on CUDA
tensors and its plain version (`fused_field_plain`, `_reference_impl`
:43-54) on CPU tensors, and whose backward is the plain version's VJP.
"""

from __future__ import annotations

import ctypes
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


#: K10's library (`csrc/k10_fused_field.cu`) and the shared memory a block
#: may take (the H100's 227 KB): the weights and eight warps' slices must fit.
K10_KERNEL = "k10_fused_field"
K10_SMEM_BYTES = 232_448


def fused_field_plain(w1, b1, w2, b2, z, eps):
    """The plain version of K10 (the JAX package's `_reference_impl`): per
    sample y = tanh(tanh(z W1 + b1) W2 + b2), eps^T J, tr = <eps^T J, eps>,
    ||y|| and ||eps^T J||.  Returns (y (B, dz), tr, e_rate, n_rate (B,))."""
    h = torch.tanh(z @ w1 + b1)
    y = torch.tanh(h @ w2 + b2)
    g1 = ((eps * (1.0 - y * y)) @ w2.T) * (1.0 - h * h)
    eJ = g1 @ w1.T
    tr = torch.sum(eJ * eps, dim=-1)
    return y, tr, torch.linalg.vector_norm(y, dim=-1), torch.linalg.vector_norm(eJ, dim=-1)


def _k10_library():
    from ._build import load_library

    lib = load_library(K10_KERNEL)
    if not getattr(lib, "_cnf_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.cnf_k10_smem_bytes.argtypes, lib.cnf_k10_smem_bytes.restype = [I, I, I], ctypes.c_longlong
        for entry in ("cnf_k10_fused_field_f32", "cnf_k10_fused_field_f64"):
            getattr(lib, entry).argtypes = [P] * 10 + [I, I, I, P]
            getattr(lib, entry).restype = I
        lib._cnf_typed = True
    return lib


def run_fused_field_kernel(w1, b1, w2, b2, z, eps):
    """K10: the per-stage TRAIN field of a 2-layer tanh MLP, w1 (dz, H), b1
    (H,), w2 (H, dz), b2 (dz,), z and eps (B, dz).  Returns (y, tr, e_rate,
    n_rate) as `fused_field_plain` does.  CPU tensors run the plain version;
    CUDA tensors (float32 or float64) launch K10, or raise where it does not
    take the net.  Not differentiable itself: `fused_tanh_mlp_dynamics` is."""
    if z.device.type == "cpu":
        return fused_field_plain(w1, b1, w2, b2, z, eps)
    if z.device.type != "cuda":
        raise ValueError(f"K10 runs on CUDA or CPU tensors, got {z.device}")
    B, dz = z.shape
    H = w1.shape[1]
    shapes = [(dz, H), (H,), (H, dz), (dz,), (B, dz), (B, dz)]
    tensors = [w1, b1, w2, b2, z, eps]
    if z.dtype not in (torch.float32, torch.float64) or any(
        x.dtype != z.dtype or x.device != z.device for x in tensors
    ):
        raise ValueError("K10 takes float32 or float64 tensors of one type on one device")
    for x, shape in zip(tensors, shapes):
        if tuple(x.shape) != shape:
            raise ValueError(f"K10: got a tensor of shape {tuple(x.shape)}, expected {shape}")
    lib = _k10_library()
    smem = lib.cnf_k10_smem_bytes(dz, H, z.element_size())
    if smem > K10_SMEM_BYTES:
        raise NotImplementedError(
            f"K10 shape variants: the weights of a {dz} -> {H} -> {dz} net and the kernel's per-warp slices "
            f"need {smem} bytes of shared memory, over {K10_SMEM_BYTES} (ROADMAP queue 2)"
        )
    tensors = [x.contiguous() for x in tensors]
    y = torch.empty_like(tensors[4])
    tr, e_rate, n_rate = (torch.empty(B, dtype=z.dtype, device=z.device) for _ in range(3))
    if B == 0:
        return y, tr, e_rate, n_rate
    entry = lib.cnf_k10_fused_field_f32 if z.dtype == torch.float32 else lib.cnf_k10_fused_field_f64
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())  # noqa: E731
    err = entry(*[ptr(x) for x in tensors + [y, tr, e_rate, n_rate]], B, dz, H,
                ctypes.c_void_p(torch.cuda.current_stream(z.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"K10 launch failed with cudaError {err} (B {B}, dz {dz}, H {H})")
    run_fused_field_kernel.launches += 1
    return y, tr, e_rate, n_rate


run_fused_field_kernel.launches = 0


class _FusedField(torch.autograd.Function):
    """K10 forward, the plain version's VJP backward for all six inputs (the
    JAX package's `_fused_op_bwd`, :136-139).  The backward is built from
    differentiable ops (`torch.func.vjp`), so a gradient of the gradient
    works."""

    @staticmethod
    def forward(ctx, w1, b1, w2, b2, z, eps):
        ctx.save_for_backward(w1, b1, w2, b2, z, eps)
        return run_fused_field_kernel(w1, b1, w2, b2, z, eps)

    @staticmethod
    def backward(ctx, *cts):
        from torch.func import vjp

        _, vjp_fn = vjp(fused_field_plain, *ctx.saved_tensors)
        return vjp_fn(cts)


def fused_tanh_mlp_dynamics(params, z: torch.Tensor, eps: torch.Tensor):
    """The per-stage TRAIN field of a 2-layer tanh MLP for one (B, dz) probe:
    (y, tr = <eps^T J, eps>, ||y||, ||eps^T J||), through K10 on CUDA tensors
    and its plain version on CPU tensors; differentiable in the params, z and
    eps."""
    (p1, p2) = params
    return _FusedField.apply(p1["w"], p1["b"], p2["w"], p2["b"], z, eps)


__all__ = [
    "fused_tanh_mlp_dynamics",
    "fused_field_plain",
    "run_fused_field_kernel",
    "K10_KERNEL",
    "exact_tanh_mlp_trace",
    "dense_chain_trace",
    "dense_chain_jacobian",
    "exact_dense_chain_trace",
    "exact_dense_chain_jacobian",
    "is_dense_tanh_chain",
    "supports_fusion",
]
