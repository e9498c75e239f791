"""Whole-ODE-solve kernels ("solve-in-kernel"): the TEST and TRAIN forward
solves and the TRAIN backsolve adjoints.

Port of `continuousnf_tpu/ops/fused_solve.py`: `ChainSpec`/`chain_spec`
(:101-152), the stages `_stage_train` (:333-369) with `_chain_fwd`,
`_probe_pullback`, `_probe_pushforward`, `_safe_col_norm` and
`_ct_safe_norm` (:155-330), the hand-derived stage VJPs
`_stage_train_fwdbwd` (:372-481), K VJP or JVP probes in both, and
`_stage_test_fwdbwd` (:506-539), the exact stages
`exact_stage_consts`, `exact_pm_chain`, `_stage_train_exact`,
`_stage_train_exact_fwdbwd` and `_stage_train_exact_chain` (:542-728),
`FullSolve` (:1346-1357) and `make_full_solve` (:1378-1823), with the
conditioning rows of `_zin` (:265-269) in every stage, in batch-major
layout.

Twenty-four CUDA kernels (`csrc/`), each with a plain PyTorch twin; six for
2-layer tanh MLPs of state width up to MAX_DZ:
- K3 (`k3_test_solve.cu`, `run_solve_kernel`, twin `solve_test_plain`) for
  `_run_solve_kernel` with `_stage_test`: the TEST solve of [z | dlogp];
- K1 (`k1_train_solve.cu`, `run_train_solve_kernel`, twin
  `solve_train_plain`) for `_run_solve_kernel` with `_stage_train`: the TRAIN
  solve of [z | dlogp | reg_e | reg_n];
- K2 (`k2_train_adjoint.cu`, `run_adjoint_kernel`, twin
  `adjoint_train_plain`) for `adjoint_solve` with `_stage_train_fwdbwd`: the
  backward integration of (z, acc, a_z, g_p) from t1 to t0;
- the K4 forward (`k4_exact_solve.cu`, `run_exact_solve_kernel`, twin
  `solve_train_exact_plain`) for `_run_solve_kernel` with
  `_stage_train_exact`: the exact-trace TRAIN solve;
- the K4 adjoint (`k4_exact_adjoint.cu`, `run_exact_adjoint_kernel`, twin
  `adjoint_train_exact_plain`) for `adjoint_solve` with
  `_stage_train_exact_fwdbwd`: the backward integration of
  (z, acc, a_z, g_p, g_pm);
- K5 (`k5_test_adjoint.cu`, `run_test_adjoint_kernel`, twin
  `adjoint_test_plain`) for `adjoint_solve` with `_stage_test_fwdbwd`: the
  TEST backward integration of (z, dlogp, a_z, [a_ys,] g_p), conditional
  nets (K8) in a second instance;
and three for chains of 1 to CHAIN_MAX_LAYERS tanh or identity layers
other than the unconditional 2-layer tanh nets above, sharing the chain
layer of `csrc/chain_common.cuh`:
- the K1 chain form (`k1_chain_solve.cu`, `run_chain_train_solve_kernel`,
  twin `solve_train_plain`) for `_stage_train` over N layers;
- the K2 chain form (`k2_chain_adjoint.cu`, `run_chain_adjoint_kernel`, twin
  `adjoint_train_plain`) for the N-layer `_stage_train_fwdbwd`;
- K7 (`k7_chain_solve.cu`) for `_stage_exact_chain` (TEST,
  `run_chain_test_solve_kernel`, twin `solve_test_plain`) and
  `_stage_train_exact_chain` (exact TRAIN, `run_chain_exact_solve_kernel`,
  twin `solve_train_exact_plain`);
and the wide forms of those three for unconditional chains past their
widths (state widths to WIDE_MAX_DZ, hidden widths to WIDE_MAX_WIDTH: the
tabular MINIBOONE model), sharing the block-cooperative chain layer of
`csrc/chain_wide.cuh`, with the same twins: `k1_wide_solve.cu`
(`run_wide_train_solve_kernel`), `k2_wide_adjoint.cu`
(`run_wide_adjoint_kernel`) and `k7_wide_solve.cu` (TEST,
`run_wide_test_solve_kernel`; exact, `run_wide_exact_solve_kernel`);
and the wide forms of the three 2-layer-only stages, for unconditional
2-layer tanh nets past MAX_DZ (the README net family at the HEPMASS width,
42 -> 126 -> 42), on the same tile layer (`csrc/two_layer_wide.cuh`) and
with the same twins: wide K3 (`k3_wide_solve.cu`,
`run_wide_test2_solve_kernel`), wide K5 (`k5_wide_adjoint.cu`,
`run_wide_test_adjoint_kernel`) and the wide K4 adjoint
(`k4_wide_adjoint.cu`, `run_wide_exact_adjoint_kernel`);
and the streamed forms of the chain kernels, for the unconditional chains
the wide forms refuse for their state width (past WIDE_MAX_DZ, up to
STREAM_MAX_DZ), their hidden widths or the shared memory their weights take
(FFJORD's MINIBOONE model 43 -> 860 -> 860 -> 43; 2-layer tanh nets past
MAX_DZ among them), on the streamed chain layer of `csrc/chain_stream.cuh`
(the weights stay in global memory and stream through shared memory in
chunks) and with the same twins: `k1_stream_solve.cu`
(`run_stream_train_solve_kernel`), `k2_stream_adjoint.cu`
(`run_stream_adjoint_kernel`) and `k7_stream_solve.cu` (TEST,
`run_stream_test_solve_kernel`; exact, `run_stream_exact_solve_kernel`);
and the streamed forms of the two 2-layer TEST stages for the 2-layer tanh
nets among those (the README net family at the MINIBOONE width,
86 -> 258 -> 86), on `csrc/two_layer_stream.cuh` and with the same twins:
streamed K3 (`k3_stream_solve.cu`, `run_stream_test2_solve_kernel`) and
streamed K5 (`k5_stream_adjoint.cu`, `run_stream_test_adjoint_kernel`), and
their exact backward member, the streamed K4 adjoint
(`k4_stream_adjoint.cu`, `run_stream_exact_adjoint_kernel`, twin
`adjoint_train_exact_plain`: each stage's per-sample pass, then the
batch-summed gradient rate as slice-owned contractions over the whole
batch);
and the COND instances of the wide forms (K8: conditional nets past the
narrow widths that the wide forms keep; CondRNODE at the HEPMASS width,
43 -> 126 -> 42 on [z | ys]), in the wide sources, with the same twins
given ys: the wide K1 chain form's (`run_wide_cond_train_solve_kernel`),
the wide K2 chain form's (`run_wide_cond_adjoint_kernel`, a_ys0 returned),
wide K3's (`run_wide_cond_test2_solve_kernel`), wide K5's
(`run_wide_cond_test_adjoint_kernel`, a_ys0 returned), wide K7 TEST's and
exact's (`run_wide_cond_test_solve_kernel`, `run_wide_cond_exact_solve_kernel`)
and the wide K4 adjoint's (`run_wide_cond_exact_adjoint_kernel`, a_ys0
returned);
and the COND instances of the streamed forms (K8 past the wide limits:
CondRNODE at the MINIBOONE width, 87 -> 258 -> 86 on [z | ys]), in the
streamed sources, with the same twins given ys: the streamed K1 chain
form's (`run_stream_cond_train_solve_kernel`), the streamed K2 chain
form's (`run_stream_cond_adjoint_kernel`, a_ys0 returned), streamed K3's
(`run_stream_cond_test2_solve_kernel`) and streamed K5's
(`run_stream_cond_test_adjoint_kernel`, a_ys0 returned);
and three under bf16 stage matmuls (`ComputeMode.bf16`: the JAX package's
`_mm(..., "bf16")` :193-225, both operands rounded to bfloat16, float32
sums), for unconditional 2-layer tanh nets of state width up to MAX_DZ and
hidden width up to BF16_MAX_WIDTH with one VJP probe, on the tensor cores
(`csrc/mma_bf16.cuh`), with the f32 kernels' twins run with `bf16=True`:
bf16 K3 (`k3_bf16_solve.cu`, `run_bf16_solve_kernel`), bf16 K1
(`k1_bf16_solve.cu`, `run_bf16_train_solve_kernel`) and bf16 K2
(`k2_bf16_adjoint.cu`, `run_bf16_adjoint_kernel`).
Each runs one whole adaptive solve in one cooperative launch, with one
batch-global error norm per attempted step, under any explicit tableau with
an embedded error estimate (K9: `_stretched_eest` :766-770 and the non-FSAL
refresh :914-922, :1293-1298; the tableau is a run-time argument,
`_tableau_array`).  K1, K2, their chain forms and the chain forms' wide
forms have a second, probe instance each (K6): K Hutchinson probes (eps
(K, B, dz)), reverse or forward mode, K and the direction run-time values;
the one-VJP-probe instance stays as it was, and the wrappers take it for
K = 1 VJP.  The
chain kernels also take conditional nets (K8: the
first layer reads [z | ys], ys constant over the solve; the K2 chain form
integrates the per-sample ys cotangent) and identity layers (K9,
`ChainSpec.acts` :104-111).  `make_full_solve` takes the chain kernels for
chains of 3 or more layers, for every conditional net and for every net
with an identity layer (their wide forms past the narrow widths, the COND
instances there for a conditional net, with wide K3's and wide K5's for
its TEST stages and the wide K4 adjoint's for its exact backward), the
2-layer kernels for unconditional 2-layer tanh nets (past MAX_DZ: wide K3,
the wide K1 and K2 chain forms, wide K7 exact and the wide K4 adjoint,
wide K5; past the wide forms' state width, hidden widths or shared memory
streamed K3 and K5 and the streamed chain forms, with the streamed K4
adjoint as the exact backward member), and K5 for the TEST backward of
every other 2-layer tanh net,
conditional or not; chains the wide forms refuse for their hidden widths or
their weights' shared memory run the streamed forms (one VJP probe).  The
forward kernels
return the last step they took beside the next step size
(`utils/near_tie.py` reads it).

A wrapper launches its kernel for CUDA tensors and runs its twin for CPU
tensors.  On a CUDA tensor there is no fallback: a configuration the kernel
does not cover raises NotImplementedError naming the kernel that would.
Each wrapper's `.launches` counts its kernel's launches, and a Hutchinson
kernel's `.probe_launches[(K, jvp)]` those of its probe instance.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..core.dynamics import safe_norm, safe_sqrt
from ..ode.solve import SolveStats, _initial_step_size, _solve_adaptive_while, needs_grad
from ..ode.tableaus import TSIT5, ButcherTableau, get_tableau  # noqa: F401 (TSIT5: re-exported)
from ..types import ADMode, Adjoint, Mode
from .fused_dynamics import K10_KERNEL, run_fused_field_kernel

K3_KERNEL = "k3_test_solve"
K1_KERNEL = "k1_train_solve"
K2_KERNEL = "k2_train_adjoint"
K4_KERNEL = "k4_exact_solve"
K4A_KERNEL = "k4_exact_adjoint"
K5_KERNEL = "k5_test_adjoint"
K1C_KERNEL = "k1_chain_solve"
K2C_KERNEL = "k2_chain_adjoint"
K7_KERNEL = "k7_chain_solve"
K1W_KERNEL = "k1_wide_solve"
K2W_KERNEL = "k2_wide_adjoint"
K7W_KERNEL = "k7_wide_solve"
K3W_KERNEL = "k3_wide_solve"
K5W_KERNEL = "k5_wide_adjoint"
K4WA_KERNEL = "k4_wide_adjoint"
K1S_KERNEL = "k1_stream_solve"
K2S_KERNEL = "k2_stream_adjoint"
K7S_KERNEL = "k7_stream_solve"
K3S_KERNEL = "k3_stream_solve"
K5S_KERNEL = "k5_stream_adjoint"
K4SA_KERNEL = "k4_stream_adjoint"
K3B_KERNEL = "k3_bf16_solve"
K1B_KERNEL = "k1_bf16_solve"
K2B_KERNEL = "k2_bf16_adjoint"

#: The chain kernels (the K1 and K2 chain forms, K7) take tanh chains of 1
#: to CHAIN_MAX_LAYERS layers with hidden widths up to CHAIN_MAX_WIDTH,
#: conditional or not, and every kernel a state width up to MAX_DZ
#: (csrc/chain_common.cuh), where the K2 chain form's weights and the slots
#: of a 32-thread block fit in a block's shared memory.  Their wide forms
#: take the chains of 2 to CHAIN_MAX_LAYERS layers beyond, with state widths
#: up to WIDE_MAX_DZ and hidden widths up to WIDE_MAX_WIDTH
#: (csrc/chain_wide.cuh), where a block's shared memory
#: (WIDE_SMEM_BYTES) holds all the weights beside a tile of samples.  Their
#: streamed forms take the unconditional chains the wide forms refuse for
#: their state width, their hidden widths or the shared memory their
#: weights take, up to state width STREAM_MAX_DZ (csrc/chain_stream.cuh:
#: the weights stay in global memory and stream through shared memory), with
#: parameter counts below STREAM_MAX_PARAMS.
CHAIN_MAX_LAYERS = 8
CHAIN_MAX_WIDTH = 64
MAX_DZ = 32
WIDE_MAX_DZ = 64
STREAM_MAX_DZ = 128
WIDE_MAX_WIDTH = 128
WIDE_SMEM_BYTES = 232_448
STREAM_MAX_PARAMS = 2**31 - 1


class ChainSpec(NamedTuple):
    """Static description of a Dense/tanh chain the megakernel covers.

    `acts[i]` is True for tanh and False for identity; `n_cond > 0` marks a
    conditional net whose first layer reads `[z | ys]`.
    """

    in_dims: Tuple[int, ...]
    out_dims: Tuple[int, ...]
    acts: Tuple[bool, ...]
    n_cond: int

    @property
    def n_layers(self) -> int:
        return len(self.out_dims)

    @property
    def dz(self) -> int:
        return self.out_dims[-1]


def chain_spec(nn, zdim: int) -> Optional[ChainSpec]:
    """ChainSpec for `nn` if it is an eligible Dense chain mapping a
    zdim-state (plus optional conditioning inputs) to a zdim field."""
    from ..nets.modules import Chain, Dense

    if not isinstance(nn, Chain) or not len(nn.layers):
        return None
    in_dims, out_dims, acts = [], [], []
    for layer in nn.layers:
        if not isinstance(layer, Dense) or not layer.use_bias:
            return None
        if layer.activation is not torch.tanh and layer.activation is not None:
            return None
        in_dims.append(layer.in_dim)
        out_dims.append(layer.out_dim)
        acts.append(layer.activation is torch.tanh)
    for nxt, prev in zip(in_dims[1:], out_dims[:-1]):
        if nxt != prev:
            return None
    if out_dims[-1] != zdim:
        return None
    n_cond = in_dims[0] - zdim
    if n_cond < 0:
        return None
    return ChainSpec(tuple(in_dims), tuple(out_dims), tuple(acts), n_cond)


class FullSolve(NamedTuple):
    """Fused solve implementations handed to `ode.solve.odeint_with_stats`.

    forward: (y0f, t0, t1, args) -> (yTf, stats).
    adjoint: (yTf, g_yf, args, t_hi, t_lo, dt_warm=None) ->
             (y0f, a_y0f, g_args, stats), the backsolve backward integration
             (`ode/adjoint.py`); None for TEST and exact-trace chains of
             N != 2 layers (forward-only, as in the JAX package) and for
             TEST 2-layer nets with an identity layer (the JAX package's
             2-layer TEST stage assumes tanh layers): the plain BACKSOLVE
             backward runs.
    """

    forward: Callable
    adjoint: Optional[Callable]


# ---- stages (batch-major) ----


def _zin(z, ys):
    """The chain's input rows [z | ys] (ys (B, n_cond) or None)."""
    from ..nets.modules import with_cond

    return z if ys is None else with_cond(z, ys)


def _test_stage(spec: ChainSpec, ws, bs, z, ys=None):
    """The plain TEST field of the chain: (y, tr J), J in z."""
    from .fused_dynamics import dense_chain_trace, exact_tanh_mlp_trace

    if ys is None and spec.n_layers == 2 and all(spec.acts):
        return exact_tanh_mlp_trace(({"w": ws[0], "b": bs[0]}, {"w": ws[1], "b": bs[1]}), z)
    return dense_chain_trace(ws, bs, spec.acts, z, ys)


#: ROADMAP queue 2's row of the bf16 stage matmuls that neither a kernel nor a
#: twin runs yet; every refusal under `ComputeMode.bf16` names it.
BF16_ROW = "ROADMAP queue 2, bf16 stage dots"


def _mm_bf16(a, b):
    """a @ b under bf16 stage matmuls (the JAX package's `_mm(..., "bf16")`,
    :193-225): both operands rounded to bfloat16 (round to nearest even),
    their exact products summed in the operands' float type."""
    return a.to(torch.bfloat16).to(a.dtype) @ b.to(torch.bfloat16).to(b.dtype)


def _mm(a, b, bf16: bool):
    """A stage matmul: a @ b, or `_mm_bf16` under bf16."""
    return _mm_bf16(a, b) if bf16 else a @ b


def _test_stage_bf16(spec: ChainSpec, ws, bs, z, ys=None):
    """The 2-layer tanh TEST field under bf16 stage matmuls, in the closed
    form of the JAX package's `_stage_test` (:484-503): (y, tr J) with
    tr J = sum_i dy_i (dh m^T)_i, m = W1z * W2^T formed in float32 from the
    z rows of W1 and then rounded (not the product of the rounded
    weights).  Deeper chains (the deep exact chain stage) have no bf16
    twin yet and raise."""
    if not _two_layer_tanh(spec):
        raise NotImplementedError(
            f"the TEST stage of a {spec.n_layers}-layer chain or of a chain with an identity layer (the deep exact "
            f"chain stage) under bf16 stage matmuls ({BF16_ROW})"
        )
    hs, (dh, dy) = _chain_fwd(spec, _zin(z, ys), ws, bs, bf16=True)
    m = ws[0][: spec.dz] * ws[1].T
    return hs[-1], torch.sum(dy * _mm_bf16(dh, m.T), dim=-1)


def _chain_fwd(spec: ChainSpec, zin, ws, bs, bf16: bool = False):
    """Forward pass of the chain on its input rows zin = [z | ys]: hs[0] =
    zin, hs[i+1] = layer i's output; ds[i] = its tanh' gate (None for an
    identity layer).  `bf16`: the products under bf16 stage matmuls."""
    hs, ds = [zin], []
    for i in range(spec.n_layers):
        a = _mm(hs[-1], ws[i], bf16) + bs[i]
        if spec.acts[i]:
            h = torch.tanh(a)
            ds.append(1.0 - h * h)
        else:
            h = a
            ds.append(None)
        hs.append(h)
    return hs, ds


def _probe_pullback(spec: ChainSpec, ek, ws, ds, bf16: bool = False):
    """One Hutchinson VJP pass, eps^T J.  Returns (us, vs, eJ): us[i] = the
    cotangent arriving at hs[i] (us[N] = ek), vs[i] = the gated cotangent
    entering layer i's matmul, eJ = the z columns of us[0]."""
    N = spec.n_layers
    us = [None] * (N + 1)
    vs = [None] * N
    us[N] = ek
    for i in reversed(range(N)):
        vs[i] = us[i + 1] * ds[i] if ds[i] is not None else us[i + 1]
        us[i] = _mm(vs[i], ws[i].T, bf16)
    return us, vs, us[0][:, : spec.dz]


def _probe_pushforward(spec: ChainSpec, ek, ws, ds, bf16: bool = False):
    """One Hutchinson JVP pass, J eps (the forward-mode counterpart of
    `_probe_pullback`).  Returns (ts, us, Je): ts[i] = the tangent arriving
    at hs[i] (ts[0] = [ek | 0]: the probe has no ys rows), us[i] = layer i's
    matmul output before its gate, Je = ts[N]."""
    t = ek if not spec.n_cond else torch.cat([ek, ek.new_zeros(ek.shape[0], spec.n_cond)], dim=-1)
    ts, us = [t], []
    for i in range(spec.n_layers):
        u = _mm(ts[-1], ws[i], bf16)
        us.append(u)
        ts.append(u * ds[i] if ds[i] is not None else u)
    return ts, us, ts[-1]


def _probe_pass(spec: ChainSpec, ek, ws, ds, jvp: bool, bf16: bool = False):
    """eps^T J (`_probe_pullback`) or, `jvp`, J eps (`_probe_pushforward`),
    with the pass's residuals."""
    return (_probe_pushforward if jvp else _probe_pullback)(spec, ek, ws, ds, bf16)


def _ct_safe_norm(ct, norm):
    """Cotangent factor of `safe_norm`: ct / ||v||, 0 at v = 0."""
    pos = norm > 0
    return torch.where(pos, ct / torch.where(pos, norm, torch.ones_like(norm)), torch.zeros_like(norm))


def _stage_train(spec: ChainSpec, z, eps, ws, bs, norm_z: bool, norm_j: bool, ys=None, jvp: bool = False,
                 bf16: bool = False):
    """One TRAIN field evaluation: z (B, dz), probes eps (K, B, dz), the
    conditioning ys (B, n_cond) or None.  Returns (k_z (B, dz), rates (3, B)
    = [-tr, ||y||, ||eps^T J||]), the trace and the probe norm averaged over
    the K probes; `jvp` takes J eps (forward mode) in place of eps^T J;
    `bf16` runs every product under bf16 stage matmuls (`_mm_bf16`), the
    gates, sums and norms in float32."""
    hs, ds = _chain_fwd(spec, _zin(z, ys), ws, bs, bf16)
    y = hs[-1]
    zero = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
    tr, n_rate = zero, zero
    for ek in eps:
        _, _, eJ = _probe_pass(spec, ek, ws, ds, jvp, bf16)
        tr = tr + torch.sum(eJ * ek, dim=-1)
        if norm_j:
            n_rate = n_rate + safe_norm(eJ)
    if eps.shape[0] > 1:
        tr = tr / eps.shape[0]
        n_rate = n_rate / eps.shape[0]
    e_rate = safe_norm(y) if norm_z else zero
    return y, torch.stack([-tr, e_rate, n_rate])


def _stage_train_fwdbwd(spec: ChainSpec, z, eps, ws, bs, norm_z: bool, norm_j: bool, ct_y, ct_r, ys=None,
                        jvp: bool = False, bf16: bool = False):
    """`_stage_train` and its hand-derived VJP against (ct_y (B, dz), ct_r
    (3, B)) in one pass: the math the K2 kernel runs.  Returns (k_z, rates,
    ct_zin, ct_ws, ct_bs), the cotangents not negated and the parameter ones
    summed over the batch; ct_zin is the cotangent of the input rows
    [z | ys].  The probe has zero ys rows, so the ys rows of W0's gradient
    come from the forward chain alone (ys x ca_0).  Each probe adds its own
    terms: up the pullback chain (VJP) or down the pushforward chain (JVP);
    the probes get no cotangent.  `bf16`: every product, the batch sums of
    the weight gradients included, under bf16 stage matmuls; the bias
    gradients are float32 sums."""
    N = spec.n_layers
    K = eps.shape[0]
    hs, ds = _chain_fwd(spec, _zin(z, ys), ws, bs, bf16)
    y = hs[-1]
    zero = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
    uss, vss, eJs, ns = [], [], [], []
    tr, n_rate = zero, zero
    for ek in eps:
        us, vs, eJ = _probe_pass(spec, ek, ws, ds, jvp, bf16)
        uss.append(us)
        vss.append(vs)
        eJs.append(eJ)
        tr = tr + torch.sum(eJ * ek, dim=-1)
        if norm_j:
            ns.append(safe_norm(eJ))
            n_rate = n_rate + ns[-1]
    if K > 1:
        tr = tr / K
        n_rate = n_rate / K
    e_rate = safe_norm(y) if norm_z else zero
    kr = torch.stack([-tr, e_rate, n_rate])

    def add(acc, x):
        return x if acc is None else acc + x

    # Rates row 0 is -tr, averaged over the probes.
    ct_tr = (-1.0 / K) * ct_r[0]
    ct_hs = [None] * (N + 1)
    ct_ws = [None] * N
    ct_ytot = ct_y
    if norm_z:
        ct_ytot = ct_ytot + y * _ct_safe_norm(ct_r[1], e_rate)[:, None]
    for k, ek in enumerate(eps):
        ct_u = ek * ct_tr[:, None]
        if norm_j:
            ct_u = ct_u + eJs[k] * _ct_safe_norm(ct_r[2] / K, ns[k])[:, None]
        if jvp:
            # Down the pushforward chain: ts[i+1] = (ts[i] W_i) * d_i, with
            # ts = uss[k] and the pre-gate products us = vss[k].
            ct_t = ct_u
            for i in reversed(range(N)):
                if ds[i] is not None:
                    ct_a = ct_t * ds[i]
                    # d_i = 1 - hs[i+1]^2: ct_h += -2 h (ct_t * u_i)
                    ct_hs[i + 1] = add(ct_hs[i + 1], (-2.0 * hs[i + 1]) * (ct_t * vss[k][i]))
                else:
                    ct_a = ct_t
                ct_ws[i] = add(ct_ws[i], _mm(uss[k][i].T, ct_a, bf16))
                if i > 0:
                    ct_t = _mm(ct_a, ws[i].T, bf16)
            continue
        if spec.n_cond:
            ct_u = torch.cat([ct_u, ct_u.new_zeros(ct_u.shape[0], spec.n_cond)], dim=-1)
        # Up the pullback chain: u_i = v_i W_i^T, v_i = u_{i+1} * d_i.
        for i in range(N):
            ct_v = _mm(ct_u, ws[i], bf16)
            ct_ws[i] = add(ct_ws[i], _mm(ct_u.T, vss[k][i], bf16))
            if ds[i] is not None:
                ct_u = ct_v * ds[i]
                # d_i = 1 - hs[i+1]^2: ct_h += -2 h (ct_v * u_{i+1})
                ct_hs[i + 1] = add(ct_hs[i + 1], (-2.0 * hs[i + 1]) * (ct_v * uss[k][i + 1]))
            else:
                ct_u = ct_v
    # Down the forward chain.
    ct_h = add(ct_hs[N], ct_ytot)
    ct_bs = [None] * N
    for i in reversed(range(N)):
        ct_a = ct_h * ds[i] if ds[i] is not None else ct_h
        ct_ws[i] = add(ct_ws[i], _mm(hs[i].T, ct_a, bf16))
        ct_bs[i] = torch.sum(ct_a, dim=0)
        ct_h = _mm(ct_a, ws[i].T, bf16)
        if i > 0 and ct_hs[i] is not None:
            ct_h = ct_h + ct_hs[i]
    return y, kr, ct_h, ct_ws, ct_bs


def _two_layer_tanh(spec: ChainSpec) -> bool:
    """True for a 2-layer tanh chain, conditional or not: where the exact
    TRAIN stage is the 2-layer pm form (K4; other Dense chains take the
    basis-propagation form, K7) and where the TEST backward stage exists
    (`_stage_test_fwdbwd`, K5)."""
    return spec.n_layers == 2 and all(spec.acts)


def exact_stage_consts(w1, w2):
    """pm[(j, i), h] = w1[j, h] w2[h, i], (dz^2, H) in j-major row order: the
    2-layer exact stage's constant, built once per solve."""
    dz, H = w1.shape
    return (w1[:, None, :] * w2.T[None, :, :]).reshape(dz * dz, H)


def exact_pm_chain(g_pm, w1, w2):
    """Chain the pm cotangent (dz^2, H) back to (w1, w2)."""
    dz, H = w1.shape
    g3 = g_pm.reshape(dz, dz, H)  # [j, i, h]
    return torch.einsum("jih,hi->jh", g3, w2), torch.einsum("jih,jh->hi", g3, w1)


def _exact_m3(spec: ChainSpec, z, ws, bs, pm, ys=None):
    """Forward pass and m[b, j, i] = sum_h pm[(j, i), h] dh[b, h]."""
    hs, ds = _chain_fwd(spec, _zin(z, ys), ws, bs)
    m3 = (ds[0] @ pm.T).reshape(z.shape[0], spec.dz, spec.dz)
    return hs, ds, m3


def _stage_train_exact(spec: ChainSpec, z, ws, bs, pm, norm_z: bool, norm_j: bool, ys=None):
    """One exact TRAIN field evaluation of a 2-layer tanh chain: with
    J[b]_ji = dy_i m[b, j, i], tr = sum_i dy_i m[i, i] and
    ||J||_F^2 = sum_i dy_i^2 sum_j m[j, i]^2 (pm built from the z rows of
    W0).  Returns (k_z, rates (3, B) = [-tr, ||y||, ||J||_F])."""
    hs, ds, m3 = _exact_m3(spec, z, ws, bs, pm, ys)
    y, dy = hs[-1], ds[1]
    tr = torch.sum(dy * torch.diagonal(m3, dim1=1, dim2=2), dim=-1)
    zero = torch.zeros_like(tr)
    n_rate = safe_sqrt(torch.sum(dy * dy * torch.sum(m3 * m3, dim=1), dim=-1)) if norm_j else zero
    e_rate = safe_norm(y) if norm_z else zero
    return y, torch.stack([-tr, e_rate, n_rate])


def _stage_train_exact_fwdbwd(spec: ChainSpec, z, ws, bs, pm, norm_z: bool, norm_j: bool, ct_y, ct_r, ys=None):
    """`_stage_train_exact` and its hand-derived VJP against (ct_y (B, dz),
    ct_r (3, B)) in one pass: the math the K4 adjoint runs.  Returns (k_z,
    rates, ct_zin, ct_ws, ct_bs, ct_pm), the cotangents not negated and the
    parameter and pm ones summed over the batch; ct_zin is the cotangent of
    the input rows [z | ys]."""
    hs, ds, m3 = _exact_m3(spec, z, ws, bs, pm, ys)
    y, (dh, dy) = hs[-1], ds
    d = torch.diagonal(m3, dim1=1, dim2=2)  # (B, dz)
    s = torch.sum(m3 * m3, dim=1)  # (B, dz): s[i] = sum_j m[j, i]^2
    tr = torch.sum(dy * d, dim=-1)
    zero = torch.zeros_like(tr)
    n_rate = safe_sqrt(torch.sum(dy * dy * s, dim=-1)) if norm_j else zero
    e_rate = safe_norm(y) if norm_z else zero
    kr = torch.stack([-tr, e_rate, n_rate])

    ct_tr = -ct_r[0][:, None]
    ct_d = dy * ct_tr
    ct_dy = d * ct_tr
    ct_m3 = torch.diag_embed(ct_d)
    if norm_j:
        # n = sqrt(fro^2): d n / d fro^2 = 1 / (2 n), 0 at n = 0.
        ct_fro2 = 0.5 * _ct_safe_norm(ct_r[2], n_rate)[:, None]
        ct_s = (dy * dy) * ct_fro2
        ct_dy = ct_dy + 2.0 * dy * s * ct_fro2
        ct_m3 = ct_m3 + (2.0 * ct_s[:, None, :]) * m3
    ct_mflat = ct_m3.reshape(z.shape[0], -1)
    ct_dh = ct_mflat @ pm  # (B, H)
    ct_pm = ct_mflat.T @ dh  # (dz^2, H)
    ct_ytot = ct_y + (-2.0 * y) * ct_dy
    if norm_z:
        ct_ytot = ct_ytot + y * _ct_safe_norm(ct_r[1], e_rate)[:, None]
    ct_pre2 = ct_ytot * dy
    ct_h = ct_pre2 @ ws[1].T + (-2.0 * hs[1]) * ct_dh
    ct_pre1 = ct_h * dh
    ct_ws = [hs[0].T @ ct_pre1, hs[1].T @ ct_pre2]
    ct_bs = [torch.sum(ct_pre1, dim=0), torch.sum(ct_pre2, dim=0)]
    return y, kr, ct_pre1 @ ws[0].T, ct_ws, ct_bs, ct_pm


def _stage_train_exact_chain(spec: ChainSpec, z, ws, bs, norm_z: bool, norm_j: bool, ys=None):
    """The exact TRAIN stage of any Dense tanh-or-identity chain, from the
    batched chain Jacobian in z (the basis-propagation form, K7)."""
    from .fused_dynamics import dense_chain_jacobian

    y, J = dense_chain_jacobian(ws, bs, spec.acts, z, ys)
    tr = torch.diagonal(J, dim1=1, dim2=2).sum(-1)
    zero = torch.zeros_like(tr)
    n_rate = safe_sqrt(torch.sum(J * J, dim=(1, 2))) if norm_j else zero
    e_rate = safe_norm(y) if norm_z else zero
    return y, torch.stack([-tr, e_rate, n_rate])


def _stage_test_fwdbwd(spec: ChainSpec, z, ws, bs, ct_y, ct_r, ys=None):
    """The 2-layer TEST stage and its hand-derived VJP against (ct_y (B, dz),
    ct_r (1, B), the cotangent of the -tr row) in one pass: the math K5
    runs.  With m = W1z * W2^T (the z rows of W1), tr = sum_i dy_i (m dh)_i.
    Returns (k_z, kr (1, B), ct_zin, ct_ws, ct_bs), the cotangents not
    negated and the parameter ones summed over the batch, ct_m folded in:
    into W2 as (ct_m * W1z)^T and into the z rows of W1 as ct_m * W2^T (its
    ys rows get none)."""
    hs, (dh, dy) = _chain_fwd(spec, _zin(z, ys), ws, bs)
    y = hs[-1]
    w1z = ws[0][: spec.dz]
    m = w1z * ws[1].T  # (dz, H)
    mdh = dh @ m.T  # (B, dz)
    tr = torch.sum(dy * mdh, dim=-1)
    ct_tr = -ct_r[0][:, None]
    ct_dy = mdh * ct_tr
    ct_mdh = dy * ct_tr
    ct_dh = ct_mdh @ m  # (B, H)
    ct_m = ct_mdh.T @ dh  # (dz, H)
    ct_pre2 = (ct_y + (-2.0 * y) * ct_dy) * dy
    ct_pre1 = (ct_pre2 @ ws[1].T + (-2.0 * hs[1]) * ct_dh) * dh
    ct_ws = [hs[0].T @ ct_pre1 + _pad_rows(ct_m * ws[1].T, ws[0].shape[0]), hs[1].T @ ct_pre2 + (ct_m * w1z).T]
    ct_bs = [torch.sum(ct_pre1, dim=0), torch.sum(ct_pre2, dim=0)]
    return y, -tr[None], ct_pre1 @ ws[0].T, ct_ws, ct_bs


# ---- plain twins ----


def _solve_plain(stage, tab, *, rtol, atol, max_steps, z0, acc0, t0, t1, dt_init):
    """The eager adaptive solve of [z | acc] with `stage(z) -> (k_z, k_acc)`,
    the accumulators seeded from acc0 (its shape: (B,) or (rows, B)).
    Returns (zT, accT, steps, accepted, dt_last, dt_used): dt_last the next
    step size, dt_used the last step taken."""
    B, dz = z0.shape

    def f(t, yf):
        y, kr = stage(yf[: B * dz].reshape(B, dz))
        return torch.cat([y.reshape(-1), kr.reshape(-1)])

    y0f = torch.cat([z0.reshape(-1), acc0.reshape(-1)])
    yf, st = _solve_adaptive_while(f, tab, y0f, t0, t1, rtol, atol, max_steps, dt_init)
    zT, accT = yf[: B * dz].reshape(B, dz), yf[B * dz :].reshape(acc0.shape)
    return zT, accT, st.steps, st.accepted, st.dt_last, st.dt_used


def solve_test_plain(tab, spec, *, rtol, atol, max_steps, ws, bs, z0, dlogp0, t0, t1, dt_init, ys=None,
                     bf16=False):
    """Plain PyTorch version of K3 and K7 TEST: the eager adaptive solve of
    [z | dlogp] on the closed-form TEST field (conditioned on ys (B, n_cond)
    when given), from the given initial step; `bf16`, of bf16 K3: the
    2-layer closed form under bf16 stage matmuls (`_test_stage_bf16`).
    Returns (zT, dlogpT, steps, accepted, dt_last, dt_used)."""

    def stage(z):
        y, tr = (_test_stage_bf16 if bf16 else _test_stage)(spec, ws, bs, z, ys)
        return y, -tr

    return _solve_plain(stage, tab, rtol=rtol, atol=atol, max_steps=max_steps, z0=z0, acc0=dlogp0,
                        t0=t0, t1=t1, dt_init=dt_init)


def solve_train_plain(
    tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, z0, eps, acc0, t0, t1, dt_init, ys=None,
    jvp=False, bf16=False,
):
    """Plain PyTorch version of K1 and its chain form (and, `bf16`, of bf16
    K1: the stage under bf16 stage matmuls): the eager adaptive
    solve of [z | acc] with acc (3, B) = [dlogp | reg_e | reg_n] rows,
    seeded from acc0, on `_stage_train` with probes eps (K, B, dz), VJP or
    (`jvp`) JVP, and the conditioning ys (B, n_cond) or None.  Returns
    (zT, accT, steps, accepted, dt_last, dt_used)."""
    return _solve_plain(
        lambda z: _stage_train(spec, z, eps, ws, bs, norm_z, norm_j, ys, jvp, bf16), tab, rtol=rtol, atol=atol,
        max_steps=max_steps, z0=z0, acc0=acc0, t0=t0, t1=t1, dt_init=dt_init,
    )


def _exact_pm(spec, ws):
    """The 2-layer exact stage's constant, from the z rows of W0."""
    return exact_stage_consts(ws[0][: spec.dz], ws[1])


def solve_train_exact_plain(
    tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, z0, acc0, t0, t1, dt_init, ys=None
):
    """Plain PyTorch version of the K4 forward and K7 exact: the eager
    adaptive solve of [z | acc] with acc (3, B) = [dlogp | reg_e | reg_n]
    rows, seeded from acc0, on the exact TRAIN stage (`_stage_train_exact`
    for 2-layer tanh chains, `_stage_train_exact_chain` for others), with
    the conditioning ys (B, n_cond) or None.  Returns
    (zT, accT, steps, accepted, dt_last, dt_used)."""
    if _two_layer_tanh(spec):
        pm = _exact_pm(spec, ws)
        stage = lambda z: _stage_train_exact(spec, z, ws, bs, pm, norm_z, norm_j, ys)  # noqa: E731
    else:
        stage = lambda z: _stage_train_exact_chain(spec, z, ws, bs, norm_z, norm_j, ys)  # noqa: E731
    return _solve_plain(stage, tab, rtol=rtol, atol=atol, max_steps=max_steps, z0=z0, acc0=acc0,
                        t0=t0, t1=t1, dt_init=dt_init)


def _split_zin(spec, ct_zin, ys):
    """(ct_z, the per-sample ys block) of an input-row cotangent: the ys
    block is [ct_ys] for a conditional stage, [] otherwise."""
    return ct_zin[:, : spec.dz], ([] if ys is None else [ct_zin[:, spec.dz :]])


def _train_adjoint_stage(spec, ws, bs, eps, norm_z, norm_j, aaccT, ys=None, jvp=False, bf16=False):
    """`(z, a_z) -> (k_z, rates, ct_z, gradient blocks [ct_ys,] [w..., b...])`
    of the Hutchinson TRAIN stage (K2), VJP or (`jvp`) JVP probes, under bf16
    stage matmuls with `bf16`: the ct_ys block (B, n_cond) only for a
    conditional stage."""

    def stage(z, az):
        y, kr, ct_zin, ct_ws, ct_bs = _stage_train_fwdbwd(spec, z, eps, ws, bs, norm_z, norm_j, az, aaccT, ys, jvp,
                                                          bf16)
        ct_z, ys_block = _split_zin(spec, ct_zin, ys)
        return y, kr, ct_z, ys_block + list(ct_ws) + list(ct_bs)

    return stage


def _test_adjoint_stage(spec, ws, bs, aaccT, ys=None):
    """The same for the 2-layer TEST stage (K5): the blocks are [ct_ys,]
    [w1, w2, b1, b2], ct_m folded in."""

    def stage(z, az):
        y, kr, ct_zin, ct_ws, ct_bs = _stage_test_fwdbwd(spec, z, ws, bs, az, aaccT, ys)
        ct_z, ys_block = _split_zin(spec, ct_zin, ys)
        return y, kr, ct_z, ys_block + list(ct_ws) + list(ct_bs)

    return stage


def _exact_adjoint_stage(spec, ws, bs, pm, norm_z, norm_j, aaccT, ys=None):
    """The same for the 2-layer exact TRAIN stage (K4): the blocks are
    [ct_ys,] [w1, w2, b1, b2, pm]."""

    def stage(z, az):
        y, kr, ct_zin, ct_ws, ct_bs, ct_pm = _stage_train_exact_fwdbwd(
            spec, z, ws, bs, pm, norm_z, norm_j, az, aaccT, ys
        )
        ct_z, ys_block = _split_zin(spec, ct_zin, ys)
        return y, kr, ct_z, ys_block + list(ct_ws) + list(ct_bs) + [ct_pm]

    return stage


def _block_shapes(ws, bs, ys, extra=()):
    """The shapes of the backward state's blocks after a_acc: [the per-sample
    a_ys (B, n_cond),] the parameter gradients [w..., b...], then `extra`."""
    return ([] if ys is None else [ys.shape]) + [x.shape for x in list(ws) + list(bs)] + list(extra)


def _adjoint_state(stage, zT, accT, azT, aaccT, shapes):
    """The backward field of the flat augmented state
    [z | acc (nacc, B) | a_z | a_acc (nacc, B) | blocks of `shapes`] (nacc:
    3 in TRAIN mode, 1 in TEST mode; the stage, its rates, -ct_z, a constant
    a_acc and the negated cotangents of the blocks: a per-sample a_ys, then
    the parameter gradients) and its value at t_hi (zero blocks)."""
    B, dz = zT.shape
    n, na = B * dz, accT.numel()

    def f(t, uf):
        z = uf[:n].reshape(B, dz)
        az = uf[n + na : 2 * n + na].reshape(B, dz)
        y, kr, ct_z, grads = stage(z, az)
        parts = [y.reshape(-1), kr.reshape(-1), -ct_z.reshape(-1), torch.zeros_like(aaccT).reshape(-1)]
        return torch.cat(parts + [-g.reshape(-1) for g in grads])

    u0 = torch.cat(
        [zT.reshape(-1), accT.reshape(-1), azT.reshape(-1), aaccT.reshape(-1)]
        + [torch.zeros(torch.Size(s).numel(), dtype=zT.dtype, device=zT.device) for s in shapes]
    )
    return f, u0


def _adjoint_plain(stage, shapes, tab, *, rtol, atol, max_steps, zT, accT, azT, aaccT, t_hi, t_lo, dt_init):
    """The eager adaptive backsolve of (z, acc, a_z, a_acc, blocks) from t_hi
    to t_lo, one error norm over the whole augmented state.  Returns
    (z0, acc0, a_z0, blocks, steps, accepted)."""
    B, dz = zT.shape
    n, na = B * dz, accT.numel()
    f, u0 = _adjoint_state(stage, zT, accT, azT, aaccT, shapes)
    uf, st = _solve_adaptive_while(f, tab, u0, t_hi, t_lo, rtol, atol, max_steps, dt_init)
    sizes = [torch.Size(s).numel() for s in shapes]
    blocks = [g.reshape(s) for g, s in zip(torch.split(uf[2 * n + 2 * na :], sizes), shapes)]
    z0 = uf[:n].reshape(B, dz)
    acc0 = uf[n : n + na].reshape(accT.shape)
    az0 = uf[n + na : 2 * n + na].reshape(B, dz)
    return z0, acc0, az0, blocks, st.steps, st.accepted


def _adjoint_result(z0, acc0, az0, blocks, steps, accepted, N, ys):
    """(z0, acc0, a_z0, g_ws, g_bs, steps, accepted), then a_ys0 for a
    conditional backsolve."""
    ays = [] if ys is None else [blocks.pop(0)]
    return (z0, acc0, az0, blocks[:N], blocks[N : 2 * N], steps, accepted, *ays)


def adjoint_train_plain(
    tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, eps, zT, accT, azT, aaccT,
    t_hi, t_lo, dt_init, ys=None, jvp=False, bf16=False,
):
    """Plain PyTorch version of K2 and its chain form (and, `bf16`, of bf16
    K2: the stage VJP under bf16 stage matmuls): the eager adaptive
    backsolve of (z, acc, a_z, a_acc, [a_ys,] g_p) from t_hi to t_lo, one
    error norm over the whole augmented state (a_acc constant), on the
    hand-derived stage VJP, with probes eps (K, B, dz), VJP or (`jvp`) JVP.
    With the conditioning ys (B, n_cond) the
    per-sample a_ys (from 0 at t_hi) is integrated too and returned last.
    `dt_init` None picks the first step by Hairer's rule.  Returns
    (z0, acc0, a_z0, g_ws, g_bs, steps, accepted[, a_ys0])."""
    out = _adjoint_plain(
        _train_adjoint_stage(spec, ws, bs, eps, norm_z, norm_j, aaccT, ys, jvp, bf16), _block_shapes(ws, bs, ys),
        tab, rtol=rtol, atol=atol, max_steps=max_steps, zT=zT, accT=accT, azT=azT, aaccT=aaccT,
        t_hi=t_hi, t_lo=t_lo, dt_init=dt_init,
    )
    return _adjoint_result(*out, len(ws), ys)


def adjoint_test_plain(tab, spec, *, rtol, atol, max_steps, ws, bs, zT, accT, azT, aaccT, t_hi, t_lo, dt_init,
                       ys=None):
    """Plain PyTorch version of K5: the eager adaptive backsolve of
    (z, dlogp, a_z, a_dlogp, [a_ys,] g_p) from t_hi to t_lo on the
    hand-derived TEST stage VJP of a 2-layer tanh chain, one error norm over
    the whole augmented state (a_dlogp constant; g_p with ct_m folded in, as
    the JAX package's kernel integrates it).  zT, azT are (B, dz), accT,
    aaccT (1, B); with the conditioning ys (B, n_cond) the per-sample a_ys
    (from 0 at t_hi) is integrated too and returned last.  `dt_init` None
    picks the first step by Hairer's rule.  Returns
    (z0, acc0, a_z0, g_ws, g_bs, steps, accepted[, a_ys0])."""
    if not _two_layer_tanh(spec):
        raise ValueError(_NO_TEST_CHAIN_ADJOINT)
    out = _adjoint_plain(
        _test_adjoint_stage(spec, ws, bs, aaccT, ys), _block_shapes(ws, bs, ys), tab, rtol=rtol, atol=atol,
        max_steps=max_steps, zT=zT, accT=accT, azT=azT, aaccT=aaccT, t_hi=t_hi, t_lo=t_lo, dt_init=dt_init,
    )
    return _adjoint_result(*out, 2, ys)


_NO_TEST_CHAIN_ADJOINT = (
    "the TEST adjoint (K5) covers 2-layer tanh chains; other chains have none, as in the JAX package "
    "(K7 is forward-only: their gradient runs the plain BACKSOLVE)"
)

_NO_EXACT_CHAIN_ADJOINT = (
    "the exact adjoint covers 2-layer tanh chains; deeper chains have none, as in the JAX package "
    "(K7 is forward-only: their gradient runs the plain BACKSOLVE)"
)


def _pad_rows(g, rows):
    """g with zero rows appended up to `rows` rows."""
    return g if g.shape[0] == rows else torch.cat([g, g.new_zeros(rows - g.shape[0], *g.shape[1:])])


def adjoint_train_exact_plain(
    tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, zT, accT, azT, aaccT,
    t_hi, t_lo, dt_init, ys=None,
):
    """Plain PyTorch version of the K4 adjoint: the eager adaptive backsolve
    of (z, acc, a_z, a_acc, [a_ys,] g_p, g_pm) from t_hi to t_lo on the
    hand-derived exact stage VJP of a 2-layer tanh chain, one error norm
    over the whole augmented state, g_pm included.  g_pm is chained back
    into g_w1 (its z rows) and g_w2 after the solve.  Returns
    (z0, acc0, a_z0, g_ws, g_bs, steps, accepted[, a_ys0])."""
    if not _two_layer_tanh(spec):
        raise ValueError(_NO_EXACT_CHAIN_ADJOINT)
    pm = _exact_pm(spec, ws)
    z0, acc0, az0, g, steps, accepted = _adjoint_plain(
        _exact_adjoint_stage(spec, ws, bs, pm, norm_z, norm_j, aaccT, ys), _block_shapes(ws, bs, ys, [pm.shape]),
        tab, rtol=rtol, atol=atol, max_steps=max_steps, zT=zT, accT=accT, azT=azT, aaccT=aaccT,
        t_hi=t_hi, t_lo=t_lo, dt_init=dt_init,
    )
    g_w1, g_w2 = exact_pm_chain(g.pop(), ws[0][: spec.dz], ws[1])
    g[-4] = g[-4] + _pad_rows(g_w1, ws[0].shape[0])
    g[-3] = g[-3] + g_w2
    return _adjoint_result(z0, acc0, az0, g, steps, accepted, 2, ys)


# ---- the CUDA kernels ----

#: The kernels take every explicit tableau with an embedded error estimate
#: of up to MAX_STAGES stages (csrc/solve_common.cuh: bosh3, dopri5, tsit5,
#: verner65, dop853).
MAX_STAGES = 13


def _wide_chain(spec: ChainSpec) -> bool:
    """Whether a chain is past the narrow chain kernels' widths, or past
    their shared memory (`_narrow_smem_bytes`: a deep chain such as
    6 -> 64 x 7 -> 6), so that the chain kernels' wide forms run it."""
    if spec.dz > MAX_DZ or max(spec.out_dims[:-1], default=0) > CHAIN_MAX_WIDTH:
        return True
    return _narrow_smem_bytes(spec) > WIDE_SMEM_BYTES


def _narrow_smem_bytes(spec: ChainSpec) -> int:
    """Shared-memory bytes of the narrow K2 chain form, the narrow form that
    keeps the most, at its smallest block of 32 threads
    (csrc/chain_common.cuh::make_chain_layout, csrc/k2_chain_adjoint.cu):
    the weights (layer 0's z rows at the padded state width DZ, its bias and
    its ys rows; each middle layer and its transpose at pitches rounded up to
    8; the last layer's rows at DZ, a 1-layer net's dz + n_cond rows so), the
    reduction slots, and 32 slots of 4 DZ + 5 hsum + n_cond floats (odd),
    hsum the hidden widths' sum (a 1-layer net's DZ-float scratch vector).
    The K1 chain form and K7 keep less a thread."""
    def up(x, m):
        return -(-x // m) * m

    DZ = next(p for p in (4, 8, 16, 32) if spec.dz <= p)
    n, nc = spec.n_layers, spec.n_cond
    widths = (spec.in_dims[0],) + tuple(spec.out_dims)
    f = 0
    for i in range(n):
        a, b = widths[i], widths[i + 1]
        if i == 0 and n > 1:
            f += up(b * DZ, 4) + up(b, 4) + up(b * nc, 4)
        elif i == n - 1:
            f += a * DZ + DZ
        else:
            f += a * up(b, 8) + b * up(a, 8) + up(b, 8)
    hsum = DZ if n == 1 else sum(spec.out_dims[:-1])
    slot = (4 * DZ + 5 * hsum + nc) | 1
    return 4 * (f + 100 + 32 * slot)


def _wide_smem_floats(spec: ChainSpec, probes: bool = False) -> int:
    """Shared-memory floats of the wide K2 chain form, the widest of the wide
    forms, at its smallest tile of 4 samples (csrc/k2_wide_adjoint.cu): the
    weights at odd pitches (a conditional chain's first layer with its
    n_cond ys rows), the reduction slots and 4 rows of 9 dz-vectors and 4
    hidden blocks (each row padded to a multiple of 4) and 7 floats, and in
    its COND instance (K8) a row's n_cond ys values and n_cond ys
    cotangents; its probe instance (`probes`, K6) one more dz-vector and
    hidden block a row, its probe COND instance (K6 x K8) both: the probe
    instance's rows with the n_cond ys values and k_ays.  The wide K1 chain
    form's instances keep less (its probe COND instance 5 dz-vectors, 2
    hidden blocks and 3 + n_cond floats a row)."""
    def pad4(x):
        return -(-x // 4) * 4

    weights = sum(a * (b | 1) + b for a, b in zip(spec.in_dims, spec.out_dims))
    hsum = sum(pad4(h) for h in spec.out_dims[:-1])
    vectors, blocks = (10, 5) if probes else (9, 4)
    return pad4(weights) + 100 + 4 * (vectors * pad4(spec.dz) + blocks * hsum + 7 + 2 * spec.n_cond)


def _kernel_covers(
    tab: ButcherTableau, spec: ChainSpec, k_probes: int = 1, chain: bool = False, jvp: bool = False,
    stream: bool = True,
) -> Optional[str]:
    """Why the 2-layer kernels (K3, K1, K2, K4, K5; `chain` False) or the
    chain kernels (the K1 and K2 chain forms, K7, narrow, wide or streamed;
    `chain` True) do not run this configuration (None if they do).  Both take
    every embedded explicit tableau (K9).  The 2-layer kernels take
    unconditional 2-layer tanh chains with state widths up to MAX_DZ (K5
    conditional ones too: its caller asks without the conditioning); the
    chain kernels take Dense chains of 1 to CHAIN_MAX_LAYERS tanh or identity
    layers (K9): their narrow forms with hidden widths up to CHAIN_MAX_WIDTH
    and state widths up to MAX_DZ, conditional ones (K8) included, 1-layer
    nets only there, whose weights and slots fit in shared memory
    (`_narrow_smem_bytes`), their wide forms the chains of 2 layers or more
    beyond, up to WIDE_MAX_DZ and WIDE_MAX_WIDTH, whose
    weights fit in a block's shared memory beside a tile (conditional ones
    in the COND instances of the wide K1 and K2 chain forms, with K VJP or
    JVP probes in their probe COND instances, and of wide K7's TEST and
    exact entries), and their streamed forms
    (`stream`; False asks for the
    wide forms alone) the chains the wide forms refuse for
    their state width, hidden widths or weights' shared memory (with K
    probes or JVP, the shared memory of the wide probe instances), up to
    state width STREAM_MAX_DZ and STREAM_MAX_PARAMS parameters, conditional
    ones in the COND instances of the streamed K1 and K2 chain forms (with K
    VJP or JVP probes in their probe COND instances) and of streamed K7's
    TEST and exact entries.  The Hutchinson kernels (K1, K2, their chain forms
    and the chain forms' wide and streamed forms) take any number `k_probes`
    of VJP or (`jvp`) JVP probes (K6), in conditional chains too (K6 x K8:
    the wide probe COND instances where their shared memory holds the
    chain, else the streamed ones)."""
    if tab.btilde is None:
        return f"the {tab.name} tableau (no embedded error estimate: fixed-step solves stay outside the kernels)"
    if tab.num_stages > MAX_STAGES:
        return f"the {tab.name} tableau ({tab.num_stages} > {MAX_STAGES} stages)"
    if not chain and not all(spec.acts):
        return ("identity-activation layers in K3, K1, K2, K4 and K5 (the chain kernels take them; a TEST "
                "gradient of such a net runs the plain backward)")
    if spec.n_cond and not chain:
        return "conditional nets (K8 in the 2-layer kernels, ROADMAP queue 2)"
    if not chain:
        if spec.dz > MAX_DZ:
            return (f"state width {spec.dz} > {MAX_DZ} in K3, K1, K2, K4 and K5 (they keep one sample's state in "
                    "registers; unconditional 2-layer nets of a wider state run their wide forms, ROADMAP queue 2, "
                    "shape variants (a))")
        if spec.n_layers != 2:
            return (f"{spec.n_layers}-layer chains (K3, K1, K2 and K4 take 2 layers; the chain kernels take the "
                    "other depths)")
        return None
    if spec.n_layers > CHAIN_MAX_LAYERS:
        return (f"{spec.n_layers}-layer chains (the chain kernels take at most {CHAIN_MAX_LAYERS} layers; "
                "deeper chains: ROADMAP queue 2, shape variants (b2))")
    if spec.n_layers == 1 and _wide_chain(spec):
        past = f"state width {spec.dz} > {MAX_DZ}" if spec.dz > MAX_DZ else "shared memory"
        return (f"1-layer nets of {past} (the narrow chain kernels take 1-layer nets up to state width {MAX_DZ} "
                "whose weights and slots fit, the wide and streamed forms none; ROADMAP queue 2, shape variants "
                "(c2))")
    if not _wide_chain(spec):
        return None
    if spec.dz > STREAM_MAX_DZ:
        return (f"state width {spec.dz} > {STREAM_MAX_DZ} (the streamed forms take up to {STREAM_MAX_DZ}, the wide "
                f"forms {WIDE_MAX_DZ}; ROADMAP queue 2, shape variants (e))")
    probes = k_probes != 1 or jvp
    if spec.dz > WIDE_MAX_DZ:
        why = (f"state width {spec.dz} > {WIDE_MAX_DZ} (the wide forms take up to {WIDE_MAX_DZ}, the streamed forms "
               f"{STREAM_MAX_DZ}; ROADMAP queue 2, shape variants (e))")
    else:
        why = _wide_limit(spec, probes)
        if why is None:
            return None
    if not stream:
        return why
    P = _param_count(spec)
    if P > STREAM_MAX_PARAMS:
        return (f"{P} parameters (the streamed forms' offsets are 32-bit ints, up to {STREAM_MAX_PARAMS}; ROADMAP "
                "queue 2, shape variants (e))")
    return None


def _param_count(spec: ChainSpec) -> int:
    return sum(a * b + b for a, b in zip(spec.in_dims, spec.out_dims))


def _wide_limit(spec: ChainSpec, probes: bool = False) -> Optional[str]:
    """Why the wide forms do not keep a chain of state width up to
    WIDE_MAX_DZ (None if they do): a hidden width past WIDE_MAX_WIDTH, or
    weights that with the wide K2 chain form's smallest tile (its probe
    instance's with `probes`, its COND instance's for a conditional chain)
    pass a block's shared memory."""
    wide = max(spec.out_dims[:-1])
    if wide > WIDE_MAX_WIDTH:
        return (f"hidden width {wide} > {WIDE_MAX_WIDTH} (the wide forms take up to {WIDE_MAX_WIDTH}; ROADMAP queue "
                "2, shape variants (e))")
    need = 4 * _wide_smem_floats(spec, probes)
    if need > WIDE_SMEM_BYTES:
        return (f"weights too large for the wide chain forms' shared memory ({need} bytes with a 4-sample tile, "
                f"over {WIDE_SMEM_BYTES}; chains of larger weights: ROADMAP queue 2, shape variants (e))")
    return None


def _stream_chain(spec: ChainSpec, probes: bool = False) -> bool:
    """Whether the chain kernels' streamed forms run a chain: a chain of 2
    to CHAIN_MAX_LAYERS layers past the narrow forms, of state width up to
    STREAM_MAX_DZ, that the wide forms refuse for its state width past
    WIDE_MAX_DZ, its hidden widths or its weights' shared memory: with one
    probe, conditional chains in the COND instances (K8), or (`probes`: K
    probes or JVP, K6) in their probe instances, which keep one more
    dz-vector and hidden block a row, conditional chains in their probe
    COND instances (K6 x K8).  2-layer tanh nets past MAX_DZ count too: the
    streamed forms run their Hutchinson and exact-forward stages, and
    streamed K3 and K5 their TEST stages."""
    if not 2 <= spec.n_layers <= CHAIN_MAX_LAYERS or spec.dz > STREAM_MAX_DZ:
        return False
    return _wide_chain(spec) and (spec.dz > WIDE_MAX_DZ or _wide_limit(spec, probes) is not None)


def _wide_two_layer(spec: ChainSpec) -> bool:
    """Whether a 2-layer tanh chain is past the 2-layer kernels' state width,
    so that their wide forms (wide K3, wide K5, the wide K4 adjoint) and the
    wide K1 and K2 chain forms and wide K7 exact run it."""
    return _two_layer_tanh(spec) and spec.dz > MAX_DZ


def _wide_two_layer_covers(tab: ButcherTableau, spec: ChainSpec) -> Optional[str]:
    """Why the wide 2-layer kernels (wide K3, wide K5, the wide K4 adjoint)
    do not run this configuration (None if they do): they take the 2-layer
    tanh chains the wide chain forms take, state widths up to WIDE_MAX_DZ and
    hidden widths up to WIDE_MAX_WIDTH, under every embedded tableau,
    conditional ones in their COND instances (K8).  Past those the streamed
    chain forms run the Hutchinson and exact-forward stages, streamed K3 and
    K5 the TEST stages (`_stream_two_layer_covers`, conditional nets in
    their COND instances) and the streamed K4 adjoint the exact backward
    member (`_stream_exact_covers`), conditional nets in the COND instances
    of each."""
    if not _two_layer_tanh(spec):
        return ("nets other than 2-layer tanh chains in wide K3, wide K5 and the wide K4 adjoint (the JAX "
                "package's 2-layer TEST and exact stages assume tanh layers, reference fault 2: the chain kernels "
                "take identity layers forward, and their gradient runs the plain backward)")
    return _kernel_covers(tab, spec, chain=True, stream=False)


def _stream_two_layer(spec: ChainSpec) -> bool:
    """Whether streamed K3 and K5 run a net's TEST stages and the streamed
    K4 adjoint its exact backward member: a 2-layer tanh chain past MAX_DZ
    that the streamed chain forms run (state widths to STREAM_MAX_DZ past
    the wide 2-layer kernels' limits: the README net family at the
    MINIBOONE and BSDS300 widths, 86 -> 258 -> 86 and 126 -> 378 -> 126);
    a conditional one in the COND instances of streamed K3, streamed K5 and
    the streamed K4 adjoint."""
    return _wide_two_layer(spec) and _stream_chain(spec)


def _stream_two_layer_covers(tab: ButcherTableau, spec: ChainSpec) -> Optional[str]:
    """Why streamed K3 and K5 (and the streamed K4 adjoint,
    `_stream_exact_covers`) do not run this configuration (None if they do):
    they take the 2-layer tanh nets of `_stream_two_layer` under every
    embedded tableau, conditional ones in their COND instances (K8)."""
    if not _two_layer_tanh(spec):
        return ("nets other than 2-layer tanh chains in streamed K3, K5 and the streamed K4 adjoint (the JAX "
                "package's 2-layer TEST and exact stages assume tanh layers, reference fault 2: streamed K7 takes "
                "identity layers forward, and their gradient runs the plain backward)")
    why = _kernel_covers(tab, spec, chain=True)
    if why is None and not _stream_two_layer(spec):
        why = (f"state width {spec.dz} with hidden width {spec.out_dims[0]} in streamed K3, K5 and the streamed K4 "
               "adjoint (K3, K5 and the K4 adjoint or their wide forms take the net)")
    return why


def _no_grad_inputs(kernel: str, *tensors) -> None:
    if needs_grad(tensors):
        raise NotImplementedError(
            f"{kernel} is not differentiable: gradients go through the BACKSOLVE "
            "adjoint (ode/adjoint.py)"
        )


def _tableau_array(tab: ButcherTableau) -> ctypes.Array:
    """`tab` as the kernels read it (csrc/solve_common.cuh::read_tableau):
    a (MAX_STAGES x MAX_STAGES, row-major) | b | btilde | btilde3 (zeros
    without one), each padded with zeros to MAX_STAGES, then S, fsal and
    whether btilde3 is set."""
    m = MAX_STAGES
    a = [[0.0] * m for _ in range(m)]
    for i, row in enumerate(tab.a):
        a[i][: len(row)] = row

    def pad(v):
        return list(v or ()) + [0.0] * (m - len(v or ()))

    flat = [x for row in a for x in row] + pad(tab.b) + pad(tab.btilde) + pad(tab.btilde3)
    flat += [float(tab.num_stages), float(tab.fsal), float(tab.btilde3 is not None)]
    return (ctypes.c_float * len(flat))(*flat)


def _gvecs(tab: ButcherTableau) -> int:
    """The gradient vectors per block the adjoint kernels keep per parity:
    the b- and btilde-weighted sums, and the btilde3-weighted one of dop853."""
    return 3 if tab.btilde3 is not None else 2


def _acts_mask(spec: ChainSpec) -> int:
    """The chain kernels' activation mask: bit i set where layer i is tanh."""
    return sum(1 << i for i, on in enumerate(spec.acts) if on)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
_CHAIN_GRID = ([_I, _IP, _I, _IP], _I)
_CHAIN_SMEM = ([_I, _IP, _I], ctypes.c_longlong)
_TAIL = [_F] * 5 + [_P, _I, _I, _P]
_WIDE_TAIL = [_F] * 5 + [_P, _I, _I, _I, _P]  # the tableau, the tile, grid, block, stream
_WIDE_SHAPE = ([_I, _IP, _I, _IP], _I)
_K4W_TAIL = [_F] * 5 + [_P] + [_I] * 4 + [_P]  # the tableau, T, R, grid, block, stream
_SIGNATURES = {
    K3_KERNEL: {
        "cnf_k3_max_grid": ([_I, _I, _I, ctypes.POINTER(_I)], _I),
        "cnf_k3_test_solve": ([_P] * 13 + [_I] * 4 + _TAIL, _I),
    },
    K1_KERNEL: {
        "cnf_k1_max_grid": ([_I, _I, _I, ctypes.POINTER(_I)], _I),
        "cnf_k1_train_solve": ([_P] * 14 + [_I] * 6 + _TAIL, _I),
        "cnf_k1p_max_grid": ([_I, _I, _I, ctypes.POINTER(_I)], _I),
        "cnf_k1_probe_solve": ([_P] * 14 + [_I] * 8 + _TAIL, _I),
    },
    K2_KERNEL: {
        "cnf_k2_max_grid": ([_I, _I, _I, ctypes.POINTER(_I)], _I),
        "cnf_k2_train_adjoint": ([_P] * 21 + [_I] * 6 + _TAIL, _I),
        "cnf_k2p_max_grid": ([_I, _I, _I, ctypes.POINTER(_I)], _I),
        "cnf_k2_probe_adjoint": ([_P] * 21 + [_I] * 8 + _TAIL, _I),
    },
    K4_KERNEL: {
        "cnf_k4_max_grid": ([_I, _I, _I, ctypes.POINTER(_I)], _I),
        "cnf_k4_exact_solve": ([_P] * 13 + [_I] * 6 + _TAIL, _I),
    },
    K4A_KERNEL: {
        "cnf_k4a_max_grid": ([_I, _I, _I, ctypes.POINTER(_I)], _I),
        "cnf_k4a_smem_bytes": ([_I, _I, _I], ctypes.c_longlong),
        "cnf_k4_exact_adjoint": ([_P] * 23 + [_I] * 6 + _TAIL, _I),
    },
    K5_KERNEL: {
        "cnf_k5_max_grid": ([_I, _I, _I, _I, ctypes.POINTER(_I)], _I),
        "cnf_k5_smem_bytes": ([_I, _I, _I, _I], ctypes.c_longlong),
        "cnf_k5_test_adjoint": ([_P] * 22 + [_I] * 5 + _TAIL, _I),
    },
    K1C_KERNEL: {
        "cnf_k1c_max_grid": _CHAIN_GRID,
        "cnf_k1c_smem_bytes": _CHAIN_SMEM,
        "cnf_k1c_train_solve": ([_P] * 12 + [_I, _I, _IP, _I, _I, _I, _I] + _TAIL, _I),
        "cnf_k1cp_max_grid": _CHAIN_GRID,
        "cnf_k1c_probe_solve": ([_P] * 12 + [_I, _I, _IP, _I, _I, _I, _I, _I, _I] + _TAIL, _I),
    },
    K7_KERNEL: {
        "cnf_k7_test_max_grid": _CHAIN_GRID,
        "cnf_k7_exact_max_grid": _CHAIN_GRID,
        "cnf_k7_smem_bytes": _CHAIN_SMEM,
        "cnf_k7_test_solve": ([_P] * 11 + [_I, _I, _IP, _I, _I] + _TAIL, _I),
        "cnf_k7_exact_solve": ([_P] * 11 + [_I, _I, _IP, _I, _I, _I, _I] + _TAIL, _I),
    },
    K2C_KERNEL: {
        "cnf_k2c_max_grid": _CHAIN_GRID,
        "cnf_k2c_smem_bytes": _CHAIN_SMEM,
        "cnf_k2c_train_adjoint": ([_P] * 18 + [_I, _I, _IP, _I, _I, _I, _I] + _TAIL, _I),
        "cnf_k2cp_max_grid": _CHAIN_GRID,
        "cnf_k2c_probe_adjoint": ([_P] * 18 + [_I, _I, _IP, _I, _I, _I, _I, _I, _I] + _TAIL, _I),
    },
    K1W_KERNEL: {
        "cnf_k1w_shape": _WIDE_SHAPE,
        "cnf_k1w_train_solve": ([_P] * 11 + [_I, _I, _IP, _I, _I, _I, _I] + _WIDE_TAIL, _I),
        "cnf_k1wp_shape": _WIDE_SHAPE,
        "cnf_k1w_probe_solve": ([_P] * 11 + [_I, _I, _IP, _I, _I, _I, _I, _I, _I] + _WIDE_TAIL, _I),
        "cnf_k1wc_shape": _WIDE_SHAPE,
        "cnf_k1w_cond_solve": ([_P] * 12 + [_I, _I, _IP, _I, _I, _I, _I] + _WIDE_TAIL, _I),
        "cnf_k1wpc_shape": _WIDE_SHAPE,
        "cnf_k1w_probe_cond_solve": ([_P] * 12 + [_I, _I, _IP, _I, _I, _I, _I, _I, _I] + _WIDE_TAIL, _I),
    },
    K7W_KERNEL: {
        "cnf_k7w_test_shape": _WIDE_SHAPE,
        "cnf_k7w_exact_shape": _WIDE_SHAPE,
        "cnf_k7w_test_solve": ([_P] * 10 + [_I, _I, _IP, _I, _I] + _WIDE_TAIL, _I),
        "cnf_k7w_exact_solve": ([_P] * 10 + [_I, _I, _IP, _I, _I, _I, _I] + _WIDE_TAIL, _I),
        "cnf_k7wc_test_shape": _WIDE_SHAPE,
        "cnf_k7wc_exact_shape": _WIDE_SHAPE,
        "cnf_k7w_cond_test_solve": ([_P] * 11 + [_I, _I, _IP, _I, _I] + _WIDE_TAIL, _I),
        "cnf_k7w_cond_exact_solve": ([_P] * 11 + [_I, _I, _IP, _I, _I, _I, _I] + _WIDE_TAIL, _I),
    },
    K3W_KERNEL: {
        "cnf_k3w_shape": _WIDE_SHAPE,
        "cnf_k3w_test_solve": ([_P] * 10 + [_I, _I, _IP, _I, _I] + _WIDE_TAIL, _I),
        "cnf_k3wc_shape": _WIDE_SHAPE,
        "cnf_k3w_cond_solve": ([_P] * 11 + [_I, _I, _IP, _I, _I] + _WIDE_TAIL, _I),
    },
    K5W_KERNEL: {
        "cnf_k5w_shape": _WIDE_SHAPE,
        "cnf_k5w_test_adjoint": ([_P] * 15 + [_I, _I, _IP, _I, _I] + _WIDE_TAIL, _I),
        "cnf_k5wc_shape": _WIDE_SHAPE,
        "cnf_k5w_cond_adjoint": ([_P] * 17 + [_I, _I, _IP, _I, _I] + _WIDE_TAIL, _I),
    },
    K4WA_KERNEL: {
        "cnf_k4w_shape": _WIDE_SHAPE,
        "cnf_k4w_exact_adjoint": ([_P] * 16 + [_I, _I, _IP, _I, _I, _I, _I] + _K4W_TAIL, _I),
        "cnf_k4wc_shape": _WIDE_SHAPE,
        "cnf_k4w_cond_exact_adjoint": ([_P] * 18 + [_I, _I, _IP, _I, _I, _I, _I] + _K4W_TAIL, _I),
    },
    K1S_KERNEL: {
        "cnf_k1s_shape": _WIDE_SHAPE,
        "cnf_k1s_train_solve": ([_P] * 12 + [_I, _I, _IP, _I, _I, _I, _I] + _WIDE_TAIL, _I),
        "cnf_k1sp_shape": _WIDE_SHAPE,
        "cnf_k1s_probe_solve": ([_P] * 12 + [_I, _I, _IP, _I, _I, _I, _I, _I, _I] + _WIDE_TAIL, _I),
        "cnf_k1sc_shape": _WIDE_SHAPE,
        "cnf_k1s_cond_solve": ([_P] * 13 + [_I, _I, _IP, _I, _I, _I, _I] + _WIDE_TAIL, _I),
        "cnf_k1spc_shape": _WIDE_SHAPE,
        "cnf_k1s_probe_cond_solve": ([_P] * 13 + [_I, _I, _IP, _I, _I, _I, _I, _I, _I] + _WIDE_TAIL, _I),
    },
    K7S_KERNEL: {
        "cnf_k7s_test_shape": _WIDE_SHAPE,
        "cnf_k7s_exact_shape": _WIDE_SHAPE,
        "cnf_k7s_test_solve": ([_P] * 11 + [_I, _I, _IP, _I, _I] + _WIDE_TAIL, _I),
        "cnf_k7s_exact_solve": ([_P] * 11 + [_I, _I, _IP, _I, _I, _I, _I] + _WIDE_TAIL, _I),
        "cnf_k7sc_test_shape": _WIDE_SHAPE,
        "cnf_k7sc_exact_shape": _WIDE_SHAPE,
        "cnf_k7s_cond_test_solve": ([_P] * 12 + [_I, _I, _IP, _I, _I] + _WIDE_TAIL, _I),
        "cnf_k7s_cond_exact_solve": ([_P] * 12 + [_I, _I, _IP, _I, _I, _I, _I] + _WIDE_TAIL, _I),
    },
    K2S_KERNEL: {
        "cnf_k2s_shape": _WIDE_SHAPE,
        "cnf_k2s_train_adjoint": ([_P] * 17 + [_I, _I, _IP, _I, _I, _I, _I] + _WIDE_TAIL, _I),
        "cnf_k2sp_shape": _WIDE_SHAPE,
        "cnf_k2s_probe_adjoint": ([_P] * 17 + [_I, _I, _IP, _I, _I, _I, _I, _I, _I] + _WIDE_TAIL, _I),
        "cnf_k2sc_shape": _WIDE_SHAPE,
        "cnf_k2s_cond_adjoint": ([_P] * 19 + [_I, _I, _IP, _I, _I, _I, _I] + _WIDE_TAIL, _I),
        "cnf_k2spc_shape": _WIDE_SHAPE,
        "cnf_k2s_probe_cond_adjoint": ([_P] * 19 + [_I, _I, _IP, _I, _I, _I, _I, _I, _I] + _WIDE_TAIL, _I),
    },
    K3S_KERNEL: {
        "cnf_k3s_shape": _WIDE_SHAPE,
        "cnf_k3s_test_solve": ([_P] * 12 + [_I, _I, _IP, _I, _I] + _WIDE_TAIL, _I),
        "cnf_k3sc_shape": _WIDE_SHAPE,
        "cnf_k3s_cond_solve": ([_P] * 13 + [_I, _I, _IP, _I, _I] + _WIDE_TAIL, _I),
    },
    K5S_KERNEL: {
        "cnf_k5s_shape": _WIDE_SHAPE,
        "cnf_k5s_test_adjoint": ([_P] * 17 + [_I, _I, _IP, _I, _I] + _WIDE_TAIL, _I),
        "cnf_k5sc_shape": _WIDE_SHAPE,
        "cnf_k5s_cond_adjoint": ([_P] * 19 + [_I, _I, _IP, _I, _I] + _WIDE_TAIL, _I),
    },
    K4SA_KERNEL: {
        "cnf_k4s_shape": _WIDE_SHAPE,
        "cnf_k4s_exact_adjoint": ([_P] * 18 + [_I, _I, _IP, _I, _I, _I, _I] + _WIDE_TAIL, _I),
        "cnf_k4sc_shape": _WIDE_SHAPE,
        "cnf_k4s_cond_exact_adjoint": ([_P] * 20 + [_I, _I, _IP, _I, _I, _I, _I] + _WIDE_TAIL, _I),
    },
    K3B_KERNEL: {
        "cnf_k3b_max_grid": ([_I, _I, _I, ctypes.POINTER(_I)], _I),
        "cnf_k3b_smem_bytes": ([_I, _I, _I], ctypes.c_longlong),
        "cnf_k3b_test_solve": ([_P] * 13 + [_I] * 4 + _TAIL, _I),
    },
    K1B_KERNEL: {
        "cnf_k1b_max_grid": ([_I, _I, _I, ctypes.POINTER(_I)], _I),
        "cnf_k1b_smem_bytes": ([_I, _I, _I], ctypes.c_longlong),
        "cnf_k1b_train_solve": ([_P] * 14 + [_I] * 6 + _TAIL, _I),
    },
    K2B_KERNEL: {
        "cnf_k2b_max_grid": ([_I, _I, _I, ctypes.POINTER(_I)], _I),
        "cnf_k2b_smem_bytes": ([_I, _I, _I], ctypes.c_longlong),
        "cnf_k2b_train_adjoint": ([_P] * 19 + [_I] * 6 + _TAIL, _I),
    },
    K2W_KERNEL: {
        "cnf_k2w_shape": _WIDE_SHAPE,
        "cnf_k2w_train_adjoint": ([_P] * 16 + [_I, _I, _IP, _I, _I, _I, _I] + _WIDE_TAIL, _I),
        "cnf_k2wp_shape": _WIDE_SHAPE,
        "cnf_k2w_probe_adjoint": ([_P] * 16 + [_I, _I, _IP, _I, _I, _I, _I, _I, _I] + _WIDE_TAIL, _I),
        "cnf_k2wc_shape": _WIDE_SHAPE,
        "cnf_k2w_cond_adjoint": ([_P] * 18 + [_I, _I, _IP, _I, _I, _I, _I] + _WIDE_TAIL, _I),
        "cnf_k2wpc_shape": _WIDE_SHAPE,
        "cnf_k2w_probe_cond_adjoint": ([_P] * 18 + [_I, _I, _IP, _I, _I, _I, _I, _I, _I] + _WIDE_TAIL, _I),
    },
}


def _depth_build(name: str, spec: ChainSpec) -> str:
    """The library of a chain kernel's source that takes `spec`'s depth:
    each such source is built twice (csrc/chain_common.cuh), as it stands
    for chains of 2 to 4 layers and as `<name>@depths` for 1 to
    CHAIN_MAX_LAYERS, so that the 2-4-layer instances keep their machine
    code."""
    return name if 2 <= spec.n_layers <= 4 else name + "@depths"


def _library(name: str, spec: Optional[ChainSpec] = None) -> ctypes.CDLL:
    """Kernel `name`'s library, typed; given a chain `spec`, the build of
    its source that takes its depth (`_depth_build`)."""
    from ._build import load_library

    lib = load_library(name if spec is None else _depth_build(name, spec))
    if not getattr(lib, "_cnf_typed", False):
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        lib._cnf_typed = True
    return lib


def _launch_shape(max_grid, label: str, B: int, blocks) -> Tuple[int, int]:
    """(threads per block, blocks) for a cooperative launch: the first block
    size in `blocks` that the kernel can launch with (`max_grid(block,
    byref(cap))` sets the co-resident grid), and at most as many blocks as
    are co-resident."""
    cap = ctypes.c_int(0)
    for block in blocks:
        err = max_grid(block, ctypes.byref(cap))
        if err == 0 and cap.value >= 1:
            return block, min(-(-B // block), cap.value)
    raise RuntimeError(
        f"{label} cannot be launched cooperatively (blocks {tuple(blocks)}): "
        f"cudaError {err}, co-resident grid {cap.value}"
    )


def _forward_blocks(B: int, device) -> Tuple[int, ...]:
    """128 threads per block, 256 once that would need more than two blocks
    per SM: at B = 4096 on the H100, 128 beat 32, 64 and 256 for K3 because
    fewer blocks make the per-step grid barrier and partial sum cheaper
    (PERF.md)."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return (256,) if -(-B // 128) > 2 * n_sm else (128,)


def _check_inputs(label, device, tensors, shapes):
    if any(x.dtype != torch.float32 or x.device != device for x in tensors):
        raise ValueError(f"{label} takes float32 tensors on one device")
    for x, shape in zip(tensors, shapes):
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{label}: got a tensor of shape {tuple(x.shape)}, expected {tuple(shape)}")
    return [x.contiguous() for x in tensors]


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _controller_floats(tab):
    return 7.0 / (10.0 * tab.order), 2.0 / (5.0 * tab.order), 1.0 / tab.order


def _cuda_only(label: str, x: torch.Tensor, tab, spec, k_probes: int = 1, chain: bool = False,
               wide: bool = False, jvp: bool = False, stream: bool = False, cond: bool = False) -> None:
    """Raise unless `label`'s kernel takes the configuration on CUDA tensors:
    a chain kernel's narrow form (`wide` and `stream` False) takes no wide
    chain, its wide form (`wide`) the chains past the narrow widths that it
    keeps in shared memory, and its streamed form (`stream`) the chains the
    wide forms refuse for their widths or shared memory (`_stream_chain`;
    with K probes or JVP, those of the wide probe instances); the wide and
    streamed forms take conditional chains in their COND instances (`cond`;
    with K probes or JVP, their probe COND instances) and unconditional ones
    in the others."""
    if x.device.type != "cuda":
        raise ValueError(f"{label} runs on CUDA or CPU tensors, got {x.device}")
    probes = k_probes != 1 or jvp
    why = _kernel_covers(tab, spec, k_probes, chain, jvp)
    if why is None and chain and not wide and not stream and _wide_chain(spec):
        why = (f"state width {spec.dz} with hidden widths {spec.out_dims[:-1]} in the narrow chain kernels (up to "
               f"{MAX_DZ} and {CHAIN_MAX_WIDTH}: their wide forms take the chain)")
    if why is None and (wide or stream) and spec.n_cond and not cond:
        why = f"conditional chains in the unconditional instance of {label} (its COND instance takes them)"
    if why is None and cond and not spec.n_cond:
        why = f"unconditional chains in the COND instance of {label} (its unconditional instance takes them)"
    if why is None and wide and _stream_chain(spec, probes):
        why = (f"state width {spec.dz} with hidden widths {spec.out_dims[:-1]} in the wide chain forms "
               f"({_kernel_covers(tab, spec, k_probes, chain=True, jvp=jvp, stream=False)}: their streamed forms "
               "take the chain)")
    if why is None and stream and not _stream_chain(spec, probes):
        why = (f"state width {spec.dz} with hidden widths {spec.out_dims[:-1]} in the streamed chain forms (the "
               "narrow or wide forms take the chain)")
    if why is not None:
        raise NotImplementedError(f"the CUDA solve kernels do not cover {why}")


def _check_launch(err: int, label: str, grid: int, block: int) -> None:
    if err != 0:
        raise RuntimeError(f"{label} launch failed with cudaError {err} (grid {grid}, block {block})")


def _forward_buffers(z0, acc0, tab, grid: int):
    """(zT, accT, stats, dt_last, work, partials) of a forward kernel:
    dt_last holds the next step size and the last step taken, work the
    (row, B) planes of the state, the proposal and the S stages."""
    B, dz = z0.shape
    nacc = 1 if acc0.dim() == 1 else acc0.shape[0]
    f32 = dict(dtype=torch.float32, device=z0.device)
    return (
        torch.empty_like(z0), torch.empty_like(acc0), torch.empty(2, dtype=torch.int32, device=z0.device),
        torch.empty(2, **f32), torch.empty((tab.num_stages + 2) * (dz + nacc) * B, **f32),
        torch.empty(6 * grid, **f32),
    )


def _forward_result(zT, accT, stats, dt_last):
    return zT, accT, stats[0], stats[1], dt_last[0], dt_last[1]


def _launch_two_layer_forward(label, lib_name, entry, max_grid, tab, spec, *, rtol, atol, max_steps, ws, bs, z0,
                              acc0, t0, t1, dt_init, eps=None, norms=None, blocks=None):
    """Launch a 2-layer forward kernel (K3: no probe, no norms; K1: the
    probes (K, B, dz) and the norms, and for its probe instance K and jvp;
    the K4 forward: the norms), whose C arguments are (w1, b1, w2, b2,
    [eps], z0, acc0, ts, zT, accT, stats, dt_last, work, partials, B, dz, H,
    max_steps, [norm_z, norm_j, [K, jvp]], rtol, atol, the controller, the
    tableau, grid, block, stream), with the first block size of `blocks`
    that launches (by default `_forward_blocks`).  Returns (zT, accT,
    steps, accepted, dt_last, dt_used)."""
    B, dz = z0.shape
    H = spec.out_dims[0]
    device = z0.device
    probe = [] if eps is None else [eps]
    w1, b1, w2, b2, z0, acc0, *probe = _check_inputs(
        label, device, [ws[0], bs[0], ws[1], bs[1], z0, acc0] + probe,
        [(dz, H), (H,), (H, dz), (dz,), (B, dz), tuple(acc0.shape)] + [(x.shape[0], B, dz) for x in probe],
    )
    lib = _library(lib_name)
    block, grid = _launch_shape(
        lambda blk, cap: getattr(lib, max_grid)(dz, H, blk, cap), label, B, blocks or _forward_blocks(B, device)
    )
    ts = torch.stack([t0, t1, dt_init]).to(device=device, dtype=torch.float32)
    zT, accT, stats, dt_last, work, partials = _forward_buffers(z0, acc0, tab, grid)
    err = getattr(lib, entry)(
        _ptr(w1), _ptr(b1), _ptr(w2), _ptr(b2), *[_ptr(x) for x in probe], _ptr(z0), _ptr(acc0), _ptr(ts),
        _ptr(zT), _ptr(accT), _ptr(stats), _ptr(dt_last), _ptr(work), _ptr(partials),
        B, dz, H, int(max_steps), *[int(x) for x in norms or ()], rtol, atol, *_controller_floats(tab),
        _tableau_array(tab), grid, block, _stream(device),
    )
    _check_launch(err, label, grid, block)
    return _forward_result(zT, accT, stats, dt_last)


def run_solve_kernel(tab, spec, *, rtol, atol, max_steps, ws, bs, z0, dlogp0, t0, t1, dt_init, ys=None):
    """K3: the TEST solve of [z | dlogp] from t0 to t1 (0-d tensors; t1 < t0
    runs backward) starting with step `dt_init`.  z0 is (B, dz) batch-major
    and dlogp0 (B,) seeds the accumulator.  Returns
    (zT, dlogpT, steps, accepted, dt_last, dt_used), all on z0's device:
    dt_last the next step size, dt_used the last step taken.

    CUDA tensors go through the K3 kernel (unconditional 2-layer tanh
    chains), CPU tensors through its plain version (any Dense chain, ys
    (B, n_cond) or None)."""
    _no_grad_inputs("K3", ws, bs, z0, dlogp0, ys)
    if z0.device.type == "cpu":
        return solve_test_plain(
            tab, spec, rtol=rtol, atol=atol, max_steps=max_steps, ws=ws, bs=bs,
            z0=z0, dlogp0=dlogp0, t0=t0, t1=t1, dt_init=dt_init, ys=ys,
        )
    _cuda_only("K3", z0, tab, spec)
    out = _launch_two_layer_forward(
        "K3", K3_KERNEL, "cnf_k3_test_solve", "cnf_k3_max_grid", tab, spec, rtol=rtol, atol=atol,
        max_steps=max_steps, ws=ws, bs=bs, z0=z0, acc0=dlogp0, t0=t0, t1=t1, dt_init=dt_init,
    )
    run_solve_kernel.launches += 1
    return out


run_solve_kernel.launches = 0


def _probe_instance(eps, jvp: bool) -> bool:
    """Whether a Hutchinson kernel runs its probe instance (K6: the probe
    loop, K VJP or JVP probes) rather than its one-VJP-probe instance."""
    return eps.shape[0] != 1 or bool(jvp)


def _count(wrapper, eps, jvp: bool) -> None:
    """One launch of a Hutchinson kernel's wrapper: `.launches`, and
    `.probe_launches[(K, jvp)]` for its probe instance."""
    wrapper.launches += 1
    if _probe_instance(eps, jvp):
        key = (int(eps.shape[0]), bool(jvp))
        wrapper.probe_launches[key] = wrapper.probe_launches.get(key, 0) + 1


def run_train_solve_kernel(
    tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, z0, eps, acc0, t0, t1, dt_init, ys=None,
    jvp=False,
):
    """K1: the TRAIN solve of [z | acc] from t0 to t1 starting with step
    `dt_init`.  z0 is (B, dz), eps (K, B, dz) the probes, VJP or (`jvp`) JVP,
    and acc0 (3, B) = [dlogp | reg_e | reg_n] seeds the accumulators.
    Returns (zT, accT, steps, accepted, dt_last, dt_used), all on z0's
    device.

    CUDA tensors go through the K1 kernel (unconditional 2-layer tanh
    chains: one VJP probe in its first instance, any other probes in its
    probe instance, K6), CPU tensors through its plain version (any Dense
    chain, ys (B, n_cond) or None)."""
    _no_grad_inputs("K1", ws, bs, z0, eps, acc0, ys)
    if z0.device.type == "cpu":
        return solve_train_plain(
            tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol, max_steps=max_steps,
            ws=ws, bs=bs, z0=z0, eps=eps, acc0=acc0, t0=t0, t1=t1, dt_init=dt_init, ys=ys, jvp=jvp,
        )
    _cuda_only("K1", z0, tab, spec, eps.shape[0], jvp=jvp)
    probes = _probe_instance(eps, jvp)
    out = _launch_two_layer_forward(
        "K1", K1_KERNEL, "cnf_k1_probe_solve" if probes else "cnf_k1_train_solve",
        "cnf_k1p_max_grid" if probes else "cnf_k1_max_grid", tab, spec, rtol=rtol, atol=atol,
        max_steps=max_steps, ws=ws, bs=bs, z0=z0, acc0=acc0, t0=t0, t1=t1, dt_init=dt_init, eps=eps,
        norms=(norm_z, norm_j) + ((eps.shape[0], jvp) if probes else ()),
    )
    _count(run_train_solve_kernel, eps, jvp)
    return out


run_train_solve_kernel.launches = 0
run_train_solve_kernel.probe_launches = {}


def _launch_k2(tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, eps, zT, accT, azT, aaccT,
               t_hi, t_lo, dt_init, jvp=False):
    B, dz = zT.shape
    H = spec.out_dims[0]
    device = zT.device
    K = eps.shape[0]
    w1, b1, w2, b2, e0, zT, accT, azT, aaccT = _check_inputs(
        "K2", device, [ws[0], bs[0], ws[1], bs[1], eps, zT, accT, azT, aaccT],
        [(dz, H), (H,), (H, dz), (dz,), (K, B, dz), (B, dz), (3, B), (B, dz), (3, B)],
    )
    lib = _library(K2_KERNEL)
    probes = _probe_instance(eps, jvp)
    max_grid = lib.cnf_k2p_max_grid if probes else lib.cnf_k2_max_grid
    block, grid = _launch_shape(lambda blk, cap: max_grid(dz, H, blk, cap), "K2", B, (128, 64, 32))
    P = 2 * dz * H + H + dz
    ts = torch.stack([t_hi, t_lo, dt_init]).to(device=device, dtype=torch.float32)
    z0, az0, acc0 = torch.empty_like(zT), torch.empty_like(azT), torch.empty_like(accT)
    gw1, gb1, gw2, gb2 = (torch.empty_like(x) for x in (w1, b1, w2, b2))
    stats = torch.empty(2, dtype=torch.int32, device=device)
    work = torch.empty((tab.num_stages + 2) * (2 * dz + 3) * B, dtype=torch.float32, device=device)
    partials = torch.empty(6 * grid, dtype=torch.float32, device=device)
    gpart = torch.empty(2 * grid * _gvecs(tab) * P, dtype=torch.float32, device=device)
    entry = lib.cnf_k2_probe_adjoint if probes else lib.cnf_k2_train_adjoint
    err = entry(
        _ptr(w1), _ptr(b1), _ptr(w2), _ptr(b2), _ptr(e0), _ptr(zT), _ptr(accT), _ptr(azT),
        _ptr(aaccT), _ptr(ts), _ptr(z0), _ptr(acc0), _ptr(az0), _ptr(gw1), _ptr(gb1), _ptr(gw2),
        _ptr(gb2), _ptr(stats), _ptr(work), _ptr(partials), _ptr(gpart),
        B, dz, H, int(max_steps), int(norm_z), int(norm_j), *([K, int(jvp)] if probes else []), rtol, atol,
        *_controller_floats(tab), _tableau_array(tab), grid, block, _stream(device),
    )
    _check_launch(err, "K2", grid, block)
    return z0, acc0, az0, [gw1, gw2], [gb1, gb2], stats[0], stats[1]


def run_adjoint_kernel(
    tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, eps, zT, accT, azT, aaccT,
    t_hi, t_lo, dt_init, ys=None, jvp=False,
):
    """K2: the backsolve of (z, acc, a_z, a_acc, g_p) from t_hi to t_lo
    starting with step `dt_init`, on the TRAIN stage with probes eps
    (K, B, dz), VJP or (`jvp`) JVP.  zT, azT are (B, dz), accT, aaccT
    (3, B).  Returns (z0, acc0, a_z0, g_ws, g_bs, steps, accepted), g_*
    summed over the batch.

    CUDA tensors go through the K2 kernel (unconditional 2-layer tanh
    chains: one VJP probe in its first instance, any other probes in its
    probe instance, K6), CPU tensors through its plain version (any Dense
    chain; with ys (B, n_cond), a_ys0 is returned last)."""
    _no_grad_inputs("K2", ws, bs, eps, zT, accT, azT, aaccT, ys)
    if zT.device.type == "cpu":
        return adjoint_train_plain(
            tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol, max_steps=max_steps,
            ws=ws, bs=bs, eps=eps, zT=zT, accT=accT, azT=azT, aaccT=aaccT,
            t_hi=t_hi, t_lo=t_lo, dt_init=dt_init, ys=ys, jvp=jvp,
        )
    _cuda_only("K2", zT, tab, spec, eps.shape[0], jvp=jvp)
    if dt_init is None:
        raise ValueError("K2 needs dt_init (the caller picks it)")
    out = _launch_k2(tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol, max_steps=max_steps, ws=ws,
                     bs=bs, eps=eps, zT=zT, accT=accT, azT=azT, aaccT=aaccT, t_hi=t_hi, t_lo=t_lo, dt_init=dt_init,
                     jvp=jvp)
    _count(run_adjoint_kernel, eps, jvp)
    return out


run_adjoint_kernel.launches = 0
run_adjoint_kernel.probe_launches = {}


def run_exact_solve_kernel(
    tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, z0, acc0, t0, t1, dt_init, ys=None
):
    """K4 forward: the exact-trace TRAIN solve of [z | acc] from t0 to t1
    starting with step `dt_init`.  z0 is (B, dz) and acc0 (3, B) = [dlogp |
    reg_e | reg_n] seeds the accumulators.  Returns
    (zT, accT, steps, accepted, dt_last, dt_used), all on z0's device.

    CUDA tensors go through the K4 forward kernel (unconditional 2-layer
    tanh chains), CPU tensors through its plain version (any Dense chain, ys
    (B, n_cond) or None)."""
    _no_grad_inputs("K4", ws, bs, z0, acc0, ys)
    if z0.device.type == "cpu":
        return solve_train_exact_plain(
            tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol, max_steps=max_steps,
            ws=ws, bs=bs, z0=z0, acc0=acc0, t0=t0, t1=t1, dt_init=dt_init, ys=ys,
        )
    _cuda_only("K4", z0, tab, spec)
    out = _launch_two_layer_forward(
        "K4 forward", K4_KERNEL, "cnf_k4_exact_solve", "cnf_k4_max_grid", tab, spec, rtol=rtol, atol=atol,
        max_steps=max_steps, ws=ws, bs=bs, z0=z0, acc0=acc0, t0=t0, t1=t1, dt_init=dt_init,
        norms=(norm_z, norm_j),
    )
    run_exact_solve_kernel.launches += 1
    return out


run_exact_solve_kernel.launches = 0


def _launch_k4_adjoint(tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, zT, accT, azT, aaccT,
                       t_hi, t_lo, dt_init):
    B, dz = zT.shape
    H = spec.out_dims[0]
    device = zT.device
    w1, b1, w2, b2, zT, accT, azT, aaccT = _check_inputs(
        "K4", device, [ws[0], bs[0], ws[1], bs[1], zT, accT, azT, aaccT],
        [(dz, H), (H,), (H, dz), (dz,), (B, dz), (3, B), (B, dz), (3, B)],
    )
    lib = _library(K4A_KERNEL)
    block, grid = _launch_shape(
        lambda blk, cap: lib.cnf_k4a_max_grid(dz, H, blk, cap), "K4 adjoint", B, (128, 64, 32)
    )
    P_total = 2 * dz * H + H + dz + dz * dz * H
    ts = torch.stack([t_hi, t_lo, dt_init]).to(device=device, dtype=torch.float32)
    z0, az0, acc0 = torch.empty_like(zT), torch.empty_like(azT), torch.empty_like(accT)
    gw1, gb1, gw2, gb2 = (torch.empty_like(x) for x in (w1, b1, w2, b2))
    gpm = torch.empty((dz * dz, H), dtype=torch.float32, device=device)
    stats = torch.empty(2, dtype=torch.int32, device=device)
    work = torch.empty((tab.num_stages + 2) * (2 * dz + 3) * B, dtype=torch.float32, device=device)
    partials = torch.empty(6 * grid, dtype=torch.float32, device=device)
    gpart = torch.empty(2 * grid * _gvecs(tab) * P_total, dtype=torch.float32, device=device)
    gblk = torch.empty(grid * 4 * P_total, dtype=torch.float32, device=device)
    mbuf = torch.empty(dz * dz * B, dtype=torch.float32, device=device)
    err = lib.cnf_k4_exact_adjoint(
        _ptr(w1), _ptr(b1), _ptr(w2), _ptr(b2), _ptr(zT), _ptr(accT), _ptr(azT), _ptr(aaccT),
        _ptr(ts), _ptr(z0), _ptr(acc0), _ptr(az0), _ptr(gw1), _ptr(gb1), _ptr(gw2), _ptr(gb2),
        _ptr(gpm), _ptr(stats), _ptr(work), _ptr(partials), _ptr(gpart), _ptr(gblk), _ptr(mbuf),
        B, dz, H, int(max_steps), int(norm_z), int(norm_j), rtol, atol, *_controller_floats(tab),
        _tableau_array(tab), grid, block, _stream(device),
    )
    _check_launch(err, "K4 adjoint", grid, block)
    g_w1, g_w2 = exact_pm_chain(gpm, w1, w2)
    return z0, acc0, az0, [gw1 + g_w1, gw2 + g_w2], [gb1, gb2], stats[0], stats[1]


def run_exact_adjoint_kernel(
    tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, zT, accT, azT, aaccT,
    t_hi, t_lo, dt_init, ys=None,
):
    """K4 adjoint: the backsolve of (z, acc, a_z, a_acc, g_p, g_pm) from t_hi
    to t_lo starting with step `dt_init`, on the exact TRAIN stage of a
    2-layer tanh chain.  zT, azT are (B, dz), accT, aaccT (3, B).  Returns
    (z0, acc0, a_z0, g_ws, g_bs, steps, accepted), g_* summed over the batch
    with g_pm chained into g_w1 and g_w2.

    CUDA tensors go through the K4 adjoint kernel (unconditional nets: the
    conditional rows of the 2-layer kernels are not ported), CPU tensors
    through its plain version (with ys (B, n_cond), a_ys0 is returned
    last).  Other chains have no exact adjoint, as in the JAX package: K7
    is forward-only."""
    if not _two_layer_tanh(spec):
        raise ValueError(_NO_EXACT_CHAIN_ADJOINT)
    _no_grad_inputs("K4", ws, bs, zT, accT, azT, aaccT, ys)
    if zT.device.type == "cpu":
        return adjoint_train_exact_plain(
            tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol, max_steps=max_steps,
            ws=ws, bs=bs, zT=zT, accT=accT, azT=azT, aaccT=aaccT, t_hi=t_hi, t_lo=t_lo, dt_init=dt_init, ys=ys,
        )
    _cuda_only("K4", zT, tab, spec)
    if dt_init is None:
        raise ValueError("the K4 adjoint needs dt_init (the caller picks it)")
    out = _launch_k4_adjoint(tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol, max_steps=max_steps,
                             ws=ws, bs=bs, zT=zT, accT=accT, azT=azT, aaccT=aaccT, t_hi=t_hi, t_lo=t_lo,
                             dt_init=dt_init)
    run_exact_adjoint_kernel.launches += 1
    return out


run_exact_adjoint_kernel.launches = 0


def _launch_k5(tab, spec, *, rtol, atol, max_steps, ws, bs, zT, accT, azT, aaccT, t_hi, t_lo, dt_init, ys=None):
    B, dz = zT.shape
    H, din, nc = spec.out_dims[0], spec.in_dims[0], spec.n_cond
    device = zT.device
    w1, b1, w2, b2, zT, accT, azT, aaccT = _check_inputs(
        "K5", device, [ws[0], bs[0], ws[1], bs[1], zT, accT, azT, aaccT],
        [(din, H), (H,), (H, dz), (dz,), (B, dz), (1, B), (B, dz), (1, B)],
    )
    ys = _cond_rows("K5", spec, ys, B, device)
    lib = _library(K5_KERNEL)
    block, grid = _launch_shape(lambda blk, cap: lib.cnf_k5_max_grid(dz, H, nc, blk, cap), "K5", B, (128, 64, 32))
    P = din * H + H + H * dz + dz
    f32 = dict(dtype=torch.float32, device=device)
    ts = torch.stack([t_hi, t_lo, dt_init]).to(**f32)
    z0, az0, acc0 = torch.empty_like(zT), torch.empty_like(azT), torch.empty_like(accT)
    ays0 = torch.empty((B, nc), **f32) if nc else None
    gw1, gb1, gw2, gb2 = (torch.empty_like(x) for x in (w1, b1, w2, b2))
    stats = torch.empty(2, dtype=torch.int32, device=device)
    work = torch.empty((tab.num_stages + 2) * (2 * dz + 1 + nc) * B, **f32)
    partials = torch.empty(6 * grid, **f32)
    gpart = torch.empty(2 * grid * _gvecs(tab) * P, **f32)
    err = lib.cnf_k5_test_adjoint(
        _ptr(w1), _ptr(b1), _ptr(w2), _ptr(b2), _ptr_or_null(ys), _ptr(zT), _ptr(accT), _ptr(azT), _ptr(aaccT),
        _ptr(ts), _ptr(z0), _ptr(acc0), _ptr(az0), _ptr_or_null(ays0), _ptr(gw1), _ptr(gb1), _ptr(gw2), _ptr(gb2),
        _ptr(stats), _ptr(work), _ptr(partials), _ptr(gpart), B, dz, H, nc, int(max_steps), rtol, atol,
        *_controller_floats(tab), _tableau_array(tab), grid, block, _stream(device),
    )
    _check_launch(err, "K5", grid, block)
    return (z0, acc0, az0, [gw1, gw2], [gb1, gb2], stats[0], stats[1]) + (() if ays0 is None else (ays0,))


def run_test_adjoint_kernel(tab, spec, *, rtol, atol, max_steps, ws, bs, zT, accT, azT, aaccT, t_hi, t_lo, dt_init,
                            ys=None):
    """K5: the backsolve of (z, dlogp, a_z, a_dlogp, [a_ys,] g_p) from t_hi
    to t_lo starting with step `dt_init`, on the TEST stage of a 2-layer
    tanh chain (`_stage_test_fwdbwd`).  zT, azT are (B, dz), accT, aaccT
    (1, B); a conditional chain takes ys (B, n_cond) and integrates the
    per-sample a_ys from 0 at t_hi in the same error norm.  Returns
    (z0, acc0, a_z0, g_ws, g_bs, steps, accepted[, a_ys0]), g_* summed over
    the batch.

    CUDA tensors go through the K5 kernel (its COND instance for a
    conditional chain), CPU tensors through its plain version.  Other chains
    have no TEST adjoint, as in the JAX package."""
    if not _two_layer_tanh(spec):
        raise ValueError(_NO_TEST_CHAIN_ADJOINT)
    _no_grad_inputs("K5", ws, bs, zT, accT, azT, aaccT, ys)
    if zT.device.type == "cpu":
        return adjoint_test_plain(tab, spec, rtol=rtol, atol=atol, max_steps=max_steps, ws=ws, bs=bs, zT=zT,
                                  accT=accT, azT=azT, aaccT=aaccT, t_hi=t_hi, t_lo=t_lo, dt_init=dt_init, ys=ys)
    # K5 has a COND instance: the 2-layer kernels' rule without the conditioning.
    _cuda_only("K5", zT, tab, spec._replace(n_cond=0))
    if dt_init is None:
        raise ValueError("K5 needs dt_init (the caller picks it)")
    out = _launch_k5(tab, spec, rtol=rtol, atol=atol, max_steps=max_steps, ws=ws, bs=bs, zT=zT, accT=accT, azT=azT,
                     aaccT=aaccT, t_hi=t_hi, t_lo=t_lo, dt_init=dt_init, ys=ys)
    run_test_adjoint_kernel.launches += 1
    return out


run_test_adjoint_kernel.launches = 0


# ---- the chain kernels (1 to CHAIN_MAX_LAYERS layers) ----

_CHAIN_BLOCKS = (128, 64, 32)


def _chain_params(label: str, spec: ChainSpec, ws, bs, device):
    """The flat params [W0 | b0 | W1 | b1 | ...] of a chain kernel and its
    level widths as a C int array: the input width dz + n_cond first, dz
    last (the kernels read n_cond as their difference)."""
    widths = (spec.in_dims[0],) + tuple(spec.out_dims)
    shapes = [s for a, b in zip(widths[:-1], widths[1:]) for s in ((a, b), (b,))]
    leaves = _check_inputs(label, device, [x for w, b in zip(ws, bs) for x in (w, b)], shapes)
    return torch.cat([x.reshape(-1) for x in leaves]), (ctypes.c_int * len(widths))(*widths)


def _split_params(flat: torch.Tensor, spec: ChainSpec):
    """The (ws, bs) views of a flat [W0 | b0 | W1 | b1 | ...] vector."""
    ws, bs, o = [], [], 0
    for a, b in zip((spec.in_dims[0],) + tuple(spec.out_dims[:-1]), spec.out_dims):
        ws.append(flat[o : o + a * b].view(a, b))
        bs.append(flat[o + a * b : o + a * b + b])
        o += a * b + b
    return ws, bs


def _cond_rows(label: str, spec: ChainSpec, ys, B: int, device):
    """The conditioning (B, n_cond) as the chain kernels read it, None for an
    unconditional chain."""
    if (ys is None) != (spec.n_cond == 0):
        raise ValueError(f"{label}: ys must be given exactly for a conditional chain (n_cond = {spec.n_cond})")
    if ys is None:
        return None
    return _check_inputs(label, device, [ys], [(B, spec.n_cond)])[0]


def _ptr_or_null(x: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None) if x is None else _ptr(x)


def _launch_chain_forward(label, lib_name, entry, max_grid, tab, spec, *, rtol, atol, max_steps, ws, bs, z0,
                          acc0, t0, t1, dt_init, ys=None, eps=None, norms=()):
    """Launch a chain forward kernel, whose C arguments are (params, [eps],
    ys, z0, acc0, ts, zT, accT, stats, dt_last, work, partials, B, n, widths,
    acts, max_steps, *norms, rtol, atol, the controller, the tableau, grid,
    block, stream); `norms` ends with K and jvp for the K1 chain form's
    probe instance.  Returns (zT, accT, steps, accepted, dt_last,
    dt_used)."""
    B, dz = z0.shape
    device = z0.device
    params, widths = _chain_params(label, spec, ws, bs, device)
    ys = _cond_rows(label, spec, ys, B, device)
    probe = [] if eps is None else [eps]
    z0, acc0, *probe = _check_inputs(label, device, [z0, acc0] + probe,
                                     [(B, dz), tuple(acc0.shape)] + [(x.shape[0], B, dz) for x in probe])
    lib = _library(lib_name, spec)
    block, grid = _launch_shape(
        lambda blk, cap: getattr(lib, max_grid)(spec.n_layers, widths, blk, cap), label, B, _CHAIN_BLOCKS
    )
    ts = torch.stack([t0, t1, dt_init]).to(device=device, dtype=torch.float32)
    zT, accT, stats, dt_last, work, partials = _forward_buffers(z0, acc0, tab, grid)
    err = getattr(lib, entry)(
        _ptr(params), *[_ptr(x) for x in probe], _ptr_or_null(ys), _ptr(z0), _ptr(acc0), _ptr(ts), _ptr(zT),
        _ptr(accT), _ptr(stats), _ptr(dt_last), _ptr(work), _ptr(partials), B, spec.n_layers, widths,
        _acts_mask(spec), int(max_steps), *[int(x) for x in norms], rtol, atol, *_controller_floats(tab),
        _tableau_array(tab), grid, block, _stream(device),
    )
    _check_launch(err, label, grid, block)
    return _forward_result(zT, accT, stats, dt_last)


def run_chain_test_solve_kernel(tab, spec, *, rtol, atol, max_steps, ws, bs, z0, dlogp0, t0, t1, dt_init, ys=None):
    """K7 TEST: the TEST solve of [z | dlogp] of a chain of 1 to
    CHAIN_MAX_LAYERS tanh or identity layers, the exact trace by basis
    propagation; arguments and returns as `run_solve_kernel`, with the
    conditioning ys (B, n_cond) of a conditional chain (K8: the first layer
    reads [z | ys]).

    CUDA tensors go through the K7 kernel's TEST entry point, CPU tensors
    through its plain version."""
    _no_grad_inputs("K7", ws, bs, z0, dlogp0, ys)
    if z0.device.type == "cpu":
        return solve_test_plain(
            tab, spec, rtol=rtol, atol=atol, max_steps=max_steps, ws=ws, bs=bs,
            z0=z0, dlogp0=dlogp0, t0=t0, t1=t1, dt_init=dt_init, ys=ys,
        )
    _cuda_only("K7", z0, tab, spec, chain=True)
    out = _launch_chain_forward(
        "K7 TEST", K7_KERNEL, "cnf_k7_test_solve", "cnf_k7_test_max_grid", tab, spec, rtol=rtol, atol=atol,
        max_steps=max_steps, ws=ws, bs=bs, z0=z0, acc0=dlogp0, t0=t0, t1=t1, dt_init=dt_init, ys=ys,
    )
    run_chain_test_solve_kernel.launches += 1
    return out


run_chain_test_solve_kernel.launches = 0


def run_chain_exact_solve_kernel(
    tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, z0, acc0, t0, t1, dt_init, ys=None
):
    """K7 exact: the exact-trace TRAIN solve of [z | acc] of a chain of 1 to
    CHAIN_MAX_LAYERS tanh or identity layers (trace and ||J||_F by basis
    propagation); arguments and returns as `run_exact_solve_kernel`, with
    the conditioning ys (B, n_cond) of a conditional chain.

    CUDA tensors go through the K7 kernel's exact entry point, CPU tensors
    through its plain version."""
    _no_grad_inputs("K7", ws, bs, z0, acc0, ys)
    if z0.device.type == "cpu":
        return solve_train_exact_plain(
            tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol, max_steps=max_steps,
            ws=ws, bs=bs, z0=z0, acc0=acc0, t0=t0, t1=t1, dt_init=dt_init, ys=ys,
        )
    _cuda_only("K7", z0, tab, spec, chain=True)
    out = _launch_chain_forward(
        "K7 exact", K7_KERNEL, "cnf_k7_exact_solve", "cnf_k7_exact_max_grid", tab, spec, rtol=rtol, atol=atol,
        max_steps=max_steps, ws=ws, bs=bs, z0=z0, acc0=acc0, t0=t0, t1=t1, dt_init=dt_init, ys=ys,
        norms=(norm_z, norm_j),
    )
    run_chain_exact_solve_kernel.launches += 1
    return out


run_chain_exact_solve_kernel.launches = 0


def run_chain_train_solve_kernel(
    tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, z0, eps, acc0, t0, t1, dt_init, ys=None,
    jvp=False,
):
    """The K1 chain form: the TRAIN solve of [z | acc] of a chain of 1 to
    CHAIN_MAX_LAYERS tanh or identity layers with probes eps (K, B, dz), VJP
    or (`jvp`) JVP; arguments and returns as `run_train_solve_kernel`, with
    the conditioning ys (B, n_cond) of a conditional chain.

    CUDA tensors go through the kernel (one VJP probe in its first
    instance, any other probes in its probe instance, K6), CPU tensors
    through its plain version."""
    _no_grad_inputs("K1", ws, bs, z0, eps, acc0, ys)
    if z0.device.type == "cpu":
        return solve_train_plain(
            tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol, max_steps=max_steps,
            ws=ws, bs=bs, z0=z0, eps=eps, acc0=acc0, t0=t0, t1=t1, dt_init=dt_init, ys=ys, jvp=jvp,
        )
    _cuda_only("K1", z0, tab, spec, eps.shape[0], chain=True, jvp=jvp)
    probes = _probe_instance(eps, jvp)
    out = _launch_chain_forward(
        "K1 chain form", K1C_KERNEL, "cnf_k1c_probe_solve" if probes else "cnf_k1c_train_solve",
        "cnf_k1cp_max_grid" if probes else "cnf_k1c_max_grid", tab, spec, rtol=rtol,
        atol=atol, max_steps=max_steps, ws=ws, bs=bs, z0=z0, acc0=acc0, t0=t0, t1=t1, dt_init=dt_init, ys=ys,
        eps=eps, norms=(norm_z, norm_j) + ((eps.shape[0], jvp) if probes else ()),
    )
    _count(run_chain_train_solve_kernel, eps, jvp)
    return out


run_chain_train_solve_kernel.launches = 0
run_chain_train_solve_kernel.probe_launches = {}


def _launch_chain_adjoint(tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, eps, zT, accT, azT, aaccT,
                          t_hi, t_lo, dt_init, ys=None, jvp=False):
    label = "K2 chain form"
    B, dz = zT.shape
    K = eps.shape[0]
    nc = spec.n_cond
    device = zT.device
    params, widths = _chain_params(label, spec, ws, bs, device)
    ys = _cond_rows(label, spec, ys, B, device)
    e0, zT, accT, azT, aaccT = _check_inputs(
        label, device, [eps, zT, accT, azT, aaccT], [(K, B, dz), (B, dz), (3, B), (B, dz), (3, B)]
    )
    lib = _library(K2C_KERNEL, spec)
    probes = _probe_instance(eps, jvp)
    max_grid = lib.cnf_k2cp_max_grid if probes else lib.cnf_k2c_max_grid
    block, grid = _launch_shape(
        lambda blk, cap: max_grid(spec.n_layers, widths, blk, cap), label, B, _CHAIN_BLOCKS
    )
    P = params.numel()
    ts = torch.stack([t_hi, t_lo, dt_init]).to(device=device, dtype=torch.float32)
    z0, az0, acc0 = torch.empty_like(zT), torch.empty_like(azT), torch.empty_like(accT)
    ays0 = torch.empty((B, nc), dtype=torch.float32, device=device) if nc else None
    g = torch.empty(P, dtype=torch.float32, device=device)
    stats = torch.empty(2, dtype=torch.int32, device=device)
    work = torch.empty((tab.num_stages + 2) * (2 * dz + 3 + nc) * B, dtype=torch.float32, device=device)
    partials = torch.empty(6 * grid, dtype=torch.float32, device=device)
    gpart = torch.empty(2 * grid * _gvecs(tab) * P, dtype=torch.float32, device=device)
    gblk = torch.empty(grid * 4 * P, dtype=torch.float32, device=device)
    entry = lib.cnf_k2c_probe_adjoint if probes else lib.cnf_k2c_train_adjoint
    err = entry(
        _ptr(params), _ptr(e0), _ptr_or_null(ys), _ptr(zT), _ptr(accT), _ptr(azT), _ptr(aaccT), _ptr(ts),
        _ptr(z0), _ptr(acc0), _ptr(az0), _ptr_or_null(ays0), _ptr(g), _ptr(stats), _ptr(work), _ptr(partials),
        _ptr(gpart), _ptr(gblk), B, spec.n_layers, widths, _acts_mask(spec), int(max_steps), int(norm_z),
        int(norm_j), *([K, int(jvp)] if probes else []), rtol, atol, *_controller_floats(tab),
        _tableau_array(tab), grid, block, _stream(device),
    )
    _check_launch(err, label, grid, block)
    g_ws, g_bs = _split_params(g, spec)
    return (z0, acc0, az0, g_ws, g_bs, stats[0], stats[1]) + (() if ays0 is None else (ays0,))


def run_chain_adjoint_kernel(
    tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, eps, zT, accT, azT, aaccT,
    t_hi, t_lo, dt_init, ys=None, jvp=False,
):
    """The K2 chain form: the backsolve of (z, acc, a_z, a_acc, [a_ys,] g_p)
    of a chain of 1 to CHAIN_MAX_LAYERS tanh or identity layers with probes
    eps (K, B, dz), VJP or (`jvp`) JVP; arguments and returns as
    `run_adjoint_kernel`.  A conditional chain takes ys (B, n_cond) and
    integrates the per-sample a_ys from 0 at t_hi in the same error norm;
    a_ys0 (B, n_cond) is returned last.

    CUDA tensors go through the kernel (one VJP probe in its first
    instance, any other probes in its probe instance, K6), CPU tensors
    through its plain version."""
    _no_grad_inputs("K2", ws, bs, eps, zT, accT, azT, aaccT, ys)
    if zT.device.type == "cpu":
        return adjoint_train_plain(
            tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol, max_steps=max_steps,
            ws=ws, bs=bs, eps=eps, zT=zT, accT=accT, azT=azT, aaccT=aaccT,
            t_hi=t_hi, t_lo=t_lo, dt_init=dt_init, ys=ys, jvp=jvp,
        )
    _cuda_only("K2", zT, tab, spec, eps.shape[0], chain=True, jvp=jvp)
    if dt_init is None:
        raise ValueError("the K2 chain form needs dt_init (the caller picks it)")
    out = _launch_chain_adjoint(tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol,
                                max_steps=max_steps, ws=ws, bs=bs, eps=eps, zT=zT, accT=accT, azT=azT,
                                aaccT=aaccT, t_hi=t_hi, t_lo=t_lo, dt_init=dt_init, ys=ys, jvp=jvp)
    _count(run_chain_adjoint_kernel, eps, jvp)
    return out


run_chain_adjoint_kernel.launches = 0
run_chain_adjoint_kernel.probe_launches = {}


# ---- the chain kernels' wide forms (state widths to WIDE_MAX_DZ, hidden to WIDE_MAX_WIDTH) ----


def _wide_shape(lib, entry: str, label: str, spec: ChainSpec, widths, B: int) -> Tuple[int, int, int]:
    """(threads per block, blocks, tile) of a wide kernel's cooperative launch
    at batch B, from its shape entry (csrc/chain_wide.cuh::wide_shape): the
    tile is the samples a tile (the K1 and K2 chain forms) or the basis rows
    a chunk (K7)."""
    out = (ctypes.c_int * 4)()
    err = getattr(lib, entry)(spec.n_layers, widths, B, out)
    if err != 0 or out[1] < 1:
        raise RuntimeError(f"{label} cannot be launched cooperatively at widths {tuple(widths)}: cudaError {err}")
    return out[0], out[1], out[2]


def _m_scratch(spec: ChainSpec, device) -> torch.Tensor:
    """The dz x H floats of M = W1 (.) W2^T that streamed K3 and K5 build in
    their launch (csrc/two_layer_stream.cuh)."""
    return torch.empty(spec.dz * spec.out_dims[0], dtype=torch.float32, device=device)


def _stream_shape(lib, entry: str, label: str, spec: ChainSpec, widths, B: int, device):
    """(threads per block, blocks, tile, the global tile scratch or None) of
    a streamed kernel's cooperative launch at batch B, from its shape entry
    (csrc/chain_stream.cuh::stream_shape): the scratch (blocks x its floats a
    block) when the tile arrays do not fit in shared memory."""
    out = (ctypes.c_int * 5)()
    err = getattr(lib, entry)(spec.n_layers, widths, B, out)
    if err != 0 or out[1] < 1:
        raise RuntimeError(f"{label} cannot be launched cooperatively at widths {tuple(widths)}: cudaError {err}")
    tiles = torch.empty(out[1] * out[4], dtype=torch.float32, device=device) if out[4] else None
    return out[0], out[1], out[2], tiles


def _launch_wide_forward(label, lib_name, entry, shape, tab, spec, *, rtol, atol, max_steps, ws, bs, z0, acc0, t0,
                         t1, dt_init, eps=None, norms=(), stream=False, m=False, ys=None):
    """Launch a wide forward kernel, whose C arguments are (params, [eps],
    [ys], z0, acc0, ts, zT, accT, stats, dt_last, work, partials, [m],
    [tiles], B, n, widths, acts, max_steps, *norms, rtol, atol, the
    controller, the tableau, tile, grid, block, stream); `norms` ends with K
    and jvp for the wide and streamed K1 chain forms' probe and probe COND
    instances, and eps is (K, B, dz).  A COND instance (K8) takes the
    conditioning ys (B, n_cond); the caller names the entry and its shape
    entry, by the conditioning and the probes together.
    A streamed kernel (`stream`) takes the global tile scratch its shape
    entry asks for and, with `m` (streamed K3), the dz x H scratch of M that
    the launch builds.  Returns (zT, accT, steps, accepted, dt_last,
    dt_used)."""
    B, dz = z0.shape
    device = z0.device
    params, widths = _chain_params(label, spec, ws, bs, device)
    cond = [] if ys is None else [_cond_rows(label, spec, ys, B, device)]
    probe = [] if eps is None else [eps]
    z0, acc0, *probe = _check_inputs(label, device, [z0, acc0] + probe,
                                     [(B, dz), tuple(acc0.shape)] + [(x.shape[0], B, dz) for x in probe])
    lib = _library(lib_name, spec)
    if stream:
        block, grid, tile, tiles = _stream_shape(lib, shape, label, spec, widths, B, device)
        m_buf = [_m_scratch(spec, device)] if m else []
        extra = [_ptr(x) for x in m_buf] + [_ptr_or_null(tiles)]
    else:
        block, grid, tile = _wide_shape(lib, shape, label, spec, widths, B)
        extra = []
    ts = torch.stack([t0, t1, dt_init]).to(device=device, dtype=torch.float32)
    zT, accT, stats, dt_last, work, partials = _forward_buffers(z0, acc0, tab, grid)
    err = getattr(lib, entry)(
        _ptr(params), *[_ptr(x) for x in probe + cond], _ptr(z0), _ptr(acc0), _ptr(ts), _ptr(zT), _ptr(accT),
        _ptr(stats), _ptr(dt_last), _ptr(work), _ptr(partials), *extra, B, spec.n_layers, widths, _acts_mask(spec),
        int(max_steps), *[int(x) for x in norms], rtol, atol, *_controller_floats(tab), _tableau_array(tab), tile,
        grid, block, _stream(device),
    )
    _check_launch(err, label, grid, block)
    return _forward_result(zT, accT, stats, dt_last)


def run_wide_test_solve_kernel(tab, spec, *, rtol, atol, max_steps, ws, bs, z0, dlogp0, t0, t1, dt_init, ys=None):
    """Wide K7 TEST: K7 TEST's solve (`run_chain_test_solve_kernel`) for
    unconditional chains of state widths up to WIDE_MAX_DZ and hidden widths
    up to WIDE_MAX_WIDTH (the tabular MINIBOONE model 43 -> 128 -> 128 ->
    43); arguments and returns as `run_solve_kernel`.

    CUDA tensors go through the kernel (`csrc/k7_wide_solve.cu`), CPU
    tensors through its plain version."""
    _no_grad_inputs("K7", ws, bs, z0, dlogp0, ys)
    if z0.device.type == "cpu":
        return solve_test_plain(
            tab, spec, rtol=rtol, atol=atol, max_steps=max_steps, ws=ws, bs=bs,
            z0=z0, dlogp0=dlogp0, t0=t0, t1=t1, dt_init=dt_init, ys=ys,
        )
    _cuda_only("wide K7", z0, tab, spec, chain=True, wide=True)
    out = _launch_wide_forward(
        "wide K7 TEST", K7W_KERNEL, "cnf_k7w_test_solve", "cnf_k7w_test_shape", tab, spec, rtol=rtol, atol=atol,
        max_steps=max_steps, ws=ws, bs=bs, z0=z0, acc0=dlogp0, t0=t0, t1=t1, dt_init=dt_init,
    )
    run_wide_test_solve_kernel.launches += 1
    return out


run_wide_test_solve_kernel.launches = 0


def run_wide_exact_solve_kernel(
    tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, z0, acc0, t0, t1, dt_init, ys=None
):
    """Wide K7 exact: K7 exact's solve (`run_chain_exact_solve_kernel`) for
    the unconditional wide chains; arguments and returns as
    `run_exact_solve_kernel`.

    CUDA tensors go through the kernel (`csrc/k7_wide_solve.cu`), CPU
    tensors through its plain version."""
    _no_grad_inputs("K7", ws, bs, z0, acc0, ys)
    if z0.device.type == "cpu":
        return solve_train_exact_plain(
            tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol, max_steps=max_steps,
            ws=ws, bs=bs, z0=z0, acc0=acc0, t0=t0, t1=t1, dt_init=dt_init, ys=ys,
        )
    _cuda_only("wide K7", z0, tab, spec, chain=True, wide=True)
    out = _launch_wide_forward(
        "wide K7 exact", K7W_KERNEL, "cnf_k7w_exact_solve", "cnf_k7w_exact_shape", tab, spec, rtol=rtol, atol=atol,
        max_steps=max_steps, ws=ws, bs=bs, z0=z0, acc0=acc0, t0=t0, t1=t1, dt_init=dt_init, norms=(norm_z, norm_j),
    )
    run_wide_exact_solve_kernel.launches += 1
    return out


run_wide_exact_solve_kernel.launches = 0


def run_wide_train_solve_kernel(
    tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, z0, eps, acc0, t0, t1, dt_init, ys=None,
    jvp=False,
):
    """The wide K1 chain form: the K1 chain form's solve
    (`run_chain_train_solve_kernel`) for the wide chains; arguments and
    returns as `run_train_solve_kernel`.

    CUDA tensors go through the kernel (`csrc/k1_wide_solve.cu`: one VJP
    probe in its first instance, any other probes in its probe instance,
    K6), CPU tensors through its plain version."""
    _no_grad_inputs("K1", ws, bs, z0, eps, acc0, ys)
    if z0.device.type == "cpu":
        return solve_train_plain(
            tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol, max_steps=max_steps,
            ws=ws, bs=bs, z0=z0, eps=eps, acc0=acc0, t0=t0, t1=t1, dt_init=dt_init, ys=ys, jvp=jvp,
        )
    _cuda_only("wide K1", z0, tab, spec, eps.shape[0], chain=True, wide=True, jvp=jvp)
    probes = _probe_instance(eps, jvp)
    out = _launch_wide_forward(
        "wide K1 chain form", K1W_KERNEL, "cnf_k1w_probe_solve" if probes else "cnf_k1w_train_solve",
        "cnf_k1wp_shape" if probes else "cnf_k1w_shape", tab, spec, rtol=rtol, atol=atol, max_steps=max_steps,
        ws=ws, bs=bs, z0=z0, acc0=acc0, t0=t0, t1=t1, dt_init=dt_init, eps=eps,
        norms=(norm_z, norm_j) + ((eps.shape[0], jvp) if probes else ()),
    )
    _count(run_wide_train_solve_kernel, eps, jvp)
    return out


run_wide_train_solve_kernel.launches = 0
run_wide_train_solve_kernel.probe_launches = {}


def _wide_adjoint_buffers(tab, zT, accT, grid: int, Pg: int, nc: int = 0):
    """(z0, acc0, a_z0, g, g_new, stats, work, partials, gblk) of a wide
    adjoint (the tile solve): g of Pg floats, the (row, B) planes of
    (z, acc, a_z) and, for nc conditioning inputs (a COND instance), a_ys,
    its partials and each block's (NG + 2) g vectors."""
    B, dz = zT.shape
    f32 = dict(dtype=torch.float32, device=zT.device)
    return (
        torch.empty_like(zT), torch.empty_like(accT), torch.empty_like(zT), torch.empty(Pg, **f32),
        torch.empty(Pg, **f32), torch.empty(2, dtype=torch.int32, device=zT.device),
        torch.empty((tab.num_stages + 2) * (2 * dz + accT.shape[0] + nc) * B, **f32), torch.empty(10 * grid, **f32),
        torch.empty(grid * (_gvecs(tab) + 2) * Pg, **f32),
    )


def _launch_wide_adjoint(tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, eps, zT, accT, azT, aaccT,
                         t_hi, t_lo, dt_init, jvp=False, ys=None):
    """Launch the wide K2 chain form: its one-probe instance, its probe
    instance (K probes or JVP, K6) or, given ys (B, n_cond), its COND
    instance (K8) or probe COND instance (K6 x K8), which return a_ys0
    (B, n_cond) last.  The shape entry and the entry are picked by the
    conditioning and the probes together."""
    label = "wide K2 chain form"
    B, dz = zT.shape
    K, nc = eps.shape[0], spec.n_cond if ys is not None else 0
    device = zT.device
    params, widths = _chain_params(label, spec, ws, bs, device)
    e0, zT, accT, azT, aaccT = _check_inputs(
        label, device, [eps, zT, accT, azT, aaccT], [(K, B, dz), (B, dz), (3, B), (B, dz), (3, B)]
    )
    lib = _library(K2W_KERNEL, spec)
    probes = _probe_instance(eps, jvp)
    shape = {(True, True): "cnf_k2wpc_shape", (True, False): "cnf_k2wc_shape", (False, True): "cnf_k2wp_shape",
             (False, False): "cnf_k2w_shape"}[(bool(nc), probes)]
    block, grid, tile = _wide_shape(lib, shape, label, spec, widths, B)
    ts = torch.stack([t_hi, t_lo, dt_init]).to(device=device, dtype=torch.float32)
    z0, acc0, az0, g, gnew, stats, work, partials, gblk = _wide_adjoint_buffers(tab, zT, accT, grid, params.numel(),
                                                                                nc)
    tail = (int(max_steps), int(norm_z), int(norm_j), *([K, int(jvp)] if probes else []), rtol, atol,
            *_controller_floats(tab), _tableau_array(tab), tile, grid, block, _stream(device))
    if nc:
        ys = _cond_rows(label, spec, ys, B, device)
        ays0 = torch.empty((B, nc), dtype=torch.float32, device=device)
        entry = lib.cnf_k2w_probe_cond_adjoint if probes else lib.cnf_k2w_cond_adjoint
        err = entry(
            _ptr(params), _ptr(e0), _ptr(ys), _ptr(zT), _ptr(accT), _ptr(azT), _ptr(aaccT), _ptr(ts), _ptr(z0),
            _ptr(acc0), _ptr(az0), _ptr(ays0), _ptr(g), _ptr(stats), _ptr(work), _ptr(partials), _ptr(gblk),
            _ptr(gnew), B, spec.n_layers, widths, _acts_mask(spec), *tail,
        )
    else:
        entry = lib.cnf_k2w_probe_adjoint if probes else lib.cnf_k2w_train_adjoint
        err = entry(
            _ptr(params), _ptr(e0), _ptr(zT), _ptr(accT), _ptr(azT), _ptr(aaccT), _ptr(ts), _ptr(z0), _ptr(acc0),
            _ptr(az0), _ptr(g), _ptr(stats), _ptr(work), _ptr(partials), _ptr(gblk), _ptr(gnew), B, spec.n_layers,
            widths, _acts_mask(spec), *tail,
        )
    _check_launch(err, label, grid, block)
    g_ws, g_bs = _split_params(g, spec)
    return (z0, acc0, az0, g_ws, g_bs, stats[0], stats[1]) + ((ays0,) if nc else ())


def run_wide_adjoint_kernel(
    tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, eps, zT, accT, azT, aaccT,
    t_hi, t_lo, dt_init, ys=None, jvp=False,
):
    """The wide K2 chain form: the K2 chain form's backsolve
    (`run_chain_adjoint_kernel`) for the wide chains; arguments and returns
    as `run_adjoint_kernel`.

    CUDA tensors go through the kernel (`csrc/k2_wide_adjoint.cu`: one VJP
    probe in its first instance, any other probes in its probe instance,
    K6), CPU tensors through its plain version."""
    _no_grad_inputs("K2", ws, bs, eps, zT, accT, azT, aaccT, ys)
    if zT.device.type == "cpu":
        return adjoint_train_plain(
            tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol, max_steps=max_steps,
            ws=ws, bs=bs, eps=eps, zT=zT, accT=accT, azT=azT, aaccT=aaccT,
            t_hi=t_hi, t_lo=t_lo, dt_init=dt_init, ys=ys, jvp=jvp,
        )
    _cuda_only("wide K2", zT, tab, spec, eps.shape[0], chain=True, wide=True, jvp=jvp)
    if dt_init is None:
        raise ValueError("the wide K2 chain form needs dt_init (the caller picks it)")
    out = _launch_wide_adjoint(tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol, max_steps=max_steps,
                               ws=ws, bs=bs, eps=eps, zT=zT, accT=accT, azT=azT, aaccT=aaccT, t_hi=t_hi, t_lo=t_lo,
                               dt_init=dt_init, jvp=jvp)
    _count(run_wide_adjoint_kernel, eps, jvp)
    return out


run_wide_adjoint_kernel.launches = 0
run_wide_adjoint_kernel.probe_launches = {}


# ---- the 2-layer kernels' wide forms (2-layer tanh nets past MAX_DZ) ----


def _cuda_only_wide_two_layer(label: str, x: torch.Tensor, tab, spec, stream: bool = False,
                              cond: bool = False) -> None:
    """Raise unless the wide 2-layer kernels (`_wide_two_layer_covers`) or,
    `stream`, streamed K3 and K5 (`_stream_two_layer_covers`) take the
    configuration on CUDA tensors: the wide ones take conditional nets in
    their COND instances (`cond`) and unconditional ones in the others."""
    if x.device.type != "cuda":
        raise ValueError(f"{label} runs on CUDA or CPU tensors, got {x.device}")
    why = _stream_two_layer_covers(tab, spec) if stream else _wide_two_layer_covers(tab, spec)
    if why is None and spec.n_cond and not cond:
        why = f"conditional nets in the unconditional instance of {label} (its COND instance takes them)"
    if why is None and cond and not spec.n_cond:
        why = f"unconditional nets in the COND instance of {label} (its unconditional instance takes them)"
    if why is not None:
        raise NotImplementedError(f"the CUDA solve kernels do not cover {why}")


def run_wide_test2_solve_kernel(tab, spec, *, rtol, atol, max_steps, ws, bs, z0, dlogp0, t0, t1, dt_init, ys=None):
    """Wide K3: K3's TEST solve with the closed-form trace
    (`run_solve_kernel`) for unconditional 2-layer tanh nets of state widths
    up to WIDE_MAX_DZ and hidden widths up to WIDE_MAX_WIDTH (the README net
    family at the HEPMASS width, 42 -> 126 -> 42); arguments and returns as
    `run_solve_kernel`.

    CUDA tensors go through the kernel (`csrc/k3_wide_solve.cu`), CPU
    tensors through its plain version."""
    _no_grad_inputs("K3", ws, bs, z0, dlogp0, ys)
    if z0.device.type == "cpu":
        return solve_test_plain(
            tab, spec, rtol=rtol, atol=atol, max_steps=max_steps, ws=ws, bs=bs,
            z0=z0, dlogp0=dlogp0, t0=t0, t1=t1, dt_init=dt_init, ys=ys,
        )
    _cuda_only_wide_two_layer("wide K3", z0, tab, spec)
    out = _launch_wide_forward(
        "wide K3", K3W_KERNEL, "cnf_k3w_test_solve", "cnf_k3w_shape", tab, spec, rtol=rtol, atol=atol,
        max_steps=max_steps, ws=ws, bs=bs, z0=z0, acc0=dlogp0, t0=t0, t1=t1, dt_init=dt_init,
    )
    run_wide_test2_solve_kernel.launches += 1
    return out


run_wide_test2_solve_kernel.launches = 0


def _launch_wide_test_adjoint(tab, spec, *, rtol, atol, max_steps, ws, bs, zT, accT, azT, aaccT, t_hi, t_lo,
                              dt_init, ys=None):
    """Launch wide K5: its unconditional instance or, given ys (B, n_cond),
    its COND instance (K8), which returns a_ys0 (B, n_cond) last."""
    label = "wide K5"
    B, dz = zT.shape
    nc = spec.n_cond if ys is not None else 0
    device = zT.device
    params, widths = _chain_params(label, spec, ws, bs, device)
    zT, accT, azT, aaccT = _check_inputs(label, device, [zT, accT, azT, aaccT], [(B, dz), (1, B), (B, dz), (1, B)])
    lib = _library(K5W_KERNEL)
    block, grid, tile = _wide_shape(lib, "cnf_k5wc_shape" if nc else "cnf_k5w_shape", label, spec, widths, B)
    ts = torch.stack([t_hi, t_lo, dt_init]).to(device=device, dtype=torch.float32)
    z0, acc0, az0, g, gnew, stats, work, partials, gblk = _wide_adjoint_buffers(tab, zT, accT, grid, params.numel(),
                                                                                nc)
    tail = (B, spec.n_layers, widths, _acts_mask(spec), int(max_steps), rtol, atol, *_controller_floats(tab),
            _tableau_array(tab), tile, grid, block, _stream(device))
    if nc:
        ys = _cond_rows(label, spec, ys, B, device)
        ays0 = torch.empty((B, nc), dtype=torch.float32, device=device)
        err = lib.cnf_k5w_cond_adjoint(
            _ptr(params), _ptr(ys), _ptr(zT), _ptr(accT), _ptr(azT), _ptr(aaccT), _ptr(ts), _ptr(z0), _ptr(acc0),
            _ptr(az0), _ptr(ays0), _ptr(g), _ptr(stats), _ptr(work), _ptr(partials), _ptr(gblk), _ptr(gnew), *tail,
        )
    else:
        err = lib.cnf_k5w_test_adjoint(
            _ptr(params), _ptr(zT), _ptr(accT), _ptr(azT), _ptr(aaccT), _ptr(ts), _ptr(z0), _ptr(acc0), _ptr(az0),
            _ptr(g), _ptr(stats), _ptr(work), _ptr(partials), _ptr(gblk), _ptr(gnew), *tail,
        )
    _check_launch(err, label, grid, block)
    g_ws, g_bs = _split_params(g, spec)
    return (z0, acc0, az0, g_ws, g_bs, stats[0], stats[1]) + ((ays0,) if nc else ())


def run_wide_test_adjoint_kernel(tab, spec, *, rtol, atol, max_steps, ws, bs, zT, accT, azT, aaccT, t_hi, t_lo,
                                 dt_init, ys=None):
    """Wide K5: K5's TEST backsolve (`run_test_adjoint_kernel`, ct_m folded
    into g) for the unconditional 2-layer tanh nets wide K3 takes; arguments
    and returns as `run_test_adjoint_kernel`.

    CUDA tensors go through the kernel (`csrc/k5_wide_adjoint.cu`), CPU
    tensors through its plain version (with ys (B, n_cond), a_ys0 is
    returned last)."""
    if not _two_layer_tanh(spec):
        raise ValueError(_NO_TEST_CHAIN_ADJOINT)
    _no_grad_inputs("K5", ws, bs, zT, accT, azT, aaccT, ys)
    if zT.device.type == "cpu":
        return adjoint_test_plain(tab, spec, rtol=rtol, atol=atol, max_steps=max_steps, ws=ws, bs=bs, zT=zT,
                                  accT=accT, azT=azT, aaccT=aaccT, t_hi=t_hi, t_lo=t_lo, dt_init=dt_init, ys=ys)
    _cuda_only_wide_two_layer("wide K5", zT, tab, spec)
    if dt_init is None:
        raise ValueError("wide K5 needs dt_init (the caller picks it)")
    out = _launch_wide_test_adjoint(tab, spec, rtol=rtol, atol=atol, max_steps=max_steps, ws=ws, bs=bs, zT=zT,
                                    accT=accT, azT=azT, aaccT=aaccT, t_hi=t_hi, t_lo=t_lo, dt_init=dt_init)
    run_wide_test_adjoint_kernel.launches += 1
    return out


run_wide_test_adjoint_kernel.launches = 0


def _launch_wide_exact_adjoint(tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, zT, accT, azT, aaccT,
                               t_hi, t_lo, dt_init, ys=None):
    """Launch the wide K4 adjoint: its unconditional instance or, given ys
    (B, n_cond), its COND instance (K8), which returns a_ys0 (B, n_cond)
    last.  g_pm, over W1's z rows, is chained into them and W2 after the
    launch; W1's ys rows get none (the JAX package's :1787-1799)."""
    label = "wide K4 adjoint"
    B, dz = zT.shape
    H = spec.out_dims[0]
    nc = spec.n_cond if ys is not None else 0
    device = zT.device
    params, widths = _chain_params(label, spec, ws, bs, device)
    zT, accT, azT, aaccT = _check_inputs(label, device, [zT, accT, azT, aaccT], [(B, dz), (3, B), (B, dz), (3, B)])
    lib = _library(K4WA_KERNEL)
    shape = (ctypes.c_int * 5)()
    err = getattr(lib, "cnf_k4wc_shape" if nc else "cnf_k4w_shape")(spec.n_layers, widths, B, shape)
    if err != 0 or shape[1] < 1:
        raise RuntimeError(f"{label} cannot be launched cooperatively at widths {tuple(widths)}: cudaError {err}")
    block, grid, T, R = shape[0], shape[1], shape[2], shape[3]
    P = params.numel()
    ts = torch.stack([t_hi, t_lo, dt_init]).to(device=device, dtype=torch.float32)
    z0, acc0, az0, g, gnew, stats, work, partials, gblk = _wide_adjoint_buffers(tab, zT, accT, grid,
                                                                                P + dz * dz * H, nc)
    mbuf = torch.empty(grid * T * dz * dz, dtype=torch.float32, device=device)
    tail = (B, spec.n_layers, widths, _acts_mask(spec), int(max_steps), int(norm_z), int(norm_j), rtol, atol,
            *_controller_floats(tab), _tableau_array(tab), T, R, grid, block, _stream(device))
    if nc:
        ys = _cond_rows(label, spec, ys, B, device)
        ays0 = torch.empty((B, nc), dtype=torch.float32, device=device)
        err = lib.cnf_k4w_cond_exact_adjoint(
            _ptr(params), _ptr(ys), _ptr(zT), _ptr(accT), _ptr(azT), _ptr(aaccT), _ptr(ts), _ptr(z0), _ptr(acc0),
            _ptr(az0), _ptr(ays0), _ptr(g), _ptr(stats), _ptr(work), _ptr(partials), _ptr(gblk), _ptr(gnew),
            _ptr(mbuf), *tail,
        )
    else:
        err = lib.cnf_k4w_exact_adjoint(
            _ptr(params), _ptr(zT), _ptr(accT), _ptr(azT), _ptr(aaccT), _ptr(ts), _ptr(z0), _ptr(acc0), _ptr(az0),
            _ptr(g), _ptr(stats), _ptr(work), _ptr(partials), _ptr(gblk), _ptr(gnew), _ptr(mbuf), *tail,
        )
    _check_launch(err, label, grid, block)
    g_ws, g_bs = _split_params(g[:P], spec)
    g_w1, g_w2 = exact_pm_chain(g[P:].view(dz * dz, H), ws[0][:dz], ws[1])
    g_ws = [g_ws[0] + _pad_rows(g_w1, g_ws[0].shape[0]), g_ws[1] + g_w2]
    return (z0, acc0, az0, g_ws, g_bs, stats[0], stats[1]) + ((ays0,) if nc else ())


def run_wide_exact_adjoint_kernel(
    tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, zT, accT, azT, aaccT,
    t_hi, t_lo, dt_init, ys=None,
):
    """The wide K4 adjoint: the K4 adjoint's exact backsolve with g_pm in
    the state (`run_exact_adjoint_kernel`) for the unconditional 2-layer
    tanh nets wide K3 takes; arguments and returns as
    `run_exact_adjoint_kernel`, g_pm chained into g_w1 and g_w2.

    CUDA tensors go through the kernel (`csrc/k4_wide_adjoint.cu`), CPU
    tensors through its plain version (with ys (B, n_cond), a_ys0 is
    returned last)."""
    if not _two_layer_tanh(spec):
        raise ValueError(_NO_EXACT_CHAIN_ADJOINT)
    _no_grad_inputs("K4", ws, bs, zT, accT, azT, aaccT, ys)
    if zT.device.type == "cpu":
        return adjoint_train_exact_plain(
            tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol, max_steps=max_steps,
            ws=ws, bs=bs, zT=zT, accT=accT, azT=azT, aaccT=aaccT, t_hi=t_hi, t_lo=t_lo, dt_init=dt_init, ys=ys,
        )
    _cuda_only_wide_two_layer("the wide K4 adjoint", zT, tab, spec)
    if dt_init is None:
        raise ValueError("the wide K4 adjoint needs dt_init (the caller picks it)")
    out = _launch_wide_exact_adjoint(tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol,
                                     max_steps=max_steps, ws=ws, bs=bs, zT=zT, accT=accT, azT=azT, aaccT=aaccT,
                                     t_hi=t_hi, t_lo=t_lo, dt_init=dt_init)
    run_wide_exact_adjoint_kernel.launches += 1
    return out


run_wide_exact_adjoint_kernel.launches = 0


# ---- the COND instances of the wide forms (K8: conditional nets past the narrow widths) ----


def run_wide_cond_train_solve_kernel(
    tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, z0, eps, acc0, t0, t1, dt_init, ys=None,
    jvp=False,
):
    """The wide K1 chain form's COND instance: the Hutchinson TRAIN solve
    (`run_wide_train_solve_kernel`) of a conditional chain past the narrow
    widths whose first layer reads [z | ys], ys (B, n_cond) constant over
    the solve (CondRNODE at the HEPMASS width, 43 -> 126 -> 42, one ys
    column); one VJP probe, or K VJP or JVP probes in its probe COND
    instance (K6 x K8); arguments and returns as `run_train_solve_kernel`.

    CUDA tensors go through the kernel (`csrc/k1_wide_solve.cu`'s
    `k1_wide_cond_solve`, or `k1_wide_probe_cond_solve` with K probes or
    JVP), CPU tensors through its plain version."""
    _no_grad_inputs("K1", ws, bs, z0, eps, acc0, ys)
    if z0.device.type == "cpu":
        return solve_train_plain(
            tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol, max_steps=max_steps,
            ws=ws, bs=bs, z0=z0, eps=eps, acc0=acc0, t0=t0, t1=t1, dt_init=dt_init, ys=ys, jvp=jvp,
        )
    _cuda_only("wide K1 COND", z0, tab, spec, eps.shape[0], chain=True, wide=True, jvp=jvp, cond=True)
    probes = _probe_instance(eps, jvp)
    out = _launch_wide_forward(
        "wide K1 chain form COND", K1W_KERNEL, "cnf_k1w_probe_cond_solve" if probes else "cnf_k1w_cond_solve",
        "cnf_k1wpc_shape" if probes else "cnf_k1wc_shape", tab, spec, rtol=rtol, atol=atol, max_steps=max_steps,
        ws=ws, bs=bs, z0=z0, acc0=acc0, t0=t0, t1=t1, dt_init=dt_init, eps=eps,
        norms=(norm_z, norm_j) + ((eps.shape[0], jvp) if probes else ()), ys=ys,
    )
    _count(run_wide_cond_train_solve_kernel, eps, jvp)
    return out


run_wide_cond_train_solve_kernel.launches = 0
run_wide_cond_train_solve_kernel.probe_launches = {}


def run_wide_cond_adjoint_kernel(
    tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, eps, zT, accT, azT, aaccT,
    t_hi, t_lo, dt_init, ys=None, jvp=False,
):
    """The wide K2 chain form's COND instance: the backsolve of (z, acc, a_z,
    a_acc, a_ys, g_p) (`run_wide_adjoint_kernel`) of a conditional chain past
    the narrow widths, the per-sample a_ys integrated from 0 at t_hi in the
    one batch-global error norm; one VJP probe, or K VJP or JVP probes in its
    probe COND instance (K6 x K8); arguments as `run_adjoint_kernel` with ys
    (B, n_cond), returns (z0, acc0, a_z0, g_ws, g_bs, steps, accepted,
    a_ys0).

    CUDA tensors go through the kernel (`csrc/k2_wide_adjoint.cu`'s
    `k2_wide_cond_adjoint`, or `k2_wide_probe_cond_adjoint` with K probes or
    JVP), CPU tensors through its plain version."""
    _no_grad_inputs("K2", ws, bs, eps, zT, accT, azT, aaccT, ys)
    if zT.device.type == "cpu":
        return adjoint_train_plain(
            tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol, max_steps=max_steps,
            ws=ws, bs=bs, eps=eps, zT=zT, accT=accT, azT=azT, aaccT=aaccT,
            t_hi=t_hi, t_lo=t_lo, dt_init=dt_init, ys=ys, jvp=jvp,
        )
    _cuda_only("wide K2 COND", zT, tab, spec, eps.shape[0], chain=True, wide=True, jvp=jvp, cond=True)
    if dt_init is None:
        raise ValueError("the wide K2 chain form needs dt_init (the caller picks it)")
    out = _launch_wide_adjoint(tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol, max_steps=max_steps,
                               ws=ws, bs=bs, eps=eps, zT=zT, accT=accT, azT=azT, aaccT=aaccT, t_hi=t_hi, t_lo=t_lo,
                               dt_init=dt_init, jvp=jvp, ys=ys)
    _count(run_wide_cond_adjoint_kernel, eps, jvp)
    return out


run_wide_cond_adjoint_kernel.launches = 0
run_wide_cond_adjoint_kernel.probe_launches = {}


def run_wide_cond_test2_solve_kernel(tab, spec, *, rtol, atol, max_steps, ws, bs, z0, dlogp0, t0, t1, dt_init,
                                     ys=None):
    """Wide K3's COND instance: the closed-form TEST solve
    (`run_wide_test2_solve_kernel`) of a conditional 2-layer tanh net past
    MAX_DZ whose W1 reads [z | ys] (CondRNODE at the HEPMASS width); the
    trace reads W1's z rows only; arguments and returns as
    `run_solve_kernel` with ys (B, n_cond).

    CUDA tensors go through the kernel (`csrc/k3_wide_solve.cu`'s
    `k3_wide_cond_solve`), CPU tensors through its plain version."""
    _no_grad_inputs("K3", ws, bs, z0, dlogp0, ys)
    if z0.device.type == "cpu":
        return solve_test_plain(
            tab, spec, rtol=rtol, atol=atol, max_steps=max_steps, ws=ws, bs=bs,
            z0=z0, dlogp0=dlogp0, t0=t0, t1=t1, dt_init=dt_init, ys=ys,
        )
    _cuda_only_wide_two_layer("wide K3", z0, tab, spec, cond=True)
    out = _launch_wide_forward(
        "wide K3 COND", K3W_KERNEL, "cnf_k3w_cond_solve", "cnf_k3wc_shape", tab, spec, rtol=rtol, atol=atol,
        max_steps=max_steps, ws=ws, bs=bs, z0=z0, acc0=dlogp0, t0=t0, t1=t1, dt_init=dt_init, ys=ys,
    )
    run_wide_cond_test2_solve_kernel.launches += 1
    return out


run_wide_cond_test2_solve_kernel.launches = 0


def run_wide_cond_test_adjoint_kernel(tab, spec, *, rtol, atol, max_steps, ws, bs, zT, accT, azT, aaccT, t_hi, t_lo,
                                      dt_init, ys=None):
    """Wide K5's COND instance: the TEST backsolve (`run_wide_test_adjoint_kernel`,
    ct_m folded into g) of the conditional 2-layer tanh nets wide K3's COND
    instance takes, the per-sample a_ys integrated from 0 at t_hi in the
    one batch-global error norm; arguments as `run_test_adjoint_kernel` with
    ys (B, n_cond), returns (z0, acc0, a_z0, g_ws, g_bs, steps, accepted,
    a_ys0).

    CUDA tensors go through the kernel (`csrc/k5_wide_adjoint.cu`'s
    `k5_wide_cond_adjoint`), CPU tensors through its plain version."""
    if not _two_layer_tanh(spec):
        raise ValueError(_NO_TEST_CHAIN_ADJOINT)
    _no_grad_inputs("K5", ws, bs, zT, accT, azT, aaccT, ys)
    if zT.device.type == "cpu":
        return adjoint_test_plain(tab, spec, rtol=rtol, atol=atol, max_steps=max_steps, ws=ws, bs=bs, zT=zT,
                                  accT=accT, azT=azT, aaccT=aaccT, t_hi=t_hi, t_lo=t_lo, dt_init=dt_init, ys=ys)
    _cuda_only_wide_two_layer("wide K5", zT, tab, spec, cond=True)
    if dt_init is None:
        raise ValueError("wide K5 needs dt_init (the caller picks it)")
    out = _launch_wide_test_adjoint(tab, spec, rtol=rtol, atol=atol, max_steps=max_steps, ws=ws, bs=bs, zT=zT,
                                    accT=accT, azT=azT, aaccT=aaccT, t_hi=t_hi, t_lo=t_lo, dt_init=dt_init, ys=ys)
    run_wide_cond_test_adjoint_kernel.launches += 1
    return out


run_wide_cond_test_adjoint_kernel.launches = 0


def run_wide_cond_test_solve_kernel(tab, spec, *, rtol, atol, max_steps, ws, bs, z0, dlogp0, t0, t1, dt_init,
                                    ys=None):
    """Wide K7 TEST's COND instance: the TEST solve by basis push
    (`run_wide_test_solve_kernel`) of a conditional chain past the narrow
    widths whose first layer reads [z | ys], ys (B, n_cond) constant over
    the solve (the 3- and 4-layer chains; `make_full_solve` gives 2-layer
    tanh nets wide K3's COND instance); the push reads W0's z rows only;
    arguments and returns as `run_solve_kernel` with ys.

    CUDA tensors go through the kernel (`csrc/k7_wide_solve.cu`'s
    `k7_wide_cond_solve<1>`), CPU tensors through its plain version."""
    _no_grad_inputs("K7", ws, bs, z0, dlogp0, ys)
    if z0.device.type == "cpu":
        return solve_test_plain(
            tab, spec, rtol=rtol, atol=atol, max_steps=max_steps, ws=ws, bs=bs,
            z0=z0, dlogp0=dlogp0, t0=t0, t1=t1, dt_init=dt_init, ys=ys,
        )
    _cuda_only("wide K7", z0, tab, spec, chain=True, wide=True, cond=True)
    out = _launch_wide_forward(
        "wide K7 TEST COND", K7W_KERNEL, "cnf_k7w_cond_test_solve", "cnf_k7wc_test_shape", tab, spec, rtol=rtol,
        atol=atol, max_steps=max_steps, ws=ws, bs=bs, z0=z0, acc0=dlogp0, t0=t0, t1=t1, dt_init=dt_init, ys=ys,
    )
    run_wide_cond_test_solve_kernel.launches += 1
    return out


run_wide_cond_test_solve_kernel.launches = 0


def run_wide_cond_exact_solve_kernel(
    tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, z0, acc0, t0, t1, dt_init, ys=None
):
    """Wide K7 exact's COND instance: the exact TRAIN solve by basis push
    (`run_wide_exact_solve_kernel`) of a conditional chain past the narrow
    widths, 2-layer tanh nets past MAX_DZ included (CondRNODE at the HEPMASS
    width, whose exact gradient runs the wide K4 adjoint's COND instance;
    deeper chains' runs the plain BACKSOLVE); arguments and returns as
    `run_exact_solve_kernel` with ys (B, n_cond).

    CUDA tensors go through the kernel (`csrc/k7_wide_solve.cu`'s
    `k7_wide_cond_solve<3>`), CPU tensors through its plain version."""
    _no_grad_inputs("K7", ws, bs, z0, acc0, ys)
    if z0.device.type == "cpu":
        return solve_train_exact_plain(
            tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol, max_steps=max_steps,
            ws=ws, bs=bs, z0=z0, acc0=acc0, t0=t0, t1=t1, dt_init=dt_init, ys=ys,
        )
    _cuda_only("wide K7", z0, tab, spec, chain=True, wide=True, cond=True)
    out = _launch_wide_forward(
        "wide K7 exact COND", K7W_KERNEL, "cnf_k7w_cond_exact_solve", "cnf_k7wc_exact_shape", tab, spec, rtol=rtol,
        atol=atol, max_steps=max_steps, ws=ws, bs=bs, z0=z0, acc0=acc0, t0=t0, t1=t1, dt_init=dt_init,
        norms=(norm_z, norm_j), ys=ys,
    )
    run_wide_cond_exact_solve_kernel.launches += 1
    return out


run_wide_cond_exact_solve_kernel.launches = 0


def run_wide_cond_exact_adjoint_kernel(
    tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, zT, accT, azT, aaccT,
    t_hi, t_lo, dt_init, ys=None,
):
    """The wide K4 adjoint's COND instance: the exact backsolve of (z, acc,
    a_z, a_acc, a_ys, g_p, g_pm) (`run_wide_exact_adjoint_kernel`) of a
    conditional 2-layer tanh net past MAX_DZ whose W1 reads [z | ys]
    (CondRNODE at the HEPMASS width), the per-sample a_ys integrated from 0
    at t_hi in the one batch-global error norm; g_pm (over W1's z rows) is
    chained into W1's z rows and W2, W1's ys rows get ys (x) ct_pre1 alone;
    arguments as `run_exact_adjoint_kernel` with ys (B, n_cond), returns
    (z0, acc0, a_z0, g_ws, g_bs, steps, accepted, a_ys0).

    CUDA tensors go through the kernel (`csrc/k4_wide_adjoint.cu`'s
    `k4_wide_cond_adjoint`), CPU tensors through its plain version."""
    if not _two_layer_tanh(spec):
        raise ValueError(_NO_EXACT_CHAIN_ADJOINT)
    _no_grad_inputs("K4", ws, bs, zT, accT, azT, aaccT, ys)
    if zT.device.type == "cpu":
        return adjoint_train_exact_plain(
            tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol, max_steps=max_steps,
            ws=ws, bs=bs, zT=zT, accT=accT, azT=azT, aaccT=aaccT, t_hi=t_hi, t_lo=t_lo, dt_init=dt_init, ys=ys,
        )
    _cuda_only_wide_two_layer("the wide K4 adjoint", zT, tab, spec, cond=True)
    if dt_init is None:
        raise ValueError("the wide K4 adjoint needs dt_init (the caller picks it)")
    out = _launch_wide_exact_adjoint(tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol,
                                     max_steps=max_steps, ws=ws, bs=bs, zT=zT, accT=accT, azT=azT, aaccT=aaccT,
                                     t_hi=t_hi, t_lo=t_lo, dt_init=dt_init, ys=ys)
    run_wide_cond_exact_adjoint_kernel.launches += 1
    return out


run_wide_cond_exact_adjoint_kernel.launches = 0


# ---- the chain kernels' streamed forms (weights past the wide forms' shared memory) ----


def run_stream_test_solve_kernel(tab, spec, *, rtol, atol, max_steps, ws, bs, z0, dlogp0, t0, t1, dt_init,
                                 ys=None):
    """Streamed K7 TEST: K7 TEST's solve (`run_chain_test_solve_kernel`)
    for the unconditional chains the wide forms refuse for their hidden
    widths or their weights' shared memory (`_stream_chain`: FFJORD's
    MINIBOONE model 43 -> 860 -> 860 -> 43), 2-layer tanh nets past MAX_DZ
    included; arguments and returns as `run_solve_kernel`.

    CUDA tensors go through the kernel (`csrc/k7_stream_solve.cu`), CPU
    tensors through its plain version; on the card a conditional chain raises
    (its COND instance, `run_stream_cond_test_solve_kernel`, takes it)."""
    _no_grad_inputs("K7", ws, bs, z0, dlogp0, ys)
    if z0.device.type == "cpu":
        return solve_test_plain(
            tab, spec, rtol=rtol, atol=atol, max_steps=max_steps, ws=ws, bs=bs,
            z0=z0, dlogp0=dlogp0, t0=t0, t1=t1, dt_init=dt_init, ys=ys,
        )
    _cuda_only("streamed K7", z0, tab, spec, chain=True, stream=True)
    out = _launch_wide_forward(
        "streamed K7 TEST", K7S_KERNEL, "cnf_k7s_test_solve", "cnf_k7s_test_shape", tab, spec, rtol=rtol,
        atol=atol, max_steps=max_steps, ws=ws, bs=bs, z0=z0, acc0=dlogp0, t0=t0, t1=t1, dt_init=dt_init,
        stream=True,
    )
    run_stream_test_solve_kernel.launches += 1
    return out


run_stream_test_solve_kernel.launches = 0


def run_stream_exact_solve_kernel(
    tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, z0, acc0, t0, t1, dt_init, ys=None
):
    """Streamed K7 exact: K7 exact's solve (`run_chain_exact_solve_kernel`)
    for the streamed chains; arguments and returns as
    `run_exact_solve_kernel`.

    CUDA tensors go through the kernel (`csrc/k7_stream_solve.cu`), CPU
    tensors through its plain version; on the card a conditional chain raises
    (its COND instance, `run_stream_cond_exact_solve_kernel`, takes it)."""
    _no_grad_inputs("K7", ws, bs, z0, acc0, ys)
    if z0.device.type == "cpu":
        return solve_train_exact_plain(
            tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol, max_steps=max_steps,
            ws=ws, bs=bs, z0=z0, acc0=acc0, t0=t0, t1=t1, dt_init=dt_init, ys=ys,
        )
    _cuda_only("streamed K7", z0, tab, spec, chain=True, stream=True)
    out = _launch_wide_forward(
        "streamed K7 exact", K7S_KERNEL, "cnf_k7s_exact_solve", "cnf_k7s_exact_shape", tab, spec, rtol=rtol,
        atol=atol, max_steps=max_steps, ws=ws, bs=bs, z0=z0, acc0=acc0, t0=t0, t1=t1, dt_init=dt_init,
        norms=(norm_z, norm_j), stream=True,
    )
    run_stream_exact_solve_kernel.launches += 1
    return out


run_stream_exact_solve_kernel.launches = 0


def run_stream_train_solve_kernel(
    tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, z0, eps, acc0, t0, t1, dt_init, ys=None,
    jvp=False,
):
    """The streamed K1 chain form: the K1 chain form's solve
    (`run_chain_train_solve_kernel`) for the streamed chains (with K probes
    or JVP also the chains only the streamed probe instances keep,
    `_stream_chain(spec, True)`); arguments and returns as
    `run_train_solve_kernel`.

    CUDA tensors go through the kernel (`csrc/k1_stream_solve.cu`: one VJP
    probe in its first instance, any other probes in its probe instance,
    K6), CPU tensors through its plain version."""
    _no_grad_inputs("K1", ws, bs, z0, eps, acc0, ys)
    if z0.device.type == "cpu":
        return solve_train_plain(
            tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol, max_steps=max_steps,
            ws=ws, bs=bs, z0=z0, eps=eps, acc0=acc0, t0=t0, t1=t1, dt_init=dt_init, ys=ys, jvp=jvp,
        )
    _cuda_only("streamed K1", z0, tab, spec, eps.shape[0], chain=True, jvp=jvp, stream=True)
    probes = _probe_instance(eps, jvp)
    out = _launch_wide_forward(
        "streamed K1 chain form", K1S_KERNEL, "cnf_k1s_probe_solve" if probes else "cnf_k1s_train_solve",
        "cnf_k1sp_shape" if probes else "cnf_k1s_shape", tab, spec, rtol=rtol, atol=atol, max_steps=max_steps,
        ws=ws, bs=bs, z0=z0, acc0=acc0, t0=t0, t1=t1, dt_init=dt_init, eps=eps,
        norms=(norm_z, norm_j) + ((eps.shape[0], jvp) if probes else ()), stream=True,
    )
    _count(run_stream_train_solve_kernel, eps, jvp)
    return out


run_stream_train_solve_kernel.launches = 0
run_stream_train_solve_kernel.probe_launches = {}


def _launch_stream_adjoint(tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, eps, zT, accT, azT, aaccT,
                           t_hi, t_lo, dt_init, jvp=False, ys=None):
    """Launch the streamed K2 chain form: its one-probe instance, its probe
    instance (K probes or JVP, K6) or, given ys (B, n_cond), its COND
    instance (K8) or probe COND instance (K6 x K8), which return a_ys0
    (B, n_cond) last.  The shape entry and the entry are picked by the
    conditioning and the probes together."""
    label = "streamed K2 chain form"
    B, dz = zT.shape
    K, nc = eps.shape[0], spec.n_cond if ys is not None else 0
    device = zT.device
    params, widths = _chain_params(label, spec, ws, bs, device)
    e0, zT, accT, azT, aaccT = _check_inputs(
        label, device, [eps, zT, accT, azT, aaccT], [(K, B, dz), (B, dz), (3, B), (B, dz), (3, B)]
    )
    lib = _library(K2S_KERNEL, spec)
    probes = _probe_instance(eps, jvp)
    shape = {(True, True): "cnf_k2spc_shape", (True, False): "cnf_k2sc_shape", (False, True): "cnf_k2sp_shape",
             (False, False): "cnf_k2s_shape"}[(bool(nc), probes)]
    block, grid, tile, tiles = _stream_shape(lib, shape, label, spec, widths, B, device)
    ts = torch.stack([t_hi, t_lo, dt_init]).to(device=device, dtype=torch.float32)
    z0, acc0, az0, g, gnew, stats, work, partials, gblk = _wide_adjoint_buffers(tab, zT, accT, grid, params.numel(),
                                                                                nc)
    tail = (B, spec.n_layers, widths, _acts_mask(spec), int(max_steps), int(norm_z), int(norm_j),
            *([K, int(jvp)] if probes else []), rtol, atol, *_controller_floats(tab), _tableau_array(tab), tile, grid,
            block, _stream(device))
    if nc:
        ys = _cond_rows(label, spec, ys, B, device)
        ays0 = torch.empty((B, nc), dtype=torch.float32, device=device)
        entry = lib.cnf_k2s_probe_cond_adjoint if probes else lib.cnf_k2s_cond_adjoint
        err = entry(
            _ptr(params), _ptr(e0), _ptr(ys), _ptr(zT), _ptr(accT), _ptr(azT), _ptr(aaccT), _ptr(ts), _ptr(z0),
            _ptr(acc0), _ptr(az0), _ptr(ays0), _ptr(g), _ptr(stats), _ptr(work), _ptr(partials), _ptr(gblk),
            _ptr(gnew), _ptr_or_null(tiles), *tail,
        )
    else:
        entry = lib.cnf_k2s_probe_adjoint if probes else lib.cnf_k2s_train_adjoint
        err = entry(
            _ptr(params), _ptr(e0), _ptr(zT), _ptr(accT), _ptr(azT), _ptr(aaccT), _ptr(ts), _ptr(z0), _ptr(acc0),
            _ptr(az0), _ptr(g), _ptr(stats), _ptr(work), _ptr(partials), _ptr(gblk), _ptr(gnew), _ptr_or_null(tiles),
            *tail,
        )
    _check_launch(err, label, grid, block)
    g_ws, g_bs = _split_params(g, spec)
    return (z0, acc0, az0, g_ws, g_bs, stats[0], stats[1]) + ((ays0,) if nc else ())


def run_stream_adjoint_kernel(
    tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, eps, zT, accT, azT, aaccT,
    t_hi, t_lo, dt_init, ys=None, jvp=False,
):
    """The streamed K2 chain form: the K2 chain form's backsolve
    (`run_chain_adjoint_kernel`) for the chains `run_stream_train_solve_kernel`
    takes; arguments and returns as `run_adjoint_kernel`.

    CUDA tensors go through the kernel (`csrc/k2_stream_adjoint.cu`: one VJP
    probe in its first instance, any other probes in its probe instance,
    K6), CPU tensors through its plain version."""
    _no_grad_inputs("K2", ws, bs, eps, zT, accT, azT, aaccT, ys)
    if zT.device.type == "cpu":
        return adjoint_train_plain(
            tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol, max_steps=max_steps,
            ws=ws, bs=bs, eps=eps, zT=zT, accT=accT, azT=azT, aaccT=aaccT,
            t_hi=t_hi, t_lo=t_lo, dt_init=dt_init, ys=ys, jvp=jvp,
        )
    _cuda_only("streamed K2", zT, tab, spec, eps.shape[0], chain=True, jvp=jvp, stream=True)
    if dt_init is None:
        raise ValueError("the streamed K2 chain form needs dt_init (the caller picks it)")
    out = _launch_stream_adjoint(tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol, max_steps=max_steps,
                                 ws=ws, bs=bs, eps=eps, zT=zT, accT=accT, azT=azT, aaccT=aaccT, t_hi=t_hi,
                                 t_lo=t_lo, dt_init=dt_init, jvp=jvp)
    _count(run_stream_adjoint_kernel, eps, jvp)
    return out


run_stream_adjoint_kernel.launches = 0
run_stream_adjoint_kernel.probe_launches = {}


# ---- the 2-layer TEST kernels' streamed forms (2-layer tanh nets past the wide limits) ----


def run_stream_test2_solve_kernel(tab, spec, *, rtol, atol, max_steps, ws, bs, z0, dlogp0, t0, t1, dt_init,
                                  ys=None):
    """Streamed K3: K3's TEST solve with the closed-form trace
    (`run_solve_kernel`) for the unconditional 2-layer tanh nets past the
    wide 2-layer kernels' limits (`_stream_two_layer`: the README net family
    at the MINIBOONE width, 86 -> 258 -> 86); arguments and returns as
    `run_solve_kernel`.

    CUDA tensors go through the kernel (`csrc/k3_stream_solve.cu`), CPU
    tensors through its plain version."""
    _no_grad_inputs("K3", ws, bs, z0, dlogp0, ys)
    if z0.device.type == "cpu":
        return solve_test_plain(
            tab, spec, rtol=rtol, atol=atol, max_steps=max_steps, ws=ws, bs=bs,
            z0=z0, dlogp0=dlogp0, t0=t0, t1=t1, dt_init=dt_init, ys=ys,
        )
    _cuda_only_wide_two_layer("streamed K3", z0, tab, spec, stream=True)
    out = _launch_wide_forward(
        "streamed K3", K3S_KERNEL, "cnf_k3s_test_solve", "cnf_k3s_shape", tab, spec, rtol=rtol, atol=atol,
        max_steps=max_steps, ws=ws, bs=bs, z0=z0, acc0=dlogp0, t0=t0, t1=t1, dt_init=dt_init, stream=True, m=True,
    )
    run_stream_test2_solve_kernel.launches += 1
    return out


run_stream_test2_solve_kernel.launches = 0


def _launch_stream_test_adjoint(tab, spec, *, rtol, atol, max_steps, ws, bs, zT, accT, azT, aaccT, t_hi, t_lo,
                                dt_init, ys=None):
    """Launch streamed K5: its unconditional instance or, given ys
    (B, n_cond), its COND instance (K8), which returns a_ys0 (B, n_cond)
    last."""
    label = "streamed K5"
    B, dz = zT.shape
    nc = spec.n_cond if ys is not None else 0
    device = zT.device
    params, widths = _chain_params(label, spec, ws, bs, device)
    zT, accT, azT, aaccT = _check_inputs(label, device, [zT, accT, azT, aaccT], [(B, dz), (1, B), (B, dz), (1, B)])
    lib = _library(K5S_KERNEL)
    block, grid, tile, tiles = _stream_shape(lib, "cnf_k5sc_shape" if nc else "cnf_k5s_shape", label, spec, widths, B,
                                             device)
    ts = torch.stack([t_hi, t_lo, dt_init]).to(device=device, dtype=torch.float32)
    z0, acc0, az0, g, gnew, stats, work, partials, gblk = _wide_adjoint_buffers(tab, zT, accT, grid, params.numel(),
                                                                                nc)
    m = _m_scratch(spec, device)
    tail = (B, spec.n_layers, widths, _acts_mask(spec), int(max_steps), rtol, atol, *_controller_floats(tab),
            _tableau_array(tab), tile, grid, block, _stream(device))
    if nc:
        ys = _cond_rows(label, spec, ys, B, device)
        ays0 = torch.empty((B, nc), dtype=torch.float32, device=device)
        err = lib.cnf_k5s_cond_adjoint(
            _ptr(params), _ptr(ys), _ptr(zT), _ptr(accT), _ptr(azT), _ptr(aaccT), _ptr(ts), _ptr(z0), _ptr(acc0),
            _ptr(az0), _ptr(ays0), _ptr(g), _ptr(stats), _ptr(work), _ptr(partials), _ptr(gblk), _ptr(gnew), _ptr(m),
            _ptr_or_null(tiles), *tail,
        )
    else:
        err = lib.cnf_k5s_test_adjoint(
            _ptr(params), _ptr(zT), _ptr(accT), _ptr(azT), _ptr(aaccT), _ptr(ts), _ptr(z0), _ptr(acc0), _ptr(az0),
            _ptr(g), _ptr(stats), _ptr(work), _ptr(partials), _ptr(gblk), _ptr(gnew), _ptr(m), _ptr_or_null(tiles),
            *tail,
        )
    _check_launch(err, label, grid, block)
    g_ws, g_bs = _split_params(g, spec)
    return (z0, acc0, az0, g_ws, g_bs, stats[0], stats[1]) + ((ays0,) if nc else ())


def run_stream_test_adjoint_kernel(tab, spec, *, rtol, atol, max_steps, ws, bs, zT, accT, azT, aaccT, t_hi, t_lo,
                                   dt_init, ys=None):
    """Streamed K5: K5's TEST backsolve (`run_test_adjoint_kernel`, ct_m
    folded into g) for the unconditional 2-layer tanh nets streamed K3
    takes; arguments and returns as `run_test_adjoint_kernel`.

    CUDA tensors go through the kernel (`csrc/k5_stream_adjoint.cu`), CPU
    tensors through its plain version (with ys (B, n_cond), a_ys0 is
    returned last)."""
    if not _two_layer_tanh(spec):
        raise ValueError(_NO_TEST_CHAIN_ADJOINT)
    _no_grad_inputs("K5", ws, bs, zT, accT, azT, aaccT, ys)
    if zT.device.type == "cpu":
        return adjoint_test_plain(tab, spec, rtol=rtol, atol=atol, max_steps=max_steps, ws=ws, bs=bs, zT=zT,
                                  accT=accT, azT=azT, aaccT=aaccT, t_hi=t_hi, t_lo=t_lo, dt_init=dt_init, ys=ys)
    _cuda_only_wide_two_layer("streamed K5", zT, tab, spec, stream=True)
    if dt_init is None:
        raise ValueError("streamed K5 needs dt_init (the caller picks it)")
    out = _launch_stream_test_adjoint(tab, spec, rtol=rtol, atol=atol, max_steps=max_steps, ws=ws, bs=bs, zT=zT,
                                      accT=accT, azT=azT, aaccT=aaccT, t_hi=t_hi, t_lo=t_lo, dt_init=dt_init)
    run_stream_test_adjoint_kernel.launches += 1
    return out


run_stream_test_adjoint_kernel.launches = 0


def _stream_exact_covers(tab: ButcherTableau, spec: ChainSpec) -> Optional[str]:
    """Why the streamed K4 adjoint does not run this configuration (None if
    it does): it takes the nets streamed K3 and K5 take
    (`_stream_two_layer_covers`) under every embedded tableau, conditional
    ones in its COND instance, while its gradient with g_pm (P + dz^2 H
    floats, P counting W1's ys rows) keeps 32-bit offsets."""
    why = _stream_two_layer_covers(tab, spec)
    if why is not None:
        return why
    dz, H = spec.dz, spec.out_dims[0]
    total = _param_count(spec) + dz * dz * H
    if total > STREAM_MAX_PARAMS:
        return (f"{total} gradient entries with g_pm in the streamed K4 adjoint (its offsets are 32-bit ints, up to "
                f"{STREAM_MAX_PARAMS}; ROADMAP queue 2, shape variants (e))")
    return None


def _cuda_only_stream_exact(label: str, x: torch.Tensor, tab, spec, cond: bool = False) -> None:
    """Raise unless the streamed K4 adjoint (`_stream_exact_covers`) takes
    the configuration on CUDA tensors: conditional nets in its COND instance
    (`cond`), unconditional ones in the other."""
    if x.device.type != "cuda":
        raise ValueError(f"{label} runs on CUDA or CPU tensors, got {x.device}")
    why = _stream_exact_covers(tab, spec)
    if why is None and spec.n_cond and not cond:
        why = f"conditional nets in the unconditional instance of {label} (its COND instance takes them)"
    if why is None and cond and not spec.n_cond:
        why = f"unconditional nets in the COND instance of {label} (its unconditional instance takes them)"
    if why is not None:
        raise NotImplementedError(f"the CUDA solve kernels do not cover {why}")


def _launch_stream_exact_adjoint(tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, zT, accT, azT, aaccT,
                                 t_hi, t_lo, dt_init, ys=None):
    """Launch the streamed K4 adjoint: its unconditional instance or, given
    ys (B, n_cond), its COND instance (K8), which returns a_ys0 (B, n_cond)
    last.  g_pm, over W1's z rows, is chained into them and W2 after the
    launch; W1's ys rows get none (the JAX package's :1787-1799)."""
    label = "streamed K4 adjoint"
    B, dz = zT.shape
    H = spec.out_dims[0]
    nc = spec.n_cond if ys is not None else 0
    device = zT.device
    params, widths = _chain_params(label, spec, ws, bs, device)
    zT, accT, azT, aaccT = _check_inputs(label, device, [zT, accT, azT, aaccT], [(B, dz), (3, B), (B, dz), (3, B)])
    lib = _library(K4SA_KERNEL)
    block, grid, T, tiles = _stream_shape(lib, "cnf_k4sc_shape" if nc else "cnf_k4s_shape", label, spec, widths, B,
                                          device)
    P = params.numel()
    Pt = P + dz * dz * H
    f32 = dict(dtype=torch.float32, device=device)
    ts = torch.stack([t_hi, t_lo, dt_init]).to(**f32)
    z0, acc0, az0 = torch.empty_like(zT), torch.empty_like(accT), torch.empty_like(zT)
    g, gnew = torch.empty(Pt, **f32), torch.empty(Pt, **f32)
    stats = torch.empty(2, dtype=torch.int32, device=device)
    work = torch.empty((tab.num_stages + 2) * (2 * dz + 3 + nc) * B, **f32)
    partials = torch.empty(10 * grid, **f32)
    gvec = torch.empty((_gvecs(tab) + 2) * Pt, **f32)
    fac = torch.empty(B * (dz * dz + 3 * H + 2 * dz + nc + 2), **f32)
    w2t = torch.empty(dz * H, **f32)
    tail = (_ptr(g), _ptr(stats), _ptr(work), _ptr(partials), _ptr(gvec), _ptr(gnew), _ptr(fac), _ptr_or_null(tiles),
            _ptr(w2t), B, spec.n_layers, widths, _acts_mask(spec), int(max_steps), int(norm_z), int(norm_j), rtol,
            atol, *_controller_floats(tab), _tableau_array(tab), T, grid, block, _stream(device))
    if nc:
        ys = _cond_rows(label, spec, ys, B, device)
        ays0 = torch.empty((B, nc), **f32)
        err = lib.cnf_k4s_cond_exact_adjoint(
            _ptr(params), _ptr(ys), _ptr(zT), _ptr(accT), _ptr(azT), _ptr(aaccT), _ptr(ts), _ptr(z0), _ptr(acc0),
            _ptr(az0), _ptr(ays0), *tail,
        )
    else:
        err = lib.cnf_k4s_exact_adjoint(
            _ptr(params), _ptr(zT), _ptr(accT), _ptr(azT), _ptr(aaccT), _ptr(ts), _ptr(z0), _ptr(acc0), _ptr(az0),
            *tail,
        )
    _check_launch(err, label, grid, block)
    g_ws, g_bs = _split_params(g[:P], spec)
    g_w1, g_w2 = exact_pm_chain(g[P:].view(dz * dz, H), ws[0][:dz], ws[1])
    g_ws = [g_ws[0] + _pad_rows(g_w1, g_ws[0].shape[0]), g_ws[1] + g_w2]
    return (z0, acc0, az0, g_ws, g_bs, stats[0], stats[1]) + ((ays0,) if nc else ())


def run_stream_exact_adjoint_kernel(
    tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, zT, accT, azT, aaccT,
    t_hi, t_lo, dt_init, ys=None,
):
    """The streamed K4 adjoint: the K4 adjoint's exact backsolve with g_pm
    in the state and in the error norm (`run_exact_adjoint_kernel`) for the
    unconditional 2-layer tanh nets streamed K3 takes (the README net family
    at the MINIBOONE and BSDS300 widths); arguments and returns as
    `run_exact_adjoint_kernel`, g_pm chained into g_w1 and g_w2.

    CUDA tensors go through the kernel (`csrc/k4_stream_adjoint.cu`: each
    stage's per-sample pass, then the batch-summed gradient rate as
    slice-owned contractions over the whole batch), CPU tensors through its
    plain version (with ys (B, n_cond), a_ys0 is returned last)."""
    if not _two_layer_tanh(spec):
        raise ValueError(_NO_EXACT_CHAIN_ADJOINT)
    _no_grad_inputs("K4", ws, bs, zT, accT, azT, aaccT, ys)
    if zT.device.type == "cpu":
        return adjoint_train_exact_plain(
            tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol, max_steps=max_steps,
            ws=ws, bs=bs, zT=zT, accT=accT, azT=azT, aaccT=aaccT, t_hi=t_hi, t_lo=t_lo, dt_init=dt_init, ys=ys,
        )
    _cuda_only_stream_exact("the streamed K4 adjoint", zT, tab, spec)
    if dt_init is None:
        raise ValueError("the streamed K4 adjoint needs dt_init (the caller picks it)")
    out = _launch_stream_exact_adjoint(tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol,
                                       max_steps=max_steps, ws=ws, bs=bs, zT=zT, accT=accT, azT=azT, aaccT=aaccT,
                                       t_hi=t_hi, t_lo=t_lo, dt_init=dt_init)
    run_stream_exact_adjoint_kernel.launches += 1
    return out


run_stream_exact_adjoint_kernel.launches = 0


# ---- the COND instances of the streamed forms (K8: conditional nets past the wide limits) ----


def run_stream_cond_train_solve_kernel(
    tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, z0, eps, acc0, t0, t1, dt_init, ys=None,
    jvp=False,
):
    """The streamed K1 chain form's COND instance: the Hutchinson TRAIN
    solve (`run_stream_train_solve_kernel`) of a conditional chain past the
    wide limits whose first layer reads [z | ys], ys (B, n_cond) constant
    over the solve (CondRNODE at the MINIBOONE width, 87 -> 258 -> 86, one
    ys column); one VJP probe, or K VJP or JVP probes in its probe COND
    instance (K6 x K8); arguments and returns as `run_train_solve_kernel`.

    CUDA tensors go through the kernel (`csrc/k1_stream_solve.cu`'s
    `k1_stream_cond_solve`, or `k1_stream_probe_cond_solve` with K probes
    or JVP), CPU tensors through its plain version."""
    _no_grad_inputs("K1", ws, bs, z0, eps, acc0, ys)
    if z0.device.type == "cpu":
        return solve_train_plain(
            tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol, max_steps=max_steps,
            ws=ws, bs=bs, z0=z0, eps=eps, acc0=acc0, t0=t0, t1=t1, dt_init=dt_init, ys=ys, jvp=jvp,
        )
    _cuda_only("streamed K1 COND", z0, tab, spec, eps.shape[0], chain=True, jvp=jvp, stream=True, cond=True)
    probes = _probe_instance(eps, jvp)
    out = _launch_wide_forward(
        "streamed K1 chain form COND", K1S_KERNEL, "cnf_k1s_probe_cond_solve" if probes else "cnf_k1s_cond_solve",
        "cnf_k1spc_shape" if probes else "cnf_k1sc_shape", tab, spec, rtol=rtol, atol=atol, max_steps=max_steps,
        ws=ws, bs=bs, z0=z0, acc0=acc0, t0=t0, t1=t1, dt_init=dt_init, eps=eps,
        norms=(norm_z, norm_j) + ((eps.shape[0], jvp) if probes else ()), stream=True, ys=ys,
    )
    _count(run_stream_cond_train_solve_kernel, eps, jvp)
    return out


run_stream_cond_train_solve_kernel.launches = 0
run_stream_cond_train_solve_kernel.probe_launches = {}


def run_stream_cond_adjoint_kernel(
    tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, eps, zT, accT, azT, aaccT,
    t_hi, t_lo, dt_init, ys=None, jvp=False,
):
    """The streamed K2 chain form's COND instance: the backsolve of (z, acc,
    a_z, a_acc, a_ys, g_p) (`run_stream_adjoint_kernel`) of the conditional
    chains `run_stream_cond_train_solve_kernel` takes, the per-sample a_ys
    integrated from 0 at t_hi in the one batch-global error norm; one VJP
    probe, or K VJP or JVP probes in its probe COND instance (K6 x K8);
    arguments as `run_adjoint_kernel` with ys (B, n_cond), returns (z0,
    acc0, a_z0, g_ws, g_bs, steps, accepted, a_ys0).

    CUDA tensors go through the kernel (`csrc/k2_stream_adjoint.cu`'s
    `k2_stream_cond_adjoint`, or `k2_stream_probe_cond_adjoint` with K
    probes or JVP), CPU tensors through its plain version."""
    _no_grad_inputs("K2", ws, bs, eps, zT, accT, azT, aaccT, ys)
    if zT.device.type == "cpu":
        return adjoint_train_plain(
            tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol, max_steps=max_steps,
            ws=ws, bs=bs, eps=eps, zT=zT, accT=accT, azT=azT, aaccT=aaccT,
            t_hi=t_hi, t_lo=t_lo, dt_init=dt_init, ys=ys, jvp=jvp,
        )
    _cuda_only("streamed K2 COND", zT, tab, spec, eps.shape[0], chain=True, jvp=jvp, stream=True, cond=True)
    if dt_init is None:
        raise ValueError("the streamed K2 chain form needs dt_init (the caller picks it)")
    out = _launch_stream_adjoint(tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol, max_steps=max_steps,
                                 ws=ws, bs=bs, eps=eps, zT=zT, accT=accT, azT=azT, aaccT=aaccT, t_hi=t_hi,
                                 t_lo=t_lo, dt_init=dt_init, jvp=jvp, ys=ys)
    _count(run_stream_cond_adjoint_kernel, eps, jvp)
    return out


run_stream_cond_adjoint_kernel.launches = 0
run_stream_cond_adjoint_kernel.probe_launches = {}


def run_stream_cond_test2_solve_kernel(tab, spec, *, rtol, atol, max_steps, ws, bs, z0, dlogp0, t0, t1, dt_init,
                                       ys=None):
    """Streamed K3's COND instance: the closed-form TEST solve
    (`run_stream_test2_solve_kernel`) of a conditional 2-layer tanh net past
    the wide limits whose W1 reads [z | ys] (CondRNODE at the MINIBOONE
    width); M and the trace read W1's z rows only; arguments and returns as
    `run_solve_kernel` with ys (B, n_cond).

    CUDA tensors go through the kernel (`csrc/k3_stream_solve.cu`'s
    `k3_stream_cond_solve`), CPU tensors through its plain version."""
    _no_grad_inputs("K3", ws, bs, z0, dlogp0, ys)
    if z0.device.type == "cpu":
        return solve_test_plain(
            tab, spec, rtol=rtol, atol=atol, max_steps=max_steps, ws=ws, bs=bs,
            z0=z0, dlogp0=dlogp0, t0=t0, t1=t1, dt_init=dt_init, ys=ys,
        )
    _cuda_only_wide_two_layer("streamed K3", z0, tab, spec, stream=True, cond=True)
    out = _launch_wide_forward(
        "streamed K3 COND", K3S_KERNEL, "cnf_k3s_cond_solve", "cnf_k3sc_shape", tab, spec, rtol=rtol, atol=atol,
        max_steps=max_steps, ws=ws, bs=bs, z0=z0, acc0=dlogp0, t0=t0, t1=t1, dt_init=dt_init, stream=True, m=True,
        ys=ys,
    )
    run_stream_cond_test2_solve_kernel.launches += 1
    return out


run_stream_cond_test2_solve_kernel.launches = 0


def run_stream_cond_test_adjoint_kernel(tab, spec, *, rtol, atol, max_steps, ws, bs, zT, accT, azT, aaccT, t_hi,
                                        t_lo, dt_init, ys=None):
    """Streamed K5's COND instance: the TEST backsolve
    (`run_stream_test_adjoint_kernel`, ct_m folded into g over W1's z rows)
    of the conditional 2-layer tanh nets streamed K3's COND instance takes,
    the per-sample a_ys integrated from 0 at t_hi in the one batch-global
    error norm; arguments as `run_test_adjoint_kernel` with ys (B, n_cond),
    returns (z0, acc0, a_z0, g_ws, g_bs, steps, accepted, a_ys0).

    CUDA tensors go through the kernel (`csrc/k5_stream_adjoint.cu`'s
    `k5_stream_cond_adjoint`), CPU tensors through its plain version."""
    if not _two_layer_tanh(spec):
        raise ValueError(_NO_TEST_CHAIN_ADJOINT)
    _no_grad_inputs("K5", ws, bs, zT, accT, azT, aaccT, ys)
    if zT.device.type == "cpu":
        return adjoint_test_plain(tab, spec, rtol=rtol, atol=atol, max_steps=max_steps, ws=ws, bs=bs, zT=zT,
                                  accT=accT, azT=azT, aaccT=aaccT, t_hi=t_hi, t_lo=t_lo, dt_init=dt_init, ys=ys)
    _cuda_only_wide_two_layer("streamed K5", zT, tab, spec, stream=True, cond=True)
    if dt_init is None:
        raise ValueError("streamed K5 needs dt_init (the caller picks it)")
    out = _launch_stream_test_adjoint(tab, spec, rtol=rtol, atol=atol, max_steps=max_steps, ws=ws, bs=bs, zT=zT,
                                      accT=accT, azT=azT, aaccT=aaccT, t_hi=t_hi, t_lo=t_lo, dt_init=dt_init, ys=ys)
    run_stream_cond_test_adjoint_kernel.launches += 1
    return out


run_stream_cond_test_adjoint_kernel.launches = 0


def run_stream_cond_test_solve_kernel(tab, spec, *, rtol, atol, max_steps, ws, bs, z0, dlogp0, t0, t1, dt_init,
                                      ys=None):
    """Streamed K7 TEST's COND instance: the TEST solve by basis push
    (`run_stream_test_solve_kernel`) of a conditional chain past the wide
    limits whose first layer reads [z | ys], ys (B, n_cond) constant over
    the solve (a conditional FFJORD-MINIBOONE chain 44 -> 860 -> 860 -> 43;
    `make_full_solve` gives 2-layer tanh nets streamed K3's COND instance);
    the push reads W0's z rows only; arguments and returns as
    `run_solve_kernel` with ys.

    CUDA tensors go through the kernel (`csrc/k7_stream_solve.cu`'s
    `k7_stream_cond_solve<1>`), CPU tensors through its plain version."""
    _no_grad_inputs("K7", ws, bs, z0, dlogp0, ys)
    if z0.device.type == "cpu":
        return solve_test_plain(
            tab, spec, rtol=rtol, atol=atol, max_steps=max_steps, ws=ws, bs=bs,
            z0=z0, dlogp0=dlogp0, t0=t0, t1=t1, dt_init=dt_init, ys=ys,
        )
    _cuda_only("streamed K7", z0, tab, spec, chain=True, stream=True, cond=True)
    out = _launch_wide_forward(
        "streamed K7 TEST COND", K7S_KERNEL, "cnf_k7s_cond_test_solve", "cnf_k7sc_test_shape", tab, spec, rtol=rtol,
        atol=atol, max_steps=max_steps, ws=ws, bs=bs, z0=z0, acc0=dlogp0, t0=t0, t1=t1, dt_init=dt_init,
        stream=True, ys=ys,
    )
    run_stream_cond_test_solve_kernel.launches += 1
    return out


run_stream_cond_test_solve_kernel.launches = 0


def run_stream_cond_exact_solve_kernel(
    tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, z0, acc0, t0, t1, dt_init, ys=None
):
    """Streamed K7 exact's COND instance: the exact TRAIN solve by basis push
    (`run_stream_exact_solve_kernel`) of a conditional chain past the wide
    limits, 2-layer tanh nets included (CondRNODE at the MINIBOONE width,
    87 -> 258 -> 86, whose exact gradient runs the streamed K4 adjoint's
    COND instance; deeper chains' runs the plain BACKSOLVE); arguments and
    returns as `run_exact_solve_kernel` with ys (B, n_cond).

    CUDA tensors go through the kernel (`csrc/k7_stream_solve.cu`'s
    `k7_stream_cond_solve<3>`), CPU tensors through its plain version."""
    _no_grad_inputs("K7", ws, bs, z0, acc0, ys)
    if z0.device.type == "cpu":
        return solve_train_exact_plain(
            tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol, max_steps=max_steps,
            ws=ws, bs=bs, z0=z0, acc0=acc0, t0=t0, t1=t1, dt_init=dt_init, ys=ys,
        )
    _cuda_only("streamed K7", z0, tab, spec, chain=True, stream=True, cond=True)
    out = _launch_wide_forward(
        "streamed K7 exact COND", K7S_KERNEL, "cnf_k7s_cond_exact_solve", "cnf_k7sc_exact_shape", tab, spec,
        rtol=rtol, atol=atol, max_steps=max_steps, ws=ws, bs=bs, z0=z0, acc0=acc0, t0=t0, t1=t1, dt_init=dt_init,
        norms=(norm_z, norm_j), stream=True, ys=ys,
    )
    run_stream_cond_exact_solve_kernel.launches += 1
    return out


run_stream_cond_exact_solve_kernel.launches = 0


def run_stream_cond_exact_adjoint_kernel(
    tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, zT, accT, azT, aaccT,
    t_hi, t_lo, dt_init, ys=None,
):
    """The streamed K4 adjoint's COND instance: the exact backsolve of (z,
    acc, a_z, a_acc, a_ys, g_p, g_pm) (`run_stream_exact_adjoint_kernel`) of
    a conditional 2-layer tanh net past the wide limits whose W1 reads
    [z | ys] (CondRNODE at the MINIBOONE width), the per-sample a_ys
    integrated from 0 at t_hi in the one batch-global error norm; g_pm (over
    W1's z rows) is chained into W1's z rows and W2, W1's ys rows get
    ys (x) ct_pre1 alone; arguments as `run_exact_adjoint_kernel` with ys
    (B, n_cond), returns (z0, acc0, a_z0, g_ws, g_bs, steps, accepted,
    a_ys0).

    CUDA tensors go through the kernel (`csrc/k4_stream_adjoint.cu`'s
    `k4_stream_cond_adjoint`), CPU tensors through its plain version."""
    if not _two_layer_tanh(spec):
        raise ValueError(_NO_EXACT_CHAIN_ADJOINT)
    _no_grad_inputs("K4", ws, bs, zT, accT, azT, aaccT, ys)
    if zT.device.type == "cpu":
        return adjoint_train_exact_plain(
            tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol, max_steps=max_steps,
            ws=ws, bs=bs, zT=zT, accT=accT, azT=azT, aaccT=aaccT, t_hi=t_hi, t_lo=t_lo, dt_init=dt_init, ys=ys,
        )
    _cuda_only_stream_exact("the streamed K4 adjoint", zT, tab, spec, cond=True)
    if dt_init is None:
        raise ValueError("the streamed K4 adjoint needs dt_init (the caller picks it)")
    out = _launch_stream_exact_adjoint(tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol,
                                       max_steps=max_steps, ws=ws, bs=bs, zT=zT, accT=accT, azT=azT, aaccT=aaccT,
                                       t_hi=t_hi, t_lo=t_lo, dt_init=dt_init, ys=ys)
    run_stream_cond_exact_adjoint_kernel.launches += 1
    return out


run_stream_cond_exact_adjoint_kernel.launches = 0


# ---- the bf16 kernels (bf16 stage matmuls on the tensor cores) ----

#: The bf16 kernels take unconditional 2-layer tanh nets of state width up
#: to MAX_DZ (padded to 16 or 32) and hidden width up to BF16_MAX_WIDTH
#: (padded to a multiple of 16), with one VJP probe in TRAIN mode.
BF16_MAX_WIDTH = 64
#: The bf16 kernels' block sizes, tried in order: a block is a tile of as
#: many samples, 32 a warp (the tile solves of csrc/solve_common.cuh).
_BF16_BLOCKS = (128, 64)


def _bf16_covers(tab: ButcherTableau, spec: ChainSpec, k_probes: int = 1, jvp: bool = False) -> Optional[str]:
    """Why the bf16 kernels (bf16 K3, K1, K2) do not run this configuration
    (None if they do)."""
    if tab.btilde is None or tab.num_stages > MAX_STAGES:
        return _kernel_covers(tab, spec)
    if spec.n_cond:
        return "conditional nets (K8)"
    if not _two_layer_tanh(spec):
        return (f"{spec.n_layers}-layer chains and chains with an identity layer (the chain forms and K7; the bf16 "
                "kernels take 2-layer tanh nets)")
    if spec.dz > MAX_DZ:
        return f"state width {spec.dz} > {MAX_DZ} (the wide and streamed forms)"
    if spec.out_dims[0] > BF16_MAX_WIDTH:
        return f"hidden width {spec.out_dims[0]} > {BF16_MAX_WIDTH}"
    if k_probes != 1 or jvp:
        return f"{k_probes} {'JVP' if jvp else 'VJP'} probe{'s' if k_probes != 1 else ''} (K6)"
    return None


def _cuda_only_bf16(label: str, x: torch.Tensor, tab, spec, k_probes: int = 1, jvp: bool = False) -> None:
    """Raise unless `label`'s bf16 kernel takes the configuration on CUDA
    tensors: every other configuration under bf16 stage matmuls raises,
    naming BF16_ROW (no f32 kernel stands in: that would change the
    numerics the caller asked for)."""
    if x.device.type != "cuda":
        raise ValueError(f"{label} runs on CUDA or CPU tensors, got {x.device}")
    why = _bf16_covers(tab, spec, k_probes, jvp)
    if why is not None:
        raise NotImplementedError(f"the CUDA bf16 kernels do not cover {why} under bf16 stage matmuls ({BF16_ROW})")


def run_bf16_solve_kernel(tab, spec, *, rtol, atol, max_steps, ws, bs, z0, dlogp0, t0, t1, dt_init, ys=None):
    """bf16 K3: K3's TEST solve (`run_solve_kernel`: arguments and returns)
    with the stage matmuls under bf16 (`_test_stage_bf16`).

    CUDA tensors go through the kernel (`csrc/k3_bf16_solve.cu`), CPU
    tensors through its plain version (2-layer tanh chains, ys (B, n_cond)
    or None)."""
    _no_grad_inputs("bf16 K3", ws, bs, z0, dlogp0, ys)
    if z0.device.type == "cpu":
        return solve_test_plain(
            tab, spec, rtol=rtol, atol=atol, max_steps=max_steps, ws=ws, bs=bs,
            z0=z0, dlogp0=dlogp0, t0=t0, t1=t1, dt_init=dt_init, ys=ys, bf16=True,
        )
    _cuda_only_bf16("bf16 K3", z0, tab, spec)
    out = _launch_two_layer_forward(
        "bf16 K3", K3B_KERNEL, "cnf_k3b_test_solve", "cnf_k3b_max_grid", tab, spec, rtol=rtol, atol=atol,
        max_steps=max_steps, ws=ws, bs=bs, z0=z0, acc0=dlogp0, t0=t0, t1=t1, dt_init=dt_init, blocks=_BF16_BLOCKS,
    )
    run_bf16_solve_kernel.launches += 1
    return out


run_bf16_solve_kernel.launches = 0


def run_bf16_train_solve_kernel(
    tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, z0, eps, acc0, t0, t1, dt_init, ys=None,
    jvp=False,
):
    """bf16 K1: K1's TRAIN solve (`run_train_solve_kernel`: arguments and
    returns) with the stage matmuls under bf16.

    CUDA tensors go through the kernel (`csrc/k1_bf16_solve.cu`: one VJP
    probe), CPU tensors through its plain version (any Dense chain, K VJP or
    JVP probes, ys (B, n_cond) or None)."""
    _no_grad_inputs("bf16 K1", ws, bs, z0, eps, acc0, ys)
    if z0.device.type == "cpu":
        return solve_train_plain(
            tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol, max_steps=max_steps,
            ws=ws, bs=bs, z0=z0, eps=eps, acc0=acc0, t0=t0, t1=t1, dt_init=dt_init, ys=ys, jvp=jvp, bf16=True,
        )
    _cuda_only_bf16("bf16 K1", z0, tab, spec, eps.shape[0], jvp)
    out = _launch_two_layer_forward(
        "bf16 K1", K1B_KERNEL, "cnf_k1b_train_solve", "cnf_k1b_max_grid", tab, spec, rtol=rtol, atol=atol,
        max_steps=max_steps, ws=ws, bs=bs, z0=z0, acc0=acc0, t0=t0, t1=t1, dt_init=dt_init, eps=eps,
        norms=(norm_z, norm_j), blocks=_BF16_BLOCKS,
    )
    run_bf16_train_solve_kernel.launches += 1
    return out


run_bf16_train_solve_kernel.launches = 0


def _launch_k2_bf16(tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, eps, zT, accT, azT, aaccT,
                    t_hi, t_lo, dt_init):
    label = "bf16 K2"
    B, dz = zT.shape
    H = spec.out_dims[0]
    device = zT.device
    w1, b1, w2, b2, e0, zT, accT, azT, aaccT = _check_inputs(
        label, device, [ws[0], bs[0], ws[1], bs[1], eps, zT, accT, azT, aaccT],
        [(dz, H), (H,), (H, dz), (dz,), (1, B, dz), (B, dz), (3, B), (B, dz), (3, B)],
    )
    lib = _library(K2B_KERNEL)
    block, grid = _launch_shape(lambda blk, cap: lib.cnf_k2b_max_grid(dz, H, blk, cap), label, B, _BF16_BLOCKS)
    P = 2 * dz * H + H + dz
    ts = torch.stack([t_hi, t_lo, dt_init]).to(device=device, dtype=torch.float32)
    z0, acc0, az0, g, gnew, stats, work, partials, gblk = _wide_adjoint_buffers(tab, zT, accT, grid, P)
    err = lib.cnf_k2b_train_adjoint(
        _ptr(w1), _ptr(b1), _ptr(w2), _ptr(b2), _ptr(e0), _ptr(zT), _ptr(accT), _ptr(azT), _ptr(aaccT), _ptr(ts),
        _ptr(z0), _ptr(acc0), _ptr(az0), _ptr(g), _ptr(stats), _ptr(work), _ptr(partials), _ptr(gblk), _ptr(gnew),
        B, dz, H, int(max_steps), int(norm_z), int(norm_j), rtol, atol, *_controller_floats(tab), _tableau_array(tab),
        grid, block, _stream(device),
    )
    _check_launch(err, label, grid, block)
    g_ws, g_bs = _split_params(g, spec)
    return z0, acc0, az0, g_ws, g_bs, stats[0], stats[1]


def run_bf16_adjoint_kernel(
    tab, spec, *, norm_z, norm_j, rtol, atol, max_steps, ws, bs, eps, zT, accT, azT, aaccT,
    t_hi, t_lo, dt_init, ys=None, jvp=False,
):
    """bf16 K2: K2's backsolve (`run_adjoint_kernel`: arguments and returns)
    on the TRAIN stage VJP under bf16 stage matmuls, the weight gradients'
    batch sums included.

    CUDA tensors go through the kernel (`csrc/k2_bf16_adjoint.cu`: one VJP
    probe), CPU tensors through its plain version (any Dense chain, K VJP or
    JVP probes; with ys (B, n_cond), a_ys0 is returned last)."""
    _no_grad_inputs("bf16 K2", ws, bs, eps, zT, accT, azT, aaccT, ys)
    if zT.device.type == "cpu":
        return adjoint_train_plain(
            tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol, max_steps=max_steps,
            ws=ws, bs=bs, eps=eps, zT=zT, accT=accT, azT=azT, aaccT=aaccT,
            t_hi=t_hi, t_lo=t_lo, dt_init=dt_init, ys=ys, jvp=jvp, bf16=True,
        )
    _cuda_only_bf16("bf16 K2", zT, tab, spec, eps.shape[0], jvp)
    if dt_init is None:
        raise ValueError("bf16 K2 needs dt_init (the caller picks it)")
    out = _launch_k2_bf16(tab, spec, norm_z=norm_z, norm_j=norm_j, rtol=rtol, atol=atol, max_steps=max_steps,
                          ws=ws, bs=bs, eps=eps, zT=zT, accT=accT, azT=azT, aaccT=aaccT, t_hi=t_hi, t_lo=t_lo,
                          dt_init=dt_init)
    run_bf16_adjoint_kernel.launches += 1
    return out


run_bf16_adjoint_kernel.launches = 0


#: Every kernel's wrapper by kernel name (K10's, the per-stage field, from
#: `ops/fused_dynamics.py`); each wrapper's `.launches` counts its own
#: kernel's launches.
KERNEL_WRAPPERS = {
    K3_KERNEL: run_solve_kernel,
    K1_KERNEL: run_train_solve_kernel,
    K2_KERNEL: run_adjoint_kernel,
    K4_KERNEL: run_exact_solve_kernel,
    K4A_KERNEL: run_exact_adjoint_kernel,
    K5_KERNEL: run_test_adjoint_kernel,
    K1C_KERNEL: run_chain_train_solve_kernel,
    K2C_KERNEL: run_chain_adjoint_kernel,
    K7_KERNEL + "/test": run_chain_test_solve_kernel,
    K7_KERNEL + "/exact": run_chain_exact_solve_kernel,
    K1W_KERNEL: run_wide_train_solve_kernel,
    K2W_KERNEL: run_wide_adjoint_kernel,
    K7W_KERNEL + "/test": run_wide_test_solve_kernel,
    K7W_KERNEL + "/exact": run_wide_exact_solve_kernel,
    K3W_KERNEL: run_wide_test2_solve_kernel,
    K5W_KERNEL: run_wide_test_adjoint_kernel,
    K4WA_KERNEL: run_wide_exact_adjoint_kernel,
    K1W_KERNEL + "/cond": run_wide_cond_train_solve_kernel,
    K2W_KERNEL + "/cond": run_wide_cond_adjoint_kernel,
    K3W_KERNEL + "/cond": run_wide_cond_test2_solve_kernel,
    K5W_KERNEL + "/cond": run_wide_cond_test_adjoint_kernel,
    K7W_KERNEL + "/test/cond": run_wide_cond_test_solve_kernel,
    K7W_KERNEL + "/exact/cond": run_wide_cond_exact_solve_kernel,
    K4WA_KERNEL + "/cond": run_wide_cond_exact_adjoint_kernel,
    K1S_KERNEL: run_stream_train_solve_kernel,
    K2S_KERNEL: run_stream_adjoint_kernel,
    K7S_KERNEL + "/test": run_stream_test_solve_kernel,
    K7S_KERNEL + "/exact": run_stream_exact_solve_kernel,
    K3S_KERNEL: run_stream_test2_solve_kernel,
    K5S_KERNEL: run_stream_test_adjoint_kernel,
    K4SA_KERNEL: run_stream_exact_adjoint_kernel,
    K1S_KERNEL + "/cond": run_stream_cond_train_solve_kernel,
    K2S_KERNEL + "/cond": run_stream_cond_adjoint_kernel,
    K3S_KERNEL + "/cond": run_stream_cond_test2_solve_kernel,
    K5S_KERNEL + "/cond": run_stream_cond_test_adjoint_kernel,
    K7S_KERNEL + "/test/cond": run_stream_cond_test_solve_kernel,
    K7S_KERNEL + "/exact/cond": run_stream_cond_exact_solve_kernel,
    K4SA_KERNEL + "/cond": run_stream_cond_exact_adjoint_kernel,
    K3B_KERNEL: run_bf16_solve_kernel,
    K1B_KERNEL: run_bf16_train_solve_kernel,
    K2B_KERNEL: run_bf16_adjoint_kernel,
    K10_KERNEL: run_fused_field_kernel,
}


#: The Hutchinson kernels' wrappers, whose `.probe_launches[(K, jvp)]`
#: counts their probe instance's launches by probe count and direction (K6).
PROBE_WRAPPERS = (run_train_solve_kernel, run_adjoint_kernel, run_chain_train_solve_kernel, run_chain_adjoint_kernel,
                  run_wide_train_solve_kernel, run_wide_adjoint_kernel, run_wide_cond_train_solve_kernel,
                  run_wide_cond_adjoint_kernel, run_stream_train_solve_kernel, run_stream_adjoint_kernel,
                  run_stream_cond_train_solve_kernel, run_stream_cond_adjoint_kernel)


def reset_launches() -> None:
    """Set every wrapper's launch counts to 0."""
    for wrapper in KERNEL_WRAPPERS.values():
        wrapper.launches = 0
    for wrapper in PROBE_WRAPPERS:
        wrapper.probe_launches = {}


# ---- make_full_solve ----


def _ys_cotangent(ays0, ys):
    """The per-sample a_ys0 (B, n_cond) summed back to the shape of the
    caller's ys ((B, n_cond), (1, n_cond) or (n_cond,))."""
    if tuple(ys.shape) == tuple(ays0.shape):
        return ays0
    return ays0.sum(dim=0).reshape(ys.shape)


def make_full_solve(icnf, mode: Mode, batch: int) -> Optional[FullSolve]:
    """Build the fused solve for `ode.solve.odeint_with_stats`, or None when
    the JAX package's megakernel would not apply either.

    Eligibility follows the JAX package: opted in via `compute_mode.fused`;
    a Dense chain with tanh-or-identity activations, conditional or not; no
    passive augmentation; an adaptive explicit method with an embedded error
    estimate (every such tableau runs in the kernels); float32.  Fixed-step
    and DIRECT solves get None: they are differentiated through the plain
    loop, whose TRAIN stages run K10 (the JAX package builds a fused solve
    there too and ignores it; the port builds none, so a configuration the
    kernels do not cover does not raise on a path that would not use
    them).  Under
    `ComputeMode.bf16` (the stage matmuls from bf16-rounded operands with
    float32 sums, the JAX package's `_mm(..., "bf16")`; the Hairer pick
    keeps the plain float32 field, as there) the TEST and Hutchinson TRAIN
    solves run the bf16 wrappers: bf16 K3 forward, bf16 K1 forward and
    bf16 K2 backward, whose kernels take unconditional 2-layer tanh nets of
    state width up to MAX_DZ with one VJP probe (every other configuration
    raises on the card, naming BF16_ROW; no f32 kernel stands in) and whose
    twins take what their f32 twins take; what has no bf16 twin raises on
    both devices: the exact-trace stages, the deep exact chain (TEST mode
    past 2-layer tanh nets) and the TEST backward stage (K5), the last when
    a gradient calls it.  The flat layout
    is [z.ravel() (batch-major) | dlogp] in TEST mode and
    [z.ravel() | dlogp | reg_e | reg_n] in TRAIN mode; the conditioning
    `args["ys"]` ((B, n_cond), (1, n_cond) or (n_cond,)) is broadcast to
    (B, n_cond) for the kernels, and its cotangent summed back.  The
    wrappers are chosen here: unconditional 2-layer tanh nets run the
    2-layer kernels; 1-layer nets and chains of 3 to CHAIN_MAX_LAYERS
    layers, every conditional chain (K8) and every chain with an identity
    layer run the chain kernels, as the JAX package's kernels run their
    N-layer stages for every depth but 2 (its 2-layer TEST and exact stages
    assume tanh layers; the chain kernels do not), their narrow forms within
    state width MAX_DZ, hidden widths CHAIN_MAX_WIDTH and a block's shared
    memory (`_narrow_smem_bytes`), their wide forms beyond (1-layer nets
    past MAX_DZ raise on the card, ROADMAP queue 2, shape variants (c2)).
    Conditional chains past the narrow widths run the COND instances of the wide forms (K8): the wide K1
    and K2 chain forms' under Hutchinson TRAIN (their probe COND instances
    with K VJP or JVP probes, K6 x K8), wide K7
    TEST's forward at 3 to CHAIN_MAX_LAYERS layers and wide K7 exact's
    forward at every depth
    and, for 2-layer tanh nets past MAX_DZ (CondRNODE at the HEPMASS width),
    wide K3's forward and wide K5's backward in TEST mode and the wide K4
    adjoint's backward under exact trace (deeper chains' exact gradient runs
    the plain BACKSOLVE, as below).  Conditional chains past the wide
    limits run the COND instances of the streamed forms: the streamed K1 and
    K2 chain forms' under Hutchinson TRAIN (their probe COND instances with
    K VJP or JVP probes, K6 x K8), streamed K7 TEST's forward at 3-8 layers
    and streamed K7 exact's forward at every depth and, for 2-layer tanh
    nets (CondRNODE at the MINIBOONE width), streamed K3's forward and
    streamed K5's backward in TEST mode and the streamed K4 adjoint's
    backward under exact trace; so do the Hutchinson TRAIN solves with K
    probes or JVP of the conditional wide chains that only the streamed
    probe COND instances keep (`_stream_chain(spec, True)`: the wide probe
    COND instances' shared memory); narrow conditional nets keep the
    narrow chain kernels and K5's COND instance.
    Hutchinson TRAIN solves run K1 (or its chain form) with the
    backward member K2 (or its chain form), with the K VJP or JVP probes of
    `compute_mode` (K6: their probe instances); exact-trace TRAIN solves run the
    K4 forward (K7 for chain-kernel nets), with the K4 adjoint as the
    backward member for 2-layer tanh chains (conditional ones raise on the
    card: K8 in the 2-layer kernels is not ported) and none for other chains
    (the JAX package's deep exact chains are forward-only too: their
    gradient runs the plain BACKSOLVE).  TEST solves run K3 (K7 for
    chain-kernel nets), with K5 as the backward member for 2-layer tanh
    nets: unconditional ones run K3 forward and K5 backward, conditional
    ones K7 TEST with ys forward and K5's COND instance backward.  Deeper
    chains have no TEST backward member, as in the JAX package, and 2-layer
    nets with an identity layer none either (the JAX package's 2-layer TEST
    stage assumes tanh layers and fails on them; the port does not copy
    that): their gradient runs the plain BACKSOLVE behind K7.  Unconditional
    2-layer tanh nets past MAX_DZ (the README net family at the HEPMASS
    width) run the wide forms: wide K3 forward and wide K5 backward in TEST
    mode, the wide K1 and K2 chain forms under Hutchinson TRAIN, wide K7
    exact forward and the wide K4 adjoint backward under exact trace.
    Chains the wide forms refuse for their state width, their hidden widths
    or the shared memory their weights take (`_stream_chain`: FFJORD's
    MINIBOONE model 43 -> 860 -> 860 -> 43, state widths to STREAM_MAX_DZ)
    run the streamed forms: streamed K7 TEST and exact forward, the streamed
    K1 and K2 chain forms under Hutchinson TRAIN, with K VJP or JVP probes
    in their probe instances (K6); so do the Hutchinson TRAIN solves with K
    probes or JVP of the wide chains that only the streamed probe instances
    keep (`_stream_chain(spec, True)`: the wide probe instances' shared
    memory), whose one-probe and other solves stay on the wide forms; a
    2-layer tanh net past MAX_DZ among
    them (the README net family at the MINIBOONE and BSDS300 widths,
    86 -> 258 -> 86 and 126 -> 378 -> 126) runs streamed K3 forward and
    streamed K5 backward in TEST mode, and streamed K7 exact forward with
    the streamed K4 adjoint backward under exact trace.
    """
    cm = icnf.compute_mode
    opts = icnf.solver
    if not cm.fused:
        return None
    spec = chain_spec(icnf.nn, icnf.zdim)
    if spec is None:
        return None
    if (spec.n_cond > 0) != bool(icnf.cond):
        return None
    if icnf.aug_passive and icnf.n_aug_input:
        return None
    if opts.fixed_num_steps is not None or opts.method == "trbdf2" or opts.adjoint == Adjoint.DIRECT:
        return None
    tab = get_tableau(opts.method, opts.rtol)
    if tab.btilde is None:
        return None
    if icnf.dtype != torch.float32:
        return None
    train = mode == Mode.TRAIN
    exact = train and cm.exact_trace
    jvp = cm.ad == ADMode.JVP
    bf16 = bool(cm.bf16)
    if bf16 and exact:
        raise NotImplementedError(f"the exact-trace stages under bf16 stage matmuls ({BF16_ROW})")
    if bf16 and not train and not _two_layer_tanh(spec):
        raise NotImplementedError(
            f"the TEST stage of a {spec.n_layers}-layer chain or of a chain with an identity layer (the deep exact "
            f"chain stage) under bf16 stage matmuls ({BF16_ROW})"
        )

    from ..core.dynamics import TestState, TrainState, make_augmented_dynamics

    B = batch
    dz = icnf.zdim
    nacc = 3 if train else 1
    norm_z, norm_j = icnf.lam1 != 0.0, icnf.lam2 != 0.0
    # The plain flat field, used only for the Hairer initial-step pick (two
    # evaluations per solve), exactly as on the plain path.
    dyn = make_augmented_dynamics(icnf.nn, mode, dataclasses.replace(cm, fused=False), norm_z, norm_j)

    def unpack_flat(yf):
        z = yf[: B * dz].reshape(B, dz)
        if train:
            acc = yf[B * dz :].reshape(3, B)
            return TrainState(z=z, dlogp=acc[0], reg_e=acc[1], reg_n=acc[2])
        return TestState(z=z, dlogp=yf[B * dz :])

    def plain_f_flat(t, yf, args):
        return torch.cat([x.reshape(-1) for x in dyn(t, unpack_flat(yf), args)])

    def kernel_kw(args):
        ps, ys = args["ps"], args.get("ys")
        return dict(
            rtol=opts.rtol, atol=opts.atol, max_steps=opts.max_steps,
            ws=[p["w"] for p in ps], bs=[p["b"] for p in ps],
            ys=ys.reshape(-1, spec.n_cond).expand(B, spec.n_cond) if spec.n_cond else None,
        )

    nfe_per = (tab.num_stages - 1) + (0 if tab.fsal else 1)

    exact_pm = exact and _two_layer_tanh(spec)
    test_adjoint = not train and _two_layer_tanh(spec)
    chain = spec.n_layers != 2 or spec.n_cond > 0 or not all(spec.acts)
    wide2 = _wide_two_layer(spec)
    run_exact_adj, run_test_adj = run_exact_adjoint_kernel, run_test_adjoint_kernel
    if wide2:
        run_exact_adj, run_test_adj = run_wide_exact_adjoint_kernel, run_wide_test_adjoint_kernel
    probes = cm.num_probes != 1 or jvp
    if (chain and _wide_chain(spec) or wide2) and _stream_chain(spec):
        run_test, run_train = run_stream_test_solve_kernel, run_stream_train_solve_kernel
        run_exact, run_adjoint = run_stream_exact_solve_kernel, run_stream_adjoint_kernel
        if spec.n_cond:
            run_test, run_train = run_stream_cond_test_solve_kernel, run_stream_cond_train_solve_kernel
            run_exact, run_adjoint = run_stream_cond_exact_solve_kernel, run_stream_cond_adjoint_kernel
        if wide2:
            run_test, run_test_adj = run_stream_test2_solve_kernel, run_stream_test_adjoint_kernel
            run_exact_adj = run_stream_exact_adjoint_kernel
            if spec.n_cond:
                run_test, run_test_adj = run_stream_cond_test2_solve_kernel, run_stream_cond_test_adjoint_kernel
                run_exact_adj = run_stream_cond_exact_adjoint_kernel
    elif spec.n_cond and _wide_chain(spec):
        run_test, run_train = run_wide_cond_test_solve_kernel, run_wide_cond_train_solve_kernel
        run_exact, run_adjoint = run_wide_cond_exact_solve_kernel, run_wide_cond_adjoint_kernel
        if wide2:
            run_test, run_test_adj = run_wide_cond_test2_solve_kernel, run_wide_cond_test_adjoint_kernel
            run_exact_adj = run_wide_cond_exact_adjoint_kernel
        if _stream_chain(spec, probes):
            run_train, run_adjoint = run_stream_cond_train_solve_kernel, run_stream_cond_adjoint_kernel
    elif chain and _wide_chain(spec):
        run_test, run_train = run_wide_test_solve_kernel, run_wide_train_solve_kernel
        run_exact, run_adjoint = run_wide_exact_solve_kernel, run_wide_adjoint_kernel
        if _stream_chain(spec, probes):
            run_train, run_adjoint = run_stream_train_solve_kernel, run_stream_adjoint_kernel
    elif chain:
        run_test, run_train = run_chain_test_solve_kernel, run_chain_train_solve_kernel
        run_exact, run_adjoint = run_chain_exact_solve_kernel, run_chain_adjoint_kernel
    elif wide2:
        run_test, run_train = run_wide_test2_solve_kernel, run_wide_train_solve_kernel
        run_exact, run_adjoint = run_wide_exact_solve_kernel, run_wide_adjoint_kernel
        if _stream_chain(spec, probes):
            run_train, run_adjoint = run_stream_train_solve_kernel, run_stream_adjoint_kernel
    else:
        run_test, run_train = run_solve_kernel, run_train_solve_kernel
        run_exact, run_adjoint = run_exact_solve_kernel, run_adjoint_kernel
    if bf16:
        run_test, run_train, run_adjoint = run_bf16_solve_kernel, run_bf16_train_solve_kernel, run_bf16_adjoint_kernel

    def forward(y0f, t0, t1, args):
        tdir = torch.sign(t1 - t0)
        if opts.dt0 is None:
            f0 = plain_f_flat(t0, y0f, args)
            dt_init = _initial_step_size(
                lambda t, yf: plain_f_flat(t, yf, args),
                t0, y0f, f0, tdir, tab.order, opts.rtol, opts.atol, torch.abs(t1 - t0),
            )
            nfe_init = 2
        else:
            dt_init = tdir * abs(float(opts.dt0))
            nfe_init = 1
        z0 = y0f[: B * dz].reshape(B, dz)
        if exact:
            zT, accT, steps, accepted, dt_last, dt_used = run_exact(
                tab, spec, norm_z=norm_z, norm_j=norm_j, **kernel_kw(args), z0=z0,
                acc0=y0f[B * dz :].reshape(3, B), t0=t0, t1=t1, dt_init=dt_init,
            )
        elif train:
            zT, accT, steps, accepted, dt_last, dt_used = run_train(
                tab, spec, norm_z=norm_z, norm_j=norm_j, **kernel_kw(args), z0=z0,
                eps=args["eps"], acc0=y0f[B * dz :].reshape(3, B), t0=t0, t1=t1, dt_init=dt_init, jvp=jvp,
            )
        else:
            zT, accT, steps, accepted, dt_last, dt_used = run_test(
                tab, spec, **kernel_kw(args), z0=z0, dlogp0=y0f[B * dz :],
                t0=t0, t1=t1, dt_init=dt_init,
            )
        stats = SolveStats(
            steps=steps, accepted=accepted, nfe=steps * nfe_per + nfe_init, dt_last=dt_last, dt_used=dt_used
        )
        return torch.cat([zT.reshape(-1), accT.reshape(-1)]), stats

    def adjoint(yTf, g_yf, args, t_hi, t_lo, dt_warm=None):
        """Backward solve of (z, acc, a_z, [a_ys,] g_p) (and g_pm under exact
        trace) from t_hi down to t_lo: K2 (or its chain, wide and streamed
        forms), the K4 adjoint (or its wide and streamed forms) or, in TEST
        mode, K5 (or its wide and streamed forms).  Returns (y0f, a_y0f, g_args, stats);
        a_acc is constant, so its final value is the incoming cotangent.
        `dt_warm` (the forward solve's last step size) is the first step;
        without it Hairer's rule picks one over the whole augmented state
        that the backward solve integrates (a zero a_ys block included and,
        under exact trace, g_pm; the JAX package's pick chains pm into the
        parameters first)."""
        if bf16 and not train:
            raise NotImplementedError(f"the TEST backward stage (K5) under bf16 stage matmuls ({BF16_ROW})")
        ps, eps = args["ps"], args.get("eps")
        kw = kernel_kw(args)
        ysb = kw["ys"]
        zT, accT = yTf[: B * dz].reshape(B, dz), yTf[B * dz :].reshape(nacc, B)
        azT, aaccT = g_yf[: B * dz].reshape(B, dz), g_yf[B * dz :].reshape(nacc, B)
        tdir = torch.sign(t_lo - t_hi)
        nfe_init = 1
        if dt_warm is not None:
            dt_init = tdir * torch.abs(torch.as_tensor(dt_warm, dtype=yTf.dtype, device=yTf.device))
        elif opts.dt0 is None:
            if exact:
                pm = _exact_pm(spec, kw["ws"])
                stage = _exact_adjoint_stage(spec, kw["ws"], kw["bs"], pm, norm_z, norm_j, aaccT, ysb)
                shapes = _block_shapes(kw["ws"], kw["bs"], ysb, [pm.shape])
            elif not train:
                stage = _test_adjoint_stage(spec, kw["ws"], kw["bs"], aaccT, ysb)
                shapes = _block_shapes(kw["ws"], kw["bs"], ysb)
            else:
                stage = _train_adjoint_stage(spec, kw["ws"], kw["bs"], eps, norm_z, norm_j, aaccT, ysb, jvp)
                shapes = _block_shapes(kw["ws"], kw["bs"], ysb)
            f, u0 = _adjoint_state(stage, zT, accT, azT, aaccT, shapes)
            dt_init = _initial_step_size(
                f, t_hi, u0, f(t_hi, u0), tdir, tab.order, opts.rtol, opts.atol, torch.abs(t_lo - t_hi)
            )
            nfe_init = 2
        else:
            dt_init = tdir * abs(float(opts.dt0))
        state = dict(zT=zT, accT=accT, azT=azT, aaccT=aaccT, t_hi=t_hi, t_lo=t_lo, dt_init=dt_init)
        if exact:
            out = run_exact_adj(tab, spec, norm_z=norm_z, norm_j=norm_j, **kw, **state)
        elif not train:
            out = run_test_adj(tab, spec, **kw, **state)
        else:
            out = run_adjoint(tab, spec, norm_z=norm_z, norm_j=norm_j, **kw, eps=eps, jvp=jvp, **state)
        z0, acc0, az0, g_ws, g_bs, steps, accepted = out[:7]
        g_ps = tuple(
            {k: (gw if k == "w" else gb) for k in p} for p, gw, gb in zip(ps, g_ws, g_bs)
        )
        g_args = dict(args, ps=g_ps)
        if spec.n_cond:
            g_args["ys"] = _ys_cotangent(out[7], args["ys"])
        if eps is not None:
            g_args["eps"] = torch.zeros_like(eps)
        stats = SolveStats(steps=steps, accepted=accepted, nfe=steps * nfe_per + nfe_init)
        y0f = torch.cat([z0.reshape(-1), acc0.reshape(-1)])
        a_y0f = torch.cat([az0.reshape(-1), aaccT.reshape(-1)])
        return y0f, a_y0f, g_args, stats

    has_adjoint = (train and (not exact or exact_pm)) or test_adjoint
    return FullSolve(forward=forward, adjoint=adjoint if has_adjoint else None)


__all__ = [
    "ChainSpec",
    "chain_spec",
    "FullSolve",
    "make_full_solve",
    "run_solve_kernel",
    "run_train_solve_kernel",
    "run_adjoint_kernel",
    "run_exact_solve_kernel",
    "run_exact_adjoint_kernel",
    "run_test_adjoint_kernel",
    "run_chain_test_solve_kernel",
    "run_chain_exact_solve_kernel",
    "run_chain_train_solve_kernel",
    "run_chain_adjoint_kernel",
    "run_wide_test_solve_kernel",
    "run_wide_exact_solve_kernel",
    "run_wide_train_solve_kernel",
    "run_wide_adjoint_kernel",
    "run_wide_test2_solve_kernel",
    "run_wide_test_adjoint_kernel",
    "run_wide_exact_adjoint_kernel",
    "run_wide_cond_train_solve_kernel",
    "run_wide_cond_adjoint_kernel",
    "run_wide_cond_test2_solve_kernel",
    "run_wide_cond_test_adjoint_kernel",
    "run_wide_cond_test_solve_kernel",
    "run_wide_cond_exact_solve_kernel",
    "run_wide_cond_exact_adjoint_kernel",
    "run_stream_test_solve_kernel",
    "run_stream_exact_solve_kernel",
    "run_stream_train_solve_kernel",
    "run_stream_adjoint_kernel",
    "run_stream_test2_solve_kernel",
    "run_stream_test_adjoint_kernel",
    "run_stream_exact_adjoint_kernel",
    "run_stream_cond_train_solve_kernel",
    "run_stream_cond_adjoint_kernel",
    "run_stream_cond_test2_solve_kernel",
    "run_stream_cond_test_adjoint_kernel",
    "run_stream_cond_test_solve_kernel",
    "run_stream_cond_exact_solve_kernel",
    "run_stream_cond_exact_adjoint_kernel",
    "run_bf16_solve_kernel",
    "run_bf16_train_solve_kernel",
    "run_bf16_adjoint_kernel",
    "KERNEL_WRAPPERS",
    "PROBE_WRAPPERS",
    "reset_launches",
    "solve_test_plain",
    "solve_train_plain",
    "solve_train_exact_plain",
    "adjoint_train_plain",
    "adjoint_train_exact_plain",
    "adjoint_test_plain",
    "exact_stage_consts",
    "exact_pm_chain",
]
