"""Whole-ODE-solve kernel ("solve-in-kernel") for TEST-mode densities.

Port of the TEST forward path of `continuousnf_tpu/ops/fused_solve.py`:
`ChainSpec`/`chain_spec` (:101-152), `FullSolve` (:1346-1357) and
`make_full_solve` (:1378-1569), with `run_solve_kernel` in the place of
`_run_solve_kernel` (:968-1061).

The kernel, K3 (`csrc/k3_test_solve.cu`), replaces the TPU megakernel
`fused_solve.py::_run_solve_kernel` with the `_stage_test` stage: the whole
adaptive tsit5 solve of [z | dlogp] for a 2-layer tanh MLP in one
cooperative launch, with one batch-global error norm per attempted step.
On the H100 it is bound by latency (the dependent FMA chains of one thread
per sample, and one grid barrier per attempted step), not by bytes or FLOPs;
the source note in the .cu file says what its design does about that.

`run_solve_kernel` launches the kernel for CUDA tensors and runs its plain
PyTorch version, `solve_test_plain` (the eager `_solve_adaptive_while` on the
plain TEST field), for CPU tensors.  On a CUDA tensor there is no fallback:
a configuration the kernel does not cover raises NotImplementedError.
`run_solve_kernel.launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..ode.solve import SolveStats, _initial_step_size, _solve_adaptive_while, forbid_grad
from ..ode.tableaus import TSIT5, ButcherTableau, get_tableau
from ..types import Mode

_KERNEL = "k3_test_solve"


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
    adjoint: the backward megakernel; None until gradients are ported.
    """

    forward: Callable
    adjoint: Optional[Callable]


def _test_stage(spec: ChainSpec, ws, bs, z):
    """The plain TEST field of the chain: (y, tr J)."""
    from .fused_dynamics import dense_chain_trace, exact_tanh_mlp_trace

    if spec.n_layers == 2 and all(spec.acts):
        return exact_tanh_mlp_trace(({"w": ws[0], "b": bs[0]}, {"w": ws[1], "b": bs[1]}), z)
    return dense_chain_trace(ws, bs, spec.acts, z)


def solve_test_plain(tab, spec, *, rtol, atol, max_steps, ws, bs, z0, dlogp0, t0, t1, dt_init):
    """Plain PyTorch version of the kernel: the eager adaptive solve of
    [z | dlogp] on the closed-form TEST field, from the given initial step.
    Returns (zT, dlogpT, steps, accepted, dt_last)."""
    B, dz = z0.shape

    def f(t, yf):
        y, tr = _test_stage(spec, ws, bs, yf[: B * dz].reshape(B, dz))
        return torch.cat([y.reshape(-1), -tr])

    y0f = torch.cat([z0.reshape(-1), dlogp0])
    yf, st = _solve_adaptive_while(f, tab, y0f, t0, t1, rtol, atol, max_steps, dt_init)
    return yf[: B * dz].reshape(B, dz), yf[B * dz :], st.steps, st.accepted, st.dt_last


def _kernel_covers(tab: ButcherTableau, spec: ChainSpec) -> Optional[str]:
    """Why the CUDA kernel cannot run this configuration (None if it can)."""
    if tab != TSIT5:
        return f"the {tab.name} tableau (K9, ROADMAP queue 2)"
    if spec.n_layers != 2:
        return f"{spec.n_layers}-layer chains (K7, ROADMAP queue 2)"
    if not all(spec.acts):
        return "identity-activation layers (K9, ROADMAP queue 2)"
    if spec.n_cond:
        return "conditional nets (K8, ROADMAP queue 2)"
    if spec.dz > 32:
        return f"state width {spec.dz} > 32 (the kernel keeps one sample's state in registers)"
    return None


def _tableau_array() -> ctypes.Array:
    """tsit5 as the kernel reads it: a (7 x 7, row-major) | b | btilde."""
    s = TSIT5.num_stages
    a = [[0.0] * s for _ in range(s)]
    for i, row in enumerate(TSIT5.a):
        a[i][: len(row)] = row
    flat = [x for row in a for x in row] + list(TSIT5.b) + list(TSIT5.btilde)
    return (ctypes.c_float * len(flat))(*flat)


def _library() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library(_KERNEL)
    if not getattr(lib, "_cnf_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.cnf_k3_max_grid.argtypes = [I, I, I, ctypes.POINTER(I)]
        lib.cnf_k3_max_grid.restype = I
        lib.cnf_k3_test_solve.argtypes = (
            [P] * 13 + [I, I, I, I] + [F] * 5 + [P, I, I, P]
        )
        lib.cnf_k3_test_solve.restype = I
        lib._cnf_typed = True
    return lib


def _launch_shape(lib, B: int, dz: int, H: int, device) -> Tuple[int, int]:
    """Threads per block and blocks, capped at the co-resident grid.  128
    threads per block (256 once that would need more than two blocks per
    SM): at B = 4096 on the H100, 128 beat 32, 64 and 256 because fewer
    blocks make the per-step grid barrier and partial sum cheaper (PERF.md)."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    block = 128
    while block < 256 and -(-B // block) > 2 * n_sm:
        block *= 2
    cap = ctypes.c_int(0)
    err = lib.cnf_k3_max_grid(dz, H, block, ctypes.byref(cap))
    if err != 0 or cap.value < 1:
        raise RuntimeError(
            f"K3 cannot be launched cooperatively (dz={dz}, H={H}, block={block}): "
            f"cudaError {err}, co-resident grid {cap.value}"
        )
    return block, min(-(-B // block), cap.value)


def run_solve_kernel(tab, spec, *, rtol, atol, max_steps, ws, bs, z0, dlogp0, t0, t1, dt_init):
    """The forward solve of [z | dlogp] from t0 to t1 (0-d tensors; t1 < t0
    runs backward) starting with step `dt_init`.  z0 is (B, dz) batch-major
    and dlogp0 (B,) seeds the accumulator.  Returns
    (zT, dlogpT, steps, accepted, dt_last), all on z0's device.

    CUDA tensors go through the K3 kernel, CPU tensors through its plain
    version."""
    forbid_grad(ws, bs, z0, dlogp0)
    if z0.device.type == "cpu":
        return solve_test_plain(
            tab, spec, rtol=rtol, atol=atol, max_steps=max_steps, ws=ws, bs=bs,
            z0=z0, dlogp0=dlogp0, t0=t0, t1=t1, dt_init=dt_init,
        )
    if z0.device.type != "cuda":
        raise ValueError(f"K3 runs on CUDA or CPU tensors, got {z0.device}")
    why = _kernel_covers(tab, spec)
    if why is not None:
        raise NotImplementedError(f"the CUDA solve kernel does not cover {why}")
    B, dz = z0.shape
    H = spec.out_dims[0]
    device = z0.device
    tensors = [ws[0], bs[0], ws[1], bs[1], z0, dlogp0]
    if any(x.dtype != torch.float32 or x.device != device for x in tensors):
        raise ValueError("K3 takes float32 tensors on one device")
    w1, b1, w2, b2, z0, dlogp0 = (x.contiguous() for x in tensors)
    if w1.shape != (dz, H) or w2.shape != (H, dz) or b1.shape != (H,) or b2.shape != (dz,):
        raise ValueError(f"K3 weight shapes do not match z0 {tuple(z0.shape)}")
    if dlogp0.shape != (B,):
        raise ValueError(f"dlogp0 must have shape ({B},), got {tuple(dlogp0.shape)}")

    lib = _library()
    block, grid = _launch_shape(lib, B, dz, H, device)
    ts = torch.stack([t0, t1, dt_init]).to(device=device, dtype=torch.float32)
    zT = torch.empty_like(z0)
    dlogpT = torch.empty_like(dlogp0)
    stats = torch.empty(2, dtype=torch.int32, device=device)
    dt_last = torch.empty(1, dtype=torch.float32, device=device)
    work = torch.empty((TSIT5.num_stages + 2) * (dz + 1) * B, dtype=torch.float32, device=device)
    partials = torch.empty(4 * grid, dtype=torch.float32, device=device)
    beta1, beta2 = 7.0 / (10.0 * tab.order), 2.0 / (5.0 * tab.order)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    err = lib.cnf_k3_test_solve(
        ptr(w1), ptr(b1), ptr(w2), ptr(b2), ptr(z0), ptr(dlogp0), ptr(ts),
        ptr(zT), ptr(dlogpT), ptr(stats), ptr(dt_last), ptr(work), ptr(partials),
        B, dz, H, int(max_steps), rtol, atol, beta1, beta2, 1.0 / tab.order,
        _tableau_array(), grid, block,
        ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"K3 launch failed with cudaError {err} (grid {grid}, block {block})")
    run_solve_kernel.launches += 1
    return zT, dlogpT, stats[0], stats[1], dt_last[0]


run_solve_kernel.launches = 0


def make_full_solve(icnf, mode: Mode, batch: int) -> Optional[FullSolve]:
    """Build the fused solve for `ode.solve.odeint_with_stats`, or None when
    the JAX package's megakernel would not apply either.

    Eligibility follows the JAX package: opted in via `compute_mode.fused`;
    a Dense chain with tanh-or-identity activations; no passive
    augmentation; an adaptive explicit method with an embedded error
    estimate; float32.  Within those, what this port has not reached
    raises NotImplementedError: TRAIN mode, conditional nets and bf16 stages.
    The flat layout is [z.ravel() (batch-major) | dlogp].
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
    if opts.fixed_num_steps is not None or opts.method == "trbdf2":
        return None
    tab = get_tableau(opts.method, opts.rtol)
    if tab.btilde is None:
        return None
    if icnf.dtype != torch.float32:
        return None
    if mode != Mode.TEST:
        raise NotImplementedError(
            "the fused TRAIN solve (K1, K2) is not ported yet (ROADMAP queue 1, items 4-7)"
        )
    if spec.n_cond:
        raise NotImplementedError("conditional models are not ported yet (ROADMAP queue 1, item 13)")
    if cm.bf16:
        raise NotImplementedError(
            "bf16 stage matmuls in the fused solve are not ported (ROADMAP queue 2, K3 variants)"
        )

    from ..core.dynamics import TestState, make_augmented_dynamics

    B = batch
    dz = icnf.zdim
    # The plain flat field, used only for the Hairer initial-step pick (two
    # evaluations per solve), exactly as on the plain path.
    dyn = make_augmented_dynamics(icnf.nn, mode, dataclasses.replace(cm, fused=False), False, False)

    def plain_f_flat(t, yf, args):
        d = dyn(t, TestState(z=yf[: B * dz].reshape(B, dz), dlogp=yf[B * dz :]), args)
        return torch.cat([d.z.reshape(-1), d.dlogp])

    def forward(y0f, t0, t1, args):
        ps = args["ps"]
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
        zT, dlogpT, steps, accepted, dt_last = run_solve_kernel(
            tab, spec, rtol=opts.rtol, atol=opts.atol, max_steps=opts.max_steps,
            ws=[p["w"] for p in ps], bs=[p["b"] for p in ps],
            z0=y0f[: B * dz].reshape(B, dz), dlogp0=y0f[B * dz :],
            t0=t0, t1=t1, dt_init=dt_init,
        )
        nfe_per = (tab.num_stages - 1) + (0 if tab.fsal else 1)
        stats = SolveStats(
            steps=steps, accepted=accepted, nfe=steps * nfe_per + nfe_init, dt_last=dt_last
        )
        return torch.cat([zT.reshape(-1), dlogpT]), stats

    return FullSolve(forward=forward, adjoint=None)


__all__ = [
    "ChainSpec",
    "chain_spec",
    "FullSolve",
    "make_full_solve",
    "run_solve_kernel",
    "solve_test_plain",
]
