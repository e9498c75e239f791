"""The training wrapper: `ICNFModel`, `fit` and `FitResult`.

Port of `continuousnf_tpu/train/fit.py`: `ICNFModel` (:34-56),
`CondICNFModel` (:58-60), `FitResult` (:63-80), `_pad_count` (:83-86), the
epoch loop of `_make_epochs_fn` (:88-152) as an eager loop, and `fit`
(:155-340), conditional models with their conditioning `Y` included.
Shuffled minibatches with the tail padded by repeated samples of weight 0
(the reference DataLoader's partial batches at a fixed shape); X and Y are
permuted alike.  Each epoch's draws derive from the seed and the global
epoch index, so a fit resumed at `epoch_start` repeats the draws of an
uninterrupted one.

An optimizer is given as a factory `params -> torch.optim.Optimizer`; the
default is `Lion(params, lr=1e-3)` (optax's `lion(1e-3)`, weight decay
1e-3 included).  Named tables (item 18), `mesh`/`distributed` (item 19)
and `profile_dir` (item 21) raise NotImplementedError naming their ROADMAP
queue 1 item.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from ..core.icnf import ICNF, init_params
from ..ode.adjoint import flatten_tree
from ..parallel.sharding import make_train_step_body
from ..types import resolve_device
from .lion import Lion


@dataclasses.dataclass(frozen=True)
class ICNFModel:
    """Training configuration wrapping an ICNF.  `optimizers` are factories
    applied one after another, each for `n_epochs`."""

    icnf: ICNF
    optimizers: Tuple[Callable, ...] = None  # default: (Lion with lr=1e-3,)
    n_epochs: int = 300
    batch_size: int = 32
    use_batch: bool = True
    sync_every: int = 0  # progress print cadence in epochs (with verbosity); 0 = only at the end

    def __post_init__(self):
        if self.optimizers is None:
            object.__setattr__(self, "optimizers", (functools.partial(Lion, lr=1.0e-3),))
        if not isinstance(self.optimizers, tuple):
            object.__setattr__(self, "optimizers", tuple(self.optimizers))


# Conditional fitting uses the same machinery with the rows of Y next to X.
CondICNFModel = ICNFModel


@dataclasses.dataclass
class FitResult:
    """Fitted parameters and per-epoch diagnostics."""

    icnf: ICNF
    ps: Any
    losses: np.ndarray  # per-epoch mean training loss
    wall_time_s: float
    epochs: int
    # Per-epoch arrays keyed "loss", "e", "n", "nfe" (means over the
    # epoch's steps) and "samples_per_s" (host clock over the epoch).
    metrics: Optional[dict] = None
    column_names: Optional[list] = None
    cond_column_names: Optional[list] = None


def _pad_count(n: int, batch_size: int) -> Tuple[int, int]:
    n_batches = -(-n // batch_size)
    return n_batches, n_batches * batch_size - n


def _seed_of(seed: int, *tags: int) -> int:
    """A 32-bit seed derived from `seed` and tags (the epoch index and what
    the generator draws), independent of every other combination."""
    return int(np.random.SeedSequence([int(seed), *tags]).generate_state(1)[0])


def fit(
    model: ICNFModel,
    X: Any,
    Y: Any = None,
    *,
    seed: int = 0,
    device=None,
    ps: Any = None,
    opt_state: Optional[dict] = None,
    epoch_start: int = 0,
    verbosity: int = 0,
    mesh=None,
    distributed: bool = False,
    callback=None,
    callback_every: int = 0,
    state_callback=None,
    profile_dir: Optional[str] = None,
) -> FitResult:
    """Train on data `X` ((n, nvars) array or tensor) and, for a conditional
    model, its conditioning `Y` ((n, n_cond), required; an unconditional
    model refuses it).

    Params start from `ps` (their device) or a fresh draw on `device` (X's
    device when X is a tensor, else `types.resolve_device`: the CUDA card
    unless a default is set).  `opt_state` (an optimizer
    `state_dict`) and `epoch_start` resume a single-optimizer fit;
    `state_callback(epoch, ps, optimizer_state_dict)` runs after every
    epoch.  `callback(epoch, ps) -> bool` runs every `callback_every`
    epochs; True stops training.
    """
    icnf = model.icnf
    if mesh is not None or distributed:
        raise NotImplementedError("mesh and multi-host fits are not ported yet (ROADMAP queue 1, item 19)")
    if profile_dir is not None:
        raise NotImplementedError("profile_dir is not ported yet (ROADMAP queue 1, item 21)")
    if icnf.cond and Y is None:
        raise ValueError("conditional model requires Y")
    if not icnf.cond and Y is not None:
        raise ValueError("non-conditional model got Y")
    for name, data in (("X", X), ("Y", Y)):
        if data is not None and not isinstance(data, (np.ndarray, torch.Tensor)):
            raise NotImplementedError(
                f"fit takes numpy arrays or tensors; tables ({name}: {type(data).__name__}) are not ported yet "
                "(ROADMAP queue 1, item 18)"
            )
    if (opt_state is not None or epoch_start) and len(model.optimizers) != 1:
        raise ValueError("opt_state/epoch_start resume requires a single optimizer")
    from ..utils.debug import check_array

    if ps is not None:
        device = flatten_tree(ps)[0][0].device
    elif device is None and isinstance(X, torch.Tensor):
        device = X.device
    else:
        device = resolve_device(device)
    xs = torch.as_tensor(X, dtype=icnf.dtype).to(device)
    check_array("X", xs, rank=(2,), last_dim=icnf.nvars, dtype=icnf.dtype)
    n = xs.shape[0]
    ys = None
    if Y is not None:
        ys = torch.as_tensor(Y, dtype=icnf.dtype).to(device)
        check_array("Y", ys, rank=(2,), dtype=icnf.dtype)
        if ys.shape[0] != n:
            raise ValueError(f"Y has {ys.shape[0]} rows, X has {n}")
    batch_size = model.batch_size if model.use_batch else n
    n_batches, pad = _pad_count(n, batch_size)

    if ps is None:
        ps = init_params(icnf, torch.Generator(device).manual_seed(_seed_of(seed, 0)), device)
    leaves, rebuild = flatten_tree(ps)
    leaves = [p.detach().clone().requires_grad_() for p in leaves]
    ps = rebuild(leaves)

    t_start = time.perf_counter()
    history = {k: [] for k in ("loss", "e", "n", "nfe", "samples_per_s")}
    epoch_i = int(epoch_start)
    stopped = False
    for oi, make_opt in enumerate(model.optimizers):
        if stopped:
            break
        optimizer = make_opt(leaves)
        if opt_state is not None:
            optimizer.load_state_dict(opt_state)
            opt_state = None
        step = make_train_step_body(icnf, optimizer)
        last = epoch_i + (model.n_epochs - epoch_i if oi == 0 else model.n_epochs)
        while epoch_i < last and not stopped:
            # The permutation and the step draws of this epoch derive from
            # the global epoch index.
            perm_gen = torch.Generator().manual_seed(_seed_of(seed, 1, epoch_i))
            draw_gen = torch.Generator(device).manual_seed(_seed_of(seed, 2, epoch_i))
            perm = torch.randperm(n, generator=perm_gen)
            w = torch.ones(n + pad, dtype=icnf.dtype)
            if pad:
                # Zero-weight repeats of the permutation; more than n of them
                # when batch_size exceeds 2n (the JAX package's perm[:pad]
                # then comes up short and its reshape fails).
                perm = torch.cat([perm, perm.repeat(-(-pad // n))[:pad]])
                w[n:] = 0.0
            perm = perm.to(device)
            xb = xs[perm].reshape(n_batches, batch_size, -1)
            yb = [None] * n_batches if ys is None else ys[perm].reshape(n_batches, batch_size, -1)
            wb = w.to(device).reshape(n_batches, batch_size)
            t_epoch = time.perf_counter()
            steps = [step(ps, xb[b], draw_gen, weights=wb[b], ys=yb[b]) for b in range(n_batches)]
            for k in ("loss", "e", "n", "nfe"):
                history[k].append(float(torch.stack([torch.as_tensor(m[k]).float() for m in steps]).mean()))
            history["samples_per_s"].append(n / max(time.perf_counter() - t_epoch, 1e-9))
            epoch_i += 1
            if verbosity and model.sync_every and epoch_i % model.sync_every == 0:
                print(
                    f"[fit] epoch {epoch_i}: loss={history['loss'][-1]:.4f} "
                    f"E={history['e'][-1]:.3f} n={history['n'][-1]:.3f} nfe={history['nfe'][-1]:.0f}"
                )
            if state_callback is not None:
                state_callback(epoch_i, ps, optimizer.state_dict())
            if callback is not None and callback_every and epoch_i % callback_every == 0 and callback(epoch_i, ps):
                stopped = True
    metrics = {k: np.asarray(v, np.float64) for k, v in history.items()}
    wall = time.perf_counter() - t_start
    if verbosity:
        print(f"[fit] {epoch_i} epochs in {wall:.1f}s; final loss {metrics['loss'][-1]:.4f}")
    return FitResult(
        icnf=icnf, ps=rebuild([p.detach() for p in leaves]), losses=metrics["loss"],
        wall_time_s=wall, epochs=epoch_i, metrics=metrics,
    )


__all__ = ["ICNFModel", "CondICNFModel", "FitResult", "fit"]
