"""The near-tie witness of the port (`utils/near_tie.py`) on the CPU: the
one-ulp nudge, the witness on an input of the conditional recipe whose step
count moves with roundoff and on one whose does not, and the near-tie
rule."""

import numpy as np
import pytest
import torch

import continuousnf_tpu_torch as tcnf
from continuousnf_tpu_torch.ode.tableaus import TSIT5
from continuousnf_tpu_torch.ops import fused_solve as tfs
from continuousnf_tpu_torch.utils import near_tie

# The port's entry points default to the CUDA card; these tests run it on the CPU.
tcnf.set_default_device("cpu")


def _case(name):
    dims, B, span = near_tie.CASES[name]
    spec = tfs.chain_spec(tcnf.MLP(dims), dims[-1])
    train, _, _ = near_tie.case_inputs(dims, B, span, torch.device("cpu"))
    return spec, train


def test_nudge_moves_every_element_one_ulp():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32))
    y = near_tie.nudge(x, torch.Generator().manual_seed(0))
    up = torch.nextafter(x, torch.full_like(x, np.inf))
    down = torch.nextafter(x, torch.full_like(x, -np.inf))
    assert bool(((y == up) | (y == down)).all())
    assert 0 < int((y == up).sum()) < x.numel()


@pytest.mark.parametrize("name,near", [("recipe-B128", True), ("narrow-ncond2", False)])
def test_witness_finds_the_recipe_near_tie(name, near):
    """The conditional recipe at B = 128 (one state dimension, kinked norm
    rates): one-ulp moves of the inputs move the twin's attempted step
    count.  The narrow chain with three state dimensions: nothing moves
    beyond 1e-4."""
    spec, train = _case(name)
    ref = tfs.solve_train_plain(TSIT5, spec, **train)
    steps, spreads = near_tie.witness(tfs.solve_train_plain, TSIT5, spec, train, "z0", ref=ref)
    assert len(steps) == 32 and len(spreads) == 4  # z and the three accumulator rows
    assert near_tie.shows_near_tie(int(ref[2]), steps, spreads, 1e-4) == near
    if near:
        assert len(set(steps)) > 1


def test_near_tie_rule():
    """The rule holds the twin's own output and a copy within four times
    the spread; it refuses a row moved by more, and a step count outside
    the twin's own range."""
    spec, train = _case("recipe-B128")
    ref = tfs.solve_train_plain(TSIT5, spec, **train)
    steps, spreads = near_tie.witness(tfs.solve_train_plain, TSIT5, spec, train, "z0", ref=ref)
    assert near_tie.within_near_tie(ref, ref, steps, spreads, 1e-4)[0]
    scale = max(1.0, float(ref[1][1].abs().max()))

    def moved_row(factor):
        acc = ref[1].clone()
        acc[1, 0] += factor * max(1e-4, 4.0 * spreads[2]) * scale
        return (ref[0], acc) + tuple(ref[2:])

    assert near_tie.within_near_tie(moved_row(0.9), ref, steps, spreads, 1e-4)[0]
    assert not near_tie.within_near_tie(moved_row(1.5), ref, steps, spreads, 1e-4)[0]
    far = (ref[0], ref[1], torch.tensor(max(steps) + 1), ref[3], ref[4])
    assert not near_tie.within_near_tie(far, ref, steps, spreads, 1e-4)[0]


def test_last_step_rule():
    """The last-step rule holds two forward solves that part only at the
    end: one more attempted and accepted step, that solve's last step
    shorter than the other's, values within the bound.  It refuses a
    longer last step, a second extra step and values moved beyond the
    bound; forward outputs carry the last step taken."""
    spec, train = _case("narrow-ncond2")
    ref = tfs.solve_train_plain(TSIT5, spec, **train)
    assert near_tie.is_forward(ref) and float(ref[5]) > 0.0

    def longer(extra=1, last=0.5, move=0.0):
        acc = ref[1] + move
        return (ref[0], acc, ref[2] + extra, ref[3] + extra, ref[4], ref[5] * last)

    assert near_tie.last_step_tie(longer(), ref, 1e-4)[0]
    assert near_tie.last_step_tie(ref, longer(), 1e-4)[0]
    assert not near_tie.last_step_tie(longer(last=1.5), ref, 1e-4)[0]
    assert not near_tie.last_step_tie(longer(extra=2), ref, 1e-4)[0]
    assert not near_tie.last_step_tie(longer(move=1.0), ref, 1e-4)[0]
    assert not near_tie.last_step_tie(ref, ref, 1e-4)[0]
