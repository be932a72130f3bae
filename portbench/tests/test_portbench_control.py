"""The control of each cell's check: the plain reference put in the
program's place.  On the card, at TF32 (the nearest precision below the
configurations' IEEE float32) and at the cell's own sizes, it fails at
least one of the cell's numbers on each of three seeds; TF32 exists only
on the card, so without one that test skips.  On the CPU, at tiny sizes,
the round cell's stand-in passes the cell's own check at float32, and
each fault planted in its rounds 1..n fails it."""

import pytest
import torch

import tiny
import control


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 runs only on its tensor cores")


@pytest.mark.parametrize("workload", sorted(tiny.TINY))
def test_control_fails_a_number(card, workload):
    for seed in (1, 2, 3):
        checks, ok = control.control(workload, seed, "cuda")
        assert not ok, (seed, checks)


def _failed(checks):
    return sorted(c["name"] for c in checks
                  if not c["value"] <= c["limit"])


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch", "pick",
                                   "prediction"])
def test_round_stand_in_faults(fault):
    checks, ok = control.control("pw1.round.entropy", 5, "cpu",
                                 tiny.TINY["pw1.round.entropy"], fault)
    assert ok == (fault is None), _failed(checks)
    if fault:
        assert "train_change_med" not in _failed(checks)
