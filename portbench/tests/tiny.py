"""Tiny sizes of the benchmark's cells, for runs on the host's CPU.

Widths stay as published; only the subjects, the pools and the windows
shrink.  :func:`run` drives a whole run through ``run.run_cell`` on the
CPU, past the look for a card."""

from __future__ import annotations

import copy
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for _p in (BENCH, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import harness  # noqa: E402

TINY = {
    "pw1.round.entropy": {"subject_shape": [24, 24, 4], "k": 8,
                          "init_size": 16, "b": 8, "B": 16, "ntb": 64,
                          "ckpt_full_every": 2, "blobs": 4,
                          "check_block": 64, "control_rounds": 3,
                          "check_rounds": 3, "learning_rate": 3e-6},
    "pw1.serve.f32": {"subject_shape": [12, 12, 4], "ring": 2,
                      "check_voxels": 64, "check_block": 32},
    "fcd103.serve.f32": {"slices": 4, "height": 32, "width": 32, "ring": 2,
                         "batch": 2, "check_block": 2},
}


def parts(workload: str):
    man = harness.manifest()
    cell = harness.cell(man, workload)
    cfg = harness.config(cell["config"])
    mix = harness.traffic(cell["traffic"], cfg["family"])
    mix.update(TINY[workload])
    limits = harness.load_json(os.path.join(BENCH, "limits",
                                            f"{workload}.json"))
    return cell, cfg, mix, limits


def run(workload: str, seed: int = 3, seconds: float = 0.5,
        trace: bool = False, limits=None):
    import run as runner

    cell, cfg, mix, lim = parts(workload)
    return runner.run_cell(cell, cfg, mix, copy.deepcopy(limits or lim),
                           seed, seconds, trace, "cpu", time.perf_counter())
