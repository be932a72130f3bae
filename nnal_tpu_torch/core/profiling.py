"""Per-phase timing journal (counterpart of ``nnal_tpu/core/profiling.py``).

``PhaseTimer`` records score/select/train/eval phases per AL round into a
JSONL stream.  PyTorch returns before CUDA kernels finish, so on a CUDA
device every phase boundary synchronizes: without it a kernel queued in
one phase would bill to whichever later phase first waits on it.  The
device defaults to the card, as every entry point of the port does.

Library code deep in a strategy records named sub-spans with
:func:`subphase`; the engine's ``PhaseTimer.commit_round`` drains them
into the round's record under ``"sub"`` (the JAX package's layout), so no
timer has to be threaded through the scoring call stack.

:func:`annotate` names a range of a profiler timeline
(``torch.profiler.record_function``) and :func:`device_trace` records one
(``torch.profiler``, the card's kernels through CUPTI when the process
uses CUDA) into a directory that TensorBoard's profiler plugin reads, as
the JAX package's ``jax.profiler`` pair does (``profiling.py:78-94``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch
from torch.profiler import record_function

from nnal_tpu_torch.core.device import resolve_device, synchronize

# sub-span accumulator, drained into the next committed round record
_SUB: Dict[str, float] = {}


def _sync_card() -> None:
    """Wait for the card's queued kernels, if this process uses the card."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def subphase(name: str):
    """Accumulate a named sub-span into the next committed round record
    (``sub`` field); nesting records both levels.  The card is
    synchronized at both ends, so kernels queued before the span (or in
    it) bill to the span that launched them."""
    _sync_card()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync_card()
        _SUB[name] = _SUB.get(name, 0.0) + (time.perf_counter() - t0)


def drain_subphases() -> Dict[str, float]:
    """Return and clear the accumulated sub-phase spans."""
    global _SUB
    out, _SUB = _SUB, {}
    return {k: round(v, 6) for k, v in out.items()}


class PhaseTimer:
    """Per-round phase timing journal (JSONL, one record per round)."""

    def __init__(self, path: Optional[str] = None, device=None):
        self.path = path
        self.device = resolve_device(device)
        self.current: Dict[str, float] = {}
        self.records = []

    @contextlib.contextmanager
    def phase(self, name: str):
        synchronize(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            synchronize(self.device)
            self.current[name] = self.current.get(name, 0.0) + (
                time.perf_counter() - t0)

    def commit_round(self, round_id: int, **extra) -> dict:
        rec = {"round": int(round_id), **{k: round(v, 6) for k, v
                                          in self.current.items()}, **extra}
        sub = drain_subphases()
        if sub:
            rec["sub"] = sub
        self.records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        self.current = {}
        return rec


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block into ``log_dir`` (``<host>_<pid>.<time>.pt.
    trace.json``, a Chrome trace that TensorBoard's profiler plugin and
    Perfetto read): host ops always, the card's kernels when CUDA is
    available.  Yields the ``torch.profiler.profile``."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def annotate(name: str):
    """A named range of the profiler timeline
    (``torch.profiler.record_function``)."""
    return record_function(name)
