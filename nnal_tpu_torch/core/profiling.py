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
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, Optional

import torch

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
