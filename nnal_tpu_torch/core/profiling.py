"""Per-phase timing journal (counterpart of ``nnal_tpu/core/profiling.py``).

``PhaseTimer`` records score/select/train/eval phases per AL round into a
JSONL stream.  PyTorch returns before CUDA kernels finish, so on a CUDA
device every phase boundary synchronizes: without it a kernel queued in
one phase would bill to whichever later phase first waits on it.  The
device defaults to the card, as every entry point of the port does.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, Optional

from nnal_tpu_torch.core.device import resolve_device, synchronize


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
        self.records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        self.current = {}
        return rec
