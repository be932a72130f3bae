"""Explicit RNG plumbing (counterpart of ``nnal_tpu/core/rng.py``).

The host half is identical to the JAX package: a seeded
``np.random.Generator`` and the same blake2b ``fold`` derivation, so host
draws (initial labeled set, batch shuffles, random queries) reproduce the
JAX package's exactly.  The device half is a ``torch.Generator`` seeded
from the same derived seed; ``next()`` draws a fresh seed from it for one
consumer (a dropout pass builds its own generator on its device).  JAX
threefry bits cannot be reproduced, so only the host half is shared.
"""

from __future__ import annotations

import base64
import hashlib

import numpy as np
import torch


class RngStream:
    """A named, forkable stream of device seeds plus a host generator."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.gen = torch.Generator().manual_seed(self.seed)
        self.host = np.random.default_rng(self.seed)

    def next(self) -> int:
        """A fresh 63-bit seed for one device consumer."""
        return int(torch.randint(0, 2 ** 62, (1,), generator=self.gen))

    def fold(self, tag: str) -> "RngStream":
        """Deterministic child stream keyed by ``(seed, tag)`` — process
        stable (blake2b, not Python's salted ``hash``)."""
        h = hashlib.blake2b(f"{self.seed}|{tag}".encode(), digest_size=4)
        return RngStream(int.from_bytes(h.digest(), "little"))

    def state(self) -> dict:
        raw = self.gen.get_state().numpy().tobytes()
        return {"key": base64.b64encode(raw).decode(),
                "host": self.host.bit_generator.state}

    def restore(self, state: dict) -> None:
        raw = np.frombuffer(base64.b64decode(state["key"]), np.uint8)
        self.gen.set_state(torch.from_numpy(raw.copy()))
        self.host.bit_generator.state = state["host"]
