"""Explicit RNG plumbing (counterpart of ``nnal_tpu/core/rng.py``).

The host half is identical to the JAX package: a seeded
``np.random.Generator`` and the same blake2b ``fold`` derivation, so host
draws (initial labeled set, batch shuffles, random queries) reproduce the
JAX package's exactly.  The device half is a ``torch.Generator`` seeded
from the same derived seed; ``next()`` draws a fresh seed from it for one
consumer (a dropout pass builds its own generator on its device).  JAX
threefry bits cannot be reproduced, so only the host half is shared.
:meth:`RngStream.restore` also takes a ``state.json`` record the JAX
package wrote (its ``key`` is threefry's uint32 words): the host
generator resumes exactly, and the device generator is seeded from a
blake2b of the words.  The device bits differ from JAX's anyway, and
every per-round stream is a ``fold`` of the seed, not of the live key.

Device keys are plain integer seeds.  :func:`fold_key` is the
counterpart of ``jax.random.fold_in`` (a keyed consumer's seed from a
parent seed and a tag) and :func:`key_generator` turns a key and a tag
into a ``torch.Generator`` on a device (:func:`key_stream` without a
tag; :func:`int_key` makes a key of a host-drawn integer).  Every
stochastic scoring pass (MC-dropout chunks, perturbation noise,
BatchBALD and BADGE draws) gets its generator from these alone and treats the key as opaque, so a
test can substitute both, and the draw functions of the consumers (and
:func:`gumbel`, which BatchBALD and BADGE share), to feed JAX's own
threefry draws through the port.
"""

from __future__ import annotations

import base64
import hashlib

import numpy as np
import torch


def _blake2b_seed(seed, tag) -> int:
    h = hashlib.blake2b(f"{seed}|{tag}".encode(), digest_size=4)
    return int.from_bytes(h.digest(), "little")


def fold_key(key: int, tag) -> int:
    """The child key of ``key`` for ``tag`` — process stable (blake2b, as
    :meth:`RngStream.fold`), the counterpart of ``fold_in``."""
    return _blake2b_seed(key, tag)


def key_generator(key: int, tag, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``(key, tag)``: one
    keyed consumer's stream (a chunk of a sweep, a selection's draws).  A
    consumer keyed this way draws the same whatever ran before it."""
    return torch.Generator(device=device).manual_seed(fold_key(key, tag))


def key_stream(key: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` drawing from ``key`` itself, no
    tag folded in: where JAX hands a key straight to its consumer (the
    classification step's dropout, the classification BADGE's draws)."""
    return torch.Generator(device=device).manual_seed(int(key))


def int_key(n: int) -> int:
    """The device key of a host-drawn integer (JAX's
    ``jax.random.key(n)``): the classification strategies draw ``n`` from
    the round's host stream and key their device draws on it."""
    return int(n)


def gumbel(shape, generator: torch.Generator, device,
           tag: int) -> torch.Tensor:
    """Standard Gumbel noise in f32 (``-log(-log(u))``, ``u`` uniform in
    ``[tiny, 1)``, as ``jax.random.gumbel``) for the categorical draw
    ``argmax(logits + gumbel)`` of step ``tag`` — the tag JAX folds into
    the key (BatchBALD's and BADGE's draws)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32).clamp_(min=tiny)
    return -torch.log(-torch.log(u))


class RngStream:
    """A named, forkable stream of device seeds plus a host generator."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.gen = torch.Generator().manual_seed(self.seed)
        self.host = np.random.default_rng(self.seed)

    def next(self) -> int:
        """A fresh 63-bit seed for one device consumer."""
        return int(torch.randint(0, 2 ** 62, (1,), generator=self.gen))

    def next_n(self, n: int) -> list:
        """``n`` fresh seeds for ``n`` consumers, drawn as :meth:`next`
        draws them (JAX splits its key ``n + 1`` ways, ``rng.py:42-44``)."""
        return [self.next() for _ in range(int(n))]

    def fold(self, tag: str) -> "RngStream":
        """Deterministic child stream keyed by ``(seed, tag)`` — process
        stable (blake2b, not Python's salted ``hash``)."""
        return RngStream(_blake2b_seed(self.seed, tag))

    def state(self) -> dict:
        raw = self.gen.get_state().numpy().tobytes()
        return {"key": base64.b64encode(raw).decode(),
                "host": self.host.bit_generator.state}

    def restore(self, state: dict) -> None:
        """Resume from :meth:`state`'s record, or from the JAX package's,
        whose ``key`` is a list of uint32 words (``rng.py:49``)."""
        key = state["key"]
        if isinstance(key, str):
            raw = np.frombuffer(base64.b64decode(key), np.uint8)
            self.gen.set_state(torch.from_numpy(raw.copy()))
        else:
            words = ",".join(str(int(w)) for w in key)
            self.gen.manual_seed(_blake2b_seed("jax-key", words))
        self.host.bit_generator.state = state["host"]
