"""The draws of the patch-wise finetune, worked out from the campaign's seed.

The program keys every draw of a round's finetune on the campaign seed,
the optimizer step and the step's row, so that a resumed campaign draws
what the uninterrupted one drew (PW1 engine, ``finetune``).  This module
derives the same draws independently, so the reference can follow the
program's first steps exactly:

* a child seed of ``(seed, tag)`` is the little-endian 4-byte blake2b
  digest of ``"<seed>|<tag>"``;
* a stream's device seed is ``torch.randint(0, 2**62)`` from a CPU
  generator seeded with its seed, and its host generator is
  ``numpy.random.default_rng(seed)``;
* the batches of an epoch are a permutation of the labeled rows cut into
  full batches, the remainder taking the permutation's last rows; each
  epoch draws its own permutation from the same host generator;
* a finetune advances the optimizer step by the count of steps that a set
  of ``n`` rows rounded up to a multiple of 256 would take, plus one a
  epoch (:func:`step_count`), whether or not the steps ran;
* step ``i``'s dropout uniforms come from a generator on the device seeded
  with the child of ``(child(dropout seed, step0), i)``, one ``torch.rand``
  per dropout layer in layer order.

Nothing here imports the program under test.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence, Tuple

import numpy as np
import torch


def child(seed, tag) -> int:
    h = hashlib.blake2b(f"{seed}|{tag}".encode(), digest_size=4)
    return int.from_bytes(h.digest(), "little")


def device_seed(seed: int) -> int:
    gen = torch.Generator().manual_seed(int(seed))
    return int(torch.randint(0, 2 ** 62, (1,), generator=gen))


def step_count(n: int, batch: int, epochs: int = 1,
               bucket: int = 256) -> int:
    """How far a finetune on ``n`` rows advances the optimizer step."""
    return epochs * (-(-(-(-n // bucket) * bucket) // batch) + 1)


def batches(seed: int, step0: int, n: int, batch: int, epochs: int = 1
            ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``(rows, weights)`` of each step of the finetune that starts at
    optimizer step ``step0`` on ``n`` labeled rows.  A short batch is
    filled up to ``batch`` with row 0 at weight 0."""
    host = np.random.default_rng(child(seed, f"finetune-{step0}"))
    quot, rem = divmod(n, batch)
    parts = []
    for _ in range(epochs):
        perm = host.permutation(n)
        parts += [perm[i * batch:(i + 1) * batch] for i in range(quot)]
        if rem:
            parts.append(perm[-rem:])
    out = []
    for p in parts:
        pad = batch - len(p)
        out.append((np.concatenate([p, np.zeros(pad, np.int64)]),
                    np.concatenate([np.ones(len(p), np.float32),
                                    np.zeros(pad, np.float32)])))
    return out


def dropout_uniforms(seed: int, step0: int, i: int, rows: int,
                     widths: Sequence[int], device) -> List[torch.Tensor]:
    """Step ``i``'s uniforms, one (rows, width) tensor per dropout layer."""
    key = child(device_seed(child(seed, f"finetune-dropout-{step0}")), step0)
    gen = torch.Generator(device=device).manual_seed(child(key, i))
    return [torch.rand((rows, w), generator=gen, device=device,
                       dtype=torch.float32) for w in widths]
