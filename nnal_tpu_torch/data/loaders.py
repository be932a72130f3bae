"""Host -> device batch pipeline for volumes kept in host RAM (counterpart
of ``nnal_tpu/data/loaders.py``).

The reference blocks training on host work: per batch it gathers patches
in Python, then feeds a ``sess.run`` (PW_AL.py:1060-1088).  Here a
background thread runs the native C++ gather (``runtime/native.py``) and
stages each batch onto the device while the consumer trains on the
previous one.  On the card a host batch is copied into pinned memory and
sent with a ``non_blocking`` copy on a side CUDA stream; the consumer's
stream waits on the batch's event, and each tensor is ``record_stream``-ed
to the consumer's stream, so the allocator does not reuse its memory
while the consumer may still read it.  On the CPU the tensors are the
host arrays.  An error in the worker is raised by the consumer's next
``next()``.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from nnal_tpu_torch.core.device import resolve_device
from nnal_tpu_torch.data.batching import gen_batch_inds, make_onehot
from nnal_tpu_torch.runtime.native import (
    gather_labels_native,
    gather_patches_native,
)


class PrefetchLoader:
    """An iterator of host batches (numpy arrays, or tuples of them) as an
    iterator of device tensors, ``depth`` batches ahead, on ``device``
    (an explicit ``torch.device``; ``None``: the card)."""

    def __init__(self, host_batches: Iterator, depth: int = 2, device=None):
        self._it = host_batches
        self._device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._err: Optional[BaseException] = None
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _stage(self, a) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self._stream is None:
            return t.to(self._device)
        with torch.cuda.stream(self._stream):
            return t.pin_memory().to(self._device, non_blocking=True)

    def _worker(self):
        try:
            for batch in self._it:
                staged = (tuple(self._stage(a) for a in batch)
                          if isinstance(batch, (tuple, list))
                          else self._stage(batch))
                ready = None
                if self._stream is not None:
                    ready = torch.cuda.Event()
                    ready.record(self._stream)
                self._q.put((staged, ready))
        except Exception as e:  # surfaced on next()
            self._err = e
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        staged, ready = item
        if ready is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(ready)
            for t in (staged if isinstance(staged, tuple) else (staged,)):
                t.record_stream(consumer)
        return staged


def patch_batch_source(padded_vols, mask, train_inds, patch_shape,
                       orig_shape, mu, sd, batch_size: int, nclass: int,
                       rng, epochs: int = 1) -> Iterator:
    """Host ``(x, y)`` batches over labeled voxels through the native
    gather: ``padded_vols`` are the ``m`` padded host volumes, ``y`` the
    one-hot labels; each epoch shuffles with ``gen_batch_inds``."""
    train_inds = np.asarray(train_inds)
    labels = gather_labels_native(mask, train_inds)
    for _ in range(epochs):
        for batch in gen_batch_inds(len(train_inds), batch_size, rng):
            x = gather_patches_native(padded_vols, train_inds[batch],
                                      patch_shape, orig_shape, mu, sd)
            yield x, make_onehot(labels[batch].astype(np.int64), nclass)


def prefetched_patch_batches(padded_vols, mask, train_inds, patch_shape,
                             orig_shape, mu, sd, batch_size: int,
                             nclass: int, rng, epochs: int = 1,
                             depth: int = 2, device=None) -> PrefetchLoader:
    return PrefetchLoader(
        patch_batch_source(padded_vols, mask, train_inds, patch_shape,
                           orig_shape, mu, sd, batch_size, nclass, rng,
                           epochs),
        depth=depth, device=device)
