"""Host-side batch index generation.

Semantics follow the reference generators (datasets/utils.py:16,44,271) but
every stochastic call takes an explicit ``np.random.Generator`` instead of
global state, so training runs are replayable.
"""

from __future__ import annotations

from itertools import zip_longest
from typing import List, Optional

import numpy as np


def gen_batch_inds(data_size: int, batch_size: int, rng) -> List[np.ndarray]:
    """Random partition of ``range(data_size)`` into batches; the remainder
    forms a final smaller batch (reference datasets/utils.py:16 — the
    remainder batch takes the *last* ``rem`` elements of the permutation,
    which overlaps the final full batch; that quirk is preserved since
    training-epoch coverage depends on it)."""
    quot, rem = divmod(data_size, batch_size)
    perm = rng.permutation(data_size)
    batches = [perm[i * batch_size:(i + 1) * batch_size] for i in range(quot)]
    if rem > 0:
        batches.append(perm[-rem:])
    return batches


def gen_minibatch_labeled_unlabeled_inds(L_indic, batch_size: int, rng,
                                         n_labeled: Optional[int] = None):
    """Eternal generator over mixed labeled/unlabeled batches (reference
    datasets/utils.py:44).  With ``n_labeled`` set, every batch contains
    exactly that many labeled samples."""
    L_indic = np.asarray(L_indic)
    n = len(L_indic)
    if n_labeled is None:
        def eternal():
            while True:
                for inds in gen_batch_inds(n, batch_size, rng):
                    yield inds
        return zip_longest(eternal())

    labeled = np.flatnonzero(L_indic == 1)
    unlabeled = np.setdiff1d(np.arange(n), labeled)
    n_unlabeled = batch_size - n_labeled

    def lab_gen():
        while True:
            for inds in gen_batch_inds(len(labeled), n_labeled, rng):
                yield labeled[inds]

    def unlab_gen():
        while True:
            for inds in gen_batch_inds(len(unlabeled), n_unlabeled, rng):
                yield unlabeled[inds]

    return zip_longest(lab_gen(), unlab_gen())


def generator_complete_data(X, Y, batch_size: int, rng,
                            eternality: bool = False, sample_axis: int = 0):
    """Batch generator over in-memory arrays (reference
    datasets/utils.py:271).  Yields ``(X_batch, Y_batch, batch_inds)``."""
    n = X.shape[sample_axis]
    while True:
        for batch in gen_batch_inds(n, batch_size, rng):
            xb = np.take(X, batch, axis=sample_axis)
            if isinstance(Y, list):
                yb = [np.take(y, batch, axis=sample_axis) for y in Y]
            else:
                yb = np.take(Y, batch, axis=sample_axis)
            yield xb, yb, batch
        if not eternality:
            break


def random_crop(img, h: int, w: int, rng, init_h=None, init_w=None):
    """Random crop of an ``(H, W[, C])`` image (reference
    datasets/utils.py:204)."""
    if init_h is None:
        init_h = 0 if img.shape[0] == h else int(rng.integers(0, img.shape[0] - h))
    if init_w is None:
        init_w = 0 if img.shape[1] == w else int(rng.integers(0, img.shape[1] - w))
    crop = img[init_h:init_h + h, init_w:init_w + w]
    return crop, init_h, init_w


def make_onehot(labels, nclass: int) -> np.ndarray:
    """Row-major one-hot ``(n, c)`` (the reference keeps column-major
    ``(c, n)`` one-hots, AL.py:755; this rebuild is row-major throughout)."""
    labels = np.asarray(labels, dtype=np.int64)
    out = np.zeros((labels.size, nclass), dtype=np.float32)
    out[np.arange(labels.size), labels] = 1.0
    return out
