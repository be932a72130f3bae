"""Intensity statistics used for patch normalization.

Reference: ``PW_AL.get_stats`` (PW_AL.py:901-919) computes per-subject,
per-modality (mean, std) over the non-NaN region of the mask; the reference
has an indexing bug (``stats[i, j*m]`` instead of ``stats[i, 2*j]``, benign
only for m==2) that is *not* replicated (SURVEY.md §2.9).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def volume_stats(img, mask=None):
    """(mean, std) over voxels where the mask is not NaN."""
    img = np.asarray(img, dtype=np.float64)
    if mask is None:
        sel = img.ravel()
    else:
        sel = img[~np.isnan(np.asarray(mask))]
    return float(sel.mean()), float(sel.std())


def multimg_stats(subjects: Sequence) -> np.ndarray:
    """Per-subject stats matrix ``stats[i] = [mu_0, sd_0, mu_1, sd_1, ...]``.

    ``subjects``: list of ``(modality_volumes, mask)`` tuples.
    Layout matches the reference consumers (PW_NNAL.py:703-706 reads
    ``stats[i, 2*j]`` / ``stats[i, 2*j+1]``).
    """
    n = len(subjects)
    m = len(subjects[0][0])
    stats = np.zeros((n, 2 * m))
    for i, (vols, mask) in enumerate(subjects):
        for j in range(m):
            mu, sd = volume_stats(vols[j], mask)
            stats[i, 2 * j] = mu
            stats[i, 2 * j + 1] = sd
    return stats


class StreamingMoments:
    """Streaming mean/variance (and histogram) of patch intensities
    (reference ``get_mean_var``, patch_utils.py:1006) via Chan's parallel
    update, so statistics can be accumulated shard-by-shard."""

    def __init__(self):
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0

    def update(self, x) -> None:
        x = np.asarray(x, dtype=np.float64).ravel()
        if x.size == 0:
            return
        n_b, mean_b = x.size, x.mean()
        m2_b = ((x - mean_b) ** 2).sum()
        delta = mean_b - self.mean
        tot = self.n + n_b
        self.mean += delta * n_b / tot
        self.m2 += m2_b + delta ** 2 * self.n * n_b / tot
        self.n = tot

    @property
    def var(self) -> float:
        return self.m2 / self.n if self.n else 0.0

    @property
    def std(self) -> float:
        return float(np.sqrt(self.var))


class StreamingHistogram:
    """Fixed-bin streaming histogram of patch intensities (the histogram
    half of reference ``get_mean_var``, patch_utils.py:1006-1084)."""

    def __init__(self, lo: float, hi: float, bins: int = 100):
        self.edges = np.linspace(lo, hi, bins + 1)
        self.counts = np.zeros(bins, dtype=np.int64)

    def update(self, x) -> None:
        c, _ = np.histogram(np.asarray(x).ravel(), bins=self.edges)
        self.counts += c

    @property
    def density(self) -> np.ndarray:
        total = self.counts.sum()
        width = np.diff(self.edges)
        return self.counts / (total * width) if total else self.counts * 0.0
