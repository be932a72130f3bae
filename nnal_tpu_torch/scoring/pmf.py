"""Sampling query batches from an optimal query PMF (a copy of
``nnal_tpu/scoring/pmf.py``, which is plain numpy: the same generator
gives the same draws in both packages).

Numerically mirrors the reference ``sample_query_dstr``
(NNAL_tools.py:844-896): cumsum-searchsorted draws, with-replacement draws
deduplicated via ``unique`` (so fewer than k may return), without-replacement
draws renormalized after each removal.  Host-side by design — k is tiny and
the PMF comes off-device once per AL round.
"""

from __future__ import annotations

import warnings

import numpy as np


def draw_queries(qdist, prior, k: int, rng,
                 replacement: bool = False) -> np.ndarray:
    """Prior-weighted PMF draw (reference ``draw_queries``,
    PW_NNAL.py:1023-1039 — a call-site-free helper there; kept for API
    parity): multiplies the query distribution by an optional prior,
    renormalizes, and samples via :func:`sample_query_pmf`."""
    q = np.array(qdist, dtype=np.float64).ravel()
    if prior is not None and len(np.atleast_1d(prior)):
        q = q * np.asarray(prior, np.float64).ravel()
    s = q[q > 0].sum()
    if s > 0:
        q = q / s
    return sample_query_pmf(q, k, rng, replacement=replacement)


def sample_query_pmf(q_pmf, k: int, rng, replacement: bool = True) -> np.ndarray:
    q = np.array(q_pmf, dtype=np.float64).ravel()
    if q.min() < -0.01:
        warnings.warn("optimal q has significant negative values")
    q[q < 0] = 0.0

    if replacement:
        draws = q.cumsum().searchsorted(rng.random(k))
        # clamp BEFORE unique: a float-rounding draw past cumsum[-1] maps
        # to len(q); clamping after dedup could emit len(q)-1 twice,
        # violating the unique-positions contract
        draws[draws == len(q)] = len(q) - 1
        return np.unique(draws)

    rem = np.arange(len(q))
    out = []
    q = q.copy()
    while len(out) < k and len(rem) > 0:
        j = int(q.cumsum().searchsorted(rng.random(1))[0])
        j = min(j, len(rem) - 1)
        out.append(int(rem[j]))
        rem = np.delete(rem, j)
        q = np.delete(q, j)
        if len(q) and q.sum() == 0:
            q[:] = 1.0
        if len(q):
            q = q / q.sum()
    return np.array(out, dtype=np.int64)
