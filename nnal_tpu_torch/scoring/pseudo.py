"""Confident pseudo-labeling (a copy of ``nnal_tpu/scoring/pseudo.py``).

Rebuild of ``get_confident_samples`` (reference PW_NNAL.py:1138-1182, broken
there — it calls a missing ``PW_AL.batch_eval_winds``): take the pool
samples the model is most confident about, label them with the model's
prediction, and optionally count mislabels against ground truth.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def confident_samples(p1: np.ndarray, pool_inds: np.ndarray, num: int,
                      threshold: float = 0.9,
                      true_labels: Optional[np.ndarray] = None
                      ) -> Tuple[np.ndarray, np.ndarray, Optional[int]]:
    """Most-confident ``num`` pool samples + their pseudo-labels.

    ``p1``: P(class 1) per pool sample.  Pseudo-label is 1 where
    ``p1 > threshold`` (reference's 0.9 rule), else 0.  Returns
    ``(voxel_inds, pseudo_labels, n_mislabeled_or_None)``.
    """
    p1 = np.asarray(p1)
    conf_pos = np.argsort(-np.abs(p1 - 0.5), kind="stable")[:num]
    conf_inds = np.asarray(pool_inds)[conf_pos]
    pseudo = (p1[conf_pos] > threshold).astype(np.int64)
    mis = None
    if true_labels is not None:
        mis = int(np.sum(np.asarray(true_labels)[conf_pos] != pseudo))
    return conf_inds, pseudo, mis
