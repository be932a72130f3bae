"""Evaluation metrics.

Rebuild of the reference metric suite (AL.py:795-851;
PW_analyze_results.py:234-296; PW_NN.py:542; eval_utils.py:240-380) without
the sklearn dependency: accuracy, P/N/TP/FP/TN/FN stats, F-measure over
arrays or per-image dicts, binary/multi-class F1, example-based P/R, and
slab-partitioned F1.
"""

from __future__ import annotations

from typing import Dict, Sequence, Union

import numpy as np


def accuracy(preds, labels) -> float:
    preds = np.asarray(preds)
    labels = np.asarray(labels)
    return float(np.sum(preds == labels) / preds.size)


def preds_stats(preds, mask):
    """P, N, TP, FP, TN, FN for binary arrays (reference
    ``get_preds_stats``, PW_analyze_results.py:234)."""
    preds = np.asarray(preds)
    mask = np.asarray(mask)
    P = float(np.sum(mask > 0))
    N = float(np.sum(mask == 0))
    TP = float(np.sum((preds > 0) & (mask > 0)))
    FP = float(np.sum((preds > 0) & (mask == 0)))
    TN = float(np.sum((preds == 0) & (mask == 0)))
    FN = float(np.sum((preds == 0) & (mask > 0)))
    return P, N, TP, FP, TN, FN


def f_measure(preds: Union[np.ndarray, Dict], mask) -> float:
    """F-measure ``2/(1/Pr + 1/Rc)`` aggregated over an array or a dict of
    per-image predictions (reference ``get_Fmeasure``,
    PW_analyze_results.py:261-289)."""
    P = TP = TPFP = 0
    if isinstance(preds, dict):
        for key, ipred in preds.items():
            imask = np.asarray(mask[key])
            ipred = np.asarray(ipred)
            P += np.sum(imask > 0)
            TP += np.sum((ipred > 0) & (imask > 0))
            TPFP += np.sum(ipred > 0)
    else:
        preds = np.asarray(preds)
        mask = np.asarray(mask)
        P = np.sum(mask > 0)
        TP = np.sum((preds > 0) & (mask > 0))
        TPFP = np.sum(preds > 0)
    if TP == 0 or TPFP == 0 or P == 0:
        return 0.0
    pr = TP / TPFP
    rc = TP / P
    return float(2.0 / (1.0 / pr + 1.0 / rc))


def binary_f1(preds, labels) -> float:
    """Binary F1 of the positive class (reference ``F1_scores`` /
    ``binary_F1_score``)."""
    return f_measure(np.asarray(preds), np.asarray(labels))


def dice(preds, labels) -> float:
    """Dice coefficient — identical to binary F1 on hard masks (the
    segmentation-community name used by BASELINE.md's config #4)."""
    return binary_f1(preds, labels)


def multi_f1(preds, labels, nclass: int):
    """Per-class F1 + macro average (reference ``multi_F1_score``)."""
    f1s = []
    for c in range(nclass):
        f1s.append(f_measure(np.asarray(preds) == c,
                             np.asarray(labels) == c))
    return np.array(f1s), float(np.mean(f1s))


def precision_recall(preds, labels):
    P, N, TP, FP, TN, FN = preds_stats(preds, labels)
    pr = TP / (TP + FP) if TP + FP > 0 else 0.0
    rc = TP / P if P > 0 else 0.0
    return pr, rc


def example_based_pr(pred_onehot, label_onehot):
    """Example-based multi-class precision/recall (reference
    ``get_multi_PR``, AL.py:821-851): per-sample intersection over predicted
    / true label sets, averaged."""
    pred = np.asarray(pred_onehot) > 0
    lab = np.asarray(label_onehot) > 0
    inter = np.sum(pred & lab, axis=1)
    p_cnt = np.maximum(np.sum(pred, axis=1), 1)
    l_cnt = np.maximum(np.sum(lab, axis=1), 1)
    return float(np.mean(inter / p_cnt)), float(np.mean(inter / l_cnt))


def partitioned_f1(preds_vol, mask_vol, slabs: Sequence[Sequence[int]] = None,
                   n_slabs: int = 3):
    """Per-slab F1 over axial partitions (reference eval_utils.py:240-360).
    Without explicit ``slabs``, boundaries are placed so each slab carries
    roughly equal label volume (the reference's label-percentage slabs)."""
    preds_vol = np.asarray(preds_vol)
    mask_vol = np.asarray(mask_vol)
    nz = mask_vol.shape[2]
    if slabs is None:
        per_slice = np.array([np.nansum(mask_vol[:, :, z]) for z in range(nz)])
        cum = np.cumsum(per_slice)
        total = cum[-1] if cum[-1] > 0 else 1
        bounds = [0]
        for i in range(1, n_slabs):
            bounds.append(int(np.searchsorted(cum, total * i / n_slabs)))
        bounds.append(nz)
        slabs = [range(bounds[i], max(bounds[i + 1], bounds[i] + 1))
                 for i in range(n_slabs)]
    out = []
    for sl in slabs:
        sl = list(sl)
        out.append(f_measure(preds_vol[:, :, sl], mask_vol[:, :, sl]))
    return np.array(out)
