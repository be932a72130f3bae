"""Offline analysis: grid F1, whole-volume DCRF evaluation, P/R series
(counterpart of ``nnal_tpu/evaluation/analysis.py``; the functions take
the port's model where JAX's take params, and its evaluators, CRF and
metrics).

Rebuild of the evaluator-level half of ``PW_analyze_results.py``:

* ``grid_based_f1`` (reference PW_analyze_results.py:772-800) — F1 over all
  grid samples of a subject;
* ``full_model_eval`` (reference PW_analyze_results.py:594-672) — dense
  slice-by-slice predictions + F1 over chosen slices;
* ``full_model_pred_dcrf`` (reference PW_analyze_results.py:449-538) —
  dense posteriors refined per-slice by the DenseCRF, then F1;
* ``pr_curves_from_predicts`` (reference ``get_eval_metrics``,
  PW_analyze_results.py:297-338) — precision/recall time series from a
  ``predicts.txt`` journal;
* ``get_full_segs`` / ``eval_full_segs_explicit_partitions`` /
  ``eval_full_segs_label_percentage`` (reference eval_utils.py:202-364) —
  dataset-level dense segmentation + per-axial-slab F1 aggregation.

Experiment-coupled routines (per-iteration test-score matrices, query
similarity) live in ``nnal_tpu.engine.analysis`` to keep the layer DAG
(evaluation must not import engine).  The 2-D DenseCRF steps take the
CRF's ``backend`` (``evaluation/crf``: ``auto`` tries the native solver
first; ``torch`` runs on the evaluator's device).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from nnal_tpu_torch.data.samplers import generate_grid_samples
from nnal_tpu_torch.evaluation.crf import dcrf_postprocess_2d
from nnal_tpu_torch.evaluation.inference import full_slice_patchwise
from nnal_tpu_torch.evaluation.metrics import f_measure, preds_stats


def grid_based_f1(evaluator, model, mask, spacing: int = 10) -> float:
    """F1 over all grid samples of one subject (reference
    ``grid_based_F1``; degenerate precision/recall yields 0.0 instead of
    the reference's division error)."""
    inds, labels = generate_grid_samples(evaluator.orig_shape, spacing,
                                         np.asarray(mask))
    preds = evaluator.evaluate(model, inds, ("prediction",))["prediction"]
    return f_measure(np.asarray(preds), np.asarray(labels))


def full_model_eval(evaluator, model, mask_vol,
                    slice_inds: Sequence[int],
                    save_dir: Optional[str] = None):
    """Dense per-slice predictions over ``slice_inds`` + F1 on those slices
    (reference ``full_model_eval``).  Saves ``segs.npy`` + ``F1_score.txt``
    when ``save_dir`` is given (npz instead of the reference's nrrd — the
    volume codec is not a capability, the artifact is)."""
    mask_vol = np.asarray(mask_vol)
    planes = full_slice_patchwise(evaluator, model, slice_inds,
                                  "prediction")
    preds = np.zeros(mask_vol.shape)
    for z in slice_inds:
        preds[:, :, z] = planes[z]
    f1 = f_measure(preds[:, :, list(slice_inds)],
                   mask_vol[:, :, list(slice_inds)])
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        np.save(os.path.join(save_dir, "segs.npy"), preds.astype(np.uint8))
        np.savetxt(os.path.join(save_dir, "F1_score.txt"), [f1])
    return preds, f1


def full_model_pred_dcrf(evaluator, model, image_vol, mask_vol,
                         slice_inds: Sequence[int],
                         save_dir: Optional[str] = None,
                         iters: int = 5, backend: str = "auto"):
    """Dense posteriors refined slice-by-slice with the DenseCRF, then F1
    (reference ``full_model_pred_DCRF``).  Saves ``dcrf_segs.npy`` +
    ``F1_score_dcrf.txt`` under ``save_dir``."""
    image_vol = np.asarray(image_vol)
    mask_vol = np.asarray(mask_vol)
    planes = full_slice_patchwise(evaluator, model, slice_inds,
                                  "posteriors")
    dcrf_preds = np.zeros(image_vol.shape)
    for z in slice_inds:
        dcrf_preds[:, :, z] = dcrf_postprocess_2d(planes[z],
                                                  image_vol[:, :, z],
                                                  iters=iters,
                                                  backend=backend,
                                                  device=evaluator.device)
    f1 = f_measure(dcrf_preds[:, :, list(slice_inds)],
                   mask_vol[:, :, list(slice_inds)])
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        np.save(os.path.join(save_dir, "dcrf_segs.npy"),
                dcrf_preds.astype(np.uint8))
        np.savetxt(os.path.join(save_dir, "F1_score_dcrf.txt"), [f1])
    return dcrf_preds, f1


def full_model_pred_dcrf3d(evaluator, model, image_vol, mask_vol,
                           slice_inds: Sequence[int],
                           save_dir: Optional[str] = None,
                           iters: int = 5):
    """Volumetric variant of :func:`full_model_pred_dcrf` (beyond the
    reference, which refines each slice independently): the evaluated
    slices' posteriors are refined with ONE 3D dense CRF over the native
    permutohedral solver, so cross-slice smoothness repairs per-slice
    artifacts.  Saves ``dcrf3d_segs.npy`` + ``F1_score_dcrf3d.txt``."""
    from nnal_tpu_torch.evaluation.crf import dcrf_postprocess_3d

    image_vol = np.asarray(image_vol)
    mask_vol = np.asarray(mask_vol)
    planes = full_slice_patchwise(evaluator, model, slice_inds,
                                  "posteriors")
    slice_inds = list(slice_inds)
    p1_stack = np.stack([planes[z] for z in slice_inds], axis=-1)
    seg_stack = dcrf_postprocess_3d(p1_stack,
                                    image_vol[:, :, slice_inds],
                                    iters=iters)
    preds = np.zeros(image_vol.shape)
    for i, z in enumerate(slice_inds):
        preds[:, :, z] = seg_stack[:, :, i]
    f1 = f_measure(preds[:, :, slice_inds], mask_vol[:, :, slice_inds])
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        np.save(os.path.join(save_dir, "dcrf3d_segs.npy"),
                preds.astype(np.uint8))
        np.savetxt(os.path.join(save_dir, "F1_score_dcrf3d.txt"), [f1])
    return preds, f1


def _as_volumes(items, reader=None):
    """Accept volumes or paths (reference eval_utils.py:247-265 loads from
    nrrd paths): a path is read by ``reader``, by default
    ``data.io.read_volume`` (``.npy`` / ``.npz``, ``.nrrd``, ``.nii``,
    ``.nii.gz`` and ``.hdr`` / ``.img``)."""
    if len(items) and isinstance(items[0], str):
        if reader is None:
            from nnal_tpu_torch.data.io import read_volume as reader
        return [np.asarray(reader(p)) for p in items]
    return [np.asarray(v) for v in items]


def get_full_segs(segment_fn, subjects, post_process: bool = False,
                  save_dir: Optional[str] = None):
    """Segment every subject of a dataset and score each against its mask
    (reference ``get_full_segs``, eval_utils.py:202-238).

    ``segment_fn(volumes) -> (H, W, Z) labels`` is any dense path —
    ``ShapeCachedFCN``, a ``full_slice_patchwise`` closure, or a sharded
    serving step; ``subjects`` is a list of ``(volumes, mask)``.  With
    ``post_process`` the reference's connected-component + hole-fill pass
    runs (``evaluation.postproc.postprocess_segmentation``); with
    ``save_dir`` each seg is written as ``seg_<i>.nrrd`` via the
    self-contained writer.  Returns ``(segs, overall_F1s)``.
    """
    segs, f1s = [], []
    for i, (vols, mask) in enumerate(subjects):
        seg = np.asarray(segment_fn(vols))
        if post_process:
            from nnal_tpu_torch.evaluation.postproc import (
                postprocess_segmentation,
            )

            seg = postprocess_segmentation(seg)
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            from nnal_tpu_torch.data.io import write_nrrd

            write_nrrd(os.path.join(save_dir, f"seg_{i}.nrrd"),
                       seg.astype(np.uint8))
        segs.append(seg)
        f1s.append(f_measure(seg, mask))
    return segs, np.array(f1s)


def eval_full_segs_explicit_partitions(segs_or_paths, masks_or_paths,
                                       slice_partitions, reader=None):
    """Overall + per-axial-slab F1 for every subject of a dataset, with
    explicit slab boundaries (reference
    ``eval_full_segs_explicit_partitions``, eval_utils.py:240-296).

    ``slice_partitions`` is either one boundary list applied to all
    subjects or an ``(n, m)`` per-subject array; ``m`` boundaries induce
    ``m + 1`` slabs ``[:b0], [b0:b1], ..., [b_last:]``.  Returns
    ``(overall (n,), partitioned (n, m+1))``.
    """
    segs = _as_volumes(segs_or_paths, reader)
    masks = _as_volumes(masks_or_paths, reader)
    parts = np.asarray(slice_partitions)
    if parts.ndim == 1:
        parts = np.repeat(parts[None, :], len(segs), axis=0)
    overall = np.zeros(len(segs))
    part_f = np.zeros((len(segs), parts.shape[1] + 1))
    for i, (seg, mask) in enumerate(zip(segs, masks)):
        overall[i] = f_measure(seg, mask)
        bounds = [0] + list(parts[i]) + [seg.shape[2]]
        for j in range(len(bounds) - 1):
            part_f[i, j] = f_measure(seg[:, :, bounds[j]:bounds[j + 1]],
                                     mask[:, :, bounds[j]:bounds[j + 1]])
    return overall, part_f


def eval_full_segs_label_percentage(segs_or_paths, masks_or_paths,
                                    label: int = 1,
                                    percentage: float = 0.001,
                                    reader=None):
    """3-fold top/middle/bottom partitioned F1 where each subject's slab
    edges are derived from its own mask: the middle slab is the contiguous
    run of axial slices whose ``label`` fraction is >= ``percentage``
    (reference ``eval_full_segs_label_percentage``, eval_utils.py:298-364,
    which located the gap in the below-threshold slice set).  Subjects
    whose below-threshold slices do not form exactly one gap keep zero rows
    (the reference printed and ``continue``d the same way).  Returns
    ``(overall (n,), partitioned (n, 3))``.
    """
    segs = _as_volumes(segs_or_paths, reader)
    masks = _as_volumes(masks_or_paths, reader)
    overall = np.zeros(len(segs))
    part_f = np.zeros((len(segs), 3))
    for i, (seg, mask) in enumerate(zip(segs, masks)):
        overall[i] = f_measure(seg, mask)
        frac = np.sum(mask == label, axis=(0, 1)) / np.prod(mask.shape[:2])
        thr_slices = np.where(frac < percentage)[0]
        gap_loc = np.where(np.diff(thr_slices) > 1)[0]
        if len(gap_loc) != 1:
            continue  # no (or ambiguous) contiguous above-threshold band
        edge_1 = int(thr_slices[gap_loc[0]])
        edge_2 = int(thr_slices[gap_loc[0] + 1])
        for j, sl in enumerate((slice(None, edge_1),
                                slice(edge_1, edge_2),
                                slice(edge_2, None))):
            part_f[i, j] = f_measure(seg[:, :, sl], mask[:, :, sl])
    return overall, part_f


def pr_curves_from_predicts(predicts_path: str, test_labels) -> np.ndarray:
    """(2, iters) precision/recall rows from a per-round ``predicts.txt``
    journal (reference ``get_eval_metrics``); degenerate rounds yield 0."""
    preds = np.atleast_2d(np.loadtxt(predicts_path))
    labels = np.asarray(test_labels)
    out = np.zeros((2, preds.shape[0]))
    for i in range(preds.shape[0]):
        P, N, TP, FP, TN, FN = preds_stats(preds[i], labels)
        out[0, i] = TP / (TP + FP) if TP + FP > 0 else 0.0
        out[1, i] = TP / P if P > 0 else 0.0
    return out
