"""Experiment-coupled analysis routines (counterpart of
``nnal_tpu/engine/analysis.py``).

Rebuild of the experiment-level half of ``PW_analyze_results.py``:

* ``test_scores_matrix`` (reference ``eval_MultimgAL``,
  PW_analyze_results.py:801-863) — per-iteration weight checkpoints
  evaluated against each test subject, accumulated resumably into
  ``test_scores.txt``;
* ``query_similarity_analysis`` (reference ``get_Qsims``,
  PW_analyze_results.py:886-920) — per-round pairwise cosine similarity of
  the queried patches' features;
* ``query_type_analysis`` and ``slice_query_preds`` — the queries'
  partition types and one slice's predictions;
* ``full_test_slice_dcrf`` (reference PW_analyze_results.py:727-770) —
  whole-volume DCRF evaluation routine over a set of experiments.

Checkpoints are read with ``models/checkpoint.load_checkpoint`` and
loaded into the engine's model on its device (float16 history copies
upcast to f32, as in JAX).
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

from nnal_tpu_torch.core.journal import MethodJournal, load_inds
from nnal_tpu_torch.evaluation.analysis import full_model_pred_dcrf
from nnal_tpu_torch.evaluation.metrics import f_measure
from nnal_tpu_torch.models.checkpoint import load_checkpoint


def _model(expr, spec, path: str):
    """The checkpoint at ``path`` as the engine's model, f32."""
    params = load_checkpoint(path)[0]
    params = {layer: {k: (np.asarray(v, np.float32)
                          if np.issubdtype(np.asarray(v).dtype, np.floating)
                          else np.asarray(v)) for k, v in d.items()}
              for layer, d in params.items()}
    return expr._load_model(spec, params)


def _current(expr, spec, j, model):
    return (_model(expr, spec, j.path("curr_weights.npz")) if model is None
            else model)


def test_scores_matrix(expr, method_name: str,
                       start_ind: int = 0) -> np.ndarray:
    """(n_test_subjects, n_rounds) F-measures: round ``i``'s weight
    checkpoint ``curr_weights_<i+1>.npz`` scored on every test subject's
    grid, streamed resumably to ``<method>/test_scores.txt`` (reference
    ``eval_MultimgAL``)."""
    from nnal_tpu_torch.data.samplers import generate_grid_samples
    from nnal_tpu_torch.data.stats import multimg_stats

    j = MethodJournal(expr.root_dir, method_name)
    spec = expr.build_model()
    iters = j.query_iters()
    qnum = len(iters)
    imgnum = len(expr.test_subjects)
    save_path = j.path("test_scores.txt")
    scores = np.zeros((imgnum, qnum))
    if start_ind > 0 and os.path.exists(save_path):
        # the saved matrix may be narrower than the journal (rounds ran
        # since the last scoring pass): copy it into the leading slice;
        # ndmin=2 keeps a single-column save a column
        old = np.loadtxt(save_path, ndmin=2)
        r, c = min(old.shape[0], imgnum), min(old.shape[1], qnum)
        scores[:r, :c] = old[:r, :c]

    evs = expr._evaluators(spec, "test", multimg_stats(expr.test_subjects))
    for i in range(start_ind, qnum):
        wpath = j.path(f"curr_weights_{iters[i] + 1}.npz")
        if not os.path.exists(wpath):
            continue
        model = _model(expr, spec, wpath)
        for s, ev in enumerate(evs):
            vols, mask = expr.test_subjects[s]
            inds, labels = generate_grid_samples(
                np.asarray(vols[0]).shape, expr.config.data.grid_spacing,
                mask)
            preds = ev.evaluate(model, inds, ("prediction",))["prediction"]
            scores[s, i] = f_measure(np.asarray(preds), labels)
        np.savetxt(save_path, scores)
    return scores


def _multi_evaluators(expr, spec):
    """Per-train-subject evaluators for a MultiImgExperiment (the matrix
    journal's subject column indexes these)."""
    from nnal_tpu_torch.data.stats import multimg_stats

    return expr._evaluators(spec, "train",
                            multimg_stats(expr.train_subjects))


def _grouped_eval(evs, model, qmat, ops):
    """Evaluate a (voxel, subject) query matrix through each subject's OWN
    evaluator, reassembled in column order (a single-subject evaluator
    would misread other subjects' raveled voxel ids)."""
    k = qmat.shape[1]
    out = [None] * k
    for si in np.unique(qmat[1]):
        m = np.flatnonzero(qmat[1] == si)
        r = np.asarray(evs[int(si)].evaluate(model, qmat[0][m],
                                             ops)[ops[0]])
        for j_, row in zip(m, r):
            out[int(j_)] = row
    return np.asarray(out)


def query_similarity_analysis(expr, method_name: str, model=None,
                              matrix: bool = False) -> List[np.ndarray]:
    """Per-round (k, k) cosine-similarity matrices of the queried patches'
    feature vectors (reference ``get_Qsims``).  ``matrix=True`` reads
    multi-subject journals, whose query files are (voxel, subject) 2 x k
    matrices (a k = 1 file reads like two 1-D indices, so the journal's
    shape cannot be detected).  ``model`` None: the method's current
    weights."""
    j = MethodJournal(expr.root_dir, method_name)
    spec = expr.build_model()
    # matrix journals come from MultiImgExperiment, whose evaluators are
    # per subject (a voxel id only means something within ITS subject)
    evs = _multi_evaluators(expr, spec) if matrix \
        else [expr.make_evaluator(spec)]
    model = _current(expr, spec, j, model)
    sims = []
    for it in j.query_iters():
        q = load_inds(os.path.join(j.queries_dir, f"{it}.txt"),
                      matrix=matrix)
        if matrix:
            F = _grouped_eval(evs, model, q, ("feature_layer",))
        else:
            F = np.asarray(evs[0].evaluate(
                model, q, ("feature_layer",))["feature_layer"])
        norms = np.linalg.norm(F, axis=1, keepdims=True)
        Fn = F / np.maximum(norms, 1e-12)
        sims.append(Fn @ Fn.T)
    return sims


def query_type_analysis(expr, method_name: str, var_kernel: int = 5,
                        var_thr: float = 2.0, matrix: bool = False
                        ) -> List[np.ndarray]:
    """Per-round partition types of the queried voxels — 0 masked /
    1 high-variance background / 2 low-variance background (reference
    ``get_queries_type`` / ``get_sample_type``, PW_analyze_results.py:
    52-85), recomputed from the mask and the log-local-variance rule of
    ``data.samplers.sample_masked_volume`` on the engine's device."""
    from nnal_tpu_torch.data.samplers import sample_types_of

    j = MethodJournal(expr.root_dir, method_name)
    subjects = (expr.train_subjects if matrix
                else [expr._load_subject()])
    types = []
    for it in j.query_iters():
        q = load_inds(os.path.join(j.queries_dir, f"{it}.txt"),
                      matrix=matrix)
        if matrix:
            out = np.zeros(q.shape[1], np.int64)
            for si in np.unique(q[1]):
                m = q[1] == si
                vols_s, mask_s = subjects[int(si)]
                out[m] = sample_types_of(np.asarray(vols_s[0]), mask_s,
                                         q[0][m], var_kernel=var_kernel,
                                         var_thr=var_thr,
                                         device=expr.device)
            types.append(out)
        else:
            vols, mask = subjects[0]
            types.append(sample_types_of(np.asarray(vols[0]), mask, q,
                                         var_kernel=var_kernel,
                                         var_thr=var_thr,
                                         device=expr.device))
    return types


def slice_query_preds(expr, method_name: str, slice_: int, model=None,
                      matrix: bool = False, subject: int = 0):
    """Class predictions of a method's journaled queries restricted to one
    axial slice (reference ``get_slice_preds``,
    PW_analyze_results.py:87-135).  Returns ``(preds, (rows, cols),
    flat_inds)`` for the queried voxels whose z coordinate is ``slice_``
    (of subject ``subject`` of a multi-subject journal)."""
    j = MethodJournal(expr.root_dir, method_name)
    spec = expr.build_model()
    if matrix:
        ev = _multi_evaluators(expr, spec)[subject]
        vols = expr.train_subjects[subject][0]
    else:
        ev = expr.make_evaluator(spec)
        vols, _ = expr._load_subject()
    model = _current(expr, spec, j, model)
    shape = np.asarray(vols[0]).shape
    qs = []
    for it in j.query_iters():
        q = load_inds(os.path.join(j.queries_dir, f"{it}.txt"),
                      matrix=matrix)
        if q.ndim == 2:
            q = q[0][q[1] == subject]
        qs.append(q)
    q = (np.concatenate(qs) if qs else np.zeros(0, np.int64))
    rows, cols, zs = np.unravel_index(q, shape)
    on = zs == slice_
    if not np.any(on):
        return np.zeros(0, np.int64), (rows[on], cols[on]), q[on]
    preds = ev.evaluate(model, q[on], ("prediction",))["prediction"]
    return np.asarray(preds), (rows[on], cols[on]), q[on]


def full_test_slice_dcrf(experiments: Sequence, method_name: str = "random",
                         slice_step: int = 2, backend: str = "auto") -> dict:
    """Whole-volume DCRF evaluation over several experiments (reference
    ``full_test_slice_DCRF``): for each experiment, load the method's
    current weights, refine every ``slice_step``-th axial slice with the
    DenseCRF and save results under ``<method>/full_preds``."""
    out = {}
    for expr in experiments:
        j = MethodJournal(expr.root_dir, method_name)
        spec = expr.build_model()
        ev = expr.make_evaluator(spec)
        model = _current(expr, spec, j, None)
        vols, mask = expr._load_subject()
        s3 = np.asarray(vols[0]).shape[2]
        slice_inds = np.arange(1, s3, slice_step)
        _, f1 = full_model_pred_dcrf(ev, model, np.asarray(vols[0]),
                                     np.asarray(mask), slice_inds,
                                     save_dir=j.path("full_preds"),
                                     backend=backend)
        out[expr.root_dir] = f1
    return out
