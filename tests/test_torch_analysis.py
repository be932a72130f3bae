"""The analysis routines (``evaluation/analysis.py``,
``engine/analysis.py``) and the analysis samplers (``data/samplers.py``)
against the JAX package's on the CPU.

A JAX-written single-subject directory (PW1 9x9x1, a 20x20x6 subject,
entropy for 2 rounds) is read by both packages: ``grid_based_f1``,
``full_model_eval``, ``full_model_pred_dcrf`` (2-D, native solver) and
``full_model_pred_dcrf3d`` give equal F-measures and segmentations
(predictions wherever JAX's p1 is more than 1e-4 from 0.5 — none here is
closer); ``query_similarity_analysis`` within 1e-5, ``query_type_analysis``
and ``slice_query_preds`` equal, ``full_test_slice_dcrf`` equal F and its
file.  ``pr_curves_from_predicts``, ``get_full_segs`` (its NRRD file read
back by JAX's reader), both ``eval_full_segs_*`` and the samplers
(``sample_masked_volume`` from one seed, ``sample_types_of``,
``filter_by_parcellation``) are equal.  The directory is deleted at the
end.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnal_tpu.core.config import ExperimentConfig as JConfig
from nnal_tpu.data import samplers as jsam
from nnal_tpu.data.formats import read_nrrd
from nnal_tpu.engine import analysis as jea
from nnal_tpu.engine.pw_experiment import PWExperiment as JExpr
from nnal_tpu.evaluation import analysis as jan
from nnal_tpu.models.checkpoint import load_checkpoint as j_load
from nnal_tpu_torch.data import samplers as tsam
from nnal_tpu_torch.data.io import synthetic_subject
from nnal_tpu_torch.engine import analysis as tea
from nnal_tpu_torch.engine.pw_experiment import PWExperiment
from nnal_tpu_torch.evaluation import analysis as tan

torch.set_num_threads(1)

PARS = {"model_name": "PW", "nclass": 2, "patch_shape": (9, 9, 1),
        "grid_spacing": 4, "k": 3, "B": 12, "ntb": 256, "b": 32,
        "epochs": 1, "learning_rate": 3e-4, "optimizer_name": "Adam",
        "dropout_rate": 0.2, "init_size": 4, "seed": 5}
SUBJECT = synthetic_subject(shape=(20, 20, 6), n_modalities=1, seed=5,
                            n_blobs=6)
SLICES = [1, 3]


@pytest.fixture(scope="module")
def exprs(tmp_path_factory):
    top = tmp_path_factory.mktemp("analysis")
    root = str(top / "expr")
    try:
        jexpr = JExpr(root, JConfig.from_pars(PARS))
        jexpr.attach_subject(*SUBJECT)
        jexpr.prep_data()
        jexpr.add_method("entropy")
        jexpr.run_method("entropy", 6)          # 2 rounds
        texpr = PWExperiment(root, device="cpu")
        texpr.attach_subject(*SUBJECT)
        yield jexpr, texpr, top
    finally:
        shutil.rmtree(top, ignore_errors=True)


def _weights(jexpr, texpr):
    path = os.path.join(jexpr.root_dir, "entropy", "curr_weights.npz")
    params = j_load(path)[0]
    return (jax.tree_util.tree_map(jnp.asarray, params),
            texpr._load_model(texpr.build_model(), params))


def _evs(jexpr, texpr):
    return (jexpr.make_evaluator(jexpr.build_model()),
            texpr.make_evaluator(texpr.build_model()))


def test_grid_f1_and_full_model_eval(exprs):
    jexpr, texpr, top = exprs
    jp, model = _weights(jexpr, texpr)
    jev, tev = _evs(jexpr, texpr)
    mask = SUBJECT[1]
    assert tan.grid_based_f1(tev, model, mask, spacing=4) == \
        jan.grid_based_f1(jev, jp, mask, spacing=4)
    want, wf = jan.full_model_eval(jev, jp, mask, SLICES)
    got, gf = tan.full_model_eval(tev, model, mask, SLICES,
                                  save_dir=str(top / "fme"))
    np.testing.assert_array_equal(got, want)
    assert gf == wf
    assert np.loadtxt(top / "fme" / "F1_score.txt") == gf
    np.testing.assert_array_equal(np.load(top / "fme" / "segs.npy"), got)


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_full_model_pred_dcrf(exprs, dim):
    jexpr, texpr, top = exprs
    jp, model = _weights(jexpr, texpr)
    jev, tev = _evs(jexpr, texpr)
    vols, mask = SUBJECT
    if dim == "2d":
        want, wf = jan.full_model_pred_dcrf(jev, jp, vols[0], mask, SLICES)
        got, gf = tan.full_model_pred_dcrf(tev, model, vols[0], mask,
                                           SLICES, save_dir=str(top / "d"),
                                           backend="native")
        assert os.path.exists(top / "d" / "F1_score_dcrf.txt")
    else:
        want, wf = jan.full_model_pred_dcrf3d(jev, jp, vols[0], mask,
                                              SLICES)
        got, gf = tan.full_model_pred_dcrf3d(tev, model, vols[0], mask,
                                             SLICES)
    np.testing.assert_array_equal(got, want)
    assert gf == wf


def test_query_analyses(exprs):
    jexpr, texpr, _ = exprs
    jp, model = _weights(jexpr, texpr)
    want = jea.query_similarity_analysis(jexpr, "entropy")
    got = tea.query_similarity_analysis(texpr, "entropy")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5)
    for g, w in zip(tea.query_type_analysis(texpr, "entropy"),
                    jea.query_type_analysis(jexpr, "entropy")):
        np.testing.assert_array_equal(g, w)
    for z in range(SUBJECT[1].shape[2]):
        g = tea.slice_query_preds(texpr, "entropy", z, model=model)
        w = jea.slice_query_preds(jexpr, "entropy", z, params=jp)
        for a, b in zip((g[0],) + g[1] + (g[2],), (w[0],) + w[1] + (w[2],)):
            np.testing.assert_array_equal(a, b)


def test_full_test_slice_dcrf(exprs):
    jexpr, texpr, _ = exprs
    out_dir = os.path.join(jexpr.root_dir, "entropy", "full_preds")
    want = jea.full_test_slice_dcrf([jexpr], "entropy", slice_step=3)
    wsegs = np.load(os.path.join(out_dir, "dcrf_segs.npy"))
    shutil.rmtree(out_dir)
    got = tea.full_test_slice_dcrf([texpr], "entropy", slice_step=3,
                                   backend="native")
    assert got == want
    np.testing.assert_array_equal(
        np.load(os.path.join(out_dir, "dcrf_segs.npy")), wsegs)


def test_pr_curves_and_dataset_scoring(tmp_path):
    labels = np.array([1, 0, 1, 1, 0])
    preds = np.array([[1, 0, 0, 1, 0], [1, 1, 1, 1, 1]])
    p = str(tmp_path / "predicts.txt")
    np.savetxt(p, preds, fmt="%d")
    np.testing.assert_array_equal(tan.pr_curves_from_predicts(p, labels),
                                  jan.pr_curves_from_predicts(p, labels))
    rng = np.random.default_rng(2)
    subjects = []
    for s in range(2):
        vols, mask = synthetic_subject(shape=(16, 16, 12), n_modalities=1,
                                       seed=10 + s, n_blobs=4)
        subjects.append((vols, np.nan_to_num(mask)))

    def segment(vols):
        return (vols[0] > np.median(vols[0])).astype(np.uint8)

    segs, f1s = tan.get_full_segs(segment, subjects, post_process=True,
                                  save_dir=str(tmp_path / "segs"))
    wsegs, wf1s = jan.get_full_segs(segment, subjects, post_process=True)
    np.testing.assert_array_equal(f1s, wf1s)
    for i, (g, w) in enumerate(zip(segs, wsegs)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(
            read_nrrd(str(tmp_path / "segs" / f"seg_{i}.nrrd"))[0], g)
    masks = [m for _, m in subjects]
    for parts in ([4, 8], rng.integers(2, 10, size=(2, 2))):
        for g, w in zip(tan.eval_full_segs_explicit_partitions(
                segs, masks, np.sort(parts, axis=-1)),
                jan.eval_full_segs_explicit_partitions(
                    segs, masks, np.sort(parts, axis=-1))):
            np.testing.assert_array_equal(g, w)
    for g, w in zip(tan.eval_full_segs_label_percentage(segs, masks,
                                                        percentage=0.01),
                    jan.eval_full_segs_label_percentage(segs, masks,
                                                        percentage=0.01)):
        np.testing.assert_array_equal(g, w)


def test_samplers():
    vols, mask = synthetic_subject(shape=(24, 24, 6), n_modalities=1,
                                   seed=3, n_blobs=5)
    img = vols[0] * 0.3          # both variance groups occur
    mask = np.nan_to_num(mask)
    got = tsam.sample_masked_volume(img, mask, [0, 2, 5], (5, 7, 9),
                                    np.random.default_rng(4), device="cpu")
    want = jsam.sample_masked_volume(img, mask, [0, 2, 5], (5, 7, 9),
                                     np.random.default_rng(4))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert set(got[2].tolist()) == {0, 1, 2}
    inds = np.arange(0, img.size, 7)
    np.testing.assert_array_equal(
        tsam.sample_types_of(img, mask, inds, device="cpu"),
        jsam.sample_types_of(img, mask, inds))
    parc = (np.arange(img.size).reshape(img.shape) % 3).astype(np.int64)
    labels = np.arange(len(inds)) % 2
    for g, w in zip(tsam.filter_by_parcellation(inds, labels, parc),
                    jsam.filter_by_parcellation(inds, labels, parc)):
        np.testing.assert_array_equal(g, w)
