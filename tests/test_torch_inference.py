"""Serving on the port (``evaluation/inference``, ``evaluation/postproc``,
``cli/run_on_subjects``) against the JAX package on the CPU, from the same
numpy weights and inputs.

* ``full_volume_patchwise`` of PW1 (9x9 patches, 2 modalities) over a
  20x20x6 subject through a grid evaluator re-spaced to stride 1:
  posteriors within 1e-5, predictions equal wherever JAX's p1 is more
  than 1e-4 from 0.5, float and int8.
* ``FCNInference`` on the small FC-DenseNet of ``tests/torch_jax_dense.py``
  with its BN state: ``posteriors`` and ``prediction`` (1e-5), ``output``
  (5e-5), ``loss`` (1e-5; NaN one-hots mark unlabeled voxels),
  ``sigma`` / ``MC-sigma`` on the aleatoric head (1e-4 relative) and
  ``MC-posteriors`` (1e-5) with JAX's dropout draws injected
  (``tests/torch_jax_draws.py``), and bf16 posteriors (5e-2, predictions
  equal on 97% of voxels, the JAX package's own bf16-serving bound
  against f32); ``ShapeCachedFCN`` builds one per shape.
* ``run_on_subjects`` over two held subjects of a JAX experiment
  directory: the F-measures and the ``segs.npy`` files equal JAX's,
  float and int8.
* ``postproc``: equal arrays.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnal_tpu.cli.run_on_subjects import run_on_subjects as j_run
from nnal_tpu.core.config import ExperimentConfig as JConfig
from nnal_tpu.data.io import synthetic_subject
from nnal_tpu.data.patches import pad_volumes as j_pad
from nnal_tpu.engine.pw_experiment import PWExperiment as JExpr
from nnal_tpu.evaluation import inference as j_inf
from nnal_tpu.evaluation import postproc as j_post
from nnal_tpu.models.cnn import init_cnn as j_init_cnn
from nnal_tpu.models.quant import quantize_params as j_quantize
from nnal_tpu.models.specs import create_model as j_create_model
from nnal_tpu.models.specs import with_aleatoric_head as j_aleatoric
from nnal_tpu.scoring.grid_eval import GridPoolEvaluator as JGrid
from nnal_tpu_torch.cli.run_on_subjects import run_on_subjects as t_run
from nnal_tpu_torch.data.patches import pad_volumes as t_pad
from nnal_tpu_torch.engine.pw_experiment import PWExperiment as TExpr
from nnal_tpu_torch.evaluation import inference as t_inf
from nnal_tpu_torch.evaluation import postproc as t_post
from nnal_tpu_torch.models.bridge import bn_state_to_port
from nnal_tpu_torch.models.quant import quantize_params as t_quantize
from nnal_tpu_torch.models.quant import quantized_cnn
from nnal_tpu_torch.models.specs import create_model as t_create_model
from nnal_tpu_torch.models.specs import with_aleatoric_head as t_aleatoric
from nnal_tpu_torch.scoring.grid_eval import GridPoolEvaluator as TGrid
from torch_jax_dense import dense_specs, jax_weights, port_model, slices
from torch_jax_draws import inject

torch.set_num_threads(1)

PS = (9, 9, 1)
SHAPE = (20, 20, 6)


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def pw():
    jspec = j_create_model("PW", nclass=2, patch_shape=(9, 9, 2))
    tspec = t_create_model("PW", nclass=2, patch_shape=(9, 9, 2))
    params, _ = j_init_cnn(jspec, jax.random.key(0))
    return jspec, tspec, _tree(params)


@pytest.mark.parametrize("quant", [False, True])
def test_full_volume_patchwise_matches_jax(pw, quant):
    jspec, tspec, params = pw
    vols, _ = synthetic_subject(shape=SHAPE, n_modalities=2, seed=5,
                                n_blobs=6)
    mu = np.array([float(np.mean(v)) for v in vols])
    sd = np.array([float(np.std(v)) + 1e-6 for v in vols])
    jev = JGrid(jspec, j_pad(vols, PS), mu, sd, PS, SHAPE, grid_spacing=2,
                ntb=256)
    tev = TGrid(tspec, t_pad(vols, PS, device="cpu"), mu, sd, PS, SHAPE,
                grid_spacing=2, ntb=256)
    if quant:
        jp = j_quantize(jspec, params)
        model = quantized_cnn(tspec, t_quantize(tspec, params), device="cpu")
    else:
        jp = params
        model = port_model(tspec, params)
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    want = j_inf.full_volume_patchwise(jev, jp, "posteriors")
    got = t_inf.full_volume_patchwise(tev, model, "posteriors")
    assert got.shape == SHAPE
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    pred_j = j_inf.full_volume_patchwise(jev, jp, "prediction")
    pred_t = t_inf.full_volume_patchwise(tev, model, "prediction")
    sure = np.abs(want - 0.5) > 1e-4
    np.testing.assert_array_equal(pred_t[sure], pred_j[sure])
    planes = t_inf.full_slice_patchwise(tev, model, [1, 4], "posteriors")
    assert set(planes) == {1, 4}
    np.testing.assert_array_equal(planes[4], got[:, :, 4])
    assert t_inf.full_slice_patchwise(tev, model, []) == {}


@pytest.fixture(scope="module")
def dense():
    jspec, tspec = dense_specs()
    params, state = jax_weights(jspec)
    jspec_a, tspec_a = j_aleatoric(jspec), t_aleatoric(tspec)
    params_a, _ = jax_weights(jspec_a, seed=3)
    x, _ = slices(3)
    return dict(
        jspec=jspec, tspec=tspec, params=params, state=state,
        model=port_model(tspec, params),
        jspec_a=jspec_a, tspec_a=tspec_a, params_a=params_a,
        model_a=port_model(tspec_a, params_a), x=x)


def _pair(d, aleatoric=False, **kw):
    suffix = "_a" if aleatoric else ""
    jp = jax.tree_util.tree_map(jnp.asarray, d["params" + suffix])
    jst = jax.tree_util.tree_map(jnp.asarray, d["state"])
    ji = j_inf.FCNInference(d["jspec" + suffix], batch=2, bn_state=jst, **kw)
    kw = {k: (torch.bfloat16 if v is not None else None)
          for k, v in kw.items()}
    ti = t_inf.FCNInference(d["tspec" + suffix], batch=2,
                            bn_state=bn_state_to_port(d["state"], "cpu"),
                            device="cpu", **kw)
    return ji, jp, ti, d["model" + suffix]


@pytest.mark.parametrize("op,atol", [("prediction", 0), ("posteriors", 1e-5),
                                     ("output", 5e-5)])
def test_fcn_inference_deterministic_ops(dense, op, atol):
    ji, jp, ti, model = _pair(dense)
    want = ji.segment(jp, dense["x"], op)
    got = ti.segment(model, dense["x"], op)
    assert got.shape == want.shape and got.dtype == want.dtype
    if op == "prediction":
        post = ji.segment(jp, dense["x"], "posteriors")[..., 1]
        sure = np.abs(post - 0.5) > 1e-4
        np.testing.assert_array_equal(got[sure], want[sure])
    else:
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_fcn_inference_loss(dense):
    ji, jp, ti, model = _pair(dense)
    rng = np.random.default_rng(7)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (3, 24, 24))]
    y[rng.random((3, 24, 24)) < 0.4] = np.nan          # unlabeled voxels
    y[2] = np.nan                                     # a slice without any
    want = ji.segment(jp, dense["x"], "loss", labels=y)
    got = ti.segment(model, dense["x"], "loss", labels=y)
    assert got.shape == (3,)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="labels"):
        ti.segment(model, dense["x"], "loss")


@pytest.mark.parametrize("op", ["MC-posteriors", "MC-sigma", "sigma"])
def test_fcn_inference_stochastic_and_sigma_ops(dense, op, monkeypatch):
    inject(monkeypatch)
    ji, jp, ti, model = _pair(dense, aleatoric=op != "MC-posteriors")
    key = jax.random.key(11)
    want = ji.segment(jp, dense["x"], op, mc_T=3, rng=key)
    got = ti.segment(model, dense["x"], op, mc_T=3, rng=key)
    assert got.shape == want.shape
    if op == "MC-posteriors":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        assert (got > 0).all()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


def test_fcn_inference_bf16(dense):
    ji, jp, ti, model = _pair(dense, compute_dtype=jnp.bfloat16)
    want = ji.segment(jp, dense["x"], "posteriors")
    got = ti.segment(model, dense["x"], "posteriors")
    assert got.dtype == np.float32
    assert np.abs(got - want).max() < 5e-2
    assert np.mean(got.argmax(-1) == want.argmax(-1)) > 0.97


def test_shape_cached_fcn():
    made = []

    def factory(shape):
        made.append(shape)
        return dense_specs(H=shape[0], W=shape[1])[1]

    cache = t_inf.ShapeCachedFCN(factory, device="cpu")
    a = cache.for_shape((16, 16))
    assert cache.for_shape([16, 16]) is a
    b = cache.for_shape((16, 24))
    assert b is not a and b.spec.input_shape[:2] == (16, 24)
    assert made == [(16, 16), (16, 24)]
    with pytest.raises(ValueError, match="dense"):
        t_inf.FCNInference(t_create_model("PW", nclass=2, patch_shape=PS),
                           device="cpu")


def test_run_on_subjects_matches_jax(tmp_path):
    pars = {"model_name": "PW", "patch_shape": PS, "grid_spacing": 2,
            "k": 4, "B": 16, "ntb": 256, "b": 16, "epochs": 1,
            "init_size": 8}
    root = str(tmp_path / "e")
    vols, mask = synthetic_subject(shape=SHAPE, n_modalities=2, seed=0,
                                   n_blobs=8)
    jexpr = JExpr(root, JConfig.from_pars(dict(pars)))
    jexpr.attach_subject(vols, mask)
    jexpr.prep_data()
    jexpr.add_method("entropy")
    texpr = TExpr(root, device="cpu")
    texpr.attach_subject(vols, mask)
    held = [synthetic_subject(shape=SHAPE, n_modalities=2, seed=s,
                              n_blobs=8) for s in (21, 22)]
    params, f_float = None, None
    for quant in (False, True):
        if quant:
            from nnal_tpu.models.checkpoint import load_checkpoint
            params = _tree(load_checkpoint(os.path.join(
                root, "entropy", "curr_weights.npz"))[0])
            jq = j_quantize(jexpr.build_model(), params)
            tq = t_quantize(texpr.build_model(), params)
        jdir, tdir = str(tmp_path / f"j{quant}"), str(tmp_path / f"t{quant}")
        want = j_run(jexpr, "entropy", held, save_dir=jdir,
                     params=jax.tree_util.tree_map(jnp.asarray, jq)
                     if quant else None)
        got = t_run(texpr, "entropy", held, save_dir=tdir,
                    params=tq if quant else None, device="cpu")
        assert set(got) == {0, 1}
        f_float = f_float or got
        for i in (0, 1):
            assert got[i] == pytest.approx(want[i], abs=1e-12)
            sj = np.load(os.path.join(jdir, str(i), "segs.npy"))
            st = np.load(os.path.join(tdir, str(i), "segs.npy"))
            assert st.dtype == np.uint8 and st.shape == SHAPE
            np.testing.assert_array_equal(st, sj)
            np.testing.assert_allclose(
                np.loadtxt(os.path.join(tdir, str(i), "F1_score.txt")),
                np.loadtxt(os.path.join(jdir, str(i), "F1_score.txt")))
    # bf16 serving of the same weights agrees with f32 on most voxels
    f16 = t_run(texpr, "entropy", held[:1], device="cpu",
                compute_dtype=torch.bfloat16)
    assert abs(f16[0] - f_float[0]) < 0.1
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".npz"):
                os.remove(os.path.join(dirpath, f))


def test_postproc_matches_jax():
    rng = np.random.default_rng(3)
    seg = (rng.random((12, 12, 6)) > 0.6).astype(np.uint8)
    seg[0, 0, 0] = 0
    seg[3:9, 3:9, 1:5] = 1
    seg[5, 5, 2] = 0                                  # a hole
    for fn in ("largest_connected_component", "fill_holes"):
        np.testing.assert_array_equal(getattr(t_post, fn)(seg),
                                      getattr(j_post, fn)(seg))
    for kw in ({}, {"keep_largest": False}, {"holes": False}):
        np.testing.assert_array_equal(
            t_post.postprocess_segmentation(seg, **kw),
            j_post.postprocess_segmentation(seg, **kw))
    for min_size in (0, 3):
        (lt, st), (lj, sj) = (t_post.lesion_components(seg, min_size),
                              j_post.lesion_components(seg, min_size))
        np.testing.assert_array_equal(lt, lj)
        np.testing.assert_array_equal(st, sj)
    empty = np.zeros((4, 4, 2), np.uint8)
    np.testing.assert_array_equal(t_post.largest_connected_component(empty),
                                  j_post.largest_connected_component(empty))
