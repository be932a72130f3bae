"""AU_4U's perturbation in the port vs the JAX package (CPU), with JAX's
own normals fed through the port's noise function
(``tests/torch_jax_draws``).

Tolerance atol 1e-5: ``rotate_2d`` is ``map_coordinates``' arithmetic
written out (same taps, same order; ``cos``/``sin`` may part by an ulp),
and the divergences are f32 forwards that differ only in summation
order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnal_tpu.data.patches import pad_volumes as j_pad
from nnal_tpu.models.cnn import init_cnn
from nnal_tpu.models.perturb import (
    measure_output_perturbation as j_measure,
    rotate_2d as j_rotate,
)
from nnal_tpu.models.specs import create_pw1
from nnal_tpu.scoring import strategies as jstrat
from nnal_tpu.scoring.grid_eval import GridPoolEvaluator as JGrid
from nnal_tpu_torch.data.io import synthetic_subject
from nnal_tpu_torch.data.patches import pad_volumes
from nnal_tpu_torch.models.bridge import from_jax_params
from nnal_tpu_torch.models.cnn import CNN
from nnal_tpu_torch.models.perturb import (
    measure_output_perturbation,
    perturb_input,
    rotate_2d,
)
from nnal_tpu_torch.models.specs import create_pw1 as t_create_pw1
from nnal_tpu_torch.scoring import strategies as tstrat
from nnal_tpu_torch.scoring.grid_eval import GridPoolEvaluator as TGrid
from torch_jax_draws import KeyGen, inject

torch.set_num_threads(1)

ATOL = 1e-5
SHAPE = (16, 16, 8)


def _x(shape, seed=0, n=8):
    return np.array(jax.random.normal(jax.random.key(seed), (n,) + shape))


@pytest.mark.parametrize("angle", [0.3, np.pi / 2, -1.1])
@pytest.mark.parametrize("shape", [(25, 25, 2), (9, 12, 3)])
def test_rotate_2d_matches_jax(angle, shape):
    x = _x(shape)
    want = np.asarray(j_rotate(jnp.asarray(x), angle))
    got = rotate_2d(torch.from_numpy(x), angle)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # the NCHW layout of the grid sweep is the same function
    got_c = rotate_2d(torch.from_numpy(x).permute(0, 3, 1, 2), angle,
                      nchw=True)
    assert torch.equal(got_c.permute(0, 2, 3, 1), got)


def test_rotate_2d_bf16_rounds_once():
    x = _x((25, 25, 2), seed=1)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(j_rotate(xb, 0.3).astype(jnp.float32))
    got = rotate_2d(torch.from_numpy(np.array(xb.astype(jnp.float32))).to(
        torch.bfloat16), 0.3)
    assert got.dtype == torch.bfloat16
    # products and sums in f32, one rounding: at most one bf16 ulp apart
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-6)


def test_perturb_input_noise_then_rotation(monkeypatch):
    inject(monkeypatch)
    x = _x((9, 9, 2), seed=2)
    key = jax.random.key(7)
    want = x + 0.05 * np.asarray(jax.random.normal(key, x.shape))
    got = perturb_input(torch.from_numpy(x), KeyGen(key), 0.05, None)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    nchw = perturb_input(torch.from_numpy(x).permute(0, 3, 1, 2),
                         KeyGen(key), 0.05, 0.3, nchw=True)
    both = perturb_input(torch.from_numpy(x), KeyGen(key), 0.05, 0.3)
    assert torch.equal(nchw.permute(0, 2, 3, 1), both)


def _models(shape, seed=0):
    spec = create_pw1(2, 0.5, shape)
    params, _ = init_cnn(spec, jax.random.key(seed))
    model = CNN(t_create_pw1(2, 0.5, shape))
    model.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    return spec, params, model


@pytest.mark.parametrize("measure", ["CE", "L2"])
@pytest.mark.parametrize("angle", [None, 0.3])
def test_measure_output_perturbation_matches_jax(monkeypatch, measure,
                                                 angle):
    inject(monkeypatch)
    shape = (25, 25, 2)
    spec, params, model = _models(shape)
    x = _x(shape, seed=3, n=16)
    key = jax.random.key(8)
    want = np.asarray(j_measure(spec, params, jnp.asarray(x), key,
                                measure=measure, gaussian_std=0.05,
                                rotation_angle=angle))
    got = measure_output_perturbation(model, torch.from_numpy(x),
                                      KeyGen(key), measure=measure,
                                      gaussian_std=0.05,
                                      rotation_angle=angle)
    assert got.shape == (16,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def _evaluators():
    vols, _ = synthetic_subject(shape=SHAPE, n_modalities=2, seed=0)
    patch = (9, 9, 1)
    spec, params, model = _models((9, 9, 2))
    mu, sd = np.array([60.0, 75.0]), np.array([30.0, 31.0])
    jev = JGrid(spec, j_pad(vols, patch), mu, sd, patch, SHAPE,
                grid_spacing=2, ntb=64, z_chunk=3)
    tev = TGrid(model.spec, pad_volumes(vols, patch, device="cpu"), mu, sd,
                patch, SHAPE, grid_spacing=2, ntb=64, z_chunk=3)
    return spec, jev, tev, params, model


@pytest.mark.parametrize("measure,angle", [("CE", None), ("L2", 0.3)])
def test_perturb_sweep_matches_jax(monkeypatch, measure, angle):
    """The whole-grid sweep: each z-chunk's noise keyed on its index (8
    slices in chunks of 3, the last padded)."""
    inject(monkeypatch)
    _, jev, tev, params, model = _evaluators()
    key = jax.random.key(9)
    want = jev.perturb_sweep(params, key, measure=measure, gaussian_std=0.05,
                             rotation_angle=angle)
    got = tev.perturb_sweep(model, key, measure=measure, gaussian_std=0.05,
                            rotation_angle=angle)
    assert got.shape == want.shape == (8 * 8 * 8,)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("off_grid", [False, True])
def test_au_4u_strategy_matches_jax(monkeypatch, off_grid):
    """AU_4U's picks, grid sweep and off-grid per-chunk fallback (chunks
    keyed on their start, the ragged tail padded): identical to JAX's."""
    inject(monkeypatch)
    spec, jev, tev, params, model = _evaluators()
    rng = np.random.default_rng(1)
    if off_grid:
        inds = np.unique(np.ravel_multi_index(
            (2 * rng.integers(0, 8, 150) + 1, rng.integers(0, 16, 150),
             rng.integers(0, 8, 150)), SHAPE))
    else:
        xs, ys, zs = np.arange(0, 16, 2), np.arange(0, 16, 2), [0, 2, 4, 6]
        X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
        inds = np.ravel_multi_index((X.ravel(), Y.ravel(), Z.ravel()), SHAPE)
    key = jax.random.key(10)
    extra = {"gaussian_noise_std": 0.05, "rotation_angle": None,
             "output_perturbation_measure": "CE"}
    jctx = jstrat.QueryContext(spec=spec, params=params, evaluator=jev,
                               pool_inds=inds, k=12,
                               rng=np.random.default_rng(0), jax_rng=key,
                               extra=dict(extra))
    tctx = tstrat.QueryContext(spec=model.spec, params=model, evaluator=tev,
                               pool_inds=inds, k=12,
                               rng=np.random.default_rng(0), seed=key,
                               extra=dict(extra))
    want = jstrat._au_4u_scores(jctx)
    got = tstrat._au_4u_scores(tctx)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(tstrat.cnn_query(tctx, "AU_4U"),
                                  jstrat.cnn_query(jctx, "AU_4U"))
