"""The sharded pool selectors and segmenter (``parallel/pool_sharded.py``)
on the CPU, against the JAX package's on the conftest's 8-device mesh
(same weights through ``models/bridge``) and against the port's own
unsharded sweeps.

* ``make_sharded_pool_selector`` (K2's plain version per shard): the same
  picks as JAX's and as an unsharded ``PoolEvaluator`` top-k (values bit
  for bit); with tied scores (repeated pool voxels and the pad rows'
  ``-inf``) the lower index comes first, as ``lax.top_k``'s.
* ``make_sharded_grid_selector`` / ``make_sharded_fim_grid_selector``:
  rows equal to JAX's and to the unsharded evaluator's top-k; values,
  posteriors and shrunk gradients bit-equal to the unsharded sweep's;
  against JAX scores within 1e-5 and shrunk gradients per
  ``tests/test_torch_fim.py``'s row rule.
* ``make_sharded_dense_segmenter``: the volume bit-equal to
  ``full_volume_patchwise`` at f32 and bf16, within 1e-5 of JAX's.
* ``grid_row_to_voxel``: equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnal_tpu.data.patches import pad_volumes as j_pad
from nnal_tpu.models.cnn import init_cnn as j_init_cnn
from nnal_tpu.models.specs import create_pw1 as j_create_pw1
from nnal_tpu.parallel import pool_sharded as jps
from nnal_tpu.parallel.mesh import make_mesh as j_make_mesh
from nnal_tpu_torch.data.io import synthetic_subject
from nnal_tpu_torch.data.patches import pad_volumes
from nnal_tpu_torch.data.samplers import generate_grid_samples
from nnal_tpu_torch.evaluation.inference import full_volume_patchwise
from nnal_tpu_torch.models.specs import create_pw1
from nnal_tpu_torch.parallel import pool_sharded as tps
from nnal_tpu_torch.parallel.mesh import make_mesh, stable_topk
from nnal_tpu_torch.scoring.grid_eval import GridPoolEvaluator
from nnal_tpu_torch.scoring.pool_eval import PoolEvaluator
from test_torch_fim import assert_rows_close
from torch_jax_dense import port_model

torch.set_num_threads(1)

SHAPE = (20, 24, 8)
PS = (9, 9, 1)
VOLS, _ = synthetic_subject(shape=SHAPE, n_modalities=2, seed=0)
MU = np.array([v.mean() for v in VOLS])
SD = np.array([v.std() for v in VOLS])


@pytest.fixture(scope="module")
def pair():
    jspec = j_create_pw1(2, 0.0, (9, 9, 2))
    params, _ = j_init_cnn(jspec, jax.random.key(0))
    params = jax.tree_util.tree_map(np.asarray, params)
    return (jspec, jax.tree_util.tree_map(jnp.asarray, params),
            port_model(create_pw1(2, 0.0, (9, 9, 2)), params))


def _padded():
    return pad_volumes(VOLS, PS, device="cpu")


@pytest.mark.parametrize("tied", [False, True])
def test_pool_selector(pair, tied):
    jspec, jp, model = pair
    pool = np.random.default_rng(1).choice(np.prod(SHAPE), size=333,
                                           replace=False).astype(np.int64)
    if tied:                  # repeated voxels score equal; 333 % 2 pads
        pool[1::3] = pool[0::3][:len(pool[1::3])]
    k, dp = 11, 2
    vals, pos = tps.make_sharded_pool_selector(
        make_mesh(dp, device="cpu"), PS, SHAPE, k, ntb_per_shard=64)(
        model, _padded(), MU, SD, pool)
    # unsharded: the same 64-row chunks of each shard's half
    n = len(pool) + (-len(pool) % dp)
    ev = PoolEvaluator(model.spec, _padded(), MU, SD, PS, SHAPE, ntb=64)
    p1 = np.concatenate([ev.evaluate(model, pool[i:i + n // dp])[
        "posteriors"] for i in range(0, n, n // dp)])
    r_vals, r_pos = stable_topk(-torch.as_tensor(np.abs(p1 - 0.5)), k)
    np.testing.assert_array_equal(pos, r_pos.numpy())
    np.testing.assert_array_equal(vals, r_vals.numpy())
    jv, jpos = jps.make_sharded_pool_selector(jspec, j_make_mesh(8), PS,
                                              SHAPE, k)(
        jp, j_pad(VOLS, PS), MU, SD, pool)
    np.testing.assert_allclose(vals, jv, atol=1e-5, rtol=0)
    if tied:                  # ties: the lower index first, as lax.top_k
        assert set(pos) == set(jpos)
        for v in np.unique(vals):
            assert np.all(np.diff(pos[vals == v]) > 0)
    else:
        np.testing.assert_array_equal(pos, jpos)


def _grid_reference(model, g, z_inner, fim):
    ev = GridPoolEvaluator(model.spec, _padded(), MU, SD, PS, SHAPE,
                           grid_spacing=g, z_chunk=z_inner)
    if fim:
        return ev.fim_sweep(model, as_device=True)
    inds = generate_grid_samples(SHAPE, g)
    return torch.as_tensor(ev.evaluate(model, inds)["posteriors"])


@pytest.mark.parametrize("dp", [2, 4])
def test_grid_selector(pair, dp):
    jspec, jp, model = pair
    k, g = 9, 2
    vals, rows = tps.make_sharded_grid_selector(
        make_mesh(dp, device="cpu"), PS, SHAPE, g, k)(model, _padded(),
                                                      MU, SD)
    p1 = _grid_reference(model, g, 2, False)
    r_vals, r_rows = stable_topk(-(p1 - 0.5).abs(), k)
    np.testing.assert_array_equal(rows, r_rows.numpy())
    np.testing.assert_array_equal(vals, r_vals.numpy())
    jv, jrows = jps.make_sharded_grid_selector(jspec, j_make_mesh(8), PS,
                                               SHAPE, g, k)(
        jp, j_pad(VOLS, PS), MU, SD)
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_allclose(vals, jv, atol=1e-5, rtol=0)
    inds = generate_grid_samples(SHAPE, g)
    np.testing.assert_array_equal(
        tps.grid_row_to_voxel(rows, SHAPE, g),
        jps.grid_row_to_voxel(jrows, SHAPE, g))
    np.testing.assert_array_equal(tps.grid_row_to_voxel(
        np.arange(len(inds)), SHAPE, g), inds)


def test_fim_grid_selector(pair):
    jspec, jp, model = pair
    B, g = 12, 3
    vals, rows, p1, shrunk = tps.make_sharded_fim_grid_selector(
        make_mesh(2, device="cpu"), PS, SHAPE, g, B)(model, _padded(), MU,
                                                     SD)
    ref = _grid_reference(model, g, 2, True)
    r_vals, r_pos = stable_topk(-ref["uncertainty"], B)
    np.testing.assert_array_equal(rows, r_pos.numpy())
    np.testing.assert_array_equal(vals, r_vals.numpy())
    np.testing.assert_array_equal(p1, ref["p1"][r_pos].numpy())
    np.testing.assert_array_equal(shrunk, ref["shrunk"][r_pos].numpy())
    jv, jrows, jp1, jshrunk = jps.make_sharded_fim_grid_selector(
        jspec, j_make_mesh(8), PS, SHAPE, g, B)(jp, j_pad(VOLS, PS), MU, SD)
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_allclose(p1, jp1, atol=1e-5, rtol=0)
    assert_rows_close(shrunk, jshrunk)


@pytest.mark.parametrize("cd", [None, torch.bfloat16])
def test_dense_segmenter(pair, cd):
    jspec, jp, model = pair
    ev = GridPoolEvaluator(model.spec, _padded(), MU, SD, PS, SHAPE,
                           grid_spacing=1, z_chunk=1, compute_dtype=cd)
    vol = tps.make_sharded_dense_segmenter(
        make_mesh(2, device="cpu"), PS, SHAPE, compute_dtype=cd)(
        model, _padded(), MU, SD)
    assert vol.shape == SHAPE
    np.testing.assert_array_equal(vol, full_volume_patchwise(
        ev, model, "posteriors"))
    pred = tps.make_sharded_dense_segmenter(
        make_mesh(2, device="cpu"), PS, SHAPE, op="prediction")(
        model, _padded(), MU, SD)
    if cd is None:
        want = jps.make_sharded_dense_segmenter(jspec, j_make_mesh(8), PS,
                                                SHAPE)(jp, j_pad(VOLS, PS),
                                                       MU, SD)
        np.testing.assert_allclose(vol, want, atol=1e-5, rtol=0)
        sure = np.abs(want - 0.5) > 1e-4
        np.testing.assert_array_equal(pred[sure], (want > 0.5)[sure])
