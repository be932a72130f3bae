"""Grid evaluator, uncertainty filter and query strategies: the port vs the
JAX package on the same subject, weights and index sets (CPU).

Tolerance for posteriors/features: rtol 1e-4, atol 1e-5 — both are IEEE
f32 forwards of PW1 that differ only in summation order (see
``test_torch_models.py``).  Selections must be identical."""

import jax
import numpy as np
import pytest
import torch

from nnal_tpu.data.patches import pad_volumes as j_pad
from nnal_tpu.models.cnn import init_cnn
from nnal_tpu.models.specs import create_pw1
from nnal_tpu.scoring import strategies as jstrat
from nnal_tpu.scoring.grid_eval import GridPoolEvaluator as JGrid
from nnal_tpu.scoring.uncertainty import (
    binary_uncertainty_filter as j_filter,
)
from nnal_tpu_torch.data.patches import pad_volumes
from nnal_tpu_torch.data.io import synthetic_subject
from nnal_tpu_torch.models.bridge import from_jax_params
from nnal_tpu_torch.models.cnn import CNN
from nnal_tpu_torch.models.specs import create_pw1 as t_create_pw1
from nnal_tpu_torch.ops import gather as k2
from nnal_tpu_torch.scoring import strategies as tstrat
from nnal_tpu_torch.scoring.grid_eval import GridPoolEvaluator as TGrid
from nnal_tpu_torch.scoring.uncertainty import binary_uncertainty_filter

torch.set_num_threads(1)

SHAPE = (16, 16, 8)
TOL = dict(rtol=1e-4, atol=1e-5)


def _setup(d3, seed=0):
    vols, mask = synthetic_subject(shape=SHAPE, n_modalities=2, seed=seed)
    patch = (9, 9, d3)
    spec = create_pw1(2, 0.5, (9, 9, 2 * d3))
    params, _ = init_cnn(spec, jax.random.key(seed))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    mu, sd = np.array([60.0, 75.0]), np.array([30.0, 31.0])
    jev = JGrid(spec, j_pad(vols, patch), mu, sd, patch, SHAPE,
                grid_spacing=2, ntb=64, z_chunk=2)
    tev = TGrid(t_create_pw1(2, 0.5, (9, 9, 2 * d3)),
                pad_volumes(vols, patch, device="cpu"), mu, sd, patch, SHAPE,
                grid_spacing=2, ntb=64, z_chunk=2)
    model = CNN(tev.spec)
    model.load_state_dict(from_jax_params(np_params))
    return jev, tev, params, model, mask


def _grid_inds(z_values, g=2):
    xs = np.arange(0, SHAPE[0], g)
    ys = np.arange(0, SHAPE[1], g)
    X, Y, Z = np.meshgrid(xs, ys, np.asarray(z_values), indexing="ij")
    return np.ravel_multi_index((X.ravel(), Y.ravel(), Z.ravel()), SHAPE)


def _compare(jev, tev, params, model, inds, ops, as_device=False):
    want = jev.evaluate(params, inds, ops, as_device=as_device)
    got = tev.evaluate(model, inds, ops, as_device=as_device)
    for op in ops:
        w = np.asarray(want[op])
        g = got[op].numpy() if as_device else got[op]
        assert g.shape == w.shape, op
        if op == "prediction":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, **TOL)


# index sets that take each route of GridPoolEvaluator.evaluate:
# whole sweep (on-grid, most slabs), slab sweep (on-grid, few slabs / wide
# ops), per-patch gather (few off-grid), stride-1 slab sweep (dense
# off-grid)
@pytest.mark.parametrize("d3", [1, 3])
@pytest.mark.parametrize("route", ["whole", "slab", "gather", "dense"])
def test_grid_evaluator_matches_jax(d3, route):
    jev, tev, params, model, _ = _setup(d3)
    rng = np.random.default_rng(1)
    if route == "whole":
        inds = rng.permutation(_grid_inds(range(SHAPE[2])))
        ops = ("posteriors", "prediction")
    elif route == "slab":
        inds = _grid_inds([3])[::3]
        ops = ("posteriors", "feature_layer")
    elif route == "gather":
        inds = np.array([1 * 128 + 3 * 8 + 2, 5 * 128 + 7 * 8 + 6,
                         2 * 128 + 1 * 8 + 0])
        ops = ("posteriors", "prediction", "feature_layer")
    else:
        xs, ys = np.meshgrid(np.arange(1, 16), np.arange(0, 16),
                             indexing="ij")
        inds = np.ravel_multi_index(
            (xs.ravel(), ys.ravel(), np.full(xs.size, 4)), SHAPE)
        ops = ("posteriors",)
    launches = k2.KERNEL.launches
    _compare(jev, tev, params, model, inds, ops)
    assert k2.KERNEL.launches == launches      # CPU: plain version only


@pytest.mark.parametrize("d3", [1, 3])
def test_grid_evaluator_as_device_matches_jax(d3):
    jev, tev, params, model, _ = _setup(d3, seed=2)
    inds = _grid_inds([0, 2, 5])
    _compare(jev, tev, params, model, inds,
             ("posteriors", "feature_layer"), as_device=True)
    off = np.array([3, 77, 200])
    _compare(jev, tev, params, model, off, ("feature_layer",),
             as_device=True)


def test_even_depth_takes_the_gather_path():
    vols, _ = synthetic_subject(shape=SHAPE, n_modalities=2, seed=3)
    spec = t_create_pw1(2, 0.5, (9, 9, 4))
    tev = TGrid(spec, pad_volumes(vols, (9, 9, 2), device="cpu"),
                [0.0, 0.0], [1.0, 1.0],
                (9, 9, 2), SHAPE, grid_spacing=2)
    assert not tev._sweep_ok and tev._slices is None


def test_binary_uncertainty_filter_ties_break_by_index():
    p1 = np.array([0.5, 0.3, 0.7, 0.5, 0.3, 0.6], np.float32)
    want = np.asarray(j_filter(p1, 6))
    got = binary_uncertainty_filter(p1, 6)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [0, 3, 5, 1, 2, 4])
    # many exact ties over more than one padding bucket
    p1 = np.round(np.random.default_rng(0).uniform(size=3000), 2
                  ).astype(np.float32)
    np.testing.assert_array_equal(binary_uncertainty_filter(p1, 700),
                                  np.asarray(j_filter(p1, 700)))


@pytest.mark.parametrize("method", ["entropy", "core-set", "random"])
def test_strategies_pick_identically(method):
    jev, tev, params, model, mask = _setup(1, seed=4)
    grid = _grid_inds(range(0, SHAPE[2], 2))
    perm = np.random.default_rng(5).permutation(len(grid))
    train, pool = grid[perm[:20]], grid[perm[20:]]
    jctx = jstrat.QueryContext(
        spec=jev.spec, params=params, evaluator=jev, pool_inds=pool, k=10,
        rng=np.random.default_rng(6), jax_rng=jax.random.key(0),
        train_inds=train, extra={"mask": mask})
    tctx = tstrat.QueryContext(
        spec=tev.spec, params=model, evaluator=tev, pool_inds=pool, k=10,
        rng=np.random.default_rng(6), train_inds=train)
    want = jstrat.cnn_query(jctx, method)
    got = tstrat.cnn_query(tctx, method)
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) == 10


def test_unknown_strategy_raises():
    ctx = tstrat.QueryContext(spec=None, params=None, evaluator=None,
                              pool_inds=np.arange(3), k=1,
                              rng=np.random.default_rng(0))
    with pytest.raises(ValueError, match="unknown query method"):
        tstrat.cnn_query(ctx, "no-such-method")
