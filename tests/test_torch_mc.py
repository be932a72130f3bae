"""MC dropout in the port vs the JAX package, with JAX's own dropout
uniforms fed through the port's draw function (``tests/torch_jax_draws``)
(CPU).

Tolerance: posteriors atol 1e-5 at f32 (the same masks; both forwards
are IEEE f32 and part only in summation order); at bf16 max 5e-3, the
bf16 forward's rule of ``test_torch_mixed_precision.py``.  The keying
checks are bitwise: a slab evaluation draws the masks the whole sweep
draws for the same grid rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnal_tpu.data.patches import pad_volumes as j_pad
from nnal_tpu.models.cnn import apply_cnn, cast_float_params, init_cnn
from nnal_tpu.models.specs import create_pw1
from nnal_tpu.scoring import pool_eval as jpe
from nnal_tpu.scoring.grid_eval import GridPoolEvaluator as JGrid
from nnal_tpu_torch.data.io import synthetic_subject
from nnal_tpu_torch.data.patches import pad_volumes
from nnal_tpu_torch.models.bridge import from_jax_params
from nnal_tpu_torch.models.cnn import CNN
from nnal_tpu_torch.models.specs import create_pw1 as t_create_pw1
from nnal_tpu_torch.scoring import pool_eval as tpe
from nnal_tpu_torch.scoring.grid_eval import GridPoolEvaluator as TGrid
from torch_jax_draws import KeyGen, inject

torch.set_num_threads(1)

SHAPE = (16, 16, 8)
TOL = dict(rtol=0, atol=1e-5)


def _models(shape, dropout=0.5, seed=0):
    spec = create_pw1(2, dropout, shape)
    params, _ = init_cnn(spec, jax.random.key(seed))
    model = CNN(t_create_pw1(2, dropout, shape))
    model.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    return spec, params, model


@pytest.mark.parametrize("shape", [(9, 9, 2), (25, 25, 2)])
def test_mc_forward_with_jax_uniforms(monkeypatch, shape):
    """fc1, fc2 and the logits layer drop out; the same uniforms give the
    same posteriors and features."""
    inject(monkeypatch)
    spec, params, model = _models(shape)
    x = np.array(jax.random.normal(jax.random.key(3), (24,) + shape))
    key = jax.random.key(11)
    want = apply_cnn(spec, params, jnp.asarray(x), mc_dropout=True,
                     dropout_rng=key)
    with torch.no_grad():
        got = model(torch.from_numpy(x), mc_dropout=True,
                    generator=KeyGen(key))
        det = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.posteriors.numpy(),
                               np.asarray(want.posteriors), **TOL)
    np.testing.assert_allclose(got.feature.numpy(), np.asarray(want.feature),
                               rtol=1e-4, atol=1e-5)
    # dropout really ran: the masked posteriors are not the deterministic
    assert np.abs(got.posteriors.numpy() - det.posteriors.numpy()).max() \
        > 1e-3


def test_mc_forward_bf16_with_jax_uniforms(monkeypatch):
    """bf16: the masks apply to bf16 activations (``h / keep`` at bf16)."""
    inject(monkeypatch)
    shape = (25, 25, 2)
    spec, params, model = _models(shape)
    x = np.array(jax.random.normal(jax.random.key(4), (32,) + shape))
    key = jax.random.key(12)
    want = apply_cnn(spec, cast_float_params(params, jnp.bfloat16),
                     jnp.asarray(x).astype(jnp.bfloat16), mc_dropout=True,
                     dropout_rng=key).posteriors[:, 1]
    with torch.no_grad():
        out = model(torch.from_numpy(x).to(torch.bfloat16), mc_dropout=True,
                    generator=KeyGen(key))
    assert out.feature.dtype == torch.bfloat16
    assert np.abs(out.posteriors[:, 1].numpy() - np.asarray(want)).max() \
        < 5e-3


def test_mc_dropout_rate_zero_is_the_deterministic_forward(monkeypatch):
    """Rate 0 under ``mc_dropout``: bit for bit the deterministic forward
    (no layer draws), and the JAX package's within the f32 tolerance."""
    shape = (9, 9, 2)
    spec, params, model = _models(shape, dropout=0.0)
    x = torch.from_numpy(np.array(jax.random.normal(jax.random.key(5),
                                                    (16,) + shape)))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        mc = model(x, mc_dropout=True, generator=gen).posteriors
        det = model(x).posteriors
    assert torch.equal(mc, det)
    want = apply_cnn(spec, params, jnp.asarray(x.numpy()), mc_dropout=True,
                     dropout_rng=jax.random.key(0)).posteriors
    np.testing.assert_allclose(mc.numpy(), np.asarray(want), **TOL)


def _evaluators(z_chunk=3, ntb=64):
    vols, _ = synthetic_subject(shape=SHAPE, n_modalities=2, seed=0)
    patch = (9, 9, 1)
    spec, params, model = _models((9, 9, 2))
    mu, sd = np.array([60.0, 75.0]), np.array([30.0, 31.0])
    jev = JGrid(spec, j_pad(vols, patch), mu, sd, patch, SHAPE,
                grid_spacing=2, ntb=ntb, z_chunk=z_chunk)
    tev = TGrid(model.spec, pad_volumes(vols, patch, device="cpu"), mu, sd,
                patch, SHAPE, grid_spacing=2, ntb=ntb, z_chunk=z_chunk)
    return jev, tev, params, model


def _grid_inds(z_values):
    xs, ys = np.arange(0, SHAPE[0], 2), np.arange(0, SHAPE[1], 2)
    X, Y, Z = np.meshgrid(xs, ys, np.asarray(z_values), indexing="ij")
    return np.ravel_multi_index((X.ravel(), Y.ravel(), Z.ravel()), SHAPE)


def test_pool_chunks_keyed_on_their_start(monkeypatch):
    """Off-grid pool chunks: each chunk's key folds its start ``lo``, the
    ragged last chunk is padded to ``ntb`` (150 = 64 + 64 + 22 rows)."""
    inject(monkeypatch)
    jev, tev, params, model = _evaluators()
    rng = np.random.default_rng(0)
    inds = np.ravel_multi_index(
        (2 * rng.integers(0, 8, 150) + 1, rng.integers(0, 16, 150),
         rng.integers(0, 8, 150)), SHAPE)
    key = jax.random.key(21)
    want = jpe.PoolEvaluator.evaluate(jev, params, inds, ("posteriors",),
                                      mc_rng=key)["posteriors"]
    got = tpe.PoolEvaluator.evaluate(tev, model, inds, ("posteriors",),
                                     mc_rng=key)["posteriors"]
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("route", ["whole", "slab"])
def test_grid_mc_sweep_matches_jax(monkeypatch, route):
    """The grid sweep's z-chunk keys fold the chunk's global index (8
    slices in chunks of 3: the last one padded)."""
    inject(monkeypatch)
    jev, tev, params, model = _evaluators()
    inds = _grid_inds(range(8) if route == "whole" else [6, 7])
    key = jax.random.key(22)
    want = jev.evaluate(params, inds, ("posteriors",), mc_rng=key)
    got = tev.evaluate(model, inds, ("posteriors",), mc_rng=key)
    np.testing.assert_allclose(got["posteriors"], want["posteriors"], **TOL)


def test_slab_rows_equal_the_whole_sweep_bitwise():
    """With the port's own generators: rows evaluated slab by slab (one
    z-chunk, starting at chunk 2) equal the same rows of the whole sweep
    bit for bit, and a second call draws the same masks."""
    _, tev, _, model = _evaluators()
    inds = _grid_inds([6, 7])
    key = 1234
    slab = tev.evaluate(model, inds, ("posteriors", "feature_layer"),
                        mc_rng=key)
    whole = tev.evaluate(model, inds, ("posteriors", "feature_layer"),
                         as_device=True, mc_rng=key)
    again = tev.evaluate(model, inds, ("posteriors",), mc_rng=key)
    for op in ("posteriors", "feature_layer"):
        np.testing.assert_array_equal(slab[op], whole[op].numpy())
    np.testing.assert_array_equal(again["posteriors"], slab["posteriors"])
    other = tev.evaluate(model, inds, ("posteriors",), mc_rng=key + 1)
    assert not np.array_equal(other["posteriors"], slab["posteriors"])


def test_mc_average_and_stack_match_jax(monkeypatch):
    """``mc_average_posteriors`` (the reference's running average) and
    ``mc_stack_posteriors``: pass i keyed ``fold_in(base, i)``."""
    inject(monkeypatch)
    jev, tev, params, model = _evaluators()
    inds = _grid_inds([0, 2, 4, 6])
    key = jax.random.key(23)
    want_avg = jpe.mc_average_posteriors(jev, params, inds, 3, key)
    got_avg = tpe.mc_average_posteriors(tev, model, inds, 3, key)
    np.testing.assert_allclose(got_avg, want_avg, **TOL)
    want = jpe.mc_stack_posteriors(jev, params, inds, 3, key)
    got = tpe.mc_stack_posteriors(tev, model, inds, 3, key)
    assert got.shape == want.shape == (3, len(inds))
    np.testing.assert_allclose(got, want, **TOL)
    # the average is the running average of the stack, in that order
    avg = 0.0
    for i in range(3):
        avg = (got[i] + i * avg) / (i + 1)
    np.testing.assert_array_equal(got_avg, avg)
