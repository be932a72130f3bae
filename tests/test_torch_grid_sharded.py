"""The z-sharded grid-pool evaluator (``parallel/grid_sharded.py``) and
the mesh (``parallel/mesh.py``) on the CPU.

* At ``dp`` 2 and 4 (CPU shards, a ragged last z-chunk and a shard with
  fewer chunks) every whole-grid sweep is the unsharded evaluator's BIT
  FOR BIT: posteriors and predictions, MC-dropout posteriors (keys on the
  global chunk), device-resident features, ``fim_sweep`` and
  ``perturb_sweep``; the slab route stays single-device.
* Against the JAX package's ``ShardedGridPoolEvaluator`` on the conftest's
  8-device CPU mesh, from the same weights (``models/bridge``) and, for
  MC and perturb, JAX's draws (``tests/torch_jax_draws.py``): posteriors
  within 1e-5 with equal f32 uncertainty ranks, shrunk gradients per
  ``tests/test_torch_fim.py``'s row rule, divergences within 1e-5
  relative.
* The mesh: ``(data, model)`` shapes, the CUDA count error (no fallback
  to the CPU or to fewer shards), explicit device lists, ``cached_mesh``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnal_tpu.data.patches import pad_volumes as j_pad
from nnal_tpu.models.cnn import init_cnn as j_init_cnn
from nnal_tpu.models.specs import create_pw1 as j_create_pw1
from nnal_tpu.parallel.grid_sharded import ShardedGridPoolEvaluator as JSh
from nnal_tpu.parallel.mesh import make_mesh as j_make_mesh
from nnal_tpu_torch.data.io import synthetic_subject
from nnal_tpu_torch.data.patches import pad_volumes
from nnal_tpu_torch.models.specs import create_pw1
from nnal_tpu_torch.parallel import mesh as tmesh
from nnal_tpu_torch.parallel.grid_sharded import ShardedGridPoolEvaluator
from nnal_tpu_torch.scoring.grid_eval import GridPoolEvaluator
from test_torch_fim import assert_rows_close
from torch_jax_dense import port_model
from torch_jax_draws import inject

torch.set_num_threads(1)

SHAPE = (14, 16, 9)          # odd z: a ragged last chunk of 1 slice
PS = (7, 7, 1)
ZC = 2
VOLS, _ = synthetic_subject(shape=SHAPE, n_modalities=2, seed=1)
MU = np.array([v.mean() for v in VOLS])
SD = np.array([v.std() for v in VOLS])


def _all_z_vox(g=2):
    """Grid voxels of every z: the whole-sweep route (a few slabs would
    take the single-device slab route on both)."""
    s1, s2, s3 = SHAPE
    gx, gy, z = np.meshgrid(np.arange(0, s1, g), np.arange(0, s2, g),
                            np.arange(s3), indexing="ij")
    return (gx.ravel() * s2 + gy.ravel()) * s3 + z.ravel()


@pytest.fixture(scope="module")
def pair():
    jspec = j_create_pw1(2, 0.5, (7, 7, 2))
    params, _ = j_init_cnn(jspec, jax.random.key(1))
    params = jax.tree_util.tree_map(np.asarray, params)
    return jspec, params, port_model(create_pw1(2, 0.5, (7, 7, 2)), params)


def _evs(model, dp):
    args = (model.spec, pad_volumes(VOLS, PS, device="cpu"), MU, SD, PS,
            SHAPE)
    kw = dict(grid_spacing=2, z_chunk=ZC)
    return (GridPoolEvaluator(*args, **kw),
            ShardedGridPoolEvaluator(tmesh.make_mesh(dp, device="cpu"),
                                     *args, **kw))


def _sweep(ev, model, kind):
    vox = _all_z_vox()
    if kind == "posteriors":
        r = ev.evaluate(model, vox, ("posteriors", "prediction"))
        return [r["posteriors"], r["prediction"]]
    if kind == "mc":
        return [ev.evaluate(model, vox, mc_rng=7)["posteriors"]]
    if kind == "features":
        return [ev.evaluate(model, vox[::5], ("feature_layer",),
                            as_device=True)["feature_layer"].numpy()]
    if kind == "fim":
        r = ev.fim_sweep(model)
        return [r["p1"], r["uncertainty"], r["shrunk"]]
    return [ev.perturb_sweep(model, 3)]


@pytest.mark.parametrize("kind", ["posteriors", "mc", "features", "fim",
                                  "perturb"])
@pytest.mark.parametrize("dp", [2, 4])
def test_sharded_sweeps_bit_equal_to_one_device(pair, dp, kind):
    _, _, model = pair
    ev1, evs = _evs(model, dp)
    assert evs._n_steps() == 5 and len(evs._shard_evs) == min(dp, 3)
    for a, b in zip(_sweep(ev1, model, kind), _sweep(evs, model, kind)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_slab_route_and_even_depth_stay_single_device(pair):
    _, _, model = pair
    ev1, evs = _evs(model, 2)
    vox = _all_z_vox()
    one_z = vox[vox % SHAPE[2] == 3]
    np.testing.assert_array_equal(
        ev1.evaluate(model, one_z)["posteriors"],
        evs.evaluate(model, one_z)["posteriors"])
    ev_even = ShardedGridPoolEvaluator(
        tmesh.make_mesh(2, device="cpu"), model.spec,
        pad_volumes(VOLS, (7, 7, 2), device="cpu"), MU, SD, (7, 7, 2), SHAPE,
        grid_spacing=2)
    assert ev_even._shard_evs == [] and evs.bytes_moved == 0


def _jax_pair(jspec, params):
    args = (jspec, j_pad(VOLS, PS), MU, SD, PS, SHAPE)
    return JSh(j_make_mesh(8), *args, grid_spacing=2, z_chunk=ZC)


@pytest.mark.parametrize("kind", ["posteriors", "mc", "fim", "perturb"])
def test_sharded_evaluator_matches_jax(pair, kind, monkeypatch):
    jspec, params, model = pair
    jev = _jax_pair(jspec, params)
    _, evs = _evs(model, 2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    vox = _all_z_vox()
    if kind in ("mc", "perturb"):
        inject(monkeypatch)
    if kind == "posteriors":
        want = jev.evaluate(jp, vox)["posteriors"]
        got = evs.evaluate(model, vox)["posteriors"]
    elif kind == "mc":
        key = jax.random.key(7)
        want = jev.evaluate(jp, vox, mc_rng=key)["posteriors"]
        got = evs.evaluate(model, vox, mc_rng=key)["posteriors"]
    elif kind == "fim":
        w, g = jev.fim_sweep(jp), evs.fim_sweep(model)
        assert_rows_close(g["shrunk"], w["shrunk"])
        want, got = w["p1"], g["p1"]
    else:
        key = jax.random.key(3)
        want = np.asarray(jev.perturb_sweep(jp, key))
        got = evs.perturb_sweep(model, key)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        return
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    unc_w = np.abs(np.asarray(want, np.float32) - 0.5)
    unc_g = np.abs(np.asarray(got, np.float32) - 0.5)
    np.testing.assert_array_equal(np.argsort(unc_g, kind="stable"),
                                  np.argsort(unc_w, kind="stable"))


def test_mesh_shapes_and_errors(monkeypatch):
    m = tmesh.make_mesh(8, model_parallel=2, device="cpu")
    assert m.shape == {"data": 4, "model": 2}
    assert len(m.data_devices) == 4 and m.primary == torch.device("cpu")
    assert tmesh.default_mesh_shape(8, 4) == (2, 4)
    with pytest.raises(ValueError, match="must divide"):
        tmesh.make_mesh(8, model_parallel=3, device="cpu")
    two = tmesh.make_mesh(2, device=["cpu", "cpu"])
    assert two.shape == {"data": 2, "model": 1}
    with pytest.raises(ValueError, match="the list holds 2"):
        tmesh.make_mesh(3, device=["cpu", "cpu"])
    assert tmesh.cached_mesh(2, device="cpu") is tmesh.cached_mesh(
        2, device=torch.device("cpu"))
    # on CUDA, fewer cards than asked is an error naming the count; there
    # is no fallback to the CPU or to fewer shards
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="need 2 CUDA devices, found 1"):
        tmesh.make_mesh(2)
    with pytest.raises(ValueError, match="found 1"):
        tmesh.make_mesh(2, device="cuda")
    one_card = tmesh.make_mesh(2, device=["cuda:0", "cuda:0"])
    assert one_card.data_devices == (torch.device("cuda", 0),) * 2


def test_stable_topk_breaks_ties_to_the_lower_index():
    s = torch.tensor([1.0, -np.inf, 3.0, 3.0, -np.inf, 1.0, 3.0])
    vals, idx = tmesh.stable_topk(s, 6)
    assert idx.tolist() == [2, 3, 6, 0, 5, 1]
    assert vals[:3].tolist() == [3.0] * 3
    jv, ji = jax.lax.top_k(jnp.asarray(s.numpy()), 6)
    assert np.asarray(ji).tolist() == idx.tolist()
