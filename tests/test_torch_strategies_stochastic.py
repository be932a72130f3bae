"""The stochastic and batch-diverse strategies of the port vs the JAX
package's, end to end through ``cnn_query`` on the same subject, weights
and pool (CPU), with JAX's own draws fed through the port's draw
functions (``tests/torch_jax_draws``): MC-entropy, BALD and BatchBALD
(MC-dropout grid sweeps keyed per pass and per z-chunk), rep-entropy and
BADGE (posteriors + features of one sweep, the uncertainty filter, the
greedy or sampled pick), and the committee methods on the same member
weights, through ``cnn_query`` and, in round 0 from ``pretrained_paths``
(JAX-written weight files, an empty labeled set), through both engines.
Picks must be identical."""

import shutil

import jax
import numpy as np
import pytest
import torch

from nnal_tpu.core.config import ExperimentConfig as JConfig
from nnal_tpu.data.patches import pad_volumes as j_pad
from nnal_tpu.engine.pw_experiment import PWExperiment as JExperiment
from nnal_tpu.models import checkpoint as jck
from nnal_tpu.models.cnn import init_cnn
from nnal_tpu.models.specs import create_pw1
from nnal_tpu.scoring import strategies as jstrat
from nnal_tpu.scoring.grid_eval import GridPoolEvaluator as JGrid
from nnal_tpu_torch.data.io import synthetic_subject
from nnal_tpu_torch.engine.pw_experiment import PWExperiment
from nnal_tpu_torch.data.patches import pad_volumes
from nnal_tpu_torch.models.bridge import from_jax_params
from nnal_tpu_torch.models.cnn import CNN
from nnal_tpu_torch.models.specs import create_pw1 as t_create_pw1
from nnal_tpu_torch.scoring import strategies as tstrat
from nnal_tpu_torch.scoring.grid_eval import GridPoolEvaluator as TGrid
from test_torch_parallel_engine import link_npz
from torch_jax_draws import inject

torch.set_num_threads(1)

SHAPE = (16, 16, 8)
PATCH = (9, 9, 1)


def _member(seed):
    spec = create_pw1(2, 0.5, (9, 9, 2))
    params, _ = init_cnn(spec, jax.random.key(seed))
    model = CNN(t_create_pw1(2, 0.5, (9, 9, 2)))
    model.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    return spec, params, model


@pytest.fixture(scope="module")
def setup():
    vols, _ = synthetic_subject(shape=SHAPE, n_modalities=2, seed=0)
    spec, params, model = _member(0)
    mu, sd = np.array([60.0, 75.0]), np.array([30.0, 31.0])
    jev = JGrid(spec, j_pad(vols, PATCH), mu, sd, PATCH, SHAPE,
                grid_spacing=2, ntb=128, z_chunk=2)
    tev = TGrid(model.spec, pad_volumes(vols, PATCH, device="cpu"), mu, sd,
                PATCH, SHAPE, grid_spacing=2, ntb=128, z_chunk=2)
    xs, ys, zs = np.arange(0, 16, 2), np.arange(0, 16, 2), [0, 2, 4, 6]
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    pool = np.ravel_multi_index((X.ravel(), Y.ravel(), Z.ravel()), SHAPE)
    committee = [_member(s)[1:] for s in (1, 2, 3)]
    return spec, params, model, jev, tev, pool, committee


def _contexts(setup, key, committee=False, **kw):
    spec, params, model, jev, tev, pool, members = setup
    jctx = jstrat.QueryContext(
        spec=spec, params=params, evaluator=jev, pool_inds=pool, k=16,
        rng=np.random.default_rng(0), jax_rng=key, B=60, MC_iters=3,
        ensemble_params=[p for p, _ in members] if committee else None, **kw)
    tctx = tstrat.QueryContext(
        spec=model.spec, params=model, evaluator=tev, pool_inds=pool, k=16,
        rng=np.random.default_rng(0), seed=key, B=60, MC_iters=3,
        ensemble_params=[m for _, m in members] if committee else None, **kw)
    return jctx, tctx


@pytest.mark.parametrize("method", ["MC-entropy", "BALD", "BatchBALD",
                                    "rep-entropy", "BADGE"])
def test_strategy_picks_match_jax(monkeypatch, setup, method):
    inject(monkeypatch)
    jctx, tctx = _contexts(setup, jax.random.key(5))
    want = jstrat.cnn_query(jctx, method)
    got = tstrat.cnn_query(tctx, method)
    assert got.dtype == np.int64 and len(got) == 16
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", ["ensemble", "QBC-JS"])
def test_committee_picks_match_jax(setup, method):
    jctx, tctx = _contexts(setup, jax.random.key(6), committee=True)
    np.testing.assert_array_equal(tstrat.cnn_query(tctx, method),
                                  jstrat.cnn_query(jctx, method))


def test_committee_methods_need_members(setup):
    _, tctx = _contexts(setup, 0)
    with pytest.raises(ValueError, match="ensemble_params"):
        tstrat.cnn_query(tctx, "QBC-JS")


def test_mc_strategies_differ_from_the_deterministic(setup):
    """With the port's own generators: BALD's MC passes really drop out
    (its picks are not entropy's), and the same seed repeats them."""
    _, tctx = _contexts(setup, 77)
    bald = tstrat.cnn_query(tctx, "BALD")
    np.testing.assert_array_equal(tstrat.cnn_query(tctx, "BALD"), bald)
    assert set(bald.tolist()) != set(
        tstrat.cnn_query(tctx, "entropy").tolist())


ENGINE_VOLS = synthetic_subject(shape=(16, 16, 4), n_modalities=2,
                                n_blobs=10, seed=1)
ENGINE_PARS = {
    "model_name": "PW", "nclass": 2, "patch_shape": (9, 9, 1),
    "grid_spacing": 2, "k": 8, "B": 20, "ntb": 256, "b": 16,
    "epochs": 1, "n_ensemble": 2, "learning_rate": 1e-3,
    "optimizer_name": "Adam", "dropout_rate": 0.5, "init_size": 0,
    "seed": 5,
}


@pytest.fixture
def tmp_path(tmp_path):
    """Drop the checkpoints (tens of MB each) as soon as the test ends."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("method", ["ensemble", "QBC-JS"])
def test_round0_from_pretrained_paths_matches_jax(tmp_path, method):
    """init_size 0: round 0's committee is the pretrained weight files
    (written by the JAX package), so both packages pick the same k."""
    spec = create_pw1(2, 0.5, (9, 9, 2))
    paths = []
    for i in range(3):
        params, bn = init_cnn(spec, jax.random.key(40 + i))
        paths.append(str(tmp_path / f"member{i}.npz"))
        jck.save_checkpoint(paths[-1], params, bn_state=bn)
    pars = {**ENGINE_PARS, "pretrained_paths": paths}
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jexpr = JExperiment(str(jdir), JConfig.from_pars(pars))
    jexpr.attach_subject(*ENGINE_VOLS)
    jexpr.prep_data()
    jexpr.add_method(method)
    shutil.copytree(jdir, tdir, copy_function=link_npz)
    jexpr.run_method(method, ENGINE_PARS["k"])
    texpr = PWExperiment(str(tdir), device="cpu")
    texpr.attach_subject(*ENGINE_VOLS)
    assert list(texpr.config.query.pretrained_paths) == paths
    texpr.run_method(method, ENGINE_PARS["k"])
    want = np.loadtxt(jdir / method / "queries" / "0.txt", dtype=np.int64)
    got = np.loadtxt(tdir / method / "queries" / "0.txt", dtype=np.int64)
    assert len(got) == ENGINE_PARS["k"]
    np.testing.assert_array_equal(got, want)
