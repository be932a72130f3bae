"""The last three strategies of the port vs the JAX package's (CPU):
the local-variance map and filter behind ``ps-random``, SLIC (native and
numpy) and the superpixel scoring behind ``SuPix``, the picks of
``ps-random``, ``SuPix`` and ``influence`` (cg, and arnoldi with JAX's
Lanczos start injected) through ``cnn_query`` from the same weights,
``finetune_wpool`` through both engines, and a two-round ``do_expr`` of
``ps-random``, ``SuPix`` and ``influence`` (arnoldi, rank 2) on the host.

Tolerances: positions, label maps, superpixel scores and picks are
exactly equal; the variance map is held within 1e-4 of its largest value
(f32 box sums in another order); ``finetune_wpool``'s parameters within
1e-5 (SGD, no dropout)."""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from nnal_tpu.core.config import ExperimentConfig as JConfig
from nnal_tpu.data.patches import pad_volumes as j_pad
from nnal_tpu.data.samplers import high_variance_filter as j_hv
from nnal_tpu.data.samplers import local_variance_map as j_lvm
from nnal_tpu.engine.pw_experiment import PWExperiment as JExperiment
from nnal_tpu.models import checkpoint as jck
from nnal_tpu.models.train import init_train_state as j_init_state
from nnal_tpu.scoring import pseudo as jpseudo
from nnal_tpu.scoring import strategies as jstrat
from nnal_tpu.scoring import superpixel as jsp
from nnal_tpu.scoring.grid_eval import GridPoolEvaluator as JGrid
from nnal_tpu_torch.cli.expr_handler import do_expr
from nnal_tpu_torch.core.profiling import drain_subphases
from nnal_tpu_torch.data.io import synthetic_subject
from nnal_tpu_torch.data.patches import pad_volumes
from nnal_tpu_torch.data.samplers import high_variance_filter, local_variance_map
from nnal_tpu_torch.engine import pw_experiment as tpw
from nnal_tpu_torch.models.bridge import to_jax_params
from nnal_tpu_torch.models.train import init_train_state
from nnal_tpu_torch.scoring import strategies as tstrat
from nnal_tpu_torch.scoring import superpixel as tsp
from nnal_tpu_torch.scoring.grid_eval import GridPoolEvaluator as TGrid
from test_torch_parallel_engine import link_npz
from torch_jax_draws import inject
from torch_jax_native import ensure_jax_native
from torch_jax_tiny import tiny_pair

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    """The JAX package's native SLIC loaded before its side
    runs: a load lost to a concurrent build would leave it on its
    fallback (``torch_jax_native``)."""
    ensure_jax_native("slic")


SHAPE = (16, 16, 8)
PATCH = (9, 9, 1)


@pytest.fixture
def tmp_path(tmp_path):
    """Drop the checkpoints (tens of MB each) as soon as the test ends."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def subject():
    return synthetic_subject(shape=(36, 36, 10), n_modalities=2, seed=0)


@pytest.mark.parametrize("d", [4, 12])
def test_local_variance_map_matches_jax(subject, d):
    vol = subject[0][0]
    got = local_variance_map(torch.as_tensor(vol), d).numpy()
    want = np.asarray(j_lvm(jax.numpy.asarray(vol), d))
    assert got.shape == vol.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("patch,thr", [((9, 9, 1), 2.0), ((25, 25, 1), 2.0),
                                       ((25, 25, 1), 100.0)])
def test_high_variance_filter_matches_jax(subject, patch, thr):
    vol = subject[0][0]
    pool = np.arange(0, vol.size, 3)
    got = high_variance_filter(vol, patch, thr, pool, device="cpu")
    want = j_hv(vol, patch, thr, pool)
    assert 0 < len(want) < len(pool) or thr == 2.0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_slic_matches_jax(subject, backend):
    vol = subject[0][0]
    for z in (0, 5, 9):
        got = tsp.slic_2d(vol[:, :, z], 16, backend=backend)
        want = jsp.slic_2d(vol[:, :, z], 16, backend="numpy")
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="backend"):
        tsp.slic_2d(vol[:, :, 0], 16, backend="cuda")


def test_slic_build_failure_falls_back_or_raises(subject, monkeypatch):
    """A library that cannot build: ``auto`` warns and runs numpy (the
    same labels), ``native`` raises; the failure is kept, not retried."""
    from nnal_tpu_torch.runtime import slic_native

    monkeypatch.setattr(slic_native, "_lib", None)
    monkeypatch.setattr(slic_native, "_failure", None)
    monkeypatch.setattr(slic_native, "GXX_FLAGS", ("--no-such-flag",))
    img = subject[0][0][:, :, 3]
    with pytest.warns(UserWarning, match="falls back to numpy"):
        got = tsp.slic_2d(img, 16)
    np.testing.assert_array_equal(got, jsp.slic_2d(img, 16,
                                                   backend="numpy"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tsp.slic_2d(img, 16, backend="native")
    assert slic_native._failure is not None


def test_superpixel_scoring_and_query_match_jax(subject):
    vol = subject[0][0]
    overseg = tsp.oversegment_volume(vol, 16, backend="native")
    np.testing.assert_array_equal(
        overseg, np.stack([jsp.slic_2d(vol[:, :, z], 16, backend="numpy")
                           for z in range(vol.shape[2])], axis=2))
    rng = np.random.default_rng(0)
    pool = np.sort(rng.choice(vol.size, 3000, replace=False))
    unc = rng.random(len(pool))
    np.testing.assert_array_equal(tsp.superpix_scores(overseg, pool, unc),
                                  jsp.superpix_scores(overseg, pool, unc))
    q, members = tsp.supix_query(overseg, pool, unc, 7)
    jq, jmembers = jsp.supix_query(overseg, pool, unc, 7)
    np.testing.assert_array_equal(q, jq)
    assert q.shape == (2, 7) and len(members) == len(jmembers) == 7
    for a, b in zip(members, jmembers):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def setup():
    vols, mask = synthetic_subject(shape=SHAPE, n_modalities=2, n_blobs=6,
                                   seed=0)
    jspec, jp, model, _ = tiny_pair(0, input_shape=(9, 9, 2))
    mu, sd = np.array([60.0, 75.0]), np.array([30.0, 31.0])
    jev = JGrid(jspec, j_pad(vols, PATCH), mu, sd, PATCH, SHAPE,
                grid_spacing=2, ntb=128, z_chunk=2)
    tev = TGrid(model.spec, pad_volumes(vols, PATCH, device="cpu"), mu, sd,
                PATCH, SHAPE, grid_spacing=2, ntb=128, z_chunk=2)
    xs = np.arange(0, 16, 2)
    X, Y, Z = np.meshgrid(xs, xs, np.arange(8), indexing="ij")
    grid = np.ravel_multi_index((X.ravel(), Y.ravel(), Z.ravel()), SHAPE)
    train, pool = grid[::7], np.setdiff1d(grid, grid[::7])
    return jspec, jp, model, jev, tev, pool, train, vols, mask


def _contexts(setup, key, **extra):
    jspec, jp, model, jev, tev, pool, train, vols, mask = setup
    kw = dict(pool_inds=pool, k=12, B=40, train_inds=train,
              raw_volume=vols[0])
    jctx = jstrat.QueryContext(
        spec=jspec, params=jp, evaluator=jev, rng=np.random.default_rng(0),
        jax_rng=key, extra={"mask": mask, **extra}, **kw)
    tctx = tstrat.QueryContext(
        spec=model.spec, params=model, evaluator=tev,
        rng=np.random.default_rng(0), seed=key,
        extra={"mask": mask, **extra}, **kw)
    return jctx, tctx


@pytest.mark.parametrize("method,extra", [
    ("ps-random", {}),
    ("SuPix", {"n_segments": 16}),
    ("influence", {}),
    ("influence", {"influence_mode": "arnoldi", "arnoldi_rank": 2}),
    ("influence", {"influence_mode": "arnoldi", "arnoldi_rank": 6,
                   "damping": 0.5}),
])
def test_strategy_picks_match_jax(monkeypatch, setup, method, extra):
    inject(monkeypatch)
    jctx, tctx = _contexts(setup, jax.random.key(5), **extra)
    want = jstrat.cnn_query(jctx, method)
    got = tstrat.cnn_query(tctx, method)
    assert got.dtype == np.int64
    assert len(got) == (12 if method != "SuPix" else len(want)) > 0
    np.testing.assert_array_equal(got, want)
    if method == "SuPix":
        assert len(got) > 12
        np.testing.assert_array_equal(tctx.extra["overseg"],
                                      jctx.extra["overseg"])


def test_influence_needs_its_inputs(setup):
    _, tctx = _contexts(setup, 0)
    tctx.extra.pop("mask")
    with pytest.raises(ValueError, match="label mask"):
        tstrat.cnn_query(tctx, "influence")
    _, tctx = _contexts(setup, 0)
    tctx.raw_volume = None
    with pytest.raises(ValueError, match="raw volume"):
        tstrat.cnn_query(tctx, "ps-random")


ENGINE_VOLS = synthetic_subject(shape=(16, 16, 4), n_modalities=2,
                                n_blobs=10, seed=1)
ENGINE_PARS = {
    "model_name": "PW", "nclass": 2, "patch_shape": (9, 9, 1),
    "grid_spacing": 2, "k": 8, "ntb": 256, "b": 16, "epochs": 1,
    "learning_rate": 1e-2, "optimizer_name": "SGD", "dropout_rate": 0.0,
    "init_size": 24, "seed": 5,
}


def test_finetune_wpool_matches_jax(tmp_path, monkeypatch):
    """The same weights, labels and pool through both engines'
    ``finetune_wpool`` (SGD, no dropout, 40 pseudo-labels): the same
    confident voxels and pseudo-labels, and parameters within 1e-5; the
    label mask is restored after the call."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jexpr = JExperiment(str(jdir), JConfig.from_pars(ENGINE_PARS))
    jexpr.attach_subject(*ENGINE_VOLS)
    jexpr.prep_data()
    jexpr.add_method("entropy")
    shutil.copytree(jdir, tdir, copy_function=link_npz)
    seen = {}

    def spy(tag, fn):
        def wrapped(*a, **kw):
            seen[tag] = fn(*a, **kw)
            return seen[tag]
        return wrapped

    monkeypatch.setattr(jpseudo, "confident_samples",
                        spy("jax", jpseudo.confident_samples))
    monkeypatch.setattr(tpw, "confident_samples",
                        spy("port", tpw.confident_samples))
    train = np.loadtxt(jdir / "entropy" / "curr_train_inds.txt", dtype=np.int64)
    pool = np.loadtxt(jdir / "entropy" / "curr_pool_inds.txt", dtype=np.int64)

    jspec = jexpr.build_model()
    params = jck.load_checkpoint(str(jdir / "entropy" /
                                     "curr_weights.npz"))[0]
    params = jax.tree_util.tree_map(jax.numpy.asarray, params)
    jstate, jtx = j_init_state(jspec, params, "SGD", 1e-2)
    jstate = jexpr.finetune_wpool(jspec, (jstate, jtx), train, pool, 40)

    texpr = tpw.PWExperiment(str(tdir), device="cpu")
    texpr.attach_subject(*ENGINE_VOLS)
    mask_before = texpr._mask
    spec = texpr.build_model()
    model = texpr._load_model(spec, jck.load_checkpoint(
        str(tdir / "entropy" / "curr_weights.npz"))[0])
    state = texpr.finetune_wpool(spec, init_train_state(model, "SGD", 1e-2),
                                 train, pool, 40)
    assert texpr._mask is mask_before
    for a, b in zip(seen["port"][:2], seen["jax"][:2]):
        np.testing.assert_array_equal(a, b)
    assert len(seen["port"][0]) == 40
    got = to_jax_params(state.model.state_dict())
    for layer in got:
        for k in ("W", "b"):
            np.testing.assert_allclose(got[layer][k],
                                       np.asarray(jstate.params[layer][k]),
                                       rtol=0, atol=1e-5,
                                       err_msg=f"{layer}/{k}")


BASE = ("patch_shape=[9,9,1],grid_spacing=2,k=8,B=30,ntb=256,b=32,"
        "epochs=1,init_size=20,learning_rate=1e-3,optimizer_name=Adam,"
        "synthetic_shape=[16,16,4],seed=3,iter_k=[8,8,0]")
RUNS = {
    "ps-random": ("ps-random", BASE),
    "SuPix": ("SuPix", BASE),
    "influence-arnoldi": ("influence",
                          BASE + ",influence_mode=arnoldi,arnoldi_rank=2"),
}
INFLUENCE_SUBS = {"influence/labeled_gather", "influence/s_test",
                  "influence/posteriors", "influence/filter",
                  "influence/cand_scores"}


@pytest.fixture(scope="module")
def campaigns(tmp_path_factory):
    top = tmp_path_factory.mktemp("rest")
    out = {}
    try:
        for name, (method, overrides) in RUNS.items():
            root = str(top / name)
            drain_subphases()    # spans left by this worker's other tests
            res = do_expr(root, method, 400, overrides, synthetic=True,
                          device="cpu")
            with open(os.path.join(root, method, "phases.jsonl")) as f:
                phases = [json.loads(line) for line in f]
            queries = [np.atleast_1d(np.loadtxt(
                os.path.join(root, method, "queries", f"{i}.txt"),
                dtype=np.int64)) for i in range(len(res["perf"]))]
            init_pool = np.loadtxt(os.path.join(root, "init_pool_inds.txt"),
                                   dtype=np.int64)
            out[name] = (method, res, phases, queries, init_pool)
            shutil.rmtree(root, ignore_errors=True)
        yield out
    finally:
        shutil.rmtree(top, ignore_errors=True)


@pytest.mark.parametrize("name", list(RUNS))
def test_two_round_campaign(campaigns, name):
    method, res, phases, queries, init_pool = campaigns[name]
    assert len(res["perf"]) == 2 and np.isfinite(res["perf"]).all()
    assert res["n_queries"] == sum(len(q) for q in queries)
    for q in queries:
        assert len(np.unique(q)) == len(q)
        # SuPix queries every pool member of 8 superpixels, at least one each
        assert len(q) >= 8 if method == "SuPix" else len(q) == 8
    train, pool = res["train_inds"], res["pool_inds"]
    assert len(train) == 20 + res["n_queries"] == len(set(train.tolist()))
    assert not set(train.tolist()) & set(pool.tolist())
    assert set(train.tolist()) | set(pool.tolist()) == set(
        init_pool.tolist())
    rounds = [r for r in phases if not r.get("tail")]
    assert len(rounds) == 2 and phases[-1].get("tail")
    for r in rounds:
        subs = set(r.get("sub", {}))
        assert (subs == INFLUENCE_SUBS if method == "influence"
                else not subs)
