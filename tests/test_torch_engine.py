"""The port's AL campaign vs the JAX package's, from one experiment
directory written by the JAX package, plus the port's package rules.

The JAX package creates the experiment and both methods' initial state
(``create_expr`` + ``add_method``, dropout 0, SGD); the directory is
copied and each framework runs 2 rounds of ``entropy`` and ``core-set``.
Round 0 scores the same weights, so its queries must be identical.  Round
1 scores weights finetuned in two frameworks (params agree to ~1e-6, see
``test_torch_train.py``), so near-ties may reorder: its queries must
overlap by >= 90% of k and the F-measures agree within 0.02 (observed:
identical queries and F in both rounds).
"""

import ast
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from nnal_tpu.cli.expr_handler import create_expr as j_create_expr
from nnal_tpu.cli.expr_handler import do_expr as j_do_expr
from nnal_tpu_torch.cli import expr_handler as t_cli
from nnal_tpu_torch.core.config import ExperimentConfig, set_parameters
from nnal_tpu_torch.engine.pw_experiment import PWExperiment
from nnal_tpu_torch.parallel.grid_sharded import ShardedGridPoolEvaluator
from nnal_tpu_torch.parallel.mesh import cached_mesh
from test_torch_parallel_engine import link_npz

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
K = 10
OVERRIDES = ("patch_shape=[9,9,1],grid_spacing=2,k=10,B=30,ntb=512,b=32,"
             "epochs=1,init_size=20,learning_rate=1e-2,optimizer_name=SGD,"
             "dropout_rate=0.0")
METHODS = ("entropy", "core-set")


@pytest.fixture(scope="module")
def campaigns(tmp_path_factory):
    """~80 MB per full-width PW1 checkpoint: a method is added just before
    it runs, its checkpoints go once it has (the tests read only text
    records), and the directories when the module ends, passed or not."""
    jdir = str(tmp_path_factory.mktemp("jax_expr"))
    tdir = str(tmp_path_factory.mktemp("port_expr") / "expr")
    try:
        expr = j_create_expr(jdir, OVERRIDES, synthetic=True)
        shutil.copytree(jdir, tdir, copy_function=link_npz)
        res = {}
        for m in METHODS:
            expr.add_method(m)
            shutil.copytree(os.path.join(jdir, m), os.path.join(tdir, m),
                            copy_function=link_npz)
            res[("jax", m)] = j_do_expr(jdir, m, 2 * K, synthetic=True)
            res[("port", m)] = t_cli.do_expr(tdir, m, 2 * K, synthetic=True,
                                             device="cpu")
            for root in (jdir, tdir):
                _drop_checkpoints(os.path.join(root, m))
        yield jdir, tdir, res
    finally:
        shutil.rmtree(jdir, ignore_errors=True)
        shutil.rmtree(tdir, ignore_errors=True)


def _drop_checkpoints(d):
    for f in os.listdir(d):
        if f.endswith(".npz"):
            os.remove(os.path.join(d, f))


def _queries(root, method, it):
    return np.loadtxt(os.path.join(root, method, "queries", f"{it}.txt"),
                      dtype=np.int64)


@pytest.mark.parametrize("method", METHODS)
def test_round0_queries_identical(campaigns, method):
    jdir, tdir, _ = campaigns
    np.testing.assert_array_equal(_queries(tdir, method, 0),
                                  _queries(jdir, method, 0))


@pytest.mark.parametrize("method", METHODS)
def test_round1_overlap_and_f_measure(campaigns, method):
    jdir, tdir, res = campaigns
    overlap = len(set(_queries(tdir, method, 1).tolist())
                  & set(_queries(jdir, method, 1).tolist()))
    assert overlap >= 0.9 * K
    fj, ft = res[("jax", method)]["perf"], res[("port", method)]["perf"]
    assert len(fj) == len(ft) == 2
    assert np.isfinite(ft).all()
    np.testing.assert_allclose(ft, fj, rtol=0, atol=0.02)


@pytest.mark.parametrize("method", METHODS)
def test_journal_layout_and_membership(campaigns, method):
    jdir, tdir, res = campaigns
    assert sorted(os.listdir(os.path.join(tdir, method))) == \
        sorted(os.listdir(os.path.join(jdir, method)))
    init_pool = np.loadtxt(os.path.join(tdir, "init_pool_inds.txt"),
                           dtype=np.int64)
    r = res[("port", method)]
    train, pool = r["train_inds"], r["pool_inds"]
    assert r["n_queries"] == 2 * K and len(train) == 20 + 2 * K
    assert not set(train.tolist()) & set(pool.tolist())
    assert set(train.tolist()) | set(pool.tolist()) == set(
        init_pool.tolist())


def test_resume_continues_from_the_journal(campaigns):
    _, tdir, _ = campaigns
    res = t_cli.do_expr(tdir, "entropy", 3 * K, synthetic=True,
                        device="cpu")
    assert res["n_queries"] == 3 * K
    assert sorted(os.listdir(os.path.join(tdir, "entropy", "queries"))) == \
        ["0.txt", "1.txt", "2.txt"]
    assert len(res["perf"]) == 3


def test_random_method_runs(campaigns):
    _, tdir, _ = campaigns
    res = t_cli.do_expr(tdir, "random", K, synthetic=True, device="cpu")
    assert res["n_queries"] == K and np.isfinite(res["perf"]).all()


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_nnal_tpu():
    files = sorted((REPO / "nnal_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    # the multi-subject, dense, classification, serving, multi-device,
    # data / library and probe slices' modules and the examples are among
    # the scanned
    scanned = {str(f.relative_to(REPO)) for f in files}
    assert {f"nnal_tpu_torch/{m}.py" for m in (
        "engine/multi_experiment", "engine/sequential", "runtime/native",
        "runtime/gxx", "data/loaders", "data/holders",
        "scoring/fcn_eval", "engine/experiment", "scoring/cls_strategies",
        "data/image_pool", "cli/run_querying",
        "cli/softmax_harness", "models/quant", "evaluation/inference",
        "evaluation/postproc", "evaluation/crf", "runtime/crf_native",
        "cli/run_on_subjects", "parallel/mesh", "parallel/grid_sharded",
        "parallel/pool_sharded", "parallel/sharding", "parallel/multihost",
        "parallel/dryrun", "evaluation/analysis", "engine/analysis",
        "evaluation/registry", "evaluation/visualize", "data/formats",
        "data/io", "data/datasets", "cli/repeat_runs",
        "models/branches", "core/device_probe", "cli/wait_device",
        "cli/prime_cache", "examples/patchwise_al",
        "examples/multi_subject_al", "examples/classification_al",
        "examples/serving", "examples/dense_model_al",
        "examples/multichip_campaign", "examples/_cli")} <= scanned
    banned = {"jax", "jaxlib", "optax", "flax", "nnal_tpu"}
    for f in files:
        for mod in _imported_modules(f):
            assert mod.split(".")[0] not in banned, f"{f}: imports {mod}"


def test_entry_points_raise_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ExperimentConfig.from_pars(set_parameters(t_cli.DEFAULT_PARS, ""))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        PWExperiment(str(tmp_path / "a"), cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        t_cli.do_expr(str(tmp_path / "b"), "entropy", 1, synthetic=True)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        t_cli.main([str(tmp_path / "c"), "entropy", "1", "--synthetic"])


# dtype, train_dtype, ckpt_dtype and ckpt_full_every are ported (their
# runs: tests/test_torch_mixed_precision.py, tests/test_torch_anchors.py);
# their cases now hold the values the JAX package rejects.  The training
# levers (consistency_coeff, lwf_lambda, aleatoric, train_layers,
# tb_logdir) are ported too: tests/test_torch_lever_engine.py holds them
# accepted and run, and so are the dense models (model_name: Tiramisu;
# tests/test_torch_dense_engine.py).
@pytest.mark.parametrize("override,exc,key", [
    ("ckpt_dtype=float16", ValueError, "unsupported ckpt_dtype"),
    ("dtype=float16", ValueError, "unsupported eval dtype"),
    ("train_dtype=float16", ValueError, "unsupported eval dtype"),
])
def test_unsupported_config_keys_raise(tmp_path, override, exc, key):
    cfg = ExperimentConfig.from_pars(
        set_parameters(t_cli.DEFAULT_PARS, override))
    with pytest.raises(exc, match=key):
        PWExperiment(str(tmp_path), cfg, device="cpu")


def test_data_parallel_builds_the_sharded_evaluator(tmp_path, monkeypatch):
    """``data_parallel`` 2 (rejected before the multi-device slice) builds
    the z-sharded evaluator over ``cached_mesh(2)``; on CUDA the default
    mesh needs two cards and says how many it found
    (``tests/test_torch_parallel_engine.py`` runs the campaigns)."""
    expr = t_cli.create_expr(str(tmp_path), "data_parallel=2",
                             synthetic=True, device="cpu")
    ev = expr.make_evaluator(expr.build_model())
    assert isinstance(ev, ShardedGridPoolEvaluator)
    assert ev.mesh.shape == {"data": 2, "model": 1}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="need 2 CUDA devices, found 1"):
        cached_mesh(2, device="cuda")
