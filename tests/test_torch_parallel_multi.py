"""``query.data_parallel`` in the multi-subject engine on the CPU: every
grid evaluator (the train, test and held subjects') is a
``ShardedGridPoolEvaluator`` over ``cached_mesh(dp)`` (CPU shards here).

From one JAX-written directory (``data_parallel`` 2, two 20x20x6 training
subjects, a test and a held one, PW1 at 9x9 patches, dropout 0, SGD):

* ``entropy`` and ``fi``: round 0's (voxel, subject) picks of the port at
  ``data_parallel`` 2 equal the JAX engine's at ``data_parallel`` 2 (its
  sharded evaluator on the conftest's 8-device CPU mesh);
* two rounds of each at ``data_parallel`` 2 equal two rounds at
  ``data_parallel`` 1 (journal, membership and ``perf_evals.txt``, exactly).

The JAX directory's checkpoints are hard-linked into the port's copies
(``test_torch_parallel_engine.link_npz``); each run's checkpoints are
deleted once it ends, everything else when the module ends.
"""

import shutil

import pytest
import torch

from nnal_tpu.core.config import ExperimentConfig as JConfig
from nnal_tpu.engine.multi_experiment import MultiImgExperiment as JMulti
from nnal_tpu_torch.core.config import ExperimentConfig
from nnal_tpu_torch.data.io import synthetic_subject
from nnal_tpu_torch.engine.multi_experiment import MultiImgExperiment
from nnal_tpu_torch.parallel.grid_sharded import ShardedGridPoolEvaluator
from test_torch_parallel_engine import _files, _round0, drop_npz, link_npz
from torch_jax_native import ensure_jax_native

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    """The JAX package's native patch gather loaded before its side
    runs: a load lost to a concurrent build would leave it on its
    fallback (``torch_jax_native``)."""
    ensure_jax_native("gather")


MSHAPE = (20, 20, 6)
TRAIN = [synthetic_subject(shape=MSHAPE, n_modalities=1, n_blobs=6, seed=s)
         for s in range(2)]
TEST = [synthetic_subject(shape=MSHAPE, n_modalities=1, n_blobs=6, seed=7)]
HELD = [synthetic_subject(shape=MSHAPE, n_modalities=1, n_blobs=6, seed=9)]
MULTI = {"model_name": "PW", "nclass": 2, "patch_shape": (9, 9, 1),
         "grid_spacing": 4, "k": 3, "B": 12, "ntb": 256, "b": 16,
         "epochs": 1, "learning_rate": 1e-2, "optimizer_name": "SGD",
         "dropout_rate": 0.0, "bootstrap_spacing": 5, "seed": 5,
         "data_parallel": 2}



@pytest.fixture(scope="module")
def multi(tmp_path_factory):
    top = tmp_path_factory.mktemp("dp_multi")
    try:
        jdir = top / "jax"
        jexpr = JMulti(str(jdir), JConfig.from_pars(MULTI))
        jexpr.attach_subjects(TRAIN, TEST, HELD)
        jexpr.prep_data()
        for m in ("entropy", "fi"):
            jexpr.add_method(m)
        for tag in ("dp2", "dp1"):
            shutil.copytree(jdir, top / tag, copy_function=link_npz)
        for m in ("entropy", "fi"):
            jexpr.run_method(m, MULTI["k"])
            drop_npz(jdir / m)
        yield top
    finally:
        shutil.rmtree(top, ignore_errors=True)


@pytest.mark.parametrize("method", ["entropy", "fi"])
def test_multi_subject_engine(multi, method):
    for tag in ("dp2", "dp1"):
        cfg = (None if tag == "dp2" else
               ExperimentConfig.from_pars({**MULTI, "data_parallel": 1}))
        expr = MultiImgExperiment(str(multi / tag), cfg, device="cpu")
        expr.attach_subjects(TRAIN, TEST, HELD)
        if tag == "dp2":
            evs = expr._evaluators(expr.build_model(), "test",
                                   expr._stats("test"))
            assert all(isinstance(e, ShardedGridPoolEvaluator) for e in evs)
        expr.run_method(method, 2 * MULTI["k"])
        drop_npz(multi / tag / method)
    assert _round0(multi / "dp2", method) == _round0(multi / "jax", method)
    assert _files(multi / "dp2", method) == _files(multi / "dp1", method)
