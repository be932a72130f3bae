"""``query.data_parallel`` in the single-subject engine on the CPU: the
engine builds ``ShardedGridPoolEvaluator`` over ``cached_mesh(dp)`` (CPU
shards here); ``tests/test_torch_parallel_multi.py`` holds the
multi-subject engine.

From one JAX-written directory (``data_parallel`` 2, PW1 at 7x7 patches,
dropout 0, SGD):

* ``entropy`` and ``fi``: round 0's picks of the port at ``data_parallel``
  2 equal the JAX engine's at ``data_parallel`` 2 (its sharded evaluator
  on the conftest's 8-device CPU mesh);
* two rounds of each at ``data_parallel`` 2 equal two rounds at
  ``data_parallel`` 1 (journal, membership and ``perf_evals.txt``, exactly);
* ``core-set`` too (the features ride the sharded whole sweep on the
  device);
* an explicit mesh handed to the engine is the one its evaluator factory
  (``engine/common.grid_evaluator``) builds on; without one it is
  ``cached_mesh(2)``.

The JAX directory's checkpoints are hard-linked into the port's two
copies, not copied (every writer replaces a checkpoint atomically, so a
link is never written through); each run's checkpoints are deleted once
it ends (the tests read text records only), the rest when the module
ends.
"""

import os
import shutil

import pytest
import torch

from nnal_tpu.core.config import ExperimentConfig as JConfig
from nnal_tpu.engine.pw_experiment import PWExperiment as JExpr
from nnal_tpu_torch.core.config import ExperimentConfig
from nnal_tpu_torch.data.io import synthetic_subject
from nnal_tpu_torch.engine.common import grid_evaluator
from nnal_tpu_torch.engine.pw_experiment import PWExperiment
from nnal_tpu_torch.parallel.grid_sharded import ShardedGridPoolEvaluator
from nnal_tpu_torch.parallel.mesh import cached_mesh, make_mesh

torch.set_num_threads(1)

SINGLE = {"model_name": "PW", "patch_shape": (7, 7, 1), "grid_spacing": 3,
          "k": 3, "B": 16, "ntb": 256, "b": 16, "epochs": 2,
          "learning_rate": 1e-2, "optimizer_name": "SGD",
          "dropout_rate": 0.0, "init_size": 12, "seed": 9,
          "data_parallel": 2}
SUBJECT = synthetic_subject(shape=(20, 20, 8), n_modalities=1, seed=4,
                            n_blobs=10)
def _files(root, method):
    d = os.path.join(str(root), method)
    names = sorted(os.listdir(os.path.join(d, "queries")))
    out = {f: open(os.path.join(d, "queries", f)).read() for f in names}
    for f in ("curr_train_inds.txt", "curr_pool_inds.txt",
              "perf_evals.txt"):
        if os.path.exists(os.path.join(d, f)):
            out[f] = open(os.path.join(d, f)).read()
    return out


def _round0(root, method):
    return open(os.path.join(str(root), method, "queries", "0.txt")).read()


def link_npz(src, dst):
    """``copytree``'s copy function for run directories: a checkpoint is
    hard-linked (the engines replace checkpoints, never rewrite them in
    place, so neither side writes through the link), anything else is
    copied."""
    if src.endswith(".npz"):
        os.link(src, dst)
    else:
        shutil.copy2(src, dst)


def drop_npz(root):
    """Delete every checkpoint under ``root``."""
    for d, _, files in os.walk(str(root)):
        for f in files:
            if f.endswith(".npz"):
                os.remove(os.path.join(d, f))


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    top = tmp_path_factory.mktemp("dp_single")
    try:
        jdir = top / "jax"
        jexpr = JExpr(str(jdir), JConfig.from_pars(SINGLE))
        jexpr.attach_subject(*SUBJECT)
        jexpr.prep_data()
        for m in ("entropy", "fi", "core-set"):
            jexpr.add_method(m)
        for tag in ("dp2", "dp1"):
            shutil.copytree(jdir, top / tag, copy_function=link_npz)
        for m in ("entropy", "fi"):
            jexpr.run_method(m, SINGLE["k"])
            drop_npz(jdir / m)
        yield top
    finally:
        shutil.rmtree(top, ignore_errors=True)


def _port_single(top, tag, mesh=None):
    cfg = (None if tag == "dp2"
           else ExperimentConfig.from_pars({**SINGLE, "data_parallel": 1}))
    expr = PWExperiment(str(top / tag), cfg, device="cpu", mesh=mesh)
    expr.attach_subject(*SUBJECT)
    return expr


@pytest.mark.parametrize("method", ["entropy", "fi", "core-set"])
def test_single_subject_engine(single, method):
    for tag in ("dp2", "dp1"):
        _port_single(single, tag).run_method(method, 2 * SINGLE["k"])
        drop_npz(single / tag / method)
    if method != "core-set":
        assert _round0(single / "dp2", method) == _round0(single / "jax",
                                                          method)
    assert _files(single / "dp2", method) == _files(single / "dp1", method)
    assert len(_files(single / "dp2", method)) >= 4


def test_engine_evaluator_factory_takes_a_mesh(single):
    expr = _port_single(single, "dp2")
    spec = expr.build_model()
    ev = expr.make_evaluator(spec)
    assert isinstance(ev, ShardedGridPoolEvaluator)
    assert ev.mesh is cached_mesh(2, device="cpu")
    mesh = make_mesh(4, device="cpu")
    assert _port_single(single, "dp2", mesh).make_evaluator(spec).mesh \
        is mesh
    assert grid_evaluator(expr.config, spec, expr.padded(), [0.0], [1.0],
                          SUBJECT[0][0].shape, mesh).mesh is mesh
    one = _port_single(single, "dp1").make_evaluator(spec)
    assert not isinstance(one, ShardedGridPoolEvaluator)
