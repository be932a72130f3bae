"""The port's ``fi`` campaign vs the JAX package's, from experiment
directories written by the JAX package (its own file and fixture, so
``--dist loadfile`` runs it beside ``test_torch_engine.py``).

The JAX package creates each experiment and the method's initial state
(dropout 0, SGD, B = 30 candidates, k = 10); the directory is copied and
each framework runs the same rounds (``iter_k`` ends in 0, so a round that
returns fewer than k picks does not add rounds).  Round 0 scores the same
weights, so its queries must be identical.  Round 1 scores weights
finetuned in two frameworks (params agree to ~1e-6, see
``test_torch_train.py``): its picks must overlap by >= 90% and the
F-measures agree within 0.02.  ``fi`` draws its PMF with replacement and
deduplicates, so a round returns between 1 and k picks.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from nnal_tpu.cli.expr_handler import create_expr as j_create_expr
from nnal_tpu.cli.expr_handler import do_expr as j_do_expr
from nnal_tpu.core import profiling as j_profiling
from nnal_tpu_torch.cli import expr_handler as t_cli
from nnal_tpu_torch.core import profiling as t_profiling
from test_torch_parallel_engine import link_npz

torch.set_num_threads(1)

K = 10
BASE = ("patch_shape=[9,9,1],grid_spacing=2,k=10,B=30,ntb=512,b=32,"
        "epochs=1,init_size=20,learning_rate=1e-2,optimizer_name=SGD,"
        "dropout_rate=0.0")
RUNS = {"plain": (BASE + ",iter_k=[10,10,0]", 2),
        "lambda": (BASE + ",lambda_=0.5,iter_k=[10,0]", 1)}


def _drop_checkpoints(root):
    """Delete the campaign's weights (~80 MB per full-width PW1
    checkpoint); the tests read only its text and JSON records."""
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".npz"):
                os.remove(os.path.join(dirpath, f))


@pytest.fixture(scope="module")
def campaigns(tmp_path_factory):
    out = {}
    for name, (overrides, _) in RUNS.items():
        # both packages keep the sub-spans of the next round record in a
        # module global; spans left there by another file's test on this
        # worker (a bare fi_select call) would land in round 0's record
        j_profiling.drain_subphases()
        t_profiling.drain_subphases()
        jdir = str(tmp_path_factory.mktemp(f"jax_{name}"))
        j_create_expr(jdir, overrides, synthetic=True).add_method("fi")
        tdir = str(tmp_path_factory.mktemp(f"port_{name}") / "expr")
        shutil.copytree(jdir, tdir, copy_function=link_npz)
        out[name] = (jdir, tdir,
                     j_do_expr(jdir, "fi", 2 * K, synthetic=True),
                     t_cli.do_expr(tdir, "fi", 2 * K, synthetic=True,
                                   device="cpu"))
        # one campaign's checkpoints on disk at a time
        _drop_checkpoints(jdir)
        _drop_checkpoints(tdir)
    yield out
    for jdir, tdir, _, _ in out.values():
        shutil.rmtree(jdir, ignore_errors=True)
        shutil.rmtree(tdir, ignore_errors=True)


def _queries(root, it):
    return np.atleast_1d(np.loadtxt(
        os.path.join(root, "fi", "queries", f"{it}.txt"), dtype=np.int64))


def _phases(root):
    with open(os.path.join(root, "fi", "phases.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("name", list(RUNS))
def test_round0_queries_identical(campaigns, name):
    jdir, tdir, _, _ = campaigns[name]
    np.testing.assert_array_equal(_queries(tdir, 0), _queries(jdir, 0))


def test_round1_overlap_and_f_measure(campaigns):
    jdir, tdir, jres, tres = campaigns["plain"]
    jq, tq = _queries(jdir, 1), _queries(tdir, 1)
    assert len(set(jq.tolist()) & set(tq.tolist())) >= 0.9 * min(len(jq),
                                                                  len(tq))
    assert len(jres["perf"]) == len(tres["perf"]) == 2
    assert np.isfinite(tres["perf"]).all()
    np.testing.assert_allclose(tres["perf"], jres["perf"], rtol=0,
                               atol=0.02)


@pytest.mark.parametrize("name", list(RUNS))
def test_rounds_membership_and_pick_counts(campaigns, name):
    _, tdir, _, res = campaigns[name]
    rounds = RUNS[name][1]
    assert sorted(os.listdir(os.path.join(tdir, "fi", "queries"))) == \
        [f"{i}.txt" for i in range(rounds)]
    picks = [_queries(tdir, i) for i in range(rounds)]
    for q in picks:
        assert 1 <= len(q) <= K and len(np.unique(q)) == len(q)
    init_pool = np.loadtxt(os.path.join(tdir, "init_pool_inds.txt"),
                           dtype=np.int64)
    train, pool = res["train_inds"], res["pool_inds"]
    assert res["n_queries"] == sum(len(q) for q in picks)
    assert len(train) == 20 + res["n_queries"] == len(set(train.tolist()))
    assert not set(train.tolist()) & set(pool.tolist())
    assert set(train.tolist()) | set(pool.tolist()) == set(
        init_pool.tolist())


@pytest.mark.parametrize("name", list(RUNS))
def test_phases_carry_the_jax_sub_spans(campaigns, name):
    jdir, tdir, _, _ = campaigns[name]
    # both engines append a "tail" record (the loop end's checkpoint
    # phase: the last async write's wait and the final save)
    jp, tp = _phases(jdir), _phases(tdir)
    assert [bool(r.get("tail")) for r in jp] == \
        [bool(r.get("tail")) for r in tp]
    jp = [r for r in jp if not r.get("tail")]
    tp = [r for r in tp if not r.get("tail")]
    assert len(jp) == len(tp) == RUNS[name][1]
    for j, t in zip(jp, tp):
        assert set(t["sub"]) == set(j["sub"])
        assert all(v >= 0 for v in t["sub"].values())
    want = {"fi/posteriors", "fi/gather_grads_A", "fi/sdp", "fi/pmf"}
    if name == "lambda":
        want.add("fi/features")
    assert set(tp[0]["sub"]) == want

