"""Two-round campaigns of the stochastic and batch-diverse strategies
through the port's ``do_expr`` on the host (``patch_shape [9,9,1]``, a
16x16x4 synthetic subject): MC-entropy, BALD, BatchBALD, the committees
ensemble and QBC-JS, AU_4U (CE with noise; L2 with a rotation),
rep-entropy and BADGE.  Each runs in its own directory (a reloaded
``parameters.txt`` does not carry ``synthetic_shape``), whose
checkpoints are deleted as soon as it ends."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from nnal_tpu_torch.cli.expr_handler import do_expr

torch.set_num_threads(1)

K = 10
BASE = ("patch_shape=[9,9,1],grid_spacing=2,k=10,B=30,ntb=256,b=32,"
        "epochs=1,init_size=20,learning_rate=1e-3,optimizer_name=Adam,"
        "MC_iters=3,n_ensemble=2,synthetic_shape=[16,16,4],seed=3")
RUNS = {m: (m, BASE) for m in ("MC-entropy", "BALD", "BatchBALD",
                               "ensemble", "QBC-JS", "AU_4U",
                               "rep-entropy", "BADGE")}
RUNS["AU_4U-rotation-L2"] = (
    "AU_4U", BASE + ",rotation_angle=0.3,output_perturbation_measure=L2")
COMMITTEE = ("ensemble", "QBC-JS")


@pytest.fixture(scope="module")
def campaigns(tmp_path_factory):
    top = tmp_path_factory.mktemp("stochastic")
    out = {}
    try:
        for name, (method, overrides) in RUNS.items():
            root = str(top / name)
            res = do_expr(root, method, 2 * K, overrides, synthetic=True,
                          device="cpu")
            with open(os.path.join(root, method, "phases.jsonl")) as f:
                phases = [json.loads(line) for line in f]
            queries = [np.loadtxt(os.path.join(root, method, "queries",
                                               f"{i}.txt"), dtype=np.int64)
                       for i in range(2)]
            init_pool = np.loadtxt(os.path.join(root, "init_pool_inds.txt"),
                                   dtype=np.int64)
            out[name] = (method, res, phases, queries, init_pool)
            shutil.rmtree(root, ignore_errors=True)
        yield out
    finally:
        shutil.rmtree(top, ignore_errors=True)


@pytest.mark.parametrize("name", list(RUNS))
def test_two_rounds_membership_and_picks(campaigns, name):
    method, res, _, queries, init_pool = campaigns[name]
    assert res["n_queries"] == 2 * K and len(res["perf"]) == 2
    assert np.isfinite(res["perf"]).all()
    for q in queries:
        assert len(q) == K and len(np.unique(q)) == K
    train, pool = res["train_inds"], res["pool_inds"]
    assert len(train) == 20 + 2 * K == len(set(train.tolist()))
    assert not set(train.tolist()) & set(pool.tolist())
    assert set(train.tolist()) | set(pool.tolist()) == set(
        init_pool.tolist())


@pytest.mark.parametrize("name", list(RUNS))
def test_phases_hold_the_committee_where_it_applies(campaigns, name):
    method, _, phases, _, _ = campaigns[name]
    rounds = [r for r in phases if not r.get("tail")]
    assert len(rounds) == 2 and phases[-1].get("tail")
    has = ["committee" in r for r in rounds]
    assert has == [method in COMMITTEE] * 2
    for r in rounds:
        assert {"score_select", "train", "eval", "checkpoint"} <= set(r)
