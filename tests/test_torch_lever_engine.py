"""Two-round campaigns of each training lever through the port's
``do_expr`` on the host (``patch_shape [9,9,1]``, a 16x16x4 synthetic
subject): the mean teacher (CE with a ramp and its own unlabeled batch
size, MSE, and under QBC-JS, whose members build their own teachers),
LwF, the aleatoric head and ``train_layers``; the CE run also mirrors
its metrics to TensorBoard.
Each run's checkpoints are deleted once it is read.  Also: the ported
keys are accepted where ``check_slice_config`` used to reject them, the
committee members never touch the main teacher (crash-resume with the
teacher: ``tests/test_torch_mt_resume.py``)."""

import os
import shutil

import numpy as np
import pytest
import torch

from nnal_tpu_torch.cli import expr_handler as t_cli
from nnal_tpu_torch.core.config import ExperimentConfig, set_parameters
from nnal_tpu_torch.engine import pw_experiment as pw_mod
from nnal_tpu_torch.models.checkpoint import load_checkpoint
from nnal_tpu_torch.models.train import init_train_state

torch.set_num_threads(1)

K = 8
BASE = ("patch_shape=[9,9,1],grid_spacing=2,k=8,B=20,ntb=256,b=16,"
        "epochs=1,init_size=16,learning_rate=1e-3,optimizer_name=Adam,"
        "synthetic_shape=[16,16,4],synthetic_blobs=10,seed=3")
RUNS = {
    "mt-CE": ("entropy", ",consistency_coeff=1.0,consistency_ramp=4,"
                         "ema_decay=0.9,unlabeled_batch=12,"
                         "tb_logdir={tb}"),
    "mt-MSE": ("entropy", ",consistency_coeff=1.0,consistency_measure=MSE"),
    "mt-QBC-JS": ("QBC-JS", ",consistency_coeff=1.0,n_ensemble=2"),
    "lwf": ("entropy", ",lwf_lambda=1.0,lwf_T=2"),
    "aleatoric": ("entropy", ",aleatoric=true,mc_t=4"),
    "train_layers": ("random", ",train_layers=[fc1,fc2,fc3]"),
}
MT = ("mt-CE", "mt-MSE", "mt-QBC-JS")


def _tb_scalars(logdir):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(logdir)
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


@pytest.fixture(scope="module")
def campaigns(tmp_path_factory):
    top = tmp_path_factory.mktemp("levers")
    out = {}
    try:
        for name, (method, extra) in RUNS.items():
            root = str(top / name)
            tb = str(top / "tb")
            res = t_cli.do_expr(root, method, 2 * K,
                                BASE + extra.format(tb=tb), synthetic=True,
                                device="cpu")
            mdir = os.path.join(root, method)
            params, _, teacher, _ = load_checkpoint(
                os.path.join(mdir, "curr_weights.npz"))
            init = load_checkpoint(os.path.join(root, "init_weights.npz"))[0]
            out[name] = dict(res=res, params=params, teacher=teacher,
                             init=init, method=method,
                             tb=_tb_scalars(os.path.join(tb, method))
                             if "tb_logdir" in extra else None)
            shutil.rmtree(root)
        yield out
    finally:
        shutil.rmtree(top, ignore_errors=True)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_two_rounds_per_lever(campaigns, name):
    run = campaigns[name]
    res = run["res"]
    assert res["n_queries"] == 2 * K and len(res["perf"]) == 2
    assert np.isfinite(res["perf"]).all()
    train, pool = res["train_inds"], res["pool_inds"]
    assert len(set(train.tolist())) == len(train) == 16 + 2 * K
    assert not set(train.tolist()) & set(pool.tolist())
    assert (run["teacher"] is not None) == (name in MT)


@pytest.mark.parametrize("name", MT)
def test_mt_teacher_is_saved_and_lags_the_student(campaigns, name):
    p, t = campaigns[name]["params"], campaigns[name]["teacher"]
    assert sorted(t) == sorted(p)
    for layer in p:
        assert t[layer]["W"].shape == p[layer]["W"].shape
    assert not np.array_equal(t["fc1"]["W"], p["fc1"]["W"])
    assert not np.array_equal(t["fc1"]["W"], campaigns[name]["init"]["fc1"]
                              ["W"])


def test_train_layers_keeps_the_convs(campaigns):
    p, init = campaigns["train_layers"]["params"], \
        campaigns["train_layers"]["init"]
    for layer in p:
        same = all(np.array_equal(p[layer][k], init[layer][k])
                   for k in ("W", "b"))
        assert same == layer.startswith("conv"), layer


def test_aleatoric_head_is_saved(campaigns):
    assert campaigns["aleatoric"]["params"]["fc3"]["W"].shape[-1] == 4
    assert campaigns["lwf"]["params"]["fc3"]["W"].shape[-1] == 2


def test_tb_mirror_writes_the_rounds(campaigns):
    run = campaigns["mt-CE"]
    sc = run["tb"]
    assert [s for s, _ in sc["al/n_train"]] == [0, 1]
    assert [v for _, v in sc["al/n_train"]] == [16 + K, 16 + 2 * K]
    np.testing.assert_allclose([v for _, v in sc["al/f_measure"]],
                               run["res"]["perf"], rtol=0, atol=1e-7)


@pytest.mark.parametrize("override", [
    "consistency_coeff=0.5", "lwf_lambda=0.5", "aleatoric=true",
    "train_layers=[fc3]", "tb_logdir=tb"])
def test_ported_lever_keys_are_accepted(tmp_path, override):
    cfg = ExperimentConfig.from_pars(
        set_parameters(t_cli.DEFAULT_PARS, override))
    pw_mod.PWExperiment(str(tmp_path), cfg, device="cpu")


def test_unknown_consistency_measure_raises(tmp_path):
    cfg = ExperimentConfig.from_pars(set_parameters(
        t_cli.DEFAULT_PARS, "consistency_coeff=0.5,consistency_measure=KL"))
    with pytest.raises(ValueError, match="consistency_measure"):
        pw_mod.PWExperiment(str(tmp_path), cfg, device="cpu")


@pytest.fixture
def tmp_path(tmp_path):
    """Drop the checkpoints (tens of MB each) as soon as the test ends."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _expr(root, extra=""):
    pars = set_parameters(t_cli.DEFAULT_PARS, BASE + extra)
    expr = pw_mod.PWExperiment(str(root), ExperimentConfig.from_pars(pars),
                               device="cpu")
    expr.attach_subject(*_subject())
    return expr


def _subject():
    from nnal_tpu_torch.data.io import synthetic_subject

    return synthetic_subject(shape=(16, 16, 4), n_modalities=2, n_blobs=10,
                             seed=3)


def test_committee_members_build_their_own_teachers(tmp_path):
    """Under MT the main finetune builds the main teacher; each member
    starts without one and builds its own from its copy; the main teacher
    does not move."""
    expr = _expr(tmp_path, ",consistency_coeff=1.0,n_ensemble=2")
    expr.prep_data()
    j = expr.add_method("QBC-JS")
    spec = expr.build_model()
    train, _ = j.membership()
    model = expr._load_model(spec, load_checkpoint(
        j.path("curr_weights.npz"))[0])
    state = init_train_state(model, "Adam", 1e-3)
    expr.finetune(state, train)
    main_teacher = state.teacher
    before = {k: v.clone() for k, v in main_teacher.state_dict().items()}
    seen = []
    orig = expr.finetune

    def spy(mstate, inds, rng_tag=""):
        assert mstate.teacher is None
        out = orig(mstate, inds, rng_tag)
        seen.append(out.teacher)
        return out

    expr.finetune = spy
    members = expr._build_committee(spec, state, train, round_id=1)
    assert len(members) == 2 and len(seen) == 2
    assert state.teacher is main_teacher
    for k, v in main_teacher.state_dict().items():
        assert torch.equal(v, before[k]), k
    for t in seen:
        assert t is not None and t is not main_teacher
        assert not {p.data_ptr() for p in t.parameters()} & \
            {p.data_ptr() for p in main_teacher.parameters()}
