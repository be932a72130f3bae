"""Crash-resume == continue under the mean teacher (CPU): ``entropy``, 3
rounds, anchors every 2 rounds, at f32 and at int8 anchors (where the
live teacher adopts the int8 rounding at each anchor, as the params do).
The crashed run loses its resume-point writes, so the resumed process
replays both finetunes from the initial weights (building the teacher
again from them) and runs round 3 from the replayed teacher.  Weights,
the ``teacher/`` group, the query journal and ``perf_evals.txt``:
bit-identical."""

import os
import shutil

import numpy as np
import pytest
import torch

from nnal_tpu_torch.core.config import ExperimentConfig
from nnal_tpu_torch.data.io import synthetic_subject
from nnal_tpu_torch.engine import pw_experiment as pw_mod
from nnal_tpu_torch.models.checkpoint import load_checkpoint
from test_torch_committee import _artifacts, _DropResumeWrites

torch.set_num_threads(1)

VOLS = synthetic_subject(shape=(16, 16, 4), n_modalities=2, n_blobs=10,
                         seed=1)
PARS = {
    "model_name": "PW", "nclass": 2, "patch_shape": (9, 9, 1),
    "grid_spacing": 2, "k": 8, "ntb": 256, "b": 16, "epochs": 1,
    "learning_rate": 1e-3, "optimizer_name": "Adam", "dropout_rate": 0.5,
    "init_size": 16, "seed": 5, "consistency_coeff": 1.0,
    "consistency_ramp": 4, "ema_decay": 0.9, "unlabeled_batch": 12,
    "ckpt_full_every": 2,
}


@pytest.fixture
def tmp_path(tmp_path):
    """Drop the checkpoints (tens of MB each) as soon as the test ends."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _fresh(root, **over):
    expr = pw_mod.PWExperiment(str(root),
                               ExperimentConfig.from_pars({**PARS, **over}),
                               device="cpu")
    expr.attach_subject(*VOLS)
    return expr


@pytest.mark.parametrize("ckpt_dtype,marker", [("float32", "teacher/fc1/W"),
                                               ("int8",
                                                "teacher/fc1/W@i8")])
def test_mt_crash_resume_equals_continue(tmp_path, ckpt_dtype, marker):
    n = 3 * PARS["k"]
    a = _fresh(tmp_path / "a", ckpt_dtype=ckpt_dtype)
    a.prep_data()
    a.add_method("entropy")
    a.run_method("entropy", n)
    ref = _artifacts(tmp_path / "a", "entropy")
    shutil.rmtree(tmp_path / "a")
    assert marker in ref[2]
    b = _fresh(tmp_path / "b", ckpt_dtype=ckpt_dtype)
    b.prep_data()
    b.add_method("entropy")
    with _DropResumeWrites() as w:
        b.run_method("entropy", 2 * PARS["k"])
    assert w.dropped >= 1
    _fresh(tmp_path / "b", ckpt_dtype=ckpt_dtype).run_method("entropy", n)
    got = _artifacts(tmp_path / "b", "entropy")
    assert got[0] == ref[0] and len(got[0]) == 3, "query journals differ"
    assert got[1] == ref[1], "per-round evals differ"
    assert sorted(got[2]) == sorted(ref[2])
    for k in ref[2]:
        np.testing.assert_array_equal(got[2][k], ref[2][k], err_msg=k)
    # the teacher moved away from the student
    params, _, teacher, _ = load_checkpoint(
        os.path.join(str(tmp_path / "b"), "entropy", "curr_weights.npz"))
    assert not np.array_equal(params["fc1"]["W"], teacher["fc1"]["W"])
