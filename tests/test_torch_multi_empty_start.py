"""Multi-subject campaigns from an empty start score F 0.0 on the test
subject in both packages (CPU).

``chip_smoke.py``'s multi runs start with no labels and score F 0.0 on
the synthetic test subject round after round.  The same configuration cut
to CPU size (PW1 on 9x9 patches, three 24x24x6 training subjects of ~4%
positives, a test and a held subject, Adam 1e-3, one epoch, k 16) gives
F 0.0 in both rounds in the JAX package's engine too: after one or two
finetunes on 16-32 mostly-background labels the model predicts
background everywhere.  A reproduced behaviour of the reference, not a
fault of the port (ROADMAP Queue 3)."""

import shutil

import numpy as np
import pytest
import torch

from nnal_tpu.core.config import ExperimentConfig as JConfig
from nnal_tpu.engine.multi_experiment import MultiImgExperiment as JMulti
from nnal_tpu_torch.core.config import ExperimentConfig
from nnal_tpu_torch.data.io import synthetic_subject
from nnal_tpu_torch.engine.multi_experiment import MultiImgExperiment

torch.set_num_threads(1)

SUBJECTS = [synthetic_subject(shape=(24, 24, 6), n_modalities=2, n_blobs=3,
                              seed=i) for i in range(5)]
PARS = {"model_name": "PW", "patch_shape": (9, 9, 1), "grid_spacing": 2,
        "k": 16, "B": 40, "b": 32, "epochs": 1, "learning_rate": 1e-3,
        "optimizer_name": "Adam", "ntb": 1024, "seed": 0, "init_size": 0}


@pytest.fixture
def tmp_path(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_empty_start_scores_zero_in_both_packages(tmp_path):
    train, test, held = SUBJECTS[:3], SUBJECTS[3:4], SUBJECTS[4:]
    assert all(0.0 < float(m.mean()) < 0.06 for _, m in SUBJECTS)
    perf = {}
    for name in ("jax", "port"):
        root = str(tmp_path / name)
        if name == "jax":
            expr = JMulti(root, JConfig.from_pars(dict(PARS)))
        else:
            expr = MultiImgExperiment(root, ExperimentConfig.from_pars(
                dict(PARS)), device="cpu")
        expr.attach_subjects(train, test, held)
        expr.prep_data()
        expr.add_method("entropy")
        perf[name] = np.asarray(expr.run_method("entropy", 32)["perf"])
        # each package's checkpoints go once its campaign has run
        shutil.rmtree(root)
    assert perf["jax"].tolist() == [0.0, 0.0]
    np.testing.assert_array_equal(perf["port"], perf["jax"])
