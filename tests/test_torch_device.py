"""The port's entry points run on the card unless the caller asks for the
host: without CUDA they raise, naming ``device="cpu"``."""

import numpy as np
import pytest
import torch

from nnal_tpu_torch.core.profiling import PhaseTimer
from nnal_tpu_torch.data.patches import pad_volumes
from nnal_tpu_torch.models.cnn import init_cnn
from nnal_tpu_torch.models.specs import create_pw1

torch.set_num_threads(1)

CALLS = {
    "init_cnn": lambda: init_cnn(create_pw1(2, 0.5, (9, 9, 2)), seed=0),
    "pad_volumes": lambda: pad_volumes([np.zeros((4, 4, 2))] * 2, (3, 3, 1)),
    "PhaseTimer": lambda: PhaseTimer(None),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_default_device_is_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        CALLS[name]()


def test_explicit_cpu_device_runs_on_the_host():
    model = init_cnn(create_pw1(2, 0.5, (9, 9, 2)), seed=0, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    assert pad_volumes([np.zeros((4, 4, 2))] * 2, (3, 3, 1),
                       device="cpu").shape == (2, 6, 6, 2)
    assert PhaseTimer(None, device="cpu").device.type == "cpu"
