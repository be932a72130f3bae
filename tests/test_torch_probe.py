"""The port's device probe, its watchdog and the build priming
(``core/device_probe``, ``cli/wait_device``, ``cli/prime_cache``) on a
machine without a CUDA device.

* The probe's subprocess matmul answers on the host (``device="cpu"``).
* The default probe targets the card: here it reports unresponsive (the
  child fails; it never succeeds on the host instead), and
  ``wait_for_device`` gives up within ``max_wait`` without blocking on a
  probe.
* ``wait_device`` exits 0 on the host's probe and 3 when ``--max-wait``
  runs out on the card's; with ``--prime`` it hands back
  ``prime_cache``'s failure.
* ``prime_cache`` without ``nvcc`` raises, naming ``nvcc``; its
  micro-campaign, like every entry point, defaults to the card and
  raises naming ``device="cpu"`` without CUDA.
"""

import time

import pytest
import torch

from nnal_tpu_torch.cli import prime_cache, wait_device
from nnal_tpu_torch.core.device_probe import device_responsive, wait_for_device
from nnal_tpu_torch.ops import _build


def test_probe_answers_on_the_host():
    assert device_responsive(timeout_s=120, device="cpu")


def test_default_probe_reports_unresponsive_without_a_card():
    assert not device_responsive(timeout_s=120)


def test_wait_for_device_gives_up_within_max_wait():
    """A budget of two probes (a probe's time is mostly the child's
    ``import torch``): one retry is logged, then it gives up, within the
    budget and one probe's timeout."""
    t0 = time.monotonic()
    assert not device_responsive(timeout_s=60)
    budget = 2 * (time.monotonic() - t0) + 1
    msgs = []
    t0 = time.monotonic()
    ok = wait_for_device(probe_timeout_s=60, interval_s=1,
                         max_wait_s=budget, log=msgs.append)
    assert ok is False
    assert time.monotonic() - t0 < budget + 60
    assert msgs and "unresponsive" in msgs[0]


def test_wait_device_exit_codes():
    assert wait_device.main(["--interval", "1", "--max-wait", "2"]) == 3
    assert wait_device.main(["--device", "cpu", "--max-wait", "600"]) == 0
    # the host answers, then priming fails (no nvcc here): its exit code
    assert wait_device.main(["--device", "cpu", "--max-wait", "600",
                             "--prime", "--prime-methods", ""]) != 0


def test_prime_cache_without_nvcc_raises_naming_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc"):
        prime_cache.prime_builds()


def test_new_entry_points_default_to_the_card(monkeypatch):
    from nnal_tpu_torch.evaluation.inference import FCNInference
    from nnal_tpu_torch.models.specs import create_tiramisu103

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        prime_cache.prime(["random"], verbose=False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        FCNInference(create_tiramisu103(2, (32, 32, 32, 1)))
