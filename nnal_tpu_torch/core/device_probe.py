"""Device health probe (counterpart of ``nnal_tpu/core/device_probe.py``).

A wedged card (a hung context, a GPU in a bad state) can hang any CUDA
call of the process that makes it, with no deadline.  The only safe
probe is a tiny matmul in a SUBPROCESS with a hard timeout: the parent
never touches the device, so it cannot hang with it.  The child
multiplies two 128x128 matrices of ones on ``device`` and must print
128; a missing CUDA device makes the child fail, so it reports
"unresponsive", never a success on the host.  ``device="cpu"`` probes the
host (the tests' case).

Shared by the ``nnal_tpu_torch.cli.wait_device`` watchdog (block until
healthy, then hand off to queued jobs).
"""

from __future__ import annotations

import subprocess
import sys
import time

_PROBE = ("import sys, torch; d = torch.device(sys.argv[1]); "
          "x = torch.ones((128, 128), device=d); "
          "v = float((x @ x)[0, 0]); "
          "sys.exit(0 if v == 128.0 else 1)")


def device_responsive(timeout_s: int = 570, device: str = "cuda") -> bool:
    """True iff a 128x128 matmul on ``device`` returns its value within
    ``timeout_s``, run in a subprocess."""
    try:
        subprocess.run([sys.executable, "-c", _PROBE, str(device)],
                       timeout=timeout_s, check=True, capture_output=True)
        return True
    except (subprocess.TimeoutExpired, subprocess.CalledProcessError):
        return False


def wait_for_device(probe_timeout_s: int = 300, interval_s: int = 120,
                    max_wait_s: float = 0, log=print,
                    device: str = "cuda") -> bool:
    """Block until ``device`` answers a probe; ``max_wait_s=0`` waits
    forever.  Returns True when healthy, False if the budget ran out."""
    t0 = time.monotonic()
    attempt = 0
    while True:
        attempt += 1
        if device_responsive(probe_timeout_s, device):
            if attempt > 1:
                log(f"device responsive after {attempt} probes "
                    f"({time.monotonic() - t0:.0f} s)")
            return True
        waited = time.monotonic() - t0
        if max_wait_s and waited + interval_s > max_wait_s:
            return False
        log(f"device unresponsive (probe {attempt}, {waited:.0f} s "
            f"elapsed) — retrying in {interval_s} s")
        time.sleep(interval_s)
