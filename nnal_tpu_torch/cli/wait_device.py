"""Block until the card is responsive, then optionally prime the builds
(counterpart of ``nnal_tpu/cli/wait_device.py``).

A wedged card hangs any CUDA call with no deadline.  The watchdog probes
with a hard-timeout subprocess matmul (``core/device_probe``) and only
then lets the queued jobs start:

    python -m nnal_tpu_torch.cli.wait_device && python chip_smoke.py
    python -m nnal_tpu_torch.cli.wait_device --max-wait 7200 || exit 3
    python -m nnal_tpu_torch.cli.wait_device --prime

Exit codes: 0 = responsive, 3 = --max-wait exceeded (a machine without
a CUDA device never answers the default probe; ``--device cpu`` probes
the host).  With ``--prime``, ``cli/prime_cache``'s exit code when it
fails.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

from nnal_tpu_torch.core.device_probe import wait_for_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--probe-timeout", type=int, default=300,
                    help="hard timeout (s) for each subprocess probe")
    ap.add_argument("--interval", type=int, default=120,
                    help="seconds between probes")
    ap.add_argument("--max-wait", type=float, default=0,
                    help="give up after this many seconds (0 = forever)")
    ap.add_argument("--prime", action="store_true",
                    help="after the device responds, build every kernel "
                         "and host library and run the micro-campaigns "
                         "(cli.prime_cache)")
    ap.add_argument("--prime-methods", default="entropy,fi,influence",
                    help="methods to prime (with --prime)")
    ap.add_argument("--device", default="cuda",
                    help="the device to probe: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    ok = wait_for_device(args.probe_timeout, args.interval, args.max_wait,
                         device=args.device)
    if ok and args.prime:
        # a subprocess, as the probe: this watchdog never touches the card
        rc = subprocess.call([sys.executable, "-m",
                              "nnal_tpu_torch.cli.prime_cache",
                              "--methods", args.prime_methods,
                              "--device", args.device])
        if rc != 0:
            return rc
    return 0 if ok else 3


if __name__ == "__main__":
    sys.exit(main())
