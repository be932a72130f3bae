"""The control of a cell's correctness check: the plain reference put in
the program's place at TF32, the nearest precision below the
configuration's IEEE float32, at the cell's own sizes.  Its outputs go
through the cell's own ``check`` and the harness's ``correct``, as a
run's do, and should come out not correct.  With ``--fault`` the
stand-in carries one of the faults its driver's ``control`` names
instead (at float32).
Not run by the benchmark's own runs.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \\
        [--fault <name>]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import harness  # noqa: E402
import reference  # noqa: E402


def control(workload: str, seed: int, device="cuda", mix_update=None,
            fault=None):
    """``(checks, correct)`` of the stand-in's outputs for ``seed``."""
    man = harness.manifest()
    cell = harness.cell(man, workload)
    cfg = harness.config(cell["config"])
    mix = harness.traffic(cell["traffic"], cfg["family"])
    mix.update(mix_update or {})
    limits = harness.load_json(os.path.join(HERE, "limits",
                                            f"{workload}.json"))
    ctx = harness.Context(cell, cfg, mix, limits, seed, 0.0, device, "")
    drv = harness.driver(mix, cfg)
    inp = drv.inputs(ctx)
    if fault is None:
        out = drv.control(ctx, inp)
    else:
        with reference.precision(tf32=False):
            out = drv.control(ctx, inp, fault)
    with reference.precision(tf32=False):
        checks = drv.check(ctx, inp, out)
    return checks, harness.correct(checks)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args()
    for s in args.seeds.split(","):
        t = time.perf_counter()
        checks, ok = control(args.workload, int(s), fault=args.fault)
        print(json.dumps({"workload": args.workload, "seed": int(s),
                          "fault": args.fault, "correct": ok,
                          "readings": {c["name"]: c["value"]
                                       for c in checks},
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
