"""Repeated runs of a method comparison (counterpart of
``nnal_tpu/cli/repeat_runs.py``, the reference's ``resetting_run.py``)::

    python -m nnal_tpu_torch.cli.repeat_runs <root> <methods,comma-sep> \\
        <nqueries> [n_runs] [overrides] [--device cuda|cpu]

Run ``r`` is the experiment directory ``<root>/run_<r>`` with ``seed=r``
appended to the overrides, on the synthetic subject; each of its methods
goes through ``expr_handler.do_expr``.  ``counter.txt`` holds the number
of finished runs, so a second call starts at the first unfinished run
(and ``do_expr`` resumes that run's methods from their own directories),
and each finished run appends ``<r> <seconds>`` to ``durations.txt``.
Runs on the card unless ``device="cpu"`` (``--device cpu``) is given.
"""

from __future__ import annotations

import os
import sys
import time

from nnal_tpu_torch.cli.expr_handler import do_expr, pop_device


def repeat_runs(root_dir: str, methods, nqueries: int, n_runs: int = 10,
                overrides: str = "", synthetic: bool = True, device=None):
    os.makedirs(root_dir, exist_ok=True)
    counter_path = os.path.join(root_dir, "counter.txt")
    start = 0
    if os.path.exists(counter_path):
        with open(counter_path) as f:
            start = int(f.read().strip())
    for run in range(start, n_runs):
        t0 = time.time()
        run_root = os.path.join(root_dir, f"run_{run}")
        ov = overrides + (("," if overrides else "") + f"seed={run}")
        for method in methods:
            do_expr(run_root, method, nqueries, ov, synthetic=synthetic,
                    device=device)
        with open(os.path.join(root_dir, "durations.txt"), "a") as f:
            f.write(f"{run} {time.time() - t0:.2f}\n")
        with open(counter_path, "w") as f:
            f.write(str(run + 1))


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        device = pop_device(argv)
    except ValueError:
        argv = []
    if len(argv) < 3:
        print("usage: repeat_runs.py <root> <methods,comma-sep> <nqueries> "
              "[n_runs] [overrides] [--device cuda|cpu]")
        return 1
    root, methods, nq = argv[0], argv[1].split(","), int(argv[2])
    n_runs = int(argv[3]) if len(argv) > 3 else 10
    overrides = argv[4] if len(argv) > 4 else ""
    repeat_runs(root, methods, nq, n_runs, overrides, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
