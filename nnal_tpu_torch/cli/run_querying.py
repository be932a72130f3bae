"""Classification AL driver, AlexNet/Caltech style (counterpart of
``nnal_tpu/cli/run_querying.py``)::

    python -m nnal_tpu_torch.cli.run_querying <root_dir> <imgs_path_file> \\
        <labels_file> <max_queries> [method,method,...] [key=val,...] \\
        [--device cuda|cpu]

Rebuild of ``run_querying_scr.py`` + ``run_AlexNet_AL`` (reference
NNAL.py:587-762): filter the dataset to target classes, split test/pool,
then loop querying methods over a shared initial model with per-method
resume — a method whose accuracy curve is complete is skipped, an
interrupted one resumes from its queries journal.  Runs on the card unless
``device="cpu"`` (``--device cpu``) is given; a missing CUDA device is an
error, not a fall-back to the host.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Sequence

import numpy as np

from nnal_tpu_torch.core.config import ExperimentConfig, set_parameters
from nnal_tpu_torch.core.device import resolve_device
from nnal_tpu_torch.engine.experiment import Experiment

DEFAULT_CLS_PARS = {
    "model_name": "Alex",
    "k": 10,
    "B": 100,
    "ntb": 256,
    "b": 32,
    "epochs": 2,
    "learning_rate": 1e-3,
    "dropout_rate": 0.5,
    "optimizer_name": "Adam",
    "lambda_": 0.0,
    "init_size": 20,
    "test_ratio": 0.2,
    "seed": 0,
}


def filter_classes(labels, target_classes: Sequence[int]):
    """Restrict a dataset to ``target_classes`` and remap labels to
    0..c-1 (reference run_querying_scr.py's class filtering)."""
    labels = np.asarray(labels)
    keep = np.flatnonzero(np.isin(labels, target_classes))
    remap = {int(c): i for i, c in enumerate(target_classes)}
    new_labels = np.asarray([remap[int(v)] for v in labels[keep]],
                            np.int64)
    return keep, new_labels


def run_classification_al(root_dir: str, pool, methods: Sequence[str],
                          max_queries: int, overrides: str = "",
                          run: Optional[int] = None, device=None) -> dict:
    """Multi-method AL campaign with per-method resume.  ``pool`` is any
    engine pool (``InMemoryPool`` / disk-backed ``ImagePathPool``);
    ``device`` None is the card."""
    device = resolve_device(device)
    par_path = os.path.join(root_dir, "parameters.txt")
    if os.path.exists(par_path):
        expr = Experiment(root_dir, device=device)
    else:
        pars = set_parameters(DEFAULT_CLS_PARS, overrides)
        pars["nclass"] = int(np.max(pool.labels)) + 1
        expr = Experiment(root_dir, ExperimentConfig.from_pars(pars),
                          device=device)
    expr.attach_pool(pool)

    if run is None:
        runs = [int(d) for d in os.listdir(root_dir) if d.isdigit()]
        run = min(runs) if runs else expr.add_run()

    expected_rounds = -(-max_queries // expr.config.query.k)
    results = {}
    for method in methods:
        mdir = os.path.join(root_dir, str(run), method)
        accs_path = os.path.join(mdir, "accs.txt")
        if os.path.exists(accs_path):
            done = np.atleast_1d(np.loadtxt(accs_path))
            if len(done) >= expected_rounds:
                # complete — skip (reference NNAL.py:626-632)
                results[method] = done
                continue
        if not os.path.exists(os.path.join(mdir, "curr_weights.npz")):
            expr.add_method(method, run)
        results[method] = expr.run_method(method, run, max_queries)["accs"]
    return results


def main(argv=None):
    """argv: root_dir imgs_path_file labels_file max_queries
    [method,method,...] [key=val,...] [--device cuda|cpu]"""
    from nnal_tpu_torch.data.image_pool import ImagePathPool

    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            print(__doc__)
            return 1
        device = argv[i + 1]
        del argv[i:i + 2]
    if len(argv) < 4:
        print(__doc__)
        return 1
    root_dir, paths_file, labels_file = argv[0], argv[1], argv[2]
    max_queries = int(argv[3])
    methods = argv[4].split(",") if len(argv) > 4 else ["random", "entropy"]
    overrides = argv[5] if len(argv) > 5 else ""
    pool = ImagePathPool(paths_file, labels_file, target_shape=(227, 227))
    res = run_classification_al(root_dir, pool, methods, max_queries,
                                overrides, device=device)
    for m, accs in res.items():
        print(f"{m}: {np.asarray(accs).tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
