"""Pool-based classification active learning, end to end (counterpart of
``examples/classification_al.py``).

``engine/experiment.Experiment`` holds *runs* (a random partition of the
data and a fresh model init) and *methods* within runs (independent AL
trajectories from the same start); each round's test predictions go to
``predicts.txt`` and accuracies to ``accs.txt``.  The data is a
synthetic two-Gaussian image problem; ``attach_data(X, labels)`` takes
any ``(n, h, w, c)`` array, and ``attach_pool`` with
``data/image_pool.ImagePathPool`` serves pools too big for memory
(``cli/run_querying``).
"""

from __future__ import annotations

from nnal_tpu_torch.examples._cli import parser, rounded


def make_data(n: int = 240, seed: int = 0):
    import numpy as np

    rng = np.random.default_rng(seed)
    X0 = rng.normal(size=(n // 2, 8, 8, 1))
    X1 = rng.normal(size=(n // 2, 8, 8, 1)) + 1.5
    X = np.concatenate([X0, X1]).astype(np.float32)
    y = np.repeat([0, 1], n // 2)
    perm = rng.permutation(n)
    return X[perm], y[perm]


def main(root_dir: str, methods=("entropy", "random"), nqueries: int = 30,
         tiny: bool = False, device=None) -> dict:
    import numpy as np

    from nnal_tpu_torch.core.config import ExperimentConfig
    from nnal_tpu_torch.engine.experiment import Experiment

    if tiny:
        nqueries = min(nqueries, 10)
    cfg = ExperimentConfig.from_pars({
        "model_name": "PW", "nclass": 2, "patch_shape": (8, 8, 1),
        "k": 5, "B": 40, "ntb": 128, "b": 16, "epochs": 3,
        "learning_rate": 3e-4, "optimizer_name": "Adam",
        "dropout_rate": 0.2, "init_size": 10, "test_ratio": 0.25,
    })
    X, y = make_data(120 if tiny else 240)
    expr = Experiment(root_dir, cfg, device=device)
    expr.attach_data(X, y)
    run = expr.add_run()
    for m in methods:
        expr.add_method(m, run)
        res = expr.run_method(m, run, nqueries)
        print(f"{m:12s} accuracy per round:", rounded(res["accs"]))
    # the per-run aggregation (eval_run / summarize_all)
    summary = expr.summarize_all(list(methods))
    for m, curve in summary.items():
        print(f"{m:12s} mean curve:", np.round(np.atleast_1d(curve), 3))
    return summary


if __name__ == "__main__":
    ap = parser("classification_al")
    ap.add_argument("--methods", default="entropy,random")
    ap.add_argument("--nqueries", type=int, default=30)
    a = ap.parse_args()
    main(a.root_dir, tuple(a.methods.split(",")), a.nqueries, a.tiny,
         a.device)
