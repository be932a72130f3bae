"""Multi-subject ("universal") active learning across training subjects
(counterpart of ``examples/multi_subject_al.py``).

One model, several training subjects: each round queries a ``(voxel,
subject)`` matrix from the union of the subjects' grid pools, finetunes
on batches drawn across subjects and scores the mean F-measure on a
held-out test subject.  Queries are journaled per round
(``queries/<round>.txt``) with per-round timing files
(``AL_running_times/dt_<round>``), so a campaign resumes after a crash.
Synthetic subjects stand in for real ones; ``data/io.SubjectRegistry``
and ``data/formats`` load NRRD / NIfTI subjects.
"""

from __future__ import annotations

import os

from nnal_tpu_torch.examples._cli import parser, rounded


def main(root_dir: str, method: str = "entropy", nqueries: int = 24,
         tiny: bool = False, device=None) -> dict:
    import numpy as np

    from nnal_tpu_torch.core.config import ExperimentConfig
    from nnal_tpu_torch.core.journal import load_inds
    from nnal_tpu_torch.data.io import synthetic_subject
    from nnal_tpu_torch.engine.multi_experiment import MultiImgExperiment

    if tiny:
        shape, n_train, nqueries = (20, 20, 6), 2, min(nqueries, 6)
        pars = {"model_name": "PW", "nclass": 2, "patch_shape": (9, 9, 1),
                "grid_spacing": 5, "k": 3, "B": 12, "ntb": 256, "b": 32,
                "epochs": 2, "MC_iters": 2, "learning_rate": 3e-4,
                "optimizer_name": "Adam", "dropout_rate": 0.2,
                "init_size": 6}
    else:
        shape, n_train = (40, 40, 12), 3
        pars = {"model_name": "PW", "nclass": 2, "patch_shape": (11, 11, 1),
                "grid_spacing": 2, "k": 8, "B": 200, "ntb": 1024, "b": 64,
                "epochs": 15, "MC_iters": 3, "learning_rate": 1e-3,
                "optimizer_name": "Adam", "dropout_rate": 0.5,
                "init_size": 24}

    train = [synthetic_subject(shape=shape, n_modalities=2, n_blobs=8,
                               seed=s) for s in range(n_train)]
    test = [synthetic_subject(shape=shape, n_modalities=2, n_blobs=8,
                              seed=100)]
    expr = MultiImgExperiment(root_dir, ExperimentConfig.from_pars(pars),
                              device=device)
    expr.attach_subjects(train, test_subjects=test)
    expr.prep_data()
    expr.add_method(method)
    res = expr.run_method(method, nqueries)
    print(f"{method}: {res['n_queries']} queries across {n_train} "
          "subjects; mean test-F per round:",
          rounded(np.atleast_1d(res["perf"])))
    # each round's journal is a 2 x k (voxel, subject) matrix
    q0 = load_inds(os.path.join(root_dir, method, "queries", "0.txt"),
                   matrix=True)
    print("round-0 (voxel, subject) queries:",
          list(zip(q0[0, :3].tolist(), q0[1, :3].tolist())), "...")
    return res


if __name__ == "__main__":
    ap = parser("multi_subject_al")
    ap.add_argument("--method", default="entropy")
    ap.add_argument("--nqueries", type=int, default=24)
    a = ap.parse_args()
    main(a.root_dir, a.method, a.nqueries, a.tiny, a.device)
