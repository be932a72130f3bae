"""Dense-model (FC-DenseNet / Tiramisu) active learning, end to end
(counterpart of ``examples/dense_model_al.py``).

The config's ``model_name: Tiramisu`` switches the same ``PWExperiment``
engine the patch-wise flows use to whole-slice dense pool scoring
(``scoring/fcn_eval.FCNGridPoolEvaluator``) and queried-voxel-masked
dense finetunes, with the BN running statistics refreshed each round.
The uncertainty family (entropy, MC-entropy, BALD, BatchBALD, random)
and the feature-space family (core-set, rep-entropy, BADGE, on per-pixel
features) run on dense specs; the per-patch gradient methods (fi,
influence) need the patch-wise evaluator.

``--mt`` turns on the dense mean teacher (whole-slice unlabeled
consistency in the finetune) with the labeled-count ramp-down
(``consistency_off_labels``).
"""

from __future__ import annotations

import os

from nnal_tpu_torch.examples._cli import parser, rounded


def main(root_dir, methods=("entropy", "BADGE"), nqueries=24,
         tiny=True, mt=False, device=None):
    import numpy as np

    from nnal_tpu_torch.core.config import ExperimentConfig
    from nnal_tpu_torch.data.io import synthetic_subject
    from nnal_tpu_torch.engine.pw_experiment import PWExperiment

    shape = (24, 24, 8) if tiny else (128, 128, 32)
    pars = {
        "model_name": "Tiramisu", "nclass": 2,
        # growth / depths size the FC-DenseNet; the published 103-layer
        # net is growth 16, depths (4, 5, 7, 10, 12, 15)
        "model_kwargs": ({"growth": 4, "depths": [2, 2]} if tiny
                         else {"growth": 8, "depths": [3, 4, 5]}),
        "patch_shape": (9, 9, 1),     # engine bookkeeping only (the fcn
                                      # takes whole slices)
        "grid_spacing": 4 if tiny else 2,
        "k": 4 if tiny else 32, "B": 16 if tiny else 128,
        "ntb": 256, "b": 4, "epochs": 2 if tiny else 25,
        "MC_iters": 2 if tiny else 5,
        "learning_rate": 1e-3, "optimizer_name": "Adam",
        "dropout_rate": 0.1, "init_size": 6 if tiny else 64, "seed": 3,
    }
    if mt:
        pars.update({"consistency_coeff": 0.5,
                     "consistency_measure": "MSE",
                     "consistency_ramp": 8, "unlabeled_batch": 2,
                     # full-strength MT below 24 labels, off at 48
                     "consistency_off_labels": 48})
    vols, mask = synthetic_subject(shape=shape, n_modalities=2,
                                   n_blobs=6 if tiny else 10, seed=0)
    curves = {}
    for method in methods:
        expr = PWExperiment(os.path.join(root_dir, method),
                            ExperimentConfig.from_pars(dict(pars)),
                            device=device)
        expr.attach_subject(vols, mask)
        expr.prep_data()
        expr.add_method(method)
        res = expr.run_method(method, nqueries)
        curves[method] = np.asarray(res["perf"])
        print(f"{method:12s} F-measure per round:",
              rounded(curves[method]))
    return curves


if __name__ == "__main__":
    ap = parser("dense_model_al")
    ap.add_argument("--mt", action="store_true")
    ap.add_argument("--methods", default="entropy,BADGE")
    ap.add_argument("--nqueries", type=int, default=24)
    a = ap.parse_args()
    main(a.root_dir, tuple(a.methods.split(",")), a.nqueries, a.tiny,
         a.mt, a.device)
