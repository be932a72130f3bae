"""Single-subject patch-wise active learning, end to end (counterpart of
``examples/patchwise_al.py``).

``cli/expr_handler.do_expr`` drives ``PWExperiment.run_method`` —
query, label, finetune, evaluate — on one synthetic subject, with the
experiment directory as the resumable journal.  Two strategies are
compared by their F-measure learning curves; any method name of
``scoring/strategies`` works in their place.
"""

from __future__ import annotations

import os

from nnal_tpu_torch.examples._cli import parser, rounded

TINY_OVERRIDES = ("patch_shape=[9,9,1],grid_spacing=4,k=5,B=30,ntb=256,"
                  "b=32,epochs=2,MC_iters=2,init_size=6,"
                  "learning_rate=1e-3,optimizer_name=Adam,"
                  "synthetic_shape=[24,24,8],synthetic_blobs=6")


def main(root_dir: str, methods=("entropy", "random"), nqueries: int = 60,
         tiny: bool = False, device=None) -> dict:
    import numpy as np

    from nnal_tpu_torch.cli.expr_handler import (DEMO_CAMPAIGN_OVERRIDES,
                                                 do_expr)

    if tiny:
        overrides = TINY_OVERRIDES
        nqueries = min(nqueries, 10)
    else:
        # the documented campaign protocol (why epochs >= 15: see the
        # constant)
        overrides = DEMO_CAMPAIGN_OVERRIDES

    curves = {}
    for method in methods:
        res = do_expr(os.path.join(root_dir, method), method, nqueries,
                      overrides, synthetic=True, device=device)
        curves[method] = np.asarray(res["perf"])
        print(f"{method:12s} F-measure per round:",
              rounded(curves[method]))
    return curves


if __name__ == "__main__":
    ap = parser("patchwise_al")
    ap.add_argument("--methods", default="entropy,random")
    ap.add_argument("--nqueries", type=int, default=60)
    a = ap.parse_args()
    main(a.root_dir, tuple(a.methods.split(",")), a.nqueries, a.tiny,
         a.device)
