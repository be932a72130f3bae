"""A campaign with pool scoring sharded over a device mesh (counterpart
of ``examples/multichip_campaign.py``).

One config key, ``data_parallel=N``, makes every grid-pool strategy
score its pool across an N-device mesh: each shard sweeps its z-slab of
the volume with the same per-chunk program as one device, so the
selections equal one device's bit for bit
(``parallel/grid_sharded.py``; checked below, round by round).

The JAX script re-executes itself with 8 virtual CPU devices.  Here the
mesh is an explicit list of 8 devices handed to the engine: the card
listed 8 times (8 shards on one card), or ``cpu`` 8 times on the host.
On 8 distinct cards, pass them instead (``parallel/mesh.make_mesh(8)``).
"""

from __future__ import annotations

import os

from nnal_tpu_torch.examples._cli import parser, rounded

N_DEVICES = 8


def main(root_dir: str, tiny: bool = False, method: str = "entropy",
         device=None) -> None:
    import numpy as np

    from nnal_tpu_torch.cli.expr_handler import do_expr
    from nnal_tpu_torch.core.device import resolve_device
    from nnal_tpu_torch.parallel.mesh import make_mesh

    dev = resolve_device(device)
    mesh = make_mesh(N_DEVICES, device=[dev] * N_DEVICES)
    nq = 10 if tiny else 30
    base = ("patch_shape=[9,9,1],grid_spacing=2,k=5,B=40,ntb=512,b=32,"
            "epochs=2,MC_iters=2,init_size=8,learning_rate=1e-3,"
            "optimizer_name=Adam,synthetic_shape=[24,24,8],"
            "synthetic_blobs=6")
    res8 = do_expr(os.path.join(root_dir, "dp8"), method, nq,
                   base + f",data_parallel={N_DEVICES}", synthetic=True,
                   device=dev, mesh=mesh)
    res1 = do_expr(os.path.join(root_dir, "dp1"), method, nq,
                   base + ",data_parallel=1", synthetic=True, device=dev)
    print(f"{method} perf  dp={N_DEVICES}:", rounded(res8["perf"]))
    print(f"{method} perf  dp=1:", rounded(res1["perf"]))

    # the sharded sweep is not an approximation: every round's selections
    # equal one device's bit for bit
    for it in range(len(res8["perf"])):
        q8 = np.loadtxt(os.path.join(root_dir, "dp8", method, "queries",
                                     f"{it}.txt"), dtype=np.int64)
        q1 = np.loadtxt(os.path.join(root_dir, "dp1", method, "queries",
                                     f"{it}.txt"), dtype=np.int64)
        if not np.array_equal(q8, q1):
            raise AssertionError(f"round {it} selections diverged")
    print(f"all {len(res8['perf'])} rounds: dp={N_DEVICES} selections "
          "bit-identical to dp=1")


if __name__ == "__main__":
    ap = parser("multichip_campaign")
    ap.add_argument("--method", default="entropy")
    a = ap.parse_args()
    main(a.root_dir, a.tiny, a.method, a.device)
