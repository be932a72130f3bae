"""Experiment front-end + CLI (counterpart of ``nnal_tpu/cli/expr_handler.py``)::

    python -m nnal_tpu_torch.cli.expr_handler <root_dir> <method> <nqueries> \\
        [key=val,key=val ...] [--synthetic] [--device cuda|cpu]

Runs on the card unless ``--device cpu`` is given; a missing CUDA device
is an error, not a fall-back to the host.
"""

from __future__ import annotations

import os
import sys

from nnal_tpu_torch.core.config import ExperimentConfig, set_parameters
from nnal_tpu_torch.engine.pw_experiment import PWExperiment
from nnal_tpu_torch.scoring.strategies import require_strategy

# the demo campaign's protocol on the dense synthetic subject, as the
# JAX package's (``expr_handler.py:27``): at least 15 epochs at lr 1e-3,
# since with tens of labels and b 64 an epoch is 1-2 Adam steps and
# shorter training can pin a method in its initial one-class regime
DEMO_CAMPAIGN_OVERRIDES = (
    "patch_shape=[11,11,1],grid_spacing=2,k=20,B=200,"
    "ntb=1024,b=64,epochs=15,init_size=40,seed=3,"
    "learning_rate=1e-3,optimizer_name=Adam,MC_iters=3,"
    "synthetic_shape=[40,40,12],synthetic_blobs=8")

DEFAULT_PARS = {
    "model_name": "PW",
    "patch_shape": [15, 15, 1],
    "grid_spacing": 3,
    "k": 10,
    "B": 100,
    "ntb": 1024,
    "b": 64,
    "epochs": 1,
    "MC_iters": 5,
    "learning_rate": 1e-3,
    "dropout_rate": 0.5,
    "optimizer_name": "Adam",
    "lambda_": 0.0,
    "init_size": 8,
    "seed": 0,
}


def create_expr(root_dir: str, overrides: str = "", synthetic: bool = False,
                device=None) -> PWExperiment:
    par_path = os.path.join(root_dir, "parameters.txt")
    if os.path.exists(par_path):
        expr = PWExperiment(root_dir, device=device)
    else:
        pars = set_parameters(DEFAULT_PARS, overrides)
        expr = PWExperiment(root_dir, ExperimentConfig.from_pars(pars),
                            device=device)
    if synthetic:
        from nnal_tpu_torch.data.io import synthetic_subject

        shape = tuple(getattr(expr.config, "synthetic_shape", (36, 36, 10)))
        blobs = int(getattr(expr.config, "synthetic_blobs", 3))
        vols, mask = synthetic_subject(shape=shape, n_modalities=2,
                                       n_blobs=blobs, seed=expr.config.seed)
        expr.attach_subject(vols, mask)
    if not os.path.exists(os.path.join(root_dir, "init_pool_inds.txt")):
        expr.prep_data()
    return expr


def do_expr(root_dir: str, method: str, nqueries: int, overrides: str = "",
            synthetic: bool = False, device=None) -> dict:
    """add_method-if-missing + run_method (reference ``do_expr``).  A
    method the port lacks raises before anything is written."""
    require_strategy(method)
    expr = create_expr(root_dir, overrides, synthetic, device)
    method_dir = os.path.join(root_dir, method)
    if not os.path.exists(os.path.join(method_dir, "curr_weights.npz")):
        expr.add_method(method)
    return expr.run_method(method, nqueries)


def print_parameters(root_dir: str) -> None:
    """Print an experiment's parameters, one ``key: value`` line each in
    sorted order (reference ``print_parameters``)."""
    import yaml

    with open(os.path.join(root_dir, "parameters.txt")) as f:
        pars = yaml.safe_load(f)
    for key in sorted(pars):
        print(f"{key:>20}: {pars[key]}")


def create_run(root_dir: str, overrides: str = "", synthetic: bool = False,
               device=None) -> PWExperiment:
    """:func:`create_expr` under the reference front end's name (a run is
    an experiment directory here)."""
    return create_expr(root_dir, overrides, synthetic, device)


def pop_device(argv: list):
    """Remove ``--device <name>`` from ``argv``; returns the name (None:
    the card), or raises ``ValueError`` when the name is missing."""
    if "--device" not in argv:
        return None
    i = argv.index("--device")
    if i + 1 >= len(argv):
        raise ValueError("--device needs a name (cuda or cpu)")
    device = argv[i + 1]
    del argv[i:i + 2]
    return device


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    synthetic = "--synthetic" in argv
    argv = [a for a in argv if a != "--synthetic"]
    try:
        device = pop_device(argv)
    except ValueError:
        print(__doc__)
        return 1
    if len(argv) < 3:
        print(__doc__)
        return 1
    root_dir, method, nqueries = argv[0], argv[1], int(argv[2])
    overrides = argv[3] if len(argv) > 3 else ""
    res = do_expr(root_dir, method, nqueries, overrides, synthetic, device)
    print(f"method={method} queries={res['n_queries']} "
          f"perf={res['perf'].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
