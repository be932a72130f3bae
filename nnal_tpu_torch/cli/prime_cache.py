"""Build everything the port compiles, then run a one-query
micro-campaign per method, while the card is healthy (counterpart of
``nnal_tpu/cli/prime_cache.py``).

What persists: the builds.  Every CUDA kernel of ``nnal_tpu_torch/csrc``
(``ops/_build.build_all``: one ``nvcc`` per source, in parallel) and every
host C++ source of ``nnal_tpu_torch/runtime`` (``runtime/gxx``: ``slic.cc``,
``patch_gather.cc``, ``dense_crf.cc``) lands in ``nnal_tpu_torch/_build/``
under a name hashed from its source and flags, so a later process loads
it and compiles nothing.  That directory is the port's counterpart of the
JAX package's persistent XLA compilation cache (``core/compile_cache``).
What does not persist: cuDNN's per-process algorithm choice (and
cuBLAS's handles and workspaces, PyTorch's CUDA context and its caching
allocator's pools): every process pays them again on its first call of
each shape.  The micro-campaign pays them in this process only; what it
gives the next one is a campaign path checked end to end on the card (at
the campaign protocol's shapes, ``PARS``) before the queued jobs start.

    python -m nnal_tpu_torch.cli.wait_device --prime && python chip_smoke.py

Usage: python -m nnal_tpu_torch.cli.prime_cache [--methods entropy,fi]
           [--pars k1=v1,k2=v2] [--device cuda|cpu]
A failed build raises with the compiler's message.  Exit code 0 on
success.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

# the JAX package's campaign-protocol parameters (its
# benchmarks/campaigns.py PARS), so a primed run is that campaign's
SHAPE = (128, 128, 32)
PARS = {
    "model_name": "PW", "nclass": 2, "patch_shape": (25, 25, 1),
    "grid_spacing": 2, "k": 1, "B": 128, "ntb": 4096, "b": 64,
    "epochs": 15, "MC_iters": 5, "learning_rate": 1e-3,
    "optimizer_name": "Adam", "dropout_rate": 0.5, "init_size": 16,
    "n_ensemble": 3, "seed": 11, "dtype": "bfloat16",
}


def prime_builds() -> dict:
    """Build every CUDA kernel and host library not yet in ``_build/``;
    returns ``{name: "present" | "built"}``.  Raises ``RuntimeError``
    with nvcc's or g++'s message when one fails (or names ``nvcc`` when
    it is missing)."""
    from nnal_tpu_torch import ops
    from nnal_tpu_torch.ops._build import build_all
    from nnal_tpu_torch.runtime import crf_native, native, slic_native
    from nnal_tpu_torch.runtime.gxx import build_library, library_path

    report = {k.name: "present" if k.lib_path().exists() else "built"
              for k in ops.KERNELS}
    build_all(list(ops.KERNELS))
    for mod in (slic_native, native, crf_native):
        present = os.path.exists(library_path(mod.SRC, mod.GXX_FLAGS,
                                              mod.STEM))
        build_library(mod.SRC, mod.GXX_FLAGS, mod.STEM)
        report[mod.STEM] = "present" if present else "built"
    return report


def prime(methods, pars_over=None, n_modalities: int = 2,
          n_subjects: int = 3, verbose: bool = True, device=None) -> dict:
    """Run a 1-query micro-campaign per method through the multi-subject
    engine at the campaign protocol's shapes (``prime_cache.py:43-91``):
    ``n_subjects`` synthetic subjects of ``SHAPE``, a test subject, 8
    labeled voxels.  Returns ``{method: seconds}``."""
    from nnal_tpu_torch.core.config import ExperimentConfig
    from nnal_tpu_torch.data.io import synthetic_subject
    from nnal_tpu_torch.engine.multi_experiment import MultiImgExperiment

    pars = dict(PARS)
    pars.update(pars_over or {})
    timings = {}
    for method in methods:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as root:
            expr = MultiImgExperiment(
                root, ExperimentConfig.from_pars(pars), device=device)
            subs = [synthetic_subject(shape=SHAPE,
                                      n_modalities=n_modalities,
                                      n_blobs=10, seed=si)
                    for si in range(n_subjects)]
            test = [synthetic_subject(shape=SHAPE,
                                      n_modalities=n_modalities,
                                      n_blobs=10, seed=9)]
            expr.attach_subjects(subs, test_subjects=test)
            expr.prep_data()
            j = expr.add_method(method)
            _, pg = j.membership()
            j.init_membership(pg[:8], pg[8:])
            expr.run_method(method, int(pars.get("k", 1)))
        timings[method] = round(time.perf_counter() - t0, 1)
        if verbose:
            print(f"primed {method}: {timings[method]} s", flush=True)
    return timings


def main(argv=None) -> int:
    from nnal_tpu_torch.core.config import set_parameters

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--methods", default="entropy,fi,influence",
                    help="comma-separated query methods to run once")
    ap.add_argument("--n-subjects", type=int, default=3,
                    help="training subjects of the micro-campaign")
    ap.add_argument("--pars", default="",
                    help="campaign-par overrides, key=val,key=val")
    ap.add_argument("--modalities", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    print("prime_cache builds: " + json.dumps(prime_builds()), flush=True)
    over = set_parameters(dict(PARS), args.pars)
    prime([m for m in args.methods.split(",") if m], pars_over=over,
          n_modalities=args.modalities, n_subjects=args.n_subjects,
          device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
