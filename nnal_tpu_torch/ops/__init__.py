"""Hand-written Hopper kernels (CUDA C++ in ``nnal_tpu_torch/csrc``).

The kernel modules import nothing else of the package; ``data.patches``
and ``scoring.representative`` call into them.  ``ops.scoring_fused`` (the
fused posterior + diag-FIM scorer, which holds no kernel) sits above
``scoring.gradients``, as in the JAX package; its ``pool_score_fused`` and
``make_pool_scorer`` are exported here on first access, since importing
it at package import would close a cycle through ``data.patches``.
"""

from nnal_tpu_torch.ops import gather, similarity
from nnal_tpu_torch.ops._build import build_all

KERNELS = (similarity.KERNEL, gather.KERNEL)


def __getattr__(name):
    if name in ("pool_score_fused", "make_pool_scorer"):
        from nnal_tpu_torch.ops import scoring_fused

        return getattr(scoring_fused, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def build_kernels() -> None:
    """Build (in parallel) and bind every kernel of the port."""
    build_all(list(KERNELS))
