"""Hand-written Hopper kernels (CUDA C++ in ``nnal_tpu_torch/csrc``).

This layer imports nothing else of the package; ``data.patches`` and
``scoring.representative`` call into it.
"""

from nnal_tpu_torch.ops import gather, similarity
from nnal_tpu_torch.ops._build import build_all

KERNELS = (similarity.KERNEL, gather.KERNEL)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def build_kernels() -> None:
    """Build (in parallel) and bind every kernel of the port."""
    build_all(list(KERNELS))
