"""3D patch extraction (counterpart of ``nnal_tpu/data/patches.py``).

Index semantics are the JAX package's: ``inds`` are raveled C-order indices
on the **original** (unpadded) shape; the pad margin equals the patch
radius, so the window start in the padded volume is the unraveled
coordinate (clamped for even patch dims).  Patches are laid out
``(b, d1, d2, m*d3)``, modalities major over depth.

``gather_patches_normalized`` is kernel K2 (``ops/gather.py``) on a CUDA
volume and its plain version on a CPU one.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from nnal_tpu_torch.core.device import resolve_device
from nnal_tpu_torch.ops.gather import gather_patches_normalized  # noqa: F401


def patch_radii(patch_shape: Sequence[int]) -> Tuple[int, int, int]:
    return tuple(int((s - 1) // 2) for s in patch_shape)


def pad_volumes(vols, patch_shape, device=None) -> torch.Tensor:
    """Stack per-modality volumes into a float32 ``(m, D1+2r1, D2+2r2,
    D3+2r3)`` tensor on ``device`` (``None``: the card), zero-padded by the
    patch radii.  The cast to float32 is what the JAX package's
    ``jnp.stack`` does to float64 volumes with x64 off."""
    device = resolve_device(device)
    r1, r2, r3 = patch_radii(patch_shape)
    vols = torch.from_numpy(np.stack([np.asarray(v) for v in vols]))
    vols = vols.to(device=device, dtype=torch.float32)
    return torch.nn.functional.pad(vols, (r3, r3, r2, r2, r1, r1))


def gather_labels(mask, inds, orig_shape) -> np.ndarray:
    """Labels at voxel ``inds`` from the (unpadded) host mask
    (reference: ``mask[multinds]``, patch_utils.py:1171)."""
    return np.asarray(mask).reshape(-1)[np.asarray(inds, np.int64)]
