"""3D patch extraction (counterpart of ``nnal_tpu/data/patches.py``).

Index semantics are the JAX package's: ``inds`` are raveled C-order indices
on the **original** (unpadded) shape; the pad margin equals the patch
radius, so the window start in the padded volume is the unraveled
coordinate (clamped for even patch dims).  Patches are laid out
``(b, d1, d2, m*d3)``, modalities major over depth.

``gather_patches_normalized`` is kernel K2 (``ops/gather.py``) on a CUDA
volume and its plain version on a CPU one; so are :func:`gather_patches`
(the unnormalized gather: K2 with mean 0 and deviation 1, for which
``(x - 0) / 1`` is ``x`` bit for bit) and :func:`gather_patches_multimg`
(each subject's patches with its own statistics).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

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


def gather_patches(padded: torch.Tensor, inds: torch.Tensor, patch_shape,
                   orig_shape) -> torch.Tensor:
    """``(b, d1, d2, m*d3)`` raw patches around raveled voxel ``inds`` of
    the padded ``(m, D1p, D2p, D3p)`` volume (``patches.py:42-61``)."""
    m = padded.shape[0]
    zeros = torch.zeros(m, dtype=torch.float32, device=padded.device)
    return gather_patches_normalized(padded, inds, zeros,
                                     torch.ones_like(zeros), patch_shape,
                                     orig_shape)


def gather_patches_multimg(all_padded, img_inds, patch_shape, stats,
                           masks=None) -> Tuple[List, List]:
    """The multi-subject gather (``patches.py:160-188``): for subject ``j``
    with non-empty ``img_inds[j]``, its patches from ``all_padded[j]`` (a
    padded volume tensor) normalized by its ``stats[j] = [mu_0, sd_0,
    mu_1, sd_1, ...]`` (rounded to f32, as JAX casts them), and with
    ``masks`` its labels.  Returns ``(b_patches, b_labels)`` lists indexed
    by subject, ``[]`` for an empty one."""
    stats = np.asarray(stats)
    b_patches: List = [[] for _ in img_inds]
    b_labels: List = [[] for _ in img_inds]
    r = patch_radii(patch_shape)
    for j, inds in enumerate(img_inds):
        inds = np.asarray(inds, dtype=np.int64)
        if inds.size == 0:
            continue
        padded = all_padded[j]
        dev, m = padded.device, padded.shape[0]
        orig_shape = tuple(int(padded.shape[1 + i] - 2 * r[i])
                           for i in range(3))

        def stat(col):
            return torch.as_tensor(np.asarray(stats[j, col::2][:m],
                                              np.float32), device=dev)

        b_patches[j] = gather_patches_normalized(
            padded, torch.as_tensor(inds, device=dev), stat(0), stat(1),
            tuple(patch_shape), orig_shape)
        if masks is not None:
            b_labels[j] = gather_labels(masks[j], inds, orig_shape)
    return b_patches, b_labels
