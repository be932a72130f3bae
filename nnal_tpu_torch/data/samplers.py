"""Pool samplers (counterpart of ``nnal_tpu/data/samplers.py``).

The grid sampler and the pool/test split the patch-wise engine uses
(numpy), and the local-variance map behind ``ps-random``: the
``Var[x] = E[x^2] - E[x]^2`` box-filter trick of the reference
(patch_utils.py:794), as two batched convolutions over every axial slice
on the given device.  The samplers no engine path calls
(``sample_masked_volume``, ``partition_2d_indices``) are not ported.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nnal_tpu_torch.core.device import resolve_device


def generate_grid_samples(shape3d, grid_spacing: int, mask=None):
    """Raveled 3D grid indices: all voxels whose in-plane coordinates are
    multiples of ``grid_spacing``, swept over every axial slice (reference
    ``gen_multimg_inds``, PW_AL.py:921-976).

    If ``mask`` is given, voxels whose mask value is NaN are discarded and
    the corresponding labels are returned (reference drops NaN voxels).
    """
    s = tuple(shape3d)
    gx = np.arange(0, s[0], grid_spacing)
    gy = np.arange(0, s[1], grid_spacing)
    X, Y = np.meshgrid(gx, gy, indexing="ij")
    X, Y = X.ravel(), Y.ravel()
    inds = []
    labels = []
    for z in range(s[2]):
        Z = np.full_like(X, z)
        inds.append(np.ravel_multi_index((X, Y, Z), s))
        if mask is not None:
            labels.append(np.asarray(mask)[X, Y, Z])
    inds = np.concatenate(inds)
    if mask is None:
        return inds
    labels = np.concatenate(labels)
    keep = ~np.isnan(labels)
    return inds[keep], labels[keep].astype(np.int64)


def even_odd_slice_split(inds, shape3d) -> Tuple[np.ndarray, np.ndarray]:
    """Pool/test split by axial-slice parity: even slices -> pool, full grid
    -> test (reference ``prep_AL_data``, PW_AL.py:1004-1013, which keeps the
    whole grid as the test set)."""
    inds = np.asarray(inds, dtype=np.int64)
    z = np.unravel_index(inds, tuple(shape3d))[2]
    return inds[z % 2 == 0], inds


def local_variance_map(vol: torch.Tensor, d: int) -> torch.Tensor:
    """Per-voxel variance of the d x d in-plane window around each voxel,
    for every axial slice of ``vol`` (``(D1, D2, D3)``), on ``vol``'s
    device (reference ``get_vars_2d``, patch_utils.py:794).

    As in the JAX package (``samplers.py:51-80``): intensities are floored
    (the reference's uint cast), each slice is mean-centered in f32 before
    filtering, and the box filter is 'SAME' with zero padding, which for
    an even ``d`` puts ``(d - 1) // 2`` rows and columns before and
    ``d // 2`` after."""
    x = torch.floor(vol.to(torch.float32))
    x = x - x.mean(dim=(0, 1), keepdim=True)
    imgs = x.permute(2, 0, 1).unsqueeze(1)                  # (D3, 1, D1, D2)
    lo, hi = (d - 1) // 2, d // 2
    ones = torch.ones((1, 1, d, d), dtype=torch.float32, device=vol.device)

    def box(v):
        return F.conv2d(F.pad(v, (lo, hi, lo, hi)), ones) / float(d * d)

    ex = box(imgs)
    ex2 = box(imgs ** 2)
    return (ex2 - ex ** 2)[:, 0].permute(1, 2, 0)


def high_variance_filter(vol, patch_shape, thr: float, pool_inds,
                         device=None) -> np.ndarray:
    """Positions (into ``pool_inds``) whose local variance exceeds ``thr``
    (reference ``get_HV_inds``, PW_NNAL.py:630-666; used by ``ps-random``).
    ``vol`` is the unpadded first-modality volume; the window is the first
    patch radius, as in the reference.  Runs on ``device`` (``None``: the
    card)."""
    d = int((patch_shape[0] - 1) // 2)
    v = torch.as_tensor(np.asarray(vol)).to(resolve_device(device))
    var = local_variance_map(v, d).reshape(-1)
    inds = torch.as_tensor(np.asarray(pool_inds, np.int64)).to(v.device)
    return torch.nonzero(var[inds] > thr).reshape(-1).cpu().numpy()
