"""Pool samplers (numpy; counterpart of ``nnal_tpu/data/samplers.py``).

Only the grid sampler and the pool/test split the patch-wise engine uses
are ported; the variance-map samplers come with ``ps-random``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


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
