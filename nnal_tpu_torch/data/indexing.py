"""Index algebra for voxel pools (a copy of ``nnal_tpu/data/indexing.py``).

Semantics match the reference exactly (they define what a "query index"
means on disk):

* voxel indices are **raveled C-order indices on the original (unpadded)
  volume shape** (reference patch_utils.py:1144-1152);
* multi-subject pools use a global index that concatenates per-subject index
  sets in order (reference patch_utils.py:829, datasets/utils.py:224).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def global2local_inds(batch_inds, set_sizes: Sequence[int]) -> List[np.ndarray]:
    """Split global indices over concatenated sets into per-set local indices.

    Reference: patch_utils.py:829 / datasets/utils.py:224 (identical copies).
    Given sets S_0..S_{s-1} with sizes ``set_sizes``, a global index g with
    ``cum[i] <= g < cum[i+1]`` maps to local index ``g - cum[i]`` in set i.
    """
    batch_inds = np.asarray(batch_inds, dtype=np.int64)
    cum = np.concatenate(([0], np.cumsum(set_sizes)))
    set_ids = np.searchsorted(cum, batch_inds, side="right") - 1
    return [batch_inds[set_ids == i] - cum[i] for i in range(len(set_sizes))]


def local2global_inds(local_inds: Sequence, set_sizes: Sequence[int]) -> np.ndarray:
    """Inverse of :func:`global2local_inds` (concatenation order preserved)."""
    cum = np.concatenate(([0], np.cumsum(set_sizes)))
    out = [np.asarray(li, dtype=np.int64) + cum[i] for i, li in enumerate(local_inds)]
    return np.concatenate(out) if out else np.zeros(0, dtype=np.int64)


def expand_raveled_inds(inds_2d, slice_ids, axis: int, shape3d) -> np.ndarray:
    """Expand raveled 2D-slice indices into raveled 3D-volume indices.

    Reference: patch_utils.py:936.  ``inds_2d`` are raveled on the 2D slice
    obtained by dropping ``axis`` from ``shape3d``; ``slice_ids`` selects the
    position along ``axis`` (scalar or per-index array).
    """
    inds_2d = np.asarray(inds_2d, dtype=np.int64)
    shape3d = tuple(shape3d)
    shape2d = tuple(s for i, s in enumerate(shape3d) if i != axis)
    multi2d = np.unravel_index(inds_2d, shape2d)
    slice_ids = np.broadcast_to(np.asarray(slice_ids, dtype=np.int64), inds_2d.shape)
    coords = list(multi2d)
    coords.insert(axis, slice_ids)
    return np.ravel_multi_index(tuple(coords), shape3d)


def ravel_binary_mask(mask) -> np.ndarray:
    """Raveled indices of nonzero voxels (reference patch_utils.py:347)."""
    mask = np.asarray(mask)
    return np.flatnonzero(mask > 0).astype(np.int64)


def locate_in_sets(inds, sets: Sequence) -> List[np.ndarray]:
    """For each set, positions of its members appearing in ``inds``
    (reference `locate_in_dict`, patch_utils.py:868)."""
    inds = np.asarray(inds)
    return [np.flatnonzero(np.isin(np.asarray(s), inds)) for s in sets]
