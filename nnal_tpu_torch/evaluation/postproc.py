"""Morphological post-processing (a copy of
``nnal_tpu/evaluation/postproc.py``: scipy.ndimage and numpy only, so the
port keeps its own copy rather than importing the JAX package).

The reference's post_processing.py:8-60 and lesion component analysis
(datasets/lesion_utils.py:14-80) on scipy.ndimage: largest-connected-
component filtering, hole filling, per-component labeling/size
thresholds.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def largest_connected_component(seg: np.ndarray) -> np.ndarray:
    """Keep only the largest foreground component; the voxel at (0,0,0) is
    assumed background (reference ``connected_component_analysis_3d``)."""
    seg = np.asarray(seg)
    labels, n = ndimage.label(seg > 0)
    if n == 0:
        return np.zeros_like(seg, dtype=np.uint32)
    bkg = labels[(0,) * seg.ndim]
    sizes = ndimage.sum_labels(np.ones_like(labels), labels,
                               index=np.arange(1, n + 1))
    order = np.argsort(-sizes) + 1
    keep = next((lab for lab in order if lab != bkg), order[0])
    return (labels == keep).astype(np.uint32)


def fill_holes(seg: np.ndarray) -> np.ndarray:
    """Binary hole filling (reference ``fill_holes``)."""
    return ndimage.binary_fill_holes(np.asarray(seg) > 0).astype(np.uint32)


def lesion_components(mask: np.ndarray, min_size: int = 0):
    """Label lesion components and drop those below ``min_size`` voxels
    (reference datasets/lesion_utils.py:14-80).  Returns
    (labeled_volume, sizes)."""
    labels, n = ndimage.label(np.asarray(mask) > 0)
    sizes = ndimage.sum_labels(np.ones_like(labels), labels,
                               index=np.arange(1, n + 1))
    if min_size > 0:
        for lab in np.flatnonzero(sizes < min_size) + 1:
            labels[labels == lab] = 0
        keep = np.flatnonzero(sizes >= min_size)
        sizes = sizes[keep]
    return labels, sizes


def postprocess_segmentation(seg: np.ndarray, keep_largest: bool = True,
                             holes: bool = True) -> np.ndarray:
    out = np.asarray(seg)
    if keep_largest:
        out = largest_connected_component(out)
    if holes:
        out = fill_holes(out)
    return out
