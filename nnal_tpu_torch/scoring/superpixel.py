"""Superpixel-level querying (counterpart of
``nnal_tpu/scoring/superpixel.py``).

The reference's superpixel path (``SuPix_query`` + ``superpix_scoring``,
PW_NNAL.py:883-1021) is broken there; the JAX package reconstructs it
from its intent: SLIC-oversegment each axial slice, score each
superpixel by the minimum pixel uncertainty inside it, query whole
superpixels.  SLIC is implemented directly (k-means in (intensity, y, x)
with compactness weighting): a numpy oracle here and a native C++ loop
(``runtime/slic.cc``) with the same seeds and update order.  All of it is
host numpy; the posteriors it ranks come from the evaluator's device.
"""

from __future__ import annotations

import warnings
from typing import List, Tuple

import numpy as np

from nnal_tpu_torch.data.indexing import expand_raveled_inds
from nnal_tpu_torch.runtime import slic_native


def slic_2d(img: np.ndarray, n_segments: int = 100,
            compactness: float = 10.0, n_iter: int = 10,
            backend: str = "auto") -> np.ndarray:
    """SLIC superpixels for one 2D slice.  Returns an int label map.

    Seeds on a regular grid, assignment within a 2S x 2S window by
    ``d = d_intensity + (compactness / S) * d_xy`` (strict ``<``, centers
    in index order), then the centroid update.

    ``backend``: ``"native"`` runs ``runtime/slic.cc`` and raises when the
    library cannot be built; ``"numpy"`` runs the oracle below; ``"auto"``
    (the JAX package's default) runs native when it builds, else warns
    once (the warnings filter's default) and runs numpy.
    """
    if backend not in ("auto", "native", "numpy"):
        raise ValueError(f"unknown SLIC backend {backend!r}")
    if backend == "native":
        return slic_native.slic_2d_native(img, n_segments, compactness,
                                          n_iter)
    if backend == "auto":
        try:
            return slic_native.slic_2d_native(img, n_segments, compactness,
                                              n_iter)
        except RuntimeError as e:
            warnings.warn(f"SLIC falls back to numpy: {e}")
    img = np.asarray(img, dtype=np.float64)
    H, W = img.shape
    S, centers = slic_native.grid_seeds(img, n_segments)
    n = len(centers)
    yy, xx = np.mgrid[0:H, 0:W]
    labels = np.zeros((H, W), dtype=np.int32)
    dists = np.full((H, W), np.inf)
    ratio = compactness / S

    for _ in range(n_iter):
        dists[:] = np.inf
        for ci in range(n):
            c_l, c_y, c_x = centers[ci]
            y0, y1 = int(max(c_y - S, 0)), int(min(c_y + S + 1, H))
            x0, x1 = int(max(c_x - S, 0)), int(min(c_x + S + 1, W))
            patch = img[y0:y1, x0:x1]
            dy = yy[y0:y1, x0:x1] - c_y
            dx = xx[y0:y1, x0:x1] - c_x
            d = np.abs(patch - c_l) + ratio * np.sqrt(dy * dy + dx * dx)
            win = dists[y0:y1, x0:x1]
            better = d < win
            win[better] = d[better]
            labels[y0:y1, x0:x1][better] = ci
        for ci in range(n):
            sel = labels == ci
            if sel.any():
                centers[ci] = [img[sel].mean(), yy[sel].mean(),
                               xx[sel].mean()]
    return labels


def oversegment_volume(vol: np.ndarray, n_segments: int = 100,
                       compactness: float = 10.0,
                       backend: str = "auto") -> np.ndarray:
    """Per-axial-slice SLIC labels, stacked to (H, W, D)."""
    vol = np.asarray(vol)
    return np.stack([slic_2d(vol[:, :, z], n_segments, compactness,
                             backend=backend)
                     for z in range(vol.shape[2])], axis=2)


def superpix_scores(overseg: np.ndarray, inds: np.ndarray,
                    scores: np.ndarray) -> np.ndarray:
    """Pixel scores extended to superpixels: a (D, max_label+1) matrix
    whose entry (z, j) is the MIN score among scored pixels of superpixel
    j in slice z; inf where no scored pixel fell (reference
    ``superpix_scoring``, PW_NNAL.py:944-1021)."""
    s = overseg.shape
    x, y, z = np.unravel_index(np.asarray(inds, np.int64), s)
    labels = overseg[x, y, z]
    out = np.full((s[2], int(overseg.max()) + 1), np.inf)
    np.minimum.at(out, (z, labels), np.asarray(scores))
    return out


def supix_query(overseg: np.ndarray, pool_inds: np.ndarray,
                uncertainty: np.ndarray, k: int
                ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """The k most uncertain superpixels and their member voxels
    (reference ``SuPix_query`` + ``get_SuPix_inds``).

    ``uncertainty``: per pool voxel, LOWER = more uncertain (|p - 0.5|).
    Returns (qSuPix (2, k) [slice; label], member voxel-index arrays)."""
    sp = superpix_scores(overseg, pool_inds, uncertainty)
    sp[np.isinf(sp)] = np.nan
    flat_order = np.argsort(np.ravel(sp))  # NaNs sort last
    picked = []
    for f in flat_order:
        z, lab = np.unravel_index(f, sp.shape)
        if np.isnan(sp[z, lab]):
            break
        picked.append((z, lab))
        if len(picked) == k:
            break
    q = (np.array(picked, dtype=np.int64).T if picked
         else np.zeros((2, 0), np.int64))
    members = [expand_raveled_inds(
        np.flatnonzero(overseg[:, :, z].ravel() == lab), z, 2,
        overseg.shape) for z, lab in picked]
    return q, members
