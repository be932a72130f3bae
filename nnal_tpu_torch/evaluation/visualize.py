"""Result visualization (a copy of ``nnal_tpu/evaluation/visualize.py``:
numpy and matplotlib only, no framework).

Rebuild of the reference's plotting (AL.py:626-753 ``visualize_run`` /
``summarize_all``; PW_analyze_results.py:136-233,339-388): accuracy/
F-measure vs #queries curves per method, mean +/- std bands across runs,
interpolated comparison curves, and query-overlay slices.  matplotlib is
imported lazily, by the plotting functions alone, on the Agg backend
(``_plt``): the numpy helpers (``interpolate_curves``,
``mean_std_over_runs``, ``interp_slice_posteriors``,
``overlay_superpixels``, ``generate_rgb_mask``) run without it.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_learning_curves(curves: Dict[str, np.ndarray], k_per_round: int,
                         save_path: str, ylabel: str = "F-measure",
                         stds: Optional[Dict[str, np.ndarray]] = None):
    """Metric-vs-#queries curves, one line per method (reference
    ``visualize_run``)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    for name, ys in curves.items():
        ys = np.asarray(ys)
        xs = np.arange(1, len(ys) + 1) * k_per_round
        ax.plot(xs, ys, marker="o", label=name)
        if stds and name in stds:
            sd = np.asarray(stds[name])
            ax.fill_between(xs, ys - sd, ys + sd, alpha=0.2)
    ax.set_xlabel("# queried samples")
    ax.set_ylabel(ylabel)
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)


def interpolate_curves(curves: Sequence[np.ndarray],
                       xs_list: Sequence[np.ndarray],
                       n_points: int = 50):
    """Align curves measured at different query counts onto a common grid
    (reference FI-curve interpolation, AL.py:650-678) via np.interp."""
    lo = max(float(np.min(x)) for x in xs_list)
    hi = min(float(np.max(x)) for x in xs_list)
    grid = np.linspace(lo, hi, n_points)
    interped = [np.interp(grid, xs, ys)
                for xs, ys in zip(xs_list, curves)]
    return grid, np.stack(interped)


def mean_std_over_runs(run_curves: Sequence[np.ndarray]):
    """Mean +/- std across runs, truncated to the shortest run (reference
    ``summarize_all``, AL.py:679-753)."""
    L = min(len(c) for c in run_curves)
    arr = np.stack([np.asarray(c)[:L] for c in run_curves])
    return arr.mean(axis=0), arr.std(axis=0)


def interp_slice_posteriors(x: np.ndarray, y: np.ndarray,
                            vals: np.ndarray, slice_shape) -> np.ndarray:
    """Dense posterior map for a slice from grid-sampled values (reference
    ``get_interp_slice_posts``, PW_analyze_results.py:866-884 — there a
    scipy ``interp2d`` evaluated per pixel; ``interp2d`` is removed from
    modern scipy and the AL samples ARE a regular grid, so this is exact
    vectorized bilinear interpolation on the sample grid, clamped to the
    nearest sample outside its hull).  ``x``/``y`` are the sampled row/col
    coordinates, ``vals`` their values; falls back to inverse-distance
    weighting when the samples don't form a complete grid."""
    x = np.asarray(x, np.int64)
    y = np.asarray(y, np.int64)
    vals = np.asarray(vals, np.float64)
    ux, uy = np.unique(x), np.unique(y)
    out_x = np.arange(slice_shape[0], dtype=np.float64)
    out_y = np.arange(slice_shape[1], dtype=np.float64)
    if len(ux) * len(uy) == len(vals):
        grid = np.full((len(ux), len(uy)), np.nan)
        grid[np.searchsorted(ux, x), np.searchsorted(uy, y)] = vals
        if not np.any(np.isnan(grid)):
            # exact bilinear on the sample grid
            def axis_weights(coords, knots):
                i1 = np.clip(np.searchsorted(knots, coords), 1,
                             len(knots) - 1) if len(knots) > 1 else \
                    np.zeros(len(coords), np.int64)
                i0 = i1 - 1 if len(knots) > 1 else i1
                span = (knots[i1] - knots[i0]) if len(knots) > 1 else 1
                w = np.clip((coords - knots[i0])
                            / np.where(span == 0, 1, span), 0.0, 1.0)
                return i0, i1, w

            xi0, xi1, wx = axis_weights(out_x, ux.astype(np.float64))
            yi0, yi1, wy = axis_weights(out_y, uy.astype(np.float64))
            wx = wx[:, None]
            wy = wy[None, :]
            return ((1 - wx) * (1 - wy) * grid[np.ix_(xi0, yi0)]
                    + (1 - wx) * wy * grid[np.ix_(xi0, yi1)]
                    + wx * (1 - wy) * grid[np.ix_(xi1, yi0)]
                    + wx * wy * grid[np.ix_(xi1, yi1)])
    # scattered samples: inverse-distance weighting (exact at samples)
    yy, xx = np.meshgrid(out_y, out_x)
    d2 = ((xx.ravel()[:, None] - x[None, :]) ** 2
          + (yy.ravel()[:, None] - y[None, :]) ** 2)
    hit = d2.argmin(axis=1)
    exact = d2[np.arange(len(hit)), hit] == 0
    w = 1.0 / np.maximum(d2, 1e-12)
    est = (w * vals).sum(axis=1) / w.sum(axis=1)
    est[exact] = vals[hit[exact]]
    return est.reshape(slice_shape)


def overlay_superpixels(overseg: np.ndarray, supix_codes: np.ndarray,
                        show_bound: bool = True) -> np.ndarray:
    """Boolean highlight volume for selected superpixels (reference
    ``mask_SuPix``, PW_analyze_results.py:339-388): boundaries of ALL
    superpixels on every slice (when ``show_bound``) plus the member
    pixels of the selected ones.  ``overseg`` is the per-slice label
    volume (``scoring.superpixel.oversegment_volume``); ``supix_codes``
    is the (2, n) [slice; label] matrix that ``supix_query`` returns."""
    overseg = np.asarray(overseg)
    out = np.zeros(overseg.shape, dtype=bool)
    if show_bound:
        lab = overseg
        b = np.zeros_like(out)
        b[1:, :, :] |= lab[1:, :, :] != lab[:-1, :, :]
        b[:-1, :, :] |= lab[1:, :, :] != lab[:-1, :, :]
        b[:, 1:, :] |= lab[:, 1:, :] != lab[:, :-1, :]
        b[:, :-1, :] |= lab[:, 1:, :] != lab[:, :-1, :]
        out |= b
    codes = np.asarray(supix_codes, np.int64)
    for z, lab in codes.T:
        out[:, :, z] |= overseg[:, :, z] == lab
    return out


def generate_rgb_mask(img2d: np.ndarray, mask=(), mask2=()) -> np.ndarray:
    """uint8 RGB overlay of up to two binary masks on a 1-channel slice
    (reference ``generate_rgb_mask``, patch_utils.py:1060-1086): the image
    is scaled to [0, 200], ``mask`` paints the red channel 230 and
    ``mask2`` the green channel 200.  Empty sequences skip a channel."""
    img2d = np.asarray(img2d, np.float64)
    rgb = np.repeat(img2d[:, :, None], 3, axis=2)
    rgb = np.uint8(rgb * 200.0 / max(float(rgb.max()), 1e-12))
    if len(mask) > 0:
        rgb[:, :, 0][np.asarray(mask) > 0] = 230
    if len(mask2) > 0:
        rgb[:, :, 1][np.asarray(mask2) > 0] = 200
    return rgb


def overlay_queries_on_slice(img2d: np.ndarray, query_xy: np.ndarray,
                             save_path: str, mask2d=None):
    """Show queried voxel positions on an axial slice (reference
    PW_analyze_results query-overlay figures)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.imshow(np.asarray(img2d), cmap="gray")
    if mask2d is not None:
        ax.contour(np.asarray(mask2d), levels=[0.5], colors="cyan",
                   linewidths=0.8)
    if len(query_xy):
        ax.scatter(query_xy[:, 1], query_xy[:, 0], s=12, c="red",
                   marker="x")
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
