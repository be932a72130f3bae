"""ctypes binding of the native DenseCRF (``runtime/dense_crf.cc``, the
port's own copy of the JAX package's source).

The library is built with ``g++`` on first use (``runtime/gxx``) into the
git-ignored ``nnal_tpu_torch/_build/``, with the JAX package's flags
(``-O3 -march=native``): the solver has no numpy oracle to agree with, its
reference is the JAX package's build of the same source, and the same
flags give the same code on the same host (the compiler may contract
multiply-adds under ``-march=native``, so another host may part from it
by rounding).  A failed build raises ``RuntimeError`` with the compiler's
message and is not retried; :func:`crf_native_available` says whether it
built.  The fallback policy lives in ``evaluation/crf.py``.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from nnal_tpu_torch.runtime.gxx import build_library

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "dense_crf.cc")
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_f32p = ctypes.POINTER(ctypes.c_float)
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failure: Optional[str] = None     # a failed build is not retried


def load() -> ctypes.CDLL:
    """Build (if needed) and bind the library; ``RuntimeError`` with the
    compiler's message when it cannot be built."""
    global _lib, _failure
    with _lock:
        if _lib is not None:
            return _lib
        if _failure is not None:
            raise RuntimeError(_failure)
        try:
            out = build_library(SRC, GXX_FLAGS, "dense_crf")
        except RuntimeError as e:
            _failure = str(e)
            raise
        lib = ctypes.CDLL(out)
        lib.nnal_permutohedral_filter.restype = None
        lib.nnal_permutohedral_filter.argtypes = [
            _f32p, _f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _f32p]
        lib.nnal_dcrf2d_meanfield.restype = None
        lib.nnal_dcrf2d_meanfield.argtypes = [
            _f32p, _f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_int, _f32p]
        lib.nnal_dcrf_meanfield_feats.restype = None
        lib.nnal_dcrf_meanfield_feats.argtypes = [
            _f32p, _f32p, ctypes.c_int, ctypes.c_float, _f32p,
            ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _f32p]
        _lib = lib
        return lib


def crf_native_available() -> bool:
    try:
        load()
    except RuntimeError:
        return False
    return True


def permutohedral_filter(feat: np.ndarray, values: np.ndarray) -> np.ndarray:
    """``out_i = sum_j exp(-|f_i - f_j|^2 / 2) v_j`` up to the lattice's
    constant gain; ``feat`` (N, d) pre-scaled features, ``values`` (N,
    vd)."""
    lib = load()
    feat = np.ascontiguousarray(feat, dtype=np.float32)
    values = np.ascontiguousarray(values, dtype=np.float32)
    n, d = feat.shape
    if values.shape[0] != n:
        raise ValueError(f"{values.shape[0]} values for {n} features")
    out = np.empty((n, values.shape[1]), dtype=np.float32)
    lib.nnal_permutohedral_filter(
        feat.ctypes.data_as(_f32p), values.ctypes.data_as(_f32p),
        n, d, values.shape[1], out.ctypes.data_as(_f32p))
    return out


def dcrf2d_meanfield(posteriors: np.ndarray, image: Optional[np.ndarray],
                     iters: int = 5, sxy_gauss: float = 3.0,
                     w_gauss: float = 3.0, sxy_bilat: float = 50.0,
                     srgb: float = 4.0, w_bilat: float = 10.0) -> np.ndarray:
    """Full dense-CRF mean field on a (H, W, C) posterior map
    (``crf_native.py:99-137``); ``image`` (H, W) or (H, W, ch), or None to
    drop the bilateral term.  Returns the refined (H, W, C) marginals."""
    lib = load()
    posteriors = np.asarray(posteriors, dtype=np.float32)
    H, W, C = posteriors.shape
    unary = -np.log(np.clip(posteriors, 1e-8, None))
    unary = np.ascontiguousarray(unary.reshape(H * W, C))
    if image is None:
        img_ptr, ch, w_bilat = None, 0, 0.0
    else:
        img = np.asarray(image, dtype=np.float32)
        if img.ndim == 2:
            img = img[..., None]
        ch = img.shape[-1]
        img = np.ascontiguousarray(img.reshape(H * W, ch))
        img_ptr = img.ctypes.data_as(_f32p)
    q = np.empty((H * W, C), dtype=np.float32)
    lib.nnal_dcrf2d_meanfield(
        unary.ctypes.data_as(_f32p), img_ptr, H, W, C, ch,
        sxy_gauss, w_gauss, sxy_bilat, srgb, w_bilat, int(iters),
        q.ctypes.data_as(_f32p))
    return q.reshape(H, W, C)


def dcrf_meanfield_feats(posteriors: np.ndarray, feat_g: np.ndarray,
                         w_gauss: float,
                         feat_b: Optional[np.ndarray] = None,
                         w_bilat: float = 0.0,
                         iters: int = 5) -> np.ndarray:
    """Dense-CRF mean field over pre-scaled feature spaces
    (``crf_native.py:140-167``): ``posteriors`` (N, C), ``feat_g`` /
    ``feat_b`` (N, d) already divided by their sigmas.  Returns (N, C)."""
    lib = load()
    posteriors = np.asarray(posteriors, dtype=np.float32)
    n, c = posteriors.shape
    unary = np.ascontiguousarray(-np.log(np.clip(posteriors, 1e-8, None)))
    feat_g = np.ascontiguousarray(feat_g, dtype=np.float32)
    if feat_b is None:
        fb_ptr, db, w_bilat = None, 0, 0.0
    else:
        feat_b = np.ascontiguousarray(feat_b, dtype=np.float32)
        fb_ptr, db = feat_b.ctypes.data_as(_f32p), feat_b.shape[1]
    if feat_g.shape[0] != n or (feat_b is not None and feat_b.shape[0] != n):
        raise ValueError("features and posteriors differ in length")
    q = np.empty((n, c), dtype=np.float32)
    lib.nnal_dcrf_meanfield_feats(
        unary.ctypes.data_as(_f32p), feat_g.ctypes.data_as(_f32p),
        feat_g.shape[1], w_gauss, fb_ptr, db, w_bilat, n, c, int(iters),
        q.ctypes.data_as(_f32p))
    return q


def dcrf3d_meanfield(posteriors: np.ndarray, volume: Optional[np.ndarray],
                     iters: int = 5, sxyz_gauss: float = 3.0,
                     w_gauss: float = 3.0, sxyz_bilat: float = 50.0,
                     srgb: float = 4.0, w_bilat: float = 10.0) -> np.ndarray:
    """Volumetric dense-CRF mean field over a (H, W, D, C) posterior volume
    (``crf_native.py:170-191``): 3-D Gaussian smoothness plus bilateral
    appearance on ``volume`` ((H, W, D) or (H, W, D, ch); None drops it).
    Returns the refined (H, W, D, C) marginals."""
    posteriors = np.asarray(posteriors, dtype=np.float32)
    H, W, D, C = posteriors.shape
    n = H * W * D
    yy, xx, zz = np.meshgrid(np.arange(H, dtype=np.float32),
                             np.arange(W, dtype=np.float32),
                             np.arange(D, dtype=np.float32), indexing="ij")
    pos = np.stack([yy.ravel(), xx.ravel(), zz.ravel()], axis=-1)
    feat_g = pos / sxyz_gauss
    feat_b = None
    if volume is not None and w_bilat != 0.0:
        vol = np.asarray(volume, dtype=np.float32)
        if vol.ndim == 3:
            vol = vol[..., None]
        feat_b = np.concatenate(
            [pos / sxyz_bilat, vol.reshape(n, -1) / srgb], axis=-1)
    q = dcrf_meanfield_feats(posteriors.reshape(n, C), feat_g, w_gauss,
                             feat_b, w_bilat, iters)
    return q.reshape(H, W, D, C)
