"""ctypes binding of the native host gather (``runtime/patch_gather.cc``,
the port's own copy of the JAX package's source), for volumes kept in
host RAM (``data/loaders.py``).

The library is built with ``g++`` on first use (``runtime/gxx``); a
failed build raises ``RuntimeError`` with the compiler's message and is
not retried.  The JAX package falls back to numpy instead.  The gather
normalizes as ``(x - mu) * (1 / sd)`` in f32, the JAX package's host
rule, which can sit one ulp from the card's ``(x - mu) / sd``.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional

import numpy as np

from nnal_tpu_torch.runtime.gxx import build_library

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "patch_gather.cc")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-ffp-contract=off")

_f32p = ctypes.POINTER(ctypes.c_float)
_i64p = ctypes.POINTER(ctypes.c_int64)
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failure: Optional[str] = None     # a failed build is not retried


def load() -> ctypes.CDLL:
    """Build (if needed) and bind the library."""
    global _lib, _failure
    with _lock:
        if _lib is not None:
            return _lib
        if _failure is not None:
            raise RuntimeError(_failure)
        try:
            lib = ctypes.CDLL(build_library(SRC, GXX_FLAGS, "patch_gather"))
        except RuntimeError as e:
            _failure = str(e)
            raise
        lib.gather_patches_f32.restype = None
        lib.gather_labels_f32.restype = None
        _lib = lib
        return lib


def gather_patches_native(padded_vols: List[np.ndarray], inds, patch_shape,
                          orig_shape, mu, sd) -> np.ndarray:
    """``(b, d1, d2, m*d3)`` normalized patches around raveled voxel
    ``inds`` (on ``orig_shape``) of the ``m`` padded host volumes — the
    contract of ``data.patches.gather_patches_normalized``."""
    lib = load()
    d1, d2, d3 = (int(v) for v in patch_shape)
    m = len(padded_vols)
    vols = [np.ascontiguousarray(v, dtype=np.float32) for v in padded_vols]
    if any(v.shape != vols[0].shape or v.ndim != 3 for v in vols):
        raise ValueError("padded_vols must be 3-D volumes of one shape")
    inds = np.ascontiguousarray(inds, dtype=np.int64)
    out = np.empty((len(inds), d1, d2, m * d3), dtype=np.float32)
    ptrs = (_f32p * m)(*[v.ctypes.data_as(_f32p) for v in vols])
    mu = np.ascontiguousarray(mu, dtype=np.float32)
    sd = np.ascontiguousarray(sd, dtype=np.float32)
    i64 = ctypes.c_int64
    lib.gather_patches_f32(
        ptrs, i64(m), *(i64(s) for s in vols[0].shape),
        *(i64(int(s)) for s in orig_shape), inds.ctypes.data_as(_i64p),
        i64(len(inds)), i64(d1), i64(d2), i64(d3), mu.ctypes.data_as(_f32p),
        sd.ctypes.data_as(_f32p), out.ctypes.data_as(_f32p))
    return out


def gather_labels_native(mask: np.ndarray, inds) -> np.ndarray:
    """``mask`` (3-D, unpadded) at raveled ``inds``, as float32."""
    lib = load()
    mask = np.ascontiguousarray(mask, dtype=np.float32)
    inds = np.ascontiguousarray(inds, dtype=np.int64)
    out = np.empty(len(inds), dtype=np.float32)
    lib.gather_labels_f32(
        mask.ctypes.data_as(_f32p), ctypes.c_int64(mask.shape[1]),
        ctypes.c_int64(mask.shape[2]), inds.ctypes.data_as(_i64p),
        ctypes.c_int64(len(inds)), out.ctypes.data_as(_f32p))
    return out
