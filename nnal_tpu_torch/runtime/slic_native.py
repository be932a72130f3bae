"""ctypes binding of the native SLIC (``runtime/slic.cc``, the port's own
copy of the JAX package's source).

The library is built with ``g++`` on first use (``runtime/gxx``).
``-ffp-contract=off`` keeps the compiler
from fusing multiply-adds, which would part the distances from the numpy
oracle's on targets with FMA.  The wrapper computes the grid seeds as
the numpy path (``scoring/superpixel.slic_2d``) does, so both paths agree
on seeding by construction; the C++ loop mirrors the assignment and
update order.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from nnal_tpu_torch.runtime.gxx import build_library

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "slic.cc")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-ffp-contract=off")
STEM = "slic"

_f64p = ctypes.POINTER(ctypes.c_double)
_i32p = ctypes.POINTER(ctypes.c_int32)
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failure: Optional[str] = None     # a failed build is not retried


def load() -> ctypes.CDLL:
    """Build (if needed) and bind the library; raise ``RuntimeError`` with
    the compiler's message when it cannot be built (the first failure is
    kept and raised again, not retried)."""
    global _lib, _failure
    with _lock:
        if _lib is not None:
            return _lib
        if _failure is not None:
            raise RuntimeError(_failure)
        try:
            out = build_library(SRC, GXX_FLAGS, STEM)
        except RuntimeError as e:
            _failure = str(e)
            raise
        lib = ctypes.CDLL(out)
        lib.nnal_slic2d.restype = None
        lib.nnal_slic2d.argtypes = [
            _f64p, ctypes.c_int, ctypes.c_int, _f64p, ctypes.c_int,
            ctypes.c_int, ctypes.c_double, ctypes.c_int, _i32p]
        _lib = lib
        return lib


def slic_native_available() -> bool:
    """True when the port's build of ``slic.cc`` loads (``slic_native.py
    :54``); ``slic_2d_native`` itself still raises when it does not."""
    try:
        load()
    except RuntimeError:
        return False
    return True


def grid_seeds(img: np.ndarray, n_segments: int):
    """SLIC's grid step ``S`` and its ``(intensity, y, x)`` seeds."""
    H, W = img.shape
    S = max(int(np.sqrt(H * W / n_segments)), 1)
    ys = np.arange(S // 2, H, S)
    xs = np.arange(S // 2, W, S)
    centers = np.array([[img[y, x], y, x] for y in ys for x in xs],
                       dtype=np.float64)
    return S, centers


def slic_2d_native(img: np.ndarray, n_segments: int = 100,
                   compactness: float = 10.0,
                   n_iter: int = 10) -> np.ndarray:
    """Native SLIC with the numpy path's seeding and semantics."""
    lib = load()
    img = np.ascontiguousarray(img, dtype=np.float64)
    H, W = img.shape
    S, centers = grid_seeds(img, n_segments)
    centers = np.ascontiguousarray(centers)
    labels = np.zeros((H, W), dtype=np.int32)
    lib.nnal_slic2d(img.ctypes.data_as(_f64p), H, W,
                    centers.ctypes.data_as(_f64p), len(centers), S,
                    float(compactness), int(n_iter),
                    labels.ctypes.data_as(_i32p))
    return labels
