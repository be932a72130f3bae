"""Volume IO and synthetic subjects (counterpart of ``nnal_tpu/data/io.py``).

``read_volume`` dispatches on the file extension (``.npy``/``.npz`` here;
the JAX package's NRRD/NIfTI readers are not ported yet).
``synthetic_subject`` is an exact copy: the same seed gives the same
float64 volumes and mask as the JAX package.  ``write_nrrd`` is a copy of
the JAX package's writer (``data/formats.py:161-199``), which
``evaluation/analysis.get_full_segs`` saves segmentations with.
"""

from __future__ import annotations

import gzip
import os
from typing import Callable, Dict, Optional

import numpy as np

_READERS: Dict[str, Callable[[str], np.ndarray]] = {
    ".npy": lambda p: np.load(p),
    ".npz": lambda p: np.load(p)["vol"],
}


def read_volume(path: str) -> np.ndarray:
    for ext in sorted(_READERS, key=len, reverse=True):
        if path.endswith(ext):
            return _READERS[ext](path)
    raise ValueError(f"no reader registered for {path!r} "
                     f"(available: {sorted(_READERS)})")


def synthetic_subject(shape=(48, 48, 16), n_modalities: int = 2,
                      n_blobs: int = 3, seed: int = 0, nan_margin: int = 0):
    """Random smooth multi-modal volumes with blob masks.

    The mask is 1 inside a union of random ellipsoids, 0 outside, and NaN in
    an optional margin (the reference's masks carry NaN for to-be-ignored
    voxels, PW_AL.py:967-970).  Modalities are correlated noisy views whose
    intensity is elevated inside the mask, so uncertainty concentrates on
    blob boundaries — giving AL strategies real signal in tests.
    """
    rng = np.random.default_rng(seed)
    s = np.array(shape)
    zz = np.stack(np.meshgrid(*[np.arange(d) for d in shape], indexing="ij"),
                  axis=-1).astype(np.float64)
    mask = np.zeros(shape, dtype=np.float64)
    for _ in range(n_blobs):
        center = rng.uniform(0.2, 0.8, size=3) * s
        radii = rng.uniform(0.08, 0.22, size=3) * s
        dist = (((zz - center) / radii) ** 2).sum(-1)
        mask[dist < 1.0] = 1.0
    vols = []
    for m in range(n_modalities):
        base = 40.0 + 15.0 * m
        img = base + 60.0 * mask + rng.normal(0, 8.0, size=shape)
        # smooth structured background
        gx = np.sin(zz[..., 0] / (3.0 + m)) * np.cos(zz[..., 1] / (4.0 + m))
        img += 10.0 * gx
        vols.append(img)
    if nan_margin > 0:
        mask[:nan_margin] = np.nan
        mask[-nan_margin:] = np.nan
    return vols, mask


# canonical NRRD type name per numpy kind+size (``formats.py:59-64``)
_NRRD_TYPE_NAMES = {
    "i1": "int8", "u1": "uint8", "i2": "int16", "u2": "uint16",
    "i4": "int32", "u4": "uint32", "i8": "int64", "u8": "uint64",
    "f4": "float", "f8": "double",
}


def write_nrrd(path: str, data: np.ndarray, encoding: str = "gzip",
               keyvals: Optional[Dict[str, str]] = None) -> None:
    """Write ``data`` as an attached-data NRRD (pynrrd-readable): Fortran
    index order on disk, little endian, as the JAX package writes it."""
    data = np.asarray(data)
    code = data.dtype.kind + str(data.dtype.itemsize)
    code = {"b1": "u1"}.get(code, code)
    if code not in _NRRD_TYPE_NAMES:
        raise ValueError(f"unsupported dtype {data.dtype} for NRRD")
    le = np.dtype("<" + code)
    payload = np.ascontiguousarray(data.T).astype(le, copy=False).tobytes()
    enc = encoding.lower()
    if enc in ("gzip", "gz"):
        payload = gzip.compress(payload, compresslevel=1)
    elif enc != "raw":
        raise ValueError(f"unsupported write encoding {encoding!r}")
    lines = [
        "NRRD0004",
        "# written by nnal_tpu.data.formats",
        f"type: {_NRRD_TYPE_NAMES[code]}",
        f"dimension: {data.ndim}",
        f"sizes: {' '.join(str(s) for s in data.shape)}",
        f"encoding: {'gzip' if enc in ('gzip', 'gz') else 'raw'}",
    ]
    if data.dtype.itemsize > 1:
        lines.append("endian: little")
    for k, v in (keyvals or {}).items():
        lines.append(f"{k}:={v}")
    header = "\n".join(lines) + "\n\n"
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(payload)
    os.replace(tmp, path)
