"""NRRD and NIfTI-1 volume readers and writers (counterpart of
``nnal_tpu/data/formats.py``).

The reference reads its brain volumes with ``nrrd.read`` and its newborn
data with nibabel; neither library is a given in a deployment image, so
the two formats are implemented here on numpy, with zlib doing the gzip
inflate.  ``data/io.py`` registers these readers by extension.

* NRRD: magic NRRD0001-0005, attached or detached data (``data file``,
  ``line skip``, ``byte skip``), encodings ``raw`` / ``gzip`` /
  ``bzip2`` / ``ascii``, every scalar type, both endians.  The index order
  is pynrrd's default (Fortran: the first axis is fastest on disk), so an
  array is bit-identical to ``nrrd.read(path)[0]``.  The writer emits
  attached ``raw`` or ``gzip`` data, little endian.
* NIfTI-1: single-file ``.nii`` / ``.nii.gz`` images and detached
  ``.hdr`` / ``.img`` pairs, the standard dtype codes, either endianness,
  and ``scl_slope`` / ``scl_inter`` applied exactly as
  ``np.asanyarray(nib.load(p).dataobj)`` does.  The writer emits a
  ``.nii`` / ``.nii.gz`` file, or a ``.hdr`` header (magic ``ni1``) with
  its voxels in the ``.img`` beside it.

Each writer emits the JAX package's layout (raw NRRD and ``.nii`` byte
for byte; the gzip streams differ only in their header's time stamp), so
either package reads the other's files.  A header that is not NRRD or
NIfTI-1, a malformed header line, an unknown type or encoding and a
truncated payload raise ``ValueError``.
"""

from __future__ import annotations

import bz2
import gzip
import os
import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

# --------------------------------------------------------------------------- #
# NRRD
# --------------------------------------------------------------------------- #
# the NRRD spec's type names -> numpy dtype code (without byte order)
_NRRD_TYPES: Dict[str, str] = {}
for _names, _dt in [
    (("signed char", "int8", "int8_t"), "i1"),
    (("uchar", "unsigned char", "uint8", "uint8_t"), "u1"),
    (("short", "short int", "signed short", "signed short int", "int16",
      "int16_t"), "i2"),
    (("ushort", "unsigned short", "unsigned short int", "uint16",
      "uint16_t"), "u2"),
    (("int", "signed int", "int32", "int32_t"), "i4"),
    (("uint", "unsigned int", "uint32", "uint32_t"), "u4"),
    (("longlong", "long long", "long long int", "signed long long",
      "signed long long int", "int64", "int64_t"), "i8"),
    (("ulonglong", "unsigned long long", "unsigned long long int",
      "uint64", "uint64_t"), "u8"),
    (("float",), "f4"),
    (("double",), "f8"),
]:
    for _n in _names:
        _NRRD_TYPES[_n] = _dt

# the type name written for each numpy kind + size
_NRRD_TYPE_NAMES = {
    "i1": "int8", "u1": "uint8", "i2": "int16", "u2": "uint16",
    "i4": "int32", "u4": "uint32", "i8": "int64", "u8": "uint64",
    "f4": "float", "f8": "double",
}


def _parse_nrrd_header(f) -> Tuple[Dict[str, str], Dict[str, str]]:
    """``(fields, key/value pairs)`` of the header ``f`` is positioned at;
    ``f`` is left at the first byte after the blank line."""
    magic = f.readline().decode("ascii", "replace").rstrip("\r\n")
    if not magic.startswith("NRRD000"):
        raise ValueError(f"not a NRRD file (magic {magic!r})")
    fields: Dict[str, str] = {}
    keyvals: Dict[str, str] = {}
    while True:
        line = f.readline()
        if line in (b"", b"\n", b"\r\n"):  # a blank line ends the header
            break
        text = line.decode("ascii", "replace").rstrip("\r\n")
        if text.startswith("#"):
            continue
        if ":=" in text:
            k, v = text.split(":=", 1)
            keyvals[k.strip()] = v.strip()
        elif ": " in text or text.endswith(":"):
            k, v = text.split(":", 1)
            fields[k.strip().lower()] = v.strip()
        else:
            raise ValueError(f"malformed NRRD header line {text!r}")
    return fields, keyvals


def _nrrd_dtype(fields: Dict[str, str]) -> np.dtype:
    tname = fields.get("type", "").strip().lower()
    if tname not in _NRRD_TYPES:
        raise ValueError(f"unsupported NRRD type {tname!r}")
    code = _NRRD_TYPES[tname]
    if code.endswith("1"):
        return np.dtype(code)
    endian = fields.get("endian", "little").strip().lower()
    return np.dtype(("<" if endian == "little" else ">") + code)


def _detached_payload(path: str, fields: Dict[str, str]) -> bytes:
    """The bytes of a detached data file after its line and byte skips."""
    datafile = fields.get("data file") or fields.get("datafile")
    dpath = os.path.join(os.path.dirname(path), datafile)
    with open(dpath, "rb") as df:
        payload = df.read()
    lskip = int(fields.get("line skip", fields.get("lineskip", 0)))
    for i in range(lskip):
        nl = payload.find(b"\n")
        if nl < 0:
            raise ValueError(f"{dpath}: line skip {lskip} exceeds the "
                             f"{i} newline(s) present")
        payload = payload[nl + 1:]
    bskip = int(fields.get("byte skip", fields.get("byteskip", 0)))
    return payload[bskip:] if bskip > 0 else payload


def read_nrrd(path: str):
    """Read a NRRD file: ``(array, header)``, as ``nrrd.read(path)``.

    The array's shape is the header's ``sizes``, the first axis fastest on
    disk; the header holds the fields (lower-cased keys) and the
    ``key:=value`` pairs.
    """
    with open(path, "rb") as f:
        fields, keyvals = _parse_nrrd_header(f)
        if "sizes" not in fields:
            raise ValueError(f"{path}: NRRD header has no sizes")
        sizes = [int(s) for s in fields["sizes"].split()]
        dim = int(fields.get("dimension", len(sizes)))
        if len(sizes) != dim:
            raise ValueError(
                f"sizes {sizes} inconsistent with dimension {dim}")
        dtype = _nrrd_dtype(fields)
        enc = fields.get("encoding", "raw").strip().lower()
        detached = bool(fields.get("data file") or fields.get("datafile"))
        payload = (_detached_payload(path, fields) if detached
                   else f.read())
    bskip = (int(fields.get("byte skip", fields.get("byteskip", 0)))
             if detached else 0)
    n = int(np.prod(sizes)) if sizes else 0
    if enc == "raw":
        if bskip == -1:
            # byte skip -1 (raw only, per the spec): the data is the tail
            payload = payload[len(payload) - n * dtype.itemsize:]
        buf = payload[: n * dtype.itemsize]
        if len(buf) < n * dtype.itemsize:
            raise ValueError(f"{path}: raw payload has {len(buf)} bytes, "
                             f"need {n * dtype.itemsize}")
    elif enc in ("gzip", "gz"):
        buf = zlib.decompress(payload, zlib.MAX_WBITS | 32)
    elif enc in ("bzip2", "bz2"):
        buf = bz2.decompress(payload)
    elif enc in ("ascii", "text", "txt"):
        flat = np.array(payload.split(),
                        dtype=(np.float64 if dtype.kind == "f"
                               else np.int64)).astype(dtype.base)
        return flat.reshape(sizes, order="F"), {**fields, **keyvals}
    else:
        raise ValueError(f"unsupported NRRD encoding {enc!r}")
    if len(buf) < n * dtype.itemsize:
        raise ValueError(f"{path}: {enc} payload inflates to {len(buf)} "
                         f"bytes, need {n * dtype.itemsize}")
    arr = np.frombuffer(buf, dtype=dtype, count=n).reshape(sizes, order="F")
    return arr.copy(), {**fields, **keyvals}


def _atomic_write(path: str, chunks, opener=open) -> None:
    """Write ``chunks`` to ``path + '.tmp'`` and move it into place."""
    tmp = path + ".tmp"
    with opener(tmp, "wb") as f:
        for c in chunks:
            f.write(c)
    os.replace(tmp, path)


def write_nrrd(path: str, data: np.ndarray, encoding: str = "gzip",
               keyvals: Optional[Dict[str, str]] = None) -> None:
    """Write ``data`` as an attached-data NRRD (pynrrd-readable): Fortran
    index order on disk, little endian, gzip level 1 or raw, as the JAX
    package writes it."""
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
    _atomic_write(path, (header.encode("ascii"), payload))


# --------------------------------------------------------------------------- #
# NIfTI-1
# --------------------------------------------------------------------------- #
_NIFTI_DTYPES = {
    2: "u1", 4: "i2", 8: "i4", 16: "f4", 64: "f8",
    256: "i1", 512: "u2", 768: "u4", 1024: "i8", 1280: "u8",
}
_NIFTI_CODES = {v: k for k, v in _NIFTI_DTYPES.items()}


def _companion_img(path: str) -> Tuple[str, object]:
    """The ``.img`` (or ``.img.gz``) beside a ``.hdr`` and its opener."""
    base = path[:-3] if path.endswith(".gz") else path
    img = os.path.splitext(base)[0] + ".img"
    if not os.path.exists(img) and os.path.exists(img + ".gz"):
        return img + ".gz", gzip.open
    return img, open


def read_nifti(path: str) -> np.ndarray:
    """Read a NIfTI-1 image: ``.nii`` / ``.nii.gz``, or a ``.hdr`` whose
    voxels sit in the ``.img`` beside it.

    Returns the data as ``np.asanyarray(nib.load(p).dataobj)`` would:
    Fortran voxel order, with ``scl_slope`` / ``scl_inter`` applied
    (promoting to float64) when the header's scaling is not the identity.
    """
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        hdr = f.read(348)
        if len(hdr) < 348:
            raise ValueError(f"{path}: truncated NIfTI header")
        bo = "<"
        if struct.unpack("<i", hdr[0:4])[0] != 348:
            if struct.unpack(">i", hdr[0:4])[0] != 348:
                raise ValueError(f"{path}: bad sizeof_hdr")
            bo = ">"
        magic = hdr[344:348]
        if magic[:3] not in (b"n+1", b"ni1"):
            raise ValueError(f"{path}: bad NIfTI magic {magic!r}")
        dim = struct.unpack(bo + "8h", hdr[40:56])
        ndim = dim[0]
        if not 1 <= ndim <= 7:
            raise ValueError(f"{path}: bad ndim {ndim}")
        shape = tuple(dim[1:1 + ndim])
        (datatype,) = struct.unpack(bo + "h", hdr[70:72])
        if datatype not in _NIFTI_DTYPES:
            raise ValueError(f"{path}: unsupported datatype code {datatype}")
        dtype = np.dtype(bo + _NIFTI_DTYPES[datatype])
        (vox_offset,) = struct.unpack(bo + "f", hdr[108:112])
        slope, inter = struct.unpack(bo + "2f", hdr[112:120])
        n = int(np.prod(shape))
        if magic[:3] == b"ni1":
            img, iopen = _companion_img(path)
            with iopen(img, "rb") as fi:
                fi.read(int(vox_offset))
                raw = fi.read(n * dtype.itemsize)
        else:
            off = int(vox_offset)
            if off > 348:
                f.read(off - 348)
            raw = f.read(n * dtype.itemsize)
    if len(raw) < n * dtype.itemsize:
        raise ValueError(f"{path}: NIfTI data has {len(raw)} bytes, "
                         f"need {n * dtype.itemsize}")
    arr = np.frombuffer(raw, dtype=dtype, count=n).reshape(shape, order="F")
    # nibabel scales unless the slope is absent (0) or the identity
    if slope != 0.0 and (slope != 1.0 or inter != 0.0):
        arr = arr * np.float64(slope) + np.float64(inter)
    return np.array(arr)


def write_nifti(path: str, data: np.ndarray,
                pixdim: Optional[Tuple[float, ...]] = None) -> None:
    """Write a minimal NIfTI-1 image (nibabel-readable): a single
    ``.nii`` / ``.nii.gz`` file (gzip by extension), as the JAX package
    writes it, or, for a ``.hdr`` path, the 348-byte header
    (magic ``ni1``, ``vox_offset`` 0) with the voxels in the ``.img``
    beside it."""
    data = np.asarray(data)
    code = data.dtype.kind + str(data.dtype.itemsize)
    if code not in _NIFTI_CODES:
        raise ValueError(f"unsupported dtype {data.dtype} for NIfTI")
    if not 1 <= data.ndim <= 7:
        raise ValueError(f"unsupported ndim {data.ndim}")
    pair = path.endswith(".hdr")
    le = np.dtype("<" + code)
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    pd = [1.0] * 8
    if pixdim:
        pd[1:1 + len(pixdim)] = [float(p) for p in pixdim]
    hdr = bytearray(348 if pair else 352)  # + the 4-byte extension flag
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, _NIFTI_CODES[code])
    struct.pack_into("<h", hdr, 72, le.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, *pd)
    struct.pack_into("<f", hdr, 108, 0.0 if pair else 352.0)  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # slope/inter: identity
    hdr[344:348] = b"ni1\x00" if pair else b"n+1\x00"
    payload = np.ascontiguousarray(data.T).astype(le, copy=False).tobytes()
    if pair:
        _atomic_write(os.path.splitext(path)[0] + ".img", (payload,))
        _atomic_write(path, (bytes(hdr),))
    else:
        _atomic_write(path, (bytes(hdr), payload),
                      gzip.open if path.endswith(".gz") else open)
