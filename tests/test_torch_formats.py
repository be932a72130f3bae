"""The port's NRRD and NIfTI-1 readers and writers (``data/formats.py``) and
``data/io.read_volume`` against the JAX package's, on the CPU.

Every case holds arrays bit-equal (``assert_array_equal`` and equal
dtypes): files the port writes are read back by the port and by the JAX
package, and files the JAX package writes are read by the port; raw NRRD
and ``.nii`` files are also equal byte for byte, and the gzip streams
equal once inflated.  NRRD raw and gzip, NIfTI ``.nii``, ``.nii.gz`` and
a detached ``.hdr`` / ``.img`` pair, at float32, float64, int16 and
uint8.  The reader-only paths (big endian, detached NRRD data with line
and byte skips, ascii, bzip2, NIfTI scaling) read hand-built headers in
both packages; malformed headers and unknown extensions raise in both;
``evaluation/analysis`` scores segmentations and masks given as NRRD /
NIfTI paths as JAX's does.  Each test writes a few KB under its
``tmp_path`` and deletes it.
"""

import bz2
import gzip
import shutil
import struct

import numpy as np
import pytest

from nnal_tpu.data import formats as jfmt
from nnal_tpu.data.io import read_volume as j_read_volume
from nnal_tpu_torch.data import formats as tfmt
from nnal_tpu_torch.data import io as tio

DTYPES = [np.float32, np.float64, np.int16, np.uint8]


@pytest.fixture
def tmp(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _volume(dtype, shape=(7, 5, 3), seed=0):
    rng = np.random.default_rng(seed)
    v = rng.uniform(-50, 200, size=shape)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        v = np.clip(np.round(v), info.min, info.max)
    return v.astype(dtype)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("encoding", ["raw", "gzip"])
def test_nrrd_round_trip_both_ways(tmp, dtype, encoding):
    arr = _volume(dtype)
    tp, jp = str(tmp / "port.nrrd"), str(tmp / "jax.nrrd")
    tfmt.write_nrrd(tp, arr, encoding=encoding, keyvals={"who": "port"})
    jfmt.write_nrrd(jp, arr, encoding=encoding, keyvals={"who": "port"})
    for p in (tp, jp):
        t_arr, t_hdr = tfmt.read_nrrd(p)
        j_arr, j_hdr = jfmt.read_nrrd(p)
        _same(t_arr, arr)
        _same(j_arr, arr)
        assert t_hdr == j_hdr and t_hdr["who"] == "port"
        _same(tio.read_volume(p), j_read_volume(p))
    t_bytes, j_bytes = open(tp, "rb").read(), open(jp, "rb").read()
    if encoding == "raw":
        assert t_bytes == j_bytes
    else:
        t_head, t_body = t_bytes.split(b"\n\n", 1)
        j_head, j_body = j_bytes.split(b"\n\n", 1)
        assert t_head == j_head
        assert gzip.decompress(t_body) == gzip.decompress(j_body)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("suffix", [".nii", ".nii.gz", ".hdr"])
def test_nifti_round_trip_both_ways(tmp, dtype, suffix):
    arr = _volume(dtype, shape=(6, 5, 4))
    tp = str(tmp / ("port" + suffix))
    tfmt.write_nifti(tp, arr, pixdim=(1.0, 1.0, 2.5))
    _same(tfmt.read_nifti(tp), arr)
    _same(jfmt.read_nifti(tp), arr)
    _same(tio.read_volume(tp), j_read_volume(tp))
    if suffix == ".hdr":
        # JAX writes single files only; its reader takes the port's pair
        assert (tmp / "port.img").stat().st_size == arr.nbytes
        assert open(tp, "rb").read()[344:348] == b"ni1\x00"
        return
    jp = str(tmp / ("jax" + suffix))
    jfmt.write_nifti(jp, arr, pixdim=(1.0, 1.0, 2.5))
    _same(tfmt.read_nifti(jp), arr)
    opener = gzip.open if suffix.endswith(".gz") else open
    with opener(tp, "rb") as a, opener(jp, "rb") as b:
        assert a.read() == b.read()


def test_detached_pair_with_gzipped_img(tmp):
    """A ``.hdr`` whose voxels sit in ``.img.gz``: both packages read it."""
    arr = _volume(np.int16, shape=(4, 3, 2))
    tfmt.write_nifti(str(tmp / "v.hdr"), arr)
    raw = open(tmp / "v.img", "rb").read()
    (tmp / "v.img").unlink()
    with gzip.open(tmp / "v.img.gz", "wb") as f:
        f.write(raw)
    _same(tfmt.read_nifti(str(tmp / "v.hdr")), arr)
    _same(jfmt.read_nifti(str(tmp / "v.hdr")), arr)


def test_nrrd_reader_only_paths(tmp):
    """Big endian with type aliases, detached raw data behind line and
    byte skips, ascii and bzip2: both packages read the same arrays."""
    be = np.arange(12, dtype=">i2").reshape(3, 4)
    (tmp / "be.nrrd").write_bytes(
        b"NRRD0001\ntype: short\ndimension: 2\nsizes: 3 4\n"
        b"endian: big\nencoding: raw\n\n" + np.ascontiguousarray(be.T)
        .tobytes())
    arr = np.arange(6, dtype=np.int32).reshape(2, 3)
    (tmp / "d.raw").write_bytes(
        b"skip me\nand me\nXYZ" + np.ascontiguousarray(arr.T)
        .astype("<i4").tobytes())
    (tmp / "d.nhdr").write_bytes(
        b"NRRD0004\ntype: int\ndimension: 2\nsizes: 2 3\nendian: little\n"
        b"encoding: raw\ndata file: d.raw\nline skip: 2\nbyte skip: 3\n")
    vals = " ".join(str(v) for v in np.ascontiguousarray(arr.T).ravel())
    (tmp / "a.nrrd").write_bytes(
        b"NRRD0001\ntype: int\ndimension: 2\nsizes: 2 3\n"
        b"encoding: ascii\n\n" + vals.encode())
    f = _volume(np.float32, shape=(3, 2, 2))
    (tmp / "b.nrrd").write_bytes(
        b"NRRD0005\ntype: float\ndimension: 3\nsizes: 3 2 2\n"
        b"endian: little\nencoding: bzip2\n# a comment\nspace:=RAS\n\n"
        + bz2.compress(np.ascontiguousarray(f.T).tobytes()))
    for name, want in (("be.nrrd", be), ("d.nhdr", arr), ("a.nrrd", arr),
                       ("b.nrrd", f)):
        p = str(tmp / name)
        t_arr, t_hdr = tfmt.read_nrrd(p)
        j_arr, j_hdr = jfmt.read_nrrd(p)
        np.testing.assert_array_equal(t_arr, want)
        _same(t_arr, j_arr)
        assert t_hdr == j_hdr


def test_nifti_scaling_and_big_endian(tmp):
    """``scl_slope`` / ``scl_inter`` promote to float64 as nibabel does,
    in either byte order."""
    arr = np.arange(8, dtype=np.int16).reshape(2, 2, 2)
    for bo in ("<", ">"):
        hdr = bytearray(352)
        struct.pack_into(bo + "i", hdr, 0, 348)
        struct.pack_into(bo + "8h", hdr, 40, 3, 2, 2, 2, 1, 1, 1, 1)
        struct.pack_into(bo + "h", hdr, 70, 4)
        struct.pack_into(bo + "h", hdr, 72, 16)
        struct.pack_into(bo + "f", hdr, 108, 352.0)
        struct.pack_into(bo + "2f", hdr, 112, 2.0, -1.0)
        hdr[344:348] = b"n+1\x00"
        p = str(tmp / f"s{bo == '>'}.nii")
        with open(p, "wb") as fh:
            fh.write(bytes(hdr))
            fh.write(np.ascontiguousarray(arr.T).astype(bo + "i2").tobytes())
        got = tfmt.read_nifti(p)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, arr * 2.0 - 1.0)
        _same(got, jfmt.read_nifti(p))


@pytest.mark.parametrize("name,content", [
    ("magic.nrrd", b"PNG\nsizes: 2\n\n"),
    ("line.nrrd", b"NRRD0004\ntype: float\nno colon here\n\n"),
    ("type.nrrd", b"NRRD0004\ntype: quad\ndimension: 1\nsizes: 2\n\n"),
    ("enc.nrrd", b"NRRD0004\ntype: float\ndimension: 1\nsizes: 2\n"
                 b"encoding: zstd\n\n"),
    ("short.nrrd", b"NRRD0004\ntype: float\ndimension: 1\nsizes: 4\n"
                   b"encoding: raw\n\n\x00\x00"),
    ("short.nii", b"\x5c\x01\x00\x00" + b"\x00" * 100),
])
def test_malformed_headers_raise_in_both(tmp, name, content):
    p = tmp / name
    p.write_bytes(content)
    read_t = tfmt.read_nifti if name.endswith(".nii") else tfmt.read_nrrd
    read_j = jfmt.read_nifti if name.endswith(".nii") else jfmt.read_nrrd
    with pytest.raises(ValueError):
        read_t(str(p))
    with pytest.raises(ValueError):
        read_j(str(p))


def test_read_volume_registry(tmp):
    """Every registered extension reads the same volume; an unknown one
    raises in both packages; ``register_reader`` adds one."""
    arr = _volume(np.float32)
    paths = {".npy": tmp / "v.npy", ".nrrd": tmp / "v.nrrd",
             ".nii": tmp / "v.nii", ".nii.gz": tmp / "v.nii.gz",
             ".hdr": tmp / "v.hdr"}
    np.save(paths[".npy"], arr)
    tfmt.write_nrrd(str(paths[".nrrd"]), arr)
    for ext in (".nii", ".nii.gz", ".hdr"):
        tfmt.write_nifti(str(paths[ext]), arr)
    for p in paths.values():
        _same(tio.read_volume(str(p)), arr)
        _same(j_read_volume(str(p)), arr)
    (tmp / "v.mha").write_bytes(b"")
    with pytest.raises(ValueError, match="no reader"):
        tio.read_volume(str(tmp / "v.mha"))
    with pytest.raises(ValueError, match="no reader"):
        j_read_volume(str(tmp / "v.mha"))
    tio.register_reader(".mha", lambda p: arr)
    try:
        _same(tio.read_volume(str(tmp / "v.mha")), arr)
    finally:
        del tio._READERS[".mha"]


def test_analysis_reads_nrrd_and_nifti_paths(tmp):
    """``evaluation/analysis`` takes segmentations and masks as NRRD /
    NIfTI paths (``_as_volumes`` through ``read_volume``): the F-measures
    equal JAX's from the same files."""
    from nnal_tpu.evaluation import analysis as j_an
    from nnal_tpu_torch.evaluation import analysis as t_an

    rng = np.random.default_rng(5)
    segs, masks = [], []
    for i, ext in enumerate((".nrrd", ".nii", ".nii.gz")):
        mask = (rng.uniform(size=(8, 8, 6)) > 0.6).astype(np.uint8)
        seg = np.where(rng.uniform(size=mask.shape) > 0.2, mask,
                       1 - mask).astype(np.uint8)
        segs.append(str(tmp / f"seg{i}{ext}"))
        masks.append(str(tmp / f"mask{i}{ext}"))
        for p, v in ((segs[-1], seg), (masks[-1], mask)):
            (tfmt.write_nrrd if ext == ".nrrd" else tfmt.write_nifti)(p, v)
    got = t_an.eval_full_segs_explicit_partitions(segs, masks, [2, 4])
    want = j_an.eval_full_segs_explicit_partitions(segs, masks, [2, 4])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1].shape == (3, 3) and (got[0] > 0).all()
