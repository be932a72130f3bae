"""K2: patch gather + normalization — the port of
``nnal_tpu/ops/gather_pallas.py::gather_patches_pallas``, implementing the
contract of ``nnal_tpu/data/patches.py::gather_patches_normalized``.

On a CUDA tensor it launches the hand-written kernel in
``csrc/gather_patches.cu`` (see its header for the bound and design) or
raises; on a CPU tensor it runs the plain advanced-indexing version below.
Every patch shape goes through the kernel (the TPU kernel only took
``d3 == 1``).

The kernel reads a y-contiguous copy of the padded volume,
``(m, D1p, D3p, D2p)``, so that a window row is contiguous.
:func:`y_contiguous` makes it once per volume and keeps it in a cache of
:data:`YCACHE_SIZE` entries, the least recently used out, keyed on the
volume's address, shape, strides and version counter (an in-place edit
bumps the counter and rebuilds the copy).  A multi-subject finetune
gathers from one subject's volume after another, so one entry per volume
keeps every subject's copy across the calls of a round.  An entry holds a
reference to its volume, so the address cannot be reused while the entry
lives.  The volume's checks run when the copy is made, which keeps the
per-call host cost to what the call needs; :data:`YCACHE_STATS` counts
the copies made (``rebuilds``) and the distinct volume tensors they were
made of (``volumes``): the two are equal unless a copy was rebuilt, after
an in-place edit or an eviction.
"""

from __future__ import annotations

import ctypes
import weakref
from collections import OrderedDict
from typing import Dict, Tuple

import torch

from nnal_tpu_torch.ops._build import INT, VOIDP, CudaKernel, stream_ptr


class GatherParams(ctypes.Structure):
    """The kernel's per-volume constants (``GatherParams`` in the source)."""
    _fields_ = [(name, ctypes.c_int) for name in
                ("d1", "d2", "d3", "m", "D1p", "D2p", "D3p", "s2", "s3")]


KERNEL = CudaKernel("gather_patches_normalized", "gather_patches.cu",
                    "gather_patches_normalized_f32",
                    [VOIDP, VOIDP, VOIDP, VOIDP, VOIDP, INT,
                     ctypes.POINTER(GatherParams), VOIDP])

REPLACES = "nnal_tpu/ops/gather_pallas.py:90"


def unravel3(inds: torch.Tensor, shape: Tuple[int, int, int]):
    """C-order unravel of raveled indices on ``shape`` -> (x, y, z)."""
    _, s2, s3 = shape
    z = inds % s3
    rem = inds // s3
    return rem // s2, rem % s2, z


def gather_patches_plain(padded, inds, mu, sd, patch_shape, orig_shape):
    """Plain PyTorch version: clamp window starts as ``lax.dynamic_slice``
    does, gather with broadcast advanced indexing, normalize."""
    d1, d2, d3 = patch_shape
    m, D1p, D2p, D3p = padded.shape
    x, y, z = unravel3(inds, orig_shape)
    dev = padded.device
    ax = x.clamp(0, D1p - d1)[:, None] + torch.arange(d1, device=dev)
    ay = y.clamp(0, D2p - d2)[:, None] + torch.arange(d2, device=dev)
    az = z.clamp(0, D3p - d3)[:, None] + torch.arange(d3, device=dev)
    win = padded[:, ax[:, :, None, None], ay[:, None, :, None],
                 az[:, None, None, :]]               # (m, n, d1, d2, d3)
    x = win.permute(1, 2, 3, 0, 4).reshape(len(inds), d1, d2, m * d3)
    mu_full = mu.repeat_interleave(d3)
    sd_full = sd.repeat_interleave(d3)
    return (x - mu_full) / sd_full


YCACHE_SIZE = 8

# key -> (volume, its y-contiguous copy), most recently used last
_YCACHE: "OrderedDict[tuple, Tuple[torch.Tensor, torch.Tensor]]" = \
    OrderedDict()
YCACHE_STATS = {"rebuilds": 0, "volumes": 0}
_SEEN: Dict[int, weakref.ref] = {}     # the volume tensors copied so far


def reset_ycache_stats() -> None:
    """Zero both counters (the cached copies stay)."""
    YCACHE_STATS.update(rebuilds=0, volumes=0)
    _SEEN.clear()


def _count_copy(padded: torch.Tensor) -> None:
    YCACHE_STATS["rebuilds"] += 1
    ref = _SEEN.get(id(padded))
    if ref is None or ref() is not padded:
        for k in [k for k, r in _SEEN.items() if r() is None]:
            del _SEEN[k]
        _SEEN[id(padded)] = weakref.ref(padded)
        YCACHE_STATS["volumes"] += 1


def _check_volume(padded: torch.Tensor) -> None:
    if padded.dim() != 4 or padded.dtype != torch.float32:
        raise ValueError("padded must be a float32 (m, D1p, D2p, D3p) "
                         f"tensor; got {padded.dtype} {tuple(padded.shape)}")
    if padded.numel() >= 2 ** 31:
        raise ValueError("the padded volume must have < 2**31 elements "
                         "(the kernel indexes it in int32)")


def y_contiguous(padded: torch.Tensor) -> torch.Tensor:
    """``padded`` (m, D1p, D2p, D3p) as a contiguous (m, D1p, D3p, D2p)
    copy, made once per volume (see the module docstring)."""
    key = (padded.data_ptr(), padded.shape, padded.stride(),
           padded._version, padded.device)
    hit = _YCACHE.get(key)
    if hit is not None:
        _YCACHE.move_to_end(key)
        return hit[1]
    _check_volume(padded)
    copy = padded.permute(0, 1, 3, 2).contiguous()
    _YCACHE[key] = (padded, copy)
    if len(_YCACHE) > YCACHE_SIZE:
        _YCACHE.popitem(last=False)
    _count_copy(padded)
    return copy


_PARAMS = {}


def _params(yvol: torch.Tensor, patch_shape, orig_shape) -> GatherParams:
    key = (yvol.shape, patch_shape, orig_shape)
    p = _PARAMS.get(key)
    if p is None:
        d1, d2, d3 = (int(v) for v in patch_shape)
        m, D1p, D3p, D2p = yvol.shape
        _, s2, s3 = (int(v) for v in orig_shape)
        if d1 > D1p or d2 > D2p or d3 > D3p:
            raise ValueError(f"patch {patch_shape} exceeds the padded "
                             f"volume {tuple(yvol.shape)}")
        if s2 * s3 >= 2 ** 31 or d1 * d2 * m * d3 >= 2 ** 31:
            raise ValueError("the original shape's last two extents and "
                             "a patch must have < 2**31 elements (the "
                             "kernel indexes in int32)")
        if len(_PARAMS) >= 16:
            _PARAMS.clear()
        p = _PARAMS[key] = GatherParams(d1, d2, d3, m, D1p, D2p, D3p, s2,
                                        s3)
    return p


def gather_patches_normalized(padded: torch.Tensor, inds: torch.Tensor,
                              mu: torch.Tensor, sd: torch.Tensor,
                              patch_shape, orig_shape) -> torch.Tensor:
    """``(n, d1, d2, m*d3)`` normalized patches around raveled voxel
    ``inds`` (non-negative, on ``orig_shape``) of the zero-padded
    ``(m, D1p, D2p, D3p)`` float32 volume; ``mu``/``sd`` are the (m,)
    per-modality statistics."""
    dev = padded.device
    if dev.type == "cuda":
        yvol = y_contiguous(padded)   # checks the volume when it is new
    else:
        _check_volume(padded)
    m = padded.shape[0]
    if inds.dim() != 1 or inds.dtype != torch.int64:
        raise ValueError(f"inds must be 1-D int64; got {inds.dtype} "
                         f"{tuple(inds.shape)}")
    if (mu.shape != (m,) or sd.shape != (m,) or mu.dtype != torch.float32
            or sd.dtype != torch.float32):
        raise ValueError(f"mu/sd must be float32 ({m},)")
    if not inds.device == mu.device == sd.device == dev:
        raise ValueError("padded, inds, mu and sd must share one device")
    patch_shape = tuple(patch_shape)
    if dev.type == "cpu":
        return gather_patches_plain(padded, inds, mu, sd, patch_shape,
                                    orig_shape)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not (inds.is_contiguous() and mu.is_contiguous()
            and sd.is_contiguous()):
        raise ValueError("gather_patches_normalized needs contiguous inputs")
    params = _params(yvol, patch_shape, tuple(orig_shape))
    n = inds.shape[0]
    if n >= 2 ** 31:
        raise ValueError("at most 2**31 - 1 patches per call")
    d1, d2, d3 = patch_shape
    out = torch.empty((n, d1, d2, m * d3), dtype=torch.float32, device=dev)
    # the C entry point launches through the runtime API, which targets
    # the current device: make it the volume's
    with torch.cuda.device(dev):
        KERNEL.launch(yvol.data_ptr(), inds.data_ptr(), mu.data_ptr(),
                      sd.data_ptr(), out.data_ptr(), n,
                      ctypes.byref(params), stream_ptr(padded))
    return out
