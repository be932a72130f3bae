"""K2: patch gather + normalization — the port of
``nnal_tpu/ops/gather_pallas.py::gather_patches_pallas``, implementing the
contract of ``nnal_tpu/data/patches.py::gather_patches_normalized``.

On a CUDA tensor it launches the hand-written kernel in
``csrc/gather_patches.cu`` (see its header for the bound and design) or
raises; on a CPU tensor it runs the plain advanced-indexing version below.
Every patch shape goes through the kernel (the TPU kernel only took
``d3 == 1``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from nnal_tpu_torch.ops._build import (
    INT,
    LONG,
    VOIDP,
    CudaKernel,
    stream_ptr,
)

KERNEL = CudaKernel("gather_patches_normalized", "gather_patches.cu",
                    "gather_patches_normalized_f32",
                    [VOIDP, VOIDP, VOIDP, VOIDP, VOIDP, LONG, INT, INT, INT,
                     INT, LONG, LONG, LONG, LONG, LONG, VOIDP])

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


def gather_patches_normalized(padded: torch.Tensor, inds: torch.Tensor,
                              mu: torch.Tensor, sd: torch.Tensor,
                              patch_shape, orig_shape) -> torch.Tensor:
    """``(n, d1, d2, m*d3)`` normalized patches around raveled voxel
    ``inds`` (non-negative, on ``orig_shape``) of the zero-padded
    ``(m, D1p, D2p, D3p)`` float32 volume; ``mu``/``sd`` are the (m,)
    per-modality statistics."""
    d1, d2, d3 = (int(v) for v in patch_shape)
    if padded.dim() != 4 or padded.dtype != torch.float32:
        raise ValueError("padded must be a float32 (m, D1p, D2p, D3p) "
                         f"tensor; got {padded.dtype} {tuple(padded.shape)}")
    m = padded.shape[0]
    if inds.dim() != 1 or inds.dtype != torch.int64:
        raise ValueError(f"inds must be 1-D int64; got {inds.dtype} "
                         f"{tuple(inds.shape)}")
    if (mu.shape != (m,) or sd.shape != (m,) or mu.dtype != torch.float32
            or sd.dtype != torch.float32):
        raise ValueError(f"mu/sd must be float32 ({m},)")
    if len({t.device for t in (padded, inds, mu, sd)}) != 1:
        raise ValueError("padded, inds, mu and sd must share one device")
    if padded.device.type == "cpu":
        return gather_patches_plain(padded, inds, mu, sd, (d1, d2, d3),
                                    orig_shape)
    if padded.device.type != "cuda":
        raise ValueError(f"unsupported device {padded.device}")
    if not all(t.is_contiguous() for t in (padded, inds, mu, sd)):
        raise ValueError("gather_patches_normalized needs contiguous inputs")
    n = inds.shape[0]
    _, D1p, D2p, D3p = padded.shape
    _, s2, s3 = (int(v) for v in orig_shape)
    out = torch.empty((n, d1, d2, m * d3), dtype=torch.float32,
                      device=padded.device)
    KERNEL.launch(padded.data_ptr(), inds.data_ptr(), mu.data_ptr(),
                  sd.data_ptr(), out.data_ptr(), n, d1, d2, d3, m, D1p, D2p,
                  D3p, s2, s3, stream_ptr(padded))
    return out
