"""The benchmark's own counts of work: model FLOPs from the layer tables,
and the bytes the patch gather (kernel K2) must move.

A multiply-add counts 2 FLOPs.  Only the convolutions, transposed
convolutions and fully connected layers are counted: activations, batch
norm, pools and softmax are not.  These counts are frozen with the
benchmark, so a change to the program cannot change what a rate or a
utilization is measured against.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from reference import fcd103, pw1


def pw1_flops(patch: Tuple[int, int] = (25, 25), channels: int = 2,
              nclass: int = 2) -> int:
    """Forward FLOPs of one PW1 patch: each conv's multiply-adds at every
    output pixel ('same' convs keep the pool's output side), and each fc's
    weight count."""
    macs = 0
    h, w = patch
    c = channels
    for row in pw1.CONVS:
        if row is None:
            h, w = pw1.pooled(h), pw1.pooled(w)
            continue
        _, out, k = row
        macs += h * w * out * c * k * k
        c = out
    d = h * w * c
    for out in (pw1.HIDDEN, pw1.HIDDEN, nclass):
        macs += d * out
        d = out
    return 2 * macs


def fcd103_flops(hw: Tuple[int, int], channels: int = 2,
                 nclass: int = 2) -> int:
    """Forward FLOPs of FC-DenseNet-103 on one ``hw`` slice: a conv's
    multiply-adds at every output pixel, a transposed conv's at every
    input pixel (each input pixel meets every kernel tap once)."""
    sizes = {}
    macs = 0
    for kind, name, srcs, cin, cout in fcd103.layers(channels, nclass):
        size = min(sizes[s] for s in srcs) if srcs else tuple(hw)
        if kind == "pool":
            sizes[name] = tuple(-(-n // 2) for n in size)
            continue
        k = 3 if kind in ("first", "dense", "tu") else 1
        macs += cout * cin * k * k * int(np.prod(size))
        sizes[name] = tuple(2 * n for n in size) if kind == "tu" else size
    return 2 * macs


def gather_bytes(inds: Sequence[int], orig_shape: Tuple[int, int, int],
                 patch: Tuple[int, int, int], modalities: int) -> int:
    """Least bytes one patch gather moves: the float32 output rows
    (``n * d1 * d2 * d3 * modalities``), the int64 indices, and every
    distinct voxel of the zero-padded volume that some patch touches,
    read once per modality."""
    inds = np.asarray(inds, np.int64)
    d1, d2, d3 = patch
    r1, r2, r3 = d1 // 2, d2 // 2, d3 // 2
    s1, s2, s3 = orig_shape
    x, rem = np.divmod(inds, s2 * s3)
    y, z = np.divmod(rem, s3)
    touched = np.zeros((s1 + 2 * r1, s2 + 2 * r2, s3 + 2 * r3), bool)
    # a window's corner in padded coordinates is the voxel itself
    for dx in range(d1):
        for dy in range(d2):
            for dz in range(d3):
                touched[x + dx, y + dy, z + dz] = True
    out = inds.size * d1 * d2 * d3 * modalities * 4
    return int(out + inds.size * 8 + int(touched.sum()) * modalities * 4)
