"""Inputs made from the run's seed, on the device, in a few large calls.

Subjects are volumes of ``modalities`` channels over a label mask of
ellipsoid blobs: each modality is a blob contrast of its own plus
box-smoothed Gaussian noise, so a voxel's class is learnable from its
neighbourhood and not from its own intensity alone.  Every seed gives the
same shapes; only the values change.  Weights are He-normal draws scaled
by each tensor's fan-in, small normal biases, and batch-norm scales,
shifts and running statistics near their identity.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def generator(seed: int, tag: int, device) -> torch.Generator:
    """A device generator for one consumer of the seed."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + int(tag)) % (2 ** 63))


def volumes(shape: Tuple[int, int, int], modalities: int, blobs: int,
            seed: int, tag: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(vols (modalities, *shape), mask shape)`` float32 on ``device``."""
    g = generator(seed, tag, device)
    s = torch.tensor(shape, dtype=torch.float32, device=device)
    centers = torch.rand((blobs, 3), generator=g, device=device) * s
    radii = (0.08 + 0.14 * torch.rand((blobs, 3), generator=g,
                                      device=device)) * s
    axes = [torch.arange(n, dtype=torch.float32, device=device)
            for n in shape]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    d = ((grid[None] - centers[:, None, None, None])
         / radii[:, None, None, None]).square().sum(-1)
    mask = (d.min(dim=0).values <= 1.0).float()
    noise = torch.randn((modalities, 1) + tuple(shape), generator=g,
                        device=device)
    noise = F.avg_pool3d(noise, 3, 1, 1, count_include_pad=False)[:, 0]
    contrast = 1.0 + torch.rand((modalities, 1, 1, 1), generator=g,
                                device=device)
    vols = 100.0 + 20.0 * (contrast * mask[None] + 0.6 * noise)
    return vols, mask


def weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device,
            tag: int = 1) -> Dict[str, torch.Tensor]:
    """One tensor per ``shapes`` entry from one draw of normals: a weight
    N(0, 2 / fan_in), a bias N(0, 0.01^2), a BN ``gamma`` 1 + N(0, 0.1^2)
    and ``beta`` N(0, 0.1^2)."""
    g = generator(seed, tag, device)
    total = sum(int(np.prod(s)) for s in shapes.values())
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = int(np.prod(shape))
        v = flat[at:at + n].view(shape)
        at += n
        kind = name.rpartition(".")[2]
        if kind == "weight":
            v = v * math.sqrt(2.0 / int(np.prod(shape[1:])))
        elif kind == "bias":
            v = v * 0.01
        elif kind == "gamma":
            v = 1.0 + 0.1 * v
        else:
            v = 0.1 * v
        out[name] = v.contiguous()
    return out


def bn_stats(widths, seed: int, device, tag: int = 2
             ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Running statistics per BN layer: mean N(0, 0.1^2), variance
    uniform in [0.5, 1.5)."""
    widths = list(widths)
    g = generator(seed, tag, device)
    total = sum(w for _, w in widths)
    mean = 0.1 * torch.randn(total, generator=g, device=device)
    var = 0.5 + torch.rand(total, generator=g, device=device)
    out, at = {}, 0
    for name, w in widths:
        out[name] = {"mean": mean[at:at + w].clone(),
                     "var": var[at:at + w].clone()}
        at += w
    return out
