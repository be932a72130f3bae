"""Plain patch extraction for the patch-wise reference.

A voxel's patch is the ``d1 x d2`` window centred on it in one axial
slice of every modality, with the volume zero-padded by the patch radii,
then normalized per modality as ``(v - mu) / sd``.  ``mu`` and ``sd`` are
each modality's mean and standard deviation over the whole volume, taken
in float64 and rounded to float32.  Voxels are raveled C-order over
``(H, W, Z)``.  Nothing here imports the program under test.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def stats(vols: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-modality ``(mu, sd)`` of ``vols`` (modalities, H, W, Z)."""
    v = np.asarray(vols, np.float64).reshape(vols.shape[0], -1)
    return v.mean(1).astype(np.float32), v.std(1).astype(np.float32)


class Patches:
    """Patches of one subject held on ``device``."""

    def __init__(self, vols: np.ndarray, patch: Tuple[int, int], device):
        self.shape = tuple(vols.shape[1:])
        self.d1, self.d2 = patch
        r1, r2 = self.d1 // 2, self.d2 // 2
        mu, sd = stats(vols)
        v = torch.as_tensor(np.asarray(vols, np.float32), device=device)
        self.padded = F.pad(v, (0, 0, r2, r2, r1, r1))
        self.mu = torch.as_tensor(mu, device=device).view(1, -1, 1, 1)
        self.sd = torch.as_tensor(sd, device=device).view(1, -1, 1, 1)
        self.device = device

    def __call__(self, inds) -> torch.Tensor:
        """(n, modalities, d1, d2) normalized patches at ``inds``."""
        inds = torch.as_tensor(np.asarray(inds, np.int64), device=self.device)
        _, s2, s3 = self.shape
        x = inds // (s2 * s3)
        y = (inds // s3) % s2
        z = inds % s3
        ox = torch.arange(self.d1, device=self.device)
        oy = torch.arange(self.d2, device=self.device)
        xs = (x[:, None, None] + ox[None, :, None]).expand(-1, -1, self.d2)
        ys = (y[:, None, None] + oy[None, None, :]).expand(-1, self.d1, -1)
        zs = z[:, None, None].expand(-1, self.d1, self.d2)
        p = self.padded[:, xs, ys, zs]               # (m, n, d1, d2)
        return (p.permute(1, 0, 2, 3) - self.mu) / self.sd
