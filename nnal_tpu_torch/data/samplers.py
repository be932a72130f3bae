"""Pool samplers (counterpart of ``nnal_tpu/data/samplers.py``).

The grid sampler and the pool/test split the patch-wise engine uses
(numpy), and the local-variance map behind ``ps-random``: the
``Var[x] = E[x^2] - E[x]^2`` box-filter trick of the reference
(patch_utils.py:794), as two batched convolutions over every axial slice
on the given device.  The analysis samplers (``samplers.py:94-173``):
``sample_masked_volume`` (the reference's balanced 3-way sampling),
``sample_types_of`` (the partition type of arbitrary voxels under the
same rule) and ``filter_by_parcellation``; their log-variance maps run on
``device`` (None: the card).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nnal_tpu_torch.core.device import resolve_device
from nnal_tpu_torch.data.indexing import expand_raveled_inds


def generate_grid_samples(shape3d, grid_spacing: int, mask=None):
    """Raveled 3D grid indices: all voxels whose in-plane coordinates are
    multiples of ``grid_spacing``, swept over every axial slice (reference
    ``gen_multimg_inds``, PW_AL.py:921-976).

    If ``mask`` is given, voxels whose mask value is NaN are discarded and
    the corresponding labels are returned (reference drops NaN voxels).
    """
    s = tuple(shape3d)
    gx = np.arange(0, s[0], grid_spacing)
    gy = np.arange(0, s[1], grid_spacing)
    X, Y = np.meshgrid(gx, gy, indexing="ij")
    X, Y = X.ravel(), Y.ravel()
    inds = []
    labels = []
    for z in range(s[2]):
        Z = np.full_like(X, z)
        inds.append(np.ravel_multi_index((X, Y, Z), s))
        if mask is not None:
            labels.append(np.asarray(mask)[X, Y, Z])
    inds = np.concatenate(inds)
    if mask is None:
        return inds
    labels = np.concatenate(labels)
    keep = ~np.isnan(labels)
    return inds[keep], labels[keep].astype(np.int64)


def even_odd_slice_split(inds, shape3d) -> Tuple[np.ndarray, np.ndarray]:
    """Pool/test split by axial-slice parity: even slices -> pool, full grid
    -> test (reference ``prep_AL_data``, PW_AL.py:1004-1013, which keeps the
    whole grid as the test set)."""
    inds = np.asarray(inds, dtype=np.int64)
    z = np.unravel_index(inds, tuple(shape3d))[2]
    return inds[z % 2 == 0], inds


def local_variance_map(vol: torch.Tensor, d: int) -> torch.Tensor:
    """Per-voxel variance of the d x d in-plane window around each voxel,
    for every axial slice of ``vol`` (``(D1, D2, D3)``), on ``vol``'s
    device (reference ``get_vars_2d``, patch_utils.py:794).

    As in the JAX package (``samplers.py:51-80``): intensities are floored
    (the reference's uint cast), each slice is mean-centered in f32 before
    filtering, and the box filter is 'SAME' with zero padding, which for
    an even ``d`` puts ``(d - 1) // 2`` rows and columns before and
    ``d // 2`` after."""
    x = torch.floor(vol.to(torch.float32))
    x = x - x.mean(dim=(0, 1), keepdim=True)
    imgs = x.permute(2, 0, 1).unsqueeze(1)                  # (D3, 1, D1, D2)
    lo, hi = (d - 1) // 2, d // 2
    ones = torch.ones((1, 1, d, d), dtype=torch.float32, device=vol.device)

    def box(v):
        return F.conv2d(F.pad(v, (lo, hi, lo, hi)), ones) / float(d * d)

    ex = box(imgs)
    ex2 = box(imgs ** 2)
    return (ex2 - ex ** 2)[:, 0].permute(1, 2, 0)


def high_variance_filter(vol, patch_shape, thr: float, pool_inds,
                         device=None) -> np.ndarray:
    """Positions (into ``pool_inds``) whose local variance exceeds ``thr``
    (reference ``get_HV_inds``, PW_NNAL.py:630-666; used by ``ps-random``).
    ``vol`` is the unpadded first-modality volume; the window is the first
    patch radius, as in the reference.  Runs on ``device`` (``None``: the
    card)."""
    d = int((patch_shape[0] - 1) // 2)
    v = torch.as_tensor(np.asarray(vol)).to(resolve_device(device))
    var = local_variance_map(v, d).reshape(-1)
    inds = torch.as_tensor(np.asarray(pool_inds, np.int64)).to(v.device)
    return torch.nonzero(var[inds] > thr).reshape(-1).cpu().numpy()


def _log_var(img, var_kernel: int, device) -> np.ndarray:
    """The log local-variance map of the balanced sampler
    (``samplers.py:104-107``): variances of exactly 0 lifted by 0.1."""
    v = torch.as_tensor(np.asarray(img)).to(resolve_device(device))
    log_var = local_variance_map(v, var_kernel).cpu().numpy()
    log_var[log_var == 0] += 1e-1
    return np.log(log_var)


def sample_masked_volume(img, mask, slices, N: Sequence[int], rng,
                         var_kernel: int = 5, var_thr: float = 2.0,
                         device=None):
    """Balanced 3-way sampling per axial slice (reference
    ``sample_masked_volume`` + ``partition_2d_indices``,
    patch_utils.py:628-792): masked voxels / high-variance background /
    low-variance background, with per-slice caps ``N = (n0, n1, n2)``.

    Returns (raveled 3D indices, labels, partition types).
    """
    img = np.asarray(img)
    mask = np.asarray(mask)
    log_var = _log_var(img, var_kernel, device)
    sel_inds, sel_labels, sel_types = [], [], []
    for s in slices:
        m2 = mask[:, :, s]
        v2 = log_var[:, :, s]
        masked = np.flatnonzero(m2.ravel() > 0)
        hvar = np.setdiff1d(np.flatnonzero(v2.ravel() > var_thr), masked)
        lvar = np.setdiff1d(np.flatnonzero(v2.ravel() < var_thr), masked)
        for t, (group, label) in enumerate(
                [(masked, 1), (hvar, 0), (lvar, 0)]):
            take = group if N[t] >= len(group) else \
                group[rng.permutation(len(group))[:N[t]]]
            g3d = expand_raveled_inds(take, s, 2, img.shape)
            sel_inds += list(g3d)
            sel_labels += [label] * len(take)
            sel_types += [t] * len(take)
    return (np.array(sel_inds, dtype=np.int64),
            np.array(sel_labels, dtype=np.int64),
            np.array(sel_types, dtype=np.int64))


def sample_types_of(img, mask, inds, var_kernel: int = 5,
                    var_thr: float = 2.0, device=None) -> np.ndarray:
    """Partition type of arbitrary voxels under the balanced-sampling rule
    (reference ``get_sample_type``, PW_analyze_results.py:69-85): 0 =
    masked, 1 = high-variance background, 2 = low-variance background
    (voxels exactly at ``var_thr``, which the sampler leaves out of both
    groups, classify as 2)."""
    img = np.asarray(img)
    mask = np.asarray(mask)
    log_var = _log_var(img, var_kernel, device)
    pos = np.unravel_index(np.asarray(inds, np.int64), img.shape)
    return np.where(mask[pos] > 0, 0,
                    np.where(log_var[pos] > var_thr, 1, 2)).astype(np.int64)


def filter_by_parcellation(inds, labels, parc) -> Tuple[np.ndarray,
                                                        np.ndarray]:
    """Drop samples whose voxel lies outside a parcellation map (reference
    ``preprop_NVM_data``, patch_utils.py:600-616): ``parc`` is a labeled
    volume or a path ``data.io.read_volume`` reads; samples with
    parcellation label 0 are removed.  Returns the filtered ``(inds,
    labels)``."""
    if isinstance(parc, str):
        from nnal_tpu_torch.data.io import read_volume

        parc = read_volume(parc)
    parc = np.asarray(parc)
    inds = np.asarray(inds, dtype=np.int64)
    labels = np.asarray(labels)
    keep = parc[np.unravel_index(inds, parc.shape)] > 0
    return inds[keep], labels[keep]
