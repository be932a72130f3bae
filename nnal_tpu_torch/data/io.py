"""Volume IO, subjects and synthetic data (counterpart of
``nnal_tpu/data/io.py``).

``read_volume`` dispatches on the file extension through a registry
(:func:`register_reader`): ``.npy`` / ``.npz`` (its ``vol`` array) with
numpy, ``.nrrd`` (raw, gzip, bzip2, ascii; attached or detached data)
and NIfTI-1 (``.nii``, ``.nii.gz``, and the ``.hdr`` of a detached
``.hdr`` / ``.img`` pair) with the port's own readers in
``data/formats.py``; the JAX package uses pynrrd / nibabel when they are
installed and the same readers otherwise.  An extension without a reader
raises ``ValueError``.

A :class:`Subject` is its ordered modality paths plus a mask path;
:class:`SubjectRegistry` finds subjects in a root directory (one
subdirectory each, files named by a convention: ``data/datasets.py``) or
takes them from lists.  ``synthetic_subject`` is an exact copy: the same
seed gives the same float64 volumes and mask as the JAX package, and
``write_synthetic_dataset`` writes them as ``.npy`` files as it does.
``write_nrrd`` (re-exported from ``data/formats.py``) is what
``evaluation/analysis.get_full_segs`` saves segmentations with.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from nnal_tpu_torch.data.formats import read_nifti, read_nrrd
from nnal_tpu_torch.data.formats import write_nrrd  # noqa: F401  (re-export)

_READERS: Dict[str, Callable[[str], np.ndarray]] = {}


def register_reader(ext: str, fn: Callable[[str], np.ndarray]) -> None:
    """Read files ending in ``ext`` with ``fn(path) -> array``; the longest
    matching extension wins (``.nii.gz`` before ``.gz``)."""
    _READERS[ext] = fn


def read_volume(path: str) -> np.ndarray:
    for ext in sorted(_READERS, key=len, reverse=True):
        if path.endswith(ext):
            return _READERS[ext](path)
    raise ValueError(f"no reader registered for {path!r} "
                     f"(available: {sorted(_READERS)})")


register_reader(".npy", lambda p: np.load(p))
register_reader(".npz", lambda p: np.load(p)["vol"])
register_reader(".nrrd", lambda p: read_nrrd(p)[0])
register_reader(".nii", read_nifti)
register_reader(".nii.gz", read_nifti)
register_reader(".hdr", read_nifti)  # the detached .hdr/.img pair


@dataclass
class Subject:
    """One imaging subject: ordered modality paths and a mask path."""

    modality_paths: List[str]
    mask_path: Optional[str] = None
    name: str = ""

    def load(self):
        """``(volumes, mask)`` as ``read_volume`` reads them (mask None
        without a mask path)."""
        vols = [read_volume(p) for p in self.modality_paths]
        mask = read_volume(self.mask_path) if self.mask_path else None
        return vols, mask


@dataclass
class SubjectRegistry:
    """The subjects of a dataset, in order (the reference's per-dataset
    ``extract_*_data_path`` functions as one declarative registry)."""

    subjects: List[Subject] = field(default_factory=list)

    @classmethod
    def from_dir(cls, root: str, modalities: List[str],
                 mask_name: str) -> "SubjectRegistry":
        """Each subdirectory of ``root`` (in sorted order) that holds every
        file of ``modalities`` is a subject named after it; its mask is
        ``mask_name`` there, or None when that file is missing."""
        subs = []
        for d in sorted(os.listdir(root)):
            sdir = os.path.join(root, d)
            if not os.path.isdir(sdir):
                continue
            mods = [os.path.join(sdir, m) for m in modalities]
            mask = os.path.join(sdir, mask_name)
            if all(os.path.exists(p) for p in mods):
                subs.append(Subject(mods, mask if os.path.exists(mask)
                                    else None, d))
        return cls(subs)

    @classmethod
    def from_lists(cls, img_paths: List[List[str]],
                   mask_paths: List[str]) -> "SubjectRegistry":
        """Subject ``i`` (named ``str(i)``) has the modality paths
        ``img_paths[i]`` and the mask ``mask_paths[i]``."""
        return cls([Subject(list(m), mk, str(i))
                    for i, (m, mk) in enumerate(zip(img_paths, mask_paths))])


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


def write_synthetic_dataset(root: str, n_subjects: int = 2,
                            **kwargs) -> SubjectRegistry:
    """Write ``n_subjects`` synthetic subjects (seeds 0, 1, ...) as
    ``<root>/sub<i>/mod<j>.npy`` and ``mask.npy``; returns their
    registry.  ``kwargs`` go to :func:`synthetic_subject`."""
    subs = []
    for i in range(n_subjects):
        sdir = os.path.join(root, f"sub{i}")
        os.makedirs(sdir, exist_ok=True)
        vols, mask = synthetic_subject(seed=i, **kwargs)
        mods = []
        for j, v in enumerate(vols):
            p = os.path.join(sdir, f"mod{j}.npy")
            np.save(p, v)
            mods.append(p)
        mp = os.path.join(sdir, "mask.npy")
        np.save(mp, mask)
        subs.append(Subject(mods, mp, f"sub{i}"))
    return SubjectRegistry(subs)
