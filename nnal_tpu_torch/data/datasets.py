"""Named dataset conventions (counterpart of ``nnal_tpu/data/datasets.py``).

The reference hard-codes seven dataset path extractors with
cluster-specific roots (datasets/path_loader.py:5-367: Hakim adolescents,
dHCP newborns, ACE/TSCR lesion, NVM, ISBI-2015 MS lesion, iSeg-2017,
Grand-Challenge-2016) and an eighth for Crohn's bowel walls.  Here each
dataset is a convention, its modality file names and its mask name,
applied to any root directory through
:meth:`~nnal_tpu_torch.data.io.SubjectRegistry.from_dir`; the table is a
copy of the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from nnal_tpu_torch.data.io import SubjectRegistry


@dataclass(frozen=True)
class DatasetConvention:
    name: str
    modalities: List[str]          # per-subject file names, in order
    mask: str
    notes: str = ""


CONVENTIONS: Dict[str, DatasetConvention] = {
    "hakim": DatasetConvention(
        "hakim", ["T1.nrrd", "T2.nrrd"], "mask.nrrd",
        "adolescent brain MRI, T1+T2 (reference path_loader.py:5)"),
    "dhcp": DatasetConvention(
        "dhcp", ["T1.nrrd", "T2.nrrd"], "mask.nrrd",
        "newborn dHCP volumes (reference path_loader.py:54)"),
    "ace_tscr": DatasetConvention(
        "ace_tscr", ["FLAIR.nrrd"], "lesion_mask.nrrd",
        "ACE/TSCR lesion (reference path_loader.py:142)"),
    "nvm": DatasetConvention(
        "nvm", ["T1.nrrd"], "mask.nrrd",
        "NVM (reference path_loader.py:225)"),
    "isbi2015": DatasetConvention(
        "isbi2015", ["flair.nii", "mprage.nii", "t2.nii"], "mask1.nii",
        "ISBI-2015 MS lesion challenge (reference path_loader.py:284)"),
    "iseg2017": DatasetConvention(
        "iseg2017", ["T1.nii", "T2.nii"], "label.nii",
        "iSeg-2017 infant segmentation (reference path_loader.py:315)"),
    "grand2016": DatasetConvention(
        "grand2016", ["FLAIR.nii", "T1.nii"], "wmh.nii",
        "Grand-Challenge-2016 WMH (reference path_loader.py:353)"),
    "crohns": DatasetConvention(
        "crohns", ["img.nrrd"], "wall_label.nrrd",
        "unimodal Crohns bowel-wall (reference "
        "patch_utils.py:577 extract_Crohns_data_path: one "
        "directory per subject with img.nrrd + wall_label.nrrd)"),
}


def registry_for(dataset: str, root: str) -> SubjectRegistry:
    """The subjects of the named dataset under ``root`` (one subdirectory
    per subject, files named per its convention); an unknown name raises
    ``KeyError``."""
    conv = CONVENTIONS[dataset]
    return SubjectRegistry.from_dir(root, conv.modalities, conv.mask)
