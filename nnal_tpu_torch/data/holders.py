"""Data holders: subject-level splits + training batch assembly (the
port's numpy copy of ``nnal_tpu/data/holders.py``).

Rebuild of ``datasets/data_holders.py`` (reference lines 10-415): the
``regular`` holder splits subjects into labeled(train)/unlabeled/valid/test
partitions (``LUV_inds_or_sizes`` semantics: explicit index lists or sizes
drawn at random), caches volumes in memory, remaps labels, and exposes
eternal mixed labeled/unlabeled minibatch generators; the ``D3`` variant
yields 3D sub-volumes with a depth margin.  Batch assembly mirrors
``prepare_batch_BrVol`` (datasets/utils.py:93-202): per-sample slice choice,
random crop to the target shape, one-hot masks with NaN rows for unlabeled
samples.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from nnal_tpu_torch.data.batching import (
    gen_minibatch_labeled_unlabeled_inds,
    random_crop,
)


def prepare_batch_brvol(imgs: Sequence, masks: Sequence,
                        img_shape: Tuple[int, int], rng,
                        one_hot_channels: Optional[int] = None,
                        slice_choice: str = "uniform",
                        labeled_indic: Optional[np.ndarray] = None,
                        depth: Optional[int] = None):
    """Assemble a batch of axial slices (or 3D sub-volumes when ``depth``)
    from brain volumes (reference ``prepare_batch_BrVol``).

    Returns ``(batch_X (b, H, W, [depth,] m), batch_mask)`` where the mask
    is one-hot ``(b, H, W, c)`` with NaN for unlabeled samples when
    ``labeled_indic`` marks them 0.
    """
    b = len(imgs)
    m = len(imgs[0])
    H, W = img_shape
    xs, ys = [], []
    for i in range(b):
        vol0 = np.asarray(imgs[i][0])
        nz = vol0.shape[2]
        if depth is None:
            if slice_choice == "uniform":
                z = int(rng.integers(0, nz))
            elif slice_choice == "middle":
                z = nz // 2
            else:
                raise ValueError(slice_choice)
            planes = [np.asarray(v)[:, :, z] for v in imgs[i]]
            mask_pl = np.asarray(masks[i])[:, :, z]
        else:
            zr = depth // 2
            vols_i = [np.asarray(v) for v in imgs[i]]
            mask_i = np.asarray(masks[i])
            if nz < depth:
                # thin sub-volumes (e.g. few queried slices) are
                # edge-padded up to the depth margin
                pad = depth - nz
                vols_i = [np.pad(v, ((0, 0), (0, 0), (0, pad)),
                                 mode="edge") for v in vols_i]
                mask_i = np.pad(mask_i, ((0, 0), (0, 0), (0, pad)),
                                mode="edge")
                nz = depth
            z = int(rng.integers(zr, nz - zr))
            planes = [v[:, :, z - zr:z + zr + 1] for v in vols_i]
            mask_pl = mask_i[:, :, z]

        crop0, ih, iw = random_crop(planes[0], H, W, rng)
        planes = [crop0] + [random_crop(p, H, W, rng, ih, iw)[0]
                            for p in planes[1:]]
        mask_pl = random_crop(mask_pl, H, W, rng, ih, iw)[0]
        x = np.stack(planes, axis=-1)
        xs.append(x)

        if one_hot_channels:
            oh = np.zeros((H, W, one_hot_channels), np.float32)
            valid = ~np.isnan(mask_pl)
            lab = np.zeros_like(mask_pl, dtype=np.int64)
            lab[valid] = mask_pl[valid].astype(np.int64)
            for c in range(one_hot_channels):
                oh[:, :, c] = (lab == c) & valid
            oh[~valid] = np.nan
            if labeled_indic is not None and labeled_indic[i] == 0:
                oh[:] = np.nan   # wholly unlabeled sample
            ys.append(oh)
        else:
            ys.append(mask_pl)
    return np.stack(xs).astype(np.float32), np.stack(ys)


class RegularHolder:
    """Subject-level data holder (reference ``regular``,
    datasets/data_holders.py:10-266)."""

    def __init__(self, subjects: Sequence, luv: Sequence, rng,
                 label_map: Optional[Dict[int, int]] = None,
                 test_rest: bool = True):
        """``subjects``: list of ``(modality_vols, mask)``; ``luv``:
        (labeled, unlabeled, valid) — each an explicit index list or an int
        size drawn randomly (the reference's ``LUV_inds_or_sizes``);
        remaining subjects become the test partition."""
        self.subjects = list(subjects)
        n = len(self.subjects)
        order = list(rng.permutation(n))
        parts = []
        for spec_part in luv:
            if isinstance(spec_part, (list, np.ndarray)):
                chosen = [int(i) for i in spec_part]
                order = [i for i in order if i not in chosen]
            else:
                chosen, order = order[:spec_part], order[spec_part:]
            parts.append(sorted(chosen))
        self.labeled_inds, self.unlabeled_inds, self.valid_inds = parts
        self.test_inds = sorted(order) if test_rest else []
        self.label_map = label_map
        self._cache: Dict[int, Tuple] = {}

    # ------------------------------------------------------------- access
    def load(self, i: int):
        if i not in self._cache:
            vols, mask = self.subjects[i]
            mask = np.asarray(mask, np.float64)
            if self.label_map:
                remapped = mask.copy()
                for old, new in self.label_map.items():
                    remapped[mask == old] = new
                mask = remapped
            self._cache[i] = ([np.asarray(v) for v in vols], mask)
        return self._cache[i]

    def combine(self, other: "RegularHolder") -> None:
        """Concatenate another holder's subjects (reference data-set
        concatenation)."""
        off = len(self.subjects)
        self.subjects += other.subjects
        self.labeled_inds += [i + off for i in other.labeled_inds]
        self.unlabeled_inds += [i + off for i in other.unlabeled_inds]
        self.valid_inds += [i + off for i in other.valid_inds]
        self.test_inds += [i + off for i in other.test_inds]

    # ------------------------------------------------------------- gens
    def create_train_valid_gens(self, batch_size: int, img_shape,
                                nclass: int, rng,
                                n_labeled: Optional[int] = None,
                                depth: Optional[int] = None):
        """Eternal train generator over labeled+unlabeled subjects and a
        finite-epoch valid generator (reference
        ``create_train_valid_gens``, datasets/data_holders.py:130-209)."""
        pool = self.labeled_inds + self.unlabeled_inds
        L_indic = np.array([1] * len(self.labeled_inds)
                           + [0] * len(self.unlabeled_inds))
        ind_gen = gen_minibatch_labeled_unlabeled_inds(
            L_indic, batch_size, rng, n_labeled=n_labeled)

        def train_gen():
            while True:
                groups = next(ind_gen)
                inds = np.concatenate([g for g in groups if g is not None])
                subj = [pool[j] for j in inds]
                imgs = [self.load(s)[0] for s in subj]
                masks = [self.load(s)[1] for s in subj]
                indic = L_indic[inds]
                yield prepare_batch_brvol(imgs, masks, img_shape, rng,
                                          one_hot_channels=nclass,
                                          labeled_indic=indic,
                                          depth=depth)

        def valid_gen():
            for s in self.valid_inds:
                vols, mask = self.load(s)
                yield prepare_batch_brvol([vols], [mask], img_shape, rng,
                                          one_hot_channels=nclass,
                                          depth=depth)

        return train_gen(), valid_gen


class D3Holder(RegularHolder):
    """3D variant: generators yield depth-margin sub-volumes (reference
    ``D3``, datasets/data_holders.py:268-359)."""

    def __init__(self, *args, depth: int = 5, **kw):
        super().__init__(*args, **kw)
        assert depth % 2 == 1, "depth must be odd (symmetric margin)"
        self.depth = depth

    def create_train_valid_gens(self, batch_size, img_shape, nclass, rng,
                                n_labeled=None, depth=None):
        return super().create_train_valid_gens(
            batch_size, img_shape, nclass, rng, n_labeled,
            depth=self.depth)


def get_dat_for_ft(holder: RegularHolder, slice_img_inds,
                   keep_unlabeled: bool = False) -> RegularHolder:
    """Build a finetuning holder where queried slices of the unlabeled
    subjects become labeled sub-volumes (reference ``get_dat_for_FT``,
    datasets/data_holders.py:360-415): slice ``slice_img_inds[j]`` of
    unlabeled subject ``j`` is 'expert-labeled' via the available ground
    truth; with ``keep_unlabeled`` the remaining slices stay as unlabeled
    subjects.  Valid subjects carry over; label remapping is baked in."""
    assert len(slice_img_inds) == len(holder.unlabeled_inds), (
        "one slice-index array per unlabeled subject required")
    new_labeled = [holder.load(i) for i in holder.labeled_inds]
    new_unlab = []
    for j, si in enumerate(holder.unlabeled_inds):
        sl = np.asarray(slice_img_inds[j], np.int64)
        if len(sl) == 0:
            continue
        vols, mask = holder.load(si)
        new_labeled.append(([np.asarray(v)[:, :, sl] for v in vols],
                            mask[:, :, sl]))
        if keep_unlabeled:
            rest = np.delete(np.arange(mask.shape[2]), sl)
            if len(rest):
                new_unlab.append(([np.asarray(v)[:, :, rest]
                                   for v in vols], mask[:, :, rest]))
    valid = [holder.load(i) for i in holder.valid_inds]
    subjects = new_labeled + new_unlab + valid
    new = object.__new__(type(holder))
    new.subjects = subjects
    new.labeled_inds = list(range(len(new_labeled)))
    new.unlabeled_inds = list(range(len(new_labeled),
                                    len(new_labeled) + len(new_unlab)))
    new.valid_inds = list(range(len(new_labeled) + len(new_unlab),
                                len(subjects)))
    new.test_inds = []
    new.label_map = None      # holder.load already applied the remap
    new._cache = {}
    if isinstance(holder, D3Holder):
        new.depth = holder.depth
    return new


def lesion_patch_gen(imgs, masks, legal_inds, square_patch_size: int,
                     patch_num: int, rng):
    """Eternal lesion-patch generator (reference datasets/utils.py:296):
    random subjects, random legal center voxels, (s, s, m) patches."""
    s = len(imgs)
    m = len(imgs[0])
    half = square_patch_size // 2
    while True:
        sub_inds = rng.integers(0, s, patch_num)
        coords = []
        for i in sub_inds:
            j = int(rng.integers(0, len(legal_inds[i][0])))
            coords.append(tuple(legal_inds[i][k][j] for k in range(3)))
        patches = np.stack([
            np.stack([np.asarray(imgs[si][j])[
                c[0] - half:c[0] + half + 1,
                c[1] - half:c[1] + half + 1, c[2]]
                for j in range(m)], axis=2)
            for si, c in zip(sub_inds, coords)])
        yield patches, sub_inds, coords
