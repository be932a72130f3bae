"""Disk-backed classification pools (counterpart of
``nnal_tpu/data/image_pool.py``, copied: the module is numpy-only).

Rebuild of ``load_winds`` (reference NN.py:1479-1527): the pool is a text
file of image paths (+ a parallel labels file), batches are loaded on
demand, resized to a target shape and mean-subtracted.  The engine consumes
pools through one small interface so in-memory arrays (tests, MNIST-style
harnesses) and disk-backed path lists (Caltech-style datasets) are
interchangeable.  Pools stay host numpy; the classification scoring moves
each chunk to the model's device (``scoring/cls_strategies``;
``InMemoryPool.images`` lets it gather an in-memory pool's rows itself).
``cv2`` is imported only when an image is read.
"""

from __future__ import annotations

import linecache
from typing import Optional, Tuple

import numpy as np


def load_winds(inds, imgs_path_file: str, target_shape,
               mean: Optional[float] = None,
               labels_file: Optional[str] = None):
    """Batch image load via a path-list file (reference ``load_winds``,
    NN.py:1479): line ``i+1`` of ``imgs_path_file`` holds sample ``i``'s
    image path; images are resized to ``target_shape`` and optionally
    mean-subtracted.  Returns ``(batch, labels)`` with labels ``[]`` when
    no labels file is given."""
    import cv2

    inds = np.asarray(inds, np.int64)
    target_shape = tuple(target_shape)
    batch = None
    labels = []
    for i, ind in enumerate(inds):
        path = linecache.getline(imgs_path_file,
                                 int(ind) + 1).splitlines()[0]
        img = np.float64(cv2.imread(path))
        img = cv2.resize(img, target_shape)
        if mean:
            img -= mean
        if batch is None:
            batch = np.zeros((len(inds),) + img.shape)
        batch[i] = img
        if labels_file:
            line = linecache.getline(labels_file,
                                     int(ind) + 1).splitlines()[0]
            labels.append(int(line))
    return batch, labels


class ImagePathPool:
    """Pool over a path-list file + labels file (lazy, disk-backed)."""

    def __init__(self, imgs_path_file: str, labels_file: str,
                 target_shape, mean: Optional[float] = None):
        self.imgs_path_file = imgs_path_file
        self.labels_file = labels_file
        self.target_shape = tuple(target_shape)
        self.mean = mean
        with open(imgs_path_file) as f:
            self._n = sum(1 for line in f if line.strip())
        self._labels = np.loadtxt(labels_file, dtype=np.int64, ndmin=1)

    def __len__(self) -> int:
        return self._n

    @property
    def labels(self) -> np.ndarray:
        return self._labels

    @property
    def input_shape(self) -> Tuple[int, ...]:
        x, _ = self.fetch(np.array([0]))
        return tuple(x.shape[1:])

    def fetch(self, inds) -> Tuple[np.ndarray, np.ndarray]:
        x, labels = load_winds(inds, self.imgs_path_file,
                               self.target_shape, self.mean,
                               self.labels_file)
        return np.asarray(x, np.float32), np.asarray(labels, np.int64)


class InMemoryPool:
    """Array-backed pool with the same interface."""

    def __init__(self, X, labels):
        self._X = np.asarray(X, np.float32)
        self._labels = np.asarray(labels, np.int64)

    def __len__(self) -> int:
        return self._X.shape[0]

    @property
    def labels(self) -> np.ndarray:
        return self._labels

    @property
    def input_shape(self):
        return tuple(self._X.shape[1:])

    @property
    def images(self) -> np.ndarray:
        """The (n, ...) float32 images, for readers that gather rows
        themselves (``scoring/cls_strategies``' pinned staging)."""
        return self._X

    def fetch(self, inds):
        inds = np.asarray(inds, np.int64)
        return self._X[inds], self._labels[inds]


class LazyPoolView:
    """Array-like view of ``pool`` restricted to ``inds`` — supports just
    enough indexing (``shape``, ``len``, slice / fancy ``__getitem__``) for
    the query strategies to treat a disk-backed pool as an array, loading
    batches on demand (the reference's per-batch ``load_winds`` pattern)."""

    def __init__(self, pool, inds):
        self.pool = pool
        self.inds = np.asarray(inds, np.int64)

    @property
    def shape(self):
        return (len(self.inds),) + tuple(self.pool.input_shape)

    def __len__(self) -> int:
        return len(self.inds)

    def __getitem__(self, key):
        sub = np.atleast_1d(self.inds[key])
        return self.pool.fetch(sub)[0]


def write_path_pool(root_dir: str, image_paths, labels) -> Tuple[str, str]:
    """Persist a (paths, labels) pool as the reference's two text files."""
    import os

    p = os.path.join(root_dir, "img_paths.txt")
    l = os.path.join(root_dir, "labels.txt")
    with open(p, "w") as f:
        f.write("\n".join(image_paths) + "\n")
    np.savetxt(l, np.asarray(labels, np.int64), fmt="%d")
    return p, l


def folder_class_paths(path: str, folders=None):
    """(paths, labels) from a folder-per-class image directory (reference
    ``prepare_data_4Alex``, NNAL_tools.py:899-924, which eagerly
    ``cv2.imread`` everything; here the list feeds the disk-backed
    ``ImagePathPool`` via ``write_path_pool`` so images load on demand).
    Class ``i`` is the ``i``-th entry of ``folders`` (sorted directory
    listing when omitted)."""
    import os

    if folders is None:
        folders = sorted(d for d in os.listdir(path)
                         if os.path.isdir(os.path.join(path, d)))
    paths, labels = [], []
    for i, folder in enumerate(folders):
        for fname in sorted(os.listdir(os.path.join(path, folder))):
            paths.append(os.path.join(path, folder, fname))
            labels.append(i)
    return paths, np.asarray(labels, np.int64)
