"""The port's host data path vs the JAX package's (CPU): its copy of
``runtime/patch_gather.cc`` (built with ``g++`` into ``_build/``) against
the JAX package's ``gather_patches_native`` and K2's plain version, the
prefetch loader's batches and error propagation, and the holders' splits
and batches for the same seeds.

Tolerances: the two native gathers and the labels bit for bit; the native
gather within 1 ulp of K2's plain version (``(x - mu) * (1 / sd)``
against ``(x - mu) / sd``); the loader's and the holders' batches exactly
equal."""

import numpy as np
import pytest
import torch

from nnal_tpu.data import holders as jh
from nnal_tpu.runtime.native import gather_labels_native as j_labels
from nnal_tpu.runtime.native import gather_patches_native as j_gather
from nnal_tpu_torch.data import holders as th
from nnal_tpu_torch.data.io import synthetic_subject
from nnal_tpu_torch.data.loaders import (
    PrefetchLoader,
    patch_batch_source,
    prefetched_patch_batches,
)
from nnal_tpu_torch.data.patches import gather_patches_normalized, pad_volumes
from nnal_tpu_torch.runtime import native

torch.set_num_threads(1)

SHAPE = (18, 20, 7)


def _volumes(patch_shape, n=60, seed=0):
    rng = np.random.default_rng(seed)
    vols = [rng.normal(size=SHAPE) * 40 + 100, rng.normal(size=SHAPE) * 2 + 1]
    mask = (rng.random(SHAPE) > 0.7).astype(np.float64)
    padded = pad_volumes(vols, patch_shape, device="cpu")
    inds = rng.choice(np.prod(SHAPE), size=n, replace=False)
    return padded, [padded[j].numpy() for j in range(2)], mask, inds


@pytest.mark.parametrize("patch_shape", [(5, 5, 1), (9, 9, 3), (25, 25, 1)])
def test_native_gather_matches_jax_and_k2(patch_shape):
    padded, host, _, inds = _volumes(patch_shape)
    mu, sd = np.array([100.0, 1.0]), np.array([40.0, 2.0])
    got = native.gather_patches_native(host, inds, patch_shape, SHAPE, mu,
                                       sd)
    want = j_gather(host, inds, patch_shape, SHAPE, mu, sd)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    k2 = gather_patches_normalized(
        padded, torch.from_numpy(inds.astype(np.int64)),
        torch.tensor(mu, dtype=torch.float32),
        torch.tensor(sd, dtype=torch.float32), patch_shape, SHAPE).numpy()
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(k2)))
    assert np.all(np.abs(got - k2) <= ulp)


def test_native_labels_match_jax():
    _, _, mask, inds = _volumes((5, 5, 1))
    got = native.gather_labels_native(mask, inds)
    np.testing.assert_array_equal(got, j_labels(mask, inds))
    np.testing.assert_array_equal(got, mask.reshape(-1)[inds])


def test_native_library_is_built_into_the_build_dir():
    lib = native.load()
    assert "_build" in lib._name and "patch_gather-" in lib._name
    with pytest.raises(ValueError, match="one shape"):
        native.gather_patches_native([np.zeros((4, 4, 4)),
                                      np.zeros((4, 4, 5))], [0],
                                     (1, 1, 1), (4, 4, 4), [0, 0], [1, 1])


def test_loader_batches_equal_the_source_and_cover_the_epochs():
    _, host, mask, inds = _volumes((5, 5, 1), n=40)
    args = (host, mask, inds, (5, 5, 1), SHAPE, [100.0, 1.0], [40.0, 2.0],
            16, 2)
    want = list(patch_batch_source(*args, np.random.default_rng(0),
                                   epochs=2))
    loader = prefetched_patch_batches(*args, np.random.default_rng(0),
                                      epochs=2, device="cpu")
    got = list(loader)
    assert len(got) == len(want) == 6       # 2 x (16, 16, the last 8)
    for (x, y), (wx, wy) in zip(got, want):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), wx)
        np.testing.assert_array_equal(y.numpy(), wy)
    assert sum(x.shape[0] for x, _ in got) == 2 * 40


def test_loader_propagates_worker_errors():
    def bad():
        yield np.zeros((2, 2), np.float32), np.ones((2, 2), np.float32)
        raise RuntimeError("boom")

    loader = PrefetchLoader(bad(), depth=1, device="cpu")
    x, y = next(loader)
    assert torch.equal(y, torch.ones(2, 2))
    with pytest.raises(RuntimeError, match="boom"):
        next(loader)
    single = PrefetchLoader(iter([np.arange(3)]), device="cpu")
    assert torch.equal(next(single), torch.arange(3))
    with pytest.raises(StopIteration):
        next(single)


def _subjects(n, shape=(20, 20, 6), seed0=0):
    return [synthetic_subject(shape=shape, n_modalities=2, seed=seed0 + i)
            for i in range(n)]


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("luv", [(2, 2, 1), ([0, 3], 1, [5])])
def test_regular_holder_matches_jax(luv):
    subs = _subjects(6)
    got = th.RegularHolder(subs, luv=luv, rng=np.random.default_rng(2),
                           label_map={1: 3})
    want = jh.RegularHolder(subs, luv=luv, rng=np.random.default_rng(2),
                            label_map={1: 3})
    for part in ("labeled_inds", "unlabeled_inds", "valid_inds",
                 "test_inds"):
        assert getattr(got, part) == getattr(want, part)
    _same(got.load(1)[1], want.load(1)[1])
    gens = [h.create_train_valid_gens(4, (16, 16), 2,
                                      np.random.default_rng(7), n_labeled=2)
            for h in (got, want)]
    for _ in range(3):
        (x, y), (wx, wy) = next(gens[0][0]), next(gens[1][0])
        _same(x, wx)
        _same(y, wy)
    for (x, y), (wx, wy) in zip(gens[0][1](), gens[1][1]()):
        _same(x, wx)
        _same(y, wy)


def test_d3_holder_ft_holder_and_lesion_patches_match_jax():
    subs = _subjects(4, shape=(16, 16, 9))
    got = th.D3Holder(subs, luv=(1, 2, 1), rng=np.random.default_rng(3),
                      depth=3)
    want = jh.D3Holder(subs, luv=(1, 2, 1), rng=np.random.default_rng(3),
                       depth=3)
    (x, y), (wx, wy) = [next(h.create_train_valid_gens(
        2, (12, 12), 2, np.random.default_rng(4), n_labeled=1)[0])
        for h in (got, want)]
    assert x.shape == (2, 12, 12, 3, 2)
    _same(x, wx)
    _same(y, wy)
    ft, wft = [th.get_dat_for_ft(got, [[1, 4], [2]], keep_unlabeled=True),
               jh.get_dat_for_ft(want, [[1, 4], [2]], keep_unlabeled=True)]
    assert isinstance(ft, th.D3Holder) and ft.depth == 3
    assert (ft.labeled_inds, ft.unlabeled_inds, ft.valid_inds) == (
        wft.labeled_inds, wft.unlabeled_inds, wft.valid_inds)
    for (v, m), (wv, wm) in zip(ft.subjects, wft.subjects):
        _same(m, wm)
        for a, b in zip(v, wv):
            _same(a, b)
    legal = []
    for vols, mask in subs:
        x, y, z = np.where(np.nan_to_num(mask) > 0)
        keep = (x > 2) & (x < 13) & (y > 2) & (y < 13)
        legal.append((x[keep], y[keep], z[keep]))
    imgs, masks = [s[0] for s in subs], [s[1] for s in subs]
    g = th.lesion_patch_gen(imgs, masks, legal, 5, 4,
                            np.random.default_rng(5))
    w = jh.lesion_patch_gen(imgs, masks, legal, 5, 4,
                            np.random.default_rng(5))
    for _ in range(2):
        (p, s, c), (wp, ws, wc) = next(g), next(w)
        _same(p, wp)
        _same(s, ws)
        assert c == wc
