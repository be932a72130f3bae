"""K2's plain version (the port's gather on a CPU tensor) vs the JAX
package's ``gather_patches_normalized`` and its Pallas kernel in interpret
mode.  Exact equality: one copy, one subtract and one IEEE divide per
element in every implementation."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnal_tpu.data.patches import gather_patches_normalized as j_gather
from nnal_tpu.data.patches import pad_volumes as j_pad
from nnal_tpu.ops.gather_pallas import gather_patches_pallas
from nnal_tpu_torch.data.patches import (
    gather_labels,
    gather_patches_normalized,
    pad_volumes,
)
from nnal_tpu_torch.ops import gather as k2

torch.set_num_threads(1)

SHAPE = (20, 22, 8)


def _inputs(patch_shape, n=200, seed=1):
    rng = np.random.default_rng(seed)
    vols = [rng.normal(size=SHAPE), rng.normal(size=SHAPE) + 3]
    inds = rng.choice(np.prod(SHAPE), size=n, replace=False).astype(np.int64)
    mu = np.array([0.1, 3.0], np.float32)
    sd = np.array([1.3, 2.0], np.float32)
    return vols, inds, mu, sd


def _port(vols, inds, mu, sd, patch_shape):
    return gather_patches_normalized(
        pad_volumes(vols, patch_shape, device="cpu"),
        torch.from_numpy(inds), torch.from_numpy(mu), torch.from_numpy(sd),
        patch_shape, SHAPE).numpy()


def test_pad_volumes_matches_jax():
    vols, _, _, _ = _inputs((5, 5, 3))
    np.testing.assert_array_equal(
        pad_volumes(vols, (5, 5, 3), device="cpu").numpy(),
        np.asarray(j_pad(vols, (5, 5, 3))))
    assert pad_volumes(vols, (5, 5, 3), device="cpu").dtype == torch.float32


# d3 = 1 and d3 = 3; even dims (4, 6, 2) exercise the clamped window
# start of lax.dynamic_slice at the volume border
@pytest.mark.parametrize("patch_shape", [(5, 5, 1), (5, 5, 3), (4, 6, 1),
                                         (3, 3, 2), (6, 4, 4)])
def test_plain_gather_equals_jax_gather(patch_shape):
    vols, inds, mu, sd = _inputs(patch_shape)
    want = np.asarray(j_gather(j_pad(vols, patch_shape), jnp.asarray(inds),
                               mu, sd, patch_shape, SHAPE))
    got = _port(vols, inds, mu, sd, patch_shape)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_plain_gather_equals_pallas_kernel_interpret():
    patch_shape = (5, 5, 1)
    vols, inds, mu, sd = _inputs(patch_shape)
    want = np.asarray(gather_patches_pallas(
        j_pad(vols, patch_shape), jnp.asarray(inds), mu, sd, patch_shape,
        SHAPE, interpret=True))
    np.testing.assert_array_equal(_port(vols, inds, mu, sd, patch_shape),
                                  want)


def test_border_voxels_clamp_like_dynamic_slice():
    patch_shape = (4, 4, 2)
    vols, _, mu, sd = _inputs(patch_shape)
    corners = np.array([0, np.prod(SHAPE) - 1, SHAPE[2] - 1,
                        (SHAPE[0] - 1) * SHAPE[1] * SHAPE[2]], np.int64)
    want = np.asarray(j_gather(j_pad(vols, patch_shape),
                               jnp.asarray(corners), mu, sd, patch_shape,
                               SHAPE))
    np.testing.assert_array_equal(
        _port(vols, corners, mu, sd, patch_shape), want)


def test_cpu_gather_uses_plain_version_and_counts_nothing():
    vols, inds, mu, sd = _inputs((5, 5, 1))
    before = k2.KERNEL.launches
    _port(vols, inds, mu, sd, (5, 5, 1))
    assert k2.KERNEL.launches == before


def test_wrapper_rejects_bad_inputs():
    padded = pad_volumes(_inputs((5, 5, 1))[0], (5, 5, 1), device="cpu")
    mu = sd = torch.ones(2)
    with pytest.raises(ValueError, match="int64"):
        gather_patches_normalized(padded, torch.zeros(3, dtype=torch.int32),
                                  mu, sd, (5, 5, 1), SHAPE)
    with pytest.raises(ValueError, match="float32"):
        gather_patches_normalized(padded.double(),
                                  torch.zeros(3, dtype=torch.int64), mu, sd,
                                  (5, 5, 1), SHAPE)
    with pytest.raises(ValueError, match="mu/sd"):
        gather_patches_normalized(padded, torch.zeros(3, dtype=torch.int64),
                                  torch.ones(3), sd, (5, 5, 1), SHAPE)
    # a device that is neither the host nor CUDA: no silent plain path
    meta = padded.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gather_patches_normalized(
            meta, torch.zeros(3, dtype=torch.int64, device="meta"),
            mu.to("meta"), sd.to("meta"), (5, 5, 1), SHAPE)


def test_gather_labels_reads_the_host_mask():
    mask = np.arange(np.prod(SHAPE)).reshape(SHAPE) % 2
    inds = np.array([0, 1, 5, 17])
    np.testing.assert_array_equal(gather_labels(mask, inds, SHAPE),
                                  inds % 2)


# --- the y-contiguous copy (m, D1p, D3p, D2p) that the kernel reads


@pytest.mark.parametrize("patch_shape", [(25, 25, 1), (25, 25, 3),
                                         (24, 24, 1)])
def test_plain_gather_through_y_copy_is_bit_equal(patch_shape):
    vols, inds, mu, sd = _inputs(patch_shape)
    padded = pad_volumes(vols, patch_shape, device="cpu")
    args = (torch.from_numpy(inds), torch.from_numpy(mu),
            torch.from_numpy(sd), patch_shape, SHAPE)
    # the plain version read through the copy, viewed back as (m, D1p,
    # D2p, D3p): the copy holds every voxel where the kernel looks for it
    yvol = k2.y_contiguous(padded)
    assert yvol.shape == (padded.shape[0], padded.shape[1],
                          padded.shape[3], padded.shape[2])
    got = k2.gather_patches_plain(yvol.permute(0, 1, 3, 2), *args).numpy()
    np.testing.assert_array_equal(
        got, k2.gather_patches_plain(padded, *args).numpy())
    want = np.asarray(j_gather(j_pad(vols, patch_shape), jnp.asarray(inds),
                               mu, sd, patch_shape, SHAPE))
    np.testing.assert_array_equal(got, want)


def test_y_copy_is_made_once_per_volume_and_rebuilt_after_edits():
    vols, _, _, _ = _inputs((5, 5, 1))
    padded = pad_volumes(vols, (5, 5, 1), device="cpu")
    y = k2.y_contiguous(padded)
    assert y.is_contiguous() and y.shape == (2, 24, 8, 26)
    assert torch.equal(y, padded.permute(0, 1, 3, 2))
    assert k2.y_contiguous(padded) is y          # made once
    padded.add_(1.0)                             # in-place edit
    y2 = k2.y_contiguous(padded)
    assert y2 is not y
    assert torch.equal(y2, padded.permute(0, 1, 3, 2))
    assert k2.y_contiguous(padded) is y2
    other = pad_volumes(vols, (5, 5, 1), device="cpu")   # a new volume
    assert k2.y_contiguous(other) is not y2


def test_y_copy_cache_keeps_one_entry_per_volume():
    """Alternating gathers from two volumes (a multi-subject finetune's
    order) build each copy once: 2 rebuilds, not one per call; past
    ``YCACHE_SIZE`` volumes the least recently used goes."""
    vols, _, _, _ = _inputs((5, 5, 1))
    a = pad_volumes(vols, (5, 5, 1), device="cpu")
    b = pad_volumes(vols[::-1], (5, 5, 1), device="cpu")
    k2.reset_ycache_stats()
    ya, yb = k2.y_contiguous(a), k2.y_contiguous(b)
    for _ in range(3):
        assert k2.y_contiguous(a) is ya and k2.y_contiguous(b) is yb
    assert k2.YCACHE_STATS == {"rebuilds": 2, "volumes": 2}
    more = [pad_volumes(vols, (5, 5, 1), device="cpu")
            for _ in range(k2.YCACHE_SIZE - 2)]
    for v in more:                            # fills the cache
        k2.y_contiguous(v)
    assert k2.y_contiguous(b) is yb           # b is now the newest
    k2.y_contiguous(pad_volumes(vols, (5, 5, 1), device="cpu"))
    assert k2.y_contiguous(b) is yb
    assert k2.y_contiguous(a) is not ya       # a was the oldest: rebuilt
    assert k2.YCACHE_STATS == {"rebuilds": k2.YCACHE_SIZE + 2,
                               "volumes": k2.YCACHE_SIZE + 1}
