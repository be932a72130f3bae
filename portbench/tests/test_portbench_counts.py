"""The frozen counters, and the plain reference against the program's
forward at a tiny size on the CPU."""

import numpy as np
import pytest
import torch

import tiny  # noqa: F401  (puts the benchmark on sys.path)
import inputs
from reference import counts, draws, fcd103, patches, pw1


def test_pw1_flops_per_patch():
    assert counts.pw1_flops((25, 25), 2, 2) == 116_296_032
    # the fcs are 62% of it
    fc = 2 * (7 * 7 * 96 * 4096 + 4096 * 4096 + 4096 * 2)
    assert round(fc / 116_296_032, 2) == 0.62


def test_fcd103_flops_per_slice():
    f128 = counts.fcd103_flops((128, 128), 2, 2)
    assert round(f128 / 1e9, 1) == 13.0
    assert counts.fcd103_flops((256, 256), 2, 2) == 4 * f128


def test_parameter_counts():
    assert sum(int(np.prod(s)) for s in
               pw1.param_shapes((25, 25), 2, 2).values()) == 36_137_082
    assert sum(int(np.prod(s)) for s in
               fcd103.param_shapes(2, 2).values()) == 9_319_346


def test_gather_bytes_hand_count():
    # one 3x3 patch of one modality at voxel (0, 0, 0) of a 4x4x1 volume:
    # 9 floats out, one int64 index, 9 distinct padded voxels read
    assert counts.gather_bytes([0], (4, 4, 1), (3, 3, 1), 1) == 36 + 8 + 36
    # two patches one row apart share six voxels: 12 distinct, 2 modalities
    assert counts.gather_bytes([0, 4], (4, 4, 1), (3, 3, 1), 2) == \
        2 * 9 * 2 * 4 + 2 * 8 + 12 * 2 * 4


def _port_pw1(params):
    from nnal_tpu_torch.models.cnn import CNN
    from nnal_tpu_torch.models.specs import create_pw1

    model = CNN(create_pw1(2, 0.5, (25, 25, 2)))
    model.load_state_dict(params)
    return model


def test_pw1_reference_matches_the_port():
    params = inputs.weights(pw1.param_shapes((25, 25), 2, 2), 7, "cpu")
    x = torch.randn(6, 2, 25, 25, generator=torch.Generator().manual_seed(1))
    got = _port_pw1(params)(x.permute(0, 2, 3, 1)).logits
    want = pw1.forward(params, x)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


def test_pw1_dropout_draws_match_the_port():
    """The reference's masks are the program's: the same uniforms, in the
    same layer order, through the same keep rule."""
    from nnal_tpu_torch.core import rng as core_rng

    params = inputs.weights(pw1.param_shapes((25, 25), 2, 2), 7, "cpu")
    x = torch.randn(4, 2, 25, 25, generator=torch.Generator().manual_seed(2))
    seed, step0, i = 12345, 0, 1
    key = core_rng.fold_key(core_rng.RngStream(seed).fold(
        f"finetune-dropout-{step0}").next(), step0)
    got = _port_pw1(params)(
        x.permute(0, 2, 3, 1), train=True,
        generator=core_rng.key_generator(key, i, "cpu")).logits
    masks = draws.dropout_uniforms(seed, step0, i, 4, pw1.fc_widths(2), "cpu")
    assert torch.allclose(got, pw1.forward(params, x, masks),
                          rtol=1e-5, atol=1e-5)


def test_batches_match_the_port():
    from nnal_tpu_torch.core.rng import RngStream
    from nnal_tpu_torch.models.train import build_batch_index_matrix

    seed, n, b = 99, 320, 128
    host = RngStream(seed).fold("finetune-0").host
    idx, w = build_batch_index_matrix(n, b, 1, host, bucket=256)
    real = [r for r in range(len(w)) if w[r].sum() > 0]
    mine = draws.batches(seed, 0, n, b)
    assert len(real) == len(mine) == 3
    for r, (rows, ww) in zip(real, mine):
        assert np.array_equal(idx[r], rows) and np.array_equal(w[r], ww)


@pytest.mark.parametrize("hw", [(32, 32), (64, 32)])
def test_fcd103_reference_matches_the_port(hw):
    from nnal_tpu_torch.models.cnn import CNN
    from nnal_tpu_torch.models.specs import create_tiramisu103

    params = inputs.weights(fcd103.param_shapes(2, 2), 5, "cpu")
    stats = inputs.bn_stats(fcd103.bn_names(2, 2), 5, "cpu")
    model = CNN(create_tiramisu103(2, hw + (2,), dropout_rate=0.2))
    model.load_state_dict(params)
    x = torch.randn((2, 2) + hw, generator=torch.Generator().manual_seed(3))
    got = model(x.permute(0, 2, 3, 1), state=stats).logits
    want = fcd103.forward(params, stats, x, 2).permute(0, 2, 3, 1)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)


def test_patches_match_the_port_gather():
    from nnal_tpu_torch.data.patches import (
        gather_patches_normalized,
        pad_volumes,
    )

    v, _ = inputs.volumes((12, 10, 4), 2, 2, 4, 10, "cpu")
    vols = v.numpy()
    mu, sd = patches.stats(vols)
    inds = np.array([0, 5, 77, 300, 479])
    got = gather_patches_normalized(
        pad_volumes(list(vols), (25, 25, 1), "cpu"), torch.as_tensor(inds),
        torch.as_tensor(mu), torch.as_tensor(sd), (25, 25, 1), (12, 10, 4))
    want = patches.Patches(vols, (25, 25), "cpu")(inds)
    assert torch.allclose(got.permute(0, 3, 1, 2), want, rtol=0, atol=1e-6)
