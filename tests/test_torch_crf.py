"""The dense CRF on the port (``evaluation/crf``, ``runtime/crf_native``)
against the JAX package on the CPU.

* ``meanfield_crf_2d`` (plain torch) against JAX's jitted one on noisy
  two- and three-class posteriors: q within 1e-5 (XLA fuses and orders the
  120 weighted messages its own way).
* The port's build of its copy of ``dense_crf.cc`` against the JAX
  package's build of the same source, with the same flags (``-O3
  -march=native``): the lattice filter, the 2-D mean field with and
  without the bilateral term, the feature-space entry and the 3-D mean
  field give the same q within 1e-6 (on one host the two builds are the
  same code; the bound leaves room for a JAX library built elsewhere) and
  the same labels.
* The backend policy: ``auto`` takes the native solver when it builds;
  when it does not, ``auto`` warns and falls back (pydensecrf is not
  installed, so to the torch mean field), ``native`` raises with the
  compiler's message and ``dcrf_postprocess_3d`` raises, as in JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnal_tpu.evaluation import crf as j_crf
from nnal_tpu.runtime import crf_native as j_native
from nnal_tpu_torch.evaluation import crf as t_crf
from nnal_tpu_torch.runtime import crf_native as t_native
from torch_jax_native import ensure_jax_native

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    """The JAX package's native DenseCRF loaded before its side
    runs: a load lost to a concurrent build would leave it on its
    fallback (``torch_jax_native``)."""
    ensure_jax_native("crf")


def _noisy(H=32, W=28, C=2, seed=0):
    rng = np.random.default_rng(seed)
    truth = np.zeros((H, W), np.int64)
    truth[H // 4:3 * H // 4, W // 4:3 * W // 4] = 1
    if C > 2:
        truth[:H // 4, :W // 3] = 2
    img = truth * 60.0 + rng.normal(0, 3, (H, W))
    p = np.eye(C)[truth] * 0.7 + 0.3 / C + rng.normal(0, 0.15, (H, W, C))
    p = np.clip(p, 0.01, None)
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    return p, img.astype(np.float32), truth


@pytest.mark.parametrize("C,iters,radius,rgb", [(2, 3, 3, False),
                                                (3, 2, 5, False),
                                                (2, 2, 2, True)])
def test_meanfield_matches_jax(C, iters, radius, rgb):
    p, img, _ = _noisy(C=C, seed=C)
    if rgb:
        img = np.stack([img, img[::-1], img * 0.5], -1)
    want = np.asarray(j_crf.meanfield_crf_2d(
        jnp.asarray(p), jnp.asarray(img), iters=iters, radius=radius))
    got = t_crf.meanfield_crf_2d(torch.from_numpy(p), torch.from_numpy(img),
                                 iters=iters, radius=radius)
    assert got.shape == want.shape and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_native_solver_matches_jax_build():
    assert t_native.crf_native_available()
    assert "-march=native" in t_native.GXX_FLAGS
    rng = np.random.default_rng(1)
    feat = rng.normal(0, 2.0, (300, 3)).astype(np.float32)
    vals = rng.normal(size=(300, 2)).astype(np.float32)
    np.testing.assert_allclose(t_native.permutohedral_filter(feat, vals),
                               j_native.permutohedral_filter(feat, vals),
                               atol=1e-6, rtol=0)
    p, img, _ = _noisy(seed=5)
    for image in (img, None):
        got = t_native.dcrf2d_meanfield(p, image, iters=5)
        want = j_native.dcrf2d_meanfield(p, image, iters=5)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    flat = p.reshape(-1, 2)
    fg = rng.normal(size=(flat.shape[0], 2)).astype(np.float32)
    fb = rng.normal(size=(flat.shape[0], 3)).astype(np.float32)
    np.testing.assert_allclose(
        t_native.dcrf_meanfield_feats(flat, fg, 3.0, fb, 10.0, iters=3),
        j_native.dcrf_meanfield_feats(flat, fg, 3.0, fb, 10.0, iters=3),
        atol=1e-6, rtol=0)
    vol_p = np.stack([_noisy(16, 16, seed=s)[0] for s in range(4)], 2)
    vol_i = np.stack([_noisy(16, 16, seed=s)[1] for s in range(4)], 2)
    got = t_native.dcrf3d_meanfield(vol_p, vol_i, iters=3)
    want = j_native.dcrf3d_meanfield(vol_p, vol_i, iters=3)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(
        t_crf.dcrf_postprocess_3d(vol_p[..., 1], vol_i, iters=3),
        j_crf.dcrf_postprocess_3d(vol_p[..., 1], vol_i, iters=3))


def test_postprocess_2d_backends_match_jax():
    p, img, truth = _noisy(seed=7)
    p1 = p[..., 1]
    for backend in ("auto", "native"):
        got = t_crf.dcrf_postprocess_2d(p1, img, iters=3, backend=backend)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(
            got, j_crf.dcrf_postprocess_2d(p1, img, iters=3, backend=backend))
    got = t_crf.dcrf_postprocess_2d(p1, img, iters=3, backend="torch",
                                    device="cpu")
    want = j_crf.dcrf_postprocess_2d(p1, img, iters=3, backend="jax")
    np.testing.assert_array_equal(got, want)
    assert np.mean(got != truth) <= np.mean((p1 > 0.5) != truth)
    with pytest.raises(ImportError):
        t_crf.dcrf_postprocess_2d(p1, img, backend="pydensecrf")
    with pytest.raises(ValueError, match="backend"):
        t_crf.dcrf_postprocess_2d(p1, img, backend="jax")


def test_backend_policy_without_the_native_library(monkeypatch):
    def broken():
        raise RuntimeError("native dense_crf: g++ failed: no compiler")

    monkeypatch.setattr(t_native, "load", broken)
    assert not t_native.crf_native_available()
    p, img, _ = _noisy(seed=9)
    p1 = p[..., 1]
    with pytest.warns(UserWarning, match="no compiler"):
        got = t_crf.dcrf_postprocess_2d(p1, img, iters=2, device="cpu")
    np.testing.assert_array_equal(got, t_crf.dcrf_postprocess_2d(
        p1, img, iters=2, backend="torch", device="cpu"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        t_crf.dcrf_postprocess_2d(p1, img, backend="native")
    with pytest.raises(RuntimeError, match="no fallback"):
        t_crf.dcrf_postprocess_3d(np.stack([p1] * 2, -1),
                                  np.stack([img] * 2, -1))
