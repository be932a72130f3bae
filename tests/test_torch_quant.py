"""int8 serving (``models/quant``, the int8 branch of ``models/cnn``) on the
port against the JAX package, on the CPU from the same numpy weights.

``W_q`` and ``w_scale`` are bit-equal to ``nnal_tpu.models.quant``'s (the
same numpy code).  The int8 forward of PW1 (9x9x1) and of the small
FC-DenseNet of ``tests/torch_jax_dense.py`` is held to JAX's *jitted*
``apply_cnn`` on the same quantized tree, at f32 and at bf16 around the
int8 ops: the activation scale is XLA's ``max|h| * f32(1/127)``, the
codes round half to even, the int32 sums are exact in both, and the
rescale plus bias is one fused multiply-add in both.  PW1 posteriors
agree within 1e-6 (a softmax ulp); every int8 conv of the dense net is bit-equal to
JAX's on the same input, and its whole forward is held statistically
(``test_dense_int8_forward_tracks_jax`` says why).  The evaluators pad a
ragged chunk as JAX does (the per-tensor scale covers the padding), so
grid and off-grid sweeps of a quantized PW1 agree with JAX's within
1e-6.  Checkpoints keep int8 and f32 leaves exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnal_tpu.data.io import synthetic_subject as j_synthetic_subject
from nnal_tpu.data.patches import pad_volumes as j_pad_volumes
from nnal_tpu.models.checkpoint import save_checkpoint as j_save_checkpoint
from nnal_tpu.models import cnn as j_cnn
from nnal_tpu.models.cnn import apply_cnn, cast_float_params
from nnal_tpu.models.cnn import init_cnn as j_init_cnn
from nnal_tpu.models.quant import quantize_params as j_quantize_params
from nnal_tpu.models.specs import create_model as j_create_model
from nnal_tpu.scoring.grid_eval import GridPoolEvaluator as JGrid
from nnal_tpu_torch.models import checkpoint as t_ckpt
from nnal_tpu_torch.models import cnn as t_cnn
from nnal_tpu_torch.models.bridge import (
    bn_state_to_port,
    from_jax_params,
    to_jax_params,
)
from nnal_tpu_torch.models.cnn import CNN, int8_matmul
from nnal_tpu_torch.models.quant import (
    is_quantized,
    quantize_model,
    quantize_params,
    quantized_cnn,
)
from nnal_tpu_torch.models.specs import create_model as t_create_model
from nnal_tpu_torch.data.patches import pad_volumes as t_pad_volumes
from nnal_tpu_torch.scoring.grid_eval import GridPoolEvaluator as TGrid
from torch_jax_dense import dense_specs, jax_weights, slices

torch.set_num_threads(1)

PS = (9, 9, 1)


@pytest.fixture(scope="module")
def pw():
    jspec = j_create_model("PW", nclass=2, patch_shape=PS)
    tspec = t_create_model("PW", nclass=2, patch_shape=PS)
    params, _ = j_init_cnn(jspec, jax.random.key(0))
    params = jax.tree_util.tree_map(np.asarray, params)
    return jspec, tspec, params, j_quantize_params(jspec, params)


def _np_tree(tree):
    return {l: {k: np.asarray(v) for k, v in p.items()}
            for l, p in tree.items()}


def _jax_posteriors(jspec, qp, x, cd=None, state=None):
    @jax.jit
    def run(p, x, st):
        if cd is not None:
            p, x = cast_float_params(p, cd), x.astype(cd)
        return apply_cnn(jspec, p, x, state=st).posteriors

    return np.asarray(run(jax.tree_util.tree_map(jnp.asarray, qp),
                          jnp.asarray(x), state))


def test_quantize_params_bit_equal(pw):
    jspec, tspec, params, qj = pw
    qt = quantize_params(tspec, params)
    assert is_quantized(qt) and not is_quantized(params)
    assert set(qt) == set(qj)
    for name, p in qj.items():
        assert set(qt[name]) == set(p)
        for k, v in p.items():
            v = np.asarray(v)
            assert qt[name][k].dtype == v.dtype, (name, k)
            np.testing.assert_array_equal(qt[name][k], v)
    first = next(l.name for l in tspec.layers if l.kind == "conv")
    kept = quantize_params(tspec, params, keep_float=[first])
    assert "W" in kept[first] and "W_q" not in kept[first]


def test_dense_quantize_keeps_convT_float():
    jspec, tspec = dense_specs()
    params, _ = jax_weights(jspec)
    qj, qt = j_quantize_params(jspec, params), quantize_params(tspec, params)
    kinds = {l.name: l.kind for l in tspec.layers}
    for name, p in qj.items():
        for k, v in p.items():
            np.testing.assert_array_equal(qt[name][k], np.asarray(v))
        assert ("W_q" in qt[name]) == (kinds[name] in ("conv", "fc"))


def test_bridge_round_trip_is_exact(pw):
    _, tspec, params, qj = pw
    model = quantized_cnn(tspec, _np_tree(qj), device="cpu")
    assert is_quantized(model)
    back = to_jax_params(model.state_dict())
    for name, p in qj.items():
        for k, v in p.items():
            assert back[name][k].dtype == np.asarray(v).dtype
            np.testing.assert_array_equal(back[name][k], np.asarray(v))
    # quantize_model of the float model builds the same int8 layers
    fm = CNN(tspec)
    fm.load_state_dict(from_jax_params(params))
    qm = quantize_model(fm)
    for k, v in model.state_dict().items():
        assert torch.equal(qm.state_dict()[k], v), k


@pytest.mark.parametrize("m,k,n", [(5, 50, 2), (40, 600, 32), (17, 8, 8)])
def test_int8_matmul_plain_is_exact(m, k, n):
    rng = np.random.default_rng(m + k)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (n, k)).astype(np.int8)
    got = int8_matmul(torch.from_numpy(a), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), a.astype(np.int64) @ w.astype(np.int64).T)


@pytest.mark.parametrize("cd", [None, "bf16"])
def test_pw1_int8_forward_matches_jax(pw, cd):
    jspec, tspec, _, qj = pw
    model = quantized_cnn(tspec, _np_tree(qj), device="cpu")
    x = np.random.default_rng(1).normal(size=(64,) + PS).astype(np.float32)
    want = _jax_posteriors(jspec, qj, x, jnp.bfloat16 if cd else None)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        out = model(xt.to(torch.bfloat16) if cd else xt)
    got = out.posteriors.numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("cd", [None, "bf16"])
def test_dense_int8_layers_match_jax(cd):
    """Every int8 conv of the small FC-DenseNet (3x3 SAME, 1x1) on the
    same input as JAX's jitted ``_int8_main``: bit-equal, at odd sizes."""
    jspec, tspec = dense_specs()
    params, _ = jax_weights(jspec, 2)
    qj = j_quantize_params(jspec, params)
    model = quantized_cnn(tspec, quantize_params(tspec, params), device="cpu")
    rng = np.random.default_rng(0)
    dt = torch.bfloat16 if cd else torch.float32
    n = 0
    for jl, tl, (in_c, _, _) in zip(jspec.layers, tspec.layers,
                                    t_cnn._trace_channels(tspec)):
        if tl.kind != "conv":
            continue
        x = rng.normal(size=(2, 11, 12, in_c)).astype(np.float32)
        p, xj = qj[jl.name], jnp.asarray(x)
        if cd:
            p = cast_float_params({"l": p}, jnp.bfloat16)["l"]
            xj = xj.astype(jnp.bfloat16)
        want = np.asarray(jax.jit(
            lambda p, h, jl=jl: j_cnn._int8_main(jl, p, h, 2))(p, xj)
            .astype(jnp.float32))
        with torch.no_grad():
            got = model._main(tl, getattr(model, tl.name),
                              torch.from_numpy(x).permute(0, 3, 1, 2).to(dt),
                              dt)
        assert got.dtype == dt
        np.testing.assert_array_equal(
            got.float().permute(0, 2, 3, 1).numpy(), want, err_msg=tl.name)
        n += 1
    assert n == 9


@pytest.mark.parametrize("cd", [None, "bf16"])
@pytest.mark.parametrize("seed", [0, 2])
def test_dense_int8_forward_tracks_jax(cd, seed):
    """End to end, the dense net's float parts (batch norm, the transposed
    convs) round differently from XLA's fused programs by an ulp here and
    there; a code that lands on the other side of a rounding boundary
    shifts a value by a quantization step, which moves every later
    layer's codes, so the int8 posteriors are held to JAX's within 0.1,
    with predictions equal on at least 95% of the voxels where JAX's p1
    is more than 0.05 from 0.5 (PW1 has no float part between its int8
    layers and is held within 1e-6 above)."""
    jspec, tspec = dense_specs()
    params, state = jax_weights(jspec, seed)
    model = quantized_cnn(tspec, quantize_params(tspec, params),
                          device="cpu")
    x, xt = slices(2, seed=seed + 1)
    want = _jax_posteriors(jspec, j_quantize_params(jspec, params), x,
                           jnp.bfloat16 if cd else None,
                           jax.tree_util.tree_map(jnp.asarray, state))
    with torch.no_grad():
        got = model(xt.to(torch.bfloat16) if cd else xt,
                    state=bn_state_to_port(state, "cpu")).posteriors.numpy()
    assert np.abs(got - want).max() < 0.1
    sure = np.abs(want[..., 1] - 0.5) > 0.05
    assert np.mean(got.argmax(-1)[sure] == want.argmax(-1)[sure]) >= 0.95


def test_quantized_evaluators_match_jax(pw):
    """Grid sweep (20x20x6, spacing 3, z-chunk 4: a ragged last chunk)
    and the off-grid gather (a ragged last ntb chunk)."""
    jspec, tspec, _, qj = pw
    vols, _ = j_synthetic_subject(shape=(20, 20, 6), n_modalities=1, seed=3,
                                  n_blobs=8)
    mu = np.array([float(np.mean(vols[0]))])
    sd = np.array([float(np.std(vols[0])) + 1e-6])
    jev = JGrid(jspec, j_pad_volumes(vols, PS), mu, sd, PS,
                tuple(vols[0].shape), grid_spacing=3, ntb=96)
    tev = TGrid(tspec, t_pad_volumes(vols, PS, device="cpu"), mu, sd, PS,
                tuple(vols[0].shape), grid_spacing=3, ntb=96)
    model = quantized_cnn(tspec, _np_tree(qj), device="cpu")
    jq = jax.tree_util.tree_map(jnp.asarray, qj)
    grid = np.arange(0, 20, 3)
    on = np.array([(x * 20 + y) * 6 + z for x in grid for y in grid
                   for z in range(6)])
    off = np.random.default_rng(4).choice(20 * 20 * 6, 250, replace=False)
    off = off[np.isin(off, on, invert=True)]
    for inds in (on, off):
        want = jev.evaluate(jq, inds, ("posteriors", "prediction"))
        got = tev.evaluate(model, inds, ("posteriors", "prediction"))
        np.testing.assert_allclose(got["posteriors"], want["posteriors"],
                                   atol=1e-6, rtol=0)
        np.testing.assert_array_equal(got["prediction"], want["prediction"])


def test_quantized_checkpoint_round_trip(pw, tmp_path):
    """The port's save / load keeps the int8 and f32 leaves exact at every
    storage dtype (an int8 ``W_q`` is never re-encoded), and a quantized
    npz the JAX package wrote serves in the port as in JAX."""
    jspec, tspec, _, qj = pw
    qt = _np_tree(qj)
    for dt in (None, "bfloat16", "int8"):
        path = str(tmp_path / f"q_{dt}.npz")
        t_ckpt.save_checkpoint(path, qt, dtype=dt)
        with np.load(path) as z:
            wq = [k for k in z.files if "W_q" in k]
            assert wq and all(z[k].dtype == np.int8
                              and not k.endswith(("@i8", "@bf16"))
                              for k in wq), wq
        loaded = t_ckpt.load_checkpoint(path)[0]
        os.remove(path)
        for name, p in qt.items():
            for k, v in p.items():
                if dt is not None and k in ("w_scale", "b"):
                    continue      # 1-D f32 leaves take the bf16 encode
                assert loaded[name][k].dtype == v.dtype, (dt, name, k)
                np.testing.assert_array_equal(loaded[name][k], v)
    path = str(tmp_path / "jax_q.npz")
    j_save_checkpoint(path, jax.tree_util.tree_map(jnp.asarray, qj))
    loaded = t_ckpt.load_checkpoint(path)[0]
    os.remove(path)
    for name, p in qt.items():
        for k, v in p.items():
            assert loaded[name][k].dtype == v.dtype
            np.testing.assert_array_equal(loaded[name][k], v)
    x = np.random.default_rng(5).normal(size=(4,) + PS).astype(np.float32)
    with torch.no_grad():
        got = quantized_cnn(tspec, loaded, device="cpu")(
            torch.from_numpy(x)).posteriors.numpy()
    np.testing.assert_allclose(got, _jax_posteriors(jspec, qj, x),
                               atol=1e-6, rtol=0)
