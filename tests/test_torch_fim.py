"""Fused posterior + diag-FIM scoring: the port vs the JAX package on the
CPU — shrunk class gradients (the epsilon trick), A-matrices, the fused
scorer, the candidate gather tail and the whole-grid ``fim_sweep``.

Inputs come from numpy seeds and weights from the JAX package's
``init_cnn`` through ``models/bridge.py``.

Tolerance for shrunk gradients (and A-matrices built from them): per layer
column, max |delta| <= 5e-5 x the column's max |value| (observed ~1.8e-6:
both are IEEE f32 forward + input-gradient passes that differ only in
summation order).  The linear head's column of the shrunk gradients is
zero in exact arithmetic (adding one constant to every logit leaves
log-softmax unchanged), so its entries are rounding noise in both
packages (observed <= 3e-6 x the largest column): it is held to |value|
<= 1e-4 x the largest column's max instead.

The whole-grid sweep is held row by row: at most 1% of its rows may
exceed that tolerance, and every row stays within 0.1 of its columns'
scale.  A relu input within f32 rounding of zero takes the other side of
the kink in the other package and drops (or adds) that unit's gradient:
observed once in 320 rows, an fc1 pre-activation of 1.9e-7 moving a
conv column by 1.7e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnal_tpu.data.patches import pad_volumes as j_pad
from nnal_tpu.models.cnn import init_cnn
from nnal_tpu.models.specs import CNNSpec as JSpec
from nnal_tpu.models.specs import Layer as JLayer
from nnal_tpu.models.specs import create_pw1
from nnal_tpu.ops.scoring_fused import pool_score_fused as j_fused
from nnal_tpu.scoring import fisher as jf
from nnal_tpu.scoring import gradients as jg
from nnal_tpu.scoring.grid_eval import GridPoolEvaluator as JGrid
from nnal_tpu_torch.data.io import synthetic_subject
from nnal_tpu_torch.data.patches import pad_volumes
from nnal_tpu_torch.models.bridge import from_jax_params
from nnal_tpu_torch.models.cnn import CNN
from nnal_tpu_torch.models.specs import CNNSpec as TSpec
from nnal_tpu_torch.models.specs import Layer as TLayer
from nnal_tpu_torch.ops.scoring_fused import pool_score_fused
from nnal_tpu_torch.scoring import fisher as tf
from nnal_tpu_torch.scoring import gradients as tg
from nnal_tpu_torch.scoring.grid_eval import GridPoolEvaluator as TGrid

torch.set_num_threads(1)

RTOL_COL = 5e-5


def _narrow(layer_cls, spec_cls, nclass, activation):
    """conv 4x4/2 (asymmetric SAME pad on 9) -> conv 3x3 -> pool (end-only
    pad, 5 -> 3) -> fc 16 -> linear head."""
    L = layer_cls
    layers = (L("c1", "conv", 4, (4, 4), (2, 2)),
              L("c2", "conv", 6, (3, 3), (1, 1)),
              L("p1", "pool", None, (2, 2), (2, 2)),
              L("f1", "fc", 16, (), (), "VALID"),
              L("f2", "fc", nclass, (), (), "VALID", "M"))
    return spec_cls("narrow", layers, (9, 9, 2), nclass,
                    activation=activation)


def _models(kind, seed=0):
    """(JAX spec, JAX params, port model) with the same weights."""
    if kind == "pw1":
        jspec = create_pw1(2, 0.5, (9, 9, 2))
        tspec = None
    else:
        nclass, act = {"narrow2": (2, "relu"), "narrow3": (3, "relu"),
                       "narrow3_elu": (3, "elu")}[kind]
        jspec = _narrow(JLayer, JSpec, nclass, act)
        tspec = _narrow(TLayer, TSpec, nclass, act)
    params, _ = init_cnn(jspec, jax.random.key(seed))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    if tspec is None:
        from nnal_tpu_torch.models.specs import create_pw1 as t_pw1

        tspec = t_pw1(2, 0.5, (9, 9, 2))
    model = CNN(tspec)
    model.load_state_dict(from_jax_params(np_params))
    return jspec, params, model


def _x(n, seed=0, shape=(9, 9, 2)):
    return np.random.default_rng(seed).normal(size=(n,) + shape).astype(
        np.float32)


def assert_cols_close(got, want, rtol=RTOL_COL, zero_head=True):
    """max |delta| per last-axis column within rtol x the column's max
    |want|; with ``zero_head`` the last column (the linear head's, zero in
    exact arithmetic) is only held near zero (see the module
    docstring)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    axes = tuple(range(want.ndim - 1))
    scale = np.abs(want).max(axis=axes)
    err = np.abs(got - want).max(axis=axes) / np.maximum(scale, 1e-30)
    if zero_head:
        noise = 1e-4 * scale[:-1].max()
        assert np.abs(got[..., -1]).max() <= noise
        assert np.abs(want[..., -1]).max() <= noise
        err = err[:-1]
    assert err.max() <= rtol, err


def assert_rows_close(got, want, rtol=RTOL_COL, bad_frac=0.01,
                      loose=0.1):
    """Per row of (n, c, L) shrunk gradients, the largest |delta| over the
    layer columns (head excluded) relative to each column's max |want|:
    at most ``bad_frac`` of the rows above ``rtol``, none above ``loose``
    (see the module docstring)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want[..., :-1]).max(axis=(0, 1))
    err = (np.abs(got - want)[..., :-1] / scale).max(axis=(1, 2))
    assert np.sum(err > rtol) <= bad_frac * len(err), np.sort(err)[-5:]
    assert err.max() <= loose, err.max()


def assert_a_close(got, want, diag_load):
    """A-matrices from shrunk gradients: the layers' block per column as
    :func:`assert_cols_close`; the head's row and column are products with
    its rounding noise, so they are held near zero, its diagonal near the
    diagonal load."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert_cols_close(got[:, :-1, :-1], want[:, :-1, :-1], zero_head=False)
    noise = 1e-4 * np.abs(want).max()
    for a in (got, want):
        assert np.abs(a[:, -1, :-1]).max() <= noise
        assert np.abs(a[:, :-1, -1]).max() <= noise
        np.testing.assert_allclose(a[:, -1, -1], diag_load, rtol=1e-3)


@pytest.mark.parametrize("kind", ["pw1", "narrow2", "narrow3",
                                  "narrow3_elu"])
def test_shrunk_grads_match_jax_fast_path(kind):
    jspec, params, model = _models(kind)
    x = _x(12)
    want, wlog = jg.shrunk_class_grads_with_logits(jspec, params,
                                                   jnp.asarray(x))
    got, glog = tg.shrunk_class_grads_with_logits(model, torch.from_numpy(x))
    assert got.shape == (12, jspec.nclass, len(tg.grad_param_layers(model)))
    assert_cols_close(got.numpy(), want)
    np.testing.assert_allclose(glog.numpy(), wlog, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["pw1", "narrow3"])
def test_shrunk_grads_match_jax_persample_oracle(kind):
    jspec, params, model = _models(kind, seed=1)
    x = _x(4, seed=1)
    want = jg.shrunk_class_grads_persample(jspec, params, jnp.asarray(x))
    got = tg.shrunk_class_grads(model, torch.from_numpy(x))
    assert_cols_close(got.numpy(), want)


@pytest.mark.parametrize("kind", ["pw1", "narrow3_elu"])
def test_shrunk_grads_match_port_oracle(kind):
    _, _, model = _models(kind, seed=2)
    x = torch.from_numpy(_x(4, seed=2))
    want = tg.shrunk_class_grads_persample(model, x)
    got = tg.shrunk_class_grads(model, x)
    assert_cols_close(got.numpy(), want.numpy())
    # channels-first input takes the same path
    got_nchw = tg.shrunk_class_grads(model, x.permute(0, 3, 1, 2), nchw=True)
    np.testing.assert_array_equal(got_nchw.numpy(), got.numpy())


def test_layer_sizes_match_jax():
    jspec, params, model = _models("pw1")
    assert tg.grad_param_layers(model) == jg.grad_param_layers(jspec, params)
    np.testing.assert_array_equal(tg.layer_sizes(model),
                                  jg.layer_sizes(jspec, params))
    assert len(tg.layer_sizes(model)) == 7


def _saturate(np_params, layer, lo, hi, n):
    """Head biases that push P(class 1) toward 1: logit gaps lo..hi."""
    p = jax.tree_util.tree_map(np.array, np_params)
    p[layer]["W"] = p[layer]["W"] * 1e-3
    p[layer]["b"] = np.zeros_like(p[layer]["b"])
    return p, np.linspace(lo, hi, n).astype(np.float32)


def test_near_saturated_posteriors_use_the_clamp():
    """p0 from ~1e-11 down to ~1e-17: the zero-sum identity divides by
    max(p0, 1e-12), so both sides of the clamp are exercised."""
    jspec, params, _ = _models("narrow2", seed=3)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    p, gaps = _saturate(np_params, "f2", 25.0, 40.0, 8)
    x = _x(8, seed=3)
    wants, gots, p0s = [], [], []
    for i, gap in enumerate(gaps):
        pi = jax.tree_util.tree_map(np.array, p)
        pi["f2"]["b"] = np.array([0.0, gap], np.float32)
        model = CNN(_narrow(TLayer, TSpec, 2, "relu"))
        model.load_state_dict(from_jax_params(pi))
        want, wlog = jg.shrunk_class_grads_with_logits(
            jspec, jax.tree_util.tree_map(jnp.asarray, pi),
            jnp.asarray(x[i:i + 1]))
        got, _ = tg.shrunk_class_grads_with_logits(
            model, torch.from_numpy(x[i:i + 1]))
        wants.append(np.asarray(want))
        gots.append(got.numpy())
        p0s.append(float(jax.nn.softmax(wlog)[0, 0]))
    assert min(p0s) < 1e-12 < max(p0s) < 1e-9
    assert np.isfinite(np.concatenate(gots)).all()
    # class 0's head entries are the head's rounding noise divided by
    # max(p0, 1e-12): compare the other layers only
    for g, w in zip(gots, wants):
        assert_cols_close(g[..., :-1], w[..., :-1], zero_head=False)


@pytest.mark.parametrize("kind", ["pw1", "narrow3"])
def test_remat_equals_plain(kind):
    _, _, model = _models(kind, seed=4)
    x = torch.from_numpy(_x(6, seed=4))
    a, la = tg.shrunk_class_grads_with_logits(model, x)
    b, lb = tg.shrunk_class_grads_with_logits(model, x, remat=True)
    np.testing.assert_array_equal(b.numpy(), a.numpy())
    np.testing.assert_array_equal(lb.numpy(), la.numpy())


def test_bf16_compute_dtype_raises():
    """bf16 scoring is ported: it runs in bf16 (never dropping silently to
    f32), and a dtype string the JAX package rejects raises as there."""
    from nnal_tpu.scoring.pool_eval import eval_compute_dtype as j_ecd
    from nnal_tpu_torch.scoring.pool_eval import eval_compute_dtype

    _, _, model = _models("narrow2")
    x = torch.from_numpy(_x(2))
    g16 = tg.shrunk_class_grads(model, x, compute_dtype=torch.bfloat16)
    g32 = tg.shrunk_class_grads(model, x)
    assert g16.dtype == torch.float32 and bool(torch.isfinite(g16).all())
    assert not torch.equal(g16, g32)
    p16 = pool_score_fused(model, x, False, torch.bfloat16)["p1"]
    assert not torch.equal(p16, pool_score_fused(model, x, False)["p1"])
    for name in ("float16", "int8"):
        with pytest.raises(ValueError, match="unsupported eval dtype"):
            j_ecd(name)
        with pytest.raises(ValueError, match="unsupported eval dtype"):
            eval_compute_dtype(name)


def _posts_with_snaps(n, seed):
    """Posteriors hitting both snap branches (< 1e-6 -> 0, > 1 - 1e-6 ->
    1), the exact ends, and the interior."""
    p = np.random.default_rng(seed).uniform(0.0, 1.0, n).astype(np.float32)
    p[:6] = [0.0, 1e-7, 9e-7, 1.0, 1 - 5e-7, 1e-6]
    return p


def test_a_matrices_match_jax_with_both_snap_branches():
    rng = np.random.default_rng(5)
    shrunk = rng.normal(size=(20, 2, 7)).astype(np.float32)
    p = _posts_with_snaps(20, 5)
    want = np.asarray(jf.a_matrices(jnp.asarray(shrunk), jnp.asarray(p),
                                    1e-5))
    got = tf.a_matrices(torch.from_numpy(shrunk), torch.from_numpy(p), 1e-5)
    # entries O(1): within a few f32 ulps (the two compilers may contract
    # the products into FMAs differently)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    # snapped rows keep one class's outer product only
    g = shrunk
    np.testing.assert_allclose(got[1].numpy(), np.outer(g[1, 0], g[1, 0])
                               + 1e-5 * np.eye(7), rtol=1e-6)
    np.testing.assert_allclose(got[4].numpy(), np.outer(g[4, 1], g[4, 1])
                               + 1e-5 * np.eye(7), rtol=1e-6)


def test_a_matrices_multiclass_match_jax():
    rng = np.random.default_rng(6)
    shrunk = rng.normal(size=(15, 3, 7)).astype(np.float32)
    posts = rng.dirichlet(np.ones(3), 15).astype(np.float32)
    want = np.asarray(jf.a_matrices_multiclass(jnp.asarray(shrunk),
                                               jnp.asarray(posts), 1e-4))
    got = tf.a_matrices_multiclass(torch.from_numpy(shrunk),
                                   torch.from_numpy(posts), 1e-4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-8)


SHAPE = (16, 16, 5)


def _subject(seed=0):
    vols, _ = synthetic_subject(shape=SHAPE, n_modalities=2, seed=seed)
    mu, sd = np.array([60.0, 75.0]), np.array([30.0, 31.0])
    return vols, mu, sd


def test_gather_shrunk_a_matrices_matches_jax():
    jspec, params, model = _models("pw1", seed=6)
    vols, mu, sd = _subject(6)
    patch = (9, 9, 1)
    inds = np.random.default_rng(6).integers(0, int(np.prod(SHAPE)), 30)
    p1 = _posts_with_snaps(30, 6)
    want = jg.gather_shrunk_a_matrices(
        jspec, params, j_pad(vols, patch), jnp.asarray(inds),
        jnp.asarray(mu, jnp.float32), jnp.asarray(sd, jnp.float32), patch,
        SHAPE, jnp.asarray(p1), 1e-5)
    got = tg.gather_shrunk_a_matrices(
        model, pad_volumes(vols, patch, device="cpu"),
        torch.from_numpy(inds), torch.tensor(mu, dtype=torch.float32),
        torch.tensor(sd, dtype=torch.float32), patch, SHAPE,
        torch.from_numpy(p1), 1e-5)
    assert got.shape == (30, 7, 7)
    assert_a_close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("with_fim", [True, False])
def test_pool_score_fused_matches_jax(with_fim):
    jspec, params, model = _models("pw1", seed=7)
    x = _x(10, seed=7)
    want = j_fused(jspec, params, jnp.asarray(x), with_fim)
    got = pool_score_fused(model, torch.from_numpy(x), with_fim)
    assert sorted(got) == sorted(want)
    for k in ("p1", "uncertainty"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4,
                                   atol=1e-5)
    if with_fim:
        assert_cols_close(got["shrunk"].numpy(), want["shrunk"])
        # the posterior is the gradient pass's own forward
        with torch.no_grad():
            p1 = model(torch.from_numpy(x)).posteriors[:, 1]
        np.testing.assert_allclose(got["p1"].numpy(), p1.numpy(), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("d3", [1, 3])
def test_fim_sweep_matches_jax(d3):
    """z_chunk 2 does not divide nz 5: the JAX sweep pads a slice and
    trims; the port's last chunk is short.  Both return nz*nx*ny rows in
    z-major grid order."""
    vols, mu, sd = _subject(8)
    patch = (9, 9, d3)
    jspec = create_pw1(2, 0.5, (9, 9, 2 * d3))
    params, _ = init_cnn(jspec, jax.random.key(8))
    from nnal_tpu_torch.models.specs import create_pw1 as t_pw1

    model = CNN(t_pw1(2, 0.5, (9, 9, 2 * d3)))
    model.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    jev = JGrid(jspec, j_pad(vols, patch), mu, sd, patch, SHAPE,
                grid_spacing=2, z_chunk=2)
    tev = TGrid(model.spec, pad_volumes(vols, patch, device="cpu"), mu, sd,
                patch, SHAPE, grid_spacing=2, z_chunk=2)
    want = jev.fim_sweep(params)
    got = tev.fim_sweep(model)
    n = SHAPE[2] * 8 * 8
    assert {k: v.shape[0] for k, v in got.items()} == {
        "p1": n, "uncertainty": n, "shrunk": n}
    for k in ("p1", "uncertainty"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5)
    assert_rows_close(got["shrunk"], want["shrunk"])
    dev = tev.fim_sweep(model, as_device=True)
    assert isinstance(dev["shrunk"], torch.Tensor)
    np.testing.assert_array_equal(dev["shrunk"].numpy(), got["shrunk"])


def test_fim_sweep_rejects_even_depth():
    vols, mu, sd = _subject(9)
    spec = dataclasses.replace(_narrow(TLayer, TSpec, 2, "relu"),
                               input_shape=(9, 9, 4))
    ev = TGrid(spec, pad_volumes(vols, (9, 9, 2), device="cpu"), mu, sd,
               (9, 9, 2), SHAPE, grid_spacing=2)
    with pytest.raises(ValueError, match="even"):
        ev.fim_sweep(CNN(spec))


def test_fi_select_matches_jax():
    """The array-level FI API: the same candidates, posteriors and host
    generator seed give the same picks."""
    jspec, params, model = _models("pw1", seed=10)
    x = _x(40, seed=10)
    p1 = np.asarray(j_fused(jspec, params, jnp.asarray(x), False)["p1"])
    want = jf.fi_select(jspec, params, jnp.asarray(x), p1, 6,
                        np.random.default_rng(3))
    got = tf.fi_select(model, torch.from_numpy(x), p1, 6,
                       np.random.default_rng(3))
    np.testing.assert_array_equal(got, want)
    assert 1 <= len(got) <= 6


def test_subphases_drain_into_the_round_record(tmp_path):
    from nnal_tpu_torch.core import profiling

    profiling.drain_subphases()
    timer = profiling.PhaseTimer(str(tmp_path / "p.jsonl"), device="cpu")
    with timer.phase("score_select"):
        with profiling.subphase("fi/sdp"):
            with profiling.subphase("fi/inner"):
                pass
        with profiling.subphase("fi/sdp"):
            pass
    rec = timer.commit_round(0)
    assert set(rec["sub"]) == {"fi/sdp", "fi/inner"}
    assert rec["sub"]["fi/sdp"] >= rec["sub"]["fi/inner"] >= 0
    assert profiling.drain_subphases() == {}
    assert "sub" not in timer.commit_round(1)
    with open(tmp_path / "p.jsonl") as f:
        assert [("sub" in line) for line in f] == [True, False]
