"""3-D (rank-3) specs on the port against the JAX package, on the CPU, from
the same numpy inputs and weights carried over by the bridge.

The model is the JAX package's small 3-D FC-DenseNet of
``tests/test_models.py``'s 3-D case (growth 2, depths (2, 2), 16x16x8x1
volumes), its parameters and BN state moved off their init values
(``tests/torch_jax_dense.jax_weights``).  Tolerances are the 2-D dense
tests' (``test_torch_dense_model.py``, ``test_torch_quant.py``,
``test_torch_inference.py``, ``test_torch_library.py``,
``test_torch_mixed_precision.py``):

* the forward in eval and train mode, at even and odd sizes: posteriors
  1e-5 absolute, logits and features 5e-5 times their largest magnitude
  (the 2-D tests' 5e-5 absolute on values near 1; a 3x3x3 window sums
  three times the products of a 3x3 one), the BN state and
  ``update_bn_stats`` 5e-6 relative (the 2-D tests' 1e-6 on statistics
  of 2-D maps; a 3-D statistic averages activations that carry those
  longer sums' rounding);
* the bridge: DHWIO <-> OIDHW exact both ways, the transposed conv's
  weight in the conv layout;
* int8: every int8 conv bit-equal to JAX's jitted ``_int8_main`` at f32
  and bf16; the whole int8 forward within 0.1 with predictions equal on
  95% of the sure voxels; bf16: 5e-2, 97% agreement;
* 5-D checkpoints at f32 / bf16 / int8 storage read back bit-equal by
  both packages, and ``restore_opt_state``;
* ``make_train_step(fcn=True)`` over NaN-masked per-voxel one-hots, with
  class weights, ``focal_gamma`` and ``weight_decay`` (JAX's dropout
  draws injected): loss 1e-5 relative, parameters 1e-5 absolute at f32;
  loss 2e-2 relative and update cosine > 0.95 at bf16;
* every ``FCNInference`` op (JAX's draws injected for the MC ops) at
  f32, bf16 and int8;
* ``shrunk_class_grads_with_logits`` on a 3-D sequential spec (conv3d,
  pool, fc): per-layer columns within 5e-5 of each column's scale,
  logits 1e-4 / 1e-5;
* the full-width 3-D FC-DenseNet-103 builds (on the meta device) with
  JAX's parameter count.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nnal_tpu.evaluation import inference as j_inf
from nnal_tpu.models import checkpoint as j_ckpt
from nnal_tpu.models import cnn as j_cnn
from nnal_tpu.models.cnn import apply_cnn, cast_float_params
from nnal_tpu.models.cnn import count_parameters as j_count
from nnal_tpu.models.cnn import init_cnn as j_init_cnn
from nnal_tpu.models.quant import quantize_params as j_quantize
from nnal_tpu.models.specs import CNNSpec as JSpec
from nnal_tpu.models.specs import Layer as JLayer
from nnal_tpu.models.specs import create_tiramisu103 as j_tiramisu
from nnal_tpu.models.specs import with_aleatoric_head as j_aleatoric
from nnal_tpu.models.train import make_train_step as j_make_train_step
from nnal_tpu.models.train import update_bn_stats as j_update_bn_stats
from nnal_tpu.scoring import gradients as jg
from nnal_tpu_torch.evaluation import inference as t_inf
from nnal_tpu_torch.models import checkpoint as t_ckpt
from nnal_tpu_torch.models import cnn as t_cnn
from nnal_tpu_torch.models.bridge import (
    bn_state_to_port,
    from_jax_params,
    to_jax_params,
)
from nnal_tpu_torch.models.cnn import CNN, count_parameters
from nnal_tpu_torch.models.optim import opt_state_leaves
from nnal_tpu_torch.models.quant import quantize_params, quantized_cnn
from nnal_tpu_torch.models.specs import CNNSpec as TSpec
from nnal_tpu_torch.models.specs import Layer as TLayer
from nnal_tpu_torch.models.specs import create_tiramisu103 as t_tiramisu
from nnal_tpu_torch.models.specs import with_aleatoric_head as t_aleatoric
from nnal_tpu_torch.models.train import (
    TrainState,
    make_train_step,
    update_bn_stats,
)
from nnal_tpu_torch.scoring import gradients as tg
from test_torch_fim import assert_cols_close
from torch_jax_dense import jax_weights, np_tree, port_model
from torch_jax_draws import inject

torch.set_num_threads(1)

VOL = (16, 16, 8)
SMALL = dict(growth=2, depths=(2, 2), dropout_rate=0.2)


def specs(spatial=VOL, nmod=1, aleatoric=False):
    shape = tuple(spatial) + (nmod,)
    js, ts = j_tiramisu(2, shape, **SMALL), t_tiramisu(2, shape, **SMALL)
    return (j_aleatoric(js), t_aleatoric(ts)) if aleatoric else (js, ts)


def volumes(n, spatial=VOL, nmod=1, seed=1):
    return np.random.default_rng(seed).normal(
        size=(n,) + tuple(spatial) + (nmod,)).astype(np.float32)


@pytest.fixture(scope="module")
def net():
    jspec, tspec = specs()
    params, state = jax_weights(jspec, 0)
    return jspec, tspec, params, state, port_model(tspec, params)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), rtol=0, atol=atol)


def _state_close(got, want, rtol=5e-6):
    assert sorted(got) == sorted(want)
    for layer in want:
        for k in ("mean", "var"):
            w = np.asarray(want[layer][k])
            np.testing.assert_allclose(got[layer][k].detach().numpy(), w,
                                       rtol=rtol,
                                       atol=rtol * np.abs(w).max())


@pytest.mark.parametrize("spatial", [VOL, (13, 11, 7)])
@pytest.mark.parametrize("train", [False, True])
def test_forward_and_bn_state_match_jax(spatial, train):
    """Eval mode on the running statistics, train mode on the batch's,
    the state moved at ``bn_decay``; odd sizes take the pool's end
    padding and the transposed conv's crop in every dim."""
    jspec, tspec = specs(spatial)
    params, state = jax_weights(jspec, 0)
    model = port_model(tspec, params)
    x = volumes(2, spatial)
    want = apply_cnn(jspec, params, jnp.asarray(x), train=train,
                     state=state, bn_decay=0.9)
    got = model(torch.from_numpy(x), train=train,
                state=bn_state_to_port(state, "cpu"), bn_decay=0.9)
    assert got.posteriors.shape == (2,) + tuple(spatial) + (2,)
    _close(got.posteriors, want.posteriors, 1e-5)
    for a, b in ((got.logits, want.logits), (got.feature, want.feature)):
        _close(a, b, 5e-5 * max(1.0, float(np.abs(b).max())))
    _state_close(got.state, want.state)


def test_bridge_round_trip_and_conv_layouts(net):
    jspec, tspec, params, _, model = net
    sd = model.state_dict()
    W = params["first_conv"]["W"]                    # DHWIO
    assert W.ndim == 5
    np.testing.assert_array_equal(sd["first_conv.weight"].numpy(),
                                  W.transpose(4, 3, 0, 1, 2))
    assert sd["up0_T.weight"].shape == params["up0_T"]["W"].shape[::-1][:2] \
        + params["up0_T"]["W"].shape[:3]
    back = to_jax_params(sd)
    for layer, p in params.items():
        for k, v in p.items():
            np.testing.assert_array_equal(back[layer][k], v)


def test_update_bn_stats_matches_jax(net):
    jspec, _, params, state, model = net
    batches = [volumes(2, seed=s) for s in (5, 6, 7)]
    it = iter(batches)
    want = j_update_bn_stats(jspec, jax.tree_util.tree_map(
        jnp.asarray, params), state, lambda: next(it), iters=3,
        bn_decay=0.5)
    it2 = iter(batches)
    got = update_bn_stats(model, bn_state_to_port(state, "cpu"),
                          lambda: next(it2), iters=3, bn_decay=0.5)
    _state_close(got, want)


@pytest.mark.parametrize("cd", [None, "bf16"])
def test_int8_layers_bit_equal_jax(cd):
    """Every int8 conv (3x3x3 SAME, 1x1x1) on the same input as JAX's
    jitted ``_int8_main``, at an odd size: bit-equal."""
    jspec, tspec = specs()
    params, _ = jax_weights(jspec, 2)
    qj = j_quantize(jspec, params)
    model = quantized_cnn(tspec, quantize_params(tspec, params), device="cpu")
    rng = np.random.default_rng(0)
    dt = torch.bfloat16 if cd else torch.float32
    n = 0
    for jl, tl, (in_c, _, _) in zip(jspec.layers, tspec.layers,
                                    t_cnn._trace_channels(tspec)):
        if tl.kind != "conv":
            continue
        x = rng.normal(size=(2, 7, 6, 5, in_c)).astype(np.float32)
        p, xj = qj[jl.name], jnp.asarray(x)
        if cd:
            p = cast_float_params({"l": p}, jnp.bfloat16)["l"]
            xj = xj.astype(jnp.bfloat16)
        want = np.asarray(jax.jit(
            lambda p, h, jl=jl: j_cnn._int8_main(jl, p, h, 3))(p, xj)
            .astype(jnp.float32))
        with torch.no_grad():
            got = model._main(tl, getattr(model, tl.name),
                              t_cnn.to_channels_first(
                                  torch.from_numpy(x).to(dt)), dt)
        assert got.dtype == dt
        np.testing.assert_array_equal(
            t_cnn.to_channels_last(got.float()).numpy(), want,
            err_msg=tl.name)
        n += 1
    assert n == 9


@pytest.mark.parametrize("cd", [None, "bf16"])
def test_int8_forward_tracks_jax(net, cd):
    """``test_torch_quant.test_dense_int8_forward_tracks_jax``'s rule."""
    jspec, tspec, params, state, _ = net
    model = quantized_cnn(tspec, quantize_params(tspec, params),
                          device="cpu")
    x = volumes(2, seed=3)
    qp = jax.tree_util.tree_map(jnp.asarray, j_quantize(jspec, params))
    xj = jnp.asarray(x)
    if cd:
        qp, xj = cast_float_params(qp, jnp.bfloat16), xj.astype(jnp.bfloat16)
    want = np.asarray(jax.jit(lambda p, s, h: apply_cnn(
        jspec, p, h, state=s).posteriors)(qp, state, xj))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = model(xt.to(torch.bfloat16) if cd else xt,
                    state=bn_state_to_port(state, "cpu")).posteriors.numpy()
    assert np.abs(got - want).max() < 0.1
    sure = np.abs(want[..., 1] - 0.5) > 0.05
    assert np.mean(got.argmax(-1)[sure] == want.argmax(-1)[sure]) >= 0.95


def test_bf16_forward_matches_jax(net):
    jspec, _, params, state, model = net
    x = volumes(2, seed=4)
    want = np.asarray(apply_cnn(
        jspec, cast_float_params(jax.tree_util.tree_map(jnp.asarray, params),
                                 jnp.bfloat16),
        jnp.asarray(x), state=state, compute_dtype=jnp.bfloat16).posteriors)
    p16 = {k: v.to(torch.bfloat16) for k, v in model.named_parameters()}
    with torch.no_grad():
        got = torch.func.functional_call(
            model, p16, (torch.from_numpy(x).to(torch.bfloat16),),
            {"state": bn_state_to_port(state, "cpu")}).posteriors.numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() < 5e-2
    assert np.mean(got.argmax(-1) == want.argmax(-1)) > 0.97


@pytest.mark.parametrize("dt", [None, "bfloat16", "int8"])
def test_checkpoint_5d_round_trip_both_ways(net, tmp_path, dt):
    """A 5-D tree saved by either package reads back bit-equal to the
    other's read of its own file (the int8 codec quantizes per DHWIO
    output channel); the optimizer leaves come back through
    ``restore_opt_state``."""
    _, tspec, params, state, _ = net
    model = port_model(tspec, params)
    tp, jp = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    model(torch.from_numpy(volumes(1)), train=True).logits.sum().backward()
    opt.step()
    leaves = opt_state_leaves(opt, model)
    t_ckpt.save_checkpoint(tp, params, bn_state=state, opt_state=leaves,
                           dtype=dt)
    j_ckpt.save_checkpoint(jp, params, bn_state=state, dtype=dt)
    try:
        jj = j_ckpt.load_checkpoint(jp)
        for got in (j_ckpt.load_checkpoint(tp), t_ckpt.load_checkpoint(jp)):
            for group in (0, 1):
                for layer, p in jj[group].items():
                    for k, v in p.items():
                        np.testing.assert_array_equal(
                            np.asarray(got[group][layer][k]), np.asarray(v))
        stored = t_ckpt.load_opt_leaves(tp)
        if dt is None:
            for a, b in zip(leaves, stored):
                np.testing.assert_array_equal(a, b)
        fresh = torch.optim.Adam(model.parameters(), lr=1e-3)
        assert t_ckpt.restore_opt_state(tp, fresh, model) is fresh
        back = opt_state_leaves(fresh, model)
        assert len(back) == len(stored) == len(leaves)
        for a, b in zip(back, stored):
            np.testing.assert_array_equal(a, b)
    finally:
        for p in (tp, jp):
            if os.path.exists(p):
                os.remove(p)


def _step_batch(seed=7):
    rng = np.random.default_rng(seed)
    x = volumes(2, seed=seed)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (2,) + VOL)]
    y[rng.uniform(size=(2,) + VOL) < 1 / 3] = np.nan
    return x, y


@pytest.mark.parametrize("cd", [None, "bf16"])
def test_fcn_train_step_matches_jax(monkeypatch, cd):
    """One SGD step (lr 0.05) of ``make_train_step(fcn=True)`` over
    per-voxel one-hots of which a third are unlabeled (NaN), with class
    weights, ``focal_gamma`` 2 and ``weight_decay`` 1e-4, JAX's dropout
    draws injected."""
    inject(monkeypatch)
    jspec, tspec = specs()
    params, _ = jax_weights(jspec, 3)
    model = port_model(tspec, params)
    x, y = _step_batch()
    cw = np.array([0.7, 1.4], np.float32)
    key, step = jax.random.fold_in(jax.random.key(2), 1), 1
    tx = optax.sgd(0.05)
    jstep = j_make_train_step(
        jspec, tx, fcn=True, class_weights=cw, focal_gamma=2.0,
        weight_decay=1e-4, compute_dtype=jnp.bfloat16 if cd else None)
    jp, _, jloss = jstep(jax.tree_util.tree_map(jnp.asarray, params),
                         tx.init(params), jnp.asarray(x), jnp.asarray(y),
                         key, jnp.asarray(step))
    state = TrainState(model=model, step=step, optimizer=torch.optim.SGD(
        model.parameters(), lr=0.05))
    loss = make_train_step(
        fcn=True, focal_gamma=2.0, weight_decay=1e-4,
        compute_dtype=torch.bfloat16 if cd else None)(
        state, torch.from_numpy(x), torch.from_numpy(y), key,
        cw=torch.from_numpy(cw))
    got = to_jax_params(model.state_dict())
    jp = np_tree(jp)
    if cd is None:
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        for layer in jp:
            for k in jp[layer]:
                np.testing.assert_allclose(got[layer][k], jp[layer][k],
                                           rtol=0, atol=1e-5,
                                           err_msg=f"{layer}/{k}")
        return
    assert all(p.dtype == torch.float32 for p in model.parameters())
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-2)

    def flat(tree):
        return np.concatenate([np.ravel(tree[l][k]) for l in sorted(tree)
                               for k in sorted(tree[l])])

    base = flat(params)
    dj, dt = flat(jp) - base, flat(got) - base
    cos = np.dot(dj, dt) / (np.linalg.norm(dj) * np.linalg.norm(dt))
    assert cos > 0.95, cos


@pytest.fixture(scope="module")
def served():
    jspec, tspec = specs()
    params, state = jax_weights(jspec)
    jspec_a, tspec_a = specs(aleatoric=True)
    params_a, _ = jax_weights(jspec_a, seed=3)
    return dict(jspec=jspec, tspec=tspec, params=params, state=state,
                model=port_model(tspec, params), jspec_a=jspec_a,
                tspec_a=tspec_a, params_a=params_a,
                model_a=port_model(tspec_a, params_a), x=volumes(3))


def _inference(d, aleatoric=False, **kw):
    suffix = "_a" if aleatoric else ""
    jp = jax.tree_util.tree_map(jnp.asarray, d["params" + suffix])
    jst = jax.tree_util.tree_map(jnp.asarray, d["state"])
    ji = j_inf.FCNInference(d["jspec" + suffix], batch=2, bn_state=jst, **kw)
    kw = {k: (torch.bfloat16 if v is not None else None)
          for k, v in kw.items()}
    ti = t_inf.FCNInference(d["tspec" + suffix], batch=2,
                            bn_state=bn_state_to_port(d["state"], "cpu"),
                            device="cpu", **kw)
    return ji, jp, ti, d["model" + suffix]


@pytest.mark.parametrize("op,atol", [("prediction", 0), ("posteriors", 1e-5),
                                     ("output", 5e-5)])
def test_fcn_inference_deterministic_ops(served, op, atol):
    ji, jp, ti, model = _inference(served)
    want = ji.segment(jp, served["x"], op)
    got = ti.segment(model, served["x"], op)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.shape[1:4] == VOL
    if op == "prediction":
        post = ji.segment(jp, served["x"], "posteriors")[..., 1]
        sure = np.abs(post - 0.5) > 1e-4
        np.testing.assert_array_equal(got[sure], want[sure])
    else:
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_fcn_inference_loss(served):
    ji, jp, ti, model = _inference(served)
    rng = np.random.default_rng(7)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (3,) + VOL)]
    y[rng.random((3,) + VOL) < 0.4] = np.nan
    y[2] = np.nan                                    # a volume without any
    want = ji.segment(jp, served["x"], "loss", labels=y)
    got = ti.segment(model, served["x"], "loss", labels=y)
    assert got.shape == (3,)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("op", ["MC-posteriors", "MC-sigma", "sigma"])
def test_fcn_inference_stochastic_and_sigma_ops(served, op, monkeypatch):
    inject(monkeypatch)
    ji, jp, ti, model = _inference(served, aleatoric=op != "MC-posteriors")
    key = jax.random.key(11)
    want = ji.segment(jp, served["x"], op, mc_T=3, rng=key)
    got = ti.segment(model, served["x"], op, mc_T=3, rng=key)
    assert got.shape == want.shape
    if op == "MC-posteriors":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        assert (got > 0).all()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


def test_fcn_inference_bf16_and_int8(served):
    ji, jp, ti, model = _inference(served, compute_dtype=jnp.bfloat16)
    want = ji.segment(jp, served["x"], "posteriors")
    got = ti.segment(model, served["x"], "posteriors")
    assert got.dtype == np.float32
    assert np.abs(got - want).max() < 5e-2
    assert np.mean(got.argmax(-1) == want.argmax(-1)) > 0.97
    ji, _, ti, _ = _inference(served)
    qj = jax.tree_util.tree_map(jnp.asarray, j_quantize(served["jspec"],
                                                        served["params"]))
    qmodel = quantized_cnn(served["tspec"], quantize_params(
        served["tspec"], served["params"]), device="cpu")
    want = ji.segment(qj, served["x"], "posteriors")
    got = ti.segment(qmodel, served["x"], "posteriors")
    assert np.abs(got - want).max() < 0.1
    sure = np.abs(want[..., 1] - 0.5) > 0.05
    assert np.mean(got.argmax(-1)[sure] == want.argmax(-1)[sure]) >= 0.95


def test_shape_cached_fcn_on_volumes():
    cache = t_inf.ShapeCachedFCN(lambda shape: specs(shape)[1],
                                 device="cpu")
    a = cache.for_shape((16, 16, 8))
    assert cache.for_shape([16, 16, 8]) is a
    assert cache.for_shape((16, 16, 4)).spec.input_shape == (16, 16, 4, 1)


def _seq3d(layer_cls, spec_cls):
    """conv 3x3x3 -> conv 2x2x2 / 2 (asymmetric SAME pad) -> pool (end
    padding, 4 -> 2) -> fc 16 -> linear head, on 7x7x5x2."""
    L = layer_cls
    layers = (L("c1", "conv", 4, (3, 3, 3), (1, 1, 1)),
              L("c2", "conv", 6, (2, 2, 2), (2, 2, 2)),
              L("p1", "pool", None, (2, 2, 2), (2, 2, 2)),
              L("f1", "fc", 16, (), (), "VALID"),
              L("f2", "fc", 3, (), (), "VALID", "M"))
    return spec_cls("seq3d", layers, (7, 7, 5, 2), 3)


def test_shrunk_class_grads_3d_sequential():
    jspec, tspec = _seq3d(JLayer, JSpec), _seq3d(TLayer, TSpec)
    params, _ = j_init_cnn(jspec, jax.random.key(0))
    np_params = np_tree(params)
    model = CNN(tspec)
    model.load_state_dict(from_jax_params(np_params))
    x = np.random.default_rng(0).normal(size=(6, 7, 7, 5, 2)).astype(
        np.float32)
    want, wlog = jg.shrunk_class_grads_with_logits(jspec, params,
                                                   jnp.asarray(x))
    got, glog = tg.shrunk_class_grads_with_logits(model, torch.from_numpy(x))
    assert got.shape == (6, 3, 4)
    assert_cols_close(got.numpy(), want)
    np.testing.assert_allclose(glog.numpy(), wlog, rtol=1e-4, atol=1e-5)


def test_full_width_3d_fc_densenet_builds_with_jax_count():
    """FC-DenseNet-103 at growth 16, depths (4, 5, 7, 10, 12, 15), 3-D on
    2 modalities: 26,167,922 parameters in both packages."""
    shape = (64, 64, 32, 2)
    jspec = j_tiramisu(2, shape)
    jp, _ = jax.eval_shape(lambda k: j_init_cnn(jspec, k), jax.random.key(0))
    with torch.device("meta"):
        model = CNN(t_tiramisu(2, shape))
    assert count_parameters(model) == j_count(jp) == 26_167_922
    assert model.first_conv.weight.shape == (48, 2, 3, 3, 3)
    assert isinstance(model.first_conv, torch.nn.Conv3d)
