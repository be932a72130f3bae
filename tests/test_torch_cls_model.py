"""The classification models and the classification train step vs the
JAX package's, on the CPU.  AlexNet at its full published width and
227x227x3 input (nclass 8: stride-4 VALID conv1, SAME 3x3/2 max-pools
55 -> 28 -> 14 -> 7, fc6 over 7x7x256 = 12,544 inputs) and VGG19 at a
small input, forward on 2 images from bridged JAX weights: posteriors
atol 1e-5, features rtol 1e-4; nothing is written to disk.  One step of
``make_train_step`` on the 2-block DenseNet (batch norm on the batch's
statistics, the zero pad rows of a padded batch included) against the
JAX package's jitted step with JAX's dropout draws injected: plain SGD
(params within 1e-5), Adam at eps 1e-3, and the mean teacher, LwF, the
aleatoric head, the class-weight vector and the ``train_layers`` mask
once each."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nnal_tpu.models import optim as joptim
from nnal_tpu.models.cnn import apply_cnn
from nnal_tpu.models.cnn import init_cnn as j_init_cnn
from nnal_tpu.models.specs import create_model as j_create_model
from nnal_tpu.models.specs import with_aleatoric_head as j_aleatoric
from nnal_tpu.models.train import make_train_step as j_make_train_step
from nnal_tpu_torch.models import optim as toptim
from nnal_tpu_torch.models.bridge import from_jax_params, to_jax_params
from nnal_tpu_torch.models.cnn import CNN
from nnal_tpu_torch.models.specs import create_model as t_create_model
from nnal_tpu_torch.models.specs import with_aleatoric_head as t_aleatoric
from nnal_tpu_torch.models.train import TrainState, make_train_step
from torch_jax_draws import inject

torch.set_num_threads(1)


def _pair(name, nclass, input_shape, dropout_rate=0.5, aleatoric=False,
          seed=0):
    args = dict(nclass=nclass, dropout_rate=dropout_rate,
                input_shape=input_shape)
    jspec, tspec = j_create_model(name, **args), t_create_model(name, **args)
    if aleatoric:
        jspec, tspec = j_aleatoric(jspec), t_aleatoric(tspec)
    params, state = j_init_cnn(jspec, jax.random.key(seed))
    params = jax.tree_util.tree_map(np.asarray, params)
    model = CNN(tspec)
    model.load_state_dict(from_jax_params(params))
    return jspec, params, model


@pytest.mark.parametrize("name,input_shape,n_params", [
    ("Alex", (227, 227, 3), 71_945_608),
    ("VGG19", (32, 32, 3), None)])
def test_forward_matches_jax(name, input_shape, n_params):
    jspec, params, model = _pair(name, 8, input_shape)
    if n_params is not None:
        assert sum(p.numel() for p in model.parameters()) == n_params
    x = np.random.default_rng(1).normal(
        size=(2,) + input_shape).astype(np.float32)
    want = apply_cnn(jspec, params, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.posteriors.numpy(),
                               np.asarray(want.posteriors), atol=1e-5)
    np.testing.assert_array_equal(got.prediction.numpy(),
                                  np.asarray(want.prediction))
    assert got.feature.shape == (2, 4096)
    f_want = np.asarray(want.feature)
    np.testing.assert_allclose(got.feature.numpy(), f_want, rtol=1e-4,
                               atol=1e-4 * np.abs(f_want).max())


B, NCLASS, SHAPE = 8, 3, (16, 16, 3)


def _batch(seed=3, pad=2, zero_pad=False):
    """A batch whose last ``pad`` rows have weight 0: images, or zeros as
    the engine pads the last batch of an epoch (``zero_pad``)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B,) + SHAPE).astype(np.float32)
    y = np.eye(NCLASS, dtype=np.float32)[rng.integers(0, NCLASS, B)]
    if zero_pad:
        x[B - pad:] = 0.0
    y[B - pad:] = np.eye(NCLASS, dtype=np.float32)[0]
    w = (np.arange(B) < B - pad).astype(np.float32)
    return x, y, w


def _jitter(params, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return {l: {k: (v + scale * rng.normal(size=v.shape)).astype(np.float32)
                for k, v in p.items()} for l, p in params.items()}


CASES = {
    "sgd": dict(opt="SGD"),
    "adam": dict(opt="Adam"),
    "mt": dict(opt="SGD", mt=True),
    "lwf": dict(opt="SGD", lwf=True),
    "aleatoric": dict(opt="SGD", aleatoric=True),
    "class_weights": dict(opt="SGD", cw=True),
    "train_layers": dict(opt="SGD", layers=["b1_conv3", "fc_out"]),
}


@pytest.mark.parametrize("case", list(CASES) + ["zero_pad"])
def test_train_step_matches_jax(monkeypatch, case):
    """One step at lr 0.1 (SGD) or Adam 1e-2 at eps 1e-3 on the DenseNet
    (dropout 0.2), the step's key and JAX's draws shared.  Two rows carry
    weight 0.  ``zero_pad``: they are zeros, as the engine pads, and enter
    the batch statistics in both packages; dropout is 0 there.  Zero rows
    are spatially constant, so their max-pool windows tie exactly in real
    arithmetic, and f32 rounding of the convs decides which input takes
    the window's gradient, differently in each package; through the batch
    statistics that moves every row's gradient.  With dropout 0.2 on such
    a batch the step's parameters part from JAX's (ROADMAP Queue 3),
    while the loss still agrees."""
    inject(monkeypatch)
    c = CASES.get(case, dict(opt="SGD"))
    jspec, params, model = _pair("DenseNet", NCLASS, SHAPE,
                                 dropout_rate=0.0 if case == "zero_pad"
                                 else 0.2,
                                 aleatoric=c.get("aleatoric", False))
    params = _jitter(params, 5)
    model.load_state_dict(from_jax_params(params))
    x, y, w = _batch(zero_pad=case == "zero_pad")
    key, step = jax.random.fold_in(jax.random.key(9), 4), 4
    if c["opt"] == "SGD":
        tx = optax.sgd(0.1)
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
    else:
        tx = optax.adam(1e-2, eps=1e-3)
        opt = torch.optim.Adam(model.parameters(), lr=1e-2,
                               betas=(0.9, 0.999), eps=1e-3)
    kw, teacher = {}, None
    if c.get("mt"):
        teacher = _jitter(params, 6)
        kw.update(consistency_coeff=lambda s: 0.5 * joptim.sigmoid_rampup(
            10)(s), consistency_measure="CE")
    if c.get("lwf"):
        kw.update(lwf_lambda=0.7, lwf_T=2.0)
    old = (np.asarray(apply_cnn(jspec, _jitter(params, 7),
                                jnp.asarray(x)).logits)
           if c.get("lwf") else None)
    cw = (np.array([0.5, 1.0, 1.5], np.float32) if c.get("cw") else None)
    mask = None
    if c.get("layers"):
        kw["grad_mask"] = joptim.layer_train_mask(params, c["layers"])
        mask = toptim.layer_train_mask(model, c["layers"])
    jstep = j_make_train_step(jspec, tx, mc_t=4, **kw)
    jp, _, jloss = jstep(
        jax.tree_util.tree_map(jnp.asarray, params), tx.init(params),
        jnp.asarray(x), jnp.asarray(y), key, jnp.asarray(step),
        None if teacher is None else jax.tree_util.tree_map(jnp.asarray,
                                                             teacher),
        jnp.asarray(w), None if old is None else jnp.asarray(old),
        None if cw is None else jnp.asarray(cw),
        cc_scale=jnp.asarray(0.8, jnp.float32))

    state = TrainState(model=model, optimizer=opt, step=step)
    tkw = dict(mc_t=4, grad_mask=mask)
    if c.get("mt"):
        t_model = CNN(model.spec)
        t_model.load_state_dict(from_jax_params(teacher))
        t_model.requires_grad_(False)
        state.teacher = t_model
        tkw.update(consistency_coeff=lambda s: np.float32(0.5)
                   * toptim.sigmoid_rampup(10)(s), consistency_measure="CE")
    if c.get("lwf"):
        tkw.update(lwf_lambda=0.7, lwf_T=2.0)
    tstep = make_train_step(**tkw)
    loss = tstep(state, torch.from_numpy(x), torch.from_numpy(y), key,
                 torch.from_numpy(w),
                 None if old is None else torch.from_numpy(old),
                 None if cw is None else torch.from_numpy(cw), 0.8)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = to_jax_params(model.state_dict())
    jp = jax.tree_util.tree_map(np.asarray, jp)
    for layer in jp:
        for k in jp[layer]:
            np.testing.assert_allclose(got[layer][k], jp[layer][k],
                                       rtol=0, atol=1e-5,
                                       err_msg=f"{case} {layer}/{k}")
    if mask is not None:
        for layer in params:
            if layer not in c["layers"]:
                np.testing.assert_array_equal(got[layer]["W"],
                                              params[layer]["W"])
