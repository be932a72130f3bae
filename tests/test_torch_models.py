"""PyTorch port vs the JAX package: weight bridge, PW1 forward, checkpoints.

Inputs and weights come from numpy/JAX seeds and go through both
packages on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nnal_tpu.models import checkpoint as jck
from nnal_tpu.models.cnn import apply_cnn, init_cnn
from nnal_tpu.models.specs import create_pw1
from nnal_tpu_torch.models import checkpoint as tck
from nnal_tpu_torch.models.bridge import from_jax_params, to_jax_params
from nnal_tpu_torch.models.cnn import CNN
from nnal_tpu_torch.models.optim import (
    load_opt_state,
    make_optimizer,
    opt_state_leaves,
)
from nnal_tpu_torch.models.specs import create_pw1 as t_create_pw1

torch.set_num_threads(1)


def _jax_params(shape, seed=0):
    spec = create_pw1(2, 0.5, shape)
    params, _ = init_cnn(spec, jax.random.key(seed))
    return spec, jax.tree_util.tree_map(np.asarray, params)


def _port_model(shape, np_params):
    model = CNN(t_create_pw1(2, 0.5, shape))
    model.load_state_dict(from_jax_params(np_params))
    return model


def test_bridge_round_trip_is_exact():
    _, params = _jax_params((9, 9, 2))
    back = to_jax_params(from_jax_params(params))
    assert sorted(back) == sorted(params)
    for layer in params:
        for k in ("W", "b"):
            np.testing.assert_array_equal(back[layer][k], params[layer][k])


# 9x9 pools 9 -> 5 -> 3 and 25x25 pools 25 -> 13 -> 7 (end-only -inf pad);
# 24x24 pools evenly.  Tolerance: both run IEEE f32 with different
# summation orders (XLA vs oneDNN convs, 4096-wide fc sums), so logits
# agree to ~1e-6 relative; rtol 1e-4 / atol 1e-5 leaves a wide margin and
# still catches any layout or padding error (those move logits by O(1)).
@pytest.mark.parametrize("shape", [(9, 9, 2), (24, 24, 2), (25, 25, 2)])
def test_pw1_forward_matches_apply_cnn(shape):
    spec, params = _jax_params(shape, seed=1)
    x = np.random.default_rng(0).normal(size=(6,) + shape).astype(np.float32)
    ref = apply_cnn(spec, jax.tree_util.tree_map(jnp.asarray, params),
                    jnp.asarray(x))
    with torch.no_grad():
        out = _port_model(shape, params)(torch.from_numpy(x))
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(ref.logits),
                               **tol)
    np.testing.assert_allclose(out.posteriors.numpy(),
                               np.asarray(ref.posteriors), **tol)
    np.testing.assert_allclose(out.feature.numpy(), np.asarray(ref.feature),
                               **tol)
    np.testing.assert_array_equal(out.prediction.numpy(),
                                  np.asarray(ref.prediction))


def test_dropout_follows_every_fc_including_the_head():
    """At a drop rate near 1, fc3's input is all zero, so its output is
    its bias (1 here); only a dropout AFTER the head can zero the logits."""
    _, params = _jax_params((9, 9, 2))
    model = CNN(t_create_pw1(2, 0.999999, (9, 9, 2)))
    model.load_state_dict(from_jax_params(params))
    with torch.no_grad():
        model.fc3.bias.fill_(1.0)
    x = torch.randn(4, 9, 9, 2, generator=torch.Generator().manual_seed(0))
    out = model(x, train=True, generator=torch.Generator().manual_seed(1))
    assert torch.count_nonzero(out.logits) == 0
    # no generator -> no dropout, as apply_cnn without a dropout key
    out_eval = model(x, train=True)
    assert torch.count_nonzero(out_eval.logits) > 0


def test_jax_checkpoint_loads_into_port(tmp_path):
    spec, params = _jax_params((9, 9, 2), seed=2)
    path = str(tmp_path / "init_weights.npz")
    jck.save_checkpoint(path, params, al_state={"step": 3, "round": 1})
    p2, bn, teacher, al = tck.load_checkpoint(path)
    assert bn is None and teacher is None and al == {"step": 3, "round": 1}
    model = _port_model((9, 9, 2), p2)
    x = np.random.default_rng(1).normal(size=(3, 9, 9, 2)).astype(np.float32)
    ref = apply_cnn(spec, jax.tree_util.tree_map(jnp.asarray, params),
                    jnp.asarray(x)).posteriors
    with torch.no_grad():
        got = model(torch.from_numpy(x)).posteriors.numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-5)
    os.remove(path)            # ~80 MB at PW1's full width


def test_port_checkpoint_loads_into_jax_with_adam_moments(tmp_path):
    _, params = _jax_params((9, 9, 2), seed=3)
    model = _port_model((9, 9, 2), params)
    opt = make_optimizer("Adam", 1e-3, model.parameters())
    x = torch.randn(5, 9, 9, 2, generator=torch.Generator().manual_seed(0))
    model(x).logits.sum().backward()
    opt.step()
    path = str(tmp_path / "curr_weights.npz")
    tck.save_checkpoint(path, to_jax_params(model.state_dict()),
                        al_state={"step": 1, "round": 1},
                        opt_state=opt_state_leaves(opt, model))
    jparams, _, _, al = jck.load_checkpoint(path)
    assert al == {"step": 1, "round": 1}
    want = to_jax_params(model.state_dict())
    for layer in want:
        for k in ("W", "b"):
            np.testing.assert_array_equal(jparams[layer][k], want[layer][k])
    # optax's Adam state reads the port's leaves positionally
    tx = optax.adam(1e-3)
    st = jck.restore_opt_state(path, tx.init(jparams))
    adam = st[0]
    assert int(adam.count) == 1
    mu_t = {n: opt.state[p]["exp_avg"] for n, p in model.named_parameters()}
    mu_j = to_jax_params(mu_t)
    for layer in mu_j:
        np.testing.assert_array_equal(np.asarray(adam.mu[layer]["W"]),
                                      mu_j[layer]["W"])
    # and back into a fresh port optimizer
    opt2 = make_optimizer("Adam", 1e-3, model.parameters())
    load_opt_state(opt2, model, tck.load_opt_leaves(path))
    for p in model.parameters():
        torch.testing.assert_close(opt2.state[p]["exp_avg_sq"],
                                   opt.state[p]["exp_avg_sq"], rtol=0,
                                   atol=0)
        assert float(opt2.state[p]["step"]) == 1.0
    os.remove(path)            # ~250 MB with both Adam moments


def test_unsupported_checkpoint_dtype_raises(tmp_path):
    """bf16 and int8 anchors are ported (tests/test_torch_anchors.py); a
    storage dtype the JAX package rejects raises the same way."""
    from nnal_tpu.models.checkpoint import save_checkpoint as j_save

    _, params = _jax_params((9, 9, 2))
    for save in (tck.save_checkpoint, j_save):
        with pytest.raises(ValueError, match="unsupported checkpoint dtype"):
            save(str(tmp_path / "w.npz"), params, dtype="float16")
    assert not os.listdir(tmp_path)
