"""The port's finetune loop vs the JAX package's scanned finetune: the
same weights, data and (steps, b) index matrix, dropout 0 (threefry
dropout bits cannot be matched).

The gradients of the two agree to ~1e-7 absolute (f32 summation order).
SGD: each update is lr * grad, so params agree to atol 1e-6.  Adam: its
first steps move a weight by lr * g / (|g| + eps) — about ±lr whatever
|g| is — so with optax's eps = 1e-8 a gradient at the 1e-7 noise floor
(0 in one framework, 1e-9 in the other) can flip a whole 1e-3 step.  The
parameter comparison therefore runs Adam with eps = 1e-3 in BOTH
frameworks, which bounds a noise-driven update difference by
lr * 1e-7 / eps = 1e-7 per step and still checks the loop, the masking
and Adam's count and moments at atol 1e-5.  At the default eps the
per-step losses are compared instead: those flipped noise-floor steps
move them by up to 0.2% relative (observed 1.9e-3 on this data, where one
Adam step throws the loss from 0.8 to 37), so rtol is 1e-2 — a wrong
bias correction or learning rate moves them by O(1)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nnal_tpu.models.cnn import init_cnn
from nnal_tpu.models.optim import make_optimizer as j_make_optimizer
from nnal_tpu.models.specs import create_pw1
from nnal_tpu.models.train import build_batch_index_matrix as j_bim
from nnal_tpu.models.train import make_scanned_finetune
from nnal_tpu_torch.models.bridge import from_jax_params, to_jax_params
from nnal_tpu_torch.models.cnn import CNN
from nnal_tpu_torch.models.specs import create_pw1 as t_create_pw1
from nnal_tpu_torch.models.train import (
    TrainState,
    build_batch_index_matrix,
    finetune_steps,
    init_train_state,
)

torch.set_num_threads(1)

SHAPE = (9, 9, 2)


def _data(n=40, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n,) + SHAPE).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=n)]
    return x, y


def test_batch_index_matrix_is_the_jax_one():
    a = build_batch_index_matrix(70, 16, 2, np.random.default_rng(3))
    b = j_bim(70, 16, 2, np.random.default_rng(3))
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


def _run_both(opt, lr, eps=None):
    """The same 2-epoch finetune (b=16 over 40 samples: 6 real steps,
    ragged tails, and the bucket's all-zero padding steps) in both
    frameworks.  Returns (JAX params, JAX losses, port params, port
    losses, index weights)."""
    spec = create_pw1(2, 0.0, SHAPE)
    params, _ = init_cnn(spec, jax.random.key(0))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    x, y = _data()
    idx_mat, w_mat = build_batch_index_matrix(40, 16, 2,
                                              np.random.default_rng(1))
    cw = np.array([0.7, 1.3], np.float32)

    tx = (j_make_optimizer(opt, lr) if eps is None
          else optax.adam(lr, eps=eps))
    run = make_scanned_finetune(spec, tx, batch_size=16)
    j_params, _, j_losses = run(params, tx.init(params), jnp.asarray(x),
                                jnp.asarray(y), jnp.asarray(idx_mat),
                                jnp.asarray(w_mat), jnp.asarray(cw),
                                jax.random.key(2))

    model = CNN(t_create_pw1(2, 0.0, SHAPE))
    model.load_state_dict(from_jax_params(np_params))
    if eps is None:
        state = init_train_state(model, opt, lr)
    else:
        state = TrainState(model, torch.optim.Adam(model.parameters(), lr=lr,
                                                   eps=eps))
    losses = finetune_steps(state, torch.from_numpy(x), torch.from_numpy(y),
                            idx_mat, w_mat, torch.from_numpy(cw))
    assert state.step == idx_mat.shape[0]
    return (j_params, np.asarray(j_losses), to_jax_params(model.state_dict()),
            np.asarray(losses), w_mat)


@pytest.mark.parametrize("opt,lr,eps,atol", [("SGD", 1e-2, None, 1e-6),
                                             ("Adam", 1e-3, 1e-3, 1e-5)])
def test_finetune_steps_match_scanned_finetune(opt, lr, eps, atol):
    j_params, _, got, losses, w_mat = _run_both(opt, lr, eps)
    assert len(losses) == int((w_mat.sum(1) > 0).sum()) == 6
    for layer in got:
        for k in ("W", "b"):
            np.testing.assert_allclose(got[layer][k],
                                       np.asarray(j_params[layer][k]),
                                       rtol=0, atol=atol,
                                       err_msg=f"{layer}/{k}")


def test_adam_default_eps_loss_trajectory_matches():
    _, j_losses, _, losses, w_mat = _run_both("Adam", 1e-3)
    real = w_mat.sum(1) > 0
    np.testing.assert_allclose(losses, j_losses[real], rtol=1e-2)


def test_zero_weight_steps_are_no_ops():
    spec = t_create_pw1(2, 0.0, SHAPE)
    model = CNN(spec)
    state = init_train_state(model, "Adam", 1e-3)
    x, y = _data(8)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    idx = np.zeros((3, 4), np.int64)
    w = np.zeros((3, 4), np.float32)
    losses = finetune_steps(state, torch.from_numpy(x), torch.from_numpy(y),
                            idx, w, torch.ones(2))
    assert losses == [] and state.step == 3
    assert len(state.optimizer.state) == 0      # Adam count/moments untouched
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])
    # a real step after them is Adam's FIRST step (count 1)
    w[1, :2] = 1.0
    finetune_steps(state, torch.from_numpy(x), torch.from_numpy(y), idx, w,
                   torch.ones(2))
    steps = {float(s["step"]) for s in state.optimizer.state.values()}
    assert steps == {1.0}
