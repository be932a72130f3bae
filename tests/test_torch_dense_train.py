"""The port's dense finetune vs the JAX package's scanned one
(``make_scanned_finetune_fcn``) on the CPU: the small FC-DenseNet-103
with the same carried-over weights, slices, pixel weights and (steps, b)
slice batches, dropout 0.2 with JAX's draws injected
(``tests/torch_jax_draws``).  Held: the masked per-pixel CE and its
gradient against ``jax.grad``; a whole finetune with plain SGD (1e-5),
with ``train_layers`` and, at Adam's larger eps as in
``tests/test_torch_train.py``, with Adam (1e-5); a step whose weighted
pixels sum to 0 is an exact no-op; the dense mean teacher (student,
teacher and EMA within 1e-5); the BN refresh and ``update_bn_stats``
(1e-6 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nnal_tpu.models import optim as joptim
from nnal_tpu.models.cnn import apply_cnn
from nnal_tpu.models.train import (
    _bn_refresh_fwd,
    build_batch_index_matrix,
    build_unlabeled_index_matrix,
    make_scanned_finetune_fcn,
)
from nnal_tpu.models.train import update_bn_stats as j_update_bn_stats
from nnal_tpu_torch.models import optim as toptim
from nnal_tpu_torch.models.bridge import to_jax_params
from nnal_tpu_torch.models.train import (
    MeanTeacher,
    TrainState,
    _dense_step_loss,
    bn_refresh,
    finetune_fcn_steps,
    init_train_state,
    make_teacher,
    update_bn_stats,
)
from torch_jax_dense import dense_pair, np_tree, slices
from torch_jax_draws import inject

torch.set_num_threads(1)

H = 16
S = 6          # real slices; the stack is bucketed to 8


def _data(seed=20):
    """(S+2, H, H, 2) slices, one-hot labels and pixel weights: a few
    labeled pixels per slice with class weights, slice 3 with none (its
    batches are no-ops), the 2 bucket slices zero."""
    rng = np.random.default_rng(seed)
    x, _ = slices(S + 2, H, seed=seed)
    lab = rng.integers(0, 2, (S + 2, H, H))
    y = np.eye(2, dtype=np.float32)[lab]
    wpix = np.where(rng.random((S + 2, H, H)) < 0.05,
                    np.array([0.6, 1.4], np.float32)[lab], 0.0
                    ).astype(np.float32)
    wpix[3] = 0.0
    wpix[S:] = 0.0
    return x, y, wpix


def _matrices(seed=21, epochs=2, b=4):
    """Two epochs of shuffled slice batches (ragged tails, bucket padding
    steps) plus one batch of the unlabeled slice 3 alone."""
    idx, w = build_batch_index_matrix(S, b, epochs,
                                      np.random.default_rng(seed), bucket=8)
    lone = np.zeros((1, b), np.int64)
    lone[0, 0] = 3
    w_lone = np.zeros((1, b), np.float32)
    w_lone[0, 0] = 1.0
    return np.concatenate([idx[:2], lone, idx[2:]]), \
        np.concatenate([w[:2], w_lone, w[2:]])


def _leaves_close(got, want, atol, what=""):
    for layer in want:
        for k in want[layer]:
            np.testing.assert_allclose(
                np.asarray(got[layer][k]), np.asarray(want[layer][k]),
                rtol=0, atol=atol, err_msg=f"{what}{layer}/{k}")


def test_masked_dense_loss_and_gradient(monkeypatch):
    """One step's loss (pixel-weighted CE over the weights' sum) and its
    gradient, dropout from ``fold_in(key, i)``, vs ``jax.grad``."""
    inject(monkeypatch)
    jspec, jp, _, model, _ = dense_pair(H=H)
    x, y, wpix = _data()
    idx = np.array([0, 1, 5, 2])
    key, i = jax.random.key(22), 3

    def loss_fn(params):
        out = apply_cnn(jspec, params, jnp.asarray(x[idx]), train=True,
                        dropout_rng=jax.random.fold_in(key, i))
        per = -jnp.sum(jnp.asarray(y[idx]) * jax.nn.log_softmax(
            out.logits, axis=-1), axis=-1)
        w = jnp.asarray(wpix[idx])
        return jnp.sum(per * w) / jnp.maximum(jnp.sum(w), 1.0)

    want, want_g = jax.jit(jax.value_and_grad(loss_fn))(jp)
    loss = _dense_step_loss(model, torch.from_numpy(x[idx]),
                            torch.from_numpy(y[idx]),
                            torch.from_numpy(wpix[idx]), key, i, None, None,
                            None, None)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    grads = to_jax_params({n: p.grad for n, p in model.named_parameters()})
    _leaves_close(grads, np_tree(want_g), 1e-5, "grad ")


def _run_both(monkeypatch, tx, make_opt, train_layers=None):
    inject(monkeypatch)
    jspec, jp, _, model, _ = dense_pair(H=H)
    x, y, wpix = _data()
    idx_mat, w_mat = _matrices()
    key = jax.random.key(23)
    grad_mask = (joptim.layer_train_mask(jp, train_layers)
                 if train_layers else None)
    run = make_scanned_finetune_fcn(jspec, tx, batch_size=4,
                                    grad_mask=grad_mask)
    j_params, j_opt, _ = run(jp, tx.init(jp), jnp.asarray(x), jnp.asarray(y),
                             jnp.asarray(wpix), jnp.asarray(idx_mat),
                             jnp.asarray(w_mat), key)
    state = TrainState(model, make_opt(model))
    losses = finetune_fcn_steps(
        state, torch.from_numpy(x), torch.from_numpy(y), wpix, idx_mat,
        w_mat, key, grad_mask=(toptim.layer_train_mask(model, train_layers)
                               if train_layers else None))
    do = (wpix.sum(axis=(1, 2))[idx_mat] * w_mat).sum(1) > 0
    assert len(losses) == int(do.sum()) < int((w_mat.sum(1) > 0).sum())
    assert state.step == idx_mat.shape[0]
    return np_tree(j_params), j_opt, state, to_jax_params(
        model.state_dict())


@pytest.mark.parametrize("train_layers", [None, ["last", "up0_l1"]])
def test_sgd_finetune_matches_the_scan(monkeypatch, train_layers):
    """Every step's parameters follow the scan's, within 1e-5; the no-op
    steps (bucket padding and the slice without labels) move nothing."""
    lr = 0.05
    want, _, _, got = _run_both(
        monkeypatch, optax.sgd(lr),
        lambda m: torch.optim.SGD(m.parameters(), lr=lr), train_layers)
    _leaves_close(got, want, 1e-5)


def test_adam_finetune_matches_the_scan(monkeypatch):
    """Adam at eps 1e-3 in both (see ``tests/test_torch_train.py``): the
    parameters within 1e-5, and Adam's step count is the scan's (no-op
    steps do not count)."""
    lr = 1e-3
    want, j_opt, state, got = _run_both(
        monkeypatch, optax.adam(lr, eps=1e-3),
        lambda m: torch.optim.Adam(m.parameters(), lr=lr, eps=1e-3))
    _leaves_close(got, want, 1e-5)
    count = int(jax.tree_util.tree_leaves(j_opt)[0])
    assert {int(s["step"]) for s in state.optimizer.state.values()} == \
        {count}


def test_dense_mean_teacher_matches_the_scan(monkeypatch):
    """The dense mean teacher: the student's unlabeled pass keyed
    ``fold_in(key_i, (1 << 21) + 3)``, the teacher clean on its own batch
    statistics, per-pixel CE consistency with a ramp, the EMA after each
    step: student and teacher within 1e-5."""
    inject(monkeypatch)
    jspec, jp, _, model, _ = dense_pair(H=H)
    x, y, wpix = _data()
    xu, _ = slices(5, H, seed=24)
    idx_mat, w_mat = _matrices()
    u_idx = build_unlabeled_index_matrix(5, 2, idx_mat.shape[0],
                                         np.random.default_rng(25))
    key, lr, step0 = jax.random.key(26), 0.05, 7
    run = make_scanned_finetune_fcn(jspec, optax.sgd(lr), batch_size=4,
                                    consistency_coeff=2.0,
                                    consistency_ramp=10, ema_decay=0.9)
    teacher = jax.tree_util.tree_map(lambda a: a * 0.98, jp)
    j_params, _, j_teacher, _ = run(
        jp, optax.sgd(lr).init(jp), teacher, jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(wpix), jnp.asarray(idx_mat), jnp.asarray(w_mat), key,
        jnp.asarray(step0, jnp.float32), jnp.asarray(0.5, jnp.float32),
        jnp.asarray(xu), jnp.asarray(u_idx))
    state = init_train_state(model, "SGD", lr)
    state.teacher = make_teacher(model)
    with torch.no_grad():
        for p in state.teacher.parameters():
            p.mul_(0.98)
    finetune_fcn_steps(
        state, torch.from_numpy(x), torch.from_numpy(y), wpix, idx_mat,
        w_mat, key, mt=MeanTeacher(
            xu_all=torch.from_numpy(xu), u_idx=u_idx, coeff=2.0,
            cc_scale=0.5, ramp=10, ema_decay=0.9, step0=step0))
    _leaves_close(to_jax_params(model.state_dict()), np_tree(j_params),
                  1e-5, "student ")
    _leaves_close(to_jax_params(state.teacher.state_dict()),
                  np_tree(j_teacher), 1e-5, "teacher ")


def _state_close(got, want):
    for layer in want:
        for k in ("mean", "var"):
            w = np.asarray(want[layer][k])
            np.testing.assert_allclose(got[layer][k].numpy(), w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max())


def test_bn_refresh_and_update_bn_stats():
    """``_bn_refresh_fwd`` (train-mode forward at decay 0.6, no dropout)
    and ``update_bn_stats`` over a batch generator."""
    jspec, jp, jst, model, tst = dense_pair(H=H)
    x, xt = slices(4, H, seed=27)
    want = _bn_refresh_fwd(jspec, 0.6)(jp, jst, jnp.asarray(x))
    _state_close(bn_refresh(model, tst, xt, 0.6), want)

    def gen(seed):
        rng = np.random.default_rng(seed)
        return lambda: rng.normal(size=(2, H, H, 2)).astype(np.float32)

    want = j_update_bn_stats(jspec, jp, jst, gen(28), iters=3, bn_decay=0.8)
    _state_close(update_bn_stats(model, tst, gen(28), iters=3,
                                 bn_decay=0.8), want)
