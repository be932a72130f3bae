"""The mean teacher (MT-SSL) and the training levers' loss terms of the
port vs the JAX package (CPU), on the same seeded numpy inputs and the
same weights (``models/bridge.from_jax_params``):

* the loss pieces: ``consistency_loss`` (CE, MSE), the aleatoric CE with
  JAX's normals fed through the port's draw function, the LwF term as the
  scan computes it, ``sigmoid_rampup`` / ``sigmoid_rampdown``,
  ``mt_rampdown`` (start and off labels) and ``ema_update``: atol 1e-6;
* whole finetune steps from the same params with JAX's dropout and normal
  draws injected (``tests/torch_jax_draws``), Adam at eps 1e-3 in both
  (``tests/test_torch_train.py`` says why): the mean teacher (CE and MSE,
  with a ramp), LwF, the aleatoric CE, and all three at once.  Losses
  atol 1e-5, parameters and the teacher atol 1e-5;
* the mean teacher at ``train_dtype`` bf16: the loss within 2e-2 and
  the updates in JAX's direction;
* padding steps leave the teacher alone (crash-resume with the teacher:
  ``tests/test_torch_mt_resume.py``).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nnal_tpu.engine import common as jcommon
from nnal_tpu.models import losses as jlosses
from nnal_tpu.models import optim as joptim
from nnal_tpu.models.cnn import init_cnn
from nnal_tpu.models.specs import create_pw1, with_aleatoric_head
from nnal_tpu.models.surgery import extend_params_to_aleatoric
from nnal_tpu.models.train import make_scanned_finetune
from nnal_tpu_torch.engine import common as tcommon
from nnal_tpu_torch.models import losses as tlosses
from nnal_tpu_torch.models import optim as toptim
from nnal_tpu_torch.models.bridge import from_jax_params, to_jax_params
from nnal_tpu_torch.models.cnn import CNN
from nnal_tpu_torch.models.specs import create_pw1 as t_create_pw1
from nnal_tpu_torch.models.specs import (
    with_aleatoric_head as t_with_aleatoric_head,
)
from nnal_tpu_torch.models.train import (
    LwF,
    MeanTeacher,
    TrainState,
    build_batch_index_matrix,
    build_unlabeled_index_matrix,
    finetune_steps,
    make_teacher,
)
from torch_jax_draws import KeyGen, inject

torch.set_num_threads(1)

SHAPE = (9, 9, 2)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _logits(n=48, c=2, seed=0, scale=2.0):
    return np.random.default_rng(seed).normal(
        scale=scale, size=(n, c)).astype(np.float32)


# --------------------------------------------------------------- the pieces
@pytest.mark.parametrize("measure", ["CE", "MSE"])
def test_consistency_loss_matches_jax(measure):
    s, t = _logits(seed=1), _logits(seed=2)
    want = float(jlosses.consistency_loss(s, t, measure))
    got = tlosses.consistency_loss(_t(s), _t(t), measure)
    np.testing.assert_allclose(float(got), want, rtol=0, atol=1e-6)
    # the teacher's side carries no gradient
    st, tt = _t(s).requires_grad_(), _t(t).requires_grad_()
    tlosses.consistency_loss(st, tt, measure).backward()
    assert tt.grad is None and st.grad is not None
    with pytest.raises(ValueError):
        tlosses.consistency_loss(_t(s), _t(t), "KL")


@pytest.mark.parametrize("sigma_scale,rtol", [(1.0, 0.0), (30.0, 1e-6)])
def test_aleatoric_ce_matches_jax(monkeypatch, sigma_scale, rtol):
    """JAX's normals for each of ``split(key, mc_t)`` through the port's
    draw function; a log-sigma scale of 30 exercises the [-10, 10]
    clamp, where sigma reaches e^10 and the CE ~1e4, so that case is
    held relative to f32 rounding (rtol 1e-6) as well."""
    inject(monkeypatch)
    logits = _logits(seed=3)
    log_sigma = _logits(seed=4, scale=sigma_scale)
    y = np.eye(2, dtype=np.float32)[np.arange(48) % 2]
    key = jax.random.key(7)
    want = np.asarray(jlosses.aleatoric_ce_per_sample(
        logits, log_sigma, y, key, 6))
    got = tlosses.aleatoric_ce_per_sample(_t(logits), _t(log_sigma), _t(y),
                                          KeyGen(key), 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=1e-6)
    np.testing.assert_allclose(
        float(tlosses.aleatoric_ce(_t(logits), _t(log_sigma), _t(y),
                                   KeyGen(key), 6)),
        float(jlosses.aleatoric_ce(logits, log_sigma, y, key, 6)),
        rtol=rtol, atol=1e-6)
    assert np.isfinite(got.numpy()).all()


def test_lwf_term_matches_the_scan():
    """``train.py:265-270``: per row, then w-weighted (zero rows add
    nothing)."""
    logits, old = _logits(seed=5), _logits(seed=6)
    w = np.ones(48, np.float32)
    w[40:] = 0.0
    T = 2.0
    soft = jax.nn.softmax(old / T, axis=-1)
    lp = jax.nn.log_softmax(logits / T, axis=-1)
    dper = -jnp.sum(soft * lp, axis=-1)
    want = float(jnp.sum(dper * w) / jnp.maximum(jnp.sum(w), 1.0))
    got = float(tlosses.lwf_distillation(_t(logits), _t(old), _t(w), T))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the unweighted convenience form is the scan's term at w = 1
    np.testing.assert_allclose(
        float(jlosses.lwf_loss(logits, np.eye(2)[np.arange(48) % 2], old,
                               1.0, T)
              - jlosses.cross_entropy(logits, np.eye(2)[np.arange(48) % 2])),
        float(tlosses.lwf_distillation(_t(logits), _t(old),
                                       torch.ones(48), T)),
        rtol=0, atol=1e-6)


def test_ramps_match_jax():
    t = np.arange(0, 60, dtype=np.float32)
    for L in (1, 7, 20):
        np.testing.assert_allclose(toptim.sigmoid_rampup(L)(t),
                                   np.asarray(joptim.sigmoid_rampup(L)(t)),
                                   rtol=0, atol=1e-6)
    for L, total in ((5, 30), (20, 40)):
        np.testing.assert_allclose(
            toptim.sigmoid_rampdown(L, total)(t),
            np.asarray(joptim.sigmoid_rampdown(L, total)(t)),
            rtol=0, atol=1e-6)
    assert toptim.sigmoid_rampup(7)(np.float32(3.0)).dtype == np.float32


@pytest.mark.parametrize("start,off", [(0, 0), (0, 100), (30, 0),
                                       (30, 100)])
def test_mt_rampdown_matches_jax(start, off):
    m = types.SimpleNamespace(consistency_coeff=0.7,
                              consistency_start_labels=start,
                              consistency_off_labels=off)
    for n in range(0, 130, 3):
        got, want = tcommon.mt_rampdown(m, n), jcommon.mt_rampdown(m, n)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    off_cfg = types.SimpleNamespace(consistency_coeff=0.0)
    assert tcommon.mt_rampdown(off_cfg, 5) == (0.0, 1.0)


def _pair(seed=0, dropout=0.5, aleatoric=False):
    """A JAX PW1 (9x9x2) and the port's model on the same weights; the
    aleatoric head by the surgery a user applies to trained weights (the
    log-sigma half zero, so sigma starts at 1)."""
    spec = create_pw1(2, dropout, SHAPE)
    tspec = t_create_pw1(2, dropout, SHAPE)
    params, _ = init_cnn(spec, jax.random.key(seed))
    if aleatoric:
        spec, tspec = with_aleatoric_head(spec), t_with_aleatoric_head(tspec)
        params = jax.tree_util.tree_map(jnp.asarray, extend_params_to_aleatoric(
            jax.tree_util.tree_map(np.asarray, params), "fc3"))
    model = CNN(tspec)
    model.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    return spec, params, model


def test_ema_update_matches_jax():
    _, teacher, tmodel = _pair(0)
    _, student, smodel = _pair(1)
    want = joptim.ema_update(teacher, student, 0.99)
    toptim.ema_update(tmodel, smodel, 0.99)
    got = to_jax_params(tmodel.state_dict())
    for layer in got:
        for k in ("W", "b"):
            np.testing.assert_allclose(got[layer][k],
                                       np.asarray(want[layer][k]), rtol=0,
                                       atol=1e-6, err_msg=f"{layer}/{k}")


# --------------------------------------------------------------- the steps
def _data(n=40, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n,) + SHAPE).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=n)]
    return x, y


def _perturbed(params, seed):
    """A teacher (numpy) that differs from the student, so the consistency
    term has a gradient from the first step."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.02 * rng.normal(
            size=v.shape).astype(np.float32), params)


LEVERS = {
    "mt-CE": dict(mt="CE"),
    "mt-MSE-ramp": dict(mt="MSE", ramp=5),
    "lwf": dict(lwf=0.8),
    "aleatoric": dict(aleatoric=True),
    "all": dict(mt="CE", ramp=3, lwf=0.5, aleatoric=True),
}


@pytest.mark.parametrize("name", sorted(LEVERS))
def test_finetune_step_matches_jax(monkeypatch, name):
    """One step from the same params, with JAX's draws: the labeled pass's
    dropout, the aleatoric normals and the student's unlabeled pass's
    dropout, each from its own key, at ``step0`` of the ramp, then the
    EMA.  It is the first row of a 16-row batch matrix over 40 rows; the
    rest is zero-weighted, so both skip it.  Loss, params and teacher
    atol 1e-5.  (Each step of this freshly initialized PW1 moves its loss
    by O(1), so later steps amplify f32 summation-order differences past
    that bound; ``tests/test_torch_train.py`` holds multi-step runs of
    the plain loss.)"""
    inject(monkeypatch)
    lv = LEVERS[name]
    spec, params, model = _pair(0, aleatoric=lv.get("aleatoric", False))
    x, y = _data()
    xu = _data(24, seed=9)[0]
    idx_mat, w_mat = build_batch_index_matrix(40, 16, 2,
                                              np.random.default_rng(1))
    w_mat[1:] = 0.0
    u_idx = build_unlabeled_index_matrix(24, 12, idx_mat.shape[0],
                                         np.random.default_rng(2))
    cw = np.array([0.7, 1.3], np.float32)
    key = jax.random.key(11)
    tx = optax.adam(1e-4, eps=1e-3)
    mt_kw = {}
    if "mt" in lv:
        mt_kw = dict(consistency_coeff=0.9, consistency_measure=lv["mt"],
                     consistency_ramp=lv.get("ramp", 0), ema_decay=0.9)
    lam = lv.get("lwf", 0.0)
    run = make_scanned_finetune(spec, tx, batch_size=16, mc_t=4,
                                lwf_lambda=lam, lwf_T=2.0, **mt_kw)
    old = None
    if lam:
        _, _, omodel = _pair(3, aleatoric=lv.get("aleatoric", False))
        with torch.no_grad():
            old = omodel(torch.from_numpy(x)).logits.numpy()
    step0, cc_scale = 6, 0.75
    teacher0 = _perturbed(params, 4)
    args = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(idx_mat),
            jnp.asarray(w_mat), jnp.asarray(cw), key)
    if mt_kw:
        jp, _, jteacher, jl = run(
            params, tx.init(params),
            jax.tree_util.tree_map(jnp.asarray, teacher0), *args,
            jnp.asarray(step0, jnp.float32),
            jnp.asarray(cc_scale, jnp.float32), jnp.asarray(xu),
            jnp.asarray(u_idx), None if old is None else jnp.asarray(old))
    else:
        jp, _, jl = run(params, tx.init(params), *args,
                        None if old is None else jnp.asarray(old))

    opt = torch.optim.Adam(model.parameters(), lr=1e-4, eps=1e-3)
    state = TrainState(model, opt, step=step0)
    mt = None
    if mt_kw:
        state.teacher = make_teacher(model)
        state.teacher.load_state_dict(from_jax_params(teacher0))
        mt = MeanTeacher(xu_all=torch.from_numpy(xu), u_idx=u_idx,
                         coeff=0.9, cc_scale=cc_scale, measure=lv["mt"],
                         ramp=lv.get("ramp", 0), ema_decay=0.9, step0=step0)
    losses = finetune_steps(
        state, torch.from_numpy(x), torch.from_numpy(y), idx_mat, w_mat,
        torch.from_numpy(cw), key, mc_t=4,
        lwf=None if old is None else LwF(torch.from_numpy(old), lam, 2.0),
        mt=mt)
    real = w_mat.sum(1) > 0
    assert len(losses) == int(real.sum()) == 1
    np.testing.assert_allclose(losses, np.asarray(jl)[real], rtol=0,
                               atol=1e-5)
    pairs = [(to_jax_params(model.state_dict()), jp)]
    if mt_kw:
        pairs.append((to_jax_params(state.teacher.state_dict()), jteacher))
    for got, want in pairs:
        for layer in got:
            for k in ("W", "b"):
                np.testing.assert_allclose(
                    got[layer][k], np.asarray(want[layer][k]), rtol=0,
                    atol=1e-5, err_msg=f"{layer}/{k}")


def test_padding_steps_leave_the_teacher():
    _, _, model = _pair(0)
    x, y = _data(8)
    state = TrainState(model, torch.optim.Adam(model.parameters(), lr=1e-3),
                       teacher=make_teacher(model))
    before = {k: v.clone() for k, v in state.teacher.state_dict().items()}
    idx = np.zeros((3, 4), np.int64)
    w = np.zeros((3, 4), np.float32)
    mt = MeanTeacher(xu_all=torch.from_numpy(x), u_idx=np.zeros((3, 4)),
                     coeff=1.0)
    assert finetune_steps(state, torch.from_numpy(x), torch.from_numpy(y),
                          idx, w, torch.ones(2), 3, mt=mt) == []
    assert state.step == 3
    for k, v in state.teacher.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(not p.requires_grad for p in state.teacher.parameters())
    with pytest.raises(ValueError, match="teacher"):
        finetune_steps(TrainState(model, state.optimizer),
                       torch.from_numpy(x), torch.from_numpy(y), idx,
                       np.ones_like(w), torch.ones(2), 3, mt=mt)


def test_bf16_mt_step_tracks_jax(monkeypatch):
    """``train_dtype`` bf16: the student (both passes) and the teacher
    forward on bf16 copies, the EMA and Adam stay f32.  One step with
    JAX's draws: the loss within 2e-2 relative and the parameter and
    teacher updates in the same direction (cosine > 0.95), the
    bf16 rules of ``tests/test_torch_mixed_precision.py``."""
    inject(monkeypatch)
    spec, params, model = _pair(0)
    x, y = _data()
    xu = _data(24, seed=9)[0]
    idx_mat, w_mat = build_batch_index_matrix(40, 16, 1,
                                              np.random.default_rng(1))
    w_mat[1:] = 0.0
    u_idx = build_unlabeled_index_matrix(24, 12, idx_mat.shape[0],
                                         np.random.default_rng(2))
    key = jax.random.key(11)
    tx = optax.adam(1e-4, eps=1e-3)
    teacher0 = _perturbed(params, 4)
    run = make_scanned_finetune(spec, tx, batch_size=16,
                                compute_dtype=jnp.bfloat16,
                                consistency_coeff=0.9, ema_decay=0.9)
    p0 = jax.tree_util.tree_map(np.asarray, params)
    jp, _, jt, jl = run(params, tx.init(params),
                        jax.tree_util.tree_map(jnp.asarray, teacher0),
                        jnp.asarray(x), jnp.asarray(y), jnp.asarray(idx_mat),
                        jnp.asarray(w_mat), jnp.ones(2, jnp.float32), key,
                        jnp.asarray(0.0, jnp.float32),
                        jnp.asarray(1.0, jnp.float32), jnp.asarray(xu),
                        jnp.asarray(u_idx))
    state = TrainState(model, torch.optim.Adam(model.parameters(), lr=1e-4,
                                               eps=1e-3),
                       teacher=make_teacher(model))
    state.teacher.load_state_dict(from_jax_params(teacher0))
    losses = finetune_steps(
        state, torch.from_numpy(x), torch.from_numpy(y), idx_mat, w_mat,
        torch.ones(2), key, compute_dtype=torch.bfloat16,
        mt=MeanTeacher(xu_all=torch.from_numpy(xu), u_idx=u_idx, coeff=0.9,
                       ema_decay=0.9))
    np.testing.assert_allclose(losses, np.asarray(jl)[:1], rtol=2e-2)
    assert all(p.dtype == torch.float32
               for m in (model, state.teacher) for p in m.parameters())

    def flat(tree):
        return np.concatenate([np.ravel(tree[l][k]) for l in sorted(tree)
                               for k in ("W", "b")])

    for got, want, base in (
            (to_jax_params(model.state_dict()), jp, p0),
            (to_jax_params(state.teacher.state_dict()), jt, teacher0)):
        dt = flat(got) - flat(base)
        dj = flat(jax.tree_util.tree_map(np.asarray, want)) - flat(base)
        cos = np.dot(dt, dj) / (np.linalg.norm(dt) * np.linalg.norm(dj))
        assert cos > 0.95, cos
