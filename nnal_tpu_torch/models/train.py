"""Finetuning (counterpart of ``nnal_tpu/models/train.py``: the patch-wise
``make_scanned_finetune`` with its levers, the dense
``make_scanned_finetune_fcn``, the BN refresh, and the step-bounded
``train`` / ``validated_train`` loops of the analysis harness).

The JAX package runs a round's finetune as one jitted ``lax.scan`` over a
precomputed ``(steps, b)`` index matrix; here it is a Python loop over the
same matrix (PyTorch runs eagerly, so the loop is the natural form).  Each
step's loss is the scan's (``train.py:251-282``):

* CE, or the aleatoric CE when the spec has the sigma head, times the
  class weight, as a ``w``-weighted mean over the batch rows;
* ``+ lwf_lambda x`` the LwF distillation against the previous model's
  logits of the same rows (:class:`LwF`);
* ``+ coeff(step0 + i) x`` the consistency of the student on an unlabeled
  batch (with dropout) with the EMA teacher on it (clean), the mean
  teacher (:class:`MeanTeacher`);

then the ``train_layers`` gradient mask, the optimizer step and, under
the mean teacher, the EMA update of the teacher **after** the step.  Steps
whose weights sum to 0 (the bucket padding steps) are skipped outright —
the scan computes them and then discards the update, so in both the
parameters, Adam's step count and moments, and the teacher do not move.

Draws are keyed like the scan's: step ``i`` (its row in the matrix) takes
``key_i = fold_key(key, i)``; the labeled pass's dropout comes from
``key_i`` itself, the aleatoric normals from ``fold_key(key_i, 1)``, and
the student's unlabeled-pass dropout from ``fold_key(key_i, (1 << 21) +
3)``.  Each has its own generator (``core/rng.key_generator``), so no
pass's masks depend on the order of the others, and a test can feed all
three JAX's draws.

``compute_dtype=torch.bfloat16`` (``model.train_dtype``) trains mixed
precision (``train.py:51-62``): f32 master weights and f32 Adam state;
each step's bf16 copies are made inside the differentiated function
(``torch.func.functional_call`` over ``p.to(bf16)``), so the gradients
reach the f32 parameters as f32.  The student's unlabeled pass reuses the
step's bf16 copies, the teacher forwards on bf16 copies of its own, and
the EMA stays f32.  ``torch.autocast`` is not used: it picks its own cast
points, which would not mirror the JAX casts.

The classification engine's step (:func:`make_train_step`,
``train.py:65-147``) takes one optimizer step on one padded batch: the
same labeled terms (without class weights on the aleatoric CE, as that
step has none there), and the mean teacher's consistency of the
student's labeled pass (with dropout) with the teacher on the SAME batch
(clean, on its batch statistics), times ``coeff(step) x cc_scale``.  Its
dropout reads the step key the engine folds (``fold_key(jrng, step)``)
as is (``core/rng.key_stream``), and the aleatoric normals take
``fold_key(key, 1)``.  The engine does the EMA update after the step.

The dense finetune (:func:`finetune_fcn_steps`, ``train.py:360-505``)
trains on whole slices: the per-pixel CE is weighted by ``wpix`` (1, or
the class weight, at the queried voxels and 0 elsewhere) and divided by
the weights' sum (at least 1); a step whose weighted pixels sum to 0 is an
exact no-op, as the scan's ``do = sum(wpix) > 0``.  Its keys are the
patch finetune's (the labeled pass from ``key_i``, the student's unlabeled
pass from ``fold_key(key_i, (1 << 21) + 3)``); the mean teacher's
consistency runs over every pixel of the unlabeled slices, the teacher
forwarding clean on its own batch statistics.  The training passes
normalize by batch statistics and leave the BN running state alone;
:func:`bn_refresh` (``_bn_refresh_fwd``) moves it afterwards with
train-mode forwards without dropout, at f32.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.func import functional_call

from nnal_tpu_torch.core import rng as core_rng
from nnal_tpu_torch.data.batching import gen_batch_inds
from nnal_tpu_torch.models.losses import (
    aleatoric_ce_per_sample,
    consistency_loss,
    fcn_cross_entropy,
    lwf_distillation,
    weight_decay_penalty,
    weighted_mean,
)
from nnal_tpu_torch.models.optim import (
    apply_grad_mask,
    ema_update,
    make_optimizer,
    sigmoid_rampup,
)

# the fold tags of the scan (``train.py:268``, ``:277``)
ALEATORIC_FOLD = 1
STUDENT_UNLAB_FOLD = (1 << 21) + 3


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    teacher: Optional[torch.nn.Module] = None   # the mean teacher (EMA)
    bn_state: Optional[Dict] = None     # BN running stats {layer: {mean, var}}
    metrics: Dict[str, List[float]] = field(default_factory=dict)


@dataclass
class LwF:
    """Learning without forgetting: ``old_logits`` are the previous model's
    logits of every row of ``x_all`` (f32, no dropout), taken once per
    round before any step."""
    old_logits: torch.Tensor
    lam: float
    T: float = 2.0


@dataclass
class MeanTeacher:
    """The mean teacher's term of a finetune: step ``i`` reads the
    unlabeled rows ``xu_all[u_idx[i]]``; its coefficient is
    ``coeff x cc_scale x sigmoid_rampup(ramp)(step0 + i)`` (no ramp when
    ``ramp`` is 0), in float32 (:func:`mt_coefficient`)."""
    xu_all: torch.Tensor
    u_idx: np.ndarray
    coeff: float
    cc_scale: float = 1.0
    measure: str = "CE"
    ramp: int = 0
    ema_decay: float = 0.99
    step0: int = 0


def mt_coefficient(mt: MeanTeacher, i: int) -> float:
    """The consistency coefficient of step ``i`` as the scan traces it:
    ``(coeff * cc_scale) * ramp(step0 + i)``, every operand float32."""
    c = np.float32(mt.coeff) * np.float32(mt.cc_scale)
    if mt.ramp > 0:
        c = c * sigmoid_rampup(mt.ramp)(np.float32(mt.step0)
                                        + np.float32(i))
    return float(np.float32(c))


def init_train_state(model, optimizer_name="SGD", learning_rate=1e-3
                     ) -> TrainState:
    return TrainState(model=model, optimizer=make_optimizer(
        optimizer_name, learning_rate, model.parameters()))


def batch_tensor(a, device) -> torch.Tensor:
    """A host or device batch as a tensor on ``device``; float64 becomes
    f32, as ``jnp.asarray`` makes it with x64 off."""
    t = torch.as_tensor(a)
    return (t.float() if t.dtype == torch.float64 else t).to(device)


def train(state: TrainState, step_fn, train_gen, *, step_limit: int, rng,
          eval_every: int = 0, eval_fn: Optional[Callable] = None,
          metric_name: str = "valid", track_best: bool = False,
          ema_decay: float = 0.999):
    """Step-bounded loop (``train.py:168-205``; reference
    NN_extended.py:928-1008).  ``train_gen`` yields ``(x, y)`` batches
    on the host or the device (channels last, one-hot ``y``); ``step_fn(state, x, y, key)``
    is :func:`make_train_step`'s, keyed ``fold_key(rng, state.step)``;
    the mean teacher, when ``state.teacher`` is set, moves after each
    step.  ``eval_fn(model) -> float`` runs every ``eval_every`` steps
    into ``state.metrics[metric_name]``; with ``track_best`` the
    best-metric weights are kept.  Returns the state and the best weights
    (a ``state_dict`` copy; the final weights' without a tracked best)."""
    dev = next(state.model.parameters()).device
    best, best_metric = None, -np.inf
    history = state.metrics.setdefault(metric_name, [])
    losses = state.metrics.setdefault("train_loss", [])
    while state.step < step_limit:
        x, y = next(train_gen)
        loss = step_fn(state, batch_tensor(x, dev), batch_tensor(y, dev),
                       core_rng.fold_key(rng, state.step))
        losses.append(float(loss))
        if state.teacher is not None:
            ema_update(state.teacher, state.model, ema_decay)
        state.step += 1
        if eval_every and eval_fn and state.step % eval_every == 0:
            m = float(eval_fn(state.model))
            history.append(m)
            if track_best and m > best_metric:
                best_metric = m
                best = {k: v.detach().clone()
                        for k, v in state.model.state_dict().items()}
    return state, (best if best is not None else state.model.state_dict())


def validated_train(state: TrainState, step_fn, train_gen, *,
                    step_limit: int, rng, eval_fn, eval_every: int
                    ) -> TrainState:
    """Validated training with best-weights rollback (``train.py:555-565``;
    reference ``validated_train``, NN.py:744): after the loop the weights
    revert to the best validation point."""
    state, best = train(state, step_fn, train_gen, step_limit=step_limit,
                        rng=rng, eval_every=eval_every, eval_fn=eval_fn,
                        track_best=True)
    state.model.load_state_dict(best)
    return state


def make_teacher(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``model`` as the mean teacher's starting point
    (``pw_experiment.py:328-330``); it takes no gradients."""
    import copy

    teacher = copy.deepcopy(model)
    teacher.requires_grad_(False)
    return teacher


def build_batch_index_matrix(n: int, batch_size: int, epochs: int, rng,
                             bucket: int = 256):
    """(steps, b) index matrix + (steps, b) validity weights with the same
    shuffled partition semantics as ``gen_batch_inds`` (ragged tails padded
    with index 0, weight 0).  The step count is padded with all-masked
    no-op steps up to the count a ``bucket``-multiple-sized set would
    need — kept so both packages draw and count steps identically."""
    rows, weights = [], []
    for _ in range(epochs):
        for batch in gen_batch_inds(n, batch_size, rng):
            pad = batch_size - len(batch)
            rows.append(np.concatenate([batch,
                                        np.zeros(pad, np.int64)]))
            weights.append(np.concatenate([np.ones(len(batch), np.float32),
                                           np.zeros(pad, np.float32)]))
    if bucket:
        n_bucket = int(-(-n // bucket)) * bucket
        steps_target = epochs * (-(-n_bucket // batch_size) + 1)
        while len(rows) < steps_target:
            rows.append(np.zeros(batch_size, np.int64))
            weights.append(np.zeros(batch_size, np.float32))
    return np.stack(rows), np.stack(weights)


def build_unlabeled_index_matrix(n_u: int, ub: int, steps: int, rng
                                 ) -> np.ndarray:
    """(steps, ub) indices drawn with replacement into the round's gathered
    unlabeled subset — the mean teacher's consistency batches, the same
    host draws as ``train.py:517-522``."""
    return rng.integers(0, n_u, size=(steps, ub)).astype(np.int32)


def cast_for_forward(compute_dtype, model, x):
    """The forward at ``compute_dtype`` (``_cast_for_forward``): a callable
    that runs ``model`` on bf16 copies of its parameters and of ``x``, or
    the model itself at f32."""
    if compute_dtype is None:
        return model, x
    params = {k: p.to(compute_dtype) for k, p in model.named_parameters()}
    return (lambda xx, **kw: functional_call(model, params, (xx,), kw),
            x.to(compute_dtype))


def _labeled_loss(out, y, w, class_weights, key_i, mc_t,
                  lwf: Optional[LwF], lwf_old, cw_on_aleatoric: bool = True):
    """The labeled terms of a step's loss from the student's forward
    ``out``: the CE (the aleatoric CE on a sigma head, its normals keyed
    ``fold_key(key_i, 1)``) times the class weight (None: unweighted; the
    classification step leaves the aleatoric CE unweighted), as a
    ``w``-weighted mean, plus LwF against ``lwf_old``."""
    if out.log_sigma is not None:
        per = aleatoric_ce_per_sample(
            out.logits, out.log_sigma.float(), y,
            core_rng.key_generator(key_i, ALEATORIC_FOLD, y.device), mc_t)
        weighted = cw_on_aleatoric
    else:
        per = -(y * torch.log_softmax(out.logits, dim=-1)).sum(-1)
        weighted = True
    if weighted and class_weights is not None:
        per = per * (y * class_weights).sum(-1)
    loss = weighted_mean(per, w)
    if lwf is not None:
        loss = loss + lwf.lam * lwf_distillation(out.logits, lwf_old, w,
                                                 lwf.T)
    return loss


def _step_loss(model, x, y, w, class_weights, key, i, dropout,
               compute_dtype, mc_t, lwf: Optional[LwF], lwf_old, teacher,
               mt: Optional[MeanTeacher], xu):
    """Step ``i``'s loss (``train.py:251-282``); ``lwf_old`` are the old
    logits of the step's rows, ``xu`` its unlabeled rows."""
    dev = x.device
    key_i = core_rng.fold_key(key, i)

    def gen(parent, tag):
        return core_rng.key_generator(parent, tag, dev) if dropout else None

    fwd, xc = cast_for_forward(compute_dtype, model, x)
    out = fwd(xc, train=True, generator=gen(key, i))
    loss = _labeled_loss(out, y, w, class_weights, key_i, mc_t, lwf,
                         lwf_old)
    if mt is not None:
        s_out = fwd(xu if compute_dtype is None else xu.to(compute_dtype),
                    train=True, generator=gen(key_i, STUDENT_UNLAB_FOLD))
        with torch.no_grad():
            t_fwd, xut = cast_for_forward(compute_dtype, teacher, xu)
            t_logits = t_fwd(xut).logits
        loss = loss + mt_coefficient(mt, i) * consistency_loss(
            s_out.logits, t_logits, mt.measure)
    return loss


def _opt_step(state: TrainState, loss: torch.Tensor, grad_mask,
              mt: Optional[MeanTeacher]) -> None:
    """Backward, the ``train_layers`` mask, the optimizer step and, under
    the mean teacher, the EMA update after it."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    apply_grad_mask(state.model, grad_mask)
    state.optimizer.step()
    if mt is not None:
        ema_update(state.teacher, state.model, mt.ema_decay)


def _run_steps(state: TrainState, steps, step_loss, grad_mask,
               mt: Optional[MeanTeacher]) -> List[float]:
    """One :func:`_opt_step` per entry of ``steps`` with ``step_loss(i)``.
    Host floats of the losses are pulled at the end, so the loop never
    waits on the card."""
    losses = []
    for i in steps:
        loss = step_loss(int(i))
        _opt_step(state, loss, grad_mask, mt)
        losses.append(loss.detach())
    return [float(v) for v in torch.stack(losses).cpu()] if losses else []


def finetune_steps(state: TrainState, x_all: torch.Tensor,
                   y_all: torch.Tensor, idx_mat: np.ndarray,
                   w_mat: np.ndarray, class_weights: torch.Tensor,
                   key=None, compute_dtype=None, *, mc_t: int = 10,
                   grad_mask: Optional[Dict[str, float]] = None,
                   lwf: Optional[LwF] = None,
                   mt: Optional[MeanTeacher] = None) -> List[float]:
    """Run the index matrix's steps on ``state`` in place.  ``x_all``
    (N, d1, d2, C) and ``y_all`` (N, nclass) one-hots live on the model's
    device.  ``key`` (an integer) keys the draws (module docstring);
    ``None`` turns dropout off, and the aleatoric normals then use key 0.
    ``grad_mask`` is :func:`models.optim.layer_train_mask`'s.  ``mt``
    needs ``state.teacher``.  Returns the per-step losses of the steps that
    ran."""
    dev = x_all.device
    if mt is not None and state.teacher is None:
        raise ValueError("the mean teacher's term needs state.teacher")
    idx_t = torch.as_tensor(idx_mat, dtype=torch.int64).to(dev)
    w_t = torch.as_tensor(w_mat, dtype=torch.float32).to(dev)
    u_idx_t = (None if mt is None else
               torch.as_tensor(mt.u_idx, dtype=torch.int64).to(dev))

    def step_loss(i):
        idx = idx_t[i]
        return _step_loss(
            state.model, x_all[idx], y_all[idx], w_t[i], class_weights,
            0 if key is None else key, i, key is not None,
            compute_dtype, mc_t, lwf,
            None if lwf is None else lwf.old_logits[idx], state.teacher,
            mt, None if mt is None else mt.xu_all[u_idx_t[i]])

    losses = _run_steps(state, np.flatnonzero(w_mat.sum(axis=1) > 0),
                        step_loss, grad_mask, mt)
    state.step += int(idx_mat.shape[0])
    return losses


def make_train_step(*, mc_t: int = 10, lwf_lambda: float = 0.0,
                    lwf_T: float = 2.0, compute_dtype=None,
                    grad_mask: Optional[Dict[str, float]] = None,
                    consistency_coeff=None,
                    consistency_measure: str = "CE", fcn: bool = False,
                    focal_gamma: Optional[float] = None,
                    weight_decay: float = 0.0):
    """The classification engine's train step (``make_train_step``,
    ``train.py:65-147``; module docstring): returns ``step_fn(state, x,
    y, key, w=None, old_logits=None, cw=None, cc_scale=1.0)``, which
    takes one optimizer step of ``state`` on the batch ``x`` (channels
    last) with one-hots ``y``, row weights ``w`` (zero on padding rows),
    the runtime class-weight vector ``cw`` and, with ``lwf_lambda > 0``,
    the previous model's logits ``old_logits`` of ``x``; ``key`` is the
    step's dropout key.  ``consistency_coeff(step)`` (host float32, the
    engine's ramp) times ``cc_scale`` weighs the mean teacher's term when
    ``state.teacher`` is set.  ``fcn`` (a dense spec, ``y`` per-pixel
    one-hots with NaN on unlabeled pixels) takes the dense CE over the
    labeled pixels, class-weighted by ``cw`` and in the focal form under
    ``focal_gamma`` (``train.py:102-104``; ``w`` does not enter it);
    ``weight_decay > 0`` adds :func:`models.losses.weight_decay_penalty`
    after the LwF term (``train.py:120-121``).  Returns the loss (a device
    scalar); the caller advances ``state.step`` and updates the
    teacher."""
    if fcn and lwf_lambda > 0.0:
        # JAX's step weighs the per-pixel LwF term by the per-row w, which
        # does not broadcast
        raise ValueError("make_train_step: LwF needs per-row logits; it "
                         "does not combine with fcn")

    def step_fn(state: TrainState, x, y, key, w=None, old_logits=None,
                cw=None, cc_scale: float = 1.0) -> torch.Tensor:
        model = state.model
        if w is None:
            w = x.new_ones(x.shape[0])
        fwd, xc = cast_for_forward(compute_dtype, model, x)
        out = fwd(xc, train=True,
                  generator=core_rng.key_stream(key, x.device))
        lwf = (LwF(old_logits, lwf_lambda, lwf_T)
               if lwf_lambda > 0.0 and old_logits is not None else None)
        if fcn and out.log_sigma is None:
            loss = fcn_cross_entropy(out.logits, y, cw, focal_gamma)
        else:
            loss = _labeled_loss(out, y, w, cw, key, mc_t, lwf, old_logits,
                                 cw_on_aleatoric=False)
        if weight_decay > 0:
            loss = loss + weight_decay_penalty(model, weight_decay,
                                               compute_dtype)
        if consistency_coeff is not None and state.teacher is not None:
            with torch.no_grad():
                t_fwd, _ = cast_for_forward(compute_dtype, state.teacher, x)
                t_logits = t_fwd(xc).logits
            # ``consistency_coeff(step) * cc_scale``, float32 as traced
            coeff = float(np.float32(consistency_coeff(state.step))
                          * np.float32(cc_scale))
            loss = loss + coeff * consistency_loss(out.logits, t_logits,
                                                   consistency_measure)
        _opt_step(state, loss, grad_mask, None)
        return loss.detach()

    return step_fn


def _dense_step_loss(model, x, y, wpix, key, i, compute_dtype, teacher,
                     mt: Optional[MeanTeacher], xu):
    """Step ``i``'s dense loss (``train.py:401-424``)."""
    dev = x.device
    key_i = core_rng.fold_key(key, i)
    fwd, xc = cast_for_forward(compute_dtype, model, x)
    out = fwd(xc, train=True, generator=core_rng.key_generator(key, i, dev))
    per = -(y * torch.log_softmax(out.logits, dim=-1)).sum(-1)
    loss = weighted_mean(per, wpix)
    if mt is not None:
        s_out = fwd(xu if compute_dtype is None else xu.to(compute_dtype),
                    train=True, generator=core_rng.key_generator(
                        key_i, STUDENT_UNLAB_FOLD, dev))
        with torch.no_grad():
            t_fwd, xut = cast_for_forward(compute_dtype, teacher, xu)
            t_logits = t_fwd(xut).logits
        c = s_out.logits.shape[-1]
        loss = loss + mt_coefficient(mt, i) * consistency_loss(
            s_out.logits.reshape(-1, c), t_logits.reshape(-1, c),
            mt.measure)
    return loss


def finetune_fcn_steps(state: TrainState, x_all: torch.Tensor,
                       y_all: torch.Tensor, wpix_all: np.ndarray,
                       idx_mat: np.ndarray, w_mat: np.ndarray, key,
                       compute_dtype=None, *,
                       grad_mask: Optional[Dict[str, float]] = None,
                       mt: Optional[MeanTeacher] = None) -> List[float]:
    """The dense finetune (module docstring) on ``state`` in place:
    ``x_all`` (S, H, W, C) slices and ``y_all`` (S, H, W, nclass) one-hots
    on the model's device, ``wpix_all`` (S, H, W) host pixel weights,
    ``idx_mat`` / ``w_mat`` the slice batches.  ``key`` (an integer) keys
    the dropout.  Returns the per-step losses of the steps that ran."""
    dev = x_all.device
    if mt is not None and state.teacher is None:
        raise ValueError("the mean teacher's term needs state.teacher")
    wpix_np = np.asarray(wpix_all, np.float32)
    # the scan's ``do = sum(wpix) > 0``, from the host weights
    do = (wpix_np.sum(axis=(1, 2))[idx_mat] * w_mat).sum(axis=1) > 0
    wpix_t = torch.as_tensor(wpix_np).to(dev)
    idx_t = torch.as_tensor(idx_mat, dtype=torch.int64).to(dev)
    w_t = torch.as_tensor(w_mat, dtype=torch.float32).to(dev)
    u_idx_t = (None if mt is None else
               torch.as_tensor(mt.u_idx, dtype=torch.int64).to(dev))

    def step_loss(i):
        idx = idx_t[i]
        return _dense_step_loss(
            state.model, x_all[idx], y_all[idx],
            wpix_t[idx] * w_t[i][:, None, None], key, i, compute_dtype,
            state.teacher, mt, None if mt is None else mt.xu_all[u_idx_t[i]])

    losses = _run_steps(state, np.flatnonzero(do), step_loss, grad_mask, mt)
    state.step += int(idx_mat.shape[0])
    return losses


@torch.no_grad()
def bn_refresh(model: torch.nn.Module, bn_state: Dict, x: torch.Tensor,
               bn_decay: float) -> Dict:
    """One BN-statistics refresh pass (``_bn_refresh_fwd``,
    ``train.py:526-531``): a train-mode forward without dropout at f32
    whose only product is the running state moved at ``bn_decay``."""
    return model(x, train=True, state=bn_state, bn_decay=bn_decay).state


def update_bn_stats(model: torch.nn.Module, bn_state: Dict, sample_gen,
                    iters: int = 200, bn_decay: float = 0.999) -> Dict:
    """Recompute the BN running statistics over ``sample_gen()`` batches
    (``x`` or ``(x, y)``, channels-last, on the model's device or the
    host) without touching the weights (reference ``update_BN_stats``,
    ``train.py:534-553``).  Returns the refreshed state."""
    dev = next(model.parameters()).device
    state = bn_state
    for _ in range(iters):
        batch = sample_gen()
        x = batch[0] if isinstance(batch, (tuple, list)) else batch
        state = bn_refresh(model, state, torch.as_tensor(x).to(dev),
                           bn_decay)
    return state
