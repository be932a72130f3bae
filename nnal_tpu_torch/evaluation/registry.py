"""Multi-metric validation registries (counterpart of
``nnal_tpu/evaluation/registry.py``).

Rebuild of the v2 step-based eval harness (reference ``eval_metrics``,
eval_utils.py:16-102, and the per-generator metric streams of
``NN_extended.train``, NN_extended.py:940-990): each validation
*registry* owns a data generator and a set of metric names ('av_acc',
'F1', 'av_loss'); during training every registry is evaluated
periodically, its histories are appended and mirrored to
``<metric>_<i>.txt`` files, and an optional tracked metric drives
best-model checkpointing (``max_model_pars.npz`` + ``max_valid_iter.txt``).
Models run in eval mode without a BN state (batch statistics), as JAX's
``apply_cnn(spec, params, x)`` does.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from nnal_tpu_torch.core import rng as core_rng
from nnal_tpu_torch.evaluation.metrics import binary_f1, multi_f1
from nnal_tpu_torch.models.train import batch_tensor


@torch.no_grad()
def eval_metrics(model, dat_gen: Callable, iters: int = 50,
                 metrics: Sequence[str] = ("av_acc",)) -> Dict[str, float]:
    """One evaluation sweep: ``iters`` generator batches (channels last)
    through ``model``, returning the requested metrics: accuracy / F1 over
    the concatenated predictions, the loss as a size-weighted running
    average."""
    dev = next(model.parameters()).device
    nclass = model.spec.nclass
    all_preds, all_masks = [], []
    av_loss, vol = 0.0, 0
    for _ in range(iters):
        batch_x, batch_y = dat_gen()
        b = batch_x.shape[0]
        out = model(batch_tensor(batch_x, dev))
        y = torch.as_tensor(batch_y).cpu().numpy()
        y_lab = y.argmax(-1) if y.ndim == out.posteriors.dim() else y
        all_preds.append(out.prediction.cpu().numpy())
        all_masks.append(y_lab)
        if "av_loss" in metrics:
            logp = torch.log_softmax(out.logits, dim=-1).cpu().numpy()
            onehot = y if y.ndim == logp.ndim else np.eye(
                logp.shape[-1])[y_lab]
            loss = float(-np.mean(np.sum(onehot * logp, axis=-1)))
            av_loss = (vol * av_loss + loss * b) / (vol + b)
        vol += b
    preds = np.concatenate(all_preds).ravel()
    masks = np.concatenate(all_masks).ravel()
    res: Dict[str, float] = {}
    for m in metrics:
        if m == "av_acc":
            res[m] = float(np.mean(preds == masks))
        elif m == "F1":
            res[m] = (binary_f1(preds, masks) if nclass == 2
                      else multi_f1(preds, masks, nclass)[1])
        elif m == "av_loss":
            res[m] = av_loss
        else:
            raise ValueError(f"unknown metric {m!r}")
    return res


@dataclass
class MetricRegistry:
    """One validation generator + its metric set (the reference's
    ``valid_metrics_<i>`` dict + ``<metric>_<i>.txt`` persistence)."""

    metrics: Sequence[str]
    gen: Callable
    iters: int = 10
    history: Dict[str, List[float]] = field(default_factory=dict)

    def evaluate(self, model) -> Dict[str, float]:
        vals = eval_metrics(model, self.gen, self.iters, tuple(self.metrics))
        for m, v in vals.items():
            self.history.setdefault(m, []).append(v)
        return vals

    def persist(self, save_path: str, idx: int) -> None:
        for m, hist in self.history.items():
            np.savetxt(os.path.join(save_path, f"{m}_{idx}.txt"), hist)

    def load(self, save_path: str, idx: int) -> None:
        for m in self.metrics:
            p = os.path.join(save_path, f"{m}_{idx}.txt")
            if os.path.exists(p):
                self.history[m] = list(np.atleast_1d(np.loadtxt(p)))


def train_with_registries(state, step_fn, train_gen, *, step_limit: int,
                          rng, registries: Sequence[MetricRegistry],
                          eval_every: int = 50,
                          save_path: Optional[str] = None,
                          track: Optional[str] = None,
                          ema_decay: float = 0.999):
    """Step-bounded training with per-registry metric streams (reference
    ``NN_extended.train``, NN_extended.py:928-1008).  ``step_fn(state, x,
    y, key)`` is ``models/train.make_train_step``'s, keyed
    ``fold_key(rng, state.step)``.  When ``track`` names a metric of
    registry 0, the best-so-far weights are checkpointed to
    ``max_model_pars.npz`` + ``max_valid_iter.txt``.  Resumes metric
    histories from ``save_path`` when the txt streams exist; with a BN
    state the running statistics are refreshed over the training stream
    before the last evaluation."""
    from nnal_tpu_torch.models.bridge import bn_state_to_jax, to_jax_tensors
    from nnal_tpu_torch.models.checkpoint import save_checkpoint
    from nnal_tpu_torch.models.optim import ema_update
    from nnal_tpu_torch.models.train import update_bn_stats

    if save_path:
        os.makedirs(save_path, exist_ok=True)
        for i, reg in enumerate(registries):
            reg.load(save_path, i)
    dev = next(state.model.parameters()).device

    def run_evals():
        for i, reg in enumerate(registries):
            reg.evaluate(state.model)
            if save_path:
                reg.persist(save_path, i)
        if track and registries:
            V = registries[0].history.get(track, [])
            if V and (len(V) == 1 or V[-1] > max(V[:-1])):
                if save_path:
                    np.savetxt(os.path.join(save_path,
                                            "max_valid_iter.txt"),
                               [state.step])
                    save_checkpoint(
                        os.path.join(save_path, "max_model_pars.npz"),
                        to_jax_tensors(state.model.state_dict()),
                        bn_state=(bn_state_to_jax(state.bn_state)
                                  if state.bn_state else None),
                        teacher_params=(
                            None if state.teacher is None else
                            to_jax_tensors(state.teacher.state_dict())))
                return True
        return False

    while state.step < step_limit:
        if state.step % eval_every == 0:
            run_evals()
        x, y = next(train_gen)
        loss = step_fn(state, batch_tensor(x, dev), batch_tensor(y, dev),
                       core_rng.fold_key(rng, state.step))
        state.metrics.setdefault("train_loss", []).append(float(loss))
        if state.teacher is not None:
            ema_update(state.teacher, state.model, ema_decay)
        state.step += 1

    if state.bn_state:
        # the reference's update_BN_stats pass (NN_extended.py:1059-1084):
        # eval-mode inference on current moving averages
        state.bn_state = update_bn_stats(state.model, state.bn_state,
                                         lambda: next(train_gen), iters=20)
    run_evals()
    return state
