"""Finetuning (counterpart of the patch-wise, non-MT branch of
``nnal_tpu/models/train.py``).

The JAX package runs a round's finetune as one jitted ``lax.scan`` over a
precomputed ``(steps, b)`` index matrix; here it is a Python loop over the
same matrix (PyTorch runs eagerly, so the loop is the natural form).  Each
step is class-weighted CE, weighted-mean over the batch rows
(``train.py:259-264``).  Steps whose weights sum to 0 (the bucket padding
steps) are skipped outright — the scan computes them and then discards the
update, so in both the parameters, Adam's step count and its moments do
not move.

``compute_dtype=torch.bfloat16`` (``model.train_dtype``) trains mixed
precision (``train.py:51-62``): f32 master weights and f32 Adam state; each
step's bf16 copies are made inside the differentiated function
(``torch.func.functional_call`` over ``p.to(bf16)``), so the gradients
reach the f32 parameters as f32.  ``torch.autocast`` is not used: it picks
its own cast points, which would not mirror the JAX casts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
from torch.func import functional_call

from nnal_tpu_torch.data.batching import gen_batch_inds
from nnal_tpu_torch.models.losses import masked_cross_entropy
from nnal_tpu_torch.models.optim import make_optimizer


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def init_train_state(model, optimizer_name="SGD", learning_rate=1e-3
                     ) -> TrainState:
    return TrainState(model=model, optimizer=make_optimizer(
        optimizer_name, learning_rate, model.parameters()))


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


def cast_for_forward(compute_dtype, model, x):
    """The forward at ``compute_dtype`` (``_cast_for_forward``): a callable
    that runs ``model`` on bf16 copies of its parameters and of ``x``, or
    the model itself at f32."""
    if compute_dtype is None:
        return model, x
    params = {k: p.to(compute_dtype) for k, p in model.named_parameters()}
    return (lambda xx, **kw: functional_call(model, params, (xx,), kw),
            x.to(compute_dtype))


def finetune_steps(state: TrainState, x_all: torch.Tensor,
                   y_all: torch.Tensor, idx_mat: np.ndarray,
                   w_mat: np.ndarray, class_weights: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   compute_dtype=None) -> List[float]:
    """Run the index matrix's steps on ``state`` in place.  ``x_all``
    (N, d1, d2, C) and ``y_all`` (N, nclass) one-hots live on the model's
    device; ``generator`` (on that device) drives dropout.  Returns the
    per-step losses of the steps that ran (host floats are pulled at the
    end, so the loop never waits on the card)."""
    model, opt = state.model, state.optimizer
    dev = x_all.device
    idx_t = torch.as_tensor(idx_mat, dtype=torch.int64).to(dev)
    w_t = torch.as_tensor(w_mat, dtype=torch.float32).to(dev)
    losses = []
    for i in np.flatnonzero(w_mat.sum(axis=1) > 0):
        idx = idx_t[i]
        fwd, x = cast_for_forward(compute_dtype, model, x_all[idx])
        out = fwd(x, train=True, generator=generator)
        loss = masked_cross_entropy(out.logits, y_all[idx], class_weights,
                                    w_t[i])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    state.step += int(idx_mat.shape[0])
    return [float(v) for v in torch.stack(losses).cpu()] if losses else []
