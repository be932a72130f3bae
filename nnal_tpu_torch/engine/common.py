"""Shared engine helpers (counterpart of ``nnal_tpu/engine/common.py``).

The resume arithmetic (``replay_prefix_lens``, ``reconcile_membership``,
both with the multi-subject engine's ``matrix`` journals) is copied as is,
so a crash-resumed port campaign replays exactly like a JAX one;
``maybe_reset_opt`` is ``opt_reset_per_round``'s warm restart,
``cached_tx`` the classification engine's optimizer reuse, and
``write_checkpoint`` runs a save now or from the writer thread.
``check_slice_config`` rejects the one configuration key whose code path
the port does not carry yet — ``data_parallel`` > 1 — naming it, rather
than ignoring it, and dtype strings the JAX package rejects.  The anchor
levers (``anchor_dtype``, ``adopt_anchor_rounding``,
``anchor_save_kwargs``) are ``engine/common.py:52-111`` on the port's
``TrainState`` (an ``nn.Module``, a ``torch.optim`` optimizer, the mean
teacher and the BN running state, updated in place).  ``mt_rampdown`` is
the mean teacher's labeled-count schedule (``:206-235``) and
``warn_fcn_unsupported_keys`` the dense finetune's warning about the keys
it ignores (``:175-203``).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from nnal_tpu_torch.core.journal import load_inds
from nnal_tpu_torch.models.bridge import to_jax_tensors
from nnal_tpu_torch.models.checkpoint import round_trip_bf16, round_trip_int8
from nnal_tpu_torch.models.optim import opt_state_tensors
from nnal_tpu_torch.scoring.pool_eval import eval_compute_dtype

ANCHOR_DTYPES = ("float32", "bfloat16", "int8")
DENSE_MODELS = ("Tiramisu", "FCDenseNet103")


def is_dense(model_cfg) -> bool:
    """Whether ``model_name`` selects the dense (fcn) model path."""
    return model_cfg.model_name in DENSE_MODELS


def dense_model_kwargs(model_cfg) -> dict:
    """The dense spec's factory knobs: ``model_kwargs`` (growth, depths,
    ...) with ``dropout_rate`` defaulting to the config's
    (``pw_experiment.py:103-117``)."""
    kw = dict(getattr(model_cfg, "model_kwargs", None) or {})
    kw.setdefault("dropout_rate", model_cfg.dropout_rate)
    if "depths" in kw:
        kw["depths"] = tuple(kw["depths"])
    return kw


def check_slice_config(cfg, classification: bool = False) -> None:
    """Raise ``NotImplementedError`` naming the first config key that
    selects a path the port does not have yet, and ``ValueError`` for a
    ``dtype`` / ``train_dtype`` / ``ckpt_dtype`` or a
    ``consistency_measure`` the JAX package rejects.  The classification
    engine warns on ``data_parallel`` > 1 instead, as the JAX package's
    does (``experiment.py:47-55``): that key shards the patch-wise
    engines' sweeps only."""
    m, q = cfg.model, cfg.query
    if int(getattr(q, "data_parallel", 1)) > 1:
        if not classification:
            raise NotImplementedError(
                "config key data_parallel is not supported by the PyTorch "
                "port yet")
        import warnings

        warnings.warn("data_parallel > 1 applies to the patch-wise "
                      "engines' grid-pool scoring; the classification "
                      "engine runs single-device", stacklevel=3)
    # the dtype strings and the consistency measure: raise where the JAX
    # package would, but up front
    if (float(getattr(m, "consistency_coeff", 0.0)) > 0.0
            and m.consistency_measure not in ("CE", "MSE")):
        raise ValueError(
            f"unsupported consistency_measure {m.consistency_measure!r}")
    eval_compute_dtype(getattr(m, "dtype", None))
    eval_compute_dtype(getattr(m, "train_dtype", None))
    anchor_dtype(m)


def replay_prefix_lens(j, al_state, round_id: int, n_train: int,
                       matrix: bool = False) -> List[int]:
    """Labeled-set prefix lengths for the rounds a resume must replay: one
    per round in ``[anchor, round_id)``, empty when the checkpoint already
    is the current round's state (a crash between the query journal and
    the checkpoint leaves the anchor one round behind).  Replay is exact
    because queries are journaled, each round's labeled set is a prefix of
    the next, and the finetune RNG is keyed on the optimizer step.
    ``matrix=True`` reads multi-subject journals, whose files are (voxel,
    subject) 2 x k matrices (a k = 1 file would read as 1-D length 2)."""
    anchor = (0 if al_state is None
              else int(al_state.get("round", round_id)))
    if anchor >= round_id:
        return []
    counts = []
    for it in j.query_iters():
        a = load_inds(os.path.join(j.queries_dir, f"{it}.txt"),
                      matrix=matrix)
        counts.append(a.shape[1] if a.ndim == 2 else len(a))
    lens, n = [], n_train - sum(counts)
    for c in counts:
        n += c
        lens.append(n)
    return lens[anchor:round_id]


def anchor_dtype(model_cfg) -> str:
    """``ckpt_dtype``: the storage dtype of the resume-point saves."""
    dt = str(getattr(model_cfg, "ckpt_dtype", "float32"))
    if dt not in ANCHOR_DTYPES:
        raise ValueError(f"unsupported ckpt_dtype {dt!r}")
    return dt


@torch.no_grad()
def adopt_anchor_rounding(state, model_cfg) -> bool:
    """Round the live parameters, the mean teacher's (when there is one),
    the BN running state and, unless ``opt_reset_per_round``, the Adam
    moments in place to what the anchor stores, right before a full save
    at ``ckpt_dtype`` bfloat16 or int8: the file then decodes to exactly
    the state the uninterrupted process trains on, so resume == continue
    bit for bit.  bfloat16 rounds every tensor; int8 quantize-dequantizes
    each weight matrix (the teacher's too; a transposed conv's is held in
    the conv layout) per output channel or feature (axis 0 here, the JAX
    layout's last axis) and rounds biases, BN parameters and state and
    moments to bf16, the save encoder's per-group rule.  Capture the save's payload first
    (:func:`anchor_save_kwargs`): int8's encode is not idempotent, so the
    save must encode the originals.  Returns True when it rounded."""
    dt = anchor_dtype(model_cfg)
    if dt == "float32":
        return False
    params = list(state.model.parameters())
    if getattr(state, "teacher", None) is not None:
        params += list(state.teacher.parameters())
    for p in params:
        if dt == "int8" and p.dim() >= 2:
            p.copy_(round_trip_int8(p, 0))
        else:
            p.copy_(round_trip_bf16(p))
    for stats in (getattr(state, "bn_state", None) or {}).values():
        for t in stats.values():
            t.copy_(round_trip_bf16(t))
    if not getattr(model_cfg, "opt_reset_per_round", False):
        for st in state.optimizer.state.values():
            for key in ("exp_avg", "exp_avg_sq"):
                if key in st:
                    st[key].copy_(round_trip_bf16(st[key]))
    return True


def anchor_save_kwargs(model_cfg, state) -> dict:
    """The resume-point save's payload under the anchor levers, captured
    now (before :func:`adopt_anchor_rounding`): JAX-layout copies of the
    parameters, of the mean teacher's (None without one: replay re-runs
    finetunes whose consistency term reads it, so it is part of the resume
    point), of the BN running state (None without batch norm) and, unless
    ``opt_reset_per_round``, the Adam state, on the model's device, plus
    the storage dtype.  The copies are a snapshot, so
    a background writer may encode and pull them while the next round
    updates the live tensors."""
    include_opt = not getattr(model_cfg, "opt_reset_per_round", False)
    teacher = getattr(state, "teacher", None)
    return {"params": to_jax_tensors(state.model.state_dict()),
            "teacher_params": (None if teacher is None else
                               to_jax_tensors(teacher.state_dict())),
            "bn_state": ({layer: {k: v.detach().clone()
                                  for k, v in d.items()}
                          for layer, d in state.bn_state.items()}
                         if getattr(state, "bn_state", None) else None),
            "opt_state": (opt_state_tensors(state.optimizer, state.model)
                          if include_opt else None),
            "dtype": anchor_dtype(model_cfg)}


def write_checkpoint(save, writer, device) -> None:
    """Run ``save`` now (``writer`` None) or from ``writer``'s thread.  On
    the card the thread pulls on a stream of its own, after an event that
    orders it behind the copies of the device snapshot ``save`` writes."""
    if writer is None:
        save()
        return
    if device.type != "cuda":
        writer.submit(save)
        return
    ready = torch.cuda.Event()
    ready.record()

    def save_on_side_stream():
        side = torch.cuda.Stream(device)
        side.wait_event(ready)
        with torch.cuda.stream(side):
            save()

    writer.submit(save_on_side_stream)


def maybe_reset_opt(state, model_cfg) -> None:
    """``opt_reset_per_round``: warm-restart the optimizer at the top of
    each finetune (its moments and step count go).  The original run and
    a crash-resume replay both pass here, so replay stays bit-identical
    without the moments in any checkpoint."""
    if getattr(model_cfg, "opt_reset_per_round", False):
        state.optimizer.state.clear()


def cached_tx(engine, model_cfg):
    """The optimizer factory of the last ``run_method`` call when the
    (optimizer, lr) config is unchanged, else None (the caller builds one
    and stores it as ``engine._tx``; JAX ``common.py:123-135``).  The
    port's "transformation" is ``tx(params) -> torch.optim.Optimizer``,
    the counterpart of optax's ``tx.init(params)``."""
    key = (model_cfg.optimizer_name, model_cfg.learning_rate)
    if getattr(engine, "_tx_key", None) == key:
        return getattr(engine, "_tx", None)
    engine._tx_key = key
    return None


def reconcile_membership(j, train_inds, pool_inds, *, matrix: bool = False,
                         to_global=None):
    """Repair the crash window between the query journal and
    ``init_membership``: queries journaled for the last round but missing
    from the membership files are appended in file order (keeping the
    prefix property replay depends on).  ``matrix`` journals ((voxel,
    subject) columns, the multi-subject engine) need ``to_global``, which
    maps the (2, k) matrix to that engine's global membership ids.
    Returns ``(train_inds, pool_inds, repaired)``."""
    iters = j.query_iters()
    if not iters:
        return train_inds, pool_inds, False
    last = load_inds(os.path.join(j.queries_dir, f"{iters[-1]}.txt"),
                     matrix=matrix)
    if matrix:
        last = to_global(last)
    present = np.isin(last, train_inds)
    if present.all():
        return train_inds, pool_inds, False
    missing = np.asarray(last)[~present]
    train_inds = np.concatenate([np.asarray(train_inds), missing])
    pool_inds = np.asarray(pool_inds)
    pool_inds = pool_inds[~np.isin(pool_inds, missing)]
    j.init_membership(train_inds, pool_inds)
    return train_inds, pool_inds, True


def inverse_frequency_weights(labels: np.ndarray, nclass: int) -> np.ndarray:
    """``class_weights: auto``: inverse class frequency over the labeled
    set, normalized to sum to ``nclass``."""
    counts = np.bincount(labels.astype(np.int64),
                         minlength=nclass).astype(np.float64)
    inv = counts.sum() / np.maximum(counts, 1.0)
    return (inv / inv.sum() * nclass).astype(np.float32)


def warn_fcn_unsupported_keys(engine, model_cfg,
                              train_layers_ok: bool = True) -> None:
    """Warn once per engine (and per set of keys) when a dense (fcn)
    finetune ignores a config key (``engine/common.py:175-203``):
    ``lwf_lambda`` always, ``train_layers`` where ``train_layers_ok`` is
    False (the multi-subject engine).  A key set mid-campaign warns the
    first time it is ignored."""
    ignored = []
    if float(getattr(model_cfg, "lwf_lambda", 0.0)) > 0.0:
        ignored.append("lwf_lambda (LwF)")
    if not train_layers_ok and getattr(model_cfg, "train_layers", None):
        ignored.append("train_layers (partial training)")
    if tuple(ignored) == getattr(engine, "_fcn_keys_warned", None):
        return
    if ignored:
        import warnings

        warnings.warn(
            "dense-model (fcn) finetune ignores config keys: "
            + ", ".join(ignored)
            + " — these are only implemented on the patch-wise path",
            stacklevel=3)
    engine._fcn_keys_warned = tuple(ignored)


def mt_rampdown(model_cfg, n_labeled: int):
    """``(effective_cc, cc_scale)`` of the mean teacher's consistency term
    for a labeled set of ``n_labeled`` (``engine/common.py:206-235``):
    off (0, 0) below ``consistency_start_labels``; with
    ``consistency_off_labels = L > 0``, full strength up to L/2, then
    ``exp(-12.5 phase^2)`` over the second half, and off from L on.  An
    effective coefficient of 0 runs the plain finetune (no teacher, no
    unlabeled work).  It depends on ``n_labeled`` alone, so replay sees the
    same values."""
    cc = float(getattr(model_cfg, "consistency_coeff", 0.0))
    if cc <= 0.0:
        return cc, 1.0
    start = int(getattr(model_cfg, "consistency_start_labels", 0))
    if start > 0 and n_labeled < start:
        return 0.0, 0.0
    off = int(getattr(model_cfg, "consistency_off_labels", 0))
    if off <= 0:
        return cc, 1.0
    if n_labeled >= off:
        return 0.0, 0.0
    half = off / 2.0
    if n_labeled <= half:
        return cc, 1.0
    phase = (n_labeled - half) / half
    return cc, float(np.exp(-12.5 * phase * phase))
