"""Shared engine helpers (counterpart of ``nnal_tpu/engine/common.py``).

The resume arithmetic (``replay_prefix_lens``, ``reconcile_membership``)
is copied as is, so a crash-resumed port campaign replays exactly like a
JAX one.  ``check_slice_config`` rejects the configuration keys whose
code paths this slice of the port does not carry, naming the key, rather
than ignoring them.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from nnal_tpu_torch.core.journal import load_inds


def check_slice_config(cfg) -> None:
    """Raise ``NotImplementedError`` naming the first config key that
    selects a path the port does not have yet."""
    m, q = cfg.model, cfg.query
    unsupported = [
        ("data_parallel", int(getattr(q, "data_parallel", 1)) > 1),
        ("consistency_coeff (MT-SSL)",
         float(getattr(m, "consistency_coeff", 0.0)) > 0.0),
        ("lwf_lambda (LwF)", float(getattr(m, "lwf_lambda", 0.0)) > 0.0),
        ("aleatoric", bool(getattr(m, "aleatoric", False))),
        ("train_layers", bool(getattr(m, "train_layers", None))),
        ("ckpt_dtype", str(getattr(m, "ckpt_dtype", "float32"))
         != "float32"),
        ("ckpt_full_every", int(getattr(m, "ckpt_full_every", 1)) > 1),
        ("model_name (dense fcn specs)",
         m.model_name in ("Tiramisu", "FCDenseNet103")),
        ("dtype", str(getattr(m, "dtype", "float32")) != "float32"),
        ("train_dtype", str(getattr(m, "train_dtype", "float32"))
         != "float32"),
        ("tb_logdir", bool(getattr(cfg, "tb_logdir", None))),
    ]
    for key, bad in unsupported:
        if bad:
            raise NotImplementedError(
                f"config key {key} is not supported by the PyTorch port yet")


def replay_prefix_lens(j, al_state, round_id: int, n_train: int) -> List[int]:
    """Labeled-set prefix lengths for the rounds a resume must replay: one
    per round in ``[anchor, round_id)``, empty when the checkpoint already
    is the current round's state (a crash between the query journal and
    the checkpoint leaves the anchor one round behind).  Replay is exact
    because queries are journaled, each round's labeled set is a prefix of
    the next, and the finetune RNG is keyed on the optimizer step."""
    anchor = (0 if al_state is None
              else int(al_state.get("round", round_id)))
    if anchor >= round_id:
        return []
    counts = [len(load_inds(os.path.join(j.queries_dir, f"{it}.txt")))
              for it in j.query_iters()]
    lens, n = [], n_train - sum(counts)
    for c in counts:
        n += c
        lens.append(n)
    return lens[anchor:round_id]


def reconcile_membership(j, train_inds, pool_inds):
    """Repair the crash window between ``record_queries`` and
    ``init_membership``: queries journaled for the last round but missing
    from the membership files are appended in file order (keeping the
    prefix property replay depends on).  Returns ``(train_inds,
    pool_inds, repaired)``."""
    iters = j.query_iters()
    if not iters:
        return train_inds, pool_inds, False
    last = load_inds(os.path.join(j.queries_dir, f"{iters[-1]}.txt"))
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
