"""The finetune loss (counterpart of the CE of ``nnal_tpu/models/train.py``
and ``nnal_tpu/models/losses.py``)."""

from __future__ import annotations

import torch


def masked_cross_entropy(logits, y_onehot, class_weights, w):
    """The finetune loss (``train.py:259-264``): class-weighted CE, then the
    mean over rows weighted by ``w`` — zero-weight (padding) rows add
    nothing, and an all-zero ``w`` gives 0."""
    per = -(y_onehot * torch.log_softmax(logits, dim=-1)).sum(-1)
    per = per * (y_onehot * class_weights).sum(-1)
    return (per * w).sum() / torch.clamp(w.sum(), min=1.0)
