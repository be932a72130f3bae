"""Uncertainty selection (counterpart of the binary filter of
``nnal_tpu/scoring/uncertainty.py``)."""

from __future__ import annotations

import numpy as np
import torch


def binary_uncertainty_scores(p1: torch.Tensor) -> torch.Tensor:
    """``|p - 0.5|`` — ascending order is most-uncertain-first."""
    return (p1 - 0.5).abs()


def binary_uncertainty_filter(p1, B: int) -> np.ndarray:
    """Indices of the ``B`` smallest ``|p1 - 0.5|``, ties broken by index
    order as the JAX package's ``top_k(-score)`` does.  A stable sort gives
    that order on every device (``torch.topk`` is not stable on CUDA)."""
    p1 = torch.as_tensor(p1, dtype=torch.float32)
    B = min(int(B), p1.shape[0])
    order = torch.sort(binary_uncertainty_scores(p1), stable=True).indices
    return order[:B].cpu().numpy()
