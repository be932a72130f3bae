"""Fused pool scoring: posterior + uncertainty + diag-FIM ingredients in
one pass (counterpart of ``nnal_tpu/ops/scoring_fused.py:31-57``).

Per patch: the binary posterior p1, the uncertainty ``|p1 - 0.5|`` and,
with FIM, the (c, L) 'sum'-shrunk class gradients from the epsilon trick
(``scoring/gradients.py``).  With FIM the gradient pass's own forward
supplies the logits, so the posterior costs no extra forward.  This module
holds no kernel: the work is cuDNN convolutions and cuBLAS GEMMs.
``make_pool_scorer`` defaults to bf16 in the JAX package and waits for
ROADMAP Queue 1 item 2.
"""

from __future__ import annotations

import torch

from nnal_tpu_torch.scoring.gradients import (
    _BF16_TODO,
    shrunk_class_grads_with_logits,
)


def pool_score_fused(model, patches: torch.Tensor, with_fim: bool = True,
                     compute_dtype=None, remat: bool = False,
                     nchw: bool = False) -> dict:
    """``{"p1", "uncertainty"}`` and, with ``with_fim``, ``"shrunk"`` —
    the (b, c, L) shrunk class gradients feeding diag-FIM/A-matrices.
    ``patches`` are channels-last ``(b, d1, d2, C)`` unless ``nchw``;
    ``remat=True`` checkpoints the gradient pass's conv segments."""
    if compute_dtype is not None:
        raise NotImplementedError(_BF16_TODO)
    if with_fim:
        shrunk, logits = shrunk_class_grads_with_logits(
            model, patches, remat=remat, nchw=nchw)
        p1 = torch.softmax(logits, dim=-1)[:, 1]
        return {"p1": p1, "uncertainty": (p1 - 0.5).abs(), "shrunk": shrunk}
    with torch.no_grad():
        p1 = model(patches, nchw=nchw).posteriors[:, 1]
    return {"p1": p1, "uncertainty": (p1 - 0.5).abs()}
