"""Fused pool scoring: posterior + uncertainty + diag-FIM ingredients in
one pass (counterpart of ``nnal_tpu/ops/scoring_fused.py:31-57``).

Per patch: the binary posterior p1, the uncertainty ``|p1 - 0.5|`` and,
with FIM, the (c, L) 'sum'-shrunk class gradients from the epsilon trick
(``scoring/gradients.py``).  With FIM the gradient pass's own forward
supplies the logits, so the posterior costs no extra forward.  This module
holds no kernel: the work is cuDNN convolutions and cuBLAS GEMMs.
``make_pool_scorer`` (``scoring_fused.py:60-71``) defaults to bf16.
"""

from __future__ import annotations

import torch

from nnal_tpu_torch.scoring.gradients import shrunk_class_grads_with_logits
from nnal_tpu_torch.scoring.pool_eval import cast_input


def pool_score_fused(model, patches: torch.Tensor, with_fim: bool = True,
                     compute_dtype=None, remat: bool = False,
                     nchw: bool = False) -> dict:
    """``{"p1", "uncertainty"}`` and, with ``with_fim``, ``"shrunk"`` —
    the (b, c, L) shrunk class gradients feeding diag-FIM/A-matrices.
    ``patches`` are channels-last ``(b, d1, d2, C)`` unless ``nchw``;
    ``remat=True`` checkpoints the gradient pass's conv segments.  With
    ``compute_dtype`` the patches are cast; the FIM pass keeps f32 biases,
    the plain forward casts every parameter (``:51-54``)."""
    if with_fim:
        shrunk, logits = shrunk_class_grads_with_logits(
            model, patches, compute_dtype, remat=remat, nchw=nchw)
        p1 = torch.softmax(logits, dim=-1)[:, 1]
        return {"p1": p1, "uncertainty": (p1 - 0.5).abs(), "shrunk": shrunk}
    with torch.no_grad():
        p1 = model(cast_input(patches, compute_dtype),
                   nchw=nchw).posteriors[:, 1]
    return {"p1": p1, "uncertainty": (p1 - 0.5).abs()}


def make_pool_scorer(compute_dtype=None, with_fim: bool = True):
    """``scorer(model, patches, nchw=False)`` with the compute-dtype cast
    fused in; bf16 by default on both paths.  The JAX version takes the
    spec too; here the model carries it.  ``scorer.compute_dtype`` names
    the dtype (``GridPoolEvaluator.fim_sweep`` takes it)."""
    cd = torch.bfloat16 if compute_dtype is None else compute_dtype

    def scorer(model, patches, nchw: bool = False):
        return pool_score_fused(model, patches, with_fim, cd, nchw=nchw)

    scorer.compute_dtype = cd
    return scorer
