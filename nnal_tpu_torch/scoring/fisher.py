"""Conditional Fisher-information A-matrices and the FI query pipeline
(counterpart of ``nnal_tpu/scoring/fisher.py``).

Reference flow (PW_NNAL.py:89-163): uncertainty-filter the pool to B ->
per-sample per-class 'sum'-shrunk gradients -> ``A_i = (1-p) g0 g0^T + p
g1 g1^T + load*I`` -> the A-optimal SDP -> sample queries from the optimal
PMF.  The A-matrices and the SDP stay on the device; only the PMF reaches
the host.  Dense (fcn) specs have no per-patch full-network gradient;
their fi takes the A-matrices of :func:`hallucinated_class_grads`, the
last-layer Fisher over the per-pixel probe features.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nnal_tpu_torch.scoring.pmf import sample_query_pmf
from nnal_tpu_torch.scoring.sdp import fi_query_distribution


def a_matrices(shrunk: torch.Tensor, posts_p1: torch.Tensor,
               diag_load: float = 1e-5) -> torch.Tensor:
    """Batched binary conditional-FI matrices (reference
    ``gen_A_matrices``, PW_NNAL.py:736-816).  ``shrunk``: (b, 2, L)
    'sum'-shrunk class gradients; ``posts_p1``: (b,) P(y=1|x).  Posteriors
    are snapped to exactly 0/1 beyond 1e-6, and the opposite class
    gradient dropped, as in the reference's branches."""
    p = posts_p1
    p = torch.where(p < 1e-6, 0.0, p)
    p = torch.where(p > 1 - 1e-6, 1.0, p)
    g0 = torch.where((p == 1.0)[:, None], 0.0, shrunk[:, 0, :])
    g1 = torch.where((p == 0.0)[:, None], 0.0, shrunk[:, 1, :])
    A = ((1.0 - p)[:, None, None] * g0[:, :, None] * g0[:, None, :]
         + p[:, None, None] * g1[:, :, None] * g1[:, None, :])
    L = shrunk.shape[-1]
    return A + diag_load * torch.eye(L, dtype=A.dtype, device=A.device)


def a_matrices_multiclass(shrunk: torch.Tensor, posts: torch.Tensor,
                          diag_load: float = 1e-5) -> torch.Tensor:
    """Multi-class conditional FI (reference NNAL.py:334-414):
    ``A_i = sum_c p_c g_c g_c^T`` on shrunk gradients."""
    A = torch.einsum("bc,bcl,bcm->blm", posts, shrunk, shrunk)
    L = shrunk.shape[-1]
    return A + diag_load * torch.eye(L, dtype=A.dtype, device=A.device)


def hallucinated_class_grads(F: torch.Tensor, posts: torch.Tensor
                             ) -> torch.Tensor:
    """Hallucinated last-layer class gradients over probe features
    (``fisher.py:59-80``; the BADGE construction): the CE gradient of a
    surrogate softmax layer ``z = W^T [f; 1]`` at ASSUMED label ``c`` is
    ``(p_j - delta_jc) [f; 1]`` over the output classes ``j``.  ``F`` (b,
    d) features, ``posts`` (b,) P(y=1) or (b, c).  Returns (b, c, c(d+1)),
    the input of :func:`a_matrices` / :func:`a_matrices_multiclass`."""
    if posts.dim() == 1:
        posts = torch.stack([1.0 - posts, posts], dim=1)
    b, d = F.shape
    c = posts.shape[1]
    f1 = torch.cat([F, F.new_ones((b, 1))], dim=1)
    delta = torch.eye(c, dtype=F.dtype, device=F.device)
    coeff = posts[:, None, :] - delta[None, :, :]      # (b, assumed, j)
    g = coeff[..., None] * f1[:, None, None, :]        # (b, assumed, j, d+1)
    return g.reshape(b, c, c * (d + 1))


def refine_feature_matrix(F: np.ndarray, B: int,
                          cond_limit: float = 1e6) -> np.ndarray:
    """Select a well-conditioned full-row-rank feature submatrix (reference
    ``refine_feature_matrix``, PW_NNAL.py:819-849): keep the B/2 features
    with the most nonzeros, then drop rows until full rank and cond <
    1e6."""
    F = np.asarray(F)
    nnz = np.sum(F > 0, axis=1)
    feat_inds = np.argsort(-nnz)[:max(1, int(B / 2))]
    ref = F[feat_inds, :]
    while len(feat_inds) > 1 and np.linalg.matrix_rank(ref) < len(feat_inds):
        feat_inds = feat_inds[:-1]
        ref = F[feat_inds, :]
    while len(feat_inds) > 1 and np.linalg.cond(ref) > cond_limit:
        feat_inds = feat_inds[:-1]
        ref = F[feat_inds, :]
    return ref


def fi_select(model, patches: torch.Tensor, posts_p1, k: int, rng, *,
              lambda_: float = 0.0, features: Optional[np.ndarray] = None,
              diag_load: float = 1e-5, cap_peak: bool = False,
              sdp_steps: int = 2000) -> np.ndarray:
    """End-to-end FI querying over a filtered candidate set: ``patches``
    (B, d1, d2, C) normalized candidates on the device, ``posts_p1`` their
    binary posteriors.  Returns positions (into the candidate set) of the
    sampled queries."""
    from nnal_tpu_torch.core.profiling import subphase
    from nnal_tpu_torch.scoring.gradients import shrunk_class_grads

    with subphase("fi/grads_A"):
        shrunk = shrunk_class_grads(model, patches)
        A = a_matrices(shrunk, torch.as_tensor(
            np.asarray(posts_p1, np.float32)).to(patches.device), diag_load)
    X_pool = None
    if lambda_ > 0 and features is not None:
        ref_F = refine_feature_matrix(np.asarray(features).T,
                                      patches.shape[0])
        X_pool = ref_F - ref_F.mean(axis=1, keepdims=True)
    with subphase("fi/sdp"):
        q = fi_query_distribution(A, lambda_, X_pool, k, cap_peak=cap_peak,
                                  steps=sdp_steps)
    with subphase("fi/pmf"):
        return sample_query_pmf(q, k, rng, replacement=True)
