"""Closed-form last-layer gradients and Hessian, LiSSA, and the low-rank
(Lanczos / Arnoldi) inverse Hessian (counterpart of
``nnal_tpu/scoring/hessian.py``).

Last layer (reference ``LLFC_grads`` / ``LLFC_hess``, NN.py:874-1029):
for ``z = W^T a + b`` with softmax posterior ``p`` and CE at label ``y``,
``dJ/dz = p - y``, ``dJ/dW = a (p - y)^T``, and over theta = (vec(W), b)
the Hessian is ``H_z (x) [[a a^T, a], [a^T, 1]]`` with
``H_z = diag(p) - p p^T``.  The parameter order theta = [W[0, :], ...,
W[d-1, :], b] is part of the contract.

Arnoldi influence ("Scaling Up Influence Functions", Schioppa et al.,
arXiv:2112.03052): a Lanczos pass finds the top eigenpairs of the
training Hessian once (matvec: ``influence.hvp``); every
``(H + damping)^-1 v`` is then exact on that eigenspace and ``1/damping``
on its complement.  Vectors are flat in the port's parameter order
(``influence.flatten``).  Lanczos's random start is drawn by
:func:`_lanczos_start`, the one seam a test replaces to feed JAX's draw.
Memory: the basis is ``(rank + 1)`` flat f32 vectors, and forming the
Ritz vectors briefly holds about twice that (PW1 25x25x2: 144.5 MB each).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from nnal_tpu_torch.scoring import influence as infl


def llfc_grads(a: torch.Tensor, p: torch.Tensor, y_onehot: torch.Tensor):
    """Per-sample last-layer CE gradients: ``a`` (b, d) inputs, ``p``
    (b, c) posteriors; returns ``(dW, db)`` of shapes (b, d, c), (b, c)."""
    dz = p - y_onehot
    return torch.einsum("bd,bc->bdc", a, dz), dz


def llfc_hess(a: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Per-sample last-layer Hessian over theta = (vec(W), b), shape
    (b, (d+1)c, (d+1)c): index (i*c + u, j*c + v) of ``kron(aa1, H_z)``."""
    b, d = a.shape
    c = p.shape[1]
    eye = torch.eye(c, dtype=p.dtype, device=p.device)
    Hz = (torch.einsum("bc,ce->bce", p, eye)
          - torch.einsum("bc,be->bce", p, p))
    a1 = torch.cat([a, a.new_ones((b, 1))], dim=1)          # (b, d+1)
    aa1 = torch.einsum("bi,bj->bij", a1, a1)                 # (b, d+1, d+1)
    H = torch.einsum("bij,buv->biujv", aa1, Hz)
    return H.reshape(b, (d + 1) * c, (d + 1) * c)


def lissa_influence(grads_q: torch.Tensor, hess_samples: torch.Tensor,
                    max_iter: int = 100, scale: float = 50.0
                    ) -> torch.Tensor:
    """LiSSA's stochastic inverse-Hessian-vector iteration
    ``V <- g + V - H_t V / scale`` (reference ``stoch_approx_IF``,
    PW_NNAL.py:851-881) over a ``(T, D, D)`` stack of single-sample
    Hessians, cycled.  ``grads_q``: (D, m).  Returns V, which approximates
    ``scale * H^-1 g``."""
    V = grads_q
    for t in range(max_iter):
        V = grads_q + V - (hess_samples[t % hess_samples.shape[0]] @ V) \
            / scale
    return V


def _lanczos_start(params: infl.Params, key, device) -> torch.Tensor:
    """Lanczos's standard-normal start, flat in the port's parameter
    order, drawn from a generator seeded with ``key`` (JAX draws one
    ``jax.random.normal(key, ...)`` in ``ravel_pytree`` order)."""
    n = sum(t.numel() for t in params.values())
    gen = torch.Generator(device=device).manual_seed(int(key))
    return torch.randn(n, generator=gen, device=device, dtype=torch.float32)


def lanczos_eigsh(model, params: infl.Params, x, y_onehot, rank: int, key,
                  w=None) -> Tuple[torch.Tensor, torch.Tensor, callable]:
    """Top eigenpairs of the batch-CE training Hessian by Lanczos with full
    reorthogonalization (twice), the matvec being ``influence.hvp`` over
    the (optionally zero-weight-padded) batch.

    Returns ``(evals, V, unravel)``: eigenvalues by descending magnitude
    ``(r,)``, Ritz vectors ``(r, dim)`` (orthonormal rows), and the
    flat -> parameter-dict map; ``r <= rank`` (a breakdown, beta < 1e-7,
    truncates)."""
    def unravel(flat):
        return infl.unflatten(flat, params)

    def matvec(vf):
        return infl.flatten(infl.hvp(model, params, x, y_onehot,
                                     unravel(vf), w))

    v = _lanczos_start(params, key, x.device)
    v = v / torch.sqrt(infl.vdot(v, v))
    V = [v]
    alphas, betas = [], []
    for j in range(rank):
        u = matvec(V[j])
        alpha = infl.vdot(u, V[j])
        alphas.append(float(alpha))
        u = u - alpha * V[j]
        if j > 0:
            u = u - betas[j - 1] * V[j - 1]
        # full reorthogonalization, twice: plain three-term Lanczos loses
        # orthogonality to float drift within ~10 steps
        for _ in range(2):
            for q in V:
                u = u - infl.vdot(u, q) * q
        beta = float(torch.sqrt(infl.vdot(u, u)))
        if j == rank - 1 or beta < 1e-7:
            break
        betas.append(beta)
        V.append(u / beta)

    r = len(alphas)
    T = (np.diag(np.asarray(alphas))
         + np.diag(np.asarray(betas[:r - 1]), 1)
         + np.diag(np.asarray(betas[:r - 1]), -1))
    evals, U = np.linalg.eigh(T)
    # by |eigenvalue|: the CE Hessian is indefinite, and the modes farthest
    # from zero (either sign) are the ones the complement's 1/damping gets
    # most wrong; Lanczos finds both ends of the spectrum first
    order = np.argsort(-np.abs(evals))
    rot = torch.as_tensor(U[:, order].T).to(v.device, v.dtype)
    ritz = rot @ torch.stack(V[:r])
    return (torch.as_tensor(evals[order]).to(v.device, v.dtype), ritz,
            unravel)


def arnoldi_s_test(model, params: infl.Params, train_x, train_y_onehot,
                   query_x, query_y_onehot, rank: int, key,
                   damping: float = 0.01, n_valid=None, q_n_valid=None,
                   bucket: int = 256, basis=None):
    """Low-rank ``s_test ~= (H + damping)^-1 grad L(query)``: exact on the
    top-``rank`` eigenspace, ``1/damping`` on the complement; modes with
    ``|lambda + damping| < 0.1 damping`` are annihilated (the Hessian is
    indefinite, and a mode near ``-damping`` would own the solve).  The
    padding contract is ``influence.s_test``'s.  ``basis`` (a previous
    return's ``(evals, V, unravel)``) reuses the Lanczos basis across
    queries or rounds.  Returns ``(s_test, basis)``."""
    if basis is None:
        tx, ty, w = infl.padded_train_set(train_x, train_y_onehot, n_valid,
                                          bucket)
        basis = lanczos_eigsh(model, params, tx, ty, rank, key, w=w)
    evals, V, unravel = basis
    gf = infl.flatten(infl.query_gradient(model, params, query_x,
                                          query_y_onehot, q_n_valid))
    proj = V @ gf
    denom = evals + damping
    inv = torch.where(denom.abs() < 0.1 * damping, torch.zeros_like(denom),
                      1.0 / denom)
    top = V.T @ (proj * inv)
    compl = (gf - V.T @ proj) / damping
    return unravel(top + compl), basis
