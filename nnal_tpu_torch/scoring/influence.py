"""Influence-function scoring via Hessian-vector products (counterpart of
``nnal_tpu/scoring/influence.py``).

Reference flow (Influence.py:369-453): s_test = (H_train + damping)^-1
grad L(query), with H applied as Hessian-vector products, then each
candidate's influence ``-<grad L(z), s_test>``.

Everything here is a plain function of the model (a
:class:`~nnal_tpu_torch.models.cnn.CNN`, used only through
``torch.func.functional_call``) and a parameter dict keyed like
``named_parameters()`` (:func:`param_dict`).  It runs at f32 on the
module's own weights whatever the campaign's compute dtype, as the JAX
package's ``make_loss`` calls ``apply_cnn`` without one.  Vectors over
the parameters are such dicts; a "flat" vector concatenates them in
``named_parameters()`` order with the port's layouts (OIHW, (out, in)),
which is not JAX's ``ravel_pytree`` order (``models/bridge`` converts).

* :func:`hvp` is forward-over-reverse, ``torch.func.jvp`` of
  ``torch.func.grad``: an exact HVP at about the cost of a few
  backward passes, on every device.
* :func:`cg_solve_hvp` is the JAX package's truncated CG: a relative stop
  ``tol * max(rs0, 1e-30)``, an exit on ``p^T (H + damping) p <= 1e-12``
  (first-iteration negative curvature returns the right-hand side, as
  ``fmin_ncg`` does), ``beta`` over ``max(rs, 1e-30)``.  JAX runs it in a
  ``lax.while_loop``; here it is a Python loop that reads the stopping
  condition from the card once per iteration.
* :func:`influence_scores_jvp` gets every candidate's score from one
  forward-mode pass of the per-sample loss vector along s_test;
  :func:`_chunk_influence` is its ``vmap(grad)`` oracle.
* :func:`scipy_newton_cg_s_test` is the host parity path through
  ``scipy.optimize.fmin_ncg`` (the reference's solver).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch.func import functional_call, grad, jvp, vmap

Params = Dict[str, torch.Tensor]


def param_dict(model) -> Params:
    """The module's parameters, detached, keyed as ``named_parameters``."""
    return {n: p.detach() for n, p in model.named_parameters()}


def flatten(tree: Params) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tree.values()])


def unflatten(flat: torch.Tensor, like: Params) -> Params:
    out, lo = {}, 0
    for n, t in like.items():
        out[n] = flat[lo:lo + t.numel()].view(t.shape)
        lo += t.numel()
    return out


def vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``<a, b>`` of two flat vectors, summed pairwise (``torch.sum``).
    Over PW1 25x25x2's 36.1 M parameters the CPU's f32 ``torch.dot`` and
    ``vector_norm`` moved the host's Lanczos eigenvalues 2.3e-3 away from
    the card's (``chip_smoke.py``'s second-order phase)."""
    return (a * b).sum()


def tree_dot(a: Params, b: Params) -> torch.Tensor:
    """``sum <a_l, b_l>`` over the leaves, each leaf summed in f32 first
    (the JAX package's ``_tree_dot``)."""
    return torch.stack([(a[n].float() * b[n]).sum() for n in a]).sum()


def per_sample_ce(model, params: Params, x, y_onehot) -> torch.Tensor:
    """``-sum(y * log_softmax(logits))`` per row, without dropout."""
    logits = functional_call(model, params, (x,)).logits
    return -(y_onehot * torch.log_softmax(logits, dim=-1)).sum(-1)


def make_loss(model):
    """Mean CE loss over a batch, as a function of the parameters."""
    def loss(params, x, y_onehot):
        return per_sample_ce(model, params, x, y_onehot).mean()
    return loss


def make_weighted_loss(model):
    """Weighted-mean CE: zero-weight rows are exact no-ops (the denominator
    is ``max(sum w, 1)``), so a growing labeled set can be padded to a
    bucket of rows."""
    def loss(params, x, y_onehot, w):
        per = per_sample_ce(model, params, x, y_onehot)
        return (per * w).sum() / torch.clamp(w.sum(), min=1.0)
    return loss


def loss_grad(model, params: Params, x, y_onehot) -> Params:
    """Gradient of the batch loss (reference ``add_loss_grad``,
    NN.py:862-871)."""
    return grad(make_loss(model))(params, x, y_onehot)


def weighted_loss_grad(model, params: Params, x, y_onehot, w) -> Params:
    """Gradient of the weighted-mean batch loss."""
    return grad(make_weighted_loss(model))(params, x, y_onehot, w)


def hvp(model, params: Params, x, y_onehot, v: Params, w=None) -> Params:
    """Hessian of the (weighted) batch loss times ``v``, forward over
    reverse (replaces the reference's double backprop,
    Influence.py:64-123)."""
    if w is None:
        def g(p):
            return grad(make_loss(model))(p, x, y_onehot)
    else:
        def g(p):
            return grad(make_weighted_loss(model))(p, x, y_onehot, w)
    return jvp(g, (params,), (v,))[1]


def cg_solve_hvp(model, params: Params, x, y_onehot, v: Params,
                 damping: float = 0.01, max_iter: int = 50,
                 tol: float = 1e-6, w=None) -> Tuple[Params, dict]:
    """Solve ``(H + damping I) t = v`` by truncated conjugate gradients
    with :func:`hvp` as the matvec (replaces ``fmin_ncg`` at
    Influence.py:445).  Returns ``(t, info)``; ``info`` holds the
    iterations run (``iters``) and whether the loop stopped on
    non-positive curvature (``curvature_exit``)."""
    vf = flatten(v)

    def matvec(tf):
        return flatten(hvp(model, params, x, y_onehot, unflatten(tf, v),
                           w)) + damping * tf

    t = torch.zeros_like(vf)
    r = vf
    p = r
    rs = vdot(r, r)
    # relative: an absolute threshold skipped the loop for small-norm
    # query gradients and returned s_test = 0
    rs_stop = tol * torch.clamp(rs, min=1e-30)
    it, neg, go = 0, False, bool(rs > rs_stop)
    while go and it < max_iter:
        Ap = matvec(p)
        pAp = vdot(p, Ap)
        neg_t = pAp <= 1e-12
        alpha = torch.where(neg_t, 0.0, rs / torch.where(neg_t, 1.0, pAp))
        # first-iteration negative curvature: the steepest-descent
        # direction (the right-hand side), as fmin_ncg falls back to
        t = torch.where(neg_t, p, alpha * p) if it == 0 else t + alpha * p
        r = r - alpha * Ap
        rs_new = vdot(r, r)
        p = r + rs_new / torch.clamp(rs, min=1e-30) * p
        rs = rs_new
        it += 1
        neg, more = torch.stack([neg_t, rs > rs_stop]).tolist()
        go = more and not neg
    return unflatten(t, v), {"iters": it, "curvature_exit": bool(neg)}


def _valid_weights(n_rows: int, n_valid: int, device) -> torch.Tensor:
    return (torch.arange(n_rows, device=device) < int(n_valid)).float()


def _pad_rows(x: torch.Tensor, bucket: int) -> torch.Tensor:
    pad = -x.shape[0] % bucket
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def query_gradient(model, params: Params, qx, qy, q_n_valid=None) -> Params:
    """``grad L(query)``: the weighted mean over the first ``q_n_valid``
    rows when given (padding rows are exact no-ops), else the mean."""
    if q_n_valid is None:
        return loss_grad(model, params, qx, qy)
    return weighted_loss_grad(model, params, qx, qy,
                              _valid_weights(qx.shape[0], q_n_valid,
                                             qx.device))


def padded_train_set(train_x, train_y, n_valid=None, bucket: int = 256):
    """The training rows padded with zero rows to a ``bucket`` multiple,
    and their validity weights (the first ``n_valid`` rows)."""
    n = train_x.shape[0] if n_valid is None else int(n_valid)
    tx, ty = _pad_rows(train_x, bucket), _pad_rows(train_y, bucket)
    return tx, ty, _valid_weights(tx.shape[0], n, tx.device)


def s_test(model, params: Params, train_x, train_y_onehot, query_x,
           query_y_onehot, damping: float = 0.01, max_iter: int = 50,
           bucket: int = 256, n_valid=None, q_n_valid=None) -> Params:
    """``(H_train + damping)^-1 grad L(query)`` (reference
    ``PW_sample_influence``, Influence.py:369-453).  The training set is
    padded to a multiple of ``bucket`` with zero-weight rows; ``n_valid``
    marks the logical count when the caller padded it already, and
    ``q_n_valid`` makes v the weighted mean gradient of the first
    ``q_n_valid`` query rows."""
    v = query_gradient(model, params, query_x, query_y_onehot, q_n_valid)
    tx, ty, w = padded_train_set(train_x, train_y_onehot, n_valid, bucket)
    return cg_solve_hvp(model, params, tx, ty, v, damping, max_iter,
                        w=w)[0]


def influence_scores_jvp(model, params: Params, s_test_vec: Params, xs,
                         ys) -> torch.Tensor:
    """``-<grad L(z_i), s_test>`` for every row in one forward-mode pass:
    the jvp of the per-sample loss vector along s_test is the vector of
    per-sample gradient dot products, so no per-sample gradient is
    formed (the reference ran one backward per sample,
    Influence.py:168-201)."""
    def losses(p):
        return per_sample_ce(model, p, xs, ys)

    return -jvp(losses, (params,), (s_test_vec,))[1]


def _chunk_influence(model, params: Params, s_test_vec: Params, xs,
                     ys) -> torch.Tensor:
    """``vmap(grad)`` per-sample oracle of :func:`influence_scores_jvp`
    (kept for the tests; the jvp pass is the production path)."""
    g = grad(make_loss(model))

    def one(xi, yi):
        return -tree_dot(g(params, xi[None], yi[None]), s_test_vec)

    return vmap(one)(xs, ys)


def influence_scores(model, params: Params, s_test_vec: Params, pool_x,
                     pool_y_onehot, bucket: int = 256) -> np.ndarray:
    """Per-candidate influence ``-<grad L(z_i), s_test>`` by one jvp pass
    over the candidates padded with zero rows to a ``bucket`` multiple
    (the padding's scores are sliced off)."""
    n = pool_x.shape[0]
    vals = influence_scores_jvp(model, params, s_test_vec,
                                _pad_rows(pool_x, bucket),
                                _pad_rows(pool_y_onehot, bucket))
    return vals[:n].cpu().numpy()


def scipy_newton_cg_s_test(model, params: Params, train_x, train_y,
                           v: Params, damping: float = 0.01) -> Params:
    """Host Newton-CG parity path (the reference's solver seam,
    Influence.py:445): minimizes ``1/2 t^T (H + damping) t - v^T t`` with
    scipy, calling :func:`hvp` for the Hessian-vector products."""
    from scipy.optimize import fmin_ncg

    vf = flatten(v)
    dev, flat_v = vf.device, vf.cpu().numpy()

    def Hflat(t):
        tt = unflatten(torch.as_tensor(t, dtype=torch.float32).to(dev), v)
        return flatten(hvp(model, params, train_x, train_y,
                           tt)).cpu().numpy()

    def f(t):
        return float(0.5 * np.dot(t, Hflat(t) + damping * t)
                     - np.dot(flat_v, t))

    def fprime(t):
        return Hflat(t) + damping * t - flat_v

    def fhess_p(t, p):
        return Hflat(p) + damping * p

    sol = fmin_ncg(f, flat_v.copy(), fprime=fprime, fhess_p=fhess_p,
                   disp=False, avextol=1e-8)
    return unflatten(torch.as_tensor(sol, dtype=torch.float32).to(dev), v)
