"""Classification (multi-class) query strategies (counterpart of
``nnal_tpu/scoring/cls_strategies.py``).

Rebuild of ``NNAL.CNN_query`` (NNAL.py:188-525) with the JAX package's
13 names: ``random``, ``entropy``, ``egl``, ``fi`` (SDP), ``rep-entropy``,
the MC-dropout family (``MC-entropy``, ``BALD``, ``BatchBALD``), the
committees (``ensemble``, ``QBC-JS``), ``core-set``, ``influence`` and
``BADGE``, each in its multiclass form, over array-like image pools
(``data/image_pool``).

:func:`batched_forward` runs static-shape chunks of ``batch`` rows, the
ragged last one zero-padded and trimmed, so an MC pass's dropout masks
have the JAX shapes; a chunk's masks are keyed on the pass key and the
chunk's start ``lo`` (``fold_key(mc_rng, lo)``).  Each chunk is copied
from the host pool to the model's device (in-memory pools through pinned
buffers on the host's threads); ``as_device`` keeps the outputs there.
``compute_dtype`` (bf16) casts the input and the weights per call; the
engine scores at f32, as the JAX package's does.

The host stream ``ctx.rng`` is consumed at the JAX package's points (a
``permutation`` for random, one ``integers(2**31 - 1)`` for the MC family,
influence and BADGE, the PMF draws of fi), so later rounds' streams stay
in step; the device key of such an integer is ``core_rng.int_key(n)``,
and every device draw goes through ``core_rng``'s seams with the JAX fold
tags.  BALD and QBC-JS score in host float64 (:func:`_entropy_np`);
MC-entropy and ensemble average in the reference's running order.
Core-set bucket-pads the pool features (``pad_rows``), gives the pads
``sims0 = +inf`` and takes the labeled similarities from
``representative.cross_max_similarities`` (kernel K1 on the card).
Influence pads the labeled set to a 256 multiple with zero-weight rows.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from nnal_tpu_torch.core import rng as core_rng
from nnal_tpu_torch.data.batching import make_onehot
from nnal_tpu_torch.data.image_pool import InMemoryPool, LazyPoolView
from nnal_tpu_torch.scoring import influence as infl
from nnal_tpu_torch.scoring.batchbald import batchbald_select_probs
from nnal_tpu_torch.scoring.fisher import (
    a_matrices_multiclass,
    refine_feature_matrix,
)
from nnal_tpu_torch.scoring.gradients import shrunk_class_grads
from nnal_tpu_torch.scoring.pmf import sample_query_pmf
from nnal_tpu_torch.scoring.pool_eval import cast_input
from nnal_tpu_torch.scoring.representative import (
    badge_embeddings_multiclass,
    badge_kmeanspp,
    core_set_select,
    cross_max_similarities,
    normalize_rows,
    pad_rows,
    rep_entropy_from_features,
)
from nnal_tpu_torch.scoring.sdp import fi_query_distribution
from nnal_tpu_torch.scoring.strategies import _BB_CFG_FOLD, _s_test_dispatch
from nnal_tpu_torch.scoring.uncertainty import uncertainty_filter

METHODS = ("random", "entropy", "MC-entropy", "BALD", "BatchBALD",
           "ensemble", "QBC-JS", "core-set", "influence", "egl", "fi",
           "rep-entropy", "BADGE")


@dataclass
class ClsQueryContext:
    spec: object
    params: torch.nn.Module          # the model holding the weights
    pool_x: object                   # (n, ...) candidate inputs, array-like
    k: int
    rng: np.random.Generator
    B: int = 200
    lambda_: float = 0.0
    batch: int = 1024
    MC_iters: int = 10               # MC-dropout passes
    labeled_x: Optional[object] = None   # current train inputs (core-set,
    labeled_y: Optional[np.ndarray] = None  # influence); array-like view
    committee_params: Optional[list] = None  # ensemble/QBC-JS members
    bn: Optional[Dict] = None            # BN running stats (eval mode)
    extra: Dict = field(default_factory=dict)


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _host_chunks(X, batch: int, dev):
    """The pool's chunks of ``batch`` rows on ``dev``, the ragged last
    one zero-padded.  Rows that sit in one host array (a numpy pool, or a
    ``LazyPoolView`` of an ``InMemoryPool``) headed for the card are
    gathered by ``index_select`` on the host's threads into one of two
    pinned buffers and copied without blocking, the other buffer filling
    meanwhile; any other pool is fetched chunk by chunk."""
    n = X.shape[0]
    base, inds = None, None
    if isinstance(X, np.ndarray) and X.dtype == np.float32:
        base = X
    elif isinstance(X, LazyPoolView) and isinstance(X.pool, InMemoryPool):
        base, inds = X.pool.images, X.inds
    if base is None or dev.type != "cuda":
        for lo in range(0, n, batch):
            xs = np.asarray(X[lo:lo + batch], np.float32)
            pad = batch - xs.shape[0]
            if pad > 0:
                xs = np.concatenate([xs, np.zeros((pad,) + xs.shape[1:],
                                                  xs.dtype)])
            yield lo, pad, torch.from_numpy(xs).to(dev)
        return
    src = torch.from_numpy(base)
    bufs = [torch.empty((batch,) + tuple(base.shape[1:]),
                        dtype=torch.float32).pin_memory() for _ in range(2)]
    done = [None, None]
    for c, lo in enumerate(range(0, n, batch)):
        buf = bufs[c % 2]
        if done[c % 2] is not None:
            done[c % 2].synchronize()      # its last copy has left
        hi = min(lo + batch, n)
        rows = (torch.arange(lo, hi) if inds is None
                else torch.from_numpy(inds[lo:hi]))
        torch.index_select(src, 0, rows, out=buf[:hi - lo])
        if hi - lo < batch:
            buf[hi - lo:].zero_()
        x = buf.to(dev, non_blocking=True)
        done[c % 2] = torch.cuda.Event()
        done[c % 2].record()
        yield lo, batch - (hi - lo), x


@torch.no_grad()
def batched_forward(spec, params, X, batch: int, what=("posteriors",),
                    mc_rng=None, as_device: bool = False, state=None,
                    compute_dtype=None):
    """Static-shape chunked forward of the model ``params`` over an
    array-like pool (reference idxBatch_posteriors, NNAL_tools.py:382;
    module docstring).  ``mc_rng`` (a key) makes the pass stochastic (MC
    dropout, each chunk keyed on its start); ``state`` is the BN running
    state (eval mode).  Returns one array per entry of ``what``
    (``posteriors``, ``prediction``, ``feature_layer``): numpy, or device
    tensors with ``as_device``."""
    dev = _device(params)
    outs = {w: [] for w in what}
    for lo, pad, xd in _host_chunks(X, batch, dev):
        x = cast_input(xd, compute_dtype)
        gen = (None if mc_rng is None
               else core_rng.key_generator(mc_rng, lo, dev))
        out = params(x, mc_dropout=mc_rng is not None, generator=gen,
                     state=state)
        for w in what:
            t = {"posteriors": out.posteriors, "prediction": out.prediction,
                 "feature_layer": out.feature}[w]
            if pad:
                t = t[:t.shape[0] - pad]
            outs[w].append(t)
    return {w: torch.cat(v) if as_device else torch.cat(v).cpu().numpy()
            for w, v in outs.items()}


def _entropy_np(p: np.ndarray) -> np.ndarray:
    """Shannon entropy over the last axis (host numpy)."""
    return -(p * np.log(np.maximum(p, 1e-12))).sum(-1)


def _running_mean(stack: np.ndarray):
    """The reference's running mean over the first axis (host f32)."""
    avg = 0.0
    for i in range(stack.shape[0]):
        avg = (stack[i] + i * avg) / (i + 1)
    return avg


def _features(ctx: ClsQueryContext, X, as_device: bool = True):
    return batched_forward(ctx.spec, ctx.params, X, ctx.batch,
                           ("feature_layer",), as_device=as_device,
                           state=ctx.bn)["feature_layer"]


def _mc_stack(ctx: ClsQueryContext, key) -> np.ndarray:
    """(T, n, C) host stack of MC-dropout posteriors, pass ``t`` keyed
    ``fold_key(key, t)``."""
    return np.stack([
        batched_forward(ctx.spec, ctx.params, ctx.pool_x, ctx.batch,
                        mc_rng=core_rng.fold_key(key, t),
                        state=ctx.bn)["posteriors"]
        for t in range(ctx.MC_iters)])


def _core_set(ctx: ClsQueryContext, n: int) -> np.ndarray:
    """Greedy k-center on pool vs labeled features, on the device."""
    F_u = _features(ctx, ctx.pool_x)
    F_u, n_u = pad_rows(F_u)
    Fn = normalize_rows(F_u)
    if ctx.labeled_x is not None and len(ctx.labeled_x) > 0:
        F_t = _features(ctx, ctx.labeled_x)
        sims0 = cross_max_similarities(F_u, F_t, as_device=True,
                                       keep_pad=True)
    else:
        sims0 = F_u.new_full((F_u.shape[0],), float("-inf"),
                             dtype=torch.float32)
    valid = torch.arange(F_u.shape[0], device=F_u.device) < n_u
    sims0 = torch.where(valid, sims0, torch.full_like(sims0, float("inf")))
    return core_set_select(Fn, sims0, min(ctx.k, n))


def _influence(ctx: ClsQueryContext, posts: np.ndarray,
               sel: np.ndarray) -> np.ndarray:
    """s_test of the labeled set padded with zero-weight rows to a 256
    multiple, then the candidates ``sel`` ranked by ``|<grad L(z at its
    pseudo-label), s_test>|``."""
    if ctx.labeled_x is None or len(ctx.labeled_x) == 0:
        raise ValueError("influence querying needs ctx.labeled_x / "
                         "ctx.labeled_y")
    dev = _device(ctx.params)
    nclass = ctx.spec.nclass
    n_tr = len(ctx.labeled_x)
    pad = -n_tr % 256
    tx = np.asarray(ctx.labeled_x[:], np.float32)
    if pad:
        tx = np.concatenate([tx, np.zeros((pad,) + tx.shape[1:], tx.dtype)])
    y = np.zeros(n_tr + pad, np.int64)
    y[:n_tr] = np.asarray(ctx.labeled_y, np.int64)
    key = core_rng.int_key(int(ctx.rng.integers(2 ** 31 - 1)))
    params = infl.param_dict(ctx.params)
    st = _s_test_dispatch(ctx.extra, ctx.params, params,
                          torch.from_numpy(tx).to(dev),
                          torch.from_numpy(make_onehot(y, nclass)).to(dev),
                          float(ctx.extra.get("damping", 0.1)), n_tr, key)
    cx = torch.from_numpy(np.asarray(ctx.pool_x[sel], np.float32)).to(dev)
    pseudo = np.argmax(posts[sel], axis=1).astype(np.int64)
    cy = torch.from_numpy(make_onehot(pseudo, nclass)).to(dev)
    scores = infl.influence_scores(ctx.params, params, st, cx, cy)
    return sel[np.argsort(-np.abs(scores), kind="stable")[:ctx.k]]


def cls_query(ctx: ClsQueryContext, method_name: str) -> np.ndarray:
    """Returns positions into ``ctx.pool_x`` (reference NNAL.CNN_query)."""
    n = ctx.pool_x.shape[0]
    dev = _device(ctx.params)

    if method_name == "random":
        return ctx.rng.permutation(n)[:ctx.k]

    if method_name in ("MC-entropy", "BALD", "BatchBALD"):
        key = core_rng.int_key(int(ctx.rng.integers(2 ** 31 - 1)))
        stack = _mc_stack(ctx, key)
        if method_name == "MC-entropy":
            return uncertainty_filter(_running_mean(stack), ctx.k)
        s = stack.astype(np.float64)
        bald = _entropy_np(s.mean(0)) - _entropy_np(s).mean(0)
        if method_name == "BALD":
            return np.argsort(-bald, kind="stable")[:ctx.k]
        Bc = min(ctx.B, n)
        sel = np.argsort(-bald, kind="stable")[:Bc]
        chosen = batchbald_select_probs(
            torch.from_numpy(stack[:, sel]).to(dev), min(ctx.k, Bc),
            core_rng.key_generator(key, _BB_CFG_FOLD, dev))
        return sel[chosen]

    if method_name in ("ensemble", "QBC-JS"):
        if not ctx.committee_params:
            raise ValueError(f"{method_name} needs ctx.committee_params "
                             "(engine-built)")
        # members score on the main model's BN statistics
        stack = np.stack([
            batched_forward(ctx.spec, p, ctx.pool_x, ctx.batch,
                            state=ctx.bn)["posteriors"]
            for p in ctx.committee_params])              # (E, n, C)
        if method_name == "ensemble":
            return uncertainty_filter(_running_mean(stack), ctx.k)
        s = stack.astype(np.float64)
        js = _entropy_np(s.mean(0)) - _entropy_np(s).mean(0)
        return np.argsort(-js, kind="stable")[:ctx.k]

    if method_name == "core-set":
        return _core_set(ctx, n)

    posts = batched_forward(ctx.spec, ctx.params, ctx.pool_x,
                            ctx.batch, state=ctx.bn)["posteriors"]

    if method_name == "entropy":
        return uncertainty_filter(posts, ctx.k)

    B = min(ctx.B, n)
    sel = uncertainty_filter(posts, B)

    if method_name == "influence":
        return _influence(ctx, posts, sel)

    if method_name in ("egl", "fi"):
        shrunk = shrunk_class_grads(
            ctx.params,
            torch.from_numpy(np.asarray(ctx.pool_x[sel], np.float32)).to(dev))
        p_sel = torch.from_numpy(np.asarray(posts[sel], np.float32)).to(dev)
        if method_name == "egl":
            # expected gradient length: sum_c p_c ||shrunk grad_c||^2
            # (reference NNAL.py:234-292, repaired)
            scores = (p_sel * (shrunk ** 2).sum(-1)).sum(1).cpu().numpy()
            return sel[np.argsort(-scores, kind="stable")[:ctx.k]]
        A = a_matrices_multiclass(shrunk, p_sel)
        X_pool = None
        if ctx.lambda_ > 0:
            F = _features(ctx, ctx.pool_x[sel], as_device=False)
            ref_F = refine_feature_matrix(F.T, B)
            X_pool = ref_F - ref_F.mean(axis=1, keepdims=True)
        q = fi_query_distribution(A, ctx.lambda_, X_pool, ctx.k)
        return sel[sample_query_pmf(q, ctx.k, ctx.rng, replacement=True)]

    if method_name == "rep-entropy":
        F = _features(ctx, ctx.pool_x)
        rest = np.setdiff1d(np.arange(n), sel)
        if len(rest) == 0:
            return sel[:ctx.k]
        return sel[rep_entropy_from_features(F, rest, sel, min(ctx.k, B))]

    if method_name == "BADGE":
        # k-means++ over the candidates' (C*d) hallucinated-label
        # last-layer gradient embeddings (Ash et al. ICLR 2020)
        F = _features(ctx, ctx.pool_x[sel])
        E = badge_embeddings_multiclass(
            F, torch.from_numpy(np.asarray(posts[sel])).to(dev))
        key = core_rng.int_key(int(ctx.rng.integers(2 ** 31 - 1)))
        return sel[badge_kmeanspp(E, min(ctx.k, len(sel)),
                                  core_rng.key_stream(key, dev))]

    raise ValueError(f"unknown classification query method "
                     f"{method_name!r}; available: {list(METHODS)}")


def linear_softmax_fi_scores(X: torch.Tensor,
                             posts: torch.Tensor) -> torch.Tensor:
    """FI utility ``(||x||^2 + 1)(1 - ||p||^2)`` per sample, the closed
    form the reference's MNIST harness ranks by (NNAL_tools.py:116-360)."""
    xn = (X.reshape(X.shape[0], -1) ** 2).sum(1)
    pn = (posts ** 2).sum(1)
    return (xn + 1.0) * (1.0 - pn)
