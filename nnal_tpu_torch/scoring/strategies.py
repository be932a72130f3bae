"""Query-strategy dispatch for patch-wise AL (counterpart of
``nnal_tpu/scoring/strategies.py:87-229``).

Each strategy consumes a :class:`QueryContext` and returns positions into
``ctx.pool_inds``.  The port has ``random``, ``entropy``, ``core-set`` and
``fi``; any other name raises the dispatch's ``ValueError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from nnal_tpu_torch.core.profiling import subphase
from nnal_tpu_torch.scoring.fisher import refine_feature_matrix
from nnal_tpu_torch.scoring.gradients import gather_shrunk_a_matrices
from nnal_tpu_torch.scoring.pmf import sample_query_pmf
from nnal_tpu_torch.scoring.pool_eval import PoolEvaluator
from nnal_tpu_torch.scoring.representative import (
    ROW_BUCKET,
    core_set_select,
    cross_max_similarities,
    normalize_rows,
    pad_inds_repeat,
)
from nnal_tpu_torch.scoring.sdp import fi_query_distribution
from nnal_tpu_torch.scoring.uncertainty import binary_uncertainty_filter


@dataclass
class QueryContext:
    """Everything a strategy needs for one subject."""

    spec: object
    params: torch.nn.Module               # the model holding the weights
    evaluator: PoolEvaluator
    pool_inds: np.ndarray                 # raveled voxel indices
    k: int
    rng: np.random.Generator              # host sampling
    B: int = 200                          # fi's uncertainty-filter size
    lambda_: float = 0.0                  # fi's representativeness weight
    diag_load: float = 1e-5               # fi's A-matrix diagonal load
    train_inds: Optional[np.ndarray] = None


_STRATEGIES: Dict[str, Callable] = {}


def register_strategy(name: str):
    def deco(fn):
        _STRATEGIES[name] = fn
        return fn
    return deco


def cnn_query(ctx: QueryContext, method_name: str) -> np.ndarray:
    """Dispatch (reference ``PW_NNAL.CNN_query``).  Returns positions into
    ``ctx.pool_inds``."""
    if method_name not in _STRATEGIES:
        raise ValueError(f"unknown query method {method_name!r}; "
                         f"available: {sorted(_STRATEGIES)}")
    q = _STRATEGIES[method_name](ctx)
    return np.asarray(q, dtype=np.int64)


def _require_patch_evaluator(ev, method: str) -> None:
    """Per-patch gradient methods need the patch evaluator's device volume
    (``ev.padded``); dense (fcn) evaluators have none.  Fail with a clear
    message at strategy entry instead of an AttributeError mid-way."""
    if not hasattr(ev, "padded"):
        raise NotImplementedError(
            f"{method} needs per-patch gradients: the dense-spec (fcn) "
            "branch is not ported yet (ROADMAP Queue 1 item 9)")


def _posteriors(ctx: QueryContext) -> np.ndarray:
    return ctx.evaluator.evaluate(ctx.params, ctx.pool_inds,
                                  ("posteriors",))["posteriors"]


@register_strategy("random")
def _random(ctx: QueryContext):
    return ctx.rng.permutation(len(ctx.pool_inds))[:ctx.k]


@register_strategy("entropy")
def _entropy(ctx: QueryContext):
    return binary_uncertainty_filter(_posteriors(ctx), ctx.k)


@register_strategy("core-set")
def _core_set(ctx: QueryContext):
    """Greedy k-center on pool features vs labeled features (reference
    PW_NNAL.py:353-451), features on the device end to end.  The pool
    index array is repeat-padded to a ``ROW_BUCKET`` multiple as in the
    JAX package; the padded rows get ``sims0 = +inf`` so the argmin never
    picks them."""
    n_u = len(ctx.pool_inds)
    inds_p = pad_inds_repeat(ctx.pool_inds, ROW_BUCKET)
    F_u = ctx.evaluator.evaluate(ctx.params, inds_p, ("feature_layer",),
                                 as_device=True)["feature_layer"]
    Fn = normalize_rows(F_u)
    if ctx.train_inds is not None and len(ctx.train_inds) > 0:
        tr_p = pad_inds_repeat(ctx.train_inds, 256)
        F_t = ctx.evaluator.evaluate(ctx.params, tr_p, ("feature_layer",),
                                     as_device=True)["feature_layer"]
        sims0 = cross_max_similarities(F_u, F_t, as_device=True,
                                       keep_pad=True)
    else:
        sims0 = torch.full((F_u.shape[0],), float("-inf"),
                           device=F_u.device)
    valid = torch.arange(F_u.shape[0], device=F_u.device) < n_u
    sims0 = torch.where(valid, sims0, torch.full_like(sims0, float("inf")))
    return core_set_select(Fn, sims0, min(ctx.k, n_u))


@register_strategy("fi")
def _fi(ctx: QueryContext):
    """Fisher-information querying (reference PW_NNAL.py:89-163): the B
    most uncertain pool voxels -> candidate gather (K2 on the card) ->
    shrunk class gradients -> A-matrices -> the A-optimal SDP, all on the
    evaluator's device -> PMF draws on the host (with replacement, then
    deduplicated, so a round may return fewer than k)."""
    ev = ctx.evaluator
    _require_patch_evaluator(ev, "fi")
    with subphase("fi/posteriors"):
        p1 = _posteriors(ctx)
    B = min(ctx.B, len(ctx.pool_inds))
    sel = binary_uncertainty_filter(p1, B)
    cand_inds = ctx.pool_inds[sel]
    with subphase("fi/gather_grads_A"):
        A = gather_shrunk_a_matrices(
            ctx.params, ev.padded,
            torch.as_tensor(np.asarray(cand_inds, np.int64)).to(ev.device),
            ev.mu, ev.sd, ev.patch_shape, ev.orig_shape,
            torch.as_tensor(np.asarray(p1[sel], np.float32)).to(ev.device),
            ctx.diag_load)
    X_pool = None
    if ctx.lambda_ > 0:
        with subphase("fi/features"):
            feats = ev.evaluate(ctx.params, cand_inds,
                                ("feature_layer",))["feature_layer"]
        ref_F = refine_feature_matrix(np.asarray(feats).T, len(sel))
        X_pool = ref_F - ref_F.mean(axis=1, keepdims=True)
    with subphase("fi/sdp"):
        q = fi_query_distribution(A, ctx.lambda_, X_pool, ctx.k)
    with subphase("fi/pmf"):
        picks = sample_query_pmf(q, ctx.k, ctx.rng, replacement=True)
    return sel[picks]
