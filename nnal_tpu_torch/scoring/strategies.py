"""Query-strategy dispatch for patch-wise AL (counterpart of
``nnal_tpu/scoring/strategies.py``).

Each strategy consumes a :class:`QueryContext` and returns positions into
``ctx.pool_inds``.  The port has all 15 strategies of the JAX package:
``random``, ``ps-random``, ``entropy``, ``core-set``, ``fi``, the
stochastic family (``MC-entropy``, ``BALD``, ``BatchBALD``, ``AU_4U``),
the committees (``ensemble``, ``QBC-JS``), the batch-diverse
``rep-entropy`` and ``BADGE``, ``SuPix`` and the second-order
``influence``.  A strategy only the JAX package has would be listed in
:data:`REFERENCE_ONLY` with the ROADMAP item that ports it and raise
``NotImplementedError`` (checked by :func:`require_strategy` before a
method is set up); any other unknown name raises ``ValueError``.
Stochastic strategies key their device draws on ``ctx.seed`` (the
counterpart of the JAX context's ``jax_rng``: the round's
``qrng.next()``), with the JAX package's fold tags.

:func:`query_multimg` is the multi-subject dispatch (reference
``query_multimg``, PW_NNAL.py:169-627; ``strategies.py:582-877``): each
subject's pool is scored by its own evaluator, selection is global over
the concatenated pools, and the picks come back as per-subject positions
through the ``global2local_inds`` algebra.  Every strategy has its
branch; the keys are the JAX package's (each subject's context its own
seed, ``BatchBALD`` and ``BADGE`` subject 0's with their fold tags).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from nnal_tpu_torch.core import rng as core_rng
from nnal_tpu_torch.core.profiling import subphase
from nnal_tpu_torch.data.batching import make_onehot
from nnal_tpu_torch.data.indexing import expand_raveled_inds, global2local_inds
from nnal_tpu_torch.data.patches import gather_labels, gather_patches_normalized
from nnal_tpu_torch.data.samplers import high_variance_filter
from nnal_tpu_torch.models.perturb import measure_output_perturbation
from nnal_tpu_torch.scoring import hessian
from nnal_tpu_torch.scoring import influence as infl
from nnal_tpu_torch.scoring.batchbald import batchbald_select
from nnal_tpu_torch.scoring.fisher import (
    a_matrices,
    a_matrices_multiclass,
    hallucinated_class_grads,
    refine_feature_matrix,
)
from nnal_tpu_torch.scoring.gradients import gather_shrunk_a_matrices
from nnal_tpu_torch.scoring.grid_eval import GridPoolEvaluator
from nnal_tpu_torch.scoring.pmf import sample_query_pmf
from nnal_tpu_torch.scoring.pool_eval import (
    PoolEvaluator,
    mc_average_posteriors,
    mc_stack_posteriors,
)
from nnal_tpu_torch.scoring.representative import (
    ROW_BUCKET,
    badge_embeddings,
    badge_kmeanspp,
    core_set_select,
    cross_max_similarities,
    normalize_rows,
    pad_inds_repeat,
    pad_rows,
    rep_entropy_from_features,
)
from nnal_tpu_torch.scoring.sdp import fi_query_distribution
from nnal_tpu_torch.scoring.superpixel import (
    oversegment_volume,
    superpix_scores,
    supix_query,
)
from nnal_tpu_torch.scoring.uncertainty import (
    bald_scores_bucketed,
    binary_uncertainty_filter,
    running_average,
)

# fold tags of the JAX package (``strategies.py:50-51``, ``:216``):
# BatchBALD's configuration draws, Lanczos's start vector and BADGE's
# k-means++ draws
_BB_CFG_FOLD = (1 << 20) + 13
_ARNOLDI_KEY_FOLD = (1 << 20) + 29
_BADGE_FOLD = 7


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
    seed: int = 0                         # device draws (JAX's jax_rng)
    MC_iters: int = 10
    hv_threshold: float = 2.0             # ps-random's variance floor
    ensemble_params: Optional[List[torch.nn.Module]] = None  # committee
    raw_volume: Optional[np.ndarray] = None  # unpadded modality 0
    # mask (influence's labels), overseg (SuPix's cache), n_segments,
    # influence_mode, arnoldi_rank, damping, and AU_4U's knobs
    extra: Dict = field(default_factory=dict)


_STRATEGIES: Dict[str, Callable] = {}

# the JAX package's strategies the port lacks, each with the ROADMAP
# Queue 1 item that ports it; drop a name when its item lands
REFERENCE_ONLY: Dict[str, int] = {}


def register_strategy(name: str):
    def deco(fn):
        _STRATEGIES[name] = fn
        return fn
    return deco


def require_strategy(method_name: str) -> None:
    """Raise unless the port has ``method_name``: ``NotImplementedError``
    naming the ROADMAP item for a strategy only the JAX package has,
    ``ValueError`` for a name neither has."""
    if method_name in _STRATEGIES:
        return
    if method_name in REFERENCE_ONLY:
        raise NotImplementedError(
            f"query method {method_name!r} is not ported to the PyTorch "
            f"port yet (ROADMAP Queue 1 item {REFERENCE_ONLY[method_name]})")
    raise ValueError(f"unknown query method {method_name!r}; "
                     f"available: {sorted(_STRATEGIES)}")


def available_strategies() -> List[str]:
    """The registered strategy names, sorted (``strategies.py:1014``)."""
    return sorted(_STRATEGIES)


def cnn_query(ctx: QueryContext, method_name: str) -> np.ndarray:
    """Dispatch (reference ``PW_NNAL.CNN_query``).  Returns positions into
    ``ctx.pool_inds``."""
    require_strategy(method_name)
    q = _STRATEGIES[method_name](ctx)
    return np.asarray(q, dtype=np.int64)


def _require_patch_evaluator(ev, method: str) -> None:
    """Per-patch gradient methods need the patch evaluator's device volume
    (``ev.padded``); dense (fcn) evaluators serve posteriors and per-pixel
    features but no patch-level loss gradients.  Fail with a clear message
    at strategy entry (``strategies.py:97-106``) instead of an
    AttributeError mid-way."""
    if not hasattr(ev, "padded"):
        raise NotImplementedError(
            f"{method} needs per-patch gradients — dense-model (fcn) specs "
            "support the uncertainty + feature-space families and "
            "last-layer fi; full-gradient methods need the patch-wise "
            "evaluator")


def _gather(ev, inds) -> torch.Tensor:
    """Normalized patches at host ``inds`` of the evaluator's volume (K2
    on the card)."""
    return gather_patches_normalized(
        ev.padded, torch.as_tensor(np.asarray(inds, np.int64)).to(ev.device),
        ev.mu, ev.sd, ev.patch_shape, ev.orig_shape)


def _posteriors(ctx: QueryContext) -> np.ndarray:
    return ctx.evaluator.evaluate(ctx.params, ctx.pool_inds,
                                  ("posteriors",))["posteriors"]


@register_strategy("random")
def _random(ctx: QueryContext):
    return ctx.rng.permutation(len(ctx.pool_inds))[:ctx.k]


def _hv_patch(ev):
    """The patch shape whose first radius is ps-random's variance window:
    the evaluator's, or a dense evaluator's ``hv_patch_shape``."""
    return getattr(ev, "hv_patch_shape", ev.patch_shape)


@register_strategy("ps-random")
def _ps_random(ctx: QueryContext):
    """Random picks among the pool voxels of high local variance
    (reference PW_NNAL.py:37-48), the variance map on the evaluator's
    device."""
    if ctx.raw_volume is None:
        raise ValueError("ps-random needs the raw volume")
    valid = high_variance_filter(ctx.raw_volume, _hv_patch(ctx.evaluator),
                                 ctx.hv_threshold, ctx.pool_inds,
                                 device=ctx.evaluator.device)
    return valid[ctx.rng.permutation(len(valid))[:ctx.k]]


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
    if not hasattr(ev, "padded"):
        return _fi_dense(ctx)
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


def _dense_a_matrices(F_sel: torch.Tensor, p_sel: torch.Tensor,
                      diag_load: float) -> torch.Tensor:
    """A-matrices of hallucinated last-layer gradients (binary ``(b,)``
    or multiclass ``(b, c)`` posteriors)."""
    g = hallucinated_class_grads(F_sel, p_sel)
    if p_sel.dim() == 1:
        return a_matrices(g, p_sel, diag_load)
    return a_matrices_multiclass(g, p_sel, diag_load)


def _fi_dense(ctx: QueryContext):
    """fi for dense (fcn) specs (``strategies.py:534-580``): one evaluate
    of posteriors and per-pixel features, the uncertainty filter to B,
    A-matrices of the hallucinated last-layer gradients of the candidates'
    features (f32, on the device), with ``lambda_`` the refined feature
    matrix, then the SDP and the PMF draws."""
    with subphase("fi/posteriors"):
        res = ctx.evaluator.evaluate(ctx.params, ctx.pool_inds,
                                     ("posteriors", "feature_layer"),
                                     as_device=True)
        p1 = res["posteriors"].cpu().numpy()
    with subphase("fi/filter"):
        B = min(ctx.B, len(ctx.pool_inds))
        sel = binary_uncertainty_filter(p1 if p1.ndim == 1 else p1[:, 1], B)
    with subphase("fi/gather_grads_A"):
        dev = res["feature_layer"].device
        F_sel = res["feature_layer"][_to_dev(sel, dev)]
        A = _dense_a_matrices(F_sel, torch.as_tensor(
            np.asarray(p1[sel], np.float32)).to(dev), ctx.diag_load)
    X_pool = None
    if ctx.lambda_ > 0:
        ref_F = refine_feature_matrix(F_sel.cpu().numpy().T, len(sel))
        X_pool = ref_F - ref_F.mean(axis=1, keepdims=True)
    with subphase("fi/sdp"):
        q = fi_query_distribution(A, ctx.lambda_, X_pool, ctx.k)
    with subphase("fi/pmf"):
        picks = sample_query_pmf(q, ctx.k, ctx.rng, replacement=True)
    return sel[picks]


@register_strategy("MC-entropy")
def _mc_entropy(ctx: QueryContext):
    avg = mc_average_posteriors(ctx.evaluator, ctx.params, ctx.pool_inds,
                                ctx.MC_iters, ctx.seed, as_device=True)
    return binary_uncertainty_filter(avg, ctx.k)


def _mc_bald(ctx: QueryContext):
    """The ``(T, n)`` MC stack on the device and its BALD scores on the
    host."""
    mc = mc_stack_posteriors(ctx.evaluator, ctx.params, ctx.pool_inds,
                             ctx.MC_iters, ctx.seed, as_device=True)
    return mc, bald_scores_bucketed(mc)


@register_strategy("BALD")
def _bald(ctx: QueryContext):
    _, scores = _mc_bald(ctx)
    return np.argsort(-scores, kind="stable")[:ctx.k]


@register_strategy("BatchBALD")
def _batchbald(ctx: QueryContext):
    """Greedy joint MI over the top-B BALD candidates of the same MC
    stack (``scoring/batchbald.py``), on the stack's device."""
    mc, scores = _mc_bald(ctx)
    B = min(ctx.B, len(ctx.pool_inds))
    sel = np.argsort(-scores, kind="stable")[:B]
    sel_t = torch.as_tensor(sel).to(mc.device)
    chosen = batchbald_select(
        mc[:, sel_t], min(ctx.k, B),
        core_rng.key_generator(ctx.seed, _BB_CFG_FOLD, mc.device))
    return sel[chosen]


@register_strategy("rep-entropy")
def _rep_entropy(ctx: QueryContext):
    """Uncertainty filter to B, then greedy representativeness of the
    candidates against the rest of the pool (reference
    PW_NNAL.py:284-351), features on the device."""
    n = len(ctx.pool_inds)
    res = ctx.evaluator.evaluate(ctx.params, ctx.pool_inds,
                                 ("posteriors", "feature_layer"),
                                 as_device=True)
    B = min(ctx.B, n)
    sel = binary_uncertainty_filter(res["posteriors"], B)
    rest = np.setdiff1d(np.arange(n), sel)
    if len(rest) == 0:
        return sel[:ctx.k]
    return sel[rep_entropy_from_features(res["feature_layer"], rest, sel,
                                         min(ctx.k, B))]


@register_strategy("BADGE")
def _badge(ctx: QueryContext):
    """Uncertainty filter to B, then k-means++ over the candidates'
    hallucinated last-layer gradient embeddings (f32, on the device)."""
    res = ctx.evaluator.evaluate(ctx.params, ctx.pool_inds,
                                 ("posteriors", "feature_layer"),
                                 as_device=True)
    p1 = res["posteriors"]
    B = min(ctx.B, len(ctx.pool_inds))
    sel = binary_uncertainty_filter(p1, B)
    sel_t = torch.as_tensor(sel).to(p1.device)
    E = badge_embeddings(res["feature_layer"][sel_t], p1[sel_t])
    chosen = badge_kmeanspp(
        E, min(ctx.k, len(sel)),
        core_rng.key_generator(ctx.seed, _BADGE_FOLD, p1.device))
    return sel[chosen]


def _committee_posteriors(ctx: QueryContext) -> torch.Tensor:
    """(E, n) pool posteriors across the committee (reference
    PW_NNAL.py:453-545), on the evaluator's device."""
    if not ctx.ensemble_params:
        raise ValueError("ensemble methods need ensemble_params")
    return torch.stack([
        ctx.evaluator.evaluate(m, ctx.pool_inds, ("posteriors",),
                               as_device=True)["posteriors"]
        for m in ctx.ensemble_params])


@register_strategy("ensemble")
def _ensemble(ctx: QueryContext):
    """Average the committee's posteriors in the reference's running
    order, then the binary uncertainty filter."""
    posts = _committee_posteriors(ctx)
    avg = 0.0
    for i in range(posts.shape[0]):
        avg = running_average(posts[i], avg, i)
    return binary_uncertainty_filter(avg, ctx.k)


@register_strategy("QBC-JS")
def _qbc_js(ctx: QueryContext):
    scores = bald_scores_bucketed(_committee_posteriors(ctx))
    return np.argsort(-scores, kind="stable")[:ctx.k]


def _au_4u_scores(ctx: QueryContext) -> np.ndarray:
    """Per-pool-voxel AU_4U divergence (higher = more unstable): the grid
    sweep for grid pools, else ``ntb`` chunks through the per-patch
    gather (K2 on the card), each chunk's noise keyed on its start, as
    in JAX (``strategies.py:338-380``)."""
    ev = ctx.evaluator
    _require_patch_evaluator(ev, "AU_4U")
    kw = dict(teacher=ctx.extra.get("teacher_params"),
              measure=ctx.extra.get("output_perturbation_measure", "CE"),
              gaussian_std=ctx.extra.get("gaussian_noise_std", 0.05),
              rotation_angle=ctx.extra.get("rotation_angle"))
    rows = (ev._grid_rows(ctx.pool_inds)
            if isinstance(ev, GridPoolEvaluator) and ev._sweep_ok else None)
    if rows is not None:
        return ev.perturb_sweep(ctx.params, ctx.seed, **kw)[rows]
    # the off-grid fallback runs f32, as in JAX; the ragged tail is padded
    # to a whole chunk so every chunk's noise has one shape
    n = len(ctx.pool_inds)
    inds = np.concatenate([np.asarray(ctx.pool_inds, np.int64),
                           np.zeros(-n % ev.ntb, np.int64)])
    inds_t = torch.as_tensor(inds).to(ev.device)
    scores = []
    for lo in range(0, len(inds), ev.ntb):
        x = gather_patches_normalized(ev.padded, inds_t[lo:lo + ev.ntb],
                                      ev.mu, ev.sd, ev.patch_shape,
                                      ev.orig_shape)
        scores.append(measure_output_perturbation(
            ctx.params, x, core_rng.key_generator(ctx.seed, lo, ev.device),
            **kw))
    return torch.cat(scores)[:n].cpu().numpy()


@register_strategy("AU_4U")
def _au_4u(ctx: QueryContext):
    """Output-perturbation uncertainty (reference AU_4U,
    NN_extended.py:913,1502): the k pool patches whose posterior moves
    most under noise and/or rotation."""
    scores = _au_4u_scores(ctx)
    return np.argsort(-scores, kind="stable")[:ctx.k]


@register_strategy("SuPix")
def _supix(ctx: QueryContext):
    """Superpixel querying (reconstructed, as in the JAX package; the
    reference's path is broken): SLIC-oversegment the first modality
    (cached in ``extra["overseg"]``), score pool voxels by |p - 0.5|, pick
    the k superpixels with the lowest minimum score, and query every pool
    member of them, so a round returns many more than k positions."""
    overseg = ctx.extra.get("overseg")
    if overseg is None:
        if ctx.raw_volume is None:
            raise ValueError("SuPix needs the raw volume")
        overseg = oversegment_volume(ctx.raw_volume,
                                     ctx.extra.get("n_segments", 64))
        ctx.extra["overseg"] = overseg
    unc = np.abs(_posteriors(ctx) - 0.5)
    _, members = supix_query(overseg, ctx.pool_inds, unc, ctx.k)
    if not members:
        return np.zeros(0, dtype=np.int64)
    wanted = np.unique(np.concatenate(members))
    return np.flatnonzero(np.isin(ctx.pool_inds, wanted))


def _s_test_dispatch(extra: Dict, model, params, tx, ty, damping,
                     n_tr: int, seed):
    """The s_test solver: ``cg`` (truncated CG, the reference's semantics)
    or ``arnoldi`` (the low-rank Lanczos basis, ``arnoldi_rank``).  Both
    weight the padding rows to exact no-ops in H and in v."""
    mode = extra.get("influence_mode", "cg")
    if mode == "arnoldi":
        st, _ = hessian.arnoldi_s_test(
            model, params, tx, ty, tx, ty,
            rank=int(extra.get("arnoldi_rank", 8)),
            key=core_rng.fold_key(seed, _ARNOLDI_KEY_FOLD),
            damping=damping, n_valid=n_tr, q_n_valid=n_tr)
        return st
    if mode != "cg":
        raise ValueError(f"unknown influence_mode {mode!r}; "
                         "expected 'cg' or 'arnoldi'")
    return infl.s_test(model, params, tx, ty, tx, ty, damping=damping,
                       n_valid=n_tr, q_n_valid=n_tr)


@register_strategy("influence")
def _influence(ctx: QueryContext):
    """Influence-function querying (reference
    ``Influence.PW_sample_influence``, Influence.py:369-453): s_test =
    (H_train + damping)^-1 grad L(labeled set) at f32, then the B most
    uncertain pool voxels (gathered through K2 on the card) ranked by
    ``|<grad L(z), s_test>|`` at their pseudo-labels ``p1 > 0.5``."""
    if ctx.train_inds is None or len(ctx.train_inds) == 0:
        raise ValueError("influence querying needs a labeled set")
    ev = ctx.evaluator
    _require_patch_evaluator(ev, "influence")
    mask = ctx.extra.get("mask")
    if mask is None:
        raise ValueError("influence querying needs the label mask")
    nclass = ctx.spec.nclass
    params = infl.param_dict(ctx.params)

    with subphase("influence/labeled_gather"):
        # padded to a 256 multiple with index 0, weighted out below, as
        # the JAX package buckets it
        n_tr = len(ctx.train_inds)
        tr_inds = np.concatenate([np.asarray(ctx.train_inds, np.int64),
                                  np.zeros(-n_tr % 256, np.int64)])
        tr = _gather(ev, tr_inds)
        y_lab = np.zeros(len(tr_inds), np.int64)
        y_lab[:n_tr] = gather_labels(mask, ctx.train_inds, ev.orig_shape)
        tr_y = torch.as_tensor(make_onehot(y_lab, nclass)).to(ev.device)
    with subphase("influence/s_test"):
        # the span ends with a device sync (subphase), so the solve's
        # queued kernels bill here
        st = _s_test_dispatch(ctx.extra, ctx.params, params, tr, tr_y,
                              ctx.extra.get("damping", 0.1), n_tr,
                              ctx.seed)
    B = min(ctx.B, len(ctx.pool_inds))
    with subphase("influence/posteriors"):
        p1 = _posteriors(ctx)
    with subphase("influence/filter"):
        sel = binary_uncertainty_filter(p1, B)
    with subphase("influence/cand_scores"):
        cx = _gather(ev, ctx.pool_inds[sel])
        pseudo = (p1[sel] > 0.5).astype(np.int64)
        cy = torch.as_tensor(make_onehot(pseudo, nclass)).to(ev.device)
        scores = infl.influence_scores(ctx.params, params, st, cx, cy)
    return sel[np.argsort(-np.abs(scores), kind="stable")[:ctx.k]]


# --------------------------------------------------------------------------- #
# multi-subject dispatch (reference query_multimg, PW_NNAL.py:169-627)
# --------------------------------------------------------------------------- #
def _to_dev(inds, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(inds, np.int64)).to(dev)


def _gather_padded(ev, inds, mult: int) -> torch.Tensor:
    """:func:`_gather` of ``inds`` padded with index 0 to a ``mult``
    multiple, the pad rows sliced off (``strategies.py:955-964``)."""
    n = len(inds)
    p = np.concatenate([np.asarray(inds, np.int64),
                        np.zeros(-n % mult, np.int64)])
    return _gather(ev, p)[:n]


def _concat_feats_posts(contexts):
    """(device features, host posteriors) of every subject's pool,
    concatenated in subject order."""
    F, p1 = [], []
    for c in contexts:
        r = c.evaluator.evaluate(c.params, c.pool_inds,
                                 ("posteriors", "feature_layer"),
                                 as_device=True)
        F.append(r["feature_layer"])
        p1.append(r["posteriors"].cpu().numpy())
    return torch.cat(F), np.concatenate(p1)


def _subject_scores(c: QueryContext, method_name: str) -> np.ndarray:
    """One subject's scores of the score-and-concatenate family, ascending
    = most wanted (``strategies.py:610-634``)."""
    if method_name == "entropy":
        return np.abs(_posteriors(c) - 0.5)
    if method_name == "MC-entropy":
        avg = mc_average_posteriors(c.evaluator, c.params, c.pool_inds,
                                    c.MC_iters, c.seed)
        return np.abs(avg - 0.5)
    if method_name == "BALD":
        mc = mc_stack_posteriors(c.evaluator, c.params, c.pool_inds,
                                 c.MC_iters, c.seed, as_device=True)
        return -bald_scores_bucketed(mc)
    posts = _committee_posteriors(c)
    if method_name == "ensemble":
        avg = 0.0
        for i in range(posts.shape[0]):
            avg = running_average(posts[i], avg, i)
        return np.abs(avg.cpu().numpy() - 0.5)
    return -bald_scores_bucketed(posts)


def query_multimg(contexts: Sequence[QueryContext], method_name: str,
                  k: int, rng) -> List[np.ndarray]:
    """Query across subjects (module docstring).  ``rng`` is the round's
    host generator (``random``, ``ps-random`` and fi's PMF draws).
    Returns one array of positions into each context's ``pool_inds``."""
    require_strategy(method_name)
    sizes = [len(c.pool_inds) for c in contexts]
    ref = contexts[0]

    if method_name == "random":
        return global2local_inds(rng.permutation(int(np.sum(sizes)))[:k],
                                 sizes)

    if method_name in ("entropy", "MC-entropy", "BALD", "ensemble",
                       "QBC-JS"):
        cat = np.concatenate([_subject_scores(c, method_name)
                              for c in contexts])
        return global2local_inds(np.argsort(cat, kind="stable")[:k], sizes)

    if method_name == "ps-random":
        for c in contexts:
            if c.raw_volume is None:
                raise ValueError("ps-random needs the raw volume")
        valid = [high_variance_filter(c.raw_volume, _hv_patch(c.evaluator),
                                      c.hv_threshold, c.pool_inds,
                                      device=c.evaluator.device)
                 for c in contexts]
        vsizes = [len(v) for v in valid]
        local = global2local_inds(
            rng.permutation(int(np.sum(vsizes)))[:k], vsizes)
        return [valid[i][local[i]] for i in range(len(contexts))]

    if method_name == "rep-entropy":
        F, p1 = _concat_feats_posts(contexts)
        B = min(ref.B, len(p1))
        sel = binary_uncertainty_filter(p1, B)
        rest = np.setdiff1d(np.arange(len(p1)), sel)
        pick = (sel[:k] if len(rest) == 0 else
                sel[rep_entropy_from_features(F, rest, sel, min(k, B))])
        return global2local_inds(pick, sizes)

    if method_name == "BADGE":
        F, p1 = _concat_feats_posts(contexts)
        B = min(ref.B, len(p1))
        sel = binary_uncertainty_filter(p1, B)
        sel_t = _to_dev(sel, F.device)
        E = badge_embeddings(F[sel_t], torch.as_tensor(p1[sel]).to(F.device))
        chosen = badge_kmeanspp(
            E, min(k, len(sel)),
            core_rng.key_generator(ref.seed, _BADGE_FOLD, F.device))
        return global2local_inds(sel[chosen], sizes)

    if method_name == "BatchBALD":
        # one dropout-key chain shared by every subject (subject 0's), so
        # MC sample t is one weight draw everywhere and the joint MI sees
        # cross-subject redundancy (``strategies.py:687-706``)
        mc = torch.cat([mc_stack_posteriors(c.evaluator, c.params,
                                            c.pool_inds, c.MC_iters,
                                            ref.seed, as_device=True)
                        for c in contexts], dim=1)
        scores = bald_scores_bucketed(mc)
        B = min(ref.B, mc.shape[1])
        sel = np.argsort(-scores, kind="stable")[:B]
        chosen = batchbald_select(
            mc[:, _to_dev(sel, mc.device)], min(k, B),
            core_rng.key_generator(ref.seed, _BB_CFG_FOLD, mc.device))
        return global2local_inds(sel[chosen], sizes)

    if method_name == "core-set":
        return global2local_inds(_core_set_multimg(contexts, k), sizes)

    if method_name == "fi":
        return global2local_inds(_fi_multimg(contexts, k, rng), sizes)

    if method_name == "AU_4U":
        scores = np.concatenate([_au_4u_scores(c) for c in contexts])
        return global2local_inds(np.argsort(-scores, kind="stable")[:k],
                                 sizes)

    if method_name == "influence":
        return _influence_multimg(contexts, k)

    if method_name == "SuPix":
        return _supix_multimg(contexts, k)

    raise ValueError(method_name)


def _core_set_multimg(contexts, k: int) -> np.ndarray:
    """Greedy k-center over the concatenated pool features against every
    subject's labeled features (K1 once per subject with labels), or the
    held subjects' bootstrap features before any label exists
    (``strategies.py:709-747``).  The concatenated pool is zero-padded to
    a ``ROW_BUCKET`` multiple, the tile ``cross_max_similarities`` pads
    to, so ``sims0`` keeps one length; the pad rows get ``+inf``."""
    F_u = torch.cat([c.evaluator.evaluate(c.params, c.pool_inds,
                                          ("feature_layer",),
                                          as_device=True)["feature_layer"]
                     for c in contexts])
    n_u = F_u.shape[0]
    F_u, _ = pad_rows(F_u, ROW_BUCKET)
    dev = F_u.device
    sims0 = torch.full((F_u.shape[0],), float("-inf"), device=dev)
    any_labeled = False
    for c in contexts:
        if c.train_inds is not None and len(c.train_inds) > 0:
            F_t = c.evaluator.evaluate(
                c.params, pad_inds_repeat(c.train_inds, 256),
                ("feature_layer",), as_device=True)["feature_layer"]
            sims0 = torch.maximum(sims0, cross_max_similarities(
                F_u, F_t, tile=ROW_BUCKET, as_device=True, keep_pad=True))
            any_labeled = True
    bf = contexts[0].extra.get("bootstrap_features")
    if not any_labeled and bf is not None:
        sims0 = cross_max_similarities(F_u, torch.as_tensor(bf).to(dev),
                                       tile=ROW_BUCKET, as_device=True,
                                       keep_pad=True)
    valid = torch.arange(F_u.shape[0], device=dev) < n_u
    sims0 = torch.where(valid, sims0, torch.full_like(sims0, float("inf")))
    return core_set_select(normalize_rows(F_u), sims0, min(k, n_u))


def _fi_multimg(contexts, k: int, rng) -> np.ndarray:
    """fi across subjects (``strategies.py:749-828``): one global
    uncertainty filter to B, each subject's candidates padded to B and
    gathered (K2) into shrunk class gradients and A-matrices, one SDP over
    the concatenated A, PMF draws.  Returns global positions."""
    ref = contexts[0]
    if not hasattr(ref.evaluator, "padded"):
        return _fi_dense_multimg(contexts, k, rng)
    sizes = [len(c.pool_inds) for c in contexts]
    with subphase("fi/posteriors"):
        p1 = np.concatenate([_posteriors(c) for c in contexts])
    B = min(ref.B, len(p1))
    with subphase("fi/filter"):
        sel = binary_uncertainty_filter(p1, B)
    sel_local = global2local_inds(sel, sizes)
    A_list, order = [], []
    for si, c in enumerate(contexts):
        li = sel_local[si]
        if len(li) == 0:
            continue
        ev = c.evaluator
        nb = len(li)
        base = int(np.sum(sizes[:si]))
        # padded to the round-invariant B, as the JAX package does for
        # its compile cache; the pad rows are sliced off
        cand = np.zeros(B, np.int64)
        cand[:nb] = c.pool_inds[li]
        pv = np.zeros(B, np.float32)
        pv[:nb] = p1[base + li]
        with subphase("fi/gather_grads_A"):
            A_list.append(gather_shrunk_a_matrices(
                c.params, ev.padded, _to_dev(cand, ev.device), ev.mu, ev.sd,
                ev.patch_shape, ev.orig_shape,
                torch.as_tensor(pv).to(ev.device), ref.diag_load)[:nb])
        order.append(base + li)
    A = torch.cat(A_list)
    order = np.concatenate(order)
    X_pool = None
    if ref.lambda_ > 0:
        with subphase("fi/features"):
            F = np.concatenate([
                c.evaluator.evaluate(c.params, c.pool_inds[li],
                                     ("feature_layer",))["feature_layer"]
                for c, li in zip(contexts, sel_local) if len(li)])
        ref_F = refine_feature_matrix(F.T, len(order))
        X_pool = ref_F - ref_F.mean(axis=1, keepdims=True)
    with subphase("fi/sdp"):
        q = fi_query_distribution(A, ref.lambda_, X_pool, k)
    with subphase("fi/pmf"):
        draws = sample_query_pmf(q, k, rng, replacement=True)
    return order[draws]


def _fi_dense_multimg(contexts, k: int, rng) -> np.ndarray:
    """Dense (fcn) fi across subjects (``strategies.py:879-932``): each
    subject's sweep of posteriors and per-pixel features, one global
    uncertainty filter to B, hallucinated last-layer A-matrices per
    subject, one SDP over their concatenation and PMF draws.  ``lambda_``
    is not read, as in the JAX package.  Returns global positions."""
    ref = contexts[0]
    sizes = [len(c.pool_inds) for c in contexts]
    with subphase("fi/posteriors"):
        results = [c.evaluator.evaluate(c.params, c.pool_inds,
                                        ("posteriors", "feature_layer"),
                                        as_device=True)
                   for c in contexts]
        p1 = np.concatenate([r["posteriors"].cpu().numpy() for r in results])
    with subphase("fi/filter"):
        B = min(ref.B, len(p1))
        sel = binary_uncertainty_filter(p1 if p1.ndim == 1 else p1[:, 1], B)
    sel_local = global2local_inds(sel, sizes)
    A_list, order = [], []
    with subphase("fi/gather_grads_A"):
        for si, li in enumerate(sel_local):
            if len(li) == 0:
                continue
            base = int(np.sum(sizes[:si]))
            F = results[si]["feature_layer"]
            A_list.append(_dense_a_matrices(
                F[_to_dev(li, F.device)], torch.as_tensor(
                    np.asarray(p1[base + li], np.float32)).to(F.device),
                ref.diag_load))
            order.append(base + li)
    A = torch.cat(A_list)
    order = np.concatenate(order)
    with subphase("fi/sdp"):
        q = fi_query_distribution(A, ref.lambda_, None, k)
    with subphase("fi/pmf"):
        draws = sample_query_pmf(q, k, rng, replacement=True)
    return order[draws]


def _influence_multimg(contexts, k: int) -> List[np.ndarray]:
    """Influence across subjects (``strategies.py:934-1011``): one s_test
    from the union of every subject's labeled set (each subject's gather
    padded to a 64 multiple, the union with zero rows to a 256 multiple,
    weighted out), candidates from one global uncertainty filter, each
    subject's gathered (K2) and ranked by ``|<grad L(z), s_test>|`` at its
    pseudo-label ``p1 > 0.5``."""
    sizes = [len(c.pool_inds) for c in contexts]
    ref = contexts[0]
    for c in contexts:
        _require_patch_evaluator(c.evaluator, "influence")
    nclass = ref.spec.nclass
    with subphase("influence/labeled_gather"):
        xs, ys = [], []
        for c in contexts:
            if c.train_inds is None or len(c.train_inds) == 0:
                continue
            mask = c.extra.get("mask")
            if mask is None:
                raise ValueError("influence querying needs the label mask")
            ev = c.evaluator
            xs.append(_gather_padded(ev, c.train_inds, 64))
            ys.append(np.asarray(gather_labels(mask, c.train_inds,
                                               ev.orig_shape), np.int64))
        if not xs:
            raise ValueError("influence querying needs a labeled set")
        n_tr = int(sum(x.shape[0] for x in xs))
        pad = -n_tr % 256
        tr = torch.cat(xs + [xs[0].new_zeros((pad,) + tuple(xs[0].shape[1:]))])
        y = np.concatenate(ys + [np.zeros(pad, np.int64)])
        tr_y = torch.as_tensor(make_onehot(y, nclass)).to(tr.device)
    params = infl.param_dict(ref.params)
    with subphase("influence/s_test"):
        st = _s_test_dispatch(ref.extra, ref.params, params, tr, tr_y,
                              ref.extra.get("damping", 0.1), n_tr, ref.seed)
    with subphase("influence/posteriors"):
        p1 = np.concatenate([_posteriors(c) for c in contexts])
    B = min(ref.B, len(p1))
    with subphase("influence/filter"):
        sel = binary_uncertainty_filter(p1, B)
    sel_local = global2local_inds(sel, sizes)
    scores = np.zeros(len(p1))
    with subphase("influence/cand_scores"):
        for si, c in enumerate(contexts):
            li = sel_local[si]
            if len(li) == 0:
                continue
            cx = _gather_padded(c.evaluator, c.pool_inds[li], 64)
            base = int(np.sum(sizes[:si]))
            pseudo = (p1[base + li] > 0.5).astype(np.int64)
            cy = torch.as_tensor(make_onehot(pseudo, nclass)).to(cx.device)
            scores[base + li] = infl.influence_scores(ref.params, params, st,
                                                      cx, cy)
    order = np.argsort(-np.abs(scores[sel]), kind="stable")[:k]
    return global2local_inds(sel[order], sizes)


def _supix_multimg(contexts, k: int) -> List[np.ndarray]:
    """The k most uncertain superpixels over every subject (each subject's
    SLIC labels cached in its ``extra["overseg"]``), and every pool member
    of each as the subject's queries (``strategies.py:839-875``)."""
    oversegs, cand = [], []       # cand: (min uncertainty, subject, z, label)
    for si, c in enumerate(contexts):
        overseg = c.extra.get("overseg")
        if overseg is None:
            if c.raw_volume is None:
                raise ValueError("SuPix needs the raw volume")
            overseg = oversegment_volume(c.raw_volume,
                                         c.extra.get("n_segments", 64))
            c.extra["overseg"] = overseg
        unc = np.abs(_posteriors(c) - 0.5)
        sp = superpix_scores(overseg, c.pool_inds, unc)
        oversegs.append(overseg)
        for z, lab in np.argwhere(np.isfinite(sp)):
            cand.append((sp[z, lab], si, int(z), int(lab)))
    cand.sort()
    out = [np.zeros(0, np.int64) for _ in contexts]
    for _, si, z, lab in cand[:k]:
        overseg = oversegs[si]
        m2d = np.flatnonzero(overseg[:, :, z].ravel() == lab)
        wanted = expand_raveled_inds(m2d, z, 2, overseg.shape)
        pos = np.flatnonzero(np.isin(contexts[si].pool_inds, wanted))
        out[si] = np.union1d(out[si], pos).astype(np.int64)
    return out
