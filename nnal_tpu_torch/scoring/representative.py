"""Representativeness and diversity selection: core-set, rep-entropy and
BADGE (counterpart of ``nnal_tpu/scoring/representative.py``).

* core-set: greedy k-center over cosine similarity (reference
  PW_NNAL.py:353-451): track each pool sample's max similarity to the
  labeled set — kernel K1 on the card (``ops/similarity.py``), for every
  CUDA input whatever its size — then repeatedly query the argmin and
  raise the similarities with the new query's row;
* rep-entropy (PW_NNAL.py:284-351): the (rest of the pool x B candidates)
  cosine similarities, one GEMM (``jnp.dot`` in JAX too, no Pallas
  kernel), then greedily the candidate maximizing ``sum max(best,
  sims[:, j])``;
* BADGE (Ash et al., ICLR 2020): k-means++ seeding over hallucinated
  last-layer gradient embeddings, in f32.  ``jax.random.categorical`` is
  ``argmax(logits + gumbel)``; the port draws its Gumbel noise and its
  first index through ``core.rng.gumbel`` and :func:`_first_index`, so a
  test can feed JAX's draws.

bf16 features (``model.dtype: bfloat16``) are normalized in bf16 and
their similarities accumulate in f32, as in the JAX package.  The greedy
loops stay on the device; the picks are pulled once at the end.  The JAX
package pads rows to buckets only for XLA's compile cache; its zero rows
add the same exact 0 to every rep-entropy candidate, so the port drops
them.
"""

from __future__ import annotations

import numpy as np
import torch

from nnal_tpu_torch.core import rng as core_rng
from nnal_tpu_torch.ops.similarity import max_similarity, normalize_rows  # noqa: F401

# leading-dim bucket the JAX package pads pools to; kept so both packages
# see the same padded rows (and the core-set argmin the same candidates)
ROW_BUCKET = 4096


def pad_rows(F: torch.Tensor, mult: int = ROW_BUCKET, fill: float = 0.0):
    """Pad the leading dim to a multiple of ``mult`` with ``fill`` rows.
    Returns ``(padded, n)``."""
    n = F.shape[0]
    pad = -n % mult
    if pad == 0:
        return F, n
    return torch.cat([F, F.new_full((pad,) + tuple(F.shape[1:]), fill)]), n


def pad_inds_repeat(inds, mult: int) -> np.ndarray:
    """Pad a host index array to a multiple of ``mult`` by repeating its
    first entry (duplicates are no-ops under a max, or masked by the
    caller)."""
    inds = np.asarray(inds)
    pad = -len(inds) % mult
    if pad == 0:
        return inds
    return np.concatenate([inds, np.full(pad, inds[0], inds.dtype)])


def pad_rows_repeat(F: torch.Tensor, mult: int = ROW_BUCKET) -> torch.Tensor:
    """Pad the leading dim to a multiple of ``mult`` by repeating row 0 —
    the exact pad for the reduced-over side of a max."""
    pad = -F.shape[0] % mult
    if pad == 0:
        return F
    return torch.cat([F, F[:1].expand((pad,) + tuple(F.shape[1:]))])


def cross_max_similarities(F1, F2, tile: int = 4096,
                           as_device: bool = False, keep_pad: bool = False):
    """Per-row-of-``F1`` max cosine similarity to ``F2`` (reference
    ``get_cross_sims``, PW_NNAL.py:1105-1136).  Zero rows give 0.  ``F1``
    is zero-padded to a ``tile`` multiple and ``F2`` repeat-padded to a
    multiple of 256 as in the JAX package; with ``keep_pad`` the result
    keeps ``F1``'s padded length.  ``as_device`` returns a tensor."""
    F1, n1 = pad_rows(F1, tile)
    F2 = pad_rows_repeat(F2, 256)
    sims = max_similarity(F1, F2)
    sims = sims if keep_pad else sims[:n1]
    return sims if as_device else sims.cpu().numpy()


@torch.no_grad()
def core_set_select(Fu_normed: torch.Tensor, sims0: torch.Tensor,
                    k: int) -> np.ndarray:
    """Greedy k-center (reference PW_NNAL.py:416-447): ``k`` steps of
    ``q = argmin(sims)`` (the first minimum, as ``jnp.argmin``), then
    ``sims = max(sims, Fu @ Fu[q])`` and ``sims[q] = +inf``.  Everything
    stays on the device; the picks are pulled once at the end.  bf16 rows
    are upcast once: their products are exact in f32, so each step is the
    JAX ``preferred_element_type=f32`` dot."""
    Fu_normed = Fu_normed.float()
    sims = sims0.clone()
    chosen = []
    for _ in range(int(k)):
        q = torch.argmin(sims)
        sims = torch.maximum(sims, torch.mv(Fu_normed, Fu_normed[q]))
        sims[q] = float("inf")
        chosen.append(q)
    if not chosen:
        return np.zeros(0, np.int64)
    return torch.stack(chosen).cpu().numpy()


def cosine_similarity(F1: torch.Tensor, F2: torch.Tensor) -> torch.Tensor:
    """(n1, n2) cosine similarities with f32 accumulation; zero rows give
    0, not NaN (the norm is clamped at 1e-12)."""
    return normalize_rows(F1).float() @ normalize_rows(F2).float().T


def self_max_similarities(F, tile: int = 4096) -> np.ndarray:
    """Per-sample max cosine similarity to the REST of the set (reference
    ``get_self_sims``, PW_NNAL.py:1041-1103), in row tiles."""
    F = torch.as_tensor(F)
    n = F.shape[0]
    out = []
    for lo in range(0, n, tile):
        sims = cosine_similarity(F[lo:lo + tile], F)
        rows = torch.arange(sims.shape[0], device=sims.device)
        sims[rows, rows + lo] = float("-inf")
        out.append(sims.amax(1))
    return torch.cat(out).cpu().numpy()


@torch.no_grad()
def rep_entropy_select(sims: torch.Tensor, k: int) -> np.ndarray:
    """Greedy max-representativeness over candidate columns (reference
    PW_NNAL.py:330-349): ``sims`` (n_rest, B); each step adds the
    unchosen candidate j with the largest ``sum max(best, sims[:, j])``
    (first max) and raises ``best`` to its column.  Returns k positions
    into the columns.  The column sums accumulate in f64 (the terms are
    exact f32 values): late in the greedy two candidates' f32 sums can
    lie within an ulp (5.6e-5 apart at 780 on 824 PW1 rows), where the
    pick would hang on the device's reduction order; in f64 it does not.
    JAX sums in f32 (``representative.py:179``)."""
    best = sims.new_full((sims.shape[0],), float("-inf"))
    taken = torch.zeros(sims.shape[1], dtype=torch.bool, device=sims.device)
    neg_inf = sims.new_full((), float("-inf"), dtype=torch.float64)
    chosen = []
    for _ in range(int(k)):
        scores = torch.maximum(best[:, None], sims).sum(
            0, dtype=torch.float64)
        j = torch.argmax(torch.where(taken, neg_inf, scores))
        best = torch.maximum(best, sims[:, j])
        taken[j] = True
        chosen.append(j)
    if not chosen:
        return np.zeros(0, np.int64)
    return torch.stack(chosen).cpu().numpy()


def rep_entropy_from_features(F: torch.Tensor, rest, sel, k: int
                              ) -> np.ndarray:
    """rep-entropy from a feature matrix: the similarities of the
    non-candidate rows ``rest`` to the candidates ``sel`` (host index
    arrays), then the greedy.  Returns positions into ``sel``.  The rest
    rows are normalized in f32 and the candidates in ``F``'s dtype: in
    JAX the rest rows pass through an f32 validity mask first
    (``representative.py:158-162``), which promotes bf16 features."""
    F = torch.as_tensor(F)
    dev = F.device
    rest_t = torch.as_tensor(np.asarray(rest, np.int64)).to(dev)
    sel_t = torch.as_tensor(np.asarray(sel, np.int64)).to(dev)
    return rep_entropy_select(
        cosine_similarity(F[rest_t].float(), F[sel_t]), k)


def badge_embeddings_multiclass(H: torch.Tensor, P: torch.Tensor
                                ) -> torch.Tensor:
    """(n, C*d) BADGE embeddings ``(p_i - onehot(argmax p_i)) (x) h_i``:
    the last-layer weight gradient of CE at the hallucinated label."""
    P = P.float()
    c = P - torch.nn.functional.one_hot(torch.argmax(P, 1),
                                        P.shape[1]).to(P.dtype)
    H = H.float()
    return (c[:, :, None] * H[:, None, :]).reshape(H.shape[0], -1)


def badge_embeddings(H: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """Binary shortcut: (n, 2d) embeddings from P(class 1) ``p1``."""
    p1 = p1.float()
    return badge_embeddings_multiclass(H, torch.stack([1.0 - p1, p1], 1))


def _first_index(n: int, generator: torch.Generator, device) -> torch.Tensor:
    """k-means++'s first center, uniform over ``[0, n)``
    (``jax.random.randint(key, (), 0, n)``)."""
    return torch.randint(0, n, (), generator=generator, device=device)


@torch.no_grad()
def badge_kmeanspp(E: torch.Tensor, k: int, generator: torch.Generator
                   ) -> np.ndarray:
    """k-means++ seeding over embedding rows: the first center uniform,
    each next drawn with probability proportional to its squared distance
    to the chosen set (``categorical`` over ``log d2``).  Chosen rows get
    distance 0 and cannot be drawn again; when every unchosen row
    coincides with a chosen one, the first unchosen row is taken."""
    E = E.float()
    n = E.shape[0]
    dev = E.device
    sq = (E * E).sum(1)
    zero = E.new_zeros(())
    neg_inf = E.new_full((), float("-inf"))

    def dist2(i):
        return torch.maximum(sq + sq[i] - 2.0 * (E @ E[i]), zero)

    first = _first_index(n, generator, dev)
    mind2 = dist2(first)
    mind2[first] = 0.0
    taken = torch.zeros(n, dtype=torch.bool, device=dev)
    taken[first] = True
    chosen = [first]
    for i in range(1, int(k)):
        avail = ~taken
        ok = avail & (mind2 > 0.0)
        logits = torch.where(ok, torch.log(torch.clamp(mind2, min=1e-30)),
                             neg_inf)
        drawn = torch.argmax(core_rng.gumbel((n,), generator, dev, i)
                             + logits)
        nxt = torch.where(ok.any(), drawn, torch.argmax(avail.to(torch.uint8)))
        mind2 = torch.minimum(mind2, dist2(nxt))
        mind2[nxt] = 0.0
        taken[nxt] = True
        chosen.append(nxt)
    return torch.stack(chosen[:max(int(k), 0)]).cpu().numpy() if k > 0 \
        else np.zeros(0, np.int64)
