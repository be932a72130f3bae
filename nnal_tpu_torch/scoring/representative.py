"""Core-set selection (counterpart of the core-set part of
``nnal_tpu/scoring/representative.py``).

Greedy k-center over cosine similarity (reference PW_NNAL.py:353-451):
track each pool sample's max similarity to the labeled set — kernel K1 on
the card (``ops/similarity.py``), for every CUDA input whatever its size —
then repeatedly query the argmin and raise the similarities with the new
query's row.  bf16 features (``model.dtype: bfloat16``) are normalized in
bf16 and their similarities accumulate in f32, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

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
