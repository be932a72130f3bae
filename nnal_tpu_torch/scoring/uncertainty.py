"""Uncertainty scores: entropy, binary margin, MC-dropout aggregates, BALD
(counterpart of ``nnal_tpu/scoring/uncertainty.py``).

The closed forms keep the JAX package's eps guards (1e-8 for entropy,
1e-6 for BALD) and its operation order, on whatever device the input
lives.  Means over the MC axis add the rows in order and divide by a
tensor, not a Python scalar: on the card torch turns a scalar divisor
into a reciprocal multiply, which rounds differently from the JAX
``sum / n``.

The JAX package pads score vectors to a 1024 bucket only to keep XLA's
compile cache small; eager torch needs no padding, and the padded rows
never reach a result there.  The scores agree with JAX's to an ulp or so
(``log`` differs by an ulp between XLA and torch), so their stable ranks
agree wherever two scores are further apart than that.

Convention: posteriors are row-major ``(n, c)``; binary shortcuts take
``p1 = P[:, 1]``.  "Most uncertain" is the smallest ``|p1 - 0.5|``
(binary) or the largest entropy (multi-class).
"""

from __future__ import annotations

import numpy as np
import torch

_EPS_ENT = 1e-8   # the reference's p == 0 guard (NNAL_tools.py:80)
_EPS_BALD = 1e-6  # the reference's BALD guard (PW_NNAL.py:264-268)


def _tensor(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32) \
        if not isinstance(x, torch.Tensor) else x


def _mean0(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean(x, axis=0)``: the sum over axis 0 in row order (XLA's
    order for this reduce; ``Tensor.sum`` may pair rows differently),
    divided by its length."""
    acc = x[0]
    for row in x[1:]:
        acc = acc + row
    return acc / x.new_full((), x.shape[0])


def shannon_entropy(posteriors) -> torch.Tensor:
    """Row-wise Shannon entropy of ``(n, c)`` posteriors."""
    P = _tensor(posteriors)
    p = torch.where(P == 0, P.new_full((), _EPS_ENT), P)
    return -(p * torch.log(p)).sum(-1)


def binary_uncertainty_scores(p1: torch.Tensor) -> torch.Tensor:
    """``|p - 0.5|`` — ascending order is most-uncertain-first."""
    return (p1 - 0.5).abs()


def binary_uncertainty_filter(p1, B: int) -> np.ndarray:
    """Indices of the ``B`` smallest ``|p1 - 0.5|``, ties broken by index
    order as the JAX package's ``top_k(-score)`` does.  A stable sort gives
    that order on every device (``torch.topk`` is not stable on CUDA)."""
    p1 = torch.as_tensor(p1, dtype=torch.float32)
    B = min(int(B), p1.shape[0])
    order = torch.sort(binary_uncertainty_scores(p1), stable=True).indices
    return order[:B].cpu().numpy()


def uncertainty_filter(posteriors, B: int) -> np.ndarray:
    """Indices of the ``B`` highest-entropy rows (reference
    ``uncertainty_filtering``), ties by index order as ``top_k``."""
    ent = shannon_entropy(posteriors)
    B = min(int(B), ent.shape[0])
    return torch.sort(-ent, stable=True).indices[:B].cpu().numpy()


def binary_entropy(p1) -> torch.Tensor:
    p1 = _tensor(p1)
    p = torch.clamp(p1, min=_EPS_BALD)
    q = torch.clamp(1.0 - p1, min=_EPS_BALD)
    return -p1 * torch.log(p) - (1.0 - p1) * torch.log(q)


def bald_from_mc(mc_p1) -> torch.Tensor:
    """BALD mutual information from MC-dropout binary posteriors
    ``(T, n)``: ``H(mean_t p) - mean_t H(p)``.  Descending order is
    most-informative-first."""
    mc = _tensor(mc_p1)
    return binary_entropy(_mean0(mc)) - _mean0(binary_entropy(mc))


def qbc_js_scores(committee_p1) -> torch.Tensor:
    """Query-by-committee disagreement over an ensemble's binary
    posteriors ``(E, n)``: BALD's decomposition across members."""
    return bald_from_mc(committee_p1)


def bald_scores_bucketed(mc_p1) -> np.ndarray:
    """BALD/QBC scores of a ``(T, n)`` MC or committee stack as a host
    array (the JAX name; see the module docstring for the bucket)."""
    return bald_from_mc(mc_p1).cpu().numpy()


def multiclass_bald_from_mc(mc_posts) -> torch.Tensor:
    """General BALD over ``(T, n, c)`` MC posteriors."""
    mc = _tensor(mc_posts)
    av_ent = _mean0(shannon_entropy(mc.reshape(-1, mc.shape[-1]))
                    .reshape(mc.shape[:2]))
    return shannon_entropy(_mean0(mc)) - av_ent


def running_average(new, avg, i: int):
    """The reference's MC accumulation ``(new + i*avg) / (i+1)``
    (PW_NNAL.py:82), kept so MC ranks match it.  Host arrays take numpy's
    f32 division; device tensors divide by a tensor (see the module
    docstring)."""
    if isinstance(new, torch.Tensor):
        return (new + i * avg) / new.new_full((), i + 1)
    return (new + i * avg) / (i + 1)
