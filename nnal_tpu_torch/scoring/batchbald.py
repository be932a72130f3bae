"""BatchBALD — greedy joint mutual information over MC-dropout posteriors
(counterpart of ``nnal_tpu/scoring/batchbald.py``; Kirsch et al.,
NeurIPS 2019).

Plain BALD scores points one by one, so its top k are often near
duplicates; BatchBALD grows the batch greedily by the JOINT information
``I(y_1..y_k ; w)``.  Configurations of the chosen set are drawn
ancestrally: each of M configurations fixes one dropout sample
``t_m`` and draws every added point's class from ``p_{t_m}``; the joint
entropy of the chosen set plus candidate i is then the importance-sampled

    H(y_S, y_i) ~= -1/M sum_m sum_c J[m,i,c]/q_m * log J[m,i,c],
    J[m,i,c] = mean_t Pt[m,t] p_t(c|i),   q_m = mean_t Pt[m,t],

with ``Pt[m,t] = prod_{j in S} p_t(s_m_j)`` kept as running products and
renormalized every step (a constant factor shifts every candidate's
estimate alike).  At step 0 the estimate is exact, so the first pick is
the BALD argmax.  ``J`` for every candidate is one ``(M,T) x (T,n*C)``
product, a library GEMM as in JAX (no Pallas kernel there).  The loop runs
on the input's device with no host round trip until the picks are pulled.
Everything is f32 (``astype(f32)`` in JAX); argmax is first-max.

The draws go through one function each — :func:`_t_assign` (the
configurations' dropout samples), :func:`_uniform` (the binary class
draw) and ``core.rng.gumbel`` (the categorical draw, ``argmax(logits +
gumbel)`` as ``jax.random.categorical``) — each told the fold tag JAX
uses (0 for ``t_assign``, ``step + 1`` for the step's draw), so a test can
feed JAX's own draws.
"""

from __future__ import annotations

import numpy as np
import torch

from nnal_tpu_torch.core import rng as core_rng
from nnal_tpu_torch.scoring.uncertainty import _mean0

_LOG_TINY = 1e-30
# estimator noise is O(1/sqrt(M)) per step; one (M,T)x(T,n*C) GEMM a step
DEFAULT_M_CONFIGS = 1024
# MI-budget saturation guard (``batchbald.py:55-68``): once the mean
# normalized entropy of the Pt rows falls below this, the joint estimate
# is noise and the remaining picks follow the marginal BALD ranking
DEFAULT_COLLAPSE_THRESHOLD = 1e-3


def _t_assign(M: int, T: int, generator: torch.Generator, device,
              tag: int = 0) -> torch.Tensor:
    """Each configuration's dropout sample, uniform over ``[0, T)``."""
    return torch.randint(0, T, (M,), generator=generator, device=device)


def _uniform(M: int, generator: torch.Generator, device,
             tag: int) -> torch.Tensor:
    """``M`` f32 uniforms for the binary class draw of step ``tag - 1``."""
    return torch.rand((M,), generator=generator, device=device,
                      dtype=torch.float32)


def _greedy_joint_mi(probs: torch.Tensor, k: int, generator, M: int, draw,
                     collapse_threshold: float = DEFAULT_COLLAPSE_THRESHOLD
                     ) -> np.ndarray:
    """The greedy loop over ``(T, n, C)`` MC posteriors; ``draw(step,
    t_assign, nxt) -> (M,)`` class indices is the ancestral draw."""
    T, n, C = probs.shape
    dev = probs.device
    tiny = probs.new_full((), _LOG_TINY)

    def mean(x, dim):
        return x.sum(dim) / x.new_full((), x.shape[dim])

    # E_t[H(y_i | w_t)], constant across steps
    cond = -_mean0((probs * torch.log(probs)).sum(-1))
    # marginal BALD: the exact step-0 objective and the saturation fallback
    pbar = _mean0(probs)
    marginal = -(pbar * torch.log(torch.maximum(pbar, tiny))).sum(-1) - cond

    t_assign = _t_assign(M, T, generator, dev, 0)
    Pt = torch.ones((M, T), dtype=torch.float32, device=dev)
    taken = torch.zeros((n,), dtype=torch.bool, device=dev)
    joint_ok = torch.ones((), dtype=torch.bool, device=dev)
    logT = torch.log(torch.tensor(float(T), dtype=torch.float32)).to(dev)
    neg_inf = probs.new_full((), float("-inf"))
    flat = probs.reshape(T, n * C)
    chosen = []
    for step in range(int(k)):
        Wn = Pt / torch.maximum(Pt.sum(1, keepdim=True), tiny)
        hbar = mean(-(Wn * torch.log(torch.maximum(Wn, tiny))).sum(1),
                    0) / logT
        joint_ok = joint_ok & (hbar > collapse_threshold)
        J = (Pt @ flat).reshape(M, n, C) / Pt.new_full((), T)
        q = mean(Pt, 1)
        w = 1.0 / (M * torch.maximum(q, tiny))
        Hj = -(w[:, None, None] * J
               * torch.log(torch.maximum(J, tiny))).sum((0, 2))
        scores = torch.where(joint_ok, Hj - cond, marginal)
        scores = torch.where(taken, neg_inf, scores)
        nxt = torch.argmax(scores)
        cls = draw(step, t_assign, nxt)                          # (M,)
        Pt = Pt * probs[:, nxt, :][:, cls].T                      # (M, T)
        Pt = Pt / torch.maximum(Pt.sum() / Pt.new_full((), Pt.numel()),
                                tiny)
        taken[nxt] = True
        chosen.append(nxt)
    if not chosen:
        return np.zeros(0, np.int64)
    return torch.stack(chosen).cpu().numpy()


@torch.no_grad()
def batchbald_select(mc_p1, k: int, generator: torch.Generator,
                     m_configs: int = DEFAULT_M_CONFIGS,
                     collapse_threshold: float = DEFAULT_COLLAPSE_THRESHOLD
                     ) -> np.ndarray:
    """Greedy BatchBALD batch over ``(T, n)`` binary MC posteriors: ``k``
    distinct candidate positions, most informative first.  ``generator``
    (on the posteriors' device) drives the configuration sampling."""
    p1 = torch.clamp(torch.as_tensor(mc_p1).float(), 1e-6, 1.0 - 1e-6)
    probs = torch.stack([1.0 - p1, p1], dim=-1)                   # (T, n, 2)

    def draw(step, t_assign, nxt):
        u = _uniform(t_assign.shape[0], generator, probs.device, step + 1)
        return (u < probs[t_assign, nxt, 1]).long()

    return _greedy_joint_mi(probs, k, generator, m_configs, draw,
                            collapse_threshold)


@torch.no_grad()
def batchbald_select_probs(mc_probs, k: int, generator: torch.Generator,
                           m_configs: int = DEFAULT_M_CONFIGS,
                           collapse_threshold: float =
                           DEFAULT_COLLAPSE_THRESHOLD) -> np.ndarray:
    """Greedy BatchBALD over ``(T, n, C)`` multiclass MC posteriors, with
    categorical class draws from ``p_{t_m}(y_nxt)``."""
    probs = torch.clamp(torch.as_tensor(mc_probs).float(), 1e-6, 1.0)
    probs = probs / probs.sum(-1, keepdim=True)

    def draw(step, t_assign, nxt):
        logits = torch.log(probs[t_assign, nxt, :])                # (M, C)
        g = core_rng.gumbel(tuple(logits.shape), generator, probs.device,
                            step + 1)
        return torch.argmax(g + logits, dim=-1)

    return _greedy_joint_mi(probs, k, generator, m_configs, draw,
                            collapse_threshold)
