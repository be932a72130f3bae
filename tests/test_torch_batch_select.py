"""BatchBALD, rep-entropy and BADGE in the port vs the JAX package (CPU).

The selections are held to identical picks: with JAX's own draws fed
through the port's draw functions (``tests/torch_jax_draws``) where the
method samples, and as they are where it does not.  Embeddings and
similarities within atol 1e-6 (f32 both sides)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnal_tpu.scoring import batchbald as jbb
from nnal_tpu.scoring import representative as jrep
from nnal_tpu.scoring.uncertainty import bald_from_mc
from nnal_tpu_torch.scoring import batchbald as tbb
from nnal_tpu_torch.scoring import representative as trep
from torch_jax_draws import KeyGen, inject

torch.set_num_threads(1)


def exact_greedy_batchbald(mc_p1: np.ndarray, k: int) -> list:
    """Oracle (copied from ``tests/test_batchbald.py``): greedy BatchBALD
    with the 2^m configurations ENUMERATED exactly (feasible for tiny
    k)."""
    mc_p1 = np.clip(mc_p1.astype(np.float64), 1e-6, 1 - 1e-6)
    T, n = mc_p1.shape
    probs = np.stack([1 - mc_p1, mc_p1], axis=-1)          # (T, n, 2)
    cond = -(probs * np.log(probs)).sum(-1).mean(0)        # (n,)
    S: list = []
    Pt = np.ones((1, T))                                   # (2^m, T)
    for _ in range(k):
        J = np.einsum("st,tnc->snc", Pt, probs) / T
        Hj = -(J * np.log(np.maximum(J, 1e-300))).sum(axis=(0, 2))
        scores = Hj - cond
        scores[S] = -np.inf
        nxt = int(np.argmax(scores))
        S.append(nxt)
        Pt = np.concatenate([Pt * probs[:, nxt, 0],
                             Pt * probs[:, nxt, 1]])
    return S


def _stack(T=10, n=200, seed=0):
    return np.random.default_rng(seed).uniform(
        0.02, 0.98, size=(T, n)).astype(np.float32)


@pytest.mark.parametrize("k,m", [(16, 1024), (40, 256)])
def test_batchbald_select_with_jax_draws(monkeypatch, k, m):
    """T 10 x 200 candidates, the JAX package's ``t_assign`` and per-step
    uniforms: the same k picks in the same order."""
    inject(monkeypatch)
    mc = _stack()
    key = jax.random.key(3)
    want = np.asarray(jbb.batchbald_select(jnp.asarray(mc), k, key,
                                           m_configs=m))
    got = tbb.batchbald_select(torch.from_numpy(mc), k, KeyGen(key),
                               m_configs=m)
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) == k


def test_batchbald_saturation_fallback_with_jax_draws(monkeypatch):
    """T 4: the joint estimate saturates (log T is spent) and the tail
    follows the marginal BALD ranking, as in JAX."""
    inject(monkeypatch)
    mc = _stack(T=4, n=120, seed=5)
    key = jax.random.key(4)
    want = np.asarray(jbb.batchbald_select(jnp.asarray(mc), 60, key,
                                           m_configs=128))
    got = tbb.batchbald_select(torch.from_numpy(mc), 60, KeyGen(key),
                               m_configs=128)
    np.testing.assert_array_equal(got, want)


def test_batchbald_select_probs_with_jax_draws(monkeypatch):
    """Multiclass: categorical class draws as argmax(logits + gumbel)."""
    inject(monkeypatch)
    rng = np.random.default_rng(6)
    mc = rng.dirichlet(np.ones(3), size=(8, 150)).astype(np.float32)
    key = jax.random.key(5)
    want = np.asarray(jbb.batchbald_select_probs(jnp.asarray(mc), 12, key,
                                                 m_configs=512))
    got = tbb.batchbald_select_probs(torch.from_numpy(mc), 12, KeyGen(key),
                                     m_configs=512)
    np.testing.assert_array_equal(got, want)


def test_batchbald_first_pick_is_bald_argmax():
    mc = _stack(T=6, n=40)
    bald = np.asarray(bald_from_mc(jnp.asarray(mc)))
    for m in (8, 128):
        got = tbb.batchbald_select(torch.from_numpy(mc), 4,
                                   torch.Generator().manual_seed(1),
                                   m_configs=m)
        assert got[0] == int(np.argmax(bald))


def test_batchbald_matches_exact_greedy_small():
    """With the port's own draws: the exact-enumeration greedy on a small
    instance with clear score gaps (``tests/test_batchbald.py``)."""
    mc = np.random.default_rng(3).uniform(0.05, 0.95,
                                          size=(5, 12)).astype(np.float32)
    want = exact_greedy_batchbald(mc, 3)
    got = tbb.batchbald_select(torch.from_numpy(mc), 3,
                               torch.Generator().manual_seed(0),
                               m_configs=4096)
    assert got.tolist() == want


def _features(n, d=96, seed=0, zero_rows=()):
    F = np.maximum(np.random.default_rng(seed).normal(size=(n, d)),
                   0).astype(np.float32)
    F[list(zero_rows)] = 0.0
    return F


def test_cosine_and_self_max_similarities_match_jax():
    F = _features(300, zero_rows=(3, 7))
    np.testing.assert_allclose(
        trep.cosine_similarity(torch.from_numpy(F[:50]),
                               torch.from_numpy(F)).numpy(),
        np.asarray(jrep.cosine_similarity(F[:50], F)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(trep.self_max_similarities(F, tile=128),
                               jrep.self_max_similarities(F, tile=128),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", [1, 16, 40])
def test_rep_entropy_select_matches_jax(k):
    F = _features(500, zero_rows=(10, 11, 400))
    sel = np.random.default_rng(1).choice(500, 40, replace=False)
    rest = np.setdiff1d(np.arange(500), sel)
    sims = np.array(jrep.cosine_similarity(F[rest], F[sel]))
    np.testing.assert_array_equal(
        trep.rep_entropy_select(torch.from_numpy(sims), k),
        np.asarray(jrep.rep_entropy_select(jnp.asarray(sims), k)))
    # from features: the JAX package pads the rest rows with zero rows,
    # the port does not (rank-neutral)
    np.testing.assert_array_equal(
        trep.rep_entropy_from_features(torch.from_numpy(F), rest, sel, k),
        jrep.rep_entropy_from_features(F, rest, sel, k))


def test_badge_embeddings_match_jax():
    H = _features(200, d=64, seed=2)
    p1 = np.random.default_rng(3).uniform(size=200).astype(np.float32)
    p1[:3] = [0.5, 0.0, 1.0]
    np.testing.assert_allclose(
        trep.badge_embeddings(torch.from_numpy(H),
                              torch.from_numpy(p1)).numpy(),
        np.asarray(jrep.badge_embeddings(H, p1)), rtol=0, atol=1e-6)
    P = np.random.default_rng(4).dirichlet(np.ones(3),
                                           size=200).astype(np.float32)
    np.testing.assert_allclose(
        trep.badge_embeddings_multiclass(torch.from_numpy(H),
                                         torch.from_numpy(P)).numpy(),
        np.asarray(jrep.badge_embeddings_multiclass(H, P)), rtol=0,
        atol=1e-6)


@pytest.mark.parametrize("dup", [False, True])
def test_badge_kmeanspp_with_jax_draws(monkeypatch, dup):
    """The JAX package's first index and Gumbel draws: the same picks.
    ``dup``: 10 distinct small-integer rows repeated (their squared
    distances are exact, so duplicates are at exactly 0 in both), so the
    draws run out of positive distances and both take the first unchosen
    row."""
    inject(monkeypatch)
    H = _features(200, d=64, seed=5)
    p1 = np.random.default_rng(6).uniform(size=200).astype(np.float32)
    E = np.array(jrep.badge_embeddings(H, p1))
    if dup:
        E = np.tile(np.random.default_rng(8).integers(
            -3, 4, size=(10, 64)).astype(np.float32), (20, 1))
    key = jax.random.key(7)
    want = np.asarray(jrep.badge_kmeanspp(jnp.asarray(E), 24, key))
    got = trep.badge_kmeanspp(torch.from_numpy(E), 24, KeyGen(key))
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) == 24
