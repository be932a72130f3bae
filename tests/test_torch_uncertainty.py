"""The uncertainty closed forms of the port vs the JAX package's, on the
same seeded numpy inputs (CPU): scores within atol 1e-6 (both are f32 with
the same eps guards; only ``log`` and summation may part by an ulp), and
the selections and stable ranks they give identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnal_tpu.scoring import uncertainty as ju
from nnal_tpu_torch.scoring import uncertainty as tu

torch.set_num_threads(1)

ATOL = 1e-6


def _mc(T=10, n=3000, seed=0, exact=True):
    """A ``(T, n)`` MC stack with exact 0, 1 and 0.5 entries (the eps
    guards) and ties (repeated columns)."""
    rng = np.random.default_rng(seed)
    mc = rng.uniform(0, 1, size=(T, n)).astype(np.float32)
    if exact:
        mc[:, :5] = 0.0
        mc[:, 5:10] = 1.0
        mc[:, 10:15] = 0.5
        mc[:, 20:40] = mc[:, 40:60]       # exactly tied columns
    return mc


def test_binary_entropy_and_bald_match_jax():
    mc = _mc()
    np.testing.assert_allclose(tu.binary_entropy(mc).numpy(),
                               np.asarray(ju.binary_entropy(mc)), atol=ATOL)
    want = np.asarray(ju.bald_from_mc(jnp.asarray(mc)))
    got = tu.bald_from_mc(mc).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(tu.qbc_js_scores(mc).numpy(),
                               np.asarray(ju.qbc_js_scores(mc)), atol=ATOL)


@pytest.mark.parametrize("n", [3000, 1024, 7])
def test_bald_scores_bucketed_scores_and_ranks(n):
    """The JAX call pads to a 1024 bucket, the port does not: the scores
    agree within atol and the stable descending ranks (BALD's and
    QBC-JS's selection) are the same.  Where two distinct scores lie
    within an ulp-level 2*atol of each other (6 of 3000 random columns
    here: ``log`` of XLA and of torch part by an ulp), the two orders may
    swap them, and only there; exact ties keep index order in both."""
    mc = _mc(n=max(n, 61))[:, :n]
    want = ju.bald_scores_bucketed(mc)
    got = tu.bald_scores_bucketed(torch.from_numpy(mc))
    assert got.shape == want.shape == (n,)
    np.testing.assert_allclose(got, want, atol=ATOL)
    og, ow = np.argsort(-got, kind="stable"), np.argsort(-want, kind="stable")
    swapped = np.nonzero(og != ow)[0]
    assert len(swapped) <= 0.01 * n
    assert np.all(np.abs(want[og[swapped]] - want[ow[swapped]]) <= 2 * ATOL)
    if n <= 1024:
        np.testing.assert_array_equal(og, ow)


def test_shannon_entropy_and_uncertainty_filter():
    rng = np.random.default_rng(1)
    P = rng.dirichlet(np.ones(4), size=2500).astype(np.float32)
    P[:3] = [1.0, 0.0, 0.0, 0.0]           # the p == 0 guard
    P[10:30] = P[30:50]                    # ties: index order
    np.testing.assert_allclose(tu.shannon_entropy(P).numpy(),
                               np.asarray(ju.shannon_entropy(P)), atol=ATOL)
    for B in (1, 200, 2500):
        np.testing.assert_array_equal(
            tu.uncertainty_filter(P, B), np.asarray(ju.uncertainty_filter(
                P, B)))


def test_multiclass_bald_matches_jax():
    rng = np.random.default_rng(2)
    mc = rng.dirichlet(np.ones(3), size=(6, 800)).astype(np.float32)
    np.testing.assert_allclose(
        tu.multiclass_bald_from_mc(mc).numpy(),
        np.asarray(ju.multiclass_bald_from_mc(jnp.asarray(mc))), atol=ATOL)


def test_running_average_is_the_reference_order():
    """The port's running average, on host arrays and on tensors, is
    bit-equal to the JAX package's (the reference's MC accumulation)."""
    mc = _mc(T=7, n=999, exact=False)
    want, got_np, got_t = 0.0, 0.0, 0.0
    for i in range(mc.shape[0]):
        want = ju.running_average(mc[i], want, i)
        got_np = tu.running_average(mc[i], got_np, i)
        got_t = tu.running_average(torch.from_numpy(mc[i]), got_t, i)
    np.testing.assert_array_equal(got_np, want)
    np.testing.assert_array_equal(got_t.numpy(), want)


def test_binary_uncertainty_filter_ties_by_index():
    p1 = np.array([0.5, 0.4, 0.6, 0.5, 0.9, 0.45, 0.55], np.float32)
    np.testing.assert_array_equal(
        tu.binary_uncertainty_filter(p1, 5),
        np.asarray(ju.binary_uncertainty_filter(p1, 5)))
