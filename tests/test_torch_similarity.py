"""K1's plain version and the port's core-set vs the JAX package.

Tolerances: the Pallas oracle's own (``test_pallas_ops.py``: rtol 1e-5,
atol 1e-6) — both sides are f32 dot products of unit vectors, differing
only in summation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnal_tpu.ops.similarity_pallas import max_similarity_pallas
from nnal_tpu.scoring import representative as jrep
from nnal_tpu_torch.ops import similarity as k1
from nnal_tpu_torch.scoring import representative as trep

torch.set_num_threads(1)


def _unit(a):
    return a / np.linalg.norm(a, axis=1, keepdims=True)


def test_plain_rowmax_matches_pallas_interpret():
    rng = np.random.default_rng(0)
    pool_n = _unit(rng.normal(size=(700, 64))).astype(np.float32)
    ref_n = _unit(rng.normal(size=(300, 64))).astype(np.float32)
    want = np.asarray(max_similarity_pallas(jnp.asarray(pool_n),
                                            jnp.asarray(ref_n),
                                            interpret=True))
    got = k1.rowmax_similarity(torch.from_numpy(pool_n),
                               torch.from_numpy(ref_n)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_plain_rowmax_padding_never_wins():
    pool_n = np.tile(np.array([[1.0, 0.0]], np.float32), (600, 1))
    ref_n = np.tile(np.array([[-1.0, 0.0]], np.float32), (5, 1))
    want = np.asarray(max_similarity_pallas(jnp.asarray(pool_n),
                                            jnp.asarray(ref_n),
                                            interpret=True))
    got = k1.rowmax_similarity(torch.from_numpy(pool_n),
                               torch.from_numpy(ref_n)).numpy()
    np.testing.assert_allclose(want, -1.0, atol=1e-6)
    np.testing.assert_allclose(got, -1.0, atol=1e-6)


@pytest.mark.parametrize("keep_pad", [False, True])
@pytest.mark.parametrize("as_device", [False, True])
def test_cross_max_similarities_matches_jax(keep_pad, as_device):
    rng = np.random.default_rng(1)
    F1 = np.maximum(rng.normal(size=(300, 48)), 0).astype(np.float32)
    F2 = np.maximum(rng.normal(size=(70, 48)), 0).astype(np.float32)
    F1[::9] = 0.0          # zero rows: the 1e-12 clamp gives 0, not NaN
    F2[3] = 0.0
    want = np.asarray(jrep.cross_max_similarities(
        jnp.asarray(F1), jnp.asarray(F2), tile=128, keep_pad=keep_pad))
    got = trep.cross_max_similarities(torch.from_numpy(F1),
                                      torch.from_numpy(F2), tile=128,
                                      as_device=as_device, keep_pad=keep_pad)
    if as_device:
        assert isinstance(got, torch.Tensor)
        got = got.numpy()
    assert got.shape == want.shape == ((384,) if keep_pad else (300,))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[:300:9], 0.0)


def test_max_similarity_zero_rows_give_zero():
    P = torch.zeros(4, 8)
    P[1, 2] = 3.0
    R = torch.eye(8)[:3]
    got = k1.max_similarity(P, R)
    assert torch.equal(got, torch.tensor([0.0, 1.0, 0.0, 0.0]))


def test_normalize_rows_matches_jax():
    F = np.random.default_rng(2).normal(size=(20, 16)).astype(np.float32)
    F[4] = 0.0
    np.testing.assert_allclose(
        trep.normalize_rows(torch.from_numpy(F)).numpy(),
        np.asarray(jrep.normalize_rows(jnp.asarray(F))), rtol=1e-6,
        atol=1e-7)


@pytest.mark.parametrize("with_labeled", [True, False])
def test_core_set_select_identical_picks(with_labeled):
    rng = np.random.default_rng(3)
    Fu = np.maximum(rng.normal(size=(512, 32)), 0).astype(np.float32)
    Ft = np.maximum(rng.normal(size=(40, 32)), 0).astype(np.float32)
    Fu_n = np.array(jrep.normalize_rows(jnp.asarray(Fu)))
    if with_labeled:
        s0 = np.array(jrep.cross_max_similarities(
            jnp.asarray(Fu), jnp.asarray(Ft), tile=128))
    else:
        s0 = np.full(512, -np.inf, np.float32)
    s0[500:] = np.inf                      # padded rows are never picked
    want = np.asarray(jrep.core_set_select(jnp.asarray(Fu_n),
                                           jnp.asarray(s0), 12))
    got = trep.core_set_select(torch.from_numpy(Fu_n), torch.from_numpy(s0),
                               12)
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) == 12 and got.max() < 500


def test_wrapper_checks():
    P = torch.ones(3, 4)
    with pytest.raises(ValueError, match="no rows"):
        k1.rowmax_similarity(P, torch.ones(0, 4))
    with pytest.raises(TypeError, match="float32"):
        k1.rowmax_similarity(P.double(), P.double())
    with pytest.raises(ValueError, match=r"\(n, d\)"):
        k1.rowmax_similarity(P, torch.ones(3, 5))
    with pytest.raises(ValueError, match="unsupported device"):
        k1.rowmax_similarity(P.to("meta"), P.to("meta"))
    before = k1.KERNEL.launches
    k1.rowmax_similarity(P, P)
    assert k1.KERNEL.launches == before


def test_pad_helpers_match_jax():
    inds = np.arange(5, 15)
    np.testing.assert_array_equal(trep.pad_inds_repeat(inds, 8),
                                  jrep.pad_inds_repeat(inds, 8))
    F = np.random.default_rng(4).normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        trep.pad_rows_repeat(torch.from_numpy(F), 4).numpy(),
        np.asarray(jrep.pad_rows_repeat(jnp.asarray(F), 4)))
    p, n = trep.pad_rows(torch.from_numpy(F), 4)
    pj, nj = jrep.pad_rows(jnp.asarray(F), 4)
    assert n == nj == 5
    np.testing.assert_array_equal(p.numpy(), np.asarray(pj))


# --- K1's split-precision TF32 arithmetic (the kernel's main path), fixed
# here before the card sees it.  Error budget: each product loses at most
# ~2^-21 |a_i||b_i| (lo rounded to TF32, lo.lo' dropped), so a dot of unit
# rows is within 1e-6 of the truth; against the Pallas kernel the oracle's
# own rtol 1e-5 / atol 1e-6 holds.

@pytest.mark.parametrize("x, want", [
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),            # tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),            # just below the tie
    (1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -9),         # odd tie: away too
    (0.0, 0.0),
])
def test_round_tf32_is_round_to_nearest_away(x, want):
    got = k1.round_tf32(torch.tensor([x], dtype=torch.float32))
    assert got.item() == np.float32(want)
    assert int(got.view(torch.int32).item()) & 0x1FFF == 0


def _boundary_rows(rng, n, d):
    """Entries +-2^-5 (1 + k 2^-10 + 2^-11 + delta), delta in
    {-1, 0, 1} ulp: each straddles a TF32 rounding boundary; rows are
    within 1e-2 of unit norm at d = 1024."""
    k = rng.integers(0, 4, size=(n, d))
    delta = rng.integers(-1, 2, size=(n, d)) * 2.0 ** -23
    sign = rng.choice([-1.0, 1.0], size=(n, d))
    return (sign * 2.0 ** -5 * (1 + k * 2.0 ** -10 + 2.0 ** -11 + delta)
            ).astype(np.float32)


def _k1_case(name):
    rng = np.random.default_rng(11)
    if name == "random":
        return (_unit(rng.normal(size=(200, 256))).astype(np.float32),
                _unit(rng.normal(size=(70, 256))).astype(np.float32))
    if name == "equal_entries":          # one row of 1/sqrt(d), d = 4096
        P = np.full((1, 4096), 1 / 64, np.float32)
        R = _unit(rng.normal(size=(40, 4096))).astype(np.float32)
        return P, np.concatenate([R, P])
    if name == "tf32_boundary":
        P = _boundary_rows(rng, 64, 1024)
        return P, np.concatenate([_boundary_rows(rng, 30, 1024), P[:3]])
    # mixed magnitudes: entries of size 1e-3 and 1 in one row
    mag = np.where(rng.random((96, 512)) < 0.5, 1e-3, 1.0)
    F = _unit(mag * rng.choice([-1.0, 1.0], size=(96, 512)))
    return F[:64].astype(np.float32), F[40:].astype(np.float32)


@pytest.mark.parametrize("case", ["random", "equal_entries",
                                  "tf32_boundary", "mixed_magnitude"])
def test_3xtf32_emulation_error_budget(case):
    P, R = _k1_case(case)
    emu = k1.rowmax_similarity_3xtf32(torch.from_numpy(P),
                                      torch.from_numpy(R)).numpy()
    truth = (P.astype(np.float64) @ R.astype(np.float64).T).max(axis=1)
    np.testing.assert_allclose(emu, truth, rtol=0, atol=1e-6)
    want = np.asarray(max_similarity_pallas(jnp.asarray(P), jnp.asarray(R),
                                            interpret=True))
    np.testing.assert_allclose(emu, want, rtol=1e-5, atol=1e-6)
    # the plain version (the CPU path) agrees as well
    plain = k1.rowmax_similarity(torch.from_numpy(P),
                                 torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(emu, plain, rtol=1e-5, atol=1e-6)
    if case == "equal_entries":
        assert emu[0] == 1.0             # hi = 1/64 exactly, lo = 0


def test_3xtf32_needs_the_correction_terms():
    """Plain TF32 (hi . hi' alone) misses the f32 oracle by far more than
    the budget: the two cross terms are what carries the kernel."""
    P, R = _k1_case("random")
    ph, _ = k1.split_tf32(torch.from_numpy(P))
    rh, _ = k1.split_tf32(torch.from_numpy(R))
    tf32 = (ph.double() @ rh.double().T).amax(1).numpy()
    truth = (P.astype(np.float64) @ R.astype(np.float64).T).max(axis=1)
    assert np.abs(tf32 - truth).max() > 1e-5
