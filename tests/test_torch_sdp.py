"""The FI query solver and the PMF tail: the port vs the JAX package on
the CPU, on A-matrices made from numpy seeds.

A-matrices are built like PW1's: per-layer gradient scales from 2e-8 (the
linear head, zero in exact arithmetic) to 2.4e-2, so M's head block is the
diagonal load 1e-5 and the gradients reach ~5e5 ("pw1" scaling); "even"
scaling gives every layer 1e-2.

Tolerances:
* a run capped at ``steps`` (not converged, the same iterations on both
  sides): max |delta q| <= 2e-6 (observed <= 3.6e-7; f32 sums in another
  order, and the capped normalization/projection root found from the
  breakpoints instead of by 80 bisection steps);
* a converged run: max |delta q| <= 5e-5 and the same objective within
  1e-5 relative.  The loop stops at the first gap within ``tol``; when the
  gap lands within rounding of ``tol`` the two packages may stop one
  iteration apart (observed: 1066 vs 1067 iterations, |delta q| 4.4e-6);
* the composite branch is held elementwise for its first 7 iterations
  only.  Its Armijo test sits within rounding of its threshold often
  enough that later iterates part by up to 1.3e-2 in q (both packages
  then crawl at steps of ~1e-12); longer runs are held to the float64
  objective within 1e-4 relative (observed <= 1.3e-5).  With the cap
  and pw1 scaling, the JAX package's bisection projection of a
  ~1e6-magnitude vector leaves the simplex (its first iterate sums to
  1.0625, which its Armijo test then accepts); the port's stays on it
  (ROADMAP Queue 3);
* PMF draws, ``refine_feature_matrix`` and ``trace_inverse``: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnal_tpu.scoring import fisher as jf
from nnal_tpu.scoring import pmf as jpmf
from nnal_tpu.scoring import sdp as jsdp
from nnal_tpu_torch.scoring import fisher as tf
from nnal_tpu_torch.scoring import pmf as tpmf
from nnal_tpu_torch.scoring import sdp as tsdp

torch.set_num_threads(1)

# per-layer scales of PW1's shrunk gradients (conv1..fc3)
_SCALES = np.array([7e-3, 1.5e-2, 2.4e-2, 5.5e-3, 1.8e-4, 2.3e-4, 2e-8])


def _A(n, seed, scaling="pw1"):
    rng = np.random.default_rng(seed)
    scales = _SCALES if scaling == "pw1" else 1e-2
    shrunk = (rng.normal(size=(n, 2, 7)) * scales).astype(np.float32)
    p = rng.uniform(0.05, 0.95, n).astype(np.float32)
    return np.asarray(jf.a_matrices(jnp.asarray(shrunk), jnp.asarray(p),
                                    1e-5))


def _features(n, seed):
    F = np.maximum(np.random.default_rng(seed).normal(size=(n, 24)), 0.0)
    ref = jf.refine_feature_matrix(F.T, n)
    return (ref - ref.mean(axis=1, keepdims=True)).astype(np.float32)


def _composite(lambda_, X):
    F = torch.from_numpy(X)
    return -lambda_ * (F ** 2).sum(0), F


CASES = {
    "a_optimal": dict(cap=1.0),
    "a_optimal_cap": dict(cap=1.0 / 8),
    "composite": dict(cap=1.0, lambda_=0.5),
    "composite_cap": dict(cap=1.0 / 8, lambda_=0.5),
    "composite_cap_even": dict(cap=1.0 / 8, lambda_=0.5, scaling="even"),
}


def _solve_both(case, n, seed, steps, tol):
    kw = CASES[case]
    A = _A(n, seed, kw.get("scaling", "pw1"))
    jkw, tkw = {}, {}
    if "lambda_" in kw:
        X = _features(n, seed + 100)
        lin, F = _composite(kw["lambda_"], X)
        jkw = dict(lin=jnp.asarray(lin.numpy()), F=jnp.asarray(X), rho=10.0)
        tkw = dict(lin=lin, F=F, rho=10.0)
    qj, gj = jsdp.solve_a_optimal(jnp.asarray(A), cap=kw["cap"], steps=steps,
                                  tol=tol, **jkw)
    sol = tsdp.solve_a_optimal(torch.from_numpy(A), cap=kw["cap"],
                               steps=steps, tol=tol, **tkw)
    return A, np.asarray(qj), float(gj), sol


def _objective64(q, A, case, seed):
    """The solver's objective in float64."""
    q = np.asarray(q, np.float64)
    f = np.trace(np.linalg.inv(np.einsum("n,nab->ab", q,
                                         A.astype(np.float64))))
    if "lambda_" in CASES[case]:
        X = _features(len(q), seed + 100).astype(np.float64)
        f += -CASES[case]["lambda_"] * (X ** 2).sum(0) @ q
        f += 5.0 * np.sum((X @ q) ** 2)
    return f


@pytest.mark.parametrize("case,steps", [
    (c, s) for c in ("a_optimal", "a_optimal_cap") for s in (1, 7, 45)]
    + [(c, s) for c in ("composite", "composite_cap_even") for s in (1, 7)])
def test_capped_steps_equal_jax(case, steps):
    """Unconverged runs stopped at exactly ``steps`` (45 = two blocks of
    20 and a remainder of 5): the block logic runs the same iterations."""
    _, qj, gj, sol = _solve_both(case, 40, 1, steps, tol=1e-9)
    assert sol.iters == steps
    np.testing.assert_allclose(sol.q.numpy(), qj, rtol=0, atol=2e-6)
    np.testing.assert_allclose(float(sol.rel_gap), gj, rtol=1e-3)


@pytest.mark.parametrize("case", ["composite", "composite_cap",
                                  "composite_cap_even"])
@pytest.mark.parametrize("steps", [45, 300])
def test_composite_runs_reach_the_jax_objective(case, steps):
    A, qj, _, sol = _solve_both(case, 40, 1, steps, tol=1e-9)
    q = sol.q.numpy()
    assert sol.iters == steps
    assert q.min() >= 0 and abs(q.astype(np.float64).sum() - 1) < 1e-5
    assert q.max() <= CASES[case]["cap"] * (1 + 1e-6)
    np.testing.assert_allclose(_objective64(q, A, case, 1),
                               _objective64(qj, A, case, 1), rtol=1e-4)


def test_capped_projection_stays_on_the_simplex_where_jax_leaves_it():
    """pw1 scaling, cap 1/8: the first iterate projects a ~1e6-magnitude
    vector.  The JAX package's 80-step f32 bisection ends off the simplex
    there; the port's breakpoint root does not (ROADMAP Queue 3)."""
    _, qj, _, sol = _solve_both("composite_cap", 40, 1, 1, tol=1e-9)
    assert abs(qj.astype(np.float64).sum() - 1.0) > 1e-2
    assert abs(sol.q.numpy().astype(np.float64).sum() - 1.0) < 1e-5
    assert sol.q.max() <= 1.0 / 8


@pytest.mark.parametrize("case", ["a_optimal", "a_optimal_cap"])
def test_converged_solution_matches_jax(case):
    A, qj, gj, sol = _solve_both(case, 60, 2, 2000, tol=1e-3)
    q = sol.q.numpy()
    assert sol.iters < 2000 and float(sol.rel_gap) <= 1e-3 and gj <= 1e-3
    np.testing.assert_allclose(q, qj, rtol=0, atol=5e-5)
    np.testing.assert_allclose(tsdp.trace_inverse(q, A),
                               jsdp.trace_inverse(qj, A), rtol=1e-5)
    assert q.min() >= 0 and abs(q.sum() - 1) < 1e-5
    assert q.max() <= CASES[case]["cap"] * (1 + 1e-5)


def test_iterations_after_convergence_change_nothing():
    """The body freezes q once the gap is within tol, so a block that runs
    far past convergence gives the same q as stopping at once."""
    A = torch.from_numpy(_A(50, 3))
    a = tsdp.solve_a_optimal(A, tol=1e-3, block=1)
    b = tsdp.solve_a_optimal(A, tol=1e-3, block=1000)
    assert a.iters == b.iters < 1000
    np.testing.assert_array_equal(a.q.numpy(), b.q.numpy())


def _jax_project_capped(u, cap):
    """The JAX package's bisection projection (a closure inside its
    ``solve_a_optimal``), verbatim."""
    lo0 = jnp.min(u) - 1.0 / u.shape[0]
    hi0 = jnp.max(u)

    def bis(_, st):
        lo, hi = st
        mid = 0.5 * (lo + hi)
        s = jnp.sum(jnp.clip(u - mid, 0.0, cap))
        return (jnp.where(s > 1.0, mid, lo), jnp.where(s > 1.0, hi, mid))

    lo, hi = jax.lax.fori_loop(0, 80, bis, (lo0, hi0))
    return jnp.clip(u - 0.5 * (lo + hi), 0.0, cap)


def _jax_armijo(A, lin, FtF, q, g, gamma, cap):
    """The JAX package's Armijo ``while_loop`` (``body_fw``), verbatim
    around its own ``_trinv``."""
    def objective(qq):
        M = jnp.einsum("n,nab->ab", qq, A)
        return jsdp._trinv(M) + jnp.dot(lin, qq) + 0.5 * jnp.dot(qq,
                                                                 FtF @ qq)

    f0 = objective(q)

    def ls_cond(st):
        gm, it = st
        qn = _jax_project_capped(q - gm * g, cap)
        return (objective(qn) > f0 + 0.3 * jnp.dot(g, qn - q)) & (it < 40)

    gm, _ = jax.lax.while_loop(ls_cond, lambda st: (st[0] * 0.5, st[1] + 1),
                               (gamma * 2.0, jnp.int32(0)))
    return _jax_project_capped(q - gm * g, cap), gm


@pytest.mark.parametrize("cap", [1.0, 1.0 / 8])
@pytest.mark.parametrize("gamma,ascent", [(1e-6, False), (1e3, False),
                                          (1e8, False), (1.0, True)])
def test_batched_armijo_matches_jax_while_loop(cap, gamma, ascent):
    """Small steps accept at once, large ones halve many times, an ascent
    direction never meets Armijo (i* = 40)."""
    n = 30
    A = _A(n, 4)
    X = _features(n, 104)
    lin, F = _composite(0.5, X)
    FtF = (F.T @ F) * 10.0
    q = torch.from_numpy(np.random.default_rng(4).dirichlet(np.ones(n))
                         .astype(np.float32))
    At = torch.from_numpy(A)
    M = torch.einsum("n,nab->ab", q, At)
    Minv = torch.linalg.inv(M)
    g = -torch.einsum("ab,nab->n", Minv @ Minv, At) + lin + FtF @ q
    if ascent:
        g = -g

    def objective(Q):
        Mq = torch.einsum("kn,nab->kab", Q, At)
        return tsdp._trinv(Mq) + Q @ lin + 0.5 * ((Q @ FtF) * Q).sum(-1)

    f0 = objective(q[None])[0]
    q_t, gm_t = tsdp._armijo(objective, q, g, f0,
                             torch.tensor(gamma, dtype=torch.float32), cap)
    q_j, gm_j = _jax_armijo(jnp.asarray(A), jnp.asarray(lin.numpy()),
                            jnp.asarray(FtF.numpy()), jnp.asarray(q.numpy()),
                            jnp.asarray(g.numpy()), jnp.float32(gamma), cap)
    assert float(gm_t) == float(gm_j)
    if ascent:
        assert float(gm_t) == gamma * 2.0 * 0.5 ** 40
    # both projections are accurate to the f32 spacing of the vector they
    # project (|q - step * g| reaches ~1e3 here)
    u = np.abs((q - gm_t * g).numpy()).max()
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), rtol=0,
                               atol=max(2e-6, 8 * float(np.spacing(u))))


@pytest.mark.parametrize("cap", [1.0, 0.05, 1.0 / 3])
def test_capped_normalization_and_projection_match_bisection(cap):
    """The breakpoint roots against the JAX package's bisections, caps
    binding or not, zeros included."""
    rng = np.random.default_rng(5)
    u = rng.exponential(size=64).astype(np.float32)
    u[:5] = 0.0
    got = tsdp._normalize_capped(torch.from_numpy(u), cap).numpy()
    want = np.asarray(jsdp._normalize_capped(jnp.asarray(u), cap))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    v = (rng.normal(size=(3, 64)) * 0.05).astype(np.float32)
    got = tsdp._project_capped(torch.from_numpy(v), cap).numpy()
    for row, g in zip(v, got):
        want = np.asarray(_jax_project_capped(jnp.asarray(row), cap))
        np.testing.assert_allclose(g, want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("lambda_,cap_peak", [(0.0, False), (0.0, True),
                                              (0.5, False)])
def test_fi_query_distribution_matches_jax(lambda_, cap_peak):
    n = 40
    A = _A(n, 6)
    X = _features(n, 106) if lambda_ > 0 else None
    steps = 300 if lambda_ > 0 else 2000
    want = jsdp.fi_query_distribution(list(A), lambda_, X, 8,
                                      cap_peak=cap_peak, steps=steps)
    got = tsdp.fi_query_distribution(torch.from_numpy(A), lambda_, X, 8,
                                     cap_peak=cap_peak, steps=steps)
    assert got.dtype == np.float64 and abs(got.sum() - 1) < 1e-12
    if lambda_ > 0:
        case = "composite"
        np.testing.assert_allclose(_objective64(got, A, case, 6),
                                   _objective64(want, A, case, 6), rtol=1e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)
    # a list of matrices goes to the device the caller names
    got_list = tsdp.fi_query_distribution(list(A), lambda_, X, 8,
                                          cap_peak=cap_peak, steps=steps,
                                          device="cpu")
    np.testing.assert_array_equal(got_list, got)


def test_fi_query_distribution_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tsdp.fi_query_distribution(list(_A(5, 7)), 0.0, None, 2)


def test_trace_inverse_matches_jax():
    A = _A(12, 8)
    q = np.random.default_rng(8).dirichlet(np.ones(12))
    assert tsdp.trace_inverse(q, A) == jsdp.trace_inverse(q, A)


@pytest.mark.parametrize("replacement", [True, False])
def test_sample_query_pmf_is_bit_identical(replacement):
    q = np.random.default_rng(9).dirichlet(np.ones(50) * 0.3)
    q[3] = -0.001                      # small negatives are zeroed
    for seed in range(5):
        a = tpmf.sample_query_pmf(q, 12, np.random.default_rng(seed),
                                  replacement)
        b = jpmf.sample_query_pmf(q, 12, np.random.default_rng(seed),
                                  replacement)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("prior", [None, "flat", "peaked"])
def test_draw_queries_is_bit_identical(prior):
    rng0 = np.random.default_rng(10)
    q = rng0.dirichlet(np.ones(30))
    pr = {None: None, "flat": np.ones(30),
          "peaked": rng0.uniform(0, 1, 30) ** 4}[prior]
    for replacement in (True, False):
        a = tpmf.draw_queries(q, pr, 7, np.random.default_rng(1),
                              replacement)
        b = jpmf.draw_queries(q, pr, 7, np.random.default_rng(1),
                              replacement)
        np.testing.assert_array_equal(a, b)


def test_refine_feature_matrix_is_exact():
    rng = np.random.default_rng(11)
    F = np.maximum(rng.normal(size=(40, 30)), 0.0)
    F[5] = F[6]                          # a rank deficiency to drop
    F[:, 3] = 0.0
    np.testing.assert_array_equal(tf.refine_feature_matrix(F, 30),
                                  jf.refine_feature_matrix(F, 30))
    np.testing.assert_array_equal(tf.refine_feature_matrix(F, 30, 10.0),
                                  jf.refine_feature_matrix(F, 30, 10.0))
