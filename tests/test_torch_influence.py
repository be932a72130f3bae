"""The port's influence functions (``nnal_tpu_torch/scoring/influence.py``)
vs the JAX package's on the tiny net of ``tests/test_second_order.py``
with the same weights (CPU): the HVP against JAX and against an explicit
Hessian, truncated CG (residual, relative stop, first-iteration negative
curvature, a fixed iteration count against JAX), s_test's padding as an
exact no-op, the one-pass jvp scores against the ``vmap(grad)`` oracle
and JAX, and the scipy Newton-CG path against JAX's.

Tolerances: f32 throughout; leaves are compared relative to the largest
entry of the reference (1e-4 for one HVP or gradient, 1e-3 after CG,
which amplifies rounding; 1e-4 for scores)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from nnal_tpu.scoring import influence as jinf
from nnal_tpu_torch.scoring import influence as tinf
from torch_jax_tiny import data, rel_err, tiny_pair, to_jax, to_port

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def net():
    return tiny_pair(0)


def _v(params, seed=2):
    g = torch.Generator().manual_seed(seed)
    return {n: torch.randn(t.shape, generator=g) for n, t in params.items()}


@pytest.mark.parametrize("weighted", [False, True])
def test_hvp_matches_jax(net, weighted):
    jspec, jp, model, params = net
    x, y, tx, ty = data(8)
    v = _v(params)
    w = np.array([1, 1, 0, 1, 1, 1, 0, 1], np.float32) if weighted else None
    jv = jax.tree_util.tree_map(jnp.asarray, to_jax(v))
    want = jinf.hvp(jspec, jp, jnp.asarray(x), jnp.asarray(y), jv,
                    None if w is None else jnp.asarray(w))
    got = tinf.hvp(model, params, tx, ty, v,
                   None if w is None else torch.from_numpy(w))
    assert rel_err(got, to_port(want, params)) < 1e-4


def test_hvp_matches_explicit_hessian(net):
    _, _, model, params = net
    _, _, tx, ty = data(4)
    flat = tinf.flatten(params)
    loss = tinf.make_loss(model)
    H = torch.autograd.functional.hessian(
        lambda f: loss(tinf.unflatten(f, params), tx, ty), flat)
    v = _v(params)
    got = tinf.flatten(tinf.hvp(model, params, tx, ty, v))
    want = H @ tinf.flatten(v)
    assert float((got - want).abs().max()) < 1e-4 * float(want.abs().max())


def _residual(model, params, tx, ty, t, v, damping):
    Ht = tinf.flatten(tinf.hvp(model, params, tx, ty, t))
    r = Ht + damping * tinf.flatten(t) - tinf.flatten(v)
    return float(r.norm() / tinf.flatten(v).norm())


def test_cg_solves_the_damped_system(net):
    """damping 2.5 exceeds |lambda_min| of this net's Hessian
    (``test_second_order.py``), so the damped system is positive
    definite and CG converges: relative residual < 1e-2."""
    _, _, model, params = net
    _, _, tx, ty = data(6)
    v = tinf.loss_grad(model, params, tx, ty)
    t, info = tinf.cg_solve_hvp(model, params, tx, ty, v, damping=2.5,
                                max_iter=100)
    assert not info["curvature_exit"] and info["iters"] < 100
    assert _residual(model, params, tx, ty, t, v, 2.5) < 1e-2


def test_cg_stop_is_relative(net):
    """A right-hand side 1e-3 as large stops at the same iteration with a
    solution 1e-3 as large: the threshold is ``tol * rs0``, not absolute
    (an absolute one returned s_test = 0 for small query gradients).  The
    loop stops at the first iteration whose residual is under it."""
    _, _, model, params = net
    _, _, tx, ty = data(6)
    v = tinf.loss_grad(model, params, tx, ty)
    small = {n: t * 1e-3 for n, t in v.items()}
    (t, info), (ts, info_s) = [
        tinf.cg_solve_hvp(model, params, tx, ty, vv, damping=2.5,
                          max_iter=100, tol=1e-3) for vv in (v, small)]
    assert info == info_s and info["iters"] > 1
    assert not info["curvature_exit"]
    big = tinf.flatten(t)
    np.testing.assert_allclose(tinf.flatten(ts).numpy() * 1e3, big.numpy(),
                               rtol=1e-3, atol=1e-3 * float(big.abs().max()))
    # CG's recursive residual is the true one up to rounding (1e-2 slack)
    assert _residual(model, params, tx, ty, t, v, 2.5) ** 2 <= 1e-3 * 1.01
    early, _ = tinf.cg_solve_hvp(model, params, tx, ty, v, damping=2.5,
                                 max_iter=info["iters"] - 1, tol=1e-3)
    assert _residual(model, params, tx, ty, early, v, 2.5) ** 2 > 1e-3


def test_cg_first_iteration_negative_curvature_returns_the_rhs(net):
    """With damping -1e3 every direction has p^T (H + d) p < 0: the first
    iteration exits with t = v (fmin_ncg's steepest-descent fallback), as
    in JAX."""
    jspec, jp, model, params = net
    x, y, tx, ty = data(6)
    v = tinf.loss_grad(model, params, tx, ty)
    t, info = tinf.cg_solve_hvp(model, params, tx, ty, v, damping=-1e3)
    assert info == {"iters": 1, "curvature_exit": True}
    for n in v:
        assert torch.equal(t[n], v[n])
    jv = jinf.loss_grad(jspec, jp, jnp.asarray(x), jnp.asarray(y))
    jt = jinf.cg_solve_hvp(jspec, jp, jnp.asarray(x), jnp.asarray(y), jv,
                           damping=-1e3)
    assert rel_err(t, to_port(jt, params)) < 1e-5


@pytest.mark.parametrize("max_iter", [3, 8])
def test_cg_at_a_fixed_iteration_count_matches_jax(net, max_iter):
    jspec, jp, model, params = net
    x, y, tx, ty = data(6)
    v = tinf.loss_grad(model, params, tx, ty)
    t, info = tinf.cg_solve_hvp(model, params, tx, ty, v, damping=2.5,
                                max_iter=max_iter, tol=1e-12)
    assert info["iters"] == max_iter
    jv = jinf.loss_grad(jspec, jp, jnp.asarray(x), jnp.asarray(y))
    jt = jinf.cg_solve_hvp(jspec, jp, jnp.asarray(x), jnp.asarray(y), jv,
                           damping=2.5, max_iter=max_iter, tol=1e-12)
    assert rel_err(t, to_port(jt, params)) < 1e-3


def test_s_test_padding_is_an_exact_noop(net):
    """Junk rows (nonzero patches, class 0) weighted out of H and v give
    the unpadded s_test and the same influence ranking, as in
    ``test_second_order.py``; the port's s_test also matches JAX's."""
    jspec, jp, model, params = net
    rng = np.random.default_rng(3)
    n_tr, pad = 5, 11
    x = rng.normal(size=(n_tr + pad, 6, 6, 1)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[np.r_[rng.integers(0, 2, n_tr),
                                          np.zeros(pad, np.int64)]]
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    ref = tinf.s_test(model, params, tx[:n_tr], ty[:n_tr], tx[:n_tr],
                      ty[:n_tr], damping=0.1, bucket=5)
    padded = tinf.s_test(model, params, tx, ty, tx, ty, damping=0.1,
                         bucket=8, n_valid=n_tr, q_n_valid=n_tr)
    _, _, px, py = data(7, seed=4)
    sc_ref = tinf.influence_scores(model, params, ref, px, py)
    sc_pad = tinf.influence_scores(model, params, padded, px, py)
    np.testing.assert_allclose(sc_pad, sc_ref, rtol=1e-4, atol=1e-6)
    assert np.array_equal(np.argsort(-np.abs(sc_pad), kind="stable"),
                          np.argsort(-np.abs(sc_ref), kind="stable"))
    want = jinf.s_test(jspec, jp, jnp.asarray(x), jnp.asarray(y),
                       jnp.asarray(x), jnp.asarray(y), damping=0.1,
                       bucket=8, n_valid=n_tr, q_n_valid=n_tr)
    assert rel_err(padded, to_port(want, params)) < 1e-3


def test_influence_scores_match_the_oracle_and_jax(net):
    jspec, jp, model, params = net
    x, y, tx, ty = data(6)
    st = tinf.s_test(model, params, tx, ty, tx, ty, damping=0.1, bucket=8)
    px, py, tpx, tpy = data(9, seed=5)
    fast = tinf.influence_scores(model, params, st, tpx, tpy, bucket=8)
    assert fast.shape == (9,)
    oracle = tinf._chunk_influence(model, params, st, tpx, tpy).numpy()
    np.testing.assert_allclose(fast, oracle, rtol=2e-4,
                               atol=1e-4 * np.abs(oracle).max())
    # the same s_test through JAX's scorer
    jst = jax.tree_util.tree_map(jnp.asarray, to_jax(st))
    want = jinf.influence_scores(jspec, jp, jst, px, py, bucket=8)
    np.testing.assert_allclose(fast, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(
        tinf.influence_scores_jvp(model, params, st, tpx, tpy).numpy(),
        np.asarray(jinf.influence_scores_jvp(jspec, jp, jst,
                                             jnp.asarray(px),
                                             jnp.asarray(py))),
        rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_scipy_newton_cg_matches_jax(net):
    """Both through ``fmin_ncg`` from v, on a damped positive-definite
    system: the solutions agree within 1e-3 of max |s|."""
    jspec, jp, model, params = net
    x, y, tx, ty = data(6)
    v = tinf.loss_grad(model, params, tx, ty)
    got = tinf.scipy_newton_cg_s_test(model, params, tx, ty, v,
                                      damping=2.5)
    jv = jinf.loss_grad(jspec, jp, jnp.asarray(x), jnp.asarray(y))
    want = jinf.scipy_newton_cg_s_test(jspec, jp, x, y, jv, damping=2.5)
    assert rel_err(got, to_port(want, params)) < 1e-3
    assert _residual(model, params, tx, ty, got, v, 2.5) < 1e-2
    assert ravel_pytree(want)[0].shape[0] == tinf.flatten(got).numel()
