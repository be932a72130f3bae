"""The port's last-layer closed forms, LiSSA, Lanczos / Arnoldi influence
(``nnal_tpu_torch/scoring/hessian.py``) and full per-sample gradients,
diagonal Fisher and whole-gradient shrinkage
(``scoring/gradients.py``) vs the JAX package's on the same inputs and
weights (CPU; the tiny net of ``tests/test_second_order.py``).  Lanczos
starts from JAX's own draw (``tests/torch_jax_draws.inject``).

Tolerances: closed forms and LiSSA 1e-5 relative; per-sample gradients
and the diagonal Fisher 1e-5 of each leaf's max |.|; Lanczos eigenvalues
and Ritz vectors 1e-3 (a Krylov basis amplifies f32 rounding step by
step); Arnoldi s_test 1e-3 of max |s|; shrinkage of the same gradient
values exactly equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from nnal_tpu.scoring import gradients as jgrad
from nnal_tpu.scoring import hessian as jhess
from nnal_tpu.scoring import influence as jinf
from nnal_tpu_torch.scoring import gradients as tgrad
from nnal_tpu_torch.scoring import hessian as thess
from nnal_tpu_torch.scoring import influence as tinf
from nnal_tpu_torch.scoring.strategies import _s_test_dispatch
from torch_jax_draws import inject
from torch_jax_tiny import data, rel_err, tiny_pair, to_jax, to_port

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def net():
    return tiny_pair(0)


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * np.abs(want).max())


def _ll(seed=0, b=4, d=5, c=3):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(b, d)).astype(np.float32)
    z = rng.normal(size=(b, c)).astype(np.float32)
    p = np.exp(z) / np.exp(z).sum(1, keepdims=True)
    y = np.eye(c, dtype=np.float32)[rng.integers(0, c, b)]
    return a, p.astype(np.float32), y


def test_llfc_closed_forms_match_jax():
    a, p, y = _ll()
    dW, db = thess.llfc_grads(*map(torch.from_numpy, (a, p, y)))
    jW, jb = jhess.llfc_grads(*map(jnp.asarray, (a, p, y)))
    _close(dW, jW, 1e-5)
    _close(db, jb, 1e-5)
    H = thess.llfc_hess(torch.from_numpy(a), torch.from_numpy(p))
    assert H.shape == (4, 18, 18)
    _close(H, jhess.llfc_hess(jnp.asarray(a), jnp.asarray(p)), 1e-5)


def test_lissa_matches_jax():
    rng = np.random.default_rng(0)
    D = 6
    M = rng.normal(size=(3, D, D))
    H = (M @ M.transpose(0, 2, 1) / D + np.eye(D)).astype(np.float32)
    g = rng.normal(size=(D, 2)).astype(np.float32)
    got = thess.lissa_influence(torch.from_numpy(g), torch.from_numpy(H),
                                max_iter=50, scale=10.0)
    _close(got, jhess.lissa_influence(jnp.asarray(g), jnp.asarray(H),
                                      max_iter=50, scale=10.0), 1e-5)


def _jax_flat_to_port(flat, unravel, params):
    return tinf.flatten(to_port(unravel(flat), params))


@pytest.mark.parametrize("rank,weighted", [(4, False), (12, True)])
def test_lanczos_matches_jax_from_jaxs_start(monkeypatch, net, rank,
                                             weighted):
    inject(monkeypatch)
    jspec, jp, model, params = net
    x, y, tx, ty = data(8)
    w = np.array([1, 1, 1, 0, 1, 1, 0, 1], np.float32) if weighted else None
    key = jax.random.key(3)
    ev, V, unravel = thess.lanczos_eigsh(
        model, params, tx, ty, rank, key,
        w=None if w is None else torch.from_numpy(w))
    jev, jV, junravel = jhess.lanczos_eigsh(
        jspec, jp, jnp.asarray(x), jnp.asarray(y), rank, key,
        w=None if w is None else jnp.asarray(w))
    assert ev.shape == (rank,) and V.shape[0] == rank
    _close(ev, jev, 1e-3)
    want = torch.stack([_jax_flat_to_port(r, junravel, params)
                        for r in jV])
    # the extreme eigenpairs, which Lanczos has converged
    _close(V[:2], want[:2], 1e-3)
    G = (V @ V.T).numpy()
    np.testing.assert_allclose(G, np.eye(rank), atol=1e-4)
    assert set(unravel(V[0])) == set(params)


def test_arnoldi_s_test_matches_jax_and_reuses_its_basis(monkeypatch, net):
    inject(monkeypatch)
    jspec, jp, model, params = net
    n_tr, pad = 6, 2
    x, y, tx, ty = data(n_tr + pad)
    key = jax.random.key(7)
    st, basis = thess.arnoldi_s_test(model, params, tx, ty, tx, ty, rank=6,
                                     key=key, damping=0.5, n_valid=n_tr,
                                     q_n_valid=n_tr, bucket=8)
    jst, _ = jhess.arnoldi_s_test(jspec, jp, jnp.asarray(x),
                                  jnp.asarray(y), jnp.asarray(x),
                                  jnp.asarray(y), rank=6, key=key,
                                  damping=0.5, n_valid=n_tr,
                                  q_n_valid=n_tr, bucket=8)
    assert rel_err(st, to_port(jst, params)) < 1e-3
    again, same = thess.arnoldi_s_test(model, params, None, None, tx, ty,
                                       rank=6, key=jax.random.key(9),
                                       damping=0.5, q_n_valid=n_tr,
                                       basis=basis)
    assert same is basis
    for n in st:
        assert torch.equal(again[n], st[n])


def test_arnoldi_annihilates_near_singular_modes(net):
    """A mode at exactly -damping, and one inside the 10% floor, is
    dropped, not inverted; the rest is JAX's formula on the same basis."""
    jspec, jp, model, params = net
    x, y, tx, ty = data(6)
    flat = tinf.flatten(params)
    loss = tinf.make_loss(model)
    H = torch.autograd.functional.hessian(
        lambda f: loss(tinf.unflatten(f, params), tx, ty), flat).double()
    lam, vecs = torch.linalg.eigh(H)
    order = torch.argsort(-lam.abs())[:4]
    damping = 0.3
    lam = lam[order].float()
    V = vecs[:, order].T.float().contiguous()
    lam[2], lam[3] = -damping, -damping * 1.05
    st, _ = thess.arnoldi_s_test(
        model, params, tx, ty, tx, ty, rank=4, key=0, damping=damping,
        basis=(lam, V, lambda f: tinf.unflatten(f, params)))
    got = tinf.flatten(st)
    assert torch.isfinite(got).all()
    g = tinf.flatten(tinf.loss_grad(model, params, tx, ty))
    inv = torch.tensor([1 / (lam[0] + damping), 1 / (lam[1] + damping),
                        0.0, 0.0])
    want = V.T @ ((V @ g) * inv) + (g - V.T @ (V @ g)) / damping
    _close(got, want, 1e-4)
    # JAX's arnoldi on the same basis, in its own layout
    jg = jinf.loss_grad(jspec, jp, jnp.asarray(x), jnp.asarray(y))
    _, junravel = ravel_pytree(jg)
    Vj = np.stack([np.asarray(ravel_pytree(to_jax(tinf.unflatten(
        row, params)))[0]) for row in V])
    jst, _ = jhess.arnoldi_s_test(
        jspec, jp, jnp.asarray(x), jnp.asarray(y), jnp.asarray(x),
        jnp.asarray(y), rank=4, key=jax.random.key(0), damping=damping,
        basis=(jnp.asarray(lam.numpy()), jnp.asarray(Vj), junravel))
    assert rel_err(st, to_port(jst, params)) < 1e-4


def test_unknown_influence_mode_raises(net):
    _, _, model, params = net
    _, _, tx, ty = data(4)
    with pytest.raises(ValueError, match="influence_mode"):
        _s_test_dispatch({"influence_mode": "arnodli"}, model, params, tx,
                         ty, 0.1, 4, 0)


def test_per_sample_grads_and_diagonal_fisher_match_jax(net):
    jspec, jp, model, params = net
    x, y, tx, ty = data(5)
    got = tgrad.per_sample_grads(model, params, tx, ty)
    want = jgrad.per_sample_grads(jspec, jp, jnp.asarray(x), jnp.asarray(y))
    for i in range(5):
        row = to_port(jax.tree_util.tree_map(lambda a: a[i], want), params)
        for n in params:
            _close(got[n][i], row[n], 1e-5)
    F = tgrad.diagonal_fisher(model, params, tx, ty, chunk=2)
    jF = to_port(jgrad.diagonal_fisher(jspec, jp, jnp.asarray(x),
                                       jnp.asarray(y), chunk=2), params)
    for n in params:
        _close(F[n], jF[n], 1e-5)
        _close(F[n], (got[n] ** 2).mean(0), 1e-5)


@pytest.mark.parametrize("method", ["sum", "max", "rand"])
def test_shrink_gradient_pytree_matches_jax(net, method):
    """The same gradient values (JAX's, carried into the port's layouts)
    shrink to the same numbers; 'rand' picks the same entries of each
    layer's JAX-layout ravel from the same generator."""
    jspec, jp, model, params = net
    x, y, _, _ = data(3)
    jg = jinf.loss_grad(jspec, jp, jnp.asarray(x), jnp.asarray(y))
    got = tgrad.shrink_gradient_pytree(to_port(jg, params), model.spec,
                                       method, np.random.default_rng(4), 5)
    want = jgrad.shrink_gradient_pytree(jg, jspec, method,
                                        np.random.default_rng(4), 5)
    assert got.shape == want.shape == ((15,) if method == "rand" else (3,))
    np.testing.assert_array_equal(got, want)
