"""The classification dispatch ``cls_query`` vs the JAX package's, on the
CPU: all 13 strategies on the JAX tests' configuration (PW at (8, 8, 1)
inputs, nclass 2 and 3, as ``tests/test_cls_extra.py``), the same pool,
labeled set, weights and committee, and the same host stream, with JAX's
draws fed through the port's seams (``tests/torch_jax_draws.inject``).
Influence runs once here, at nclass 3 with the Arnoldi s_test (an HVP
solve of this 18.4 M-parameter net takes ~10 s a package on the host);
its CG solve is held in ``tests/test_torch_cls_engine.py``'s campaigns.
Held: identical picks at f32, and the host stream's state after the call
equal to JAX's (every draw at the same point).  fi runs at a diagonal
load of 0.1 in both packages, where both A-optimal solves converge.  Also
``batched_forward`` (chunked, zero-padded, MC keyed per chunk) and
``linear_softmax_fi_scores`` against the JAX package's."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnal_tpu.models.cnn import init_cnn as j_init_cnn
from nnal_tpu.models.specs import create_model as j_create_model
from nnal_tpu.scoring import cls_strategies as jcls
from nnal_tpu.scoring import fisher as jfisher
from nnal_tpu_torch.models.bridge import from_jax_params
from nnal_tpu_torch.models.cnn import CNN
from nnal_tpu_torch.models.specs import create_model as t_create_model
from nnal_tpu_torch.scoring import cls_strategies as tcls
from nnal_tpu_torch.scoring import fisher as tfisher
from torch_jax_draws import inject

torch.set_num_threads(1)

SHAPE = (8, 8, 1)
N_POOL, N_LAB, K, B = 40, 6, 4, 16


def _port(spec_t, params):
    model = CNN(spec_t)
    model.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    return model


@functools.lru_cache(maxsize=None)
def _setup(nclass):
    args = dict(nclass=nclass, dropout_rate=0.3, patch_shape=SHAPE)
    jspec, tspec = j_create_model("PW", **args), t_create_model("PW", **args)
    params, _ = j_init_cnn(jspec, jax.random.key(nclass))
    members = [j_init_cnn(jspec, jax.random.key(100 + i))[0]
               for i in range(3)]
    rng = np.random.default_rng(7 + nclass)
    X = rng.normal(size=(N_POOL,) + SHAPE).astype(np.float32)
    L = rng.normal(size=(N_LAB,) + SHAPE).astype(np.float32)
    lab_y = rng.integers(0, nclass, size=N_LAB)
    return jspec, tspec, params, members, X, L, lab_y


def _ctx(mod, spec, params, members, X, L, lab_y):
    return mod.ClsQueryContext(
        spec=spec, params=params, pool_x=X, k=K,
        rng=np.random.default_rng(11), B=B, batch=16, MC_iters=3,
        labeled_x=L, labeled_y=lab_y, committee_params=members,
        extra={"damping": 0.1, "influence_mode": "arnoldi",
               "arnoldi_rank": 2})


def _loaded_fi(monkeypatch):
    for mod, fisher in ((jcls, jfisher), (tcls, tfisher)):
        monkeypatch.setattr(mod, "a_matrices_multiclass", functools.partial(
            fisher.a_matrices_multiclass, diag_load=0.1))


class _no_gap_warning:
    """Fail on the A-optimal solver's unconverged-gap warning."""

    def __enter__(self):
        import warnings

        self._cm = warnings.catch_warnings()
        self._cm.__enter__()
        warnings.filterwarnings("error", message="A-optimal")

    def __exit__(self, *exc):
        return self._cm.__exit__(*exc)


CASES = [(m, c) for m in tcls.METHODS for c in (2, 3)
         if (m, c) != ("influence", 2)]


@pytest.mark.parametrize("method,nclass", CASES)
def test_picks_and_host_stream_match_jax(monkeypatch, method, nclass):
    inject(monkeypatch)
    if method == "fi":
        _loaded_fi(monkeypatch)
    jspec, tspec, params, members, X, L, lab_y = _setup(nclass)
    jctx = _ctx(jcls, jspec, params, members, X, L, lab_y)
    tctx = _ctx(tcls, tspec, _port(tspec, params),
                [_port(tspec, p) for p in members], X, L, lab_y)
    with _no_gap_warning():
        want = np.asarray(jcls.cls_query(jctx, method))
        got = tcls.cls_query(tctx, method)
    assert len(got) == (K if method != "fi" else len(want))
    np.testing.assert_array_equal(got, want)
    assert (tctx.rng.bit_generator.state
            == jctx.rng.bit_generator.state)


def test_unknown_method_raises():
    jspec, tspec, params, members, X, L, lab_y = _setup(3)
    ctx = _ctx(tcls, tspec, _port(tspec, params), None, X, L, lab_y)
    with pytest.raises(ValueError, match="unknown classification"):
        tcls.cls_query(ctx, "ps-random")


@pytest.mark.parametrize("what", ["posteriors", "prediction",
                                  "feature_layer"])
def test_batched_forward_matches_jax(what):
    """A ragged last chunk (40 rows in chunks of 16), eval mode."""
    jspec, tspec, params, _, X, _, _ = _setup(3)
    want = jcls.batched_forward(jspec, params, X, 16, (what,))[what]
    got = tcls.batched_forward(tspec, _port(tspec, params), X, 16,
                               (what,))[what]
    if what == "prediction":
        np.testing.assert_array_equal(got, np.asarray(want))
    else:
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


def test_batched_forward_mc_matches_jax(monkeypatch):
    """MC dropout with JAX's masks: each chunk keyed on its start."""
    inject(monkeypatch)
    jspec, tspec, params, _, X, _, _ = _setup(3)
    key = jax.random.key(5)
    want = jcls.batched_forward(jspec, params, X, 16, mc_rng=key)
    got = tcls.batched_forward(tspec, _port(tspec, params), X, 16,
                               mc_rng=key)
    np.testing.assert_allclose(got["posteriors"],
                               np.asarray(want["posteriors"]), atol=1e-5)
    det = tcls.batched_forward(tspec, _port(tspec, params), X, 16)
    assert not np.allclose(got["posteriors"], det["posteriors"])


def test_linear_softmax_fi_scores_match_jax():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(12, 5, 2)).astype(np.float32)
    P = rng.dirichlet(np.ones(4), size=12).astype(np.float32)
    want = np.asarray(jcls.linear_softmax_fi_scores(jnp.asarray(X),
                                                    jnp.asarray(P)))
    got = tcls.linear_softmax_fi_scores(torch.from_numpy(X),
                                        torch.from_numpy(P)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
