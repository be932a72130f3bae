"""``query_multimg`` of the port vs the JAX package's (CPU): every one of
the 15 strategies on two 20x20x6 subjects (9x9x1 patches, PW1 with
dropout 0.5, the same weights through ``models/bridge``; influence on the
tiny net of ``tests/torch_jax_tiny.py``, whose second-order solves are
cheap and well conditioned), each subject scored by its own grid
evaluator, with JAX's draws fed through the port's draw functions
(``tests/torch_jax_draws.inject``) and each subject's context keyed by
its own JAX key, as the engine's ``qrng.next()`` does.  Also core-set
from held-out bootstrap features, influence with arnoldi, fi's
A-matrices, and fi on one subject against the single-subject path.

Tolerances: picks (per-subject positions) are exactly equal; fi's
A-matrices are held within 1e-5 of the largest |entry| (the shrunk
gradients' f32 sums run in another order on each side)."""

import jax
import numpy as np
import pytest
import torch

from nnal_tpu.core.profiling import drain_subphases as j_drain
from nnal_tpu.data.patches import pad_volumes as j_pad
from nnal_tpu.models.cnn import init_cnn
from nnal_tpu.models.specs import create_pw1
from nnal_tpu.scoring import gradients as jgrad
from nnal_tpu.scoring import strategies as jstrat
from nnal_tpu.scoring.grid_eval import GridPoolEvaluator as JGrid
from nnal_tpu_torch.core.profiling import drain_subphases
from nnal_tpu_torch.data.io import synthetic_subject
from nnal_tpu_torch.data.patches import pad_volumes
from nnal_tpu_torch.data.samplers import generate_grid_samples
from nnal_tpu_torch.data.stats import multimg_stats
from nnal_tpu_torch.models.bridge import from_jax_params
from nnal_tpu_torch.models.cnn import CNN
from nnal_tpu_torch.models.specs import create_pw1 as t_create_pw1
from nnal_tpu_torch.scoring import strategies as tstrat
from nnal_tpu_torch.scoring.grid_eval import GridPoolEvaluator as TGrid
from torch_jax_draws import inject
from torch_jax_tiny import tiny_pair

torch.set_num_threads(1)

SHAPE = (20, 20, 6)
PATCH = (9, 9, 1)
K = 6
SUBJECTS = [synthetic_subject(shape=SHAPE, n_modalities=1, n_blobs=6,
                              seed=s) for s in range(2)]
STRATEGIES = ("random", "ps-random", "entropy", "MC-entropy", "BALD",
              "BatchBALD", "ensemble", "QBC-JS", "rep-entropy", "BADGE",
              "core-set", "fi", "AU_4U", "SuPix", "influence")


@pytest.fixture(autouse=True)
def _no_stray_spans():
    """fi's and influence's sub-spans recorded here are committed by no
    round: drop them, so a later campaign in this worker does not
    report them as its own."""
    yield
    drain_subphases()
    j_drain()


def _member(seed):
    spec = create_pw1(2, 0.5, (9, 9, 1))
    params, _ = init_cnn(spec, jax.random.key(seed))
    model = CNN(t_create_pw1(2, 0.5, (9, 9, 1)))
    model.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    return spec, params, model


def _tiny(seed):
    return tiny_pair(seed, input_shape=PATCH)[:3]


def _setup(member):
    jspec, jp, model = member(0)
    stats = multimg_stats(SUBJECTS)
    jevs, tevs, pools, trains = [], [], [], []
    for i, (vols, mask) in enumerate(SUBJECTS):
        mu, sd = stats[i, 0::2], stats[i, 1::2]
        jevs.append(JGrid(jspec, j_pad(vols, PATCH), mu, sd, PATCH, SHAPE,
                          grid_spacing=2, ntb=256, z_chunk=2))
        tevs.append(TGrid(model.spec, pad_volumes(vols, PATCH, device="cpu"),
                          mu, sd, PATCH, SHAPE, grid_spacing=2, ntb=256,
                          z_chunk=2))
        grid, _ = generate_grid_samples(SHAPE, 2, mask)
        trains.append(grid[i::9])
        pools.append(np.setdiff1d(grid, grid[i::9]))
    committee = [member(100 + i) for i in range(3)]
    return dict(jspec=jspec, jp=jp, model=model, jevs=jevs, tevs=tevs,
                pools=pools, trains=trains, committee=committee)


@pytest.fixture(scope="module")
def setup():
    return _setup(_member)


@pytest.fixture(scope="module")
def tiny():
    return _setup(_tiny)


def _contexts(s, labeled=True, subjects=(0, 1), **extra):
    """Both packages' contexts over ``subjects``, and each package's round
    generator (the contexts' ``rng``, passed to ``query_multimg`` too)."""
    jrng, trng = np.random.default_rng(3), np.random.default_rng(3)
    jc, tc = [], []
    for si in subjects:
        vols, mask = SUBJECTS[si]
        kw = dict(pool_inds=s["pools"][si], k=K, B=40, MC_iters=2,
                  train_inds=s["trains"][si] if labeled else None,
                  raw_volume=vols[0])
        key = jax.random.key(11 + si)
        ex = {"mask": mask, "n_segments": 16, **extra}
        jc.append(jstrat.QueryContext(
            spec=s["jspec"], params=s["jp"], evaluator=s["jevs"][si],
            rng=jrng, jax_rng=key, extra=dict(ex),
            ensemble_params=[m[1] for m in s["committee"]], **kw))
        tc.append(tstrat.QueryContext(
            spec=s["model"].spec, params=s["model"], evaluator=s["tevs"][si],
            rng=trng, seed=key, extra=dict(ex),
            ensemble_params=[m[2] for m in s["committee"]], **kw))
    return jc, tc, jrng, trng


def _assert_same_picks(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("method", STRATEGIES)
def test_picks_match_jax(monkeypatch, setup, tiny, method):
    inject(monkeypatch)
    jc, tc, jrng, trng = _contexts(tiny if method == "influence" else setup)
    want = jstrat.query_multimg(jc, method, K, jrng)
    got = tstrat.query_multimg(tc, method, K, trng)
    _assert_same_picks(got, want)
    n = sum(len(g) for g in got)
    assert (n > K if method == "SuPix" else 1 <= n <= K)
    for g, c in zip(got, tc):
        assert len(np.unique(g)) == len(g) and np.all(g < len(c.pool_inds))
    if method == "SuPix":
        for j, t in zip(jc, tc):
            np.testing.assert_array_equal(t.extra["overseg"],
                                          j.extra["overseg"])


@pytest.mark.parametrize("case", ["core-set bootstrap", "influence arnoldi"])
def test_variant_picks_match_jax(monkeypatch, setup, tiny, case):
    inject(monkeypatch)
    if case == "core-set bootstrap":
        # no labels yet: similarities seeded from held-out features
        rng = np.random.default_rng(0)
        bf = rng.normal(size=(37, 4096)).astype(np.float32)
        jc, tc, jrng, trng = _contexts(setup, labeled=False,
                                       bootstrap_features=bf)
        method = "core-set"
    else:
        jc, tc, jrng, trng = _contexts(tiny, influence_mode="arnoldi",
                                       arnoldi_rank=3)
        method = "influence"
    _assert_same_picks(tstrat.query_multimg(tc, method, K, trng),
                       jstrat.query_multimg(jc, method, K, jrng))


def test_fi_a_matrices_match_jax(monkeypatch, setup):
    """Each subject's A-matrices (candidates padded to B, pad rows sliced
    off) against JAX's, and the picks."""
    seen = {"jax": [], "port": []}

    def spy(tag, fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            seen[tag].append(np.asarray(out))
            return out
        return wrapped

    monkeypatch.setattr(jgrad, "gather_shrunk_a_matrices",
                        spy("jax", jgrad.gather_shrunk_a_matrices))
    monkeypatch.setattr(tstrat, "gather_shrunk_a_matrices",
                        spy("port", tstrat.gather_shrunk_a_matrices))
    jc, tc, jrng, trng = _contexts(setup)
    want = jstrat.query_multimg(jc, "fi", K, jrng)
    got = tstrat.query_multimg(tc, "fi", K, trng)
    _assert_same_picks(got, want)
    assert len(seen["port"]) == len(seen["jax"]) == 2
    for a, b in zip(seen["port"], seen["jax"]):
        assert a.shape == b.shape and a.shape[0] == 40
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())


def test_fi_one_subject_matches_the_single_subject_path(setup):
    _, tc, _, _ = _contexts(setup, subjects=(0,))
    single = tstrat.cnn_query(tc[0], "fi")
    _, tc, _, trng = _contexts(setup, subjects=(0,))
    multi = tstrat.query_multimg(tc, "fi", K, trng)
    np.testing.assert_array_equal(single, multi[0])


def test_multimg_rejects_what_the_port_lacks(setup):
    _, tc, _, trng = _contexts(setup)
    with pytest.raises(ValueError, match="unknown query method"):
        tstrat.query_multimg(tc, "no-such", K, trng)

    class Dense:                       # a dense-spec (fcn) evaluator
        patch_shape = PATCH

    tc[0].evaluator = Dense()
    with pytest.raises(NotImplementedError, match="patch-wise evaluator"):
        tstrat.query_multimg(tc, "influence", K, trng)
