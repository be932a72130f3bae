"""The single-subject engine's dense-model path (``model_name: Tiramisu``)
vs the JAX package's on the CPU: the small FC-DenseNet-103 on a 24x24x8
two-modality subject, from one JAX-written experiment directory.  Held:
round 0's picks of entropy, core-set (K1's plain version), fi
(hallucinated last-layer A-matrices, at a diagonal load where the A-optimal
solver converges), BALD, BADGE and rep-entropy equal
the JAX package's (the port's engine fed JAX's streams and draws); a
directory the JAX package left after a round resumed by the port picks
round 1 as the JAX package does; crash-resume == continue bit for bit
with int8 anchors and the mean teacher, the BN state included; influence
and AU_4U raise on a dense spec; ps-random's window is the configured
patch; committee members leave the main BN state alone."""

import os
import shutil

import numpy as np
import pytest
import torch

from nnal_tpu.core.config import ExperimentConfig as JConfig
from nnal_tpu.core.rng import RngStream as JRngStream
from nnal_tpu.data.io import synthetic_subject
from nnal_tpu.engine.pw_experiment import PWExperiment as JExperiment
from nnal_tpu_torch.core.config import ExperimentConfig
from nnal_tpu_torch.engine import pw_experiment as pw_mod
from nnal_tpu_torch.engine.pw_experiment import PWExperiment
from nnal_tpu_torch.scoring import strategies as tstrat
from nnal_tpu_torch.scoring.fcn_eval import FCNGridPoolEvaluator
from nnal_tpu_torch.scoring.grid_eval import GridPoolEvaluator
from torch_jax_draws import inject

torch.set_num_threads(1)

K = 4
PARS = {"model_name": "Tiramisu", "nclass": 2, "patch_shape": (9, 9, 1),
        "grid_spacing": 4, "k": K, "B": 16, "ntb": 256, "b": 4,
        "epochs": 2, "MC_iters": 2, "learning_rate": 1e-3,
        "optimizer_name": "Adam", "dropout_rate": 0.1, "init_size": 6,
        "seed": 3, "model_kwargs": {"growth": 4, "depths": [2, 2]},
        # fi's SDP converges at this load (tests/test_torch_dense_model.py
        # holds the unconverged default)
        "diag_load": 0.1}
SUBJECT = synthetic_subject(shape=(24, 24, 8), n_modalities=2, seed=0)
ROUND0 = ["entropy", "core-set", "fi", "BALD", "BADGE", "rep-entropy"]


def _queries(root, method, it):
    return np.atleast_1d(np.loadtxt(
        os.path.join(str(root), method, "queries", f"{it}.txt"),
        dtype=np.int64))


@pytest.fixture(scope="module")
def jax_round0(tmp_path_factory):
    """One JAX experiment with every method added; the port's copy is
    taken before any round runs, then the JAX package runs round 0 of
    each method and the entropy campaign a second round from a copy."""
    root = tmp_path_factory.mktemp("dense_engine")
    jdir, tdir = root / "jax", root / "port"
    jexpr = JExperiment(str(jdir), JConfig.from_pars(dict(PARS)))
    jexpr.attach_subject(*SUBJECT)
    jexpr.prep_data()
    for m in ROUND0:
        jexpr.add_method(m)
    shutil.copytree(jdir, tdir)
    for m in ROUND0:
        jexpr.run_method(m, K)
    # the JAX package's directory after round 0, for the port to resume
    shutil.copytree(jdir, root / "resume")
    jexpr.run_method("entropy", 2 * K)
    yield root
    shutil.rmtree(root, ignore_errors=True)


def _jax_streams(monkeypatch):
    """The port's engine on the JAX package's streams and draws: its
    RngStream hands out JAX keys, which the injected draw functions take."""
    inject(monkeypatch)
    monkeypatch.setattr(pw_mod, "RngStream", JRngStream)


@pytest.mark.parametrize("method", ROUND0)
def test_round0_picks_match_jax(monkeypatch, jax_round0, method):
    _jax_streams(monkeypatch)
    texpr = PWExperiment(str(jax_round0 / "port"), device="cpu")
    texpr.attach_subject(*SUBJECT)
    texpr.run_method(method, K)
    got = _queries(jax_round0 / "port", method, 0)
    assert len(got) == (K if method != "fi" else len(np.unique(got)))
    np.testing.assert_array_equal(got, _queries(jax_round0 / "jax", method,
                                                0))


def test_jax_directory_resumed_by_the_port(jax_round0):
    """The JAX package's resume point after round 0 (weights, Adam state
    and the ``bn/`` running statistics): the port's round 1 picks what the
    uninterrupted JAX campaign picked."""
    texpr = PWExperiment(str(jax_round0 / "resume"), device="cpu")
    texpr.attach_subject(*SUBJECT)
    res = texpr.run_method("entropy", 2 * K)
    assert res["n_queries"] == 2 * K
    np.testing.assert_array_equal(_queries(jax_round0 / "resume", "entropy",
                                           1),
                                  _queries(jax_round0 / "jax", "entropy", 1))


class _DropResumeWrites:
    """The engine's ``save_checkpoint`` with the resume-point writes
    dropped: what a crash before they land leaves on disk."""

    def __enter__(self):
        self.orig = pw_mod.save_checkpoint
        self.dropped = 0

        def patched(path, *a, **kw):
            if os.path.basename(path) == "curr_weights.npz":
                self.dropped += 1
                return None
            return self.orig(path, *a, **kw)

        pw_mod.save_checkpoint = patched
        return self

    def __exit__(self, *exc):
        pw_mod.save_checkpoint = self.orig


def _start(root, method, **over):
    expr = PWExperiment(str(root), ExperimentConfig.from_pars(
        {**PARS, **over}), device="cpu")
    expr.attach_subject(*SUBJECT)
    expr.prep_data()
    expr.add_method(method)
    return expr


def _artifacts(root, method):
    mdir = os.path.join(str(root), method)
    qdir = os.path.join(mdir, "queries")
    queries = {f: open(os.path.join(qdir, f)).read()
               for f in sorted(os.listdir(qdir))}
    with open(os.path.join(mdir, "perf_evals.txt")) as f:
        evals = f.read()
    with np.load(os.path.join(mdir, "curr_weights.npz")) as z:
        entries = {k: z[k] for k in z.files}
    return queries, evals, entries


@pytest.fixture
def tmp_path(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_crash_resume_equals_continue(tmp_path):
    """3 rounds of fi under the mean teacher with int8 anchors every 2:
    the crashed run loses its resume-point writes, so the resumed process
    replays both finetunes (BN refreshes included) from the initial
    weights; its journal, evals and checkpoint (``bn/`` and ``teacher/``
    too) equal the uninterrupted run's bit for bit."""
    over = dict(ckpt_full_every=2, ckpt_dtype="int8", consistency_coeff=1.0)
    n = 3 * K
    _start(tmp_path / "a", "fi", **over).run_method("fi", n)
    ref = _artifacts(tmp_path / "a", "fi")
    assert any(k.startswith("bn/") for k in ref[2])
    assert any(k.startswith("teacher/") for k in ref[2])
    expr = _start(tmp_path / "b", "fi", **over)
    # fi may pick fewer than k in a round (its PMF draws repeat), so the
    # crashed run stops where the uninterrupted one stood after 2 rounds
    n2 = sum(len(_queries(tmp_path / "a", "fi", it)) for it in (0, 1))
    with _DropResumeWrites() as w:
        expr.run_method("fi", n2)
    assert w.dropped >= 1
    fresh = PWExperiment(str(tmp_path / "b"), device="cpu")
    fresh.attach_subject(*SUBJECT)
    fresh.run_method("fi", n)
    got = _artifacts(tmp_path / "b", "fi")
    assert got[0] == ref[0] and len(got[0]) >= 3
    assert got[1] == ref[1]
    assert sorted(got[2]) == sorted(ref[2])
    for k in ref[2]:
        np.testing.assert_array_equal(got[2][k], ref[2][k], err_msg=k)


@pytest.mark.parametrize("method", ["influence", "AU_4U"])
def test_full_gradient_methods_raise_on_a_dense_spec(tmp_path, method):
    expr = _start(tmp_path, method)
    with pytest.raises(NotImplementedError, match="patch-wise evaluator"):
        expr.run_method(method, K)


def test_ps_random_reads_the_configured_window(tmp_path):
    """ps-random's variance filter on the dense evaluator uses the
    configured patch's window, so it picks what the patch evaluator's
    ps-random picks on the same pool and stream."""
    expr = _start(tmp_path, "ps-random")
    spec = expr.build_model()
    model = pw_mod.init_cnn(spec, 0, device="cpu")
    dense = expr.make_evaluator(spec)
    assert isinstance(dense, FCNGridPoolEvaluator)
    patch = GridPoolEvaluator(
        spec, expr.padded(), *expr._stats_arrays(), (9, 9, 1), (24, 24, 8),
        grid_spacing=4)
    pool = pw_mod.load_inds(expr._p("init_pool_inds.txt"))
    picks = [tstrat.cnn_query(tstrat.QueryContext(
        spec=spec, params=model, evaluator=ev, pool_inds=pool, k=K,
        rng=np.random.default_rng(0), raw_volume=SUBJECT[0][0]),
        "ps-random") for ev in (dense, patch)]
    assert len(picks[0]) == K
    np.testing.assert_array_equal(picks[0], picks[1])


def test_committee_members_leave_the_main_bn_state(tmp_path):
    """QBC-JS members finetune copies (their BN refresh moves their own
    state); the main model's running statistics, which the evaluator
    scores the members on, are untouched."""
    expr = _start(tmp_path, "QBC-JS", n_ensemble=2)
    spec = expr.build_model()
    params, bn, _, _ = pw_mod.load_checkpoint(
        os.path.join(str(tmp_path), "QBC-JS", "curr_weights.npz"))
    state = pw_mod.init_train_state(expr._load_model(spec, params), "Adam",
                                    1e-3)
    state.bn_state = pw_mod.bn_state_to_port(bn, "cpu")
    before = {l: {k: v.clone() for k, v in d.items()}
              for l, d in state.bn_state.items()}
    pool = pw_mod.load_inds(expr._p("init_pool_inds.txt"))
    members = expr._build_committee(spec, state, pool[:6], 1)
    assert len(members) == 2
    for layer, d in before.items():
        for k, v in d.items():
            assert torch.equal(state.bn_state[layer][k], v)
