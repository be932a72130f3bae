"""The multi-subject engine's dense-model path vs the JAX package's on the
CPU: the small FC-DenseNet-103 over two training subjects of different
slice shapes (24x24 and 21x21, so the finetune trains two shape groups),
a 20x20 test subject and a held subject for core-set's bootstrap.  Held:
round 0's picks of entropy, fi (the dense multi-subject branch),
core-set (the held subject's features on batch statistics, K1's plain
version), BALD, BADGE and rep-entropy equal the JAX package's; one finetune over both shape groups
(``g0-`` / ``g1-`` streams, a BN refresh per group), plain and under the
mean teacher, with SGD and JAX's streams and draws, equals the JAX
package's within 1e-5 (parameters, teacher and BN state); every pool and
test evaluator scores on the engine's BN state (``_bn_sync``); crash-resume
== continue bit for bit with int8 anchors; influence and AU_4U raise."""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from nnal_tpu.core.config import ExperimentConfig as JConfig
from nnal_tpu.core.rng import RngStream as JRngStream
from nnal_tpu.data.io import synthetic_subject
from nnal_tpu.engine.multi_experiment import MultiImgExperiment as JMulti
from nnal_tpu.models.checkpoint import load_checkpoint as j_load
from nnal_tpu.models.train import init_train_state as j_init_train_state
from nnal_tpu_torch.core.config import ExperimentConfig
from nnal_tpu_torch.engine import multi_experiment as tmulti
from nnal_tpu_torch.models.bridge import bn_state_to_jax, to_jax_params
from nnal_tpu_torch.scoring.fcn_eval import FCNGridPoolEvaluator
from torch_jax_draws import inject

torch.set_num_threads(1)

K = 4
TRAIN = [synthetic_subject(shape=(24, 24, 8), n_modalities=2, seed=0),
         synthetic_subject(shape=(21, 21, 8), n_modalities=2, seed=1)]
TEST = [synthetic_subject(shape=(20, 20, 8), n_modalities=2, seed=5)]
HELD = [synthetic_subject(shape=(20, 20, 8), n_modalities=2, seed=6)]
PARS = {"model_name": "Tiramisu", "nclass": 2, "patch_shape": (9, 9, 1),
        "grid_spacing": 4, "k": K, "B": 16, "ntb": 256, "b": 4,
        "epochs": 2, "MC_iters": 2, "learning_rate": 1e-3,
        "optimizer_name": "Adam", "dropout_rate": 0.1,
        "bootstrap_spacing": 4, "seed": 3, "diag_load": 0.1,
        "model_kwargs": {"growth": 4, "depths": [2, 2]}}
ROUND0 = ["entropy", "fi", "core-set", "BALD", "BADGE", "rep-entropy"]


def _jax(root, **over):
    expr = JMulti(str(root), JConfig.from_pars({**PARS, **over}))
    expr.attach_subjects(TRAIN, TEST, HELD)
    return expr


def _port(root, config=True, **over):
    cfg = ExperimentConfig.from_pars({**PARS, **over}) if config else None
    expr = tmulti.MultiImgExperiment(str(root), cfg, device="cpu")
    expr.attach_subjects(TRAIN, TEST, HELD)
    return expr


def _qmat(root, method, it):
    return np.loadtxt(os.path.join(str(root), method, "queries",
                                   f"{it}.txt"), dtype=np.int64)


def _jax_streams(monkeypatch):
    inject(monkeypatch)
    monkeypatch.setattr(tmulti, "RngStream", JRngStream)


@pytest.fixture(scope="module")
def jax_round0(tmp_path_factory):
    root = tmp_path_factory.mktemp("dense_multi")
    # round 0's picks come before any finetune: epochs 0 skips the
    # finetune after them in both packages (and the JAX scan's compile)
    jexpr = _jax(root / "jax", epochs=0)
    jexpr.prep_data()
    for m in ROUND0:
        jexpr.add_method(m)
    shutil.copytree(root / "jax", root / "port")
    for m in ROUND0:
        jexpr.run_method(m, K)
    yield root
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("method", ROUND0)
def test_round0_picks_match_jax(monkeypatch, jax_round0, method):
    _jax_streams(monkeypatch)
    texpr = _port(jax_round0 / "port", config=False)
    texpr.run_method(method, K)
    want = _qmat(jax_round0 / "jax", method, 0)
    got = _qmat(jax_round0 / "port", method, 0)
    assert got.shape[0] == 2
    np.testing.assert_array_equal(got, want)


@pytest.fixture
def tmp_path(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _labeled(expr):
    """A few labeled voxels of each subject, from its grid pool."""
    pools = [np.loadtxt(expr._p(f"pool_inds_{i}.txt"), dtype=np.int64)
             for i in range(2)]
    return [pools[0][[3, 40, 77, 120, 200]], pools[1][[5, 9, 150]]]


def _close_tree(got, want, atol, what):
    for layer in want:
        for k in want[layer]:
            np.testing.assert_allclose(
                np.asarray(got[layer][k]), np.asarray(want[layer][k]),
                rtol=0, atol=atol, err_msg=f"{what}{layer}/{k}")


@pytest.mark.parametrize("mt", [False, True])
def test_shape_group_finetune_matches_jax(monkeypatch, tmp_path, mt):
    over = dict(optimizer_name="SGD", learning_rate=0.05,
                **({"consistency_coeff": 1.0, "unlabeled_batch": 2}
                   if mt else {}))
    jexpr = _jax(tmp_path / "jax", **over)
    jexpr.prep_data()
    jexpr.add_method("entropy")
    spec = jexpr.build_model()
    params, bn, _, _ = j_load(str(tmp_path / "jax" / "entropy" /
                                  "curr_weights.npz"))
    jstate, tx = j_init_train_state(spec, jax.tree_util.tree_map(
        jax.numpy.asarray, params), "SGD", 0.05, bn_state=bn)
    per = _labeled(jexpr)
    jstate = jexpr.finetune_multimg(spec, jstate, tx, per)

    _jax_streams(monkeypatch)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    texpr = _port(tmp_path / "port", config=False)
    tspec = texpr.build_model()
    p, b, _, _ = tmulti.load_checkpoint(str(tmp_path / "port" / "entropy" /
                                            "curr_weights.npz"))
    state = tmulti.init_train_state(texpr._load_model(tspec, p), "SGD", 0.05)
    state.bn_state = tmulti.bn_state_to_port(b, "cpu")
    state = texpr.finetune_multimg(state, per)
    assert state.step == jstate.step
    _close_tree(to_jax_params(state.model.state_dict()), jstate.params,
                1e-5, "params ")
    want_bn = jax.tree_util.tree_map(np.asarray, jstate.bn_state)
    got_bn = bn_state_to_jax(state.bn_state)
    for layer in want_bn:
        for k in ("mean", "var"):
            w = want_bn[layer][k]
            np.testing.assert_allclose(got_bn[layer][k], w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max())
    if mt:
        _close_tree(to_jax_params(state.teacher.state_dict()),
                    jstate.teacher_params, 1e-5, "teacher ")


def test_every_evaluator_scores_on_the_engine_bn_state(tmp_path):
    expr = _port(tmp_path)
    expr.prep_data()
    expr.add_method("entropy")
    expr.run_method("entropy", 2 * K)
    _, bn, _, _ = tmulti.load_checkpoint(
        str(tmp_path / "entropy" / "curr_weights.npz"))
    assert expr._test_evs and all(isinstance(ev, FCNGridPoolEvaluator)
                                  for ev in expr._test_evs)
    for ev in expr._test_evs:
        assert ev.bn_state is expr._bn_sync
    for layer, d in bn_state_to_jax(expr._bn_sync).items():
        for k, v in d.items():
            np.testing.assert_array_equal(v, bn[layer][k])


class _DropResumeWrites:
    def __enter__(self):
        self.orig = tmulti.save_checkpoint
        self.dropped = 0

        def patched(path, *a, **kw):
            if os.path.basename(path) == "curr_weights.npz":
                self.dropped += 1
                return None
            return self.orig(path, *a, **kw)

        tmulti.save_checkpoint = patched
        return self

    def __exit__(self, *exc):
        tmulti.save_checkpoint = self.orig


def _artifacts(root, method):
    mdir = os.path.join(str(root), method)
    qdir = os.path.join(mdir, "queries")
    out = {f: open(os.path.join(qdir, f)).read()
           for f in sorted(os.listdir(qdir))}
    with np.load(os.path.join(mdir, "curr_weights.npz")) as z:
        entries = {k: z[k] for k in z.files}
    return out, entries


def test_crash_resume_equals_continue(tmp_path):
    """3 rounds of fi with int8 anchors every 2 over both shape groups:
    the crashed run loses its resume-point writes; the resumed process
    replays the finetunes (two groups, two BN refreshes each) and ends
    bit for bit where the uninterrupted run did."""
    over = dict(ckpt_full_every=2, ckpt_dtype="int8", hist_every=0)
    n = 3 * K
    a = _port(tmp_path / "a", **over)
    a.prep_data()
    a.add_method("fi")
    a.run_method("fi", n)
    ref = _artifacts(tmp_path / "a", "fi")
    assert any(k.startswith("bn/") for k in ref[1])
    b = _port(tmp_path / "b", **over)
    b.prep_data()
    b.add_method("fi")
    # fi may pick fewer than k in a round (its PMF draws repeat), so the
    # crashed run stops where the uninterrupted one stood after 2 rounds
    n2 = sum(_qmat(tmp_path / "a", "fi", it).reshape(2, -1).shape[1]
             for it in (0, 1))
    with _DropResumeWrites() as w:
        b.run_method("fi", n2)
    assert w.dropped >= 1
    _port(tmp_path / "b", config=False).run_method("fi", n)
    got = _artifacts(tmp_path / "b", "fi")
    assert got[0] == ref[0]
    assert sorted(got[1]) == sorted(ref[1])
    for k in ref[1]:
        np.testing.assert_array_equal(got[1][k], ref[1][k], err_msg=k)


@pytest.mark.parametrize("method", ["influence", "AU_4U"])
def test_full_gradient_methods_raise_on_a_dense_spec(tmp_path, method):
    expr = _port(tmp_path)
    expr.prep_data()
    expr.add_method(method)
    with pytest.raises(NotImplementedError, match="patch-wise evaluator"):
        expr.run_method(method, K)
