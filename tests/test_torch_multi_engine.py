"""The port's multi-subject engine against the JAX package's (CPU), on
two 20x20x6 training subjects, one test and one held subject (9x9x1
patches, PW1, SGD, dropout 0):

* ``finetune_multimg``: the concatenated labeled patches (the port
  gathers through K2's plain version, the JAX package on the host with
  its native C++ gather) and the parameters after one SGD finetune from
  the same weights;
* ``run_method`` from one JAX-written directory: round 0's picks of
  ``entropy`` and of ``core-set`` (bootstrapped from the held subject),
  and a two-round ``random`` campaign's whole journal;
* a JAX-written ``random`` campaign resumed by the port (state, Adam-free
  SGD weights, the (voxel, subject) journal) picks what JAX picks next;
* crash-resume == continue with int8 anchors every 3 rounds, and with a
  crash between the journal and the membership files;
* the ``hist_every`` / ``hist_dtype`` history copies, ``dt_<r>`` and the
  ``tail`` phase row; ``sequential_al`` with its warm start and resume
  guard; the keys the engine rejects.

Tolerances: patches within 1 ulp (the JAX host gather multiplies by
``1 / sd``, K2 divides); parameters within 1e-5; picks, journals and
resumed artifacts exactly equal.  Every test deletes the checkpoints it
wrote (~80 MB each) when it ends; the module fixture hard-links the
JAX directory's checkpoints into its copies
(``test_torch_parallel_engine.link_npz``) and deletes every checkpoint
once the campaigns have run (the tests read journals and results)."""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from nnal_tpu.core.config import ExperimentConfig as JConfig
from nnal_tpu.engine.multi_experiment import MultiImgExperiment as JMulti
from nnal_tpu.models import checkpoint as jck
from nnal_tpu.models.train import init_train_state as j_init_state
from nnal_tpu.runtime import native as jnative
from nnal_tpu_torch.core.config import ExperimentConfig
from nnal_tpu_torch.data.io import synthetic_subject
from nnal_tpu_torch.engine import multi_experiment as tmulti
from nnal_tpu_torch.engine.sequential import sequential_al
from nnal_tpu_torch.models.bridge import to_jax_params
from nnal_tpu_torch.models.checkpoint import load_checkpoint
from nnal_tpu_torch.models.train import init_train_state
from nnal_tpu_torch.parallel.grid_sharded import ShardedGridPoolEvaluator
from test_torch_parallel_engine import drop_npz, link_npz
from torch_jax_native import ensure_jax_native

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    """The JAX package's native patch gather loaded before its side
    runs: a load lost to a concurrent build would leave it on its
    fallback (``torch_jax_native``)."""
    ensure_jax_native("gather")


SHAPE = (20, 20, 6)
TRAIN = [synthetic_subject(shape=SHAPE, n_modalities=1, n_blobs=6, seed=s)
         for s in range(2)]
TEST = [synthetic_subject(shape=SHAPE, n_modalities=1, n_blobs=6, seed=7)]
HELD = [synthetic_subject(shape=SHAPE, n_modalities=1, n_blobs=6, seed=9)]
PARS = {"model_name": "PW", "nclass": 2, "patch_shape": (9, 9, 1),
        "grid_spacing": 4, "k": 3, "B": 12, "ntb": 256, "b": 16,
        "epochs": 1, "learning_rate": 1e-2, "optimizer_name": "SGD",
        "dropout_rate": 0.0, "bootstrap_spacing": 5, "seed": 5}


@pytest.fixture
def tmp_path(tmp_path):
    """Drop the checkpoints as soon as the test ends."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _drop_checkpoints(root):
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".npz") and f != "init_weights.npz":
                os.remove(os.path.join(dirpath, f))


def _jax(root, **over):
    expr = JMulti(str(root), JConfig.from_pars({**PARS, **over}))
    expr.attach_subjects(TRAIN, TEST, HELD)
    return expr


def _port(root, config=True, **over):
    cfg = ExperimentConfig.from_pars({**PARS, **over}) if config else None
    expr = tmulti.MultiImgExperiment(str(root), cfg, device="cpu")
    expr.attach_subjects(TRAIN, TEST, HELD)
    return expr


def _journal(root, method):
    qdir = os.path.join(str(root), method, "queries")
    out = {f: open(os.path.join(qdir, f)).read()
           for f in sorted(os.listdir(qdir))}
    for f in ("curr_train_inds.txt", "curr_pool_inds.txt"):
        out[f] = open(os.path.join(str(root), method, f)).read()
    return out


def test_finetune_patches_and_sgd_step_match_jax(tmp_path, monkeypatch):
    jexpr = _jax(tmp_path / "jax")
    jexpr.prep_data()
    jexpr.add_method("entropy")
    pools = [np.loadtxt(tmp_path / "jax" / f"pool_inds_{i}.txt",
                        dtype=np.int64) for i in range(2)]
    per_subject = [pools[0][::5], pools[1][2::7]]
    jp = jck.load_checkpoint(str(tmp_path / "jax" / "entropy" /
                                 "curr_weights.npz"))[0]

    seen = {"jax": [], "port": []}
    jgather = jnative.gather_patches_native

    def jspy(*a, **kw):
        seen["jax"].append(jgather(*a, **kw))
        return seen["jax"][-1]

    monkeypatch.setattr(jnative, "gather_patches_native", jspy)
    tsteps = tmulti.finetune_steps

    def tspy(state, x_all, *a, **kw):
        seen["port"].append(x_all.numpy().copy())
        return tsteps(state, x_all, *a, **kw)

    monkeypatch.setattr(tmulti, "finetune_steps", tspy)

    spec = jexpr.build_model()
    jstate, jtx = j_init_state(
        spec, jax.tree_util.tree_map(jax.numpy.asarray, jp), "SGD", 1e-2)
    jstate = jexpr.finetune_multimg(spec, jstate, jtx, per_subject)

    texpr = _port(tmp_path / "jax", config=False)
    model = texpr._load_model(texpr.build_model(), jp)
    state = texpr.finetune_multimg(init_train_state(model, "SGD", 1e-2),
                                   per_subject)
    want = np.concatenate(seen["jax"])
    got, = seen["port"]
    assert got.shape == want.shape == (len(per_subject[0])
                                       + len(per_subject[1]), 9, 9, 1)
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(np.abs(got - want) <= ulp)
    assert state.step == jstate.step
    params = to_jax_params(state.model.state_dict())
    for layer in params:
        for k in ("W", "b"):
            np.testing.assert_allclose(params[layer][k],
                                       np.asarray(jstate.params[layer][k]),
                                       rtol=0, atol=1e-5,
                                       err_msg=f"{layer}/{k}")


@pytest.fixture(scope="module")
def campaigns(tmp_path_factory):
    """One JAX-written directory, copied for the port before any run;
    entropy and core-set run one round in each package, random two, then
    a copy of JAX's random state is resumed by the port while JAX runs a
    third round itself."""
    top = tmp_path_factory.mktemp("multi")
    jdir, tdir, rdir = top / "jax", top / "port", top / "resumed"
    try:
        jexpr = _jax(jdir)
        jexpr.prep_data()
        for m in ("entropy", "core-set", "random"):
            jexpr.add_method(m)
        shutil.copytree(jdir, tdir, copy_function=link_npz)
        texpr = _port(tdir, config=False)
        out = {}
        for m, n in (("entropy", 3), ("core-set", 3), ("random", 6)):
            out[("jax", m)] = jexpr.run_method(m, n)
            out[("port", m)] = texpr.run_method(m, n)
            if m != "random":
                _drop_checkpoints(jdir / m)
                _drop_checkpoints(tdir / m)
        drop_npz(tdir)
        shutil.copytree(jdir, rdir, copy_function=link_npz)
        out[("jax", "random+")] = jexpr.run_method("random", 9)
        out[("port", "random+")] = _port(rdir, config=False).run_method(
            "random", 9)
        drop_npz(top)
        yield jdir, tdir, rdir, out
    finally:
        shutil.rmtree(top, ignore_errors=True)


@pytest.mark.parametrize("method", ["entropy", "core-set"])
def test_round0_picks_match_jax(campaigns, method):
    jdir, tdir, _, out = campaigns
    assert _journal(tdir, method) == _journal(jdir, method)
    q = np.loadtxt(tdir / method / "queries" / "0.txt", dtype=np.int64,
                   ndmin=2)
    assert q.shape == (2, 3) and set(q[1]) <= {0, 1}
    assert out[("port", method)]["n_queries"] == 3
    assert np.isfinite(out[("port", method)]["perf"]).all()


def test_random_journal_and_jax_resume_match(campaigns):
    jdir, tdir, rdir, out = campaigns
    # the port's own two rounds: picks from the host streams alone
    port2 = _journal(tdir, "random")
    assert len([f for f in port2 if f.endswith(".txt")
                and f[0].isdigit()]) == 2
    # the JAX directory resumed by the port: its third round picks what
    # JAX picks (state.json, the journal and the weights are JAX's)
    assert _journal(rdir, "random") == _journal(jdir, "random")
    assert "2.txt" in _journal(rdir, "random")
    res = out[("port", "random+")]
    assert res["n_queries"] == 9
    assert not set(res["train_global"]) & set(res["pool_global"])
    for f in ("0.txt", "1.txt"):
        assert port2[f] == _journal(jdir, "random")[f]
    np.testing.assert_allclose(out[("port", "random+")]["perf"],
                               out[("jax", "random+")]["perf"], atol=0.05)


def _weights(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


class _DropWrites:
    """The engine's ``save_checkpoint`` with the resume-point writes
    dropped: what a crash before they land leaves on disk."""

    def __init__(self, monkeypatch):
        self.dropped = 0
        orig = tmulti.save_checkpoint

        def patched(path, *a, **kw):
            if os.path.basename(path) == "curr_weights.npz":
                self.dropped += 1
                return None
            return orig(path, *a, **kw)

        monkeypatch.setattr(tmulti, "save_checkpoint", patched)
        self.undo = lambda: monkeypatch.setattr(tmulti, "save_checkpoint",
                                                orig)


@pytest.mark.parametrize("method", ["random", "entropy"])
def test_crash_resume_equals_continue_int8(tmp_path, monkeypatch, method):
    over = dict(ckpt_full_every=3, ckpt_dtype="int8", hist_every=0,
                optimizer_name="Adam", learning_rate=1e-3)
    a = _port(tmp_path / "a", **over)
    a.prep_data()
    a.add_method(method)
    a.run_method(method, 12)
    ref = _journal(tmp_path / "a", method), _weights(
        tmp_path / "a" / method / "curr_weights.npz")
    shutil.rmtree(tmp_path / "a")
    b = _port(tmp_path / "b", **over)
    b.prep_data()
    b.add_method(method)
    drop = _DropWrites(monkeypatch)
    b.run_method(method, 9)
    drop.undo()
    assert drop.dropped == 1          # the round-3 anchor never landed
    # and a crash between the journal and the membership files: the last
    # round's queries are missing from the membership
    q3 = np.loadtxt(tmp_path / "b" / method / "queries" / "2.txt",
                    dtype=np.int64, ndmin=2)
    train = np.loadtxt(tmp_path / "b" / method / "curr_train_inds.txt",
                       dtype=np.int64)
    pool = np.loadtxt(tmp_path / "b" / method / "curr_pool_inds.txt",
                      dtype=np.int64)
    np.savetxt(tmp_path / "b" / method / "curr_train_inds.txt",
               train[:-q3.shape[1]], fmt="%d")
    np.savetxt(tmp_path / "b" / method / "curr_pool_inds.txt",
               np.sort(np.concatenate([pool, train[-q3.shape[1]:]])),
               fmt="%d")
    res = _port(tmp_path / "b", config=False).run_method(method, 12)
    assert res["n_queries"] == 12
    got = _journal(tmp_path / "b", method), _weights(
        tmp_path / "b" / method / "curr_weights.npz")
    assert got[0] == ref[0] and "3.txt" in got[0]
    assert sorted(got[1]) == sorted(ref[1])
    assert any(k.endswith("@i8") for k in got[1])
    for k in ref[1]:
        np.testing.assert_array_equal(got[1][k], ref[1][k], err_msg=k)


@pytest.mark.parametrize("hd", ["float16", "bfloat16"])
def test_history_copies_and_round_records(tmp_path, hd):
    expr = _port(tmp_path, hist_every=2, hist_dtype=hd, ckpt_full_every=2)
    expr.prep_data()
    j = expr.add_method("random")
    res = expr.run_method("random", 9)
    assert res["n_queries"] == 9 and len(res["perf"]) == 3
    files = sorted(f for f in os.listdir(j.dir) if f.endswith(".npz"))
    assert files == ["curr_weights.npz", "curr_weights_2.npz"]
    with np.load(j.path("curr_weights_2.npz")) as z:
        want = np.float16 if hd == "float16" else np.uint16
        assert all(z[k].dtype == want for k in z.files)
        assert all(k.endswith("@bf16") == (hd == "bfloat16")
                   for k in z.files)
    # both packages' loaders read the history copy
    hist = load_checkpoint(j.path("curr_weights_2.npz"))[0]
    jhist = jck.load_checkpoint(j.path("curr_weights_2.npz"))[0]
    for layer in hist:
        np.testing.assert_array_equal(hist[layer]["W"],
                                      np.asarray(jhist[layer]["W"]))
    # the resume point stays f32, written at the loop's end (round 3)
    params, _, _, al = load_checkpoint(j.path("curr_weights.npz"))
    assert al["round"] == 3 and params["fc1"]["W"].dtype == np.float32
    times = sorted(os.listdir(tmp_path / "AL_running_times"))
    assert times == ["dt_0", "dt_1", "dt_2"]
    with open(j.path("phases.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r.get("tail", False) for r in rows] == [False] * 3 + [True]
    assert all({"score_select", "train", "eval", "checkpoint"} <= set(r)
               for r in rows[:3])


def test_sequential_al_warm_starts_and_resumes(tmp_path):
    cfg = ExperimentConfig.from_pars({**PARS, "init_size": 4})
    res = sequential_al(str(tmp_path), TRAIN, "random", 3, cfg,
                        device="cpu")
    assert [r["n_queries"] for r in res] == [3, 3]
    steps = [load_checkpoint(str(tmp_path / f"subject_{i}" / "random" /
                                 "curr_weights.npz"))[3]["step"]
             for i in range(2)]
    # subject 1 started from subject 0's final state (its step count)
    assert steps[1] > steps[0] > 0
    journals = [_journal(tmp_path / f"subject_{i}", "random")
                for i in range(2)]
    # re-invoked after completion: nothing is reset or re-queried
    again = sequential_al(str(tmp_path), TRAIN, "random", 3, cfg,
                          device="cpu")
    assert [r["n_queries"] for r in again] == [3, 3]
    assert [_journal(tmp_path / f"subject_{i}", "random")
            for i in range(2)] == journals


@pytest.mark.parametrize("over,exc,key", [
    ({"hist_dtype": "int8"}, ValueError, "unsupported hist_dtype"),
])
def test_unsupported_keys_raise(tmp_path, over, exc, key):
    with pytest.raises(exc, match=key):
        _port(tmp_path, **over)


def test_data_parallel_shards_every_grid_evaluator(tmp_path):
    """``data_parallel`` 2 (rejected before the multi-device slice): the
    train, test and held subjects' evaluators are z-sharded over
    ``cached_mesh(2)`` (``tests/test_torch_parallel_multi.py`` runs the
    campaigns)."""
    expr = _port(tmp_path, data_parallel=2)
    expr.prep_data()
    spec = expr.build_model()
    for kind in ("train", "test"):
        evs = expr._evaluators(spec, kind, expr._stats(kind))
        assert len(evs) == len(expr._subjects(kind))
        assert all(isinstance(e, ShardedGridPoolEvaluator)
                   and e.mesh.shape["data"] == 2 for e in evs)


def test_entry_point_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tmulti.MultiImgExperiment(str(tmp_path),
                                  ExperimentConfig.from_pars(PARS))
