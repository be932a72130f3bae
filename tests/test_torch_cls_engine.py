"""The classification engine (``engine/experiment.Experiment`` through
``cli/run_querying.run_classification_al``) vs the JAX package's, on the
CPU.  Held: 2-round campaigns of entropy, core-set, QBC-JS (2 members)
and influence (CG) in both packages, from one JAX-written run (PW at
8x8x1, two classes, plain SGD, dropout 0.3; the port's engine on the JAX
package's streams with JAX's draws injected) write identical
``queries/``, ``accs.txt`` and ``predicts.txt``; ``eval_run`` (accuracy
and example-based PR) reads them as the JAX package's does; crash-resume
== continue bit for bit on the 2-block DenseNet (batch norm, Adam,
anchors every 2 rounds); the ``data_parallel`` warning; the missing-CUDA
error; ``import_keras_vgg_weights`` on an h5 file the test writes; the
image pools; and ``softmax_harness.run_comparison``.  Each test deletes
its checkpoints as soon as it has read them."""

import os
import shutil
import warnings

import numpy as np
import pytest
import torch

from nnal_tpu.cli import run_querying as j_rq
from nnal_tpu.cli import softmax_harness as j_harness
from nnal_tpu.core.config import ExperimentConfig as JConfig
from nnal_tpu.core.rng import RngStream as JRngStream
from nnal_tpu.data import image_pool as j_pool
from nnal_tpu.engine.experiment import Experiment as JExperiment
from nnal_tpu.models import surgery as j_surgery
from nnal_tpu_torch.cli import run_querying as t_rq
from nnal_tpu_torch.cli import softmax_harness as t_harness
from nnal_tpu_torch.core.config import ExperimentConfig
from nnal_tpu_torch.data import image_pool as t_pool
from nnal_tpu_torch.engine import experiment as exp_mod
from nnal_tpu_torch.engine.experiment import Experiment
from nnal_tpu_torch.models import surgery as t_surgery
from nnal_tpu_torch.models.bridge import from_jax_params, to_jax_params
from nnal_tpu_torch.models.cnn import CNN, init_cnn
from nnal_tpu_torch.models.specs import create_model
from torch_jax_draws import inject

torch.set_num_threads(1)

K = 4
PARS = {"model_name": "PW", "nclass": 2, "k": K, "B": 16, "ntb": 32,
        "b": 8, "epochs": 1, "learning_rate": 0.01, "optimizer_name": "SGD",
        "dropout_rate": 0.3, "init_size": 8, "test_ratio": 0.25,
        "MC_iters": 2, "n_ensemble": 2, "seed": 3}
OVERRIDES = ",".join(f"{k}={v}" for k, v in PARS.items())
METHODS = ["entropy", "core-set", "QBC-JS", "influence"]


def _data(n=60, shape=(8, 8, 1), seed=1):
    """Two classes of images, shifted apart (the JAX tests' data)."""
    rng = np.random.default_rng(seed)
    h = n // 2
    X = np.concatenate([rng.normal(size=(h,) + shape) - 1.0,
                        rng.normal(size=(n - h,) + shape) + 1.0]
                       ).astype(np.float32)
    y = np.repeat([0, 1], [h, n - h])
    perm = rng.permutation(n)
    return X[perm], y[perm]


def _texts(mdir):
    out = {}
    for f in ("accs.txt", "predicts.txt"):
        with open(os.path.join(mdir, f)) as fh:
            out[f] = fh.read()
    qdir = os.path.join(mdir, "queries")
    out.update({f"queries/{f}": open(os.path.join(qdir, f)).read()
                for f in sorted(os.listdir(qdir))})
    return out


def _drop_npz(root):
    for d, _, files in os.walk(str(root)):
        for f in files:
            if f.endswith(".npz") and f != "init_weights.npz":
                os.remove(os.path.join(d, f))


@pytest.fixture(scope="module")
def campaigns(tmp_path_factory):
    """One JAX-written run, hard-linked into the port's root; then each
    method's 2-round campaign in the JAX package and in the port (its
    engine on JAX's streams and draws); their checkpoints are deleted
    as soon as each campaign ends."""
    top = tmp_path_factory.mktemp("cls_engine")
    jdir, tdir = top / "jax", top / "port"
    X, y = _data()
    pool = j_pool.InMemoryPool(X, y)
    try:
        jexpr = JExperiment(str(jdir), JConfig.from_pars(dict(PARS)))
        jexpr.attach_pool(pool)
        jexpr.add_run()
        shutil.copytree(jdir, tdir, copy_function=os.link)
        mp = pytest.MonkeyPatch()
        out = {}
        for m in METHODS:
            jres = j_rq.run_classification_al(str(jdir), pool, [m], 2 * K)
            _drop_npz(jdir)
            with mp.context() as c:
                inject(c)
                c.setattr(exp_mod, "RngStream", JRngStream)
                tres = t_rq.run_classification_al(
                    str(tdir), t_pool.InMemoryPool(X, y), [m], 2 * K,
                    device="cpu")
            _drop_npz(tdir)
            out[m] = (jres[m], tres[m])
        yield top, X, y, out
    finally:
        shutil.rmtree(top, ignore_errors=True)


@pytest.mark.parametrize("method", METHODS)
def test_campaign_matches_jax(campaigns, method):
    top, _, _, out = campaigns
    jaccs, taccs = out[method]
    assert len(taccs) == 2
    np.testing.assert_array_equal(taccs, jaccs)
    got = _texts(top / "port" / "0" / method)
    want = _texts(top / "jax" / "0" / method)
    assert sorted(got) == sorted(want)
    for f in want:
        assert got[f] == want[f], f"{method}: {f} differs"


@pytest.mark.parametrize("eval_method", ["accuracy", "PR"])
def test_eval_run_matches_jax(campaigns, eval_method):
    top, X, y, _ = campaigns
    jexpr = JExperiment(str(top / "jax"))
    jexpr.attach_data(X, y)
    texpr = Experiment(str(top / "port"), device="cpu")
    texpr.attach_data(X, y)
    want = jexpr.eval_run(0, eval_method, save=False)
    got = texpr.eval_run(0, eval_method, save=False)
    assert sorted(got) == sorted(want) == sorted(METHODS)
    for m in METHODS:
        assert got[m].shape == ((2,) if eval_method == "accuracy"
                                else (2, 2))
        np.testing.assert_array_equal(got[m], want[m])
    assert texpr.read_queries("entropy", 0) == [K, K]
    assert texpr.get_runs() == ["0"]


def test_summarize_and_visualize(campaigns):
    top, X, y, _ = campaigns
    texpr = Experiment(str(top / "port"), device="cpu")
    texpr.attach_data(X, y)
    s = texpr.summarize_all(METHODS)
    np.testing.assert_array_equal(s["entropy"], texpr.read_run(0, "entropy"))
    with pytest.raises(NotImplementedError, match="item 11"):
        texpr.visualize_run(0, METHODS, str(top / "curves.png"))


DENSE = {**PARS, "model_name": "DenseNet", "nclass": 3,
         "optimizer_name": "Adam", "learning_rate": 1e-3, "b": 6,
         "dropout_rate": 0.2, "ckpt_full_every": 2, "test_ratio": 0.2}


class _DropResumeWrites:
    """The engine's ``save_checkpoint`` with the resume-point writes
    dropped: what a crash before they land leaves on disk."""

    def __enter__(self):
        self.orig = exp_mod.save_checkpoint
        self.dropped = 0

        def patched(path, *a, **kw):
            if os.path.basename(path) == "curr_weights.npz":
                self.dropped += 1
                return None
            return self.orig(path, *a, **kw)

        exp_mod.save_checkpoint = patched
        return self

    def __exit__(self, *exc):
        exp_mod.save_checkpoint = self.orig


def _dense_start(root, X, y):
    expr = Experiment(str(root), ExperimentConfig.from_pars(dict(DENSE)),
                      device="cpu")
    expr.attach_data(X, y)
    run = expr.add_run()
    expr.add_method("entropy", run)
    return expr


def _artifacts(root):
    mdir = os.path.join(str(root), "0", "entropy")
    with np.load(os.path.join(mdir, "curr_weights.npz")) as z:
        entries = {k: z[k] for k in z.files}
    return _texts(mdir), entries


@pytest.fixture
def tmp_path(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_crash_resume_equals_continue(tmp_path):
    """3 rounds of entropy on the DenseNet (BN state, Adam moments),
    anchors every 2 rounds: the crashed run loses its resume-point
    writes, so the resumed process replays both retrains (and their BN
    refreshes) from the initial weights; queries, accuracies,
    predictions and the checkpoint equal the uninterrupted run's."""
    X, y = _data(n=50, shape=(16, 16, 3), seed=2)
    y = y + (X[:, 0, 0, 0] > 1.0)              # three classes
    _dense_start(tmp_path / "a", X, y).run_method("entropy", 0, 3 * K)
    ref = _artifacts(tmp_path / "a")
    shutil.rmtree(tmp_path / "a")
    assert any(k.startswith("bn/") for k in ref[1])
    assert any(k.startswith("opt/") for k in ref[1])
    expr = _dense_start(tmp_path / "b", X, y)
    with _DropResumeWrites() as w:
        expr.run_method("entropy", 0, 2 * K)
    assert w.dropped >= 1
    fresh = Experiment(str(tmp_path / "b"), device="cpu")
    fresh.attach_data(X, y)
    res = fresh.run_method("entropy", 0, 3 * K)
    assert res["n_queries"] == 3 * K
    got = _artifacts(tmp_path / "b")
    assert got[0] == ref[0] and len(got[0]) == 5
    assert sorted(got[1]) == sorted(ref[1])
    for k in ref[1]:
        np.testing.assert_array_equal(got[1][k], ref[1][k], err_msg=k)


def test_data_parallel_warns_and_cuda_is_the_default(tmp_path,
                                                     monkeypatch):
    cfg = ExperimentConfig.from_pars({**PARS, "data_parallel": 2})
    with pytest.warns(UserWarning, match="data_parallel"):
        Experiment(str(tmp_path / "dp"), cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _data()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        t_rq.run_classification_al(str(tmp_path / "c"),
                                   t_pool.InMemoryPool(X, y), ["random"],
                                   K, OVERRIDES)
    assert not os.path.exists(tmp_path / "c")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Experiment(str(tmp_path / "d"), cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        t_harness.run_comparison(X.reshape(len(y), -1), y, 2, rounds=1)
    assert t_rq.main([]) == 1


def test_filter_classes_matches_jax():
    labels = np.array([3, 1, 4, 1, 5, 9, 2, 6, 5, 3])
    for want, got in zip(j_rq.filter_classes(labels, [5, 1, 3]),
                         t_rq.filter_classes(labels, [5, 1, 3])):
        np.testing.assert_array_equal(got, want)
    assert t_rq.DEFAULT_CLS_PARS == j_rq.DEFAULT_CLS_PARS


def test_image_pools_match_jax(tmp_path):
    """``ImagePathPool`` over files written here, and ``LazyPoolView``,
    against the JAX package's."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    paths, labels = [], []
    for i in range(6):
        p = str(tmp_path / f"im{i}.png")
        cv2.imwrite(p, rng.integers(0, 255, size=(12, 10, 3),
                                    dtype=np.uint8))
        paths.append(p)
        labels.append(i % 3)
    pfile, lfile = t_pool.write_path_pool(str(tmp_path), paths, labels)
    tp = t_pool.ImagePathPool(pfile, lfile, (9, 9), mean=10.0)
    jp = j_pool.ImagePathPool(pfile, lfile, (9, 9), mean=10.0)
    assert len(tp) == 6 and tp.input_shape == jp.input_shape == (9, 9, 3)
    for a, b in zip(tp.fetch([4, 0, 2]), jp.fetch([4, 0, 2])):
        np.testing.assert_array_equal(a, b)
    view = t_pool.LazyPoolView(tp, [5, 1, 3])
    assert view.shape == (3, 9, 9, 3) and len(view) == 3
    np.testing.assert_array_equal(view[1:], jp.fetch([1, 3])[0])
    folders = tmp_path / "folders"
    for c in ("b", "a"):
        os.makedirs(folders / c)
        cv2.imwrite(str(folders / c / "x.png"), np.zeros((4, 4, 3),
                                                         np.uint8))
    got = t_pool.folder_class_paths(str(folders))
    want = j_pool.folder_class_paths(str(folders))
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


def test_import_keras_vgg_weights(tmp_path):
    """An h5 file of Keras-named groups (a conv kernel in HWIO, one dense
    kernel stored (in, out) and one transposed), imported into the VGG19
    tree as the JAX package imports it, then bridged into the port's
    module."""
    h5py = pytest.importorskip("h5py")
    spec = create_model("VGG19", nclass=5, dropout_rate=0.0,
                        input_shape=(32, 32, 3))
    model = init_cnn(spec, 0, device="cpu")
    template = to_jax_params(model.state_dict())
    rng = np.random.default_rng(4)
    new = {"conv1": rng.normal(size=(3, 3, 3, 64)),
           "fc2": rng.normal(size=(4096, 4096)),
           "fc3": rng.normal(size=(4096, 5))}
    path = str(tmp_path / "vgg.h5")
    with h5py.File(path, "w") as f:
        for name, W in new.items():
            g = f.create_group(f"block_{name}")
            # fc3 is stored (out, in): the import transposes it
            g["kernel:0"] = (W.T if name == "fc3" else W).astype(np.float32)
            g["bias:0"] = rng.normal(size=W.shape[-1]).astype(np.float32)
    layer_map = {n: f"block_{n}" for n in new}
    got = t_surgery.import_keras_vgg_weights(path, template, layer_map)
    want = j_surgery.import_keras_vgg_weights(path, template, layer_map)
    os.remove(path)
    for layer in want:
        for k in want[layer]:
            np.testing.assert_array_equal(got[layer][k], want[layer][k])
    np.testing.assert_array_equal(got["fc3"]["W"], new["fc3"].astype(
        np.float32))
    np.testing.assert_array_equal(got["conv4"]["W"], template["conv4"]["W"])
    ported = CNN(spec)
    ported.load_state_dict(from_jax_params(got))
    back = to_jax_params(ported.state_dict())
    np.testing.assert_array_equal(back["conv1"]["W"], got["conv1"]["W"])


def test_softmax_harness_matches_jax():
    X, y = t_harness.synthetic_mnist(n_per_class=40, d=32, seed=1)
    jX, jy = j_harness.synthetic_mnist(n_per_class=40, d=32, seed=1)
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(y, jy)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = j_harness.run_comparison(X, y, 10, rounds=3, steps=100)
    got = t_harness.run_comparison(X, y, 10, rounds=3, steps=100,
                                   device="cpu")
    assert sorted(got) == sorted(want) == ["entropy", "fi", "random"]
    for m in want:
        np.testing.assert_array_equal(got[m], want[m])
