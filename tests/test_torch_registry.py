"""The validation registries (``evaluation/registry.py``), the
step-bounded loops ``models/train.train`` / ``validated_train``,
``engine/analysis.test_scores_matrix`` and ``evaluation/visualize`` against
the JAX package's on the CPU.

* ``eval_metrics``: accuracy and F1 equal, the loss within 1e-5 relative.
* ``train`` / ``validated_train`` (PW1 9x9x1, dropout 0.5 with JAX's draws
  injected, SGD 1e-2, an accuracy validation every 2 steps): the loss
  stream within 1e-5 relative, the validation stream equal, the final
  and the rolled-back best parameters within 1e-5 of JAX's.
* ``train_with_registries`` (SGD 1e-2, dropout 0): the
  ``<metric>_<i>.txt`` streams within 1e-5 relative, ``max_valid_iter.txt``
  equal, ``max_model_pars.npz`` within 1e-5, and histories reload on a
  resume.
* ``test_scores_matrix`` on a JAX-written multi-subject ``random``
  campaign (history copies every round): equal F-measures, also when
  resumed from ``start_ind``.
* ``visualize``: the numpy helpers equal JAX's; the plots write their
  files on the Agg backend.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nnal_tpu.core.config import ExperimentConfig as JConfig
from nnal_tpu.engine.analysis import test_scores_matrix as j_scores
from nnal_tpu.engine.multi_experiment import MultiImgExperiment as JMulti
from nnal_tpu.evaluation import registry as jreg
from nnal_tpu.evaluation import visualize as jvis
from nnal_tpu.models import train as jtrain
from nnal_tpu.models.cnn import init_cnn as j_init_cnn
from nnal_tpu.models.checkpoint import load_checkpoint as j_load
from nnal_tpu.models.specs import create_pw1 as j_create_pw1
from nnal_tpu_torch.data.io import synthetic_subject
from nnal_tpu_torch.engine.analysis import test_scores_matrix as t_scores
from nnal_tpu_torch.engine.multi_experiment import MultiImgExperiment
from nnal_tpu_torch.evaluation import registry as treg
from nnal_tpu_torch.evaluation import visualize as tvis
from nnal_tpu_torch.models import train as ttrain
from nnal_tpu_torch.models.bridge import to_jax_params
from nnal_tpu_torch.models.checkpoint import load_checkpoint
from nnal_tpu_torch.models.specs import create_pw1
from torch_jax_dense import port_model
from torch_jax_draws import inject
from torch_jax_native import ensure_jax_native

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    """The JAX package's native patch gather loaded before its side
    runs: a load lost to a concurrent build would leave it on its
    fallback (``torch_jax_native``)."""
    ensure_jax_native("gather")


def _toy(seed, n=32):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(size=(n // 2, 9, 9, 1)) - 0.3,
                        rng.normal(size=(n // 2, 9, 9, 1)) + 0.3]).astype(
                            np.float32)
    y = np.eye(2)[np.repeat([0, 1], n // 2)].astype(np.float32)
    return x, y


def _pair(dropout):
    jspec = j_create_pw1(2, dropout, (9, 9, 1))
    params = jax.tree_util.tree_map(
        np.asarray, j_init_cnn(jspec, jax.random.key(0))[0])
    return (jspec, jax.tree_util.tree_map(jnp.asarray, params),
            port_model(create_pw1(2, dropout, (9, 9, 1)), params))


def _close(port_model_, jparams, tol=1e-5):
    got = to_jax_params(port_model_.state_dict())
    for layer, d in got.items():
        for k, v in d.items():
            np.testing.assert_allclose(v, np.asarray(jparams[layer][k]),
                                       rtol=0, atol=tol,
                                       err_msg=f"{layer}/{k}")


def test_eval_metrics():
    jspec, jp, model = _pair(0.0)
    x, y = _toy(0)
    want = jreg.eval_metrics(jspec, jp, lambda: (x, y), iters=2,
                             metrics=("av_acc", "F1", "av_loss"))
    got = treg.eval_metrics(model, lambda: (x, y), iters=2,
                            metrics=("av_acc", "F1", "av_loss"))
    assert got["av_acc"] == want["av_acc"] and got["F1"] == want["F1"]
    assert abs(got["av_loss"] - want["av_loss"]) <= 1e-5 * want["av_loss"]
    with pytest.raises(ValueError, match="unknown metric"):
        treg.eval_metrics(model, lambda: (x, y), 1, ("recall",))


def _batches(seed):
    x, y = _toy(seed, 64)
    i = 0
    while True:
        sl = slice(16 * (i % 4), 16 * (i % 4 + 1))
        yield x[sl], y[sl]
        i += 1


@pytest.mark.parametrize("validated", [False, True])
def test_train_loops(monkeypatch, validated):
    jspec, jp, model = _pair(0.5)
    xv, yv = _toy(9, 16)
    inject(monkeypatch)
    jtx = optax.sgd(1e-2)
    jstate = jtrain.TrainState(params=jp, opt_state=jtx.init(jp))
    jstep = jtrain.make_train_step(jspec, jtx)

    def j_eval(params):
        pred = np.asarray(jax.numpy.argmax(
            jtrain.apply_cnn(jspec, params, jnp.asarray(xv)).logits, -1))
        return float(np.mean(pred == yv.argmax(-1)))

    def t_eval(m):
        with torch.no_grad():
            pred = m(torch.as_tensor(xv)).prediction.numpy()
        return float(np.mean(pred == yv.argmax(-1)))

    state = ttrain.TrainState(model, torch.optim.SGD(model.parameters(),
                                                     lr=1e-2))
    tstep = ttrain.make_train_step()
    key = jax.random.key(6)
    kw = dict(step_limit=6, rng=key, eval_every=2)
    if validated:
        jstate = jtrain.validated_train(jspec, jstate, jstep, _batches(1),
                                        eval_fn=j_eval, **kw)
        state = ttrain.validated_train(state, tstep, _batches(1),
                                       eval_fn=t_eval, **kw)
        jbest = jstate.params
    else:
        jstate, jbest = jtrain.train(jspec, jstate, jstep, _batches(1),
                                     eval_fn=j_eval, track_best=True, **kw)
        state, best = ttrain.train(state, tstep, _batches(1),
                                   eval_fn=t_eval, track_best=True, **kw)
    assert state.step == jstate.step == 6
    np.testing.assert_allclose(state.metrics["train_loss"],
                               jstate.metrics["train_loss"], rtol=1e-5)
    assert state.metrics["valid"] == jstate.metrics["valid"]
    if validated:
        _close(state.model, jbest)
    else:
        _close(state.model, jstate.params)
        state.model.load_state_dict(best)
        _close(state.model, jbest)


def test_train_with_registries(tmp_path):
    jspec, jp, model = _pair(0.0)
    x, y = _toy(1)

    def gen():
        while True:
            yield x, y

    jtx = optax.sgd(1e-2)
    jstate = jtrain.TrainState(params=jp, opt_state=jtx.init(jp))
    state = ttrain.TrainState(model, torch.optim.SGD(model.parameters(),
                                                     lr=1e-2))

    def regs(mod):
        return [mod.MetricRegistry(("av_acc", "av_loss"), lambda: (x, y),
                                   iters=1),
                mod.MetricRegistry(("F1",), lambda: (x, y), iters=1)]

    kw = dict(step_limit=6, rng=jax.random.key(2), eval_every=3,
              track="av_acc")
    jreg.train_with_registries(jspec, jstate, jtrain.make_train_step(
        jspec, jtx), gen(), registries=regs(jreg),
        save_path=str(tmp_path / "j"), **kw)
    state = treg.train_with_registries(state, ttrain.make_train_step(),
                                       gen(), registries=regs(treg),
                                       save_path=str(tmp_path / "t"), **kw)
    for f in ("av_acc_0.txt", "av_loss_0.txt", "F1_1.txt",
              "max_valid_iter.txt"):
        np.testing.assert_allclose(np.loadtxt(tmp_path / "t" / f),
                                   np.loadtxt(tmp_path / "j" / f),
                                   rtol=1e-5, err_msg=f)
    assert len(np.atleast_1d(np.loadtxt(tmp_path / "t" /
                                        "av_acc_0.txt"))) == 3
    got = load_checkpoint(str(tmp_path / "t" / "max_model_pars.npz"))[0]
    want = j_load(str(tmp_path / "j" / "max_model_pars.npz"))[0]
    for layer in want:
        for k in want[layer]:
            np.testing.assert_allclose(got[layer][k], want[layer][k],
                                       rtol=0, atol=1e-5)
    regs2 = regs(treg)
    treg.train_with_registries(
        ttrain.TrainState(state.model, torch.optim.SGD(
            state.model.parameters(), lr=1e-2), step=6), ttrain.
        make_train_step(), gen(), registries=regs2,
        save_path=str(tmp_path / "t"), **kw)
    assert len(regs2[0].history["av_acc"]) == 4


def test_test_scores_matrix(tmp_path):
    shape = (20, 20, 6)
    subs = [synthetic_subject(shape=shape, n_modalities=1, seed=s,
                              n_blobs=6) for s in range(2)]
    test = [synthetic_subject(shape=shape, n_modalities=1, seed=7,
                              n_blobs=6)]
    pars = {"model_name": "PW", "nclass": 2, "patch_shape": (9, 9, 1),
            "grid_spacing": 4, "k": 3, "B": 12, "ntb": 256, "b": 32,
            "epochs": 1, "learning_rate": 3e-3, "optimizer_name": "SGD",
            "dropout_rate": 0.0, "init_size": 4, "seed": 5}
    root = str(tmp_path / "multi")
    try:
        jexpr = JMulti(root, JConfig.from_pars(pars))
        jexpr.attach_subjects(subs, test_subjects=test)
        jexpr.prep_data()
        jexpr.add_method("random")
        jexpr.run_method("random", 6)
        want = j_scores(jexpr, "random")
        os.remove(os.path.join(root, "random", "test_scores.txt"))
        texpr = MultiImgExperiment(root, device="cpu")
        texpr.attach_subjects(subs, test_subjects=test)
        got = t_scores(texpr, "random")
        assert got.shape == (1, 2)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(t_scores(texpr, "random",
                                               start_ind=2), want)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def test_visualize(tmp_path):
    xs = [np.arange(1, 9) * 3.0, np.arange(1, 7) * 4.0]
    ys = [np.linspace(0.1, 0.8, 8), np.linspace(0.2, 0.7, 6)]
    for g, w in zip(tvis.interpolate_curves(ys, xs, 11),
                    jvis.interpolate_curves(ys, xs, 11)):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(tvis.mean_std_over_runs(ys),
                    jvis.mean_std_over_runs(ys)):
        np.testing.assert_array_equal(g, w)
    gx, gy = np.meshgrid(np.arange(0, 12, 3), np.arange(0, 10, 3),
                         indexing="ij")
    vals = np.random.default_rng(0).random(gx.size)
    for sl in (slice(None), slice(0, -2)):       # grid, then scattered
        np.testing.assert_array_equal(
            tvis.interp_slice_posteriors(gx.ravel()[sl], gy.ravel()[sl],
                                         vals[sl], (12, 10)),
            jvis.interp_slice_posteriors(gx.ravel()[sl], gy.ravel()[sl],
                                         vals[sl], (12, 10)))
    img = np.random.default_rng(1).random((12, 10))
    m1, m2 = img > 0.7, img < 0.2
    np.testing.assert_array_equal(tvis.generate_rgb_mask(img, m1, m2),
                                  jvis.generate_rgb_mask(img, m1, m2))
    over = np.arange(12 * 10 * 2).reshape(12, 10, 2) // 7
    codes = np.array([[0, 1], [3, 20]])
    np.testing.assert_array_equal(tvis.overlay_superpixels(over, codes),
                                  jvis.overlay_superpixels(over, codes))
    tvis.plot_learning_curves({"a": ys[0], "b": ys[0][::-1]}, 3,
                              str(tmp_path / "c.png"),
                              stds={"a": 0.05 * ys[0]})
    tvis.overlay_queries_on_slice(img, np.array([[1, 2], [5, 6]]),
                                  str(tmp_path / "q.png"), mask2d=m1)
    assert all(os.path.getsize(tmp_path / f) > 0 for f in ("c.png",
                                                           "q.png"))
