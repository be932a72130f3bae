"""Config paths the engines reach: ``optimizer_name: RMSProp`` and
``PWExperiment.modify_parameters`` / ``reset_method`` / ``load_results``,
on the port against the JAX package (CPU).

* RMSProp steps against ``optax.rmsprop(lr, decay=0.9, eps=1e-10,
  momentum=0.0)`` under ``jit``, on gradients spanning five decades with
  a masked (all-zero) leaf: parameters within 1e-6, ``nu`` within 1e-6
  relative and ``trace`` within 1e-6 of its largest entry (XLA fuses the
  moment update into fused multiply-adds, so an element may sit an f32
  ulp away).
* The optimizer state's leaves are optax's ``(nu..., trace...)`` in
  sorted layer order and JAX layout, both ways, through a checkpoint.
* resume == continue on the host: an entropy campaign under RMSProp,
  resumed from its resume point (bf16 anchors every round, ``nu`` and
  ``trace`` rounded as the anchor stores them) or replayed from the
  initial weights after its resume-point writes were lost,
  equals the uninterrupted one bit for bit; the multi-subject and
  classification engines run it and save its leaves.
* ``modify_parameters`` persists the edit, ``train_layers`` takes effect
  at the next finetune (SGD, so frozen layers stay bit-identical), and a
  dense run warns the first time a key set mid-campaign is ignored;
  ``reset_method`` and ``load_results`` give what the JAX package's give
  on the same directories.
"""

import os
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nnal_tpu.core.config import ExperimentConfig as JConfig
from nnal_tpu.engine.pw_experiment import PWExperiment as JExpr
from nnal_tpu_torch.cli import run_querying as t_rq
from nnal_tpu_torch.core.config import ExperimentConfig
from nnal_tpu_torch.data import image_pool as t_pool
from nnal_tpu_torch.data.io import synthetic_subject
from nnal_tpu_torch.engine import multi_experiment as tmulti
from nnal_tpu_torch.engine import pw_experiment as pw_mod
from nnal_tpu_torch.models.bridge import to_jax_params
from nnal_tpu_torch.models.checkpoint import (
    load_checkpoint,
    load_opt_leaves,
    save_checkpoint,
)
from nnal_tpu_torch.models.optim import (
    RMSProp,
    load_opt_state,
    make_optimizer,
    opt_state_leaves,
)
from test_torch_parallel_engine import link_npz
from torch_jax_tiny import tiny_pair

torch.set_num_threads(1)

VOLS = synthetic_subject(shape=(16, 16, 4), n_modalities=2, n_blobs=10,
                         seed=1)
PARS = {"model_name": "PW", "nclass": 2, "patch_shape": (9, 9, 1),
        "grid_spacing": 2, "k": 8, "B": 20, "ntb": 256, "b": 16,
        "epochs": 1, "learning_rate": 1e-3, "optimizer_name": "RMSProp",
        "dropout_rate": 0.5, "init_size": 16, "seed": 5}


@pytest.fixture
def tmp_path(tmp_path):
    """Drop the checkpoints as soon as the test ends."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _grads(shapes, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        g = {k: (rng.normal(size=s) * 10 ** rng.uniform(-4, 1)).astype(
            np.float32) for k, s in shapes.items()}
        if i == 2:
            g["b"] = np.zeros_like(g["b"])     # a frozen (masked) leaf
        out.append(g)
    return out


def test_rmsprop_steps_match_optax():
    shapes = {"a": (50, 70), "b": (130,), "c": (3, 3, 4, 8)}
    rng = np.random.default_rng(0)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    tx = optax.rmsprop(1e-3, decay=0.9, eps=1e-10, momentum=0.0)

    @jax.jit
    def step(p, st, g):
        u, st = tx.update(g, st, p)
        return optax.apply_updates(p, u), st

    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt = make_optimizer("RMSProp", 1e-3, list(tp.values()))
    assert isinstance(opt, RMSProp)
    for g in _grads(shapes, 8, 1):
        jp, st = step(jp, st, {k: jnp.asarray(v) for k, v in g.items()})
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(opt.state[p]["nu"].numpy(),
                                   np.asarray(st[0].nu[k]), rtol=1e-6)
        tr = np.asarray(st[2].trace[k])
        np.testing.assert_allclose(opt.state[p]["trace"].numpy(), tr,
                                   atol=1e-6 * np.abs(tr).max(), rtol=0)


def test_rmsprop_leaves_are_optax_order(tmp_path):
    jspec, jparams, model, _ = tiny_pair(seed=2)
    tx = optax.rmsprop(1e-2, decay=0.9, eps=1e-10, momentum=0.0)
    st = tx.init(jparams)
    opt = make_optimizer("RMSProp", 1e-2, model.parameters())
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(4, 6, 6, 1)).astype(np.float32))
    for _ in range(2):
        opt.zero_grad()
        model(x).logits.square().sum().backward()
        jg = to_jax_params({n: p.grad for n, p in model.named_parameters()})
        _, st = jax.jit(tx.update)(jax.tree_util.tree_map(jnp.asarray, jg),
                                   st, jparams)
        opt.step()
    want = [np.asarray(v) for v in jax.tree_util.tree_leaves(st)]
    got = opt_state_leaves(opt, model)
    assert len(got) == len(want) == 2 * 6
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-12)
    # a checkpoint round trip installs them back exactly
    path = str(tmp_path / "o.npz")
    save_checkpoint(path, {}, opt_state=got)
    leaves = load_opt_leaves(path)
    os.remove(path)
    fresh = make_optimizer("RMSProp", 1e-2, model.parameters())
    load_opt_state(fresh, model, leaves)
    for g, w in zip(opt_state_leaves(fresh, model), got):
        np.testing.assert_array_equal(g, w)
    # and optax's own leaves load into the port's optimizer
    load_opt_state(fresh, model, want)
    for g, w in zip(opt_state_leaves(fresh, model), want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="RMSProp needs 12"):
        load_opt_state(fresh, model, want[:-1])


def _fresh(root, **over):
    expr = pw_mod.PWExperiment(str(root),
                               ExperimentConfig.from_pars({**PARS, **over}),
                               device="cpu")
    expr.attach_subject(*VOLS)
    return expr


def _start(root, method, **over):
    expr = _fresh(root, **over)
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


class _DropResumeWrites:
    """The engine's resume-point writes dropped: a crash before they
    land."""

    def __enter__(self):
        self.orig = pw_mod.save_checkpoint

        def patched(path, *a, **kw):
            if os.path.basename(path) != "curr_weights.npz":
                self.orig(path, *a, **kw)

        pw_mod.save_checkpoint = patched
        return self

    def __exit__(self, *exc):
        pw_mod.save_checkpoint = self.orig


@pytest.mark.parametrize("how,over", [
    ("saved", {"ckpt_dtype": "bfloat16"}),
    ("dropped", {"ckpt_full_every": 2, "ckpt_dtype": "bfloat16"})])
def test_rmsprop_resume_equals_continue(tmp_path, how, over):
    k = PARS["k"]
    _start(tmp_path / "a", "entropy", **over).run_method("entropy", 2 * k)
    ref = _artifacts(tmp_path / "a", "entropy")
    shutil.rmtree(tmp_path / "a")
    n_opt = sum(key.startswith("opt/") for key in ref[2])
    assert n_opt == 2 * 14           # nu and trace of PW1's 14 leaves
    expr = _start(tmp_path / "b", "entropy", **over)
    if how == "dropped":
        with _DropResumeWrites():
            expr.run_method("entropy", k)
    else:
        expr.run_method("entropy", k)
    _fresh(tmp_path / "b", **over).run_method("entropy", 2 * k)
    got = _artifacts(tmp_path / "b", "entropy")
    assert got[0] == ref[0] and len(got[0]) == 2
    assert got[1] == ref[1]
    assert sorted(got[2]) == sorted(ref[2])
    for key in ref[2]:
        np.testing.assert_array_equal(got[2][key], ref[2][key], err_msg=key)


def test_rmsprop_in_multi_and_classification_engines(tmp_path):
    shape = (20, 20, 6)
    train = [synthetic_subject(shape=shape, n_modalities=1, n_blobs=6,
                               seed=s) for s in range(2)]
    test = [synthetic_subject(shape=shape, n_modalities=1, n_blobs=6,
                              seed=7)]
    cfg = ExperimentConfig.from_pars({
        **PARS, "grid_spacing": 4, "k": 3, "B": 12, "init_size": 0})
    expr = tmulti.MultiImgExperiment(str(tmp_path / "m"), cfg, device="cpu")
    expr.attach_subjects(train, test)
    expr.prep_data()
    expr.add_method("random")
    res = expr.run_method("random", 6)
    assert res["n_queries"] == 6
    leaves = load_opt_leaves(str(tmp_path / "m" / "random"
                                 / "curr_weights.npz"))
    assert len(leaves) == 2 * 14 and any(np.any(v) for v in leaves)
    shutil.rmtree(tmp_path / "m")      # read: its checkpoints can go
    rng = np.random.default_rng(1)
    X = np.concatenate([rng.normal(size=(30, 8, 8, 1)) - 1,
                        rng.normal(size=(30, 8, 8, 1)) + 1]).astype(
        np.float32)
    y = np.repeat([0, 1], 30)
    over = ("model_name=PW,k=4,B=16,ntb=32,b=8,epochs=1,learning_rate=0.001,"
            "optimizer_name=RMSProp,init_size=8,test_ratio=0.25,seed=3")
    out = t_rq.run_classification_al(str(tmp_path / "c"),
                                     t_pool.InMemoryPool(X, y), ["random"],
                                     4, over, device="cpu")
    assert len(out["random"]) >= 1
    mdir = tmp_path / "c" / "0" / "random"
    leaves = load_opt_leaves(str(mdir / "curr_weights.npz"))
    assert len(leaves) == 2 * 14 and any(np.any(v) for v in leaves)


def test_modify_parameters_train_layers_take_effect(tmp_path):
    k = PARS["k"]
    expr = _start(tmp_path, "entropy", optimizer_name="SGD")
    expr.run_method("entropy", k)
    before = load_checkpoint(str(tmp_path / "entropy" / "curr_weights.npz"))[0]
    expr.modify_parameters(train_layers=["fc3"], k=k)
    assert list(expr.config.model.train_layers) == ["fc3"]
    reread = JConfig.from_yaml(str(tmp_path / "parameters.txt"))
    assert list(reread.model.train_layers) == ["fc3"]
    assert reread.model.optimizer_name == "SGD"
    expr.run_method("entropy", 2 * k)
    after = load_checkpoint(str(tmp_path / "entropy" / "curr_weights.npz"))[0]
    for layer in before:
        same = all(np.array_equal(before[layer][w], after[layer][w])
                   for w in before[layer])
        assert same == (layer != "fc3"), layer


def test_dense_run_warns_once_for_a_key_set_mid_campaign(tmp_path):
    vols = synthetic_subject(shape=(24, 24, 4), n_modalities=2, n_blobs=10,
                             seed=2)
    cfg = ExperimentConfig.from_pars({
        **PARS, "model_name": "Tiramisu", "optimizer_name": "SGD",
        "model_kwargs": {"growth": 4, "depths": [2, 2]}, "grid_spacing": 4,
        "k": 4, "init_size": 8, "b": 4})
    expr = pw_mod.PWExperiment(str(tmp_path), cfg, device="cpu")
    expr.attach_subject(*vols)
    expr.prep_data()
    expr.add_method("random")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        expr.run_method("random", 4)
        assert not [w for w in rec if "ignores config keys" in str(w.message)]
        expr.modify_parameters(lwf_lambda=1.0)
        expr.run_method("random", 8)
        first = [w for w in rec if "ignores config keys" in str(w.message)]
        assert len(first) == 1 and "lwf_lambda" in str(first[0].message)
        expr.run_method("random", 12)
        again = [w for w in rec if "ignores config keys" in str(w.message)]
        assert len(again) == 1


def test_reset_method_and_load_results_match_jax(tmp_path):
    k = PARS["k"]
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    over = {"optimizer_name": "SGD"}
    jexpr = JExpr(str(jdir), JConfig.from_pars({**PARS, **over}))
    jexpr.attach_subject(*VOLS)
    jexpr.prep_data()
    shutil.copytree(jdir, tdir, copy_function=link_npz)
    texpr = _fresh(tdir, **over)
    for e in (jexpr, texpr):
        e.add_method("random")
        e.run_method("random", k)
    perf = texpr.load_results("random")
    assert perf.shape == (1,)
    np.testing.assert_array_equal(perf, np.loadtxt(
        str(tdir / "random" / "perf_evals.txt")))
    np.testing.assert_array_equal(
        JExpr(str(tdir)).load_results("random"), perf)
    np.testing.assert_array_equal(
        texpr.load_results("random").shape, jexpr.load_results("random").shape)
    jexpr.reset_method("random")
    texpr.reset_method("random")
    for f in ("curr_train_inds.txt", "curr_pool_inds.txt"):
        assert (open(tdir / "random" / f).read()
                == open(jdir / "random" / f).read()), f
    assert not os.path.exists(tdir / "random" / "queries") or \
        not os.listdir(tdir / "random" / "queries")
    init = load_checkpoint(str(tdir / "init_weights.npz"))[0]
    curr = load_checkpoint(str(tdir / "random" / "curr_weights.npz"))[0]
    for layer in init:
        for w in init[layer]:
            np.testing.assert_array_equal(curr[layer][w], init[layer][w])
    assert texpr.load_results("random").size == 0
