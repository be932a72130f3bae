"""The library surface that no engine path reaches, against the JAX
package's, on the CPU:

* the seven losses of ``models/losses`` (``cross_entropy`` with and
  without class weights, ``soft_cross_entropy``, ``generalized_ce``,
  ``focal_loss``, ``lwf_loss``, ``weight_decay_penalty``) and
  ``get_loss_fn``'s four names: within 1e-6 relative, gradients too;
* ``models/optim``'s ``exponential_decay``, ``constant`` and the PFT
  masks from saliency (ties, k 0, k past the end) and from a threshold:
  schedules within 1e-6 relative, masks equal entry for entry through
  the bridge's layouts;
* ``make_train_step``'s ``focal_gamma`` (the dense CE over NaN-masked
  pixel labels, with class weights) and ``weight_decay``: one SGD step
  against JAX's jitted step with JAX's dropout draws injected, at the
  classification step's tolerance (loss rtol 1e-5, params atol 1e-5);
* ``models/branches``: a branch on PW1's probe from bridged weights,
  trunk and branch posteriors atol 1e-6, ``branch_input_shape``, and a
  replica that moves apart;
* ``load_reference_h5`` / ``save_reference_h5``: files either package
  writes read back bit-equal by both;
* the last names of the ported modules: ``models/cnn.count_parameters``
  and ``scoring/strategies.available_strategies`` equal JAX's;
  ``data/patches.gather_patches`` and ``gather_patches_multimg`` (K2's
  plain version here) give JAX's patches and labels bit for bit;
  ``runtime/native.native_available`` and ``slic_native_available`` are
  true where g++ builds the sources; ``core/profiling.annotate`` names a
  range of the trace ``device_trace`` writes;
* ``PoolEvaluator.from_volumes``: the padded volume, ``mu`` and ``sd``
  equal JAX's, posteriors of a ragged pool through the tiny net's
  bridged weights agree within 1e-5, and it asks for the card by
  default;
* ``RngStream.next_n``: ``n`` distinct seeds, those ``n`` calls of
  ``next`` would give, drawn again after ``restore(state())``.

Tiny shapes; the h5 files are deleted with their ``tmp_path``.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nnal_tpu.data import patches as jpatches
from nnal_tpu.models import branches as jbr
from nnal_tpu.models import checkpoint as jckpt
from nnal_tpu.models import losses as jl
from nnal_tpu.models import optim as jopt
from nnal_tpu.models.cnn import init_cnn as j_init_cnn
from nnal_tpu.models.specs import CNNSpec as JSpec
from nnal_tpu.models.specs import Layer as JLayer
from nnal_tpu.models.specs import create_pw1 as j_pw1
from nnal_tpu.models.train import make_train_step as j_make_train_step
from nnal_tpu.models.cnn import count_parameters as j_count_parameters
from nnal_tpu.scoring.pool_eval import PoolEvaluator as JPool
from nnal_tpu.scoring.strategies import available_strategies as j_available
from nnal_tpu_torch.core import profiling as tprof
from nnal_tpu_torch.core.rng import RngStream
from nnal_tpu_torch.data.io import synthetic_subject
from nnal_tpu_torch.data.stats import multimg_stats
from nnal_tpu_torch.data import patches as tpatches
from nnal_tpu_torch.models import branches as tbr
from nnal_tpu_torch.models import checkpoint as tckpt
from nnal_tpu_torch.models import losses as tl
from nnal_tpu_torch.models import optim as topt
from nnal_tpu_torch.models.bridge import from_jax_params, to_jax_params
from nnal_tpu_torch.models.cnn import CNN
from nnal_tpu_torch.models.specs import CNNSpec as TSpec
from nnal_tpu_torch.models.specs import Layer as TLayer
from nnal_tpu_torch.models.specs import create_pw1 as t_pw1
from nnal_tpu_torch.models.cnn import count_parameters
from nnal_tpu_torch.models.train import TrainState, make_train_step
from nnal_tpu_torch.runtime import native as tnative
from nnal_tpu_torch.runtime import slic_native as tslic
from nnal_tpu_torch.scoring.pool_eval import PoolEvaluator
from nnal_tpu_torch.scoring.strategies import available_strategies
from test_torch_cls_model import _batch, _jitter, _pair
from torch_jax_dense import dense_pair
from torch_jax_draws import inject
from torch_jax_tiny import tiny_pair

torch.set_num_threads(1)

RTOL = 1e-6


def _logits_labels(n=16, c=3, seed=0):
    rng = np.random.default_rng(seed)
    lg = (3 * rng.normal(size=(n, c))).astype(np.float32)
    y = np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]
    soft = rng.dirichlet(np.ones(c), n).astype(np.float32)
    old = (2 * rng.normal(size=(n, c))).astype(np.float32)
    cw = np.array([0.5, 1.0, 2.0], np.float32)[:c]
    return lg, y, soft, old, cw


LOSSES = {
    "cross_entropy": (lambda lg, y, s, o, cw: jl.cross_entropy(lg, y),
                      lambda lg, y, s, o, cw: tl.cross_entropy(lg, y)),
    "cross_entropy_cw": (
        lambda lg, y, s, o, cw: jl.cross_entropy(lg, y, cw),
        lambda lg, y, s, o, cw: tl.cross_entropy(lg, y, cw)),
    "soft_cross_entropy": (
        lambda lg, y, s, o, cw: jl.soft_cross_entropy(lg, s),
        lambda lg, y, s, o, cw: tl.soft_cross_entropy(lg, s)),
    "generalized_ce": (
        lambda lg, y, s, o, cw: jl.generalized_ce(lg, y, 0.6),
        lambda lg, y, s, o, cw: tl.generalized_ce(lg, y, 0.6)),
    "focal_loss": (
        lambda lg, y, s, o, cw: jl.focal_loss(lg, y, 2.0, cw),
        lambda lg, y, s, o, cw: tl.focal_loss(lg, y, 2.0, cw)),
    "lwf_loss": (
        lambda lg, y, s, o, cw: jl.lwf_loss(lg, y, o, 0.7, 2.0),
        lambda lg, y, s, o, cw: tl.lwf_loss(lg, y, o, 0.7, 2.0)),
}
for _name, _kw in (("CE", {"class_weights": [0.5, 1.0, 2.0]}),
                   ("CE_softclasses", {}), ("GCE", {"q": 0.5}),
                   ("focal", {"gamma": 1.5})):
    LOSSES[f"get_loss_fn[{_name}]"] = (
        (lambda n, k: lambda lg, y, s, o, cw: jl.get_loss_fn(n, **k)(
            lg, s if n == "CE_softclasses" else y))(_name, _kw),
        (lambda n, k: lambda lg, y, s, o, cw: tl.get_loss_fn(n, **k)(
            lg, s if n == "CE_softclasses" else y))(_name, _kw))


@pytest.mark.parametrize("name", list(LOSSES))
def test_losses_match_jax(name):
    jf, tf = LOSSES[name]
    lg, y, soft, old, cw = _logits_labels()
    jval, jgrad = jax.value_and_grad(
        lambda a: jf(a, jnp.asarray(y), jnp.asarray(soft), jnp.asarray(old),
                     jnp.asarray(cw)))(jnp.asarray(lg))
    t_lg = torch.from_numpy(lg).requires_grad_(True)
    tval = tf(t_lg, torch.from_numpy(y), torch.from_numpy(soft),
              torch.from_numpy(old), torch.from_numpy(cw))
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval),
                               rtol=RTOL)
    np.testing.assert_allclose(t_lg.grad.numpy(), np.asarray(jgrad),
                               rtol=RTOL, atol=RTOL * np.abs(jgrad).max())


def test_unknown_loss_name_raises():
    with pytest.raises(ValueError):
        tl.get_loss_fn("hinge")


def test_weight_decay_penalty_matches_jax():
    _, params, model = _pair("DenseNet", 3, (16, 16, 3))
    params = _jitter(params, 2)
    model.load_state_dict(from_jax_params(params))
    want = jl.weight_decay_penalty(
        jax.tree_util.tree_map(jnp.asarray, params), 3e-4)
    got = tl.weight_decay_penalty(model, 3e-4)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_schedules_match_jax():
    for sched_j, sched_t in (
            (jopt.exponential_decay(0.1, 0.5, 100),
             topt.exponential_decay(0.1, 0.5, 100)),
            (jopt.exponential_decay(3e-3, 0.96),
             topt.exponential_decay(3e-3, 0.96)),
            (jopt.constant(1e-3), topt.constant(1e-3))):
        for t in (0, 1, 37, 100, 2500):
            np.testing.assert_allclose(sched_t(t), sched_j(t), rtol=RTOL)


def _fisher():
    """A diagonal Fisher of the small DenseNet, keyed as the port's
    ``named_parameters`` and as the JAX tree, with ties at a few values."""
    _, params, model = _pair("DenseNet", 3, (16, 16, 3))
    rng = np.random.default_rng(4)
    jtree = {l: {k: np.round(rng.exponential(size=v.shape), 2)
                 .astype(np.float32) for k, v in p.items()}
             for l, p in params.items()}
    named = {k: v for k, v in from_jax_params(jtree).items()}
    assert set(named) == {n for n, _ in model.named_parameters()}
    return jtree, named


@pytest.mark.parametrize("k", [0, 1, 500, 2000, 10 ** 9])
def test_pft_mask_from_saliency_matches_jax(k):
    jtree, named = _fisher()
    want = jopt.pft_mask_from_saliency(jtree, k)
    got = topt.pft_mask_from_saliency(named, k)
    assert all(v.dtype == torch.float32 for v in got.values())
    got_j = to_jax_params(got)
    for layer in want:
        for key in want[layer]:
            np.testing.assert_array_equal(got_j[layer][key],
                                          np.asarray(want[layer][key]))
    total = sum(int(v.sum()) for v in got.values())
    n = sum(v.numel() for v in got.values())
    assert total == 0 if k == 0 else total >= min(k, n)


def test_pft_mask_from_threshold_matches_jax():
    jtree, named = _fisher()
    want = jopt.pft_mask_from_threshold(jtree, 1.5)
    got_j = to_jax_params(topt.pft_mask_from_threshold(named, 1.5))
    for layer in want:
        for key in want[layer]:
            np.testing.assert_array_equal(got_j[layer][key],
                                          np.asarray(want[layer][key]))


def test_pft_mask_multiplies_gradients():
    _, params, model = _pair("DenseNet", 3, (16, 16, 3))
    _, named = _fisher()
    mask = topt.pft_mask_from_saliency(named, 300)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    topt.apply_grad_mask(model, mask)
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.grad, mask[name], rtol=0, atol=0)


def _params_close(model, jp, case):
    got = to_jax_params(model.state_dict())
    jp = jax.tree_util.tree_map(np.asarray, jp)
    for layer in jp:
        for k in jp[layer]:
            np.testing.assert_allclose(got[layer][k], jp[layer][k], rtol=0,
                                       atol=1e-5,
                                       err_msg=f"{case} {layer}/{k}")


def test_weight_decay_step_matches_jax(monkeypatch):
    """One SGD step (lr 0.1) of the classification step with
    ``weight_decay`` 1e-3 on the small DenseNet (dropout 0.2, JAX's draws
    injected, two weight-0 rows)."""
    inject(monkeypatch)
    jspec, params, model = _pair("DenseNet", 3, (16, 16, 3))
    params = _jitter(params, 5)
    model.load_state_dict(from_jax_params(params))
    x, y, w = _batch()
    key, step = jax.random.fold_in(jax.random.key(9), 4), 4
    tx = optax.sgd(0.1)
    jstep = j_make_train_step(jspec, tx, weight_decay=1e-3)
    jp, _, jloss = jstep(jax.tree_util.tree_map(jnp.asarray, params),
                         tx.init(params), jnp.asarray(x), jnp.asarray(y),
                         key, jnp.asarray(step), None, jnp.asarray(w))
    state = TrainState(model=model, step=step, optimizer=torch.optim.SGD(
        model.parameters(), lr=0.1))
    loss = make_train_step(weight_decay=1e-3)(
        state, torch.from_numpy(x), torch.from_numpy(y), key,
        torch.from_numpy(w))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _params_close(model, jp, "weight_decay")


def test_focal_gamma_fcn_step_matches_jax(monkeypatch):
    """One SGD step (lr 0.05) of the dense step on the small FC-DenseNet
    (growth 4, depths [2, 2], dropout 0.2, JAX's draws injected) with
    ``focal_gamma`` 2 and class weights, over per-pixel one-hots of which
    a third are unlabeled (NaN), and ``weight_decay`` 1e-4 beside it."""
    inject(monkeypatch)
    jspec, params, _, model, _ = dense_pair(seed=3, H=16)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 16, 16, 2)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (2, 16, 16))]
    y[rng.uniform(size=(2, 16, 16)) < 1 / 3] = np.nan
    cw = np.array([0.7, 1.4], np.float32)
    key, step = jax.random.fold_in(jax.random.key(2), 1), 1
    tx = optax.sgd(0.05)
    jstep = j_make_train_step(jspec, tx, fcn=True, class_weights=cw,
                              focal_gamma=2.0, weight_decay=1e-4)
    jp, _, jloss = jstep(jax.tree_util.tree_map(jnp.asarray, params),
                         tx.init(params), jnp.asarray(x), jnp.asarray(y),
                         key, jnp.asarray(step))
    state = TrainState(model=model, step=step, optimizer=torch.optim.SGD(
        model.parameters(), lr=0.05))
    loss = make_train_step(fcn=True, focal_gamma=2.0, weight_decay=1e-4)(
        state, torch.from_numpy(x), torch.from_numpy(y), key,
        cw=torch.from_numpy(cw))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _params_close(model, jp, "focal_gamma")
    with pytest.raises(ValueError, match="fcn"):
        make_train_step(fcn=True, lwf_lambda=0.5)


def test_branch_matches_jax():
    jtrunk, ttrunk = j_pw1(2, 0.0, (9, 9, 1)), t_pw1(2, 0.0, (9, 9, 1))
    shape = tbr.branch_input_shape(ttrunk, 4)
    assert shape == jbr.branch_input_shape(jtrunk, 4) and len(shape) == 3
    jbranch = JSpec("aux", (JLayer("bfc", "fc", 3, (), (), "VALID", "M"),),
                    shape, 3)
    tbranch = TSpec("aux", (TLayer("bfc", "fc", 3, (), (), "VALID", "M"),),
                    shape, 3)
    tp, _ = j_init_cnn(jtrunk, jax.random.key(1))
    bp, _ = jbr.init_branch(jbranch, jax.random.key(0))
    tp, bp = (jax.tree_util.tree_map(np.asarray, t) for t in (tp, bp))
    trunk, branch = CNN(ttrunk), CNN(tbranch)
    trunk.load_state_dict(from_jax_params(tp))
    branch.load_state_dict(from_jax_params(bp))
    x = np.random.default_rng(3).normal(size=(4, 9, 9, 1)).astype(np.float32)
    j_t, j_b = jbr.apply_with_branch(jtrunk, jbranch, tp, bp,
                                     jnp.asarray(x), 4)
    with torch.no_grad():
        t_t, t_b = tbr.apply_with_branch(trunk, branch, torch.from_numpy(x),
                                         4)
    for got, want in ((t_t, j_t), (t_b, j_b)):
        np.testing.assert_allclose(got.posteriors.numpy(),
                                   np.asarray(want.posteriors), atol=1e-6)
    name = ttrunk.layers[4].name
    np.testing.assert_allclose(t_t.probes[name].numpy(),
                               np.asarray(j_t.probes[name]), atol=1e-5)
    with pytest.raises(ValueError, match="not probed"):
        tbr.apply_with_branch(trunk, branch, torch.from_numpy(x), 3)
    fresh = tbr.init_branch(tbranch, 0, device="cpu")
    assert fresh.bfc.weight.shape == branch.bfc.weight.shape
    rep = tbr.replicate_params(trunk)
    with torch.no_grad():
        rep.fc3.weight.add_(1.0)
    assert not torch.equal(rep.fc3.weight, trunk.fc3.weight)
    assert torch.equal(rep.fc1.weight, trunk.fc1.weight)


def test_reference_h5_round_trip_both_ways(tmp_path):
    jspec, params, model = _pair("DenseNet", 3, (16, 16, 3))
    params = _jitter(params, 8)
    template = to_jax_params(model.state_dict())
    try:
        for writer, name in ((tckpt.save_reference_h5, "port.h5"),
                             (jckpt.save_reference_h5, "jax.h5")):
            path = str(tmp_path / name)
            writer(path, params)
            for reader in (tckpt.load_reference_h5,
                           jckpt.load_reference_h5):
                got = reader(path, template)
                for layer, p in params.items():
                    for k in ("W", "b"):
                        if k in p:
                            np.testing.assert_array_equal(
                                np.asarray(got[layer][k]), p[k])
                    for k in set(p) - {"W", "b"}:
                        np.testing.assert_array_equal(
                            np.asarray(got[layer][k]), template[layer][k])
        # a feature-major fc weight is transposed on the way in; a shape
        # that fits neither way raises
        import h5py

        fc = next(l for l, p in params.items() if p["W"].ndim == 2)
        path = str(tmp_path / "t.h5")
        with h5py.File(path, "w") as f:
            f.create_group(fc)["Weight"] = params[fc]["W"].T
        np.testing.assert_array_equal(
            tckpt.load_reference_h5(path, template)[fc]["W"], params[fc]["W"])
        with h5py.File(path, "w") as f:
            f.create_group(fc)["Weight"] = np.zeros((3, 3, 3), np.float32)
        with pytest.raises(ValueError, match="shape"):
            tckpt.load_reference_h5(path, template)
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)


def test_count_parameters_and_available_strategies_match_jax():
    jspec, params, model = _pair("DenseNet", 3, (16, 16, 3))
    assert count_parameters(model) == j_count_parameters(params)
    assert available_strategies() == j_available()


def _subjects(n=3, seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(9, 8, 5), (7, 10, 4), (8, 8, 6)][:n]
    vols = [[rng.normal(size=s).astype(np.float32) for _ in range(2)]
            for s in shapes]
    masks = [(rng.uniform(size=s) < 0.4).astype(np.float32) for s in shapes]
    return vols, masks


def test_gather_patches_match_jax_bit_for_bit():
    ps = (5, 5, 3)
    vols, masks = _subjects()
    jpad = [jpatches.pad_volumes(v, ps) for v in vols]
    tpad = [tpatches.pad_volumes(v, ps, device="cpu") for v in vols]
    inds = np.array([0, 17, 40, 99, 143], np.int64)
    raw_j = np.asarray(jpatches.gather_patches(
        jpad[0], jnp.asarray(inds), ps, (9, 8, 5)))
    raw_t = tpatches.gather_patches(tpad[0], torch.as_tensor(inds), ps,
                                    (9, 8, 5))
    np.testing.assert_array_equal(raw_t.numpy(), raw_j)
    stats = np.array([[0.1, 1.3, -0.2, 0.7], [0.0, 1.0, 0.3, 2.1],
                      [-0.4, 0.9, 0.2, 1.1]])
    img_inds = [inds, np.array([], np.int64), np.array([3, 5, 200])]
    bj, lj = jpatches.gather_patches_multimg(jpad, img_inds, ps, stats,
                                             masks)
    bt, lt = tpatches.gather_patches_multimg(tpad, img_inds, ps, stats,
                                             masks)
    assert bt[1] == [] and lt[1] == [] and bj[1] == []
    for j in (0, 2):
        np.testing.assert_array_equal(bt[j].numpy(), np.asarray(bj[j]))
        np.testing.assert_array_equal(lt[j], lj[j])
    bt, lt = tpatches.gather_patches_multimg(tpad, img_inds, ps, stats)
    assert lt == [[], [], []] and bt[0].shape == (5, 5, 5, 6)


def test_native_available_and_profiling_names(tmp_path):
    assert tnative.native_available() and tslic.slic_native_available()
    with tprof.device_trace(str(tmp_path / "tb")) as prof:
        with tprof.annotate("nnal/range"):
            torch.ones(8) @ torch.ones(8)
    assert any(e.key == "nnal/range" for e in prof.key_averages())
    files = list((tmp_path / "tb").glob("*.pt.trace.json"))
    assert len(files) == 1 and "nnal/range" in files[0].read_text()


def test_pool_evaluator_from_volumes_matches_jax(monkeypatch):
    vols, mask = synthetic_subject(shape=(12, 10, 4), n_modalities=2,
                                   n_blobs=2, seed=5)
    stats = multimg_stats([(vols, mask)]).reshape(-1, 2)   # (m, 2)
    jspec, jparams, model, _ = tiny_pair(seed=3, input_shape=(5, 5, 2))
    jev = JPool.from_volumes(jspec, vols, stats, (5, 5, 1), ntb=16)
    tev = PoolEvaluator.from_volumes(model.spec, vols, stats, (5, 5, 1),
                                     ntb=16, device="cpu")
    assert tev.padded.device.type == "cpu"
    assert tev.orig_shape == jev.orig_shape == (12, 10, 4)
    np.testing.assert_array_equal(tev.padded.numpy(),
                                  np.asarray(jev.padded))
    np.testing.assert_array_equal(tev.mu.numpy(), np.asarray(jev.mu))
    np.testing.assert_array_equal(tev.sd.numpy(), np.asarray(jev.sd))
    inds = np.random.default_rng(0).choice(480, 50, replace=False)
    got = tev.evaluate(model, inds, ("posteriors", "prediction"))
    want = jev.evaluate(jparams, inds, ("posteriors", "prediction"))
    np.testing.assert_allclose(got["posteriors"], want["posteriors"],
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got["prediction"], want["prediction"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        PoolEvaluator.from_volumes(model.spec, vols, stats, (5, 5, 1))


def test_rng_stream_next_n():
    s = RngStream(11)
    s.next()
    saved = s.state()
    seeds = s.next_n(6)
    assert len(seeds) == 6 and len(set(seeds)) == 6
    assert all(isinstance(v, int) and 0 <= v < 2 ** 62 for v in seeds)
    assert s.next() not in seeds
    s.restore(saved)
    assert s.next_n(6) == seeds
    s.restore(saved)
    assert [s.next() for _ in range(6)] == seeds
    assert s.next_n(0) == []
