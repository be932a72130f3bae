"""The training levers of the port vs the JAX package (CPU), on the same
seeded numpy inputs and weights:

* ``train_layers``: the mask, a frozen layer that stays bit-identical
  under fresh Adam, and the mid-campaign change (unmasked steps, then
  ``train_layers`` set): the frozen conv weights keep moving on their
  Adam moments exactly as JAX's do (Adam eps 1e-3 in both, atol 1e-5);
* the aleatoric head: the split forward (logits, log-sigma, posteriors),
  the doubled fc3 through the bridge both ways, ``surgery``'s extension,
  and what the scorers do with it, as the JAX package does (its
  ``fi`` takes all 2 x nclass head columns into its log-softmax and
  broadcasts the zero-sum identity, which the port reproduces): BALD
  picks through ``cnn_query`` with JAX's draws, and round 0 of
  ``entropy`` and ``fi`` through both engines from a JAX-written
  directory;
* the teacher group of the resume point, cross-read both ways at f32,
  bf16 and int8, bit for bit.
"""

import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nnal_tpu.cli.expr_handler import create_expr as j_create_expr
from nnal_tpu.cli.expr_handler import do_expr as j_do_expr
from nnal_tpu.data.patches import pad_volumes as j_pad
from nnal_tpu.engine import common as jcommon
from nnal_tpu.models import checkpoint as jck
from nnal_tpu.models import optim as joptim
from nnal_tpu.models.cnn import apply_cnn, init_cnn
from nnal_tpu.models.specs import create_pw1, with_aleatoric_head
from nnal_tpu.models.surgery import extend_params_to_aleatoric
from nnal_tpu.models.train import TrainState as JState
from nnal_tpu.models.train import make_scanned_finetune
from nnal_tpu.scoring import strategies as jstrat
from nnal_tpu.scoring.grid_eval import GridPoolEvaluator as JGrid
from nnal_tpu_torch.cli import expr_handler as t_cli
from nnal_tpu_torch.data.io import synthetic_subject
from nnal_tpu_torch.data.patches import pad_volumes
from nnal_tpu_torch.engine import common as tcommon
from nnal_tpu_torch.models import checkpoint as tck
from nnal_tpu_torch.models import surgery as tsurgery
from nnal_tpu_torch.models.bridge import from_jax_params, to_jax_params
from nnal_tpu_torch.models.cnn import CNN
from nnal_tpu_torch.models.optim import apply_grad_mask, layer_train_mask
from nnal_tpu_torch.models.specs import create_pw1 as t_create_pw1
from nnal_tpu_torch.models.specs import (
    with_aleatoric_head as t_with_aleatoric_head,
)
from nnal_tpu_torch.models.train import (
    TrainState,
    build_batch_index_matrix,
    finetune_steps,
    make_teacher,
)
from nnal_tpu_torch.scoring import strategies as tstrat
from nnal_tpu_torch.scoring.grid_eval import GridPoolEvaluator as TGrid
from test_torch_parallel_engine import link_npz
from torch_jax_draws import inject

torch.set_num_threads(1)

SHAPE = (9, 9, 2)
FC = ["fc1", "fc2", "fc3"]


@pytest.fixture
def tmp_path(tmp_path):
    """Drop the checkpoints (tens of MB each) as soon as the test ends."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({4: np.uint32, 2: np.uint16, 1: np.uint8}[a.itemsize])


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(seed=0, dropout=0.0, aleatoric=False, shape=SHAPE):
    spec = create_pw1(2, dropout, shape)
    tspec = t_create_pw1(2, dropout, shape)
    if aleatoric:
        spec, tspec = with_aleatoric_head(spec), t_with_aleatoric_head(tspec)
    params = _np(init_cnn(spec, jax.random.key(seed))[0])
    model = CNN(tspec)
    model.load_state_dict(from_jax_params(params))
    return spec, params, model


def _data(n=40, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n,) + SHAPE).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=n)]
    return x, y


# ------------------------------------------------------------ train_layers
def test_layer_train_mask_matches_jax():
    _, params, model = _pair()
    for layers in (FC, ["conv1"], []):
        want = joptim.layer_train_mask(params, layers)
        got = layer_train_mask(model, layers)
        for name in got:
            layer, _, kind = name.rpartition(".")
            leaf = np.asarray(want[layer]["W" if kind == "weight" else "b"])
            assert np.all(leaf == got[name]), (layers, name)
    # masked gradients become zeros, never None
    x, y = _data(8)
    model(torch.from_numpy(x)).logits.sum().backward()
    apply_grad_mask(model, layer_train_mask(model, FC))
    assert torch.count_nonzero(model.conv1.weight.grad) == 0
    assert torch.count_nonzero(model.fc1.weight.grad) > 0


def test_frozen_layers_stay_bit_identical_under_fresh_adam():
    _, _, model = _pair()
    x, y = _data()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    idx, w = build_batch_index_matrix(40, 16, 1, np.random.default_rng(1))
    state = TrainState(model, torch.optim.Adam(model.parameters(), 1e-3))
    finetune_steps(state, torch.from_numpy(x), torch.from_numpy(y), idx, w,
                   torch.ones(2), grad_mask=layer_train_mask(model, FC))
    for k, v in model.state_dict().items():
        same = torch.equal(v, before[k])
        assert same == k.startswith("conv"), k
    # every parameter stepped: Adam's per-parameter counts stay optax's
    assert {float(s["step"]) for s in state.optimizer.state.values()} \
        == {3.0} and len(state.optimizer.state) == 14


def test_train_layers_set_mid_campaign_matches_jax():
    """Three unmasked Adam steps build moments, then three with
    ``train_layers`` [fc1, fc2, fc3]: optax keeps stepping the masked
    conv leaves on their decaying moments, and so does the port.  At lr
    1e-4: at 1e-3, 445 weights of one fc1 unit part by up to 2.8e-4 (the
    unit's input to its relu lands within rounding of the kink in one of
    the six steps and takes the other branch in one framework), while
    every other entry, and the same six steps unmasked, agree within
    3.2e-7."""
    spec, params, model = _pair()
    x, y = _data()
    rng = np.random.default_rng(1)
    idx1, w1 = build_batch_index_matrix(40, 16, 1, rng)
    idx2, w2 = build_batch_index_matrix(40, 16, 1, rng)
    cw = np.array([0.7, 1.3], np.float32)
    tx = optax.adam(1e-4, eps=1e-3)
    key = jax.random.key(2)
    args = (jnp.asarray(x), jnp.asarray(y))
    p1, o1, _ = make_scanned_finetune(spec, tx, batch_size=16)(
        jax.tree_util.tree_map(jnp.asarray, params),
        tx.init(jax.tree_util.tree_map(jnp.asarray, params)), *args,
        jnp.asarray(idx1), jnp.asarray(w1), jnp.asarray(cw), key)
    p1_np = _np(p1)
    masked = make_scanned_finetune(
        spec, tx, batch_size=16,
        grad_mask=joptim.layer_train_mask(p1, FC))
    p2, _, _ = masked(p1, o1, *args, jnp.asarray(idx2), jnp.asarray(w2),
                      jnp.asarray(cw), key)
    p2 = _np(p2)

    state = TrainState(model, torch.optim.Adam(model.parameters(), lr=1e-4,
                                               eps=1e-3))
    xt, yt, cwt = torch.from_numpy(x), torch.from_numpy(y), \
        torch.from_numpy(cw)
    finetune_steps(state, xt, yt, idx1, w1, cwt)
    finetune_steps(state, xt, yt, idx2, w2, cwt,
                   grad_mask=layer_train_mask(model, FC))
    got = to_jax_params(model.state_dict())
    for layer in got:
        for k in ("W", "b"):
            np.testing.assert_allclose(got[layer][k], p2[layer][k], rtol=0,
                                       atol=1e-5, err_msg=f"{layer}/{k}")
    # the frozen convs did move, in both
    for layer in ("conv1", "conv4"):
        assert np.abs(p2[layer]["W"] - p1_np[layer]["W"]).max() > 1e-5
        assert np.abs(got[layer]["W"] - p1_np[layer]["W"]).max() > 1e-5


# ---------------------------------------------------------- aleatoric head
def test_aleatoric_forward_and_bridge_match_jax():
    spec, params, model = _pair(seed=3, aleatoric=True)
    assert params["fc3"]["W"].shape == (4096, 4)
    assert model.fc3.weight.shape == (4, 4096)
    back = to_jax_params(model.state_dict())
    for layer in params:
        for k in ("W", "b"):
            np.testing.assert_array_equal(back[layer][k], params[layer][k])
    x = _data(16)[0]
    want = apply_cnn(spec, jax.tree_util.tree_map(jnp.asarray, params),
                     jnp.asarray(x))
    got = model(torch.from_numpy(x))
    assert got.logits.shape == (16, 2) and got.log_sigma.shape == (16, 2)
    for a, b in ((got.logits, want.logits), (got.log_sigma, want.log_sigma),
                 (got.posteriors, want.posteriors)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.prediction.numpy(),
                                  np.asarray(want.prediction))
    assert _pair()[2](torch.from_numpy(x)).log_sigma is None


def test_extend_params_to_aleatoric_matches_jax():
    _, params, _ = _pair(seed=4)
    want = extend_params_to_aleatoric(params, "fc3")
    got = tsurgery.extend_params_to_aleatoric(params, "fc3")
    for layer in want:
        for k in ("W", "b"):
            np.testing.assert_array_equal(got[layer][k], want[layer][k])
    assert params["fc3"]["W"].shape == (4096, 2)      # input left alone
    model = CNN(t_with_aleatoric_head(t_create_pw1(2, 0.0, SHAPE)))
    model.load_state_dict(from_jax_params(got))
    x = torch.from_numpy(_data(4)[0])
    assert torch.count_nonzero(model(x).log_sigma) == 0


def test_aleatoric_bald_picks_match_jax(monkeypatch):
    """BALD's MC sweeps read the first nclass columns in both packages."""
    inject(monkeypatch)
    shape, patch = (16, 16, 8), (9, 9, 1)
    vols, _ = synthetic_subject(shape=shape, n_modalities=2, seed=0)
    spec, params, model = _pair(seed=5, dropout=0.5, aleatoric=True)
    mu, sd = np.array([60.0, 75.0]), np.array([30.0, 31.0])
    jev = JGrid(spec, j_pad(vols, patch), mu, sd, patch, shape,
                grid_spacing=2, ntb=128, z_chunk=2)
    tev = TGrid(model.spec, pad_volumes(vols, patch, device="cpu"), mu, sd,
                patch, shape, grid_spacing=2, ntb=128, z_chunk=2)
    X, Y, Z = np.meshgrid(np.arange(0, 16, 2), np.arange(0, 16, 2),
                          [0, 2, 4, 6], indexing="ij")
    pool = np.ravel_multi_index((X.ravel(), Y.ravel(), Z.ravel()), shape)
    key = jax.random.key(5)
    jctx = jstrat.QueryContext(
        spec=spec, params=jax.tree_util.tree_map(jnp.asarray, params),
        evaluator=jev, pool_inds=pool, k=16, rng=np.random.default_rng(0),
        jax_rng=key, MC_iters=3)
    tctx = tstrat.QueryContext(
        spec=model.spec, params=model, evaluator=tev, pool_inds=pool, k=16,
        rng=np.random.default_rng(0), seed=key, MC_iters=3)
    np.testing.assert_array_equal(tstrat.cnn_query(tctx, "BALD"),
                                  jstrat.cnn_query(jctx, "BALD"))


@pytest.mark.parametrize("method", ["entropy", "fi"])
def test_aleatoric_round0_matches_jax(tmp_path, method):
    """Round 0 of an aleatoric campaign from a directory (and weights) the
    JAX package wrote: both engines score the same weights, so the picks
    are identical."""
    base = ("patch_shape=[9,9,1],grid_spacing=2,k=10,B=30,ntb=512,b=32,"
            "epochs=1,init_size=20,learning_rate=1e-2,optimizer_name=SGD,"
            "dropout_rate=0.0,aleatoric=true,mc_t=4,iter_k=[10,0]")
    jdir = str(tmp_path / "jax")
    j_create_expr(jdir, base, synthetic=True).add_method(method)
    tdir = str(tmp_path / "port")
    shutil.copytree(jdir, tdir, copy_function=link_npz)
    j_do_expr(jdir, method, 10, synthetic=True)
    t_cli.do_expr(tdir, method, 10, synthetic=True, device="cpu")
    picks = [np.loadtxt(os.path.join(d, method, "queries", "0.txt"),
                        dtype=np.int64) for d in (jdir, tdir)]
    assert len(picks[1]) >= 1
    np.testing.assert_array_equal(picks[1], picks[0])
    params = tck.load_checkpoint(
        os.path.join(tdir, method, "curr_weights.npz"))[0]
    assert params["fc3"]["W"].shape[-1] == 4


# ------------------------------------------------------- the teacher group
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_teacher_anchors_cross_read(tmp_path, dtype):
    """A port resume point with a teacher loads in the JAX package to the
    port's adopted live values, and a JAX one (the JAX engine's adopt and
    save) loads in the port to the JAX engine's adopted values."""
    mcfg = types.SimpleNamespace(ckpt_dtype=dtype,
                                 opt_reset_per_round=False)
    _, params, model = _pair(seed=6)
    _, tparams, _ = _pair(seed=7)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=1e-2),
                       teacher=make_teacher(model))
    state.teacher.load_state_dict(from_jax_params(tparams))
    akw = tcommon.anchor_save_kwargs(mcfg, state)
    assert tcommon.adopt_anchor_rounding(state, mcfg) == (dtype != "float32")
    path = str(tmp_path / "port.npz")
    tck.save_checkpoint(path, akw["params"],
                        teacher_params=akw["teacher_params"],
                        opt_state=akw["opt_state"], dtype=akw["dtype"])
    jp, _, jt, _ = jck.load_checkpoint(path)
    for live, loaded in ((model, jp), (state.teacher, jt)):
        ref = to_jax_params(live.state_dict())
        for layer in ref:
            for k in ("W", "b"):
                np.testing.assert_array_equal(
                    _bits(np.asarray(loaded[layer][k])),
                    _bits(ref[layer][k]), err_msg=f"{layer}/{k}")
    if dtype == "int8":
        with np.load(path) as z:
            assert "teacher/fc1/W@i8" in z.files
    os.remove(path)

    # the other way
    tx = optax.sgd(1e-2)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = JState(params=jparams, opt_state=tx.init(jparams),
                    teacher_params=jax.tree_util.tree_map(jnp.asarray,
                                                          tparams))
    jkw = jcommon.anchor_save_kwargs(mcfg, jstate)
    params_d = jstate.params
    jcommon.adopt_anchor_rounding(jstate, mcfg)
    jpath = str(tmp_path / "jax.npz")
    jck.save_checkpoint(jpath, params_d, **jkw)
    p, _, t, _ = tck.load_checkpoint(jpath)
    for loaded, ref in ((p, jstate.params), (t, jstate.teacher_params)):
        for layer in ref:
            for k in ("W", "b"):
                np.testing.assert_array_equal(
                    _bits(loaded[layer][k]), _bits(np.asarray(ref[layer][k])),
                    err_msg=f"{layer}/{k}")
