"""bf16 on the port (``model.dtype`` / ``train_dtype`` bfloat16) against
the JAX package's bf16, and against the port's own f32.

PW1 at 15x15x2, b 64, JAX weights from key 0 loaded into the port.  The
two frameworks round bf16 at the same places on the host (each conv and
fc accumulates in f32, adds the bias in f32 and rounds once), but sum in
different orders, so one bf16 ulp can differ here and there; p1 is held
within 5e-3 and selections by overlap (bf16 logits take few distinct
values, so a stable argsort breaks wide ties by index and ranks are not
comparable).  Shrunk gradients: correlation > 0.995 and max |delta| <
0.1 x max |JAX|; the port's bf16 against its f32 meets the thresholds the
JAX package holds itself to (``tests/test_bf16_fim.py``).  Training:
master weights stay f32; one SGD step and an Adam finetune (eps 1e-3, as
in ``tests/test_torch_train.py``) against JAX's bf16 runs.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nnal_tpu.cli.expr_handler import create_expr as j_create_expr
from nnal_tpu.cli.expr_handler import do_expr as j_do_expr
from nnal_tpu.models.cnn import apply_cnn, cast_float_params
from nnal_tpu.models.cnn import init_cnn as j_init_cnn
from nnal_tpu.models.optim import make_optimizer as j_make_optimizer
from nnal_tpu.models.specs import create_pw1 as j_create_pw1
from nnal_tpu.models.train import make_scanned_finetune, make_train_step
from nnal_tpu.ops.scoring_fused import make_pool_scorer as j_make_scorer
from nnal_tpu.ops.scoring_fused import pool_score_fused as j_fused
from nnal_tpu.scoring.fisher import a_matrices as j_a_matrices
from nnal_tpu.scoring.sdp import fi_query_distribution as j_fiq
from nnal_tpu_torch import ops
from nnal_tpu_torch.cli import expr_handler as t_cli
from nnal_tpu_torch.models.bridge import from_jax_params, to_jax_params
from nnal_tpu_torch.models.cnn import CNN
from nnal_tpu_torch.models.specs import create_pw1
from nnal_tpu_torch.models.train import (
    TrainState,
    build_batch_index_matrix,
    finetune_steps,
)
from nnal_tpu_torch.scoring.fisher import a_matrices
from nnal_tpu_torch.scoring.sdp import fi_query_distribution
from test_torch_parallel_engine import link_npz

torch.set_num_threads(1)

SHAPE = (15, 15, 2)
BF16 = torch.bfloat16


def _setup(b=64, shape=SHAPE, dropout=0.5):
    spec = j_create_pw1(2, dropout, shape)
    params, _ = j_init_cnn(spec, jax.random.key(0))
    x = np.array(jax.random.normal(jax.random.key(1), (b,) + shape))
    model = CNN(create_pw1(2, dropout, shape))
    model.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    return spec, params, x, model


def _top(p1, n):
    return set(np.argsort(np.abs(np.asarray(p1) - 0.5), kind="stable")[:n])


def _jax_p1(spec, params, x, cd):
    if cd is not None:
        params, x = cast_float_params(params, cd), jnp.asarray(x).astype(cd)
    return np.asarray(apply_cnn(spec, params, x).posteriors[:, 1])


def test_bf16_forward_matches_jax():
    spec, params, x, model = _setup()
    with torch.no_grad():
        out = model(torch.from_numpy(x).to(BF16))
        p32 = model(torch.from_numpy(x)).posteriors[:, 1].numpy()
    assert out.feature.dtype == BF16 and out.logits.dtype == torch.float32
    p16 = out.posteriors[:, 1].numpy()
    j16 = _jax_p1(spec, params, x, jnp.bfloat16)
    assert np.abs(p16 - j16).max() < 5e-3
    assert len(_top(p16, 16) & _top(j16, 16)) >= 15
    # bf16 is not f32 (no silent fall-back), and stays within bf16 reach
    assert 0 < np.abs(p16 - p32).max() < 0.05


def _q(A, k=5):
    return fi_query_distribution(A, 0.0, None, k, device="cpu")


def _j_q(shrunk, p1, k=5):
    A = np.asarray(j_a_matrices(jnp.asarray(shrunk),
                                jnp.asarray(p1, jnp.float32), 1e-3))
    return j_fiq(A, 0.0, None, k)


def _fim_agree(got, want, scale_rtol, corr_min):
    s, w = np.asarray(got["shrunk"]), np.asarray(want["shrunk"])
    corr = np.corrcoef(s.ravel(), w.ravel())[0, 1]
    assert corr > corr_min, corr
    assert np.abs(s - w).max() < scale_rtol * np.abs(w).max()


@pytest.mark.parametrize("entry", ["pool_score_fused", "make_pool_scorer"])
def test_bf16_fim_matches_jax(entry):
    spec, params, x, model = _setup(b=32)
    xt = torch.from_numpy(x)
    if entry == "pool_score_fused":
        got = ops.pool_score_fused(model, xt, True, BF16)
        want = j_fused(spec, params, jnp.asarray(x), True, jnp.bfloat16)
    else:
        got = ops.make_pool_scorer()(model, xt)
        want = j_make_scorer(spec)(params, jnp.asarray(x))
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    assert got["shrunk"].dtype == np.float32
    assert np.abs(got["p1"] - want["p1"]).max() < 5e-3
    _fim_agree(got, want, 0.1, 0.995)
    q = _q(a_matrices(torch.from_numpy(got["shrunk"]),
                      torch.from_numpy(got["p1"]), 1e-3))
    qj = _j_q(want["shrunk"], want["p1"])
    assert len(set(np.argsort(-q)[:8]) & set(np.argsort(-qj)[:8])) >= 6


def test_make_pool_scorer_defaults_to_bf16_without_fim():
    spec, params, x, model = _setup()
    scorer = ops.make_pool_scorer(with_fim=False)
    assert scorer.compute_dtype == BF16
    got = scorer(model, torch.from_numpy(x))
    assert set(got) == {"p1", "uncertainty"}
    want = np.asarray(j_make_scorer(spec, with_fim=False)(
        params, jnp.asarray(x))["p1"])
    assert np.abs(got["p1"].numpy() - want).max() < 5e-3


def test_port_bf16_vs_its_f32():
    """The thresholds of ``tests/test_bf16_fim.py`` (the JAX package's own
    bf16 against its f32), on the port."""
    _, _, x, model = _setup()
    xt = torch.from_numpy(x)
    r32 = {k: v.numpy() for k, v in
           ops.pool_score_fused(model, xt).items()}
    r16 = {k: v.numpy() for k, v in
           ops.pool_score_fused(model, xt, True, BF16).items()}
    assert np.isfinite(r16["shrunk"]).all()
    assert np.abs(r32["p1"] - r16["p1"]).max() < 0.05
    _fim_agree(r16, r32, 0.25, 0.99)
    assert len(_top(r32["p1"], 16) & _top(r16["p1"], 16)) >= 15
    _, _, x, model = _setup(b=32)
    xt = torch.from_numpy(x)
    q = [_q(a_matrices(r["shrunk"], r["p1"], 1e-3)) for r in (
        ops.pool_score_fused(model, xt),
        ops.pool_score_fused(model, xt, True, BF16))]
    assert len(set(np.argsort(-q[0])[:8]) & set(np.argsort(-q[1])[:8])) >= 6


def _flat(tree):
    return np.concatenate([np.asarray(tree[layer][k], np.float64).ravel()
                           for layer in sorted(tree)
                           for k in sorted(tree[layer])])


def test_bf16_sgd_step_matches_jax():
    """``tests/test_mixed_precision.py``'s one-step check, port vs JAX at
    bf16: master weights stay f32, the loss within 2e-2, and the update
    direction agrees (cosine > 0.95)."""
    shape, n = (9, 9, 1), 32
    spec, params, _, model = _setup(shape=shape, dropout=0.0)
    x = np.array(jax.random.normal(jax.random.key(1), (n,) + shape))
    y = np.eye(2, dtype=np.float32)[np.arange(n) % 2]
    tx = j_make_optimizer("SGD", 1e-2)
    step = make_train_step(spec, tx, compute_dtype=jnp.bfloat16)
    p1, _, jloss = step(jax.tree_util.tree_map(jnp.copy, params),
                        tx.init(params), jnp.asarray(x), jnp.asarray(y),
                        jax.random.key(1), jnp.asarray(0))
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=1e-2))
    losses = finetune_steps(state, torch.from_numpy(x), torch.from_numpy(y),
                            np.arange(n)[None], np.ones((1, n), np.float32),
                            torch.ones(2), compute_dtype=BF16)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    np.testing.assert_allclose(losses[0], float(jloss), rtol=2e-2)
    base = _flat(jax.tree_util.tree_map(np.asarray, params))
    dj = _flat(jax.tree_util.tree_map(np.asarray, p1)) - base
    dt = _flat(to_jax_params(model.state_dict())) - base
    cos = np.dot(dj, dt) / (np.linalg.norm(dj) * np.linalg.norm(dt))
    assert cos > 0.95, cos


def test_bf16_finetune_loss_trajectory_matches_jax():
    """Adam (eps 1e-3 in both, see ``tests/test_torch_train.py``) over 2
    epochs of ragged batches at bf16: f32 master weights and moments, the
    per-step losses within 2e-2 of JAX's bf16 scan."""
    shape, n = (9, 9, 1), 40
    spec, params, _, model = _setup(shape=shape, dropout=0.0)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n,) + shape).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=n)]
    idx_mat, w_mat = build_batch_index_matrix(n, 16, 2,
                                              np.random.default_rng(1))
    tx = optax.adam(1e-3, eps=1e-3)
    run = make_scanned_finetune(spec, tx, batch_size=16,
                                compute_dtype=jnp.bfloat16)
    _, _, jl = run(params, tx.init(params), jnp.asarray(x), jnp.asarray(y),
                   jnp.asarray(idx_mat), jnp.asarray(w_mat),
                   jnp.ones(2, jnp.float32), jax.random.key(2))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-3)
    losses = finetune_steps(TrainState(model, opt), torch.from_numpy(x),
                            torch.from_numpy(y), idx_mat, w_mat,
                            torch.ones(2), compute_dtype=BF16)
    real = w_mat.sum(1) > 0
    assert len(losses) == int(real.sum()) == 6
    np.testing.assert_allclose(losses, np.asarray(jl)[real], rtol=2e-2)
    for p in model.parameters():
        st = opt.state[p]
        assert p.dtype == st["exp_avg"].dtype == st["exp_avg_sq"].dtype \
            == torch.float32


K = 10
OVERRIDES = ("patch_shape=[9,9,1],grid_spacing=2,k=10,B=30,ntb=512,b=32,"
             "epochs=1,init_size=20,learning_rate=1e-2,optimizer_name=SGD,"
             "dropout_rate=0.0,dtype=bfloat16,train_dtype=bfloat16,"
             "ckpt_dtype=bfloat16,ckpt_full_every=2,iter_k=[10,10,0]")
METHODS = ("entropy", "core-set", "fi")


@pytest.fixture(scope="module")
def bf16_campaigns(tmp_path_factory):
    """2 rounds of each method, bf16 everywhere, through both packages'
    ``do_expr`` from one JAX-written experiment directory.  Checkpoints
    are ~40-80 MB each: a method is added just before it runs and its
    checkpoints are deleted once it has (the port's resume-point entry
    names are kept in ``res``), and the directories when the module ends,
    passed or not."""
    jdir = str(tmp_path_factory.mktemp("jax_bf16"))
    tdir = str(tmp_path_factory.mktemp("port_bf16") / "expr")
    try:
        expr = j_create_expr(jdir, OVERRIDES, synthetic=True)
        shutil.copytree(jdir, tdir, copy_function=link_npz)
        res = {}
        for m in METHODS:
            expr.add_method(m)
            shutil.copytree(os.path.join(jdir, m), os.path.join(tdir, m),
                            copy_function=link_npz)
            res[("jax", m)] = j_do_expr(jdir, m, 2 * K, synthetic=True)
            res[("port", m)] = t_cli.do_expr(tdir, m, 2 * K, synthetic=True,
                                             device="cpu")
            with np.load(os.path.join(tdir, m, "curr_weights.npz")) as z:
                res[("port_entries", m)] = list(z.files)
            for root in (jdir, tdir):
                _drop_checkpoints(os.path.join(root, m))
        yield jdir, tdir, res
    finally:
        shutil.rmtree(jdir, ignore_errors=True)
        shutil.rmtree(tdir, ignore_errors=True)


def _drop_checkpoints(d):
    for f in os.listdir(d):
        if f.endswith(".npz"):
            os.remove(os.path.join(d, f))


def _queries(root, method, it):
    return np.atleast_1d(np.loadtxt(
        os.path.join(root, method, "queries", f"{it}.txt"), dtype=np.int64))


@pytest.mark.parametrize("method", METHODS)
def test_bf16_campaign_round0_picks_overlap_jax(bf16_campaigns, method):
    jdir, tdir, res = bf16_campaigns
    t0, j0 = _queries(tdir, method, 0), _queries(jdir, method, 0)
    assert len(set(t0.tolist()) & set(j0.tolist())) >= 0.8 * len(j0)
    r = res[("port", method)]
    assert len(r["perf"]) == 2 and np.isfinite(r["perf"]).all()
    assert any(k.endswith("@bf16") for k in res[("port_entries", method)])
