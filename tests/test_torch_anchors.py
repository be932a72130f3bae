"""The resume-anchor levers on the port: ``ckpt_dtype`` bfloat16/int8
anchors, ``ckpt_full_every`` replay and ``async_checkpoint``.

The codecs must be bit-equal to the JAX package's on the same arrays
(either package reads the other's anchors), and crash-resume must be
bit-identical to an uninterrupted campaign, as
``tests/test_ckpt_every.py`` asks of the JAX engine: the crash is a run
whose ``curr_weights.npz`` writes are dropped, which is what a kill after
the round's ``state.json`` leaves on disk.  Also: a JAX-trained Adam
state (f32 and bf16 anchor) resumes in the port and its next finetune
matches JAX's within ``tests/test_torch_train.py``'s Adam tolerance.

Full-width PW1 checkpoints are ~80-250 MB, so every test's ``tmp_path``
is removed when the test ends, passed or not, and a run whose files have
been read is removed before the next one starts.
"""

import os
import shutil
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nnal_tpu.engine import common as jcommon
from nnal_tpu.models import checkpoint as jck
from nnal_tpu.models.cnn import init_cnn as j_init_cnn
from nnal_tpu.models.specs import create_pw1 as j_create_pw1
from nnal_tpu.models.train import TrainState as JState
from nnal_tpu.models.train import make_scanned_finetune
from nnal_tpu_torch.core.config import ExperimentConfig
from nnal_tpu_torch.data.io import synthetic_subject
from nnal_tpu_torch.engine import common as tcommon
from nnal_tpu_torch.engine import pw_experiment as pw_mod
from nnal_tpu_torch.models import checkpoint as tck
from nnal_tpu_torch.models.bridge import (
    from_jax_params,
    to_jax_params,
    to_jax_tensors,
)
from nnal_tpu_torch.models.cnn import CNN
from nnal_tpu_torch.models.optim import (
    load_opt_state,
    opt_state_leaves,
    opt_state_tensors,
)
from nnal_tpu_torch.models.specs import create_pw1
from nnal_tpu_torch.models.train import (
    TrainState,
    build_batch_index_matrix,
    finetune_steps,
)

torch.set_num_threads(1)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest keeps every test's ``tmp_path`` for three sessions: drop
    these checkpoints as soon as the test ends."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({4: np.uint32, 2: np.uint16, 1: np.uint8}[a.itemsize])


def _arrays():
    """JAX-layout arrays: a conv filter (HWIO) with an all-zero output
    channel and an exact half-way case (x / s = 2.5), an fc matrix, a
    bias and a second-moment-like leaf of tiny values."""
    rng = np.random.default_rng(0)
    conv = rng.normal(size=(3, 3, 2, 8)).astype(np.float32)
    conv[..., 3] = 0.0
    conv[..., 5] = 0.0
    conv[0, 0, 0, 5] = 127 * 2.0 ** -4     # s = 2^-4 exactly
    conv[1, 1, 1, 5] = 2.5 * 2.0 ** -4     # -> 2 (half to even)
    conv[2, 2, 1, 5] = -3.5 * 2.0 ** -4    # -> -4
    fc = (rng.normal(size=(50, 7)) * 0.03).astype(np.float32)
    b = rng.normal(size=(7,)).astype(np.float32)
    nu = (rng.random(size=(50, 7)) * 1e-9).astype(np.float32)
    return {"conv": conv, "fc": fc, "b": b, "nu": nu}


def _port_layout(a):
    return torch.from_numpy(np.ascontiguousarray(
        a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T))


@pytest.mark.parametrize("codec", ["bfloat16", "int8"])
def test_codecs_bit_equal_to_jax(codec):
    for name, a in _arrays().items():
        if codec == "bfloat16":
            got = tck.round_trip_bf16(torch.from_numpy(a)).numpy()
            np.testing.assert_array_equal(
                _bits(got), _bits(np.asarray(jck.round_trip_bf16(a))), name)
            continue
        if a.ndim < 2:
            continue
        q, s = (v.numpy() for v in tck.i8_parts(torch.from_numpy(a), -1))
        jq, js = jck._i8_parts(jnp.asarray(a))         # JAX, op by op
        np.testing.assert_array_equal(q, np.asarray(jq), name)
        np.testing.assert_array_equal(_bits(s), _bits(np.asarray(js)), name)
        tq, ts = tck.i8_parts(_port_layout(a), 0)      # port layout, torch
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(_port_layout(q).numpy(), tq.numpy())
        np.testing.assert_array_equal(
            _bits(_port_layout(s).numpy()), _bits(ts.numpy()))
        got = tck.round_trip_int8(_port_layout(a), 0)
        want = _port_layout(np.asarray(jq).astype(np.float32)
                            * np.asarray(js)).numpy()
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want), name)
        # the JAX package's jitted encode (its device leaves and its
        # adoption) lets XLA turn / 127 into * (1/127): its scales may
        # sit one f32 ulp from the division of its host encode and the
        # port (ROADMAP Queue 3)
        _, sj = jax.jit(jck._i8_parts)(jnp.asarray(a))
        ulps = np.abs(_bits(np.asarray(sj)).astype(np.int64)
                      - _bits(s).astype(np.int64))
        assert ulps.max() <= 1, name
    conv_q, _ = tck.i8_parts(torch.from_numpy(_arrays()["conv"]), -1)
    assert conv_q[1, 1, 1, 5] == 2 and conv_q[2, 2, 1, 5] == -4
    assert not conv_q[..., 3].any()


def _payload():
    a = _arrays()
    params = {"conv1": {"W": a["conv"], "b": a["b"][:1].repeat(8)},
              "fc1": {"W": a["fc"], "b": a["b"]}}
    opt = [np.asarray(3, np.int32), a["fc"] * 0.1, a["nu"]]
    return params, opt


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_file_encodes_bit_equal_to_jax(tmp_path, dtype):
    """The JAX writer, the port's host (numpy) encode and its tensor
    encode write the same entries, bit for bit."""
    params, opt = _payload()
    al = {"step": 3, "round": 1}
    jck.save_checkpoint(str(tmp_path / "j.npz"), params, al_state=al,
                        opt_state=opt, dtype=dtype)
    tck.save_checkpoint(str(tmp_path / "h.npz"), params, al_state=al,
                        opt_state=opt, dtype=dtype)
    tparams = {l: {k: torch.from_numpy(v) for k, v in d.items()}
               for l, d in params.items()}
    topt = [opt[0]] + [torch.from_numpy(v) for v in opt[1:]]
    tck.save_checkpoint(str(tmp_path / "t.npz"), tparams, al_state=al,
                        opt_state=topt, dtype=dtype)
    with np.load(tmp_path / "j.npz") as j:
        want = {k: j[k] for k in j.files}
    marks = {"bfloat16": "@bf16", "int8": "@i8"}
    assert any(k.endswith(marks[dtype]) for k in want)
    for f in ("h.npz", "t.npz"):
        with np.load(tmp_path / f) as z:
            assert sorted(z.files) == sorted(want), f
            for k in z.files:
                assert z[k].dtype == want[k].dtype, (f, k)
                np.testing.assert_array_equal(z[k], want[k], f"{f} {k}")
    # and each loader decodes the other's file to the same float32 values
    jp = jck.load_checkpoint(str(tmp_path / "h.npz"))[0]
    tp = tck.load_checkpoint(str(tmp_path / "j.npz"))[0]
    for layer in params:
        for k in params[layer]:
            np.testing.assert_array_equal(_bits(np.asarray(jp[layer][k])),
                                          _bits(tp[layer][k]))


def _port_state(shape=(9, 9, 1), steps=2):
    """A port PW1 with Adam moments from two finetune steps."""
    spec = j_create_pw1(2, 0.0, shape)
    params, _ = j_init_cnn(spec, jax.random.key(0))
    model = CNN(create_pw1(2, 0.0, shape))
    model.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-3)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(16,) + shape).astype(np.float32))
    y = torch.from_numpy(np.eye(2, dtype=np.float32)[np.arange(16) % 2])
    idx = np.tile(np.arange(16), (steps, 1))
    finetune_steps(TrainState(model, opt), x, y, idx,
                   np.ones(idx.shape, np.float32), torch.ones(2))
    return spec, model, opt


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_anchors_cross_read(tmp_path, dtype):
    """A port anchor loads in the JAX package to the port's adopted live
    values; a JAX anchor loads in the port to the JAX engine's adopted
    values."""
    mcfg = types.SimpleNamespace(ckpt_dtype=dtype,
                                 opt_reset_per_round=False)
    spec, model, opt = _port_state()
    state = TrainState(model, opt)
    akw = tcommon.anchor_save_kwargs(mcfg, state)
    assert tcommon.adopt_anchor_rounding(state, mcfg)
    path = str(tmp_path / "port.npz")
    tck.save_checkpoint(path, akw["params"], opt_state=akw["opt_state"],
                        dtype=akw["dtype"])
    live = to_jax_params(model.state_dict())
    jparams = jck.load_checkpoint(path)[0]
    for layer in live:
        for k in live[layer]:
            np.testing.assert_array_equal(
                _bits(np.asarray(jparams[layer][k])), _bits(live[layer][k]))
    tx = optax.adam(1e-3, eps=1e-3)
    jopt = jck.restore_opt_state(path, tx.init(jparams))
    for a, b in zip(jax.tree_util.tree_leaves(jopt),
                    opt_state_leaves(opt, model)):
        np.testing.assert_array_equal(_bits(np.asarray(a)), _bits(b))

    # the other way: a JAX state, adopted and saved by the JAX engine's rule
    jstate = JState(params=jax.tree_util.tree_map(jnp.asarray, live),
                    opt_state=jax.tree_util.tree_unflatten(
                        jax.tree_util.tree_structure(jopt),
                        [jnp.asarray(v) * 1.37 if v.dtype == np.float32
                         else jnp.asarray(v) for v in
                         jax.tree_util.tree_leaves(jopt)]))
    jkw = jcommon.anchor_save_kwargs(mcfg, jstate)
    params_d = jstate.params
    assert jcommon.adopt_anchor_rounding(jstate, mcfg)
    jpath = str(tmp_path / "jax.npz")
    jck.save_checkpoint(jpath, params_d, **jkw)
    tparams = tck.load_checkpoint(jpath)[0]
    for layer in tparams:
        for k in tparams[layer]:
            np.testing.assert_array_equal(
                _bits(tparams[layer][k]),
                _bits(np.asarray(jstate.params[layer][k])))
    for a, b in zip(tck.load_opt_leaves(jpath),
                    jax.tree_util.tree_leaves(jstate.opt_state)):
        np.testing.assert_array_equal(_bits(a), _bits(np.asarray(b)))


# --------------------------------------------------------------- the engine

VOLS = synthetic_subject(shape=(24, 24, 8), n_modalities=1, seed=0)


def _cfg(**over):
    pars = {
        "model_name": "PW", "nclass": 2, "patch_shape": (9, 9, 1),
        "grid_spacing": 5, "k": 3, "B": 16, "ntb": 256, "b": 32,
        "epochs": 1, "MC_iters": 2, "learning_rate": 3e-4,
        "optimizer_name": "Adam", "dropout_rate": 0.2, "init_size": 4,
        "seed": 7,
    }
    pars.update(over)
    return ExperimentConfig.from_pars(pars)


def _fresh(root, **over):
    expr = pw_mod.PWExperiment(str(root), _cfg(**over), device="cpu")
    expr.attach_subject(*VOLS)
    return expr


def _start(root, **over):
    expr = _fresh(root, **over)
    expr.prep_data()
    expr.add_method("random")
    return expr


def _artifacts(root):
    mdir = os.path.join(str(root), "random")
    qdir = os.path.join(mdir, "queries")
    queries = {f: open(os.path.join(qdir, f)).read()
               for f in sorted(os.listdir(qdir))}
    with open(os.path.join(mdir, "perf_evals.txt")) as f:
        evals = f.read()
    with np.load(os.path.join(mdir, "curr_weights.npz")) as z:
        entries = {k: z[k] for k in z.files}
    return queries, evals, entries


def _assert_identical(a, b):
    assert a[0] == b[0], "query journals differ"
    assert a[1] == b[1], "per-round evals differ"
    assert sorted(a[2]) == sorted(b[2])
    for k in a[2]:
        assert a[2][k].dtype == b[2][k].dtype, k
        np.testing.assert_array_equal(a[2][k], b[2][k], err_msg=k)


class _Writes:
    """Wraps the engine's ``save_checkpoint``: records each resume-point
    write (its thread, and the file read back), or drops them all
    (``drop``: a crash before they land)."""

    def __init__(self, drop=False):
        self.drop, self.saved, self.threads = drop, [], []
        self.orig = pw_mod.save_checkpoint

    def __enter__(self):
        def patched(path, *a, **kw):
            if os.path.basename(path) != "curr_weights.npz":
                return self.orig(path, *a, **kw)
            self.threads.append(threading.current_thread())
            if self.drop:
                self.saved.append(None)
                return None
            self.orig(path, *a, **kw)
            with np.load(path) as z:
                self.saved.append({k: z[k] for k in z.files})
            return None

        pw_mod.save_checkpoint = patched
        return self

    def __exit__(self, *exc):
        pw_mod.save_checkpoint = self.orig


def test_ckpt_full_every_writes_two_full_saves(tmp_path):
    """K = 3 over 4 rounds: the round-3 anchor and the loop-end full save,
    not one per round; the file names round 4."""
    expr = _start(tmp_path / "a", ckpt_full_every=3)
    with _Writes() as w:
        res = expr.run_method("random", 12)
    assert res["n_queries"] == 12 and len(w.saved) == 2
    al = tck.load_checkpoint(
        str(tmp_path / "a" / "random" / "curr_weights.npz"))[3]
    assert al["round"] == 4
    with open(tmp_path / "a" / "random" / "phases.jsonl") as f:
        rows = f.read().splitlines()
    assert len(rows) == 5 and '"tail": true' in rows[-1]


# (overrides, queries of the crashed run): f32 crashes at round 2, before
# any anchor; bf16 and int8 after the round-3 anchor whose write was lost
# (the live process adopted its rounding), so replay must re-adopt it
REPLAY = {
    "float32": ({"ckpt_full_every": 3}, 6),
    "bfloat16": ({"ckpt_full_every": 3, "ckpt_dtype": "bfloat16",
                  "opt_reset_per_round": True}, 9),
    "int8": ({"ckpt_full_every": 3, "ckpt_dtype": "int8"}, 9),
}


@pytest.mark.parametrize("dtype", list(REPLAY))
def test_crash_replay_is_bit_identical(tmp_path, dtype):
    over, crash_at = REPLAY[dtype]
    res = _start(tmp_path / "a", **over).run_method("random", 12)
    assert res["n_queries"] == 12
    ref = _artifacts(tmp_path / "a")
    shutil.rmtree(tmp_path / "a")          # held in memory from here on
    if dtype != "float32":
        mark = "@bf16" if dtype == "bfloat16" else "@i8"
        assert any(k.endswith(mark) for k in ref[2])
        has_opt = any(k.startswith("opt/") for k in ref[2])
        assert has_opt == (dtype == "int8")
    expr = _start(tmp_path / "b", **over)
    with _Writes(drop=True) as w:
        expr.run_method("random", crash_at)
    assert len(w.saved) >= 1
    res2 = _fresh(tmp_path / "b", **over).run_method("random", 12)
    assert res2["n_queries"] == 12
    _assert_identical(ref, _artifacts(tmp_path / "b"))


def test_async_checkpoint_file_equals_the_round_it_names(tmp_path):
    """The writer thread writes a snapshot taken at the save: each file
    equals the synchronous run's file for the same round, although the
    live weights moved on in place while it was written."""
    over = {"ckpt_full_every": 2, "ckpt_dtype": "bfloat16"}
    expr = _start(tmp_path / "s", **over)
    with _Writes() as sync:
        expr.run_method("random", 12)
    shutil.rmtree(tmp_path / "s")          # its files are in sync.saved
    expr = _start(tmp_path / "a", async_checkpoint=True, **over)
    with _Writes() as asyn:
        expr.run_method("random", 12)
    assert len(sync.saved) == len(asyn.saved) == 2
    assert all(t is threading.main_thread() for t in sync.threads)
    assert all(t is not threading.main_thread() for t in asyn.threads)
    for s, a in zip(sync.saved, asyn.saved):
        assert sorted(s) == sorted(a)
        for k in s:
            np.testing.assert_array_equal(s[k], a[k], err_msg=k)
    rounds = [tck.json.loads(s["__al_state__"].tobytes())["round"]
              for s in asyn.saved]
    assert rounds == [2, 4]


def test_writer_error_surfaces_on_wait():
    w = tck.AsyncCheckpointWriter()

    def boom():
        raise OSError("disk full")

    w.submit(boom)
    with pytest.raises(OSError, match="disk full"):
        w.wait()
    w.wait()                      # raised once, then cleared
    done = []
    w.submit(boom)
    with pytest.raises(OSError):  # the next submit waits first
        w.submit(lambda: done.append(1))
    w.submit(lambda: done.append(1))
    w.wait()
    assert done == [1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_adam_state_resumes_in_the_port(tmp_path, dtype):
    """A JAX-trained Adam state, saved by the JAX package (f32, or a bf16
    anchor after the JAX engine's adoption), resumes in the port: the
    next finetune step matches JAX's at Adam eps 1e-3 within
    ``tests/test_torch_train.py``'s atol 1e-5.  (Longer continuations
    part further on this data: its loss rises from 3.4 to 5.7 in two
    steps, which amplifies f32 summation-order noise.)"""
    shape = (9, 9, 1)
    spec = j_create_pw1(2, 0.0, shape)
    params, _ = j_init_cnn(spec, jax.random.key(0))
    tx = optax.adam(1e-3, eps=1e-3)
    run = make_scanned_finetune(spec, tx, batch_size=16)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(40,) + shape).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=40)]
    first = build_batch_index_matrix(40, 16, 1, np.random.default_rng(1))
    idx, w = build_batch_index_matrix(40, 16, 1, np.random.default_rng(2))
    mats = [first, (idx[:1], w[:1])]      # then the next step alone

    def jrun(p, o, m):
        return run(p, o, jnp.asarray(x), jnp.asarray(y), jnp.asarray(m[0]),
                   jnp.asarray(m[1]), jnp.ones(2, jnp.float32),
                   jax.random.key(3))[:2]

    p1, o1 = jrun(params, tx.init(params), mats[0])
    count = float(np.asarray(jax.tree_util.tree_leaves(o1)[0]))
    path = str(tmp_path / "jax.npz")
    mcfg = types.SimpleNamespace(ckpt_dtype=dtype,
                                 opt_reset_per_round=False)
    jstate = JState(params=p1, opt_state=o1)
    jkw = jcommon.anchor_save_kwargs(mcfg, jstate)
    jcommon.adopt_anchor_rounding(jstate, mcfg)
    jck.save_checkpoint(path, p1, al_state={"step": 3, "round": 1}, **jkw)
    p2, _ = jrun(jstate.params, jstate.opt_state, mats[1])

    model = CNN(create_pw1(2, 0.0, shape))
    model.load_state_dict(from_jax_params(tck.load_checkpoint(path)[0]))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-3)
    load_opt_state(opt, model, tck.load_opt_leaves(path))
    assert {float(s["step"]) for s in opt.state.values()} == {count}
    finetune_steps(TrainState(model, opt), torch.from_numpy(x),
                   torch.from_numpy(y), *mats[1], torch.ones(2))
    got = to_jax_params(model.state_dict())
    for layer in got:
        for k in ("W", "b"):
            np.testing.assert_allclose(got[layer][k],
                                       np.asarray(p2[layer][k]), rtol=0,
                                       atol=1e-5, err_msg=f"{layer}/{k}")


def test_device_snapshot_is_a_copy():
    """``to_jax_tensors`` / ``opt_state_tensors`` (the async writer's
    payload) do not alias the live tensors."""
    _, model, opt = _port_state(steps=1)
    ref = to_jax_params(model.state_dict())["fc1"]["W"]
    snap = to_jax_tensors(model.state_dict())
    leaves = opt_state_tensors(opt, model)
    before = [v.clone() for v in leaves[1:]]
    w0 = snap["fc1"]["W"].clone()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
        for st in opt.state.values():
            st["exp_avg"].add_(1.0)
    assert torch.equal(snap["fc1"]["W"], w0)
    assert all(torch.equal(a, b) for a, b in zip(leaves[1:], before))
    np.testing.assert_array_equal(snap["fc1"]["W"].numpy(), ref)
