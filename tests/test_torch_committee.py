"""The committee of ensemble/QBC-JS in the port's engine, and
crash-resume == continue for the MC and committee methods (CPU).

* The copies: members are finetuned deep copies, each with a fresh
  optimizer at the main state's step; the main model and its Adam state
  do not move, and no member shares a tensor with it.
* resume == continue: ``BALD`` (MC masks keyed on the round's seed) and
  ``QBC-JS`` (member streams keyed on round and optimizer step) with
  ``ckpt_full_every`` 2, the resume-point writes of a first run dropped:
  weights file, query journal and ``perf_evals.txt`` bit-identical."""

import os
import shutil

import numpy as np
import pytest
import torch

from nnal_tpu_torch.core.config import ExperimentConfig
from nnal_tpu_torch.data.io import synthetic_subject
from nnal_tpu_torch.engine import pw_experiment as pw_mod
from nnal_tpu_torch.models.checkpoint import load_checkpoint
from nnal_tpu_torch.models.train import init_train_state

torch.set_num_threads(1)

# 10 blobs: 14% of the voxels positive, so the labeled sets hold both
# classes and the finetunes have gradients to follow
VOLS = synthetic_subject(shape=(16, 16, 4), n_modalities=2, n_blobs=10,
                         seed=1)
PARS = {
    "model_name": "PW", "nclass": 2, "patch_shape": (9, 9, 1),
    "grid_spacing": 2, "k": 8, "B": 20, "ntb": 256, "b": 16,
    "epochs": 1, "MC_iters": 2, "n_ensemble": 2, "learning_rate": 1e-3,
    "optimizer_name": "Adam", "dropout_rate": 0.5, "init_size": 16,
    "seed": 5,
}


@pytest.fixture
def tmp_path(tmp_path):
    """Drop the checkpoints (tens of MB each) as soon as the test ends."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


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


def test_committee_copies_leave_the_main_state(tmp_path):
    expr = _start(tmp_path, "QBC-JS")
    spec = expr.build_model()
    j = pw_mod.MethodJournal(str(tmp_path), "QBC-JS")
    train, _ = j.membership()
    labels = VOLS[1].ravel()[train]
    assert 0 < labels.sum() < len(labels)
    model = expr._load_model(spec, load_checkpoint(
        j.path("curr_weights.npz"))[0])
    state = init_train_state(model, "Adam", 1e-3)
    expr.finetune(state, train)          # Adam moments and a step count
    before = {k: v.clone() for k, v in model.state_dict().items()}
    moments = {id(p): {k: v.clone() for k, v in s.items()
                       if torch.is_tensor(v)}
               for p, s in state.optimizer.state.items()}
    step = state.step
    members = expr._build_committee(spec, state, train, round_id=1)
    assert len(members) == 2 and state.step == step
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for p, s in state.optimizer.state.items():
        for k, v in moments[id(p)].items():
            assert torch.equal(s[k], v), k
    main_ptrs = {p.data_ptr() for p in model.parameters()}
    for m in members:
        assert m is not model
        assert not main_ptrs & {p.data_ptr() for p in m.parameters()}
        assert not torch.equal(m.fc1.weight, model.fc1.weight)
    # each member has its own streams
    assert not torch.equal(members[0].fc1.weight, members[1].fc1.weight)
    # an empty labeled set without weight files: n_ensemble fresh inits
    fresh = expr._build_committee(spec, state, np.zeros(0, np.int64), 0)
    assert len(fresh) == 2 and not torch.equal(fresh[0].fc1.weight,
                                               fresh[1].fc1.weight)


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


@pytest.mark.parametrize("method", ["BALD", "QBC-JS"])
def test_crash_resume_equals_continue(tmp_path, method):
    """3 rounds with anchors every 2; the crashed run loses every
    resume-point write of its 2 rounds, so the resumed process replays
    both finetunes from the initial weights and runs round 3 live."""
    n = 3 * PARS["k"]
    _start(tmp_path / "a", method, ckpt_full_every=2).run_method(method, n)
    ref = _artifacts(tmp_path / "a", method)
    shutil.rmtree(tmp_path / "a")
    expr = _start(tmp_path / "b", method, ckpt_full_every=2)
    with _DropResumeWrites() as w:
        expr.run_method(method, 2 * PARS["k"])
    assert w.dropped >= 1
    res = _fresh(tmp_path / "b", ckpt_full_every=2).run_method(method, n)
    assert res["n_queries"] == n
    got = _artifacts(tmp_path / "b", method)
    assert got[0] == ref[0] and len(got[0]) == 3, "query journals differ"
    assert got[1] == ref[1], "per-round evals differ"
    assert sorted(got[2]) == sorted(ref[2])
    for k in ref[2]:
        np.testing.assert_array_equal(got[2][k], ref[2][k], err_msg=k)
