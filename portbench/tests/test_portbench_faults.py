"""Whole runs on the CPU at tiny sizes, past the look for a card: a sound
program comes out correct, and each fault a cell can have, planted in
the timed path, comes out not correct."""

import numpy as np
import pytest

import tiny


def _failed(out):
    return sorted(n for n, c in out["checks"].items()
                  if not c["value"] <= c["limit"])


@pytest.mark.parametrize("workload", sorted(tiny.TINY))
def test_sound_run_is_correct(workload):
    out = tiny.run(workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"


# The round's faults are planted in the window's rounds (1..n) only: round 0
# runs in set-up, and the check has to see what the timed rounds did.  The
# window is long enough for rounds 1 and 2, which the reference follows.
ROUND_S = 4.0
def test_round_state_left_unchanged(monkeypatch):
    from nnal_tpu_torch.engine import pw_experiment

    steps = pw_experiment.finetune_steps

    def unchanged(state, x_all, y_all, idx_mat, *a, **kw):
        if state.step == 0:
            return steps(state, x_all, y_all, idx_mat, *a, **kw)
        state.step += int(idx_mat.shape[0])
        return []

    monkeypatch.setattr(pw_experiment, "finetune_steps", unchanged)
    out = tiny.run("pw1.round.entropy", seconds=ROUND_S)
    assert not out["correct"] and "window_change_med" in _failed(out)
    assert "train_change_med" not in _failed(out)


def test_round_half_batch_left_out(monkeypatch):
    from nnal_tpu_torch.engine import pw_experiment

    steps = pw_experiment.finetune_steps

    def half(state, x_all, y_all, idx_mat, w_mat, *a, **kw):
        w = np.array(w_mat)
        if state.step:
            w[:, w.shape[1] // 2:] = 0.0
        return steps(state, x_all, y_all, idx_mat, w, *a, **kw)

    monkeypatch.setattr(pw_experiment, "finetune_steps", half)
    out = tiny.run("pw1.round.entropy", seconds=ROUND_S)
    assert not out["correct"]
    assert "train_change_med" not in _failed(out)


def test_round_pick_altered(monkeypatch):
    from nnal_tpu_torch.engine import pw_experiment

    query = pw_experiment.cnn_query
    calls = []

    def altered(ctx, method):
        q = np.array(query(ctx, method))
        calls.append(1)
        if len(calls) > 1:
            order = np.argsort(np.abs(np.asarray(ctx.evaluator.evaluate(
                ctx.params, ctx.pool_inds, ("posteriors",))["posteriors"])
                - 0.5))
            q[0] = order[-1]    # the most certain voxel in place of one
        return q

    monkeypatch.setattr(pw_experiment, "cnn_query", altered)
    out = tiny.run("pw1.round.entropy", seconds=ROUND_S)
    assert not out["correct"] and "pick_gap" in _failed(out)


def test_round_prediction_altered(monkeypatch):
    from nnal_tpu_torch.scoring.grid_eval import GridPoolEvaluator

    evaluate = GridPoolEvaluator.evaluate

    def altered(self, model, inds, ops=("posteriors",), *a, **kw):
        out = evaluate(self, model, inds, ops, *a, **kw)
        if "prediction" in out:
            p = np.array(out["prediction"])
            p[len(p) // 2] = 1 - p[len(p) // 2]
            out["prediction"] = p
        return out

    monkeypatch.setattr(GridPoolEvaluator, "evaluate", altered)
    out = tiny.run("pw1.round.entropy", seconds=ROUND_S)
    assert not out["correct"] and "final_eval_gap" in _failed(out)


def test_patchwise_answer_altered(monkeypatch):
    from nnal_tpu_torch.evaluation import inference

    full = inference.full_volume_patchwise

    def altered(ev, model, op="prediction"):
        v = np.array(full(ev, model, op))
        v.reshape(-1)[::7] = 1.0 - v.reshape(-1)[::7]
        return v

    monkeypatch.setattr(inference, "full_volume_patchwise", altered)
    out = tiny.run("pw1.serve.f32")
    assert not out["correct"] and _failed(out) == ["logodds_err"]


@pytest.mark.parametrize("fault", ["answer", "half_batch"])
def test_dense_faults(monkeypatch, fault):
    from nnal_tpu_torch.evaluation.inference import FCNInference

    segment = FCNInference.segment

    def broken(self, model, vol, op="prediction", *a, **kw):
        if fault == "half_batch":
            # the second half of each batch never reaches the model
            vol = np.array(vol)
            for lo in range(0, vol.shape[0], self.batch):
                vol[lo + (self.batch + 1) // 2:lo + self.batch] = 0.0
            return segment(self, model, vol, op, *a, **kw)
        out = np.array(segment(self, model, vol, op, *a, **kw))
        out[..., 1] = 1.0 - out[..., 1]
        return out

    monkeypatch.setattr(FCNInference, "segment", broken)
    out = tiny.run("fcd103.serve.f32")
    assert not out["correct"] and _failed(out) == ["post_err"]
