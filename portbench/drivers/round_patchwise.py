"""AL rounds of a patch-wise campaign: ``PWExperiment.run_method``.

Set-up makes the subject and the initial weights from the seed, builds
the campaign (``prep_data``, ``add_method``) and runs round 0 through
``run_method``: the first finetune, and every shape's first sweep.  That
call ends with the engine's full resume point, which the window's call
resumes from, as a user's next session would.

The window is one more ``run_method`` call.  The campaign's per-round
``iter_k`` schedule is a :class:`RoundClock`, which the engine reads once
at the top of every round: the first read opens the window, and the first
read after ``seconds`` closes it and ends the campaign there.  So the
window holds whole rounds 1..n, the same rounds in every run of a seed.

``outputs`` collects what the rounds produced: round 0's pool
posteriors, every round's picks (the engine's query journal), the
window's test-grid predictions, and the resume points after round 0 and
after round n.  ``check`` has the plain reference follow the whole
campaign from the inputs the harness made (:mod:`reference.campaign`):
it takes the program's picks of every round (the picks are data, as an
annotator's answers would be) and finetunes with the batches and dropout
draws worked out from the seed and the round's optimizer step.  In the
first ``check_rounds`` rounds (round 0 and window rounds 1 and 2 at
the cell's size) it also scores its own pool with its own weights.  Later
the two campaigns part by round-off: Adam turns the sign of a near-zero
gradient into a whole step, and the picks that follow amplify it (at
the cell's size the picks part after round 3-16), so the later rounds'
picks are not judged, and round n's predictions are judged from the
program's own final state.  It
compares:

* ``train_change_med`` and ``train_moment_med``: round 0's finetune (three
  Adam steps) against the resume point after round 0, the median leaf's
  gap of the parameters' change and of Adam's first moment (the worst
  leaf's swings from seed to seed);
* ``pool_p1_err``: round 0's pool posteriors, max abs;
* ``pick_gap``: over the followed rounds, the widest gap by which a pick's
  ``|p1 - 0.5|`` (the reference's) lies above the ``k``-th smallest of
  the round's pool; a journal that is not the labeled set reads inf;
* ``window_change_med``: the median leaf's gap of the parameters' change
  over every finetune of the campaign, against the final resume point;
* ``final_eval_gap``: round n's test-grid predictions against the
  reference's logits from the final resume point (the program's state);
* ``grid_mismatch``: the pool and the test grid the program built are the
  subject's grid.

:func:`control` puts the reference campaign in the program's place, at
TF32 and choosing its own picks, optionally with a fault planted in
rounds 1..n, and hands ``check`` the same outputs.  The evaluator's
outputs are kept by a shim around the evaluator the campaign's
``make_evaluator`` returns: it holds a reference to round 0's pool
posteriors and to the window's test predictions, and copies
nothing.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List

import numpy as np
import torch

import harness
import inputs as inputs_mod
import reference
from reference import campaign, counts, patches as ref_patches, pw1 as ref


class RoundClock:
    """The campaign's ``iter_k``: ``k`` every round until the window has
    run ``seconds``, then 0, which ends the campaign at that boundary."""

    def __init__(self, k: int, window):
        self.k = int(k)
        self.window = window
        self.rounds = 0
        self.reads = 0
        self._span = None

    def __bool__(self) -> bool:
        return True

    def __len__(self) -> int:
        return 1 << 30

    def __getitem__(self, i) -> int:
        self.reads += 1
        if self.reads == 1:
            self.window.begin()
        else:
            self._span.__exit__(None, None, None)
            self.rounds += 1
            if self.window.expired():
                self.window.end()
                return 0
        self._span = self.window.span("round")
        self._span.__enter__()
        return self.k


class Recorder:
    """Keeps a reference to the evaluator's outputs that the check reads:
    the first pool posteriors (round 0's), and every test prediction once
    ``armed`` (rounds 1..n)."""

    def __init__(self, expr):
        self.armed = False
        self.pool_p1 = None
        self.test_preds = []
        make = expr.make_evaluator

        def make_evaluator(spec):
            ev = make(spec)
            evaluate = ev.evaluate

            def recorded(model, inds, ops=("posteriors",), *a, **kw):
                out = evaluate(model, inds, ops, *a, **kw)
                if "posteriors" in ops and self.pool_p1 is None:
                    self.pool_p1 = out["posteriors"]
                if self.armed and "prediction" in ops:
                    self.test_preds.append(out["prediction"])
                return out

            ev.evaluate = recorded
            return ev

        expr.make_evaluator = make_evaluator


def _pars(cfg: dict, mix: dict, seed: int) -> dict:
    pars = {
        "model_name": cfg["model_name"], "nclass": cfg["nclass"],
        "dropout_rate": cfg["dropout_rate"],
        "patch_shape": list(cfg["patch_shape"]),
        "dtype": cfg["precision"], "train_dtype": cfg["precision"],
        "seed": int(seed),
    }
    for key in ("grid_spacing", "k", "B", "b", "epochs", "init_size",
                "learning_rate", "optimizer_name", "ntb", "async_checkpoint",
                "ckpt_full_every", "class_weights"):
        pars[key] = mix[key]
    return pars


def inputs(ctx) -> dict:
    """The subject (host arrays) and the initial weights (on the device),
    from the seed."""
    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    m = int(cfg["modalities"])
    vols_t, mask_t = inputs_mod.volumes(tuple(mix["subject_shape"]), m,
                                        mix["blobs"], ctx.seed, 10, dev)
    vols, mask = vols_t.cpu().numpy(), mask_t.cpu().numpy()
    del vols_t, mask_t
    ctx.part("subject")
    d1, d2, _ = cfg["patch_shape"]
    params = inputs_mod.weights(ref.param_shapes((d1, d2), m, cfg["nclass"]),
                                ctx.seed, dev)
    ctx.part("weights")
    return {"vols": vols, "mask": mask, "params": params}


def setup(ctx, inp):
    from nnal_tpu_torch import ops
    from nnal_tpu_torch.core.config import ExperimentConfig
    from nnal_tpu_torch.engine.pw_experiment import PWExperiment
    from nnal_tpu_torch.models.bridge import to_jax_params
    from nnal_tpu_torch.models.checkpoint import save_checkpoint

    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    if dev.type == "cuda":
        ops.build_kernels()
    ctx.part("kernel_load")
    vols, mask, params = inp["vols"], inp["mask"], inp["params"]
    root = os.path.join(ctx.workdir, "campaign")
    shutil.rmtree(root, ignore_errors=True)
    expr = PWExperiment(root, ExperimentConfig.from_pars(
        _pars(cfg, mix, ctx.seed)), device=dev)
    expr.attach_subject(list(vols), mask)
    expr.prep_data()
    save_checkpoint(os.path.join(root, "init_weights.npz"),
                    to_jax_params(params))
    method = mix["strategy"]
    expr.add_method(method)
    recorder = Recorder(expr)
    ctx.part("campaign")
    expr.run_method(method, int(mix["k"]))
    with open(os.path.join(root, method, "phases.jsonl")) as f:
        harness.log("round 0 phases (s): " + " ".join(f.read().split()))
    ckpt = os.path.join(root, method, "curr_weights.npz")
    round0 = os.path.join(root, "round0.npz")
    os.link(ckpt, round0)
    ctx.part("round_0")
    return {"expr": expr, "root": root, "method": method, "round0": round0,
            "ckpt": ckpt, "recorder": recorder}


def window(ctx, st, win) -> dict:
    from nnal_tpu_torch import ops

    expr, mix = st["expr"], ctx.mix
    k = int(mix["k"])
    clock = RoundClock(k, win)
    expr.config.query.iter_k = clock
    st["recorder"].armed = True
    k2 = ops.gather.KERNEL
    launches0 = k2.launches
    # a cap the clock ends long before: 20 rounds a second
    cap = 1 + int(20 * ctx.seconds) + int(mix["init_size"]) // k
    res = expr.run_method(st["method"], k * cap)
    if clock.reads < 2 or win.t1 is None:
        raise RuntimeError("the engine did not read its iter_k schedule "
                           "at the top of each round")
    with open(os.path.join(st["root"], st["method"], "phases.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    phases = [r for r in rows if not r.get("tail")
              and 1 <= r["round"] <= clock.rounds]
    return {"units": clock.rounds, "elapsed": win.elapsed,
            "train_inds": res["train_inds"], "phases": phases,
            "k2_launches": k2.launches - launches0,
            "launches": {kk.name: kk.launches for kk in ops.KERNELS}}


def end_to_end(ctx, res) -> Dict[str, float]:
    return {"round_s": res["elapsed"] / res["units"]}


def record(ctx, st, res) -> dict:
    """What the per-layer readers read, beside the trace."""
    cfg, mix = ctx.cfg, ctx.mix
    d1, d2, d3 = cfg["patch_shape"]
    m = int(cfg["modalities"])
    f = counts.pw1_flops((d1, d2), m * d3, cfg["nclass"])
    n_test = len(np.loadtxt(os.path.join(st["root"], "test_inds.txt")))
    flops, k2_bytes = 0, 0
    for r in res["phases"]:
        scored = r["n_pool"] + int(mix["k"])
        flops += f * (scored + n_test + 3 * r["n_train"] * mix["epochs"])
        k2_bytes += counts.gather_bytes(res["train_inds"][:r["n_train"]],
                                        tuple(mix["subject_shape"]),
                                        tuple(cfg["patch_shape"]), m)
    return {"phases": res["phases"],
            "units": res["units"], "elapsed": res["elapsed"],
            "model_flops": flops,
            "k2": {"bytes": k2_bytes, "launches": res["k2_launches"],
                   "kernel": "gather_patches_kernel"}}


def outputs(ctx, st, res) -> dict:
    """What the rounds produced, read back once the window has closed."""
    root, method = st["root"], st["method"]
    rec = st["recorder"]
    n_init, k = int(ctx.mix["init_size"]), int(ctx.mix["k"])
    train = np.asarray(res["train_inds"], np.int64)
    picks = [np.atleast_1d(np.loadtxt(
        os.path.join(root, method, "queries", f"{r}.txt"), dtype=np.int64))
        for r in range((len(train) - n_init) // k)]
    return {"train_inds": train, "picks": picks,
            "pool_p1_0": rec.pool_p1,
            "round0": _jax_tree(st["round0"]),
            "final": _jax_tree(st["ckpt"]),
            "test_preds": rec.test_preds,
            "test_inds": np.loadtxt(os.path.join(root, "test_inds.txt"),
                                    dtype=np.int64),
            "init_pool": np.loadtxt(os.path.join(root,
                                                 "init_pool_inds.txt"),
                                    dtype=np.int64)}


# ------------------------------------------------------------------ check
def _jax_tree(path: str):
    """``(params, mu)`` of a resume point, the parameters and Adam's first
    moment, in the reference's layout: conv ``(out, in, kh, kw)``, fc
    ``(out, in)``.  The optimizer leaves are ``[count, *mu, *nu]``, each
    moment in sorted (layer, key) order."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    layers = sorted({k.split("/")[1] for k in flat if k.startswith("params/")})
    names = [(layer, key) for layer in layers for key in ("W", "b")]

    def port(layer, key, a):
        if key == "b":
            return f"{layer}.bias", a
        a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        return f"{layer}.weight", np.ascontiguousarray(a)

    params = dict(port(layer, key, flat[f"params/{layer}/{key}"])
                  for layer, key in names)
    opt = [flat[k] for k in sorted(k for k in flat if k.startswith("opt/"))]
    mu = dict(port(layer, key, a) for (layer, key), a
              in zip(names, opt[1:1 + len(names)]))
    return params, mu


def _on(d, dev):
    return {k: torch.as_tensor(v, device=dev) for k, v in d.items()}


def _leaf_gaps(prog: Dict, want: Dict, keep: List[str]) -> Dict[str, float]:
    """Each leaf's gap of norms, against the larger of its own reference
    norm and the median leaf's."""
    norms = {k: float(want[k].norm()) for k in keep}
    med = float(np.median(list(norms.values())))
    return {k: abs(float(prog[k].norm()) - norms[k]) / max(norms[k], med)
            for k in keep}


def _train_gaps(init, prog, theta_ref, m_ref, keep, dev):
    """The median leaf's gap of the parameters' change and of Adam's first
    moment, and the worst leaf's of each, of the program's state ``prog``
    (``(params, mu)``) against the reference's."""
    theta, m = _on(prog[0], dev), _on(prog[1], dev)
    change = _leaf_gaps({kk: theta[kk] - init[kk] for kk in keep},
                        {kk: theta_ref[kk] - init[kk] for kk in keep},
                        keep)
    moment = _leaf_gaps(m, m_ref, keep)
    return (float(np.median(list(change.values()))),
            float(np.median(list(moment.values()))),
            max(change.values()), max(moment.values()))


def _pick_gap(p1_ref, pool, picks, k: int) -> float:
    """The widest gap by which a pick's ``|p1 - 0.5|`` (the reference's)
    lies above the ``k``-th smallest of the pool's."""
    s_ref = (p1_ref - 0.5).abs()
    kth = torch.sort(s_ref).values[k - 1]
    pos = {v: i for i, v in enumerate(np.asarray(pool).tolist())}
    at = [pos.get(v) for v in np.asarray(picks).tolist()]
    if len(at) != k or None in at:
        return float("inf")
    return float((s_ref[torch.as_tensor(at, device=s_ref.device)] - kth)
                 .clamp(min=0).max())


def _grid(shape, g: int):
    """The test grid (every voxel whose in-plane coordinates are multiples
    of ``g``, all slices) and the pool (its even slices), raveled."""
    xs, ys, zs = np.meshgrid(np.arange(0, shape[0], g),
                             np.arange(0, shape[1], g), np.arange(shape[2]),
                             indexing="ij")
    test = np.ravel_multi_index((xs.ravel(), ys.ravel(), zs.ravel()), shape)
    return test, test[zs.ravel() % 2 == 0]


def _campaign(ctx, inp, train, pool) -> campaign.Campaign:
    cfg, mix = ctx.cfg, ctx.mix
    d1, d2, _ = cfg["patch_shape"]
    P = ref_patches.Patches(inp["vols"], (d1, d2), ctx.device)
    return campaign.Campaign(inp["params"], P, inp["mask"].reshape(-1),
                             train, pool, ctx.seed,
                             float(mix["learning_rate"]), int(mix["b"]),
                             int(mix["epochs"]), int(cfg["nclass"]),
                             int(mix["check_block"]))


def _keep(grads) -> List[str]:
    """The leaves that count: those whose first gradient is at least a
    thousandth of the median leaf's."""
    g0 = {kk: float(v.norm()) for kk, v in grads.items()}
    floor = 1e-3 * float(np.median(list(g0.values())))
    return [kk for kk, v in g0.items() if v >= floor]


def _eval_gap(lg, pred) -> float:
    """The widest gap by which the logit of a predicted class lies below
    the reference's best (inf where the predictions are missing)."""
    if pred is None or len(pred) != len(lg):
        return float("inf")
    pred = torch.as_tensor(np.asarray(pred, np.int64), device=lg.device)
    return float((lg.max(-1).values - lg.gather(1, pred[:, None])[:, 0])
                 .max())


def check(ctx, inp, out) -> List[dict]:
    mix, dev = ctx.mix, ctx.device
    k, n_init = int(mix["k"]), int(mix["init_size"])
    followed = int(mix["check_rounds"])
    init = inp["params"]
    train, picks = np.asarray(out["train_inds"], np.int64), out["picks"]
    init_pool, test = out["init_pool"], out["test_inds"]
    preds = out["test_preds"]
    if not len(picks) or len(preds) != len(picks) - 1:
        return [{"name": n, "value": float("inf"), "limit": v}
                for n, v in ctx.limits.items()]
    got = {}
    journal_ok = (np.array_equal(
        np.concatenate([train[:n_init]] + list(picks)), train)
        and len(np.unique(train)) == len(train)
        and bool(np.isin(train, init_pool).all()))
    camp = _campaign(ctx, inp, train[:n_init],
                     init_pool[~np.isin(init_pool, train[:n_init])])
    gaps, kth, unsat = [], [], []
    for r, q in enumerate(picks):
        if r < followed:
            p1 = camp.pool_p1()
            if r == 0:
                rec = out["pool_p1_0"]
                got["pool_p1_err"] = (
                    float((torch.as_tensor(np.asarray(rec), device=dev)
                           - p1).abs().max())
                    if rec is not None and len(rec) == len(camp.pool)
                    else float("inf"))
            s = (p1 - 0.5).abs()
            kth.append(float(torch.sort(s).values[k - 1]))
            unsat.append(int((s < 0.5).sum()))
            gaps.append(_pick_gap(p1, camp.pool, q, k))
            del p1, s
        camp.take(q)
        g0 = camp.finetune()
        if r == 0:
            keep = _keep(g0)
            (got["train_change_med"], got["train_moment_med"], wc,
             wm) = _train_gaps(init, out["round0"], camp.theta, camp.opt.m,
                               keep, dev)
            harness.log(f"round 0 finetune, worst leaf (not compared): "
                        f"change {wc!r}, moment {wm!r}")
    got["pick_gap"] = max(gaps) if journal_ok else float("inf")
    harness.log(f"rounds 0..{len(gaps) - 1}: pick gaps {gaps}, k-th "
                f"smallest |p1 - 0.5| {kth}, pool voxels under "
                f"|p1 - 0.5| = 0.5 {unsat}")
    (got["window_change_med"], wm, wc,
     _) = _train_gaps(init, out["final"], camp.theta, camp.opt.m, keep, dev)
    harness.log(f"round n: Adam's first moment, median leaf {wm!r} (not "
                f"compared); the change's worst leaf {wc!r} (not compared)")
    got["final_eval_gap"] = _eval_gap(
        camp.logits(test, _on(out["final"][0], dev)), preds[-1])
    grid, even = _grid(inp["vols"].shape[1:], int(mix["grid_spacing"]))
    got["grid_mismatch"] = float(
        (set(test.tolist()) != set(grid.tolist()))
        + (set(init_pool.tolist()) != set(even.tolist())))
    return [{"name": n, "value": v, "limit": ctx.limits.get(n)}
            for n, v in got.items()]


# ---------------------------------------------------------------- control
def _half(rows, w):
    """Half of the batch left out; the loss is the mean over the rest."""
    w = np.array(w)
    w[len(w) // 2:] = 0.0
    return rows, w


def control(ctx, inp, fault=None) -> dict:
    """The outputs of the reference campaign put in the program's place at
    TF32, with its own picks, for ``control_rounds`` rounds (round 0 and
    the rounds a window holds).  ``fault`` plants one fault
    in every round 1..n instead, at float32: ``unchanged``, a finetune
    that leaves the state unchanged; ``half_batch``, half of each batch
    left out; ``pick``, a pick swapped for the pool's most certain voxel;
    ``prediction``, every 97th test prediction flipped.  Test
    predictions are made for round n, which ``check`` reads."""
    mix = ctx.mix
    k, n_init = int(mix["k"]), int(mix["init_size"])
    n_rounds = int(mix["control_rounds"])
    test, init_pool = _grid(inp["vols"].shape[1:], int(mix["grid_spacing"]))
    first = np.random.default_rng(ctx.seed).permutation(len(init_pool))
    train0 = init_pool[first[:n_init]]
    camp = _campaign(ctx, inp, train0,
                     init_pool[~np.isin(init_pool, train0)])
    picks, preds = [], []
    with reference.precision(tf32=fault is None):
        for r in range(n_rounds):
            p1 = camp.pool_p1()
            if r == 0:
                pool_p1_0 = p1.cpu().numpy()
            q = camp.pool[campaign.select(p1, k)]
            if fault == "pick" and r:
                q[0] = camp.pool[int((p1 - 0.5).abs().argmax())]
            picks.append(q)
            camp.take(q)
            camp.finetune(run=not (fault == "unchanged" and r),
                          batches=_half if fault == "half_batch" and r
                          else None)
            if r == 0:
                round0 = ({kk: v.clone() for kk, v in camp.theta.items()},
                          {kk: v.clone() for kk, v in camp.opt.m.items()})
            elif r == n_rounds - 1:
                pred = camp.logits(test).argmax(-1).cpu().numpy()
                if fault == "prediction":
                    pred[::97] = 1 - pred[::97]
                preds.append(pred)
            else:
                preds.append(None)
    return {"train_inds": camp.train, "picks": picks,
            "pool_p1_0": pool_p1_0, "round0": round0,
            "final": (camp.theta, camp.opt.m), "test_preds": preds,
            "test_inds": test, "init_pool": init_pool}
