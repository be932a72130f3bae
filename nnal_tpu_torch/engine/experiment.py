"""Classification AL experiment, runs x methods (counterpart of
``nnal_tpu/engine/experiment.py``).

Rebuild of ``AL.Experiment`` (AL.py:16-753): an experiment root holds
``parameters.txt`` plus numbered *runs*; each run fixes a random
train/test/pool partition and an initial model (``init_weights.npz``);
each *method* inside a run owns its membership, ``queries/`` journal,
``accs.txt``, ``predicts.txt``, ``phases.jsonl``, ``state.json`` and
``curr_weights.npz`` — the JAX package's layout, so either package reads
the other's directories.  Per round: query -> move to train -> retrain ->
predict the test set -> append the accuracy -> checkpoint.

The retrain (``_retrain``) walks the labeled set in host-shuffled batches
(``rng.fold(f"{tag}retrain-{step}")``), each padded to ``b`` with
zero-weight rows, one :func:`~nnal_tpu_torch.models.train.make_train_step`
step per batch (dropout keyed ``fold_key(jrng, step)``), with the levers
of the JAX engine: class weights (``auto``: inverse frequency of the
labeled set, a runtime vector), ``train_dtype``, ``train_layers``, LwF
(the round-entry model's logits of each batch) and the mean teacher's
consistency on the same batch (EMA after each step, ``mt_rampdown``).
With batch norm the zero pad rows enter the batch statistics, as in JAX,
and the running statistics are refreshed over the labeled set after the
epochs (``iters = min(20, max(1, n // b))``).  On the card the retrain
runs on deterministic cuDNN, which replay's bit identity needs.

The resume point is written every ``ckpt_full_every`` rounds (and at the
end of a run) at ``ckpt_dtype`` after adopting that dtype's rounding; a
crash between anchors replays the journaled retrains.  ``ensemble`` and
``QBC-JS`` build a committee each round (``committee`` phase): the
``pretrained_paths`` at round 0, else ``n_ensemble`` copies of the model
retrained with their own streams (``ens-{round}-{i}-``).  Scoring and
evaluation run at f32, as the JAX engine's.  Runs on ``device`` (default:
the card; CUDA missing raises).
"""

from __future__ import annotations

import copy
import os
import shutil
from typing import Dict, Optional

import numpy as np
import torch

from nnal_tpu_torch.core import rng as core_rng
from nnal_tpu_torch.core.config import ExperimentConfig
from nnal_tpu_torch.core.device import deterministic_cudnn, resolve_device
from nnal_tpu_torch.core.journal import MethodJournal, load_inds, save_inds
from nnal_tpu_torch.core.profiling import PhaseTimer
from nnal_tpu_torch.core.rng import RngStream
from nnal_tpu_torch.data.batching import gen_batch_inds, make_onehot
from nnal_tpu_torch.data.image_pool import InMemoryPool, LazyPoolView
from nnal_tpu_torch.engine.common import (
    adopt_anchor_rounding,
    anchor_save_kwargs,
    cached_tx,
    check_slice_config,
    inverse_frequency_weights,
    maybe_reset_opt,
    mt_rampdown,
    reconcile_membership,
    replay_prefix_lens,
)
from nnal_tpu_torch.evaluation.metrics import accuracy, example_based_pr
from nnal_tpu_torch.models.bridge import (
    bn_state_to_jax,
    bn_state_to_port,
    from_jax_params,
    to_jax_params,
)
from nnal_tpu_torch.models.checkpoint import (
    load_checkpoint,
    load_opt_leaves,
    save_checkpoint,
)
from nnal_tpu_torch.models.cnn import CNN, init_cnn
from nnal_tpu_torch.models.optim import (
    ema_update,
    layer_train_mask,
    load_opt_state,
    make_optimizer,
    sigmoid_rampup,
)
from nnal_tpu_torch.models.specs import create_model
from nnal_tpu_torch.models.train import (
    TrainState,
    make_teacher,
    make_train_step,
    update_bn_stats,
)
from nnal_tpu_torch.scoring.cls_strategies import (
    ClsQueryContext,
    batched_forward,
    cls_query,
)
from nnal_tpu_torch.scoring.pool_eval import eval_compute_dtype


class Experiment:
    """Classification AL over a pool (``attach_data`` / ``attach_pool``)."""

    def __init__(self, root_dir: str,
                 config: Optional[ExperimentConfig] = None, device=None):
        self.device = resolve_device(device)
        self.root_dir = root_dir
        os.makedirs(root_dir, exist_ok=True)
        par_path = os.path.join(root_dir, "parameters.txt")
        if config is None:
            config = ExperimentConfig.from_yaml(par_path)
        else:
            config.to_yaml(par_path)
        check_slice_config(config, classification=True)
        self.config = config
        self.rng = RngStream(config.seed)
        self._pool = None

    def attach_data(self, X, labels) -> None:
        self._pool = InMemoryPool(X, labels)

    def attach_pool(self, pool) -> None:
        """Attach a disk-backed pool (``data.image_pool.ImagePathPool``)
        or any object with ``__len__``/``labels``/``input_shape``/
        ``fetch``."""
        self._pool = pool

    # ------------------------------------------------------------- runs
    def _run_dir(self, run: int) -> str:
        return os.path.join(self.root_dir, str(run))

    def add_run(self) -> int:
        """New run: random test/pool/init-train partition + fresh init
        weights (reference ``add_run``, AL.py:148-241)."""
        existing = [int(d) for d in os.listdir(self.root_dir)
                    if d.isdigit()]
        run = max(existing) + 1 if existing else 0
        rdir = self._run_dir(run)
        os.makedirs(rdir, exist_ok=True)

        n = len(self._pool)
        perm = self.rng.fold(f"run{run}").host.permutation(n)
        n_test = int(self.config.query.test_ratio * n)
        test, rest = perm[:n_test], perm[n_test:]
        init_size = self.config.query.init_size
        save_inds(os.path.join(rdir, "test_inds.txt"), test)
        save_inds(os.path.join(rdir, "init_train_inds.txt"),
                  rest[:init_size])
        save_inds(os.path.join(rdir, "init_pool_inds.txt"),
                  rest[init_size:])

        model = init_cnn(self.build_model(),
                         self.rng.fold(f"init{run}").next(), device="cpu")
        save_checkpoint(os.path.join(rdir, "init_weights.npz"),
                        to_jax_params(model.state_dict()),
                        bn_state=bn_state_to_jax(model.init_state()))
        return run

    def build_model(self):
        m = self.config.model
        input_shape = tuple(self._pool.input_shape)
        return create_model(m.model_name, nclass=m.nclass,
                            dropout_rate=m.dropout_rate,
                            patch_shape=input_shape,
                            input_shape=input_shape)

    def _load_model(self, spec, params) -> CNN:
        model = CNN(spec)
        model.load_state_dict(from_jax_params(params))
        return model.to(self.device)

    # ------------------------------------------------------------- methods
    def add_method(self, method_name: str, run: int):
        rdir = self._run_dir(run)
        j = MethodJournal(rdir, method_name)
        j.init_membership(
            load_inds(os.path.join(rdir, "init_train_inds.txt")),
            load_inds(os.path.join(rdir, "init_pool_inds.txt")))
        params, bn, _, _ = load_checkpoint(
            os.path.join(rdir, "init_weights.npz"))
        save_checkpoint(j.path("curr_weights.npz"), params, bn_state=bn)
        return j

    def _cached_tx(self):
        return cached_tx(self, self.config.model)

    # ------------------------------------------------------------- training
    def _step_fn(self, grad_mask, lwf_lambda, lwf_T, cc):
        """The train step of the configured levers (``_retrain``'s
        ``make_train_step`` call, ``experiment.py:160-194``)."""
        m = self.config.model
        coeff_fn = None
        if cc > 0.0:
            ramp_len = int(getattr(m, "consistency_ramp", 0))
            ramp = sigmoid_rampup(ramp_len) if ramp_len > 0 else None

            def coeff_fn(step, _cc=np.float32(cc)):
                return _cc if ramp is None else _cc * ramp(step)
        return make_train_step(
            mc_t=int(m.mc_t), lwf_lambda=lwf_lambda, lwf_T=lwf_T,
            compute_dtype=eval_compute_dtype(getattr(m, "train_dtype",
                                                     None)),
            grad_mask=grad_mask, consistency_coeff=coeff_fn,
            consistency_measure=str(getattr(m, "consistency_measure",
                                            "CE")))

    def _retrain(self, state: TrainState, train_inds, epochs: int,
                 rng_tag: str = "") -> TrainState:
        """Epochs of padded batches over the labeled set, then the BN
        refresh (module docstring; ``experiment.py:124-253``)."""
        m = self.config.model
        dev = self.device
        maybe_reset_opt(state, m)
        lwf_lambda = float(getattr(m, "lwf_lambda", 0.0))
        lwf_T = float(getattr(m, "lwf_T", 2.0))
        grad_mask = (layer_train_mask(state.model, m.train_layers)
                     if m.train_layers else None)
        cw = getattr(m, "class_weights", None)
        if isinstance(cw, str) and cw == "auto":
            cw = inverse_frequency_weights(
                np.asarray(self._pool.labels)[train_inds], m.nclass)
        cw_vec = (None if cw is None else
                  torch.as_tensor(np.asarray(cw, np.float32)).to(dev))
        cc, cc_scale = mt_rampdown(m, len(train_inds))
        if cc > 0.0 and state.teacher is None:
            state.teacher = make_teacher(state.model)
        step_fn = self._step_fn(grad_mask, lwf_lambda, lwf_T, cc)
        old = copy.deepcopy(state.model) if lwf_lambda > 0.0 else None
        # per-call streams keyed by the replay-stable optimizer step;
        # rng_tag separates committee members' streams
        host = self.rng.fold(f"{rng_tag}retrain-{state.step}").host
        jrng = self.rng.fold(f"{rng_tag}retrain-dropout-{state.step}").next()
        w_full = np.ones(m.b, np.float32)
        with deterministic_cudnn():
            for _ in range(epochs):
                for batch in gen_batch_inds(len(train_inds), m.b, host):
                    xb, yb = self._pool.fetch(train_inds[batch])
                    # every batch padded to b with zero-weight rows
                    pad = m.b - len(batch)
                    w = w_full
                    if pad > 0:
                        xb = np.concatenate(
                            [xb, np.zeros((pad,) + np.shape(xb)[1:],
                                          np.asarray(xb).dtype)])
                        yb = np.concatenate([yb, np.zeros(pad, np.int64)])
                        w = (np.arange(m.b) < m.b - pad).astype(np.float32)
                    x = torch.from_numpy(
                        np.asarray(xb, np.float32)).to(dev)
                    y = torch.from_numpy(make_onehot(yb, m.nclass)).to(dev)
                    ol = None
                    if old is not None:
                        with torch.no_grad():
                            ol = old(x).logits
                    step_fn(state, x, y, core_rng.fold_key(jrng, state.step),
                            torch.from_numpy(w).to(dev), ol, cw_vec,
                            cc_scale)
                    if cc > 0.0:
                        ema_update(state.teacher, state.model,
                                   float(getattr(m, "ema_decay", 0.99)))
                    state.step += 1
            if state.bn_state:
                def _bn_batch():
                    b = host.choice(len(train_inds),
                                    size=min(m.b, len(train_inds)),
                                    replace=False)
                    return self._pool.fetch(train_inds[b])[0]

                state.bn_state = update_bn_stats(
                    state.model, state.bn_state, _bn_batch,
                    iters=min(20, max(1, len(train_inds) // m.b)))
        return state

    def _build_committee(self, spec, state: TrainState, train_inds,
                         round_id: int):
        """The committee of ensemble/QBC-JS (``experiment.py:255-282``):
        round 0 with ``query.pretrained_paths`` loads those weight sets;
        otherwise ``n_ensemble`` copies of the current model, each with a
        fresh optimizer at the main state's step and its own streams,
        retrained on the labeled set.  Members score on the main model's
        BN statistics."""
        q = self.config.query
        paths = list(getattr(q, "pretrained_paths", []) or [])
        if round_id == 0 and paths:
            return [self._load_model(spec, load_checkpoint(p)[0])
                    for p in paths]
        members = []
        for i in range(q.n_ensemble):
            model = copy.deepcopy(state.model)
            mstate = TrainState(model=model, optimizer=self._tx(
                model.parameters()), step=state.step,
                bn_state=state.bn_state)
            mstate = self._retrain(mstate, train_inds,
                                   self.config.model.epochs,
                                   rng_tag=f"ens-{round_id}-{i}-")
            members.append(mstate.model)
        return members

    def _save_resume_point(self, path: str, state: TrainState,
                           round_id: int) -> None:
        """Capture the payload, adopt the anchor rounding, save."""
        m = self.config.model
        akw = anchor_save_kwargs(m, state)
        adopt_anchor_rounding(state, m)
        save_checkpoint(path, akw["params"], bn_state=akw["bn_state"],
                        al_state={"step": int(state.step),
                                  "round": int(round_id)},
                        teacher_params=akw["teacher_params"],
                        opt_state=akw["opt_state"], dtype=akw["dtype"])

    # ------------------------------------------------------------- AL loop
    def run_method(self, method_name: str, run: int,
                   max_queries: int) -> Dict:
        """The AL loop (reference ``run_method``, AL.py:299-500),
        resumable: replayed queries count toward ``max_queries``."""
        cfg = self.config
        rdir = self._run_dir(run)
        j = MethodJournal(rdir, method_name)
        spec = self.build_model()
        test_inds = load_inds(os.path.join(rdir, "test_inds.txt"))

        ckpt = j.path("curr_weights.npz")
        params, bn, teacher, al_state = load_checkpoint(ckpt)
        model = self._load_model(spec, params)
        tx = self._cached_tx()
        if tx is None:
            tx = lambda p, _m=cfg.model: make_optimizer(  # noqa: E731
                _m.optimizer_name, _m.learning_rate, p)
        self._tx = tx
        state = TrainState(model=model, optimizer=tx(model.parameters()),
                           bn_state=bn_state_to_port(bn, self.device))
        if teacher is not None:
            # the mean teacher is part of the resume point
            state.teacher = self._load_model(spec, teacher)
            state.teacher.requires_grad_(False)
        load_opt_state(state.optimizer, model, load_opt_leaves(ckpt))
        if al_state is not None:
            state.step = int(al_state.get("step", 0))
        saved = j.load_state()
        if saved is not None:
            self.rng.restore(saved["rng"])
        n_queries = j.n_queried()
        round_id = len(j.query_iters())
        train_inds, pool_inds = j.membership()
        train_inds, pool_inds, _ = reconcile_membership(j, train_inds,
                                                        pool_inds)

        # ckpt_full_every > 1: replay the journaled rounds' retrains from
        # the anchor, re-adopting the anchor rounding at the same rounds
        K = max(1, int(getattr(cfg.model, "ckpt_full_every", 1)))
        anchor0 = (0 if al_state is None
                   else int(al_state.get("round", round_id)))
        for ri, ln in enumerate(replay_prefix_lens(j, al_state, round_id,
                                                   len(train_inds))):
            state = self._retrain(state, train_inds[:ln], cfg.model.epochs)
            if (anchor0 + ri + 1) % K == 0:
                adopt_anchor_rounding(state, cfg.model)

        timer = PhaseTimer(j.path("phases.jsonl"), self.device)
        labels = np.asarray(self._pool.labels)
        last_full_round = round_id
        while n_queries < max_queries and len(pool_inds) > 0:
            k = min(cfg.query.k, max_queries - n_queries, len(pool_inds))
            qrng = self.rng.fold(f"q-{method_name}-{run}-{round_id}")
            committee = None
            if method_name in ("ensemble", "QBC-JS"):
                with timer.phase("committee"):
                    committee = self._build_committee(spec, state,
                                                      train_inds, round_id)
            ctx = ClsQueryContext(
                spec=spec, params=state.model,
                pool_x=LazyPoolView(self._pool, pool_inds),
                k=k, rng=qrng.host, B=cfg.query.B, lambda_=cfg.query.lambda_,
                batch=cfg.query.ntb, MC_iters=cfg.query.MC_iters,
                labeled_x=LazyPoolView(self._pool, train_inds),
                labeled_y=labels[train_inds],
                committee_params=committee,
                bn=state.bn_state or None,
                extra={"damping": float(getattr(cfg.query, "damping", 0.1)),
                       "influence_mode": cfg.query.influence_mode,
                       "arnoldi_rank": cfg.query.arnoldi_rank})
            with timer.phase("score_select"):
                q_pos = cls_query(ctx, method_name)
            del ctx, committee
            q_inds = pool_inds[q_pos]

            j.record_queries(round_id, q_inds)
            train_inds = np.concatenate([train_inds, q_inds])
            pool_inds = np.delete(pool_inds, q_pos)
            j.init_membership(train_inds, pool_inds)
            n_queries += len(q_inds)
            round_id += 1

            with timer.phase("train"):
                state = self._retrain(state, train_inds, cfg.model.epochs)

            with timer.phase("eval"):
                preds = batched_forward(
                    spec, state.model, LazyPoolView(self._pool, test_inds),
                    cfg.query.ntb, ("prediction",),
                    state=state.bn_state or None)["prediction"]
                acc = accuracy(preds, labels[test_inds])
            j.append_eval([acc], "accs.txt")
            with open(j.path("predicts.txt"), "a") as f:
                f.write(" ".join(str(int(p)) for p in preds) + "\n")

            with timer.phase("checkpoint"):
                # anchor rounds write the full resume point; in between,
                # ckpt_full_every > 1 skips it (resume replays)
                if round_id % K == 0:
                    self._save_resume_point(ckpt, state, round_id)
                    last_full_round = round_id
            timer.commit_round(round_id - 1, n_train=len(train_inds),
                               n_pool=len(pool_inds), accuracy=float(acc))
            j.save_state(round_id=round_id, rng_state=self.rng.state(),
                         n_train=len(train_inds), n_pool=len(pool_inds))

        if last_full_round != round_id:
            # a completed invocation always leaves a full resume point
            self._save_resume_point(ckpt, state, round_id)
        return {"n_queries": n_queries,
                "accs": j.load_evals("accs.txt"),
                "train_inds": train_inds, "pool_inds": pool_inds}

    # ------------------------------------------------------------- run mgmt
    def get_runs(self):
        """Run folders of this experiment, ordered (reference
        ``get_runs``, AL.py:112-123)."""
        return sorted((d for d in os.listdir(self.root_dir)
                       if d.isdigit()
                       and os.path.isdir(os.path.join(self.root_dir, d))),
                      key=int)

    def organize_runs(self) -> None:
        """Renumber run folders to 0..n-1 (reference ``organize_runs``)."""
        for i, name in enumerate(self.get_runs()):
            if i != int(name):
                os.rename(os.path.join(self.root_dir, name),
                          os.path.join(self.root_dir, str(i)))

    def remove_run(self, run: int) -> None:
        """Delete a run folder and renumber the rest (reference
        ``remove_run``)."""
        shutil.rmtree(self._run_dir(int(run)))
        self.organize_runs()

    def reset_method(self, method_name: str, run: int) -> None:
        """Wipe one (run, method) back to the run's initial membership and
        weights (reference ``reset_method``)."""
        mdir = os.path.join(self._run_dir(run), method_name)
        if os.path.exists(mdir):
            shutil.rmtree(mdir)
        self.add_method(method_name, run)

    def read_queries(self, method_name: str, run: int):
        """Per-iteration query counts, iteration-ordered (reference
        ``read_queries``, repaired as in the JAX package)."""
        j = MethodJournal(self._run_dir(run), method_name)
        return [len(load_inds(os.path.join(j.queries_dir, f"{it}.txt")))
                for it in j.query_iters()]

    def eval_run(self, run: int, eval_method: str = "accuracy",
                 save: bool = True) -> Dict[str, np.ndarray]:
        """Per-iteration metric curves of each method from its
        ``predicts.txt`` against the run's test labels (reference
        ``eval_run``): ``accuracy`` a (rounds,) curve, ``PR`` a (2,
        rounds) example-based precision/recall matrix — both written to
        ``accs.txt`` when ``save``."""
        rdir = self._run_dir(run)
        test_inds = load_inds(os.path.join(rdir, "test_inds.txt"))
        test_labels = np.asarray(self._pool.labels)[test_inds]
        methods = [d for d in os.listdir(rdir)
                   if os.path.isdir(os.path.join(rdir, d))
                   and os.path.exists(os.path.join(rdir, d, "predicts.txt"))]
        out: Dict[str, np.ndarray] = {}
        nclass = self.config.model.nclass
        for method in methods:
            yhat = np.loadtxt(os.path.join(rdir, method, "predicts.txt"),
                              dtype=np.int64, ndmin=2)
            if eval_method == "accuracy":
                crit = np.array([accuracy(yhat[i], test_labels)
                                 for i in range(yhat.shape[0])])
            elif eval_method == "PR":
                lab_hot = make_onehot(test_labels, nclass)
                crit = np.zeros((2, yhat.shape[0]))
                for i in range(yhat.shape[0]):
                    crit[:, i] = example_based_pr(
                        make_onehot(yhat[i], nclass), lab_hot)
            else:
                raise ValueError(f"unknown eval_method {eval_method!r}")
            if save:
                np.savetxt(os.path.join(rdir, method, "accs.txt"), crit)
            out[method] = crit
        return out

    # ------------------------------------------------------------- analysis
    def read_run(self, run: int, method_name: str) -> np.ndarray:
        """Accuracy curve of one (run, method) (reference ``read_run``)."""
        return MethodJournal(self._run_dir(run),
                             method_name).load_evals("accs.txt")

    def visualize_run(self, run: int, method_names, save_path: str) -> None:
        """Accuracy-vs-#queries curves for one run (reference
        ``visualize_run``, AL.py:626-678), written to ``save_path``."""
        from nnal_tpu_torch.evaluation.visualize import plot_learning_curves

        curves = {m: self.read_run(run, m) for m in method_names
                  if len(self.read_run(run, m))}
        plot_learning_curves(curves, self.config.query.k, save_path,
                             ylabel="test accuracy")

    def summarize_all(self, method_names) -> Dict[str, np.ndarray]:
        """Mean accuracy curves across runs (reference ``summarize_all``)."""
        runs = sorted(int(d) for d in os.listdir(self.root_dir)
                      if d.isdigit())
        out = {}
        for m in method_names:
            curves = [self.read_run(r, m) for r in runs
                      if os.path.exists(os.path.join(self._run_dir(r), m))]
            if curves:
                L = min(len(c) for c in curves)
                out[m] = np.mean([c[:L] for c in curves], axis=0)
        return out
