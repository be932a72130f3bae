"""Multi-subject ("universal") patch-wise AL experiment (counterpart of
``nnal_tpu/engine/multi_experiment.py``; reference
``PW_AL.Experiment_MultiImg``, PW_AL.py:586-898).

A campaign spans a cohort of training subjects: every subject's grid pool
is scored by its own device-resident :class:`GridPoolEvaluator`, the
selection is global (:func:`scoring.strategies.query_multimg`), the
model is evaluated on held-out test subjects, and the queries are
journaled as (voxel, subject) columns in ``queries/<round>.txt``.
Membership (``curr_train_inds.txt`` / ``curr_pool_inds.txt``) lives in
the global index space over the concatenated per-subject pools
(``pool_inds_<i>.txt``, in grid order, not sorted).  The directory
layout and file formats are the JAX package's, so either package resumes
the other's experiments.

Each subject's zero-padded volume lives on the device once per
experiment (:meth:`padded`).  The finetune gathers each subject's labeled
patches from it through kernel K2 (the JAX package gathers on the host
with its native C++ gather), concatenates them subject-major and runs the
single-subject engine's ``finetune_steps`` with the multi engine's own
streams (``ft-multi-{tag}{step}``, ``ft-multi-d-...``,
``ft-multi-unlab-...``), class weights, ``train_dtype``, LwF and the mean
teacher, whose 256 unlabeled patches a round are drawn from the initial
pools and gathered subject by subject.  Like the JAX multi engine, it
does not read ``aleatoric``, ``train_layers``, ``tb_logdir`` or AU_4U's
perturbation keys.

``run_method`` is resumable: a crash between the journal and the
membership files is repaired (``reconcile_membership`` with the exact
position lookup of ``_qmat_to_global``), and with ``ckpt_full_every`` >
1 the journaled finetunes since the last anchor are replayed, with the
anchor dtype's rounding re-adopted at the anchor rounds.  Each round
writes ``AL_running_times/dt_<r>`` (the selection's seconds),
``phases.jsonl`` (with the loop end's ``"tail"`` row) and, every
``hist_every`` rounds, the analysis-only history copy
``curr_weights_<r>.npz`` at ``hist_dtype``; the resume point is written
at ``ckpt_dtype`` on anchor rounds, from a thread under
``async_checkpoint``.

``model_name: Tiramisu`` runs the dense-model path (``:114-115``,
``:383-561``): one FC-DenseNet-103 spec (fully convolutional, so it runs on
every subject's slice size) scored per subject by whole-slice sweeps, and
a finetune over every subject's labeled axial slices grouped by slice
shape, one run of steps per shape group in sorted shape order, each with
its own streams (a ``g<i>-`` tag only when there are two or more
shapes, keyed on the round's entry step), its own mean-teacher unlabeled
slices (16, drawn over the group's labeled subjects) and its own BN
refresh (decay 0.6, 8 batches).  The BN running state is saved with the
weights and the history copies, and every pool and test evaluator scores
on it from the resume on and after each finetune (``_bn_sync``,
``:639-646``); the held subjects' bootstrap evaluators score on batch
statistics, as in the JAX package.

Runs on ``device`` (default: the card; CUDA missing raises).
"""

from __future__ import annotations

import copy
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from nnal_tpu_torch.core import rng as core_rng
from nnal_tpu_torch.core.config import ExperimentConfig
from nnal_tpu_torch.core.device import deterministic_cudnn, resolve_device
from nnal_tpu_torch.core.journal import MethodJournal, load_inds, save_inds
from nnal_tpu_torch.core.profiling import PhaseTimer
from nnal_tpu_torch.core.rng import RngStream
from nnal_tpu_torch.data.batching import make_onehot
from nnal_tpu_torch.data.indexing import global2local_inds, local2global_inds
from nnal_tpu_torch.data.patches import (
    gather_labels,
    gather_patches_normalized,
    pad_volumes,
)
from nnal_tpu_torch.data.samplers import generate_grid_samples
from nnal_tpu_torch.data.stats import multimg_stats
from nnal_tpu_torch.engine.common import (
    adopt_anchor_rounding,
    anchor_save_kwargs,
    check_slice_config,
    dense_model_kwargs,
    grid_evaluator,
    inverse_frequency_weights,
    is_dense,
    maybe_reset_opt,
    mt_rampdown,
    reconcile_membership,
    replay_prefix_lens,
    warn_fcn_unsupported_keys,
    write_checkpoint,
)
from nnal_tpu_torch.evaluation.metrics import f_measure
from nnal_tpu_torch.models.bridge import (
    bn_state_to_jax,
    bn_state_to_port,
    from_jax_params,
    to_jax_params,
    to_jax_tensors,
)
from nnal_tpu_torch.models.checkpoint import (
    AsyncCheckpointWriter,
    load_checkpoint,
    load_opt_leaves,
    save_checkpoint,
)
from nnal_tpu_torch.models.cnn import CNN, init_cnn
from nnal_tpu_torch.models.optim import load_opt_state
from nnal_tpu_torch.models.specs import create_model
from nnal_tpu_torch.models.train import (
    LwF,
    MeanTeacher,
    TrainState,
    build_batch_index_matrix,
    bn_refresh,
    build_unlabeled_index_matrix,
    finetune_fcn_steps,
    finetune_steps,
    init_train_state,
    make_teacher,
)
from nnal_tpu_torch.scoring.fcn_eval import (
    FCNGridPoolEvaluator,
    normalized_slices,
)
from nnal_tpu_torch.scoring.pool_eval import eval_compute_dtype
from nnal_tpu_torch.scoring.strategies import (
    QueryContext,
    query_multimg,
    require_strategy,
)

HIST_DTYPES = ("float32", "float16", "bfloat16")


def hist_dtype(model_cfg) -> str:
    """``hist_dtype``: the storage dtype of the per-round history copy."""
    hd = str(getattr(model_cfg, "hist_dtype", "float32"))
    if hd not in HIST_DTYPES:
        raise ValueError(f"unsupported hist_dtype {hd!r}")
    return hd


class MultiImgExperiment:
    """AL across several training subjects and held-out test subjects."""

    def __init__(self, root_dir: str,
                 config: Optional[ExperimentConfig] = None, device=None,
                 mesh=None):
        self.device = resolve_device(device)
        # the data_parallel evaluators' mesh (None: cached_mesh(dp))
        self.mesh = mesh
        self.root_dir = root_dir
        os.makedirs(root_dir, exist_ok=True)
        par_path = os.path.join(root_dir, "parameters.txt")
        if config is None:
            config = ExperimentConfig.from_yaml(par_path)
        else:
            config.to_yaml(par_path)
        check_slice_config(config)
        hist_dtype(config.model)
        self.config = config
        self.rng = RngStream(config.seed)
        self.ensemble_paths: List[str] = []
        self.attach_subjects([])

    def attach_subjects(self, train_subjects, test_subjects=(),
                        held_subjects=()) -> None:
        """``(vols, mask)`` per subject.  ``held_subjects`` seed core-set's
        labeled features before any query exists (reference
        PW_AL.py:809-822)."""
        def own(subjects):
            return [([np.asarray(v) for v in vols], np.asarray(mask))
                    for vols, mask in subjects]

        self.train_subjects: List = own(train_subjects)
        self.test_subjects: List = own(test_subjects)
        self.held_subjects: List = own(held_subjects)
        self._padded: Dict = {}
        self._mu_sd: Dict = {}
        self._test_evs = self._mt_u_cat = None
        self._overseg_cache: Dict = {}
        self._fcn_slices: Dict = {}
        self._bn_sync = None       # the running BN state evaluators read

    def _subjects(self, kind: str) -> List:
        return {"train": self.train_subjects, "test": self.test_subjects,
                "held": self.held_subjects}[kind]

    def padded(self, kind: str, i: int) -> torch.Tensor:
        """Subject ``i``'s zero-padded float32 volume on the device
        (``kind``: train, test or held), built once per experiment."""
        key = (kind, i)
        if key not in self._padded:
            self._padded[key] = pad_volumes(self._subjects(kind)[i][0],
                                            self.config.model.patch_shape,
                                            self.device)
        return self._padded[key]

    # ------------------------------------------------------------- setup
    def prep_data(self) -> None:
        """Per-subject grid pools (NaN-masked voxels dropped) and the
        per-subject statistics (reference PW_AL.py:622-637, 698-707)."""
        np.savetxt(self._p("train_stats.txt"),
                   multimg_stats(self.train_subjects))
        if self.test_subjects:
            np.savetxt(self._p("test_stats.txt"),
                       multimg_stats(self.test_subjects))
        for i, (vols, mask) in enumerate(self.train_subjects):
            inds, labels = generate_grid_samples(
                vols[0].shape, self.config.data.grid_spacing, mask)
            save_inds(self._p(f"pool_inds_{i}.txt"), inds)
            save_inds(self._p(f"pool_labels_{i}.txt"), labels)

    def _p(self, name: str) -> str:
        return os.path.join(self.root_dir, name)

    def _stats(self, kind: str = "train") -> np.ndarray:
        n = len(self._subjects(kind))
        return np.loadtxt(self._p(f"{kind}_stats.txt")).reshape(n, -1)

    def _pools(self) -> List[np.ndarray]:
        return [load_inds(self._p(f"pool_inds_{i}.txt"))
                for i in range(len(self.train_subjects))]

    def build_model(self):
        check_slice_config(self.config)
        m = self.config.model
        d1, d2, d3 = m.patch_shape
        vols = self.train_subjects[0][0]
        if is_dense(m):
            # one spec for every slice size: input_shape only traces the
            # channels of a fully convolutional net
            H, W = vols[0].shape[:2]
            return create_model(m.model_name, nclass=m.nclass,
                                input_shape=(int(H), int(W), len(vols)),
                                **dense_model_kwargs(m))
        return create_model(m.model_name, nclass=m.nclass,
                            dropout_rate=m.dropout_rate,
                            patch_shape=(d1, d2, len(vols) * d3))

    def _evaluators(self, spec, kind: str, stats: np.ndarray) -> List:
        """One evaluator per subject, over its device-resident volume (a
        dense spec's: over its normalized slice stack), z-sharded over the
        engine's ``mesh`` when ``data_parallel`` > 1."""
        m = self.config.model
        if spec.fcn:
            return [FCNGridPoolEvaluator(
                spec, vols, stats[i, 0::2], stats[i, 1::2],
                tuple(vols[0].shape), compute_dtype=eval_compute_dtype(m.dtype),
                device=self.device, hv_patch_shape=tuple(m.patch_shape))
                for i, (vols, _) in enumerate(self._subjects(kind))]
        return [grid_evaluator(self.config, spec, self.padded(kind, i),
                               stats[i, 0::2], stats[i, 1::2], vols[0].shape,
                               self.mesh)
                for i, (vols, _) in enumerate(self._subjects(kind))]

    def _load_model(self, spec, params) -> CNN:
        model = CNN(spec)
        model.load_state_dict(from_jax_params(params))
        return model.to(self.device)

    def add_method(self, method_name: str) -> MethodJournal:
        """A method directory with an empty labeled set (membership in the
        global index space) and the shared initial weights, written once
        as ``init_weights.npz`` in the JAX layout."""
        j = MethodJournal(self.root_dir, method_name)
        n = int(np.sum([len(p) for p in self._pools()]))
        j.init_membership(np.zeros(0, np.int64), np.arange(n, dtype=np.int64))
        init_w = self._p("init_weights.npz")
        if not os.path.exists(init_w):
            model = init_cnn(self.build_model(),
                             self.rng.fold("init-w").next(), device="cpu")
            save_checkpoint(init_w, to_jax_params(model.state_dict()),
                            bn_state=bn_state_to_jax(model.init_state()))
        params, bn, _, _ = load_checkpoint(init_w)
        save_checkpoint(j.path("curr_weights.npz"), params, bn_state=bn)
        return j

    # ------------------------------------------------------------- finetune
    def _gather_train(self, si: int, inds) -> torch.Tensor:
        """Normalized patches of training subject ``si`` at ``inds`` (K2 on
        the card)."""
        dev = self.device
        if si not in self._mu_sd:
            stats = self._stats()[si].astype(np.float32)
            self._mu_sd[si] = (torch.as_tensor(stats[0::2]).to(dev),
                               torch.as_tensor(stats[1::2]).to(dev))
        mu, sd = self._mu_sd[si]
        return gather_patches_normalized(
            self.padded("train", si),
            torch.as_tensor(np.asarray(inds, np.int64)).to(dev), mu, sd,
            tuple(self.config.model.patch_shape),
            tuple(self.train_subjects[si][0][0].shape))

    def _unlabeled_pool(self):
        """(subject, voxel) of every initial pool entry: the mean
        teacher's unlabeled source, so a replayed round draws what the
        original drew."""
        if self._mt_u_cat is None:
            pools = self._pools()
            self._mt_u_cat = (
                np.concatenate([np.full(len(p), si, np.int64)
                                for si, p in enumerate(pools)]),
                np.concatenate(pools))
        return self._mt_u_cat

    def _unlabeled_patches(self, subj, vox) -> torch.Tensor:
        """The unlabeled draw's patches in draw order, gathered subject by
        subject and placed by subject mask (``:343-360``)."""
        xu = None
        for si in np.unique(subj):
            sel = subj == si
            got = self._gather_train(int(si), vox[sel])
            if xu is None:
                xu = got.new_zeros((len(subj),) + tuple(got.shape[1:]))
            xu[torch.as_tensor(sel).to(self.device)] = got
        return xu

    def finetune_multimg(self, state: TrainState, per_subject_inds,
                         epochs: Optional[int] = None,
                         rng_tag: str = "") -> TrainState:
        """Finetune on every subject's labeled voxels (reference
        ``finetune_multimg``, PW_AL.py:1091-1150): the labeled patches are
        gathered per subject (K2 on the card) and concatenated
        subject-major, then the round's batch-index matrix runs with the
        levers of the module docstring.  ``rng_tag`` names a committee
        member's own streams."""
        m = self.config.model
        maybe_reset_opt(state, m)
        epochs = m.epochs if epochs is None else epochs
        per = [np.asarray(v, np.int64) for v in per_subject_inds]
        total = int(sum(len(v) for v in per))
        if total == 0 or epochs == 0:
            return state
        if state.model.spec.fcn:
            return self._finetune_fcn_multimg(state, per, epochs, rng_tag)
        dev = self.device
        xs, ys = [], []
        for si, vinds in enumerate(per):
            if vinds.size == 0:
                continue
            xs.append(self._gather_train(si, vinds))
            vols, mask = self.train_subjects[si]
            ys.append(np.asarray(gather_labels(mask, vinds, vols[0].shape),
                                 np.int64))
        x_all = torch.cat(xs)
        y_cat = np.concatenate(ys)
        y_all = torch.as_tensor(make_onehot(y_cat, m.nclass)).to(dev)
        # streams keyed on the replay-stable optimizer step
        host = self.rng.fold(f"ft-multi-{rng_tag}{state.step}").host
        seed = self.rng.fold(f"ft-multi-d-{rng_tag}{state.step}").next()
        idx_mat, w_mat = build_batch_index_matrix(total, m.b, epochs, host,
                                                  bucket=256)
        cw = getattr(m, "class_weights", None)
        if isinstance(cw, str) and cw == "auto":
            cw = inverse_frequency_weights(y_cat, m.nclass)
        cw_vec = (torch.ones(m.nclass) if cw is None
                  else torch.as_tensor(np.asarray(cw, np.float32))).to(dev)
        with deterministic_cudnn():
            lwf = None
            if m.lwf_lambda > 0.0:
                with torch.no_grad():
                    lwf = LwF(state.model(x_all).logits,
                              float(m.lwf_lambda), float(m.lwf_T))
            mt = None
            cc, cc_scale = mt_rampdown(m, total)
            if cc > 0.0:
                if state.teacher is None:
                    state.teacher = make_teacher(state.model)
                u_subj, u_vox = self._unlabeled_pool()
                uhost = self.rng.fold(
                    f"ft-multi-unlab-{rng_tag}{state.step}").host
                n_take = 256
                draw = uhost.integers(0, len(u_vox), size=n_take)
                ub = int(m.unlabeled_batch) or m.b
                mt = MeanTeacher(
                    xu_all=self._unlabeled_patches(u_subj[draw],
                                                   u_vox[draw]),
                    u_idx=build_unlabeled_index_matrix(
                        n_take, ub, idx_mat.shape[0], uhost),
                    coeff=cc, cc_scale=cc_scale,
                    measure=str(m.consistency_measure),
                    ramp=int(m.consistency_ramp),
                    ema_decay=float(m.ema_decay), step0=state.step)
            finetune_steps(state, x_all, y_all, idx_mat, w_mat, cw_vec,
                           core_rng.fold_key(seed, state.step),
                           compute_dtype=eval_compute_dtype(m.train_dtype),
                           mc_t=int(m.mc_t), lwf=lwf, mt=mt)
        return state

    def _subject_slices(self, si: int) -> torch.Tensor:
        """Training subject ``si``'s normalized (Z, H, W, C) slice stack on
        the device, built once."""
        if si not in self._fcn_slices:
            stats = self._stats()[si]
            self._fcn_slices[si] = torch.from_numpy(normalized_slices(
                self.train_subjects[si][0], stats[0::2], stats[1::2])).to(
                    self.device)
        return self._fcn_slices[si]

    def _finetune_fcn_multimg(self, state: TrainState, per, epochs: int,
                              rng_tag: str) -> TrainState:
        """The dense finetune across subjects (module docstring;
        ``multi_experiment.py:383-561``)."""
        m = self.config.model
        warn_fcn_unsupported_keys(self, m, train_layers_ok=False)
        dev = self.device
        labs = [np.asarray(self.train_subjects[si][1]).reshape(-1)[v]
                .astype(np.int64) for si, v in enumerate(per)]
        cw = getattr(m, "class_weights", None)
        if isinstance(cw, str) and cw == "auto":
            cw = inverse_frequency_weights(
                np.concatenate([l for l in labs if len(l)]), m.nclass)
        # labeled slices grouped by slice shape, subject-major, each
        # subject's in z order: (slices, labels, pixel weights, subjects)
        groups: Dict = {}
        for si, vinds in enumerate(per):
            if vinds.size == 0:
                continue
            H, W, Z = self.train_subjects[si][0][0].shape
            x_, y_, z_ = np.unravel_index(vinds, (H, W, Z))
            zs = np.unique(z_)
            xs, ys, ws, subs = groups.setdefault((H, W), ([], [], [], set()))
            subs.add(si)
            yv = np.zeros((len(zs), H, W), np.int64)
            wv = np.zeros((len(zs), H, W), np.float32)
            pos = np.searchsorted(zs, z_)
            yv[pos, x_, y_] = labs[si]
            wv[pos, x_, y_] = 1.0 if cw is None else np.asarray(cw)[labs[si]]
            xs.append(self._subject_slices(si)[torch.as_tensor(zs).to(dev)])
            ys.append(yv)
            ws.append(wv)
        fcn_b = max(1, min(int(m.b), 4))
        train_cd = eval_compute_dtype(m.train_dtype)
        cc, cc_scale = mt_rampdown(m, int(sum(len(v) for v in per)))
        step0 = state.step
        with deterministic_cudnn():
            for gi, shape in enumerate(sorted(groups)):
                xs, ys, ws, subs = groups[shape]
                H, W = shape
                x_all = torch.cat(xs)
                S = x_all.shape[0]
                pad = -(-S // 8) * 8 - S
                x_all = torch.cat([x_all, x_all.new_zeros(
                    (pad,) + tuple(x_all.shape[1:]))])
                y_np = np.concatenate(ys + [np.zeros((pad, H, W), np.int64)])
                wpix = np.concatenate(ws + [np.zeros((pad, H, W), np.float32)])
                y_all = torch.as_tensor(make_onehot(
                    y_np.reshape(-1), m.nclass).reshape(
                        S + pad, H, W, m.nclass)).to(dev)
                # keyed on the round's entry step; the group tag only with
                # two or more shapes (``:486-492``)
                gtag = f"g{gi}-" if len(groups) > 1 else ""
                host = self.rng.fold(f"ft-multi-{rng_tag}{gtag}{step0}").host
                seed = self.rng.fold(
                    f"ft-multi-d-{rng_tag}{gtag}{step0}").next()
                idx_mat, w_mat = build_batch_index_matrix(S, fcn_b, epochs,
                                                          host, bucket=8)
                mt = None
                if cc > 0.0:
                    if state.teacher is None:
                        state.teacher = make_teacher(state.model)
                    uhost = self.rng.fold(
                        f"ft-multi-unlab-{rng_tag}{gtag}{step0}").host
                    g_subs = sorted(subs)
                    xu = []
                    for gs in uhost.integers(0, len(g_subs), size=16):
                        stack = self._subject_slices(g_subs[int(gs)])
                        xu.append(stack[int(uhost.integers(
                            0, stack.shape[0]))])
                    ub = max(1, min(int(m.unlabeled_batch) or fcn_b, 4))
                    mt = MeanTeacher(
                        xu_all=torch.stack(xu),
                        u_idx=build_unlabeled_index_matrix(
                            16, ub, idx_mat.shape[0], uhost),
                        coeff=cc, cc_scale=cc_scale,
                        measure=str(m.consistency_measure),
                        ramp=int(m.consistency_ramp),
                        ema_decay=float(m.ema_decay), step0=step0)
                finetune_fcn_steps(state, x_all, y_all, wpix, idx_mat, w_mat,
                                   core_rng.fold_key(seed, step0), train_cd,
                                   mt=mt)
                if state.bn_state:
                    for _ in range(8):
                        bi = host.integers(0, S, size=fcn_b)
                        state.bn_state = bn_refresh(
                            state.model, state.bn_state,
                            x_all[torch.as_tensor(bi).to(dev)], 0.6)
        return state

    # ------------------------------------------------------------- committee
    def _build_committee(self, spec, state: TrainState, train_vox,
                         round_id: int) -> List[CNN]:
        """The ensemble/QBC-JS committee (``:569-596``): before any label,
        ``pretrained_paths`` / ``ensemble_paths`` or ``n_ensemble`` fresh
        inits; afterwards ``n_ensemble`` copies of the current model, each
        with a fresh optimizer at the main state's step, finetuned on
        every subject's labels with its own streams."""
        m, q = self.config.model, self.config.query
        if int(np.sum([len(v) for v in train_vox])) == 0:
            paths = list(q.pretrained_paths) or list(self.ensemble_paths)
            if paths:
                return [self._load_model(spec, load_checkpoint(p)[0])
                        for p in paths]
            return [init_cnn(spec, self.rng.fold(f"ens-init-{i}").next(),
                             device=self.device)
                    for i in range(q.n_ensemble)]
        members = []
        for i in range(q.n_ensemble):
            mstate = init_train_state(copy.deepcopy(state.model),
                                      m.optimizer_name, m.learning_rate)
            mstate.step = state.step
            # members keep params only: they score on the main model's BN
            # statistics (``:569-596``)
            mstate.bn_state = state.bn_state
            self.finetune_multimg(mstate, train_vox,
                                  rng_tag=f"ens-{round_id}-{i}-")
            members.append(mstate.model)
        return members

    def _bootstrap_features(self, spec, model) -> Optional[torch.Tensor]:
        """Core-set's labeled features before any query: the held
        subjects' grid at ``bootstrap_spacing`` (reference
        ``gen_multimg_inds(labeled_paths, 50)``), on the device."""
        if not self.held_subjects:
            return None
        evs = self._evaluators(spec, "held",
                               multimg_stats(self.held_subjects))
        feats = []
        for ev, (vols, mask) in zip(evs, self.held_subjects):
            inds, _ = generate_grid_samples(
                vols[0].shape, self.config.query.bootstrap_spacing, mask)
            if len(inds):
                feats.append(ev.evaluate(model, inds, ("feature_layer",),
                                         as_device=True)["feature_layer"])
        return torch.cat(feats) if feats else None

    # ------------------------------------------------------------- test eval
    def test_eval(self, spec, model) -> float:
        """F-measure over the test subjects' grid voxels (reference
        ``test_eval``, PW_AL.py:639-677); the evaluators are kept across
        rounds."""
        if not self.test_subjects:
            return float("nan")
        if self._test_evs is None:
            self._test_evs = self._evaluators(spec, "test",
                                              self._stats("test"))
            self._test_grids = [
                generate_grid_samples(vols[0].shape,
                                      self.config.data.grid_spacing, mask)
                for vols, mask in self.test_subjects]
        self._sync_bn(self._test_evs)
        preds, masks = {}, {}
        for i, ev in enumerate(self._test_evs):
            inds, labels = self._test_grids[i]
            preds[i] = ev.evaluate(model, inds, ("prediction",))["prediction"]
            masks[i] = labels
        return f_measure(preds, masks)

    def _sync_bn(self, evs) -> None:
        """Dense evaluators score on the engine's current BN running state
        (``_bn_sync``, ``:639-646``)."""
        for ev in evs:
            if isinstance(ev, FCNGridPoolEvaluator):
                ev.bn_state = self._bn_sync

    # ------------------------------------------------------------- saves
    def _save_round(self, j, state: TrainState, round_id: int, full: bool,
                    want_hist: bool, writer=None) -> None:
        """The round's writes (``:856-979``): the history copy
        ``curr_weights_<r>.npz`` at ``hist_dtype`` when ``want_hist``, and
        on ``full`` rounds the resume point at ``ckpt_dtype`` — its payload
        captured, then the anchor rounding adopted into the live state.
        Both are device snapshots, so ``writer``'s thread may write them
        while the next round runs (``write_checkpoint``)."""
        m = self.config.model
        jobs = []
        if want_hist:
            hd = hist_dtype(m)
            hist = to_jax_tensors(state.model.state_dict())
            hist_bn = {layer: {k: v.detach().clone() for k, v in d.items()}
                       for layer, d in (state.bn_state or {}).items()}
            if hd == "float16":
                hist, hist_bn = ({layer: {k: v.to(torch.float16)
                                          for k, v in d.items()}
                                  for layer, d in tree.items()}
                                 for tree in (hist, hist_bn))
            hist_path = j.path(f"curr_weights_{round_id}.npz")
            jobs.append(lambda: save_checkpoint(
                hist_path, hist, bn_state=hist_bn,
                dtype="bfloat16" if hd == "bfloat16" else None))
        if full:
            akw = anchor_save_kwargs(m, state)
            adopt_anchor_rounding(state, m)
            al = {"step": int(state.step), "round": int(round_id)}
            ckpt = j.path("curr_weights.npz")
            jobs.append(lambda: save_checkpoint(
                ckpt, akw["params"], al_state=al, bn_state=akw["bn_state"],
                teacher_params=akw["teacher_params"],
                opt_state=akw["opt_state"], dtype=akw["dtype"]))
        if jobs:
            write_checkpoint(lambda: [job() for job in jobs], writer,
                             self.device)

    # ------------------------------------------------------------- AL loop
    def _replay_to_round(self, j, state, al_state, train_g, round_id,
                         pools) -> TrainState:
        """Re-run the journaled rounds' finetunes the checkpoint does not
        hold, re-adopting the anchor rounding at the anchor rounds
        (``:711-731``)."""
        K = max(1, int(getattr(self.config.model, "ckpt_full_every", 1)))
        anchor = (0 if al_state is None
                  else int(al_state.get("round", round_id)))
        sizes = [len(p) for p in pools]
        for i, ln in enumerate(replay_prefix_lens(
                j, al_state, round_id, len(train_g), matrix=True)):
            tv = [pools[s][loc] for s, loc in
                  enumerate(global2local_inds(train_g[:ln], sizes))]
            state = self.finetune_multimg(state, tv)
            if (anchor + i + 1) % K == 0:
                adopt_anchor_rounding(state, self.config.model)
        return state

    def run_method(self, method_name: str, max_queries: int) -> Dict:
        """The multi-subject AL loop (reference ``run_method``,
        PW_AL.py:700-898), resumable; replayed queries count toward
        ``max_queries``."""
        require_strategy(method_name)
        cfg = self.config
        j = MethodJournal(self.root_dir, method_name)
        spec = self.build_model()
        n_sub = len(self.train_subjects)
        evs = self._evaluators(spec, "train", self._stats())
        pools = self._pools()
        sizes = [len(p) for p in pools]
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(
            np.int64)

        ckpt = j.path("curr_weights.npz")
        params, bn, teacher, al_state = load_checkpoint(ckpt)
        model = self._load_model(spec, params)
        state = init_train_state(model, cfg.model.optimizer_name,
                                 cfg.model.learning_rate)
        state.bn_state = bn_state_to_port(bn, self.device)
        if teacher is not None:
            state.teacher = self._load_model(spec, teacher)
            state.teacher.requires_grad_(False)
        load_opt_state(state.optimizer, model, load_opt_leaves(ckpt))
        if al_state is not None:
            state.step = int(al_state.get("step", 0))
        saved = j.load_state()
        if saved is not None:
            self.rng.restore(saved["rng"])
        n_queries = j.n_queried(matrix=True)
        round_id = len(j.query_iters())
        train_g, pool_g = j.membership()

        def qmat_to_global(qmat):
            # exact positions: the pool files are in grid order, not
            # sorted, so searchsorted would find wrong ones (``:693-707``)
            pos_of = [{int(v): i for i, v in enumerate(p.tolist())}
                      for p in pools]
            return np.asarray([int(offsets[s]) + pos_of[int(s)][int(v)]
                               for v, s in qmat.T], np.int64)

        train_g, pool_g, _ = reconcile_membership(
            j, train_g, pool_g, matrix=True, to_global=qmat_to_global)
        state = self._replay_to_round(j, state, al_state, train_g, round_id,
                                      pools)
        # after the replay, which re-centers the BN statistics
        self._bn_sync = state.bn_state
        self._sync_bn(evs)

        times_path = self._p("AL_running_times")
        os.makedirs(times_path, exist_ok=True)
        timer = PhaseTimer(j.path("phases.jsonl"), self.device)
        writer = (AsyncCheckpointWriter()
                  if getattr(cfg.model, "async_checkpoint", False) else None)
        K = max(1, int(getattr(cfg.model, "ckpt_full_every", 1)))
        H = int(getattr(cfg.model, "hist_every", 1))
        last_full_round = round_id     # the entry state is reproducible
        while n_queries < max_queries and len(pool_g) > 0:
            k = min(cfg.query.k, max_queries - n_queries, len(pool_g))
            # per-round stateless stream, replayable from (seed, method,
            # round)
            qrng = self.rng.fold(f"q-{method_name}-{round_id}")
            local_pool = global2local_inds(pool_g, sizes)
            per_train = global2local_inds(train_g, sizes)
            train_vox = [pools[i][per_train[i]] for i in range(n_sub)]
            committee = None
            if method_name in ("ensemble", "QBC-JS"):
                with timer.phase("committee"):
                    committee = self._build_committee(spec, state,
                                                      train_vox, round_id)
            extra = {"influence_mode": cfg.query.influence_mode,
                     "arnoldi_rank": cfg.query.arnoldi_rank}
            if method_name == "core-set" and len(train_g) == 0:
                bf = self._bootstrap_features(spec, model)
                if bf is not None:
                    extra["bootstrap_features"] = bf
            contexts = []
            for si in range(n_sub):
                vols, mask = self.train_subjects[si]
                extra_i = dict(extra, mask=mask)
                if si in self._overseg_cache:
                    extra_i["overseg"] = self._overseg_cache[si]
                contexts.append(QueryContext(
                    spec=spec, params=model, evaluator=evs[si],
                    pool_inds=pools[si][local_pool[si]], k=k,
                    rng=qrng.host, seed=qrng.next(), B=cfg.query.B,
                    MC_iters=cfg.query.MC_iters, lambda_=cfg.query.lambda_,
                    diag_load=float(cfg.query.diag_load),
                    ensemble_params=committee, train_inds=train_vox[si],
                    raw_volume=vols[0], extra=extra_i))
            t0 = time.time()
            with timer.phase("score_select"):
                per_q = query_multimg(contexts, method_name, k, qrng.host)
            dt = time.time() - t0
            if writer is not None:
                with timer.phase("checkpoint"):
                    # the previous round's save overlapped the scoring; it
                    # must be durable before this round writes any state
                    writer.wait()
            for si, c in enumerate(contexts):
                if c.extra.get("overseg") is not None:
                    self._overseg_cache[si] = c.extra["overseg"]
            del contexts, committee
            with open(os.path.join(times_path, f"dt_{round_id}"), "w") as f:
                f.write(f"{dt:.4f}\n")

            # per-subject positions -> global ids -> (voxel, subject)
            q_g = pool_g[local2global_inds(per_q,
                                           [len(lp) for lp in local_pool])]
            subj_of = np.searchsorted(np.cumsum(sizes), q_g, side="right")
            voxels = np.asarray([pools[s][g - offsets[s]]
                                 for g, s in zip(q_g, subj_of)], np.int64)
            np.savetxt(os.path.join(j.queries_dir, f"{round_id}.txt"),
                       np.stack([voxels, subj_of]), fmt="%d")
            train_g = np.concatenate([train_g, q_g])
            pool_g = np.setdiff1d(pool_g, q_g)
            j.init_membership(train_g, pool_g)
            n_queries += len(q_g)
            round_id += 1

            per_train = global2local_inds(train_g, sizes)
            train_vox = [pools[i][per_train[i]] for i in range(n_sub)]
            with timer.phase("train"):
                state = self.finetune_multimg(state, train_vox)
            self._bn_sync = state.bn_state
            self._sync_bn(evs)
            with timer.phase("eval"):
                fm = self.test_eval(spec, model)
            j.append_eval([fm])
            with timer.phase("checkpoint"):
                full = round_id % K == 0
                self._save_round(j, state, round_id, full,
                                 H > 0 and round_id % H == 0, writer)
                if full:
                    last_full_round = round_id
                j.save_state(round_id=round_id, rng_state=self.rng.state(),
                             n_train=len(train_g), n_pool=len(pool_g))
            timer.commit_round(round_id - 1, n_train=len(train_g),
                               n_pool=len(pool_g), f_measure=fm)

        with timer.phase("checkpoint"):
            if writer is not None:
                writer.wait()     # the last round's save must land
            if last_full_round != round_id:
                # a finished run always leaves a full resume point
                self._save_round(j, state, round_id, True, False)
        if timer.current:
            timer.commit_round(round_id - 1, tail=True)
        return {"n_queries": n_queries, "perf": j.load_evals(),
                "train_global": train_g, "pool_global": pool_g}
