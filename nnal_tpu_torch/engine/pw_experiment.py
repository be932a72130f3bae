"""Single-subject patch-wise AL experiment (counterpart of
``nnal_tpu/engine/pw_experiment.py``).

The root directory holds ``parameters.txt`` (YAML config), pool/test index
files, ``init_weights.npz`` and one subdirectory per querying method with
membership files, a ``queries/`` journal, per-round F-measures
(``perf_evals.txt``), ``query_times.txt``, ``phases.jsonl``, ``state.json``
and ``curr_weights.npz`` — the JAX package's layout, so either package can
read the other's experiment directories.  The AL loop per round: query ->
move queries from pool to train -> finetune -> predict test -> append
F-measure -> checkpoint.  Resume replays the ``queries/`` journal plus
``state.json``.

``model.dtype`` / ``train_dtype`` bfloat16 run the sweeps / the finetune in
bf16 (f32 accumulation, f32 master weights); fi's A-matrices stay f32.
The resume point is written every ``ckpt_full_every`` rounds (and at the
end of a run) at ``ckpt_dtype``, after adopting that dtype's rounding into
the live state; a crash between anchors replays the journaled finetunes,
re-adopting at the anchor rounds.  ``async_checkpoint`` writes from a
background thread a device snapshot taken at the save, and waits for it
right after the next round's ``score_select`` (nothing before that point
mutates the weights).  The card's finetune runs with deterministic cuDNN
algorithms, which replay's bit-identity needs.

``ensemble`` and ``QBC-JS`` build their committee before each round's
scoring (the ``committee`` phase): with an empty labeled set the members
come from ``pretrained_paths`` / ``ensemble_paths`` or ``n_ensemble``
fresh inits; otherwise ``n_ensemble`` deep copies of the current model,
each with a fresh optimizer at the main state's step, are finetuned on
the labeled set with their own streams (``rng_tag``), so the main model
and its Adam state never move.  Every stochastic draw of a round is keyed
on (seed, method, round) and the optimizer step, so a resumed campaign
draws the same masks, noise and member streams.

The finetune carries the training levers (``finetune``,
``pw_experiment.py:229-350``): ``train_layers`` (a gradient mask),
LwF (``lwf_lambda``: the previous model's logits of the labeled set, once
per round, before any step), the aleatoric head (``aleatoric``, ``mc_t``)
and the mean teacher (``consistency_coeff`` and its knobs): an EMA
teacher, a copy of the model on first use, held on the ``TrainState``
and saved in the resume point's ``teacher/`` group, and 256 unlabeled
patches a round drawn from ``init_pool_inds.txt`` (a step-keyed host
stream, so replay draws the same) and gathered through K2.  A committee
member starts without a teacher and builds its own from its copy.
``tb_logdir`` mirrors ``al/f_measure`` and ``al/n_train`` per round to
TensorBoard under ``tb_logdir/<method>`` when the backend imports.

Each round's query context carries the raw first modality and the label
mask (``ps-random``, ``SuPix``, ``influence``), the SLIC
oversegmentation, computed once and kept across rounds, and
``influence_mode`` / ``arnoldi_rank``.  ``finetune_wpool`` finetunes on
the labels plus confident pseudo-labels.

``model_name: Tiramisu`` (or ``FCDenseNet103``) runs the dense-model path
(``pw_experiment.py:103-117``, ``:364-512``): the FC-DenseNet-103 spec at
the subject's slice size with ``model_kwargs`` (growth, depths,
dropout_rate), scored by whole-slice sweeps
(:class:`~nnal_tpu_torch.scoring.fcn_eval.FCNGridPoolEvaluator`), and
finetuned on the labeled voxels' axial slices (bucketed to a multiple of
8, batches of ``min(b, 4)``) with the per-pixel CE masked to the queried
voxels (class weights folded into the pixel weights); under the mean
teacher 16 unlabeled slices a round (batches of at most 4).  After each
finetune the BN running statistics are refreshed at decay 0.6 over 8
host-drawn batches; they are part of the resume point (``bn/``), and the
evaluator scores on them from the resume on and after every finetune.
Committee members are params only: they score on the main model's
running statistics, as in the JAX package.

Runs on ``device`` (default: the card; CUDA missing raises).
"""

from __future__ import annotations

import copy
import os
import shutil
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
from nnal_tpu_torch.core.tb import TBWriter
from nnal_tpu_torch.data.batching import make_onehot
from nnal_tpu_torch.data.patches import (
    gather_labels,
    gather_patches_normalized,
    pad_volumes,
)
from nnal_tpu_torch.data.samplers import (
    even_odd_slice_split,
    generate_grid_samples,
)
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
)
from nnal_tpu_torch.models.checkpoint import (
    AsyncCheckpointWriter,
    load_checkpoint,
    load_opt_leaves,
    save_checkpoint,
)
from nnal_tpu_torch.models.cnn import CNN, init_cnn
from nnal_tpu_torch.models.optim import layer_train_mask, load_opt_state
from nnal_tpu_torch.models.specs import create_model, with_aleatoric_head
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
from nnal_tpu_torch.scoring.pseudo import confident_samples
from nnal_tpu_torch.scoring.strategies import QueryContext, cnn_query


class PWExperiment:
    """Patch-wise AL experiment over one subject's volumes."""

    def __init__(self, root_dir: str,
                 config: Optional[ExperimentConfig] = None, device=None,
                 mesh=None):
        self.device = resolve_device(device)
        # the data_parallel evaluator's mesh (None: cached_mesh(dp))
        self.mesh = mesh
        self.root_dir = root_dir
        os.makedirs(root_dir, exist_ok=True)
        par_path = os.path.join(root_dir, "parameters.txt")
        if config is None:
            config = ExperimentConfig.from_yaml(par_path)
        else:
            config.to_yaml(par_path)
        check_slice_config(config)
        self.config = config
        self.rng = RngStream(config.seed)
        self._vols: Optional[List[np.ndarray]] = None
        self._mask: Optional[np.ndarray] = None
        self._padded: Optional[torch.Tensor] = None
        self._fcn_slices: Optional[torch.Tensor] = None   # dense models'
        self._overseg: Optional[np.ndarray] = None    # SuPix's SLIC labels
        # ensemble/QBC-JS committee: checkpoint paths (reference
        # pretrained_paths + model_holder)
        self.ensemble_paths: List[str] = []

    # ------------------------------------------------------------- data
    def attach_subject(self, vols, mask) -> None:
        """Provide the subject volumes in memory (tests/synthetic)."""
        self._vols = [np.asarray(v) for v in vols]
        self._mask = np.asarray(mask)
        self._padded = self._fcn_slices = None

    def _load_subject(self):
        if self._vols is None:
            from nnal_tpu_torch.data.io import read_volume

            self._vols = [read_volume(p) for p in self.config.data.img_paths]
            self._mask = read_volume(self.config.data.mask_path)
        return self._vols, self._mask

    def padded(self) -> torch.Tensor:
        """The subject's zero-padded float32 volume on the device (built
        once; the JAX package re-pads per call)."""
        if self._padded is None:
            self._padded = pad_volumes(self._load_subject()[0],
                                       self.config.model.patch_shape,
                                       self.device)
        return self._padded

    def prep_data(self) -> None:
        """Grid-sample the subject; even axial slices feed the pool, the
        full grid is the test set (reference ``prep_AL_data``).  NaN-masked
        voxels are discarded."""
        vols, mask = self._load_subject()
        inds, labels = generate_grid_samples(
            vols[0].shape, self.config.data.grid_spacing, mask)
        pool_inds, test_inds = even_odd_slice_split(inds, vols[0].shape)
        lab_of = dict(zip(inds.tolist(), labels.tolist()))
        save_inds(self._p("init_pool_inds.txt"), pool_inds)
        save_inds(self._p("init_pool_labels.txt"),
                  [lab_of[i] for i in pool_inds.tolist()])
        save_inds(self._p("test_inds.txt"), test_inds)
        save_inds(self._p("test_labels.txt"),
                  [lab_of[i] for i in test_inds.tolist()])
        np.savetxt(self._p("train_stats.txt"), multimg_stats([(vols, mask)]))

    def _p(self, name: str) -> str:
        return os.path.join(self.root_dir, name)

    # ------------------------------------------------------------- model
    def build_model(self):
        m = self.config.model
        d1, d2, d3 = m.patch_shape
        vols = self._load_subject()[0]
        if is_dense(m):
            H, W = vols[0].shape[:2]
            spec = create_model(m.model_name, nclass=m.nclass,
                                input_shape=(int(H), int(W), len(vols)),
                                **dense_model_kwargs(m))
        else:
            spec = create_model(m.model_name, nclass=m.nclass,
                                dropout_rate=m.dropout_rate,
                                patch_shape=(d1, d2, len(vols) * d3))
        return with_aleatoric_head(spec) if m.aleatoric else spec

    def _stats_arrays(self):
        stats = np.loadtxt(self._p("train_stats.txt")).reshape(1, -1)
        return stats[0, 0::2], stats[0, 1::2]

    def make_evaluator(self, spec):
        """Grid pools sweep by im2col, off-grid sets fall back inside,
        z-sharded over the engine's ``mesh`` when ``data_parallel`` > 1;
        dense specs score by whole-slice sweeps."""
        mu, sd = self._stats_arrays()
        if spec.fcn:
            vols = self._load_subject()[0]
            return FCNGridPoolEvaluator(
                spec, vols, mu, sd, tuple(vols[0].shape),
                compute_dtype=eval_compute_dtype(self.config.model.dtype),
                device=self.device,
                hv_patch_shape=tuple(self.config.model.patch_shape))
        return grid_evaluator(self.config, spec, self.padded(), mu, sd,
                              self._load_subject()[0][0].shape, self.mesh)

    def _load_model(self, spec, params) -> CNN:
        model = CNN(spec)
        model.load_state_dict(from_jax_params(params))
        return model.to(self.device)

    def _unlabeled_pool(self) -> np.ndarray:
        """The mean teacher's unlabeled source: the INITIAL pool, so a
        replayed round draws what the original drew."""
        if getattr(self, "_mt_u_pool", None) is None:
            self._mt_u_pool = load_inds(self._p("init_pool_inds.txt"))
        return self._mt_u_pool

    # ------------------------------------------------------------- methods
    def add_method(self, method_name: str, init_size: Optional[int] = None):
        """Create a method directory with the initial pool/train membership
        and the shared initial weights (reference ``add_method``)."""
        j = MethodJournal(self.root_dir, method_name)
        pool = load_inds(self._p("init_pool_inds.txt"))
        init_size = (self.config.query.init_size
                     if init_size is None else init_size)
        host = self.rng.fold(f"init-{method_name}").host
        if init_size > 0:
            pick = host.permutation(len(pool))[:init_size]
            train = pool[pick]
            pool = np.delete(pool, pick)
        else:
            train = np.zeros(0, dtype=np.int64)
        j.init_membership(train, pool)

        init_w = self._p("init_weights.npz")
        if not os.path.exists(init_w):
            model = init_cnn(self.build_model(),
                             self.rng.fold("init-weights").next(),
                             device="cpu")
            save_checkpoint(init_w, to_jax_params(model.state_dict()),
                            bn_state=bn_state_to_jax(model.init_state()))
        params, bn, _, _ = load_checkpoint(init_w)
        save_checkpoint(j.path("curr_weights.npz"), params, bn_state=bn)
        return j

    # ------------------------------------------------------------- training
    def finetune(self, state: TrainState, train_inds, rng_tag: str = "",
                 epochs: Optional[int] = None) -> TrainState:
        """Finetune on the labeled set (reference ``finetune``): gather and
        normalize it once (kernel K2 on the card), then run the round's
        batch-index matrix with the configured levers (module docstring).
        ``rng_tag`` names a committee member's own batch, dropout and
        unlabeled streams (``pw_experiment.py:251-252``, ``:336``)."""
        m = self.config.model
        maybe_reset_opt(state, m)
        epochs = m.epochs if epochs is None else epochs
        if len(train_inds) == 0 or epochs == 0:
            return state
        if state.model.spec.fcn:
            return self._finetune_fcn(state, train_inds, rng_tag, epochs)
        vols, mask = self._load_subject()
        mu, sd = self._stats_arrays()
        orig_shape = tuple(vols[0].shape)
        labels_all = np.asarray(gather_labels(mask, train_inds, orig_shape))
        cw = getattr(m, "class_weights", None)
        if isinstance(cw, str) and cw == "auto":
            cw = inverse_frequency_weights(labels_all, m.nclass)
        # streams keyed on the replay-stable optimizer step, as in the JAX
        # package, so a resumed campaign shuffles identically
        host = self.rng.fold(f"finetune-{rng_tag}{state.step}").host
        seed = self.rng.fold(f"finetune-dropout-{rng_tag}{state.step}").next()
        dev = self.device
        mu_t = torch.as_tensor(np.asarray(mu, np.float32)).to(dev)
        sd_t = torch.as_tensor(np.asarray(sd, np.float32)).to(dev)

        def gather(inds):
            return gather_patches_normalized(
                self.padded(), torch.as_tensor(np.asarray(inds, np.int64)
                                               ).to(dev),
                mu_t, sd_t, tuple(m.patch_shape), orig_shape)

        n = len(train_inds)
        x_all = gather(train_inds)
        y_all = torch.as_tensor(make_onehot(labels_all, m.nclass)).to(dev)
        idx_mat, w_mat = build_batch_index_matrix(n, m.b, epochs, host,
                                                  bucket=256)
        cw_vec = (torch.ones(m.nclass) if cw is None
                  else torch.as_tensor(np.asarray(cw, np.float32))).to(dev)
        grad_mask = (layer_train_mask(state.model, m.train_layers)
                     if m.train_layers else None)
        with deterministic_cudnn():
            lwf = None
            if m.lwf_lambda > 0.0:
                # the previous model's logits of the labeled set, f32 and
                # without dropout, once per round (``:310-320``)
                with torch.no_grad():
                    lwf = LwF(state.model(x_all).logits,
                              float(m.lwf_lambda), float(m.lwf_T))
            mt = None
            cc, cc_scale = mt_rampdown(m, n)
            if cc > 0.0:
                if state.teacher is None:
                    state.teacher = make_teacher(state.model)
                u_pool = self._unlabeled_pool()
                uhost = self.rng.fold(
                    f"finetune-unlab-{rng_tag}{state.step}").host
                n_take = 256
                u_sub = u_pool[uhost.integers(0, len(u_pool), size=n_take)]
                ub = int(m.unlabeled_batch) or m.b
                mt = MeanTeacher(
                    xu_all=gather(u_sub),
                    u_idx=build_unlabeled_index_matrix(
                        n_take, ub, idx_mat.shape[0], uhost),
                    coeff=cc, cc_scale=cc_scale,
                    measure=str(m.consistency_measure),
                    ramp=int(m.consistency_ramp),
                    ema_decay=float(m.ema_decay), step0=state.step)
            finetune_steps(state, x_all, y_all, idx_mat, w_mat, cw_vec,
                           core_rng.fold_key(seed, state.step),
                           compute_dtype=eval_compute_dtype(m.train_dtype),
                           mc_t=int(m.mc_t), grad_mask=grad_mask, lwf=lwf,
                           mt=mt)
        return state

    def _dense_slices(self) -> torch.Tensor:
        """The subject's normalized (Z, H, W, C) slice stack on the device,
        built once."""
        if self._fcn_slices is None:
            mu, sd = self._stats_arrays()
            self._fcn_slices = torch.from_numpy(normalized_slices(
                self._load_subject()[0], mu, sd)).to(self.device)
        return self._fcn_slices

    def _finetune_fcn(self, state: TrainState, train_inds, rng_tag: str,
                      epochs: int) -> TrainState:
        """The dense finetune (module docstring; ``pw_experiment.py:
        364-512``): the labeled voxels' slices, a pixel weight of 1 (or
        the class weight) at each labeled voxel, then the BN refresh."""
        m = self.config.model
        warn_fcn_unsupported_keys(self, m)
        vols, mask = self._load_subject()
        H, W, Z = vols[0].shape
        slices = self._dense_slices()
        train_inds = np.asarray(train_inds, np.int64)
        x_, y_, z_ = np.unravel_index(train_inds, (H, W, Z))
        lab = np.asarray(mask).reshape(-1)[train_inds].astype(np.int64)
        zs = np.unique(z_)
        S = len(zs)
        s_bucket = -(-S // 8) * 8
        z_pad = np.concatenate([zs, np.full(s_bucket - S, zs[0], np.int64)])
        cw = getattr(m, "class_weights", None)
        if isinstance(cw, str) and cw == "auto":
            cw = inverse_frequency_weights(lab, m.nclass)
        si = np.searchsorted(zs, z_)
        y_vol = np.zeros((s_bucket, H, W), np.int64)
        wpix = np.zeros((s_bucket, H, W), np.float32)
        y_vol[si, x_, y_] = lab
        wpix[si, x_, y_] = 1.0 if cw is None else np.asarray(cw)[lab]
        dev = self.device
        x_all = slices[torch.as_tensor(z_pad).to(dev)]
        y_all = torch.as_tensor(make_onehot(y_vol.reshape(-1), m.nclass)
                                .reshape(s_bucket, H, W, m.nclass)).to(dev)
        host = self.rng.fold(f"finetune-{rng_tag}{state.step}").host
        seed = self.rng.fold(f"finetune-dropout-{rng_tag}{state.step}").next()
        fcn_b = max(1, min(int(m.b), 4))     # slices are whole images
        idx_mat, w_mat = build_batch_index_matrix(S, fcn_b, epochs, host,
                                                  bucket=8)
        grad_mask = (layer_train_mask(state.model, m.train_layers)
                     if m.train_layers else None)
        with deterministic_cudnn():
            mt = None
            cc, cc_scale = mt_rampdown(m, len(train_inds))
            if cc > 0.0:
                if state.teacher is None:
                    state.teacher = make_teacher(state.model)
                # unlabeled whole slices of the subject, step-keyed
                uhost = self.rng.fold(
                    f"finetune-unlab-{rng_tag}{state.step}").host
                n_u = min(16, Z)
                u_z = uhost.integers(0, Z, size=n_u)
                ub = max(1, min(int(m.unlabeled_batch) or fcn_b, 4))
                mt = MeanTeacher(
                    xu_all=slices[torch.as_tensor(u_z).to(dev)],
                    u_idx=build_unlabeled_index_matrix(
                        n_u, ub, idx_mat.shape[0], uhost),
                    coeff=cc, cc_scale=cc_scale,
                    measure=str(m.consistency_measure),
                    ramp=int(m.consistency_ramp),
                    ema_decay=float(m.ema_decay), step0=state.step)
            finetune_fcn_steps(state, x_all, y_all, wpix, idx_mat, w_mat,
                               core_rng.fold_key(seed, state.step),
                               eval_compute_dtype(m.train_dtype),
                               grad_mask=grad_mask, mt=mt)
            if state.bn_state:
                # the scan trains on batch statistics; re-center the
                # running ones on the new weights (decay 0.6, 8 batches)
                for _ in range(8):
                    bi = host.integers(0, S, size=fcn_b)
                    state.bn_state = bn_refresh(
                        state.model, state.bn_state,
                        x_all[torch.as_tensor(bi).to(dev)], 0.6)
        return state

    def finetune_wpool(self, spec, state: TrainState, train_inds,
                       pool_inds, n_pseudo: int, *,
                       epochs: Optional[int] = None,
                       threshold: float = 0.9) -> TrainState:
        """Finetune on the labels plus the ``n_pseudo`` most confident pool
        voxels at their pseudo-labels (reference ``finetune_wpool``,
        PW_AL.py:500-543; ``pw_experiment.py:768-800``): the pseudo-labels
        patch the label mask for the one finetune (K2 gathers both sets),
        and the mask is restored after it, also on an error.  The
        evaluator is kept per spec."""
        cache = getattr(self, "_wpool_ev_cache", None)
        if cache is None or cache[0] is not spec:
            cache = self._wpool_ev_cache = (spec, self.make_evaluator(spec))
        p1 = cache[1].evaluate(state.model, pool_inds,
                               ("posteriors",))["posteriors"]
        conf_inds, pseudo, _ = confident_samples(p1, pool_inds, n_pseudo,
                                                 threshold)
        _, mask = self._load_subject()
        patched = np.array(mask, dtype=np.float64)
        patched[np.unravel_index(conf_inds, patched.shape)] = pseudo
        orig_mask = self._mask
        self._mask = patched
        try:
            return self.finetune(state, np.concatenate([train_inds,
                                                        conf_inds]),
                                 epochs=epochs)
        finally:
            self._mask = orig_mask

    def modify_parameters(self, **kw) -> None:
        """In-place config edits persisted back to ``parameters.txt``
        (``pw_experiment.py:801-809``).  The finetune builds its
        ``train_layers`` mask from the config at each call, so an edit
        takes effect at the next finetune; a dense run's ignored keys warn
        the first time (``warn_fcn_unsupported_keys``)."""
        pars = self.config.pars
        pars.update(kw)
        config = ExperimentConfig.from_pars(pars)
        check_slice_config(config)
        self.config = config
        config.to_yaml(self._p("parameters.txt"))

    def reset_method(self, method_name: str) -> None:
        """Wipe a method's state back to the initial membership and weights
        (``pw_experiment.py:811-819``)."""
        mdir = os.path.join(self.root_dir, method_name)
        if os.path.exists(mdir):
            shutil.rmtree(mdir)
        self.add_method(method_name)

    def load_results(self, method_name: str) -> np.ndarray:
        """Per-round F-measures (``pw_experiment.py:861-864``)."""
        return MethodJournal(self.root_dir, method_name).load_evals()

    def _ensemble_params(self, spec):
        """The committee of ``ensemble_paths`` (None when unset)."""
        if not self.ensemble_paths:
            return None
        return [self._load_model(spec, load_checkpoint(p)[0])
                for p in self.ensemble_paths]

    def _build_committee(self, spec, state: TrainState, train_inds,
                         round_id: int) -> List[CNN]:
        """The committee of ensemble/QBC-JS (``pw_experiment.py:821-859``):
        with an empty labeled set, ``pretrained_paths`` or
        ``ensemble_paths`` if given, else ``n_ensemble`` fresh inits;
        otherwise ``n_ensemble`` copies of the current model, each with a
        fresh optimizer at the main state's step and no mean teacher (under
        MT it builds its own from its copy), finetuned with its own
        streams.  The copies share no tensor with the main state."""
        m, q = self.config.model, self.config.query
        if len(train_inds) == 0:
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
            # a member's BN refresh moves its own copy of the running
            # state, which is then dropped: members score on the main
            # model's statistics (``pw_experiment.py:826-858``)
            mstate.bn_state = state.bn_state
            self.finetune(mstate, train_inds,
                          rng_tag=f"ens-{round_id}-{i}-")
            members.append(mstate.model)
        return members

    def _replay_to_round(self, j, state, al_state, train_inds, round_id):
        """Re-run the finetunes of journaled rounds the checkpoint does not
        hold (an anchor from an earlier round, or a crash between the query
        journal and the save).  The live process adopted the anchor dtype's
        rounding at every anchor round, so replay re-applies it at the same
        rounds (``pw_experiment.py:515-540``)."""
        K = max(1, int(getattr(self.config.model, "ckpt_full_every", 1)))
        anchor = (0 if al_state is None
                  else int(al_state.get("round", round_id)))
        for i, ln in enumerate(replay_prefix_lens(j, al_state, round_id,
                                                  len(train_inds))):
            state = self.finetune(state, train_inds[:ln])
            if (anchor + i + 1) % K == 0:
                adopt_anchor_rounding(state, self.config.model)
        return state

    def _save_resume_point(self, ckpt, state, round_id, writer=None):
        """Capture the payload, adopt the anchor rounding into the live
        state, then save the captured originals (``:695-733``) — from
        ``writer``'s thread when given (``write_checkpoint``)."""
        m = self.config.model
        akw = anchor_save_kwargs(m, state)
        adopt_anchor_rounding(state, m)
        al = {"step": int(state.step), "round": int(round_id)}
        write_checkpoint(
            lambda: save_checkpoint(ckpt, akw["params"], al_state=al,
                                    bn_state=akw["bn_state"],
                                    teacher_params=akw["teacher_params"],
                                    opt_state=akw["opt_state"],
                                    dtype=akw["dtype"]),
            writer, self.device)

    @staticmethod
    def _sync_bn(evaluator, state: TrainState) -> None:
        """A dense evaluator scores on the current running statistics:
        after the resume's replay (which re-centers them) and after every
        finetune (``pw_experiment.py:594-600``, ``:678-681``)."""
        if isinstance(evaluator, FCNGridPoolEvaluator):
            evaluator.bn_state = state.bn_state

    # ------------------------------------------------------------- AL loop
    def run_method(self, method_name: str, max_queries: int) -> Dict:
        """The AL loop (reference ``run_method``), resumable: replayed
        queries count toward ``max_queries``."""
        cfg = self.config
        j = MethodJournal(self.root_dir, method_name)
        spec = self.build_model()
        evaluator = self.make_evaluator(spec)
        test_inds = load_inds(self._p("test_inds.txt"))
        test_labels = load_inds(self._p("test_labels.txt"))

        ckpt = j.path("curr_weights.npz")
        params, bn, teacher, al_state = load_checkpoint(ckpt)
        model = self._load_model(spec, params)
        state = init_train_state(model, cfg.model.optimizer_name,
                                 cfg.model.learning_rate)
        state.bn_state = bn_state_to_port(bn, self.device)
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
        state = self._replay_to_round(j, state, al_state, train_inds,
                                      round_id)
        self._sync_bn(evaluator, state)

        timer = PhaseTimer(j.path("phases.jsonl"), self.device)
        writer = (AsyncCheckpointWriter()
                  if getattr(cfg.model, "async_checkpoint", False) else None)
        K = max(1, int(getattr(cfg.model, "ckpt_full_every", 1)))
        tb_root = getattr(cfg, "tb_logdir", None)
        tb = TBWriter(tb_root and os.path.join(str(tb_root), method_name))
        # the entry state is reproducible as is (anchor or replay above)
        last_full_round = round_id
        # pool guard: an exhausted pool would yield k=0 rounds forever
        while n_queries < max_queries and len(pool_inds) > 0:
            t0 = time.time()
            k = min(cfg.query.k, max_queries - n_queries, len(pool_inds))
            if cfg.query.iter_k:
                k = min(k, cfg.query.iter_k[min(round_id,
                                                len(cfg.query.iter_k) - 1)])
            if k <= 0:
                break
            # per-round stateless stream: replayable from (seed, method,
            # round) alone
            qrng = self.rng.fold(f"query-{method_name}-{round_id}")
            if method_name in ("ensemble", "QBC-JS"):
                with timer.phase("committee"):
                    committee = self._build_committee(spec, state,
                                                      train_inds, round_id)
            else:
                committee = self._ensemble_params(spec)
            m = cfg.model
            vols, mask = self._load_subject()
            ctx = QueryContext(spec=spec, params=model, evaluator=evaluator,
                               pool_inds=pool_inds, k=k, rng=qrng.host,
                               B=cfg.query.B, lambda_=cfg.query.lambda_,
                               diag_load=float(cfg.query.diag_load),
                               train_inds=train_inds, seed=qrng.next(),
                               MC_iters=cfg.query.MC_iters,
                               ensemble_params=committee,
                               raw_volume=vols[0],
                               extra={"mask": mask,
                                      "overseg": self._overseg,
                                      "gaussian_noise_std":
                                      m.gaussian_noise_std,
                                      "rotation_angle": m.rotation_angle,
                                      "output_perturbation_measure":
                                      m.output_perturbation_measure,
                                      "influence_mode":
                                      cfg.query.influence_mode,
                                      "arnoldi_rank":
                                      cfg.query.arnoldi_rank})
            with timer.phase("score_select"):
                q_pos = cnn_query(ctx, method_name)
            # SLIC's oversegmentation depends on the volume alone: kept
            # across rounds
            self._overseg = ctx.extra.get("overseg")
            # the committee's weights (and the copies' device memory) go
            # with the round's scoring
            del ctx, committee
            if writer is not None:
                with timer.phase("checkpoint"):
                    # the previous round's save overlapped the scoring; it
                    # must be durable before this round writes any state
                    writer.wait()
            q_inds = pool_inds[q_pos]

            # bookkeeping: journal then membership (replayable order)
            j.record_queries(round_id, q_inds)
            train_inds = np.concatenate([train_inds, q_inds])
            pool_inds = np.delete(pool_inds, q_pos)
            j.init_membership(train_inds, pool_inds)
            n_queries += len(q_inds)
            round_id += 1

            with timer.phase("train"):
                state = self.finetune(state, train_inds)
            self._sync_bn(evaluator, state)
            with timer.phase("eval"):
                preds = evaluator.evaluate(model, test_inds,
                                           ("prediction",))["prediction"]
                fm = f_measure(preds, test_labels)
            j.append_eval([fm])
            tb.scalars({"al/f_measure": fm, "al/n_train": len(train_inds)},
                       round_id - 1)

            dt = time.time() - t0
            with open(j.path("query_times.txt"), "a") as f:
                f.write(f"{round_id - 1} {dt:.3f}\n")

            with timer.phase("checkpoint"):
                # anchor rounds write the full resume point; in between,
                # ckpt_full_every > 1 skips the save (resume replays the
                # journaled finetunes from the anchor)
                if round_id % K == 0:
                    self._save_resume_point(ckpt, state, round_id, writer)
                    last_full_round = round_id
            timer.commit_round(round_id - 1, n_train=len(train_inds),
                               n_pool=len(pool_inds), f_measure=fm)
            j.save_state(round_id=round_id, rng_state=self.rng.state(),
                         n_train=len(train_inds), n_pool=len(pool_inds))

        with timer.phase("checkpoint"):
            if writer is not None:
                writer.wait()     # the last round's save must land
            if last_full_round != round_id:
                # a finished run always leaves a full resume point, so
                # readers see the final weights and a later run_method
                # resumes without replay
                self._save_resume_point(ckpt, state, round_id)
        if timer.current:
            timer.commit_round(round_id - 1, tail=True)
        tb.close()
        return {
            "n_queries": n_queries,
            "train_inds": train_inds,
            "pool_inds": pool_inds,
            "perf": j.load_evals(),
        }
