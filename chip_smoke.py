"""Smoke run of the PyTorch port (``nnal_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which passes or exits non-zero:

1. the card: ``nvidia-smi`` name and power limit;
2. the kernel build: every ``nnal_tpu_torch/csrc`` source through nvcc
   (one process per source, in parallel), timed;
3. K1 ``rowmax_similarity`` (split-precision TF32 on ``wgmma``) vs its
   plain version on the card at the core-set shapes (P 65,536 x 4096; R
   256 and 512 x 4096, the campaign's rounds 0 and 1, and a ragged 320),
   plus the padding-never-wins, zero-row, ragged-d and unaligned cases
   (the f32 FMA path); max |delta| <= 1e-5.  Full-width adversarial rows
   (equal entries, TF32 rounding boundaries, magnitudes 1e-3 and 1, rows
   repeated in R) are held to the float64 truth within 1e-5, since the
   f32 plain version itself strays from it there; the binary must hold
   ``HGMMA`` and ``UTMALDG`` instructions (``cuobjdump``);
4. K2 ``gather_patches_normalized`` vs its plain version on the card,
   bit-equal, for patch shapes (25,25,1), (25,25,3), (24,24,1) on a
   2-modality 128x128x32 subject, 4096 random indices, (64,64,2) on a
   wider volume, 3 modalities, at the campaign's 384 and at fi's 200
   candidates; the
   y-contiguous copy is made once per volume; device time (CUDA events
   behind a sleep kernel, and a ``torch.profiler`` window at 384) apart
   from the host's cost per call;
5. PW1 25x25x2 posteriors on 1024 patches, and the evaluator's off-grid
   (per-patch gather) route on 256 voxels, card vs host, atol 1e-4;
   then the stochastic pieces, card vs host with the same draws fed to
   both through the port's draw functions (``HostDraws``): MC dropout on
   1024 patches (1e-4; rate 0 under ``mc_dropout`` bit-equal to the
   deterministic forward), the MC grid sweep's keying on the campaign
   subject (slab rows == whole-sweep rows bit for bit) and its rate (10
   passes over 131,072 rows, f32 and bf16), ``rotate_2d`` (1e-5 at 0.3
   rad and pi/2), AU_4U's CE and L2 (1e-4) and the perturb sweep's
   rows/s, and BatchBALD (T 10 x 200), rep-entropy and BADGE (200
   candidates of 1024 patches) with identical picks; and one finetune
   step of each training lever from the same PW1 weights and 128-patch
   labeled and unlabeled batches, card vs host with the same dropout
   uniforms and aleatoric normals (``KeyedDraws``), plain SGD: the mean
   teacher, CE and MSE (loss 1e-4, params and the EMA teacher 1e-5),
   LwF and the aleatoric CE (loss and params 1e-5), ``train_layers``
   [fc1, fc2, fc3] (conv weights bit-identical), then each lever's
   seconds per Adam step beside the plain step's;
6. the second-order path at full width, card vs host (PW1 25x25x2 from
   seed 0, 256 labeled rows and 200 candidates of the campaign subject;
   rows within 3e-7 of a relu or max-pool kink are weighted out of the
   batch quantities, and the HVP over all rows is held at 1e-2): one HVP
   (1e-4 of max |Hv|), truncated CG at a fixed 8 iterations (the same
   iterations and curvature exit, 1e-3), the jvp influence scores of the
   candidates (1e-4 of max |score|; 0.1 near a kink; and the card's
   against the ``vmap(grad)`` oracle on 16, 1e-4), Lanczos and
   ``arnoldi_s_test`` at rank 4 from one numpy start (eigenvalues 1e-3 of
   max |lambda|, s_test 1e-3), ``per_sample_grads`` of 8 rows (1e-5 per
   row, 0.1 near a kink) and ``diagonal_fisher`` (1e-5); then ms and
   TFLOP/s per HVP at the 256- and 512-row buckets and seconds per
   Lanczos basis at rank 8;
7. SLIC native vs numpy on 4 slices of the campaign subject (equal label
   maps), seconds per volume of the native ``oversegment_volume``, and
   ``high_variance_filter`` card vs host (the same positions);
8. FIM parity, card vs host (the same port code with ``device="cpu"``):
   ``pool_score_fused`` on 256 gathered PW1 25x25x2 patches (p1 atol
   1e-4; shrunk per layer column within 1e-4 of the column's max |.|),
   ``gather_shrunk_a_matrices`` at B = 200 (K2 must launch; A held the
   same way), and the A-optimal solver on those A: ``lambda_ = 0`` with
   and without ``cap_peak`` (q within 1e-4, objective within 1e-5) and
   ``lambda_ = 0.5`` with refined features (objective within 1e-4), with
   ``fi/sdp`` seconds (CUDA-graph and eager loops) and iterations;
9. the FIM sweep at ``bench.py``'s size: a synthetic 256x256x64
   two-modality subject, grid spacing 2, PW1 25x25x2, f32 (1,048,576
   patches): patches/s, seconds, peak memory, 64 rows checked against the
   host, and a ``torch.profiler`` window over one z-chunk (top device ops,
   the conv / fc / im2col split, the card's idle share, and no
   weight-gradient kernel);
10. the campaign: ``do_expr(..., device="cuda")`` on a synthetic
   128x128x32 subject (pool of 65,536 grid voxels), 2 rounds (1 for the
   runs in ``ONE_ROUND``, whose second round runs no other code) each of
   ``entropy``, ``core-set``, ``random`` and ``fi`` (init 256, k 64, b
   128, Adam 1e-3; fi: B 200, lambda_ 0), and of ``MC-entropy``,
   ``BALD``, ``BatchBALD``, ``ensemble``, ``QBC-JS``, ``AU_4U`` (and
   once more with a 0.3 rad rotation), ``rep-entropy`` and ``BADGE`` at
   the JAX package's defaults (MC_iters 10, n_ensemble 5, B 200, noise
   std 0.05, CE), and the training levers: ``entropy`` with the mean
   teacher (coefficient 1, CE, ramp 20, EMA 0.99, 128 unlabeled patches a
   step, mirrored to TensorBoard), with LwF (lambda 1, T 2) and with the
   aleatoric head (``mc_t`` 10), and ``random`` with ``train_layers``
   [fc1, fc2, fc3], and ``influence`` (cg, and arnoldi at rank 8; B 200),
   ``ps-random`` and ``SuPix`` (64 segments a slice, whole superpixels a
   round); launch counts are zeroed just before and read just
   after, and every kernel must have launched (K2 at least 4 times in
   fi, twice a round in the mean teacher's run, n_ensemble + 1 times a
   round in each committee method, whose rounds must hold a ``committee``
   phase; at least 6 in each influence run, whose rounds must hold the
   ``influence/*`` sub-spans); the mean teacher's ``teacher/`` group must
   be saved, and ``train_layers`` must leave every conv weight
   bit-identical to round 0's; then ``finetune_wpool`` once on the
   entropy run's state (256 pseudo-labels, timed), its confident picks
   from 4096 pool voxels card vs host (the same voxels and labels);
11. bf16 (``model.dtype`` bfloat16): PW1 posteriors on 1024 patches card
   vs host (max 2e-2, mean 2e-3: the card rounds each conv's sum before
   the bias) and against f32, plus the fcs' f32-output bf16 GEMM and its
   hand-written backward against autograd on upcast operands;
12. the bf16 FIM sweep on phase 9's pool through ``make_pool_scorer``'s
   compute dtype: patches/s, TFLOP/s and the bound at 989 TFLOP/s, peak
   memory, a profiler window, 64 rows against the host (p1 2e-2; shrunk
   correlation > 0.995, max |delta| < 0.1 of max |host|) and the top-1024
   uncertainty overlap with the f32 sweep;
13. the checkpoint codecs on the f32 campaign's entropy state (Adam
   moments included): ``round_trip_bf16`` / ``round_trip_int8`` on the
   card bit-equal to the numpy encode, the card's file encode equal to
   the host's, and the seconds and bytes of one save at f32, bf16, int8,
   also with a mean teacher's group;
14. the bf16 campaign: 2 rounds each of entropy, core-set, BALD,
   QBC-JS, entropy with the mean teacher (bf16 anchors, the teacher's
   too) and influence (cg; bf16 posteriors, f32 s_test) and fi (int8
   anchors), bf16 sweeps (MC ones too) and finetunes
   (the committee's and the teacher's forwards too), ``ckpt_full_every``
   2,
   ``async_checkpoint``; its launch counts are zeroed before and read
   after it, and K1 and K2 must launch;
15. resume == continue: a 4-round random campaign with int8 anchors every
   3 rounds, run uninterrupted and then crashed after round 3 and
   resumed by replay in a fresh ``PWExperiment``: the final
   ``curr_weights.npz``, the query journal and ``perf_evals.txt`` must be
   bit-identical; again with the mean teacher (its int8 ``teacher/``
   group included); and the finetune's seconds with and without
   deterministic cuDNN, interleaved in one process;
16. the multi-subject engine (``MultiImgExperiment``): ``query_multimg``
   with all 15 strategies on the card over three 64x64x16 subjects (k 64,
   B 200, 2 MC passes, 3 members), the picks of entropy, core-set,
   rep-entropy, BALD, BatchBALD and BADGE equal on the host with the same
   weights and draws, and fi's A-matrices of the card's candidates held
   on the host (the row rule below; ``multi picks ok``); 128-query
   campaigns (64 for the f32 ``MULTI_ONE_ROUND``) over three 128x128x32
   subjects (131,072 grid voxels each), a
   test and a held subject, from an empty start: f32 entropy, core-set
   (round 0 from the held subject's features through K1), fi, QBC-JS (3
   members), influence (64 labels seeded) and entropy with the mean
   teacher, every finetune gathering each subject's labels through K2,
   and bf16 entropy and fi (int8 anchors every 2 rounds, async writes, a
   float16 history copy every 2 rounds), each checked (journal columns,
   membership, rounds, sub-spans, history copies, anchors, K1 / K2
   launches) with the launch counts zeroed just before each campaign and
   read just after; K2's copy cache must make one copy per distinct
   volume; multi resume == continue (random, int8 anchors every 3
   rounds, crashed after round 3) bit for bit; ``sequential_al`` over
   two subjects, warm-started; and the host loader (``PrefetchLoader``
   over the native gather: each batch equal to the host source's, within
   1 ulp of K2, and its batches/s);
17. the dense-model path (``phase_dense``): FC-DenseNet-103 at its
   published width and depth (108 spec rows, 9.32 M parameters, 13.0
   GFLOP a 128x128x2 slice, counted from the spec by ``dense_flops``)
   from one seed's weights and a refreshed BN state, card vs host on 4
   slices of the campaign subject: eval mode on the running statistics
   and train mode on the batch's with the moved state (posteriors atol
   1e-4, features and state 1e-4 relative); one finetune step with the
   same dropout uniforms (``KeyedDraws``) and plain SGD, plain and under
   the mean teacher: card and host each held to a float64 step on the
   card (the f32 update of this net is good to ~2e-3 of its size on
   either device; the card within 2x the host's error and 1e-2), then
   the BN refresh on the float64 step's weights card vs host (1e-4
   relative), and the seconds per Adam step of each; the whole-slice sweep's
   slices/s and TFLOP/s at f32 and bf16 (32 slices, batches of 4) and the
   bf16 sweep's top-1024 uncertainty overlap with f32 (tie-aware, at
   least 80%); K1 at d = 16 (P the pool's 65,536 per-pixel features, R
   256, 512 and a ragged 320) against its plain version within 1e-5,
   with its ms beside the bound; 2-round dense campaigns (1 for
   ``DENSE_ONE_ROUND``; f32: entropy,
   core-set, fi, BALD with 10 MC passes, BADGE, QBC-JS with 3 members,
   entropy with the mean teacher; bf16: entropy and fi), each checked
   (rounds, picks, membership, no K2 launch, K1 in core-set, the ``bn/``
   group, fi's sub-spans, the committee phase, the teacher group); dense
   resume == continue bit for bit (entropy, 3 rounds, int8 anchors every
   2, crashed after round 2); and a multi-subject dense campaign of
   entropy and fi over two 128x128x32 subjects and one 96x96x32 (two
   shape groups; 128 and 64 queries), every test evaluator on the
   engine's BN state;
18. the classification engine (``phase_cls``): AlexNet at its published
   width and 227x227x3 input (71,945,608 parameters, 2.5244 GFLOP an
   image, counted from the spec by ``cls_flops``) from one seed's
   weights, card vs host: posteriors of 4 images (1e-5) and fc7 features
   (1e-4 relative), one SGD and one Adam (eps 1e-3) step of
   ``make_train_step`` on a padded batch of 32 with the same dropout
   uniforms (``KeyedDraws``), each device's update held to a float64
   step on the card within 1e-2 of its size (2-norm; SGD's worst element
   too; f32 moves some max-pool argmaxes, so ~1e-3 is its limit), and the
   seconds
   per Adam step; VGG19 at 224x224x3 on 2 images (1e-5, 1e-4); the pool
   sweep's images/s and TFLOP/s at f32 and bf16 (4,096 images from host
   RAM in chunks of 256, and one resident chunk); K1 at the
   classification shape (P the campaign pool's 4,096-row bucket of fc7
   features, R the 256-row labeled bucket of rounds 0 and 1) against its
   plain version within 1e-5, with its ms beside the bound and
   ``matmul + amax``; the campaign: ``run_classification_al(...,
   device="cuda")`` at ``DEFAULT_CLS_PARS`` (k 10, B 100, ntb 256, b 32,
   2 epochs, Adam 1e-3, dropout 0.5, init 20, test 20%) on 4,096
   synthetic 8-class images of 227x227x3 (oriented gratings under noise,
   ``benchmarks/cls_campaigns.make_dataset`` scaled up; 2.5 GB of f32 in
   host RAM): 2 rounds of each of the 13 strategies (1 for
   ``CLS_ONE_ROUND``; fi to 10 queries), ``entropy`` with the mean
   teacher and with LwF, and ``random`` with ``train_dtype`` bfloat16,
   each checked (accuracies, picks, membership, K1 in every core-set
   round, no K2 launch, the committee phase, the teacher group);
   classification resume == continue bit for bit (entropy, 3 rounds,
   anchors every 2, crashed after round 2); one round each of entropy
   and core-set with VGG19 on 512 images of 224x224x3 (K1 on VGG's fc2
   features); and ``softmax_harness.run_comparison`` on the card;
19. lines with the new methods' per-round seconds, the MC and perturb
   sweeps' rates, the committee campaigns' peak memory, the lever runs'
   per-round seconds, each lever's seconds per finetune step, the
   checkpoint bytes with the teacher, whether the TensorBoard mirror
   was active (it needs the ``tensorboard`` package), and the influence,
   ps-random and SuPix runs' per-round seconds with the ``influence/*``
   spans, CG iterations and peak memory, then one
   ``phases`` JSON line (per-round seconds from ``phases.jsonl`` of both
   campaigns, build seconds, K1's SASS counts, the FIM, bf16, codec,
   resume, MC, perturbation, selection, second-order, SLIC and
   ``finetune_wpool`` phases, the multi-subject and the dense ones) and
   one ``kernels`` JSON line (times, bounds, launches in every campaign;
   K1's row also its times at d = 16 under ``at_d16`` and at the
   classification shape under ``at_cls``).

The row and column tolerance rules for shrunk gradients and A-matrices:
the linear head's column is zero in exact arithmetic (a constant added to
every logit leaves log-softmax unchanged), so it is held near zero
(<= 1e-4 of the largest column), not relative to itself.  Class 0
comes from the zero-sum identity g0 = -p1 g1 / p0, which divides f32
rounding by p0: where p0 < 1e-3 it is left out of both rules.  A row may
exceed 1e-4 only where its patch sits near a kink — a relu input, or the
gap between a max-pool window's two largest inputs, within 3e-7 of the
layer's largest value (13% of PW1 25x25x2 patches on the host; 1e-7 of
it is about where the two devices' f32 sums part) — since rounding on
the other device can then flip a gate or an argmax and move that unit's
gradient; such rows are at most 5% and stay within 0.1 (the first card
run had 4 of 256 beyond 1e-4, median 3.7e-7).

The last line is ``{"ok": true, "device": {...}}``.  Without CUDA the
script exits non-zero and prints no result.  The campaign runs under
``_smoke_expr/`` beside this file (git-ignored) and is removed at the end.
"""

from __future__ import annotations

import copy
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from nnal_tpu_torch import ops
from nnal_tpu_torch.ops._build import stream_ptr
from nnal_tpu_torch.cli.expr_handler import DEFAULT_PARS, create_expr, do_expr
from nnal_tpu_torch.cli import run_querying
from nnal_tpu_torch.cli.softmax_harness import run_comparison, synthetic_mnist
from nnal_tpu_torch.data.image_pool import InMemoryPool
from nnal_tpu_torch.engine import experiment as experiment_mod
from nnal_tpu_torch.core import rng as core_rng
from nnal_tpu_torch.core.config import ExperimentConfig, set_parameters
from nnal_tpu_torch.core.profiling import drain_subphases
from nnal_tpu_torch.core.device import deterministic_cudnn, set_precision
from nnal_tpu_torch.data.io import synthetic_subject
from nnal_tpu_torch.core.journal import MethodJournal
from nnal_tpu_torch.data.patches import pad_volumes
from nnal_tpu_torch.data.samplers import (
    even_odd_slice_split,
    generate_grid_samples,
    high_variance_filter,
)
from nnal_tpu_torch.engine import multi_experiment, pw_experiment
from nnal_tpu_torch.engine.sequential import sequential_al
from nnal_tpu_torch.data.loaders import (
    patch_batch_source,
    prefetched_patch_batches,
)
from nnal_tpu_torch.data.stats import multimg_stats
from nnal_tpu_torch.runtime.native import gather_patches_native
from nnal_tpu_torch.models import checkpoint as ckpt
from nnal_tpu_torch.models import cnn as cnn_mod
from nnal_tpu_torch.models import losses as losses_mod
from nnal_tpu_torch.models import perturb as perturb_mod
from nnal_tpu_torch.models.bridge import (
    from_jax_params,
    to_jax_params,
    to_jax_tensors,
)
from nnal_tpu_torch.models.cnn import CNN, init_cnn, linear_f32acc
from nnal_tpu_torch.models.optim import (
    layer_train_mask,
    load_opt_state,
    make_optimizer,
    opt_state_leaves,
    opt_state_tensors,
)
from nnal_tpu_torch.models.specs import (
    create_model,
    create_pw1,
    with_aleatoric_head,
)
from nnal_tpu_torch.models.surgery import extend_params_to_aleatoric
from nnal_tpu_torch.models.train import (
    LwF,
    MeanTeacher,
    TrainState,
    bn_refresh,
    build_batch_index_matrix,
    finetune_fcn_steps,
    finetune_steps,
    init_train_state,
    make_teacher,
    make_train_step,
)
from nnal_tpu_torch.scoring import cls_strategies as cls_mod
from nnal_tpu_torch.scoring.fcn_eval import (
    FCNGridPoolEvaluator,
    normalized_slices,
)
from nnal_tpu_torch.scoring.grid_eval import GridPoolEvaluator
from nnal_tpu_torch.ops.gather import (
    gather_patches_normalized,
    gather_patches_plain,
)
from nnal_tpu_torch.ops.scoring_fused import make_pool_scorer, pool_score_fused
from nnal_tpu_torch.scoring import batchbald as bb_mod
from nnal_tpu_torch.scoring import strategies as strat_mod
from nnal_tpu_torch.scoring import hessian as hessian_mod
from nnal_tpu_torch.scoring import influence as infl_mod
from nnal_tpu_torch.scoring import representative as rep_mod
from nnal_tpu_torch.scoring import sdp
from nnal_tpu_torch.scoring import superpixel as sp_mod
from nnal_tpu_torch.scoring.pool_eval import PoolEvaluator, mc_stack_posteriors
from nnal_tpu_torch.scoring.pseudo import confident_samples
from nnal_tpu_torch.scoring.uncertainty import binary_uncertainty_filter
from nnal_tpu_torch.scoring.fisher import refine_feature_matrix
from nnal_tpu_torch.scoring.gradients import (
    diagonal_fisher,
    gather_shrunk_a_matrices,
    per_sample_grads,
)
from nnal_tpu_torch.scoring.grid_eval import extract_normalize
from nnal_tpu_torch.ops.similarity import (
    normalize_rows,
    rowmax_similarity,
    rowmax_similarity_plain,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
# published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12        # float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12      # TF32 on the tensor cores, dense
PEAK_BF16_FLOPS = 989e12     # bf16 on the tensor cores, dense
PEAK_HBM_BYTES = 3.35e12
SHAPE = (128, 128, 32)
METHODS = ("entropy", "core-set", "random", "fi")
OVERRIDES = ("patch_shape=[25,25,1],grid_spacing=2,k=64,B=128,b=128,"
             "epochs=1,init_size=256,learning_rate=1e-3,"
             "optimizer_name=Adam,ntb=4096,synthetic_shape=[128,128,32],"
             "seed=0")
# fi: 200 candidates, and exactly 2 rounds (a round may return fewer than
# k picks: the PMF is drawn with replacement and deduplicated)
OVERRIDES_FI = OVERRIDES.replace("B=128", "B=200") + ",iter_k=[64,64,0]"
FI_SUBS = {"fi/posteriors", "fi/gather_grads_A", "fi/sdp", "fi/pmf"}
# the stochastic and batch-diverse strategies at the JAX package's
# defaults: MC_iters 10, n_ensemble 5, B 200, noise std 0.05, measure CE
NEW_METHODS = ("MC-entropy", "BALD", "BatchBALD", "ensemble", "QBC-JS",
               "AU_4U", "rep-entropy", "BADGE")
COMMITTEE = ("ensemble", "QBC-JS")
OVERRIDES_NEW = (OVERRIDES.replace("B=128", "B=200")
                 + ",MC_iters=10,n_ensemble=5")
N_ENSEMBLE = 5
MC_ITERS = 10
# the bf16 campaign: sweeps and finetunes in bf16, bf16 anchors (int8 for
# fi) every 2 rounds, written from the checkpoint thread
BF16 = (",dtype=bfloat16,train_dtype=bfloat16,ckpt_full_every=2,"
        "async_checkpoint=true")
BF16_RUNS = (("entropy", OVERRIDES + BF16 + ",ckpt_dtype=bfloat16"),
             ("core-set", OVERRIDES + BF16 + ",ckpt_dtype=bfloat16"),
             ("fi", OVERRIDES_FI + BF16 + ",ckpt_dtype=int8"),
             ("BALD", OVERRIDES_NEW + BF16 + ",ckpt_dtype=bfloat16"),
             ("QBC-JS", OVERRIDES_NEW + BF16 + ",ckpt_dtype=bfloat16"))
F32_RUNS = (tuple((m, OVERRIDES_FI if m == "fi" else OVERRIDES)
                  for m in METHODS)
            + tuple((m, OVERRIDES_NEW) for m in NEW_METHODS)
            + (("AU_4U@rotation", OVERRIDES_NEW + ",rotation_angle=0.3"),))
# the training levers: the mean teacher (mirrored to TensorBoard), LwF,
# the aleatoric head and train_layers, 2 rounds each
TB_DIR = os.path.join(ROOT, "_smoke_expr", "tb")
MT = (",consistency_coeff=1.0,consistency_measure=CE,consistency_ramp=20,"
      "ema_decay=0.99,unlabeled_batch=128")
FC_LAYERS = ["fc1", "fc2", "fc3"]
LEVER_RUNS = (("entropy@mt", OVERRIDES + MT + f",tb_logdir={TB_DIR}"),
              ("entropy@lwf", OVERRIDES + ",lwf_lambda=1.0,lwf_T=2"),
              ("entropy@aleatoric", OVERRIDES + ",aleatoric=true,mc_t=10"),
              ("random@train_layers",
               OVERRIDES + ",train_layers=[fc1,fc2,fc3]"))
F32_RUNS += LEVER_RUNS
BF16_RUNS += (("entropy@mt", OVERRIDES + BF16 + ",ckpt_dtype=bfloat16" + MT),)
# the last three strategies: influence (cg, and arnoldi at rank 8) on B
# 200 candidates, ps-random, and SuPix on 64 SLIC segments a slice, which
# queries whole superpixels (~64 pool voxels each): a budget that 2 rounds
# cannot reach, and iter_k stops it after 2
INFLUENCE = OVERRIDES.replace("B=128", "B=200")
REST_RUNS = (("influence", INFLUENCE),
             ("influence@arnoldi",
              INFLUENCE + ",influence_mode=arnoldi,arnoldi_rank=8"),
             ("ps-random", OVERRIDES),
             ("SuPix", OVERRIDES + ",iter_k=[64,64,0]"))
SUPIX_BUDGET = 65536
F32_RUNS += REST_RUNS
# f32 runs whose second round runs no code their first does not: one
# round each, to keep the whole script near half its time limit (the
# committees, core-set, fi, SuPix, the mean teacher and influence (cg)
# keep two: their second round takes another branch)
ONE_ROUND = {"random", "MC-entropy", "BALD", "BatchBALD", "AU_4U",
             "AU_4U@rotation", "rep-entropy", "BADGE", "entropy@lwf",
             "entropy@aleatoric", "random@train_layers", "ps-random",
             "influence@arnoldi", "ensemble", "QBC-JS", "entropy@mt",
             "influence"}
BF16_RUNS += (("influence", INFLUENCE + BF16 + ",ckpt_dtype=bfloat16"),)
INFLUENCE_SUBS = {"influence/labeled_gather", "influence/s_test",
                  "influence/posteriors", "influence/filter",
                  "influence/cand_scores"}
# resume == continue: 4 rounds of random, int8 anchors every 3 rounds;
# again with the mean teacher
RESUME_OVERRIDES = OVERRIDES + ",ckpt_full_every=3,ckpt_dtype=int8"
# the multi-subject engine: three 128x128x32 training subjects (pools of
# 65,536 grid voxels each), a test and a held subject, an empty start
# (influence: 64 labels seeded), k 64, B 200, 128 queries a run
MULTI = ("patch_shape=[25,25,1],grid_spacing=2,k=64,B=200,b=128,epochs=1,"
         "learning_rate=1e-3,optimizer_name=Adam,ntb=4096,seed=0")
MULTI_RUNS = (("entropy", MULTI), ("core-set", MULTI), ("fi", MULTI),
              ("QBC-JS", MULTI + ",n_ensemble=3"), ("influence", MULTI),
              ("entropy@mt", MULTI + MT))
# f32 multi runs whose second round runs no code their first does not
MULTI_ONE_ROUND = {"QBC-JS", "influence"}
MULTI_BF16 = (",dtype=bfloat16,train_dtype=bfloat16,ckpt_full_every=2,"
              "ckpt_dtype=int8,async_checkpoint=true,hist_every=2,"
              "hist_dtype=float16")
MULTI_BF16_RUNS = (("entropy", MULTI + MULTI_BF16),
                   ("fi", MULTI + MULTI_BF16))
MULTI_RESUME = MULTI + ",ckpt_full_every=3,ckpt_dtype=int8,hist_every=0"
MULTI_SUBS = {"fi": FI_SUBS, "influence": INFLUENCE_SUBS}
# query_multimg card vs host: three 64x64x16 subjects at grid spacing 4
PICKS_SHAPE = (64, 64, 16)
STRATEGIES = ("random", "ps-random", "entropy", "MC-entropy", "BALD",
              "BatchBALD", "ensemble", "QBC-JS", "rep-entropy", "BADGE",
              "core-set", "fi", "AU_4U", "SuPix", "influence")
HELD_PICKS = ("entropy", "core-set", "rep-entropy", "BALD", "BatchBALD",
              "BADGE")
TOP_B = 1024
# the dense-model path: FC-DenseNet-103 at its published width and depth
# (growth 16, dense blocks 4-5-7-10-12, 15 in the bottleneck, dropout 0.2)
# on the campaign subject's whole 128x128 slices, PW1's grid and budget
DENSE = ("model_name=Tiramisu,dropout_rate=0.2,patch_shape=[25,25,1],"
         "grid_spacing=2,k=64,B=200,b=4,epochs=1,init_size=256,"
         "learning_rate=1e-3,optimizer_name=Adam,ntb=4096,"
         "synthetic_shape=[128,128,32],seed=0")
DENSE_RUNS = (("entropy", DENSE), ("core-set", DENSE),
              ("fi", DENSE + ",iter_k=[64,64,0]"),
              ("BALD", DENSE + ",MC_iters=10"), ("BADGE", DENSE),
              ("QBC-JS", DENSE + ",n_ensemble=3"), ("entropy@mt", DENSE + MT))
# dense runs whose second round runs no code their first does not
DENSE_ONE_ROUND = {"BALD", "BADGE", "QBC-JS"}
DENSE_BF16_RUNS = (("entropy", DENSE + ",dtype=bfloat16,train_dtype=bfloat16"),
                   ("fi", DENSE + ",iter_k=[64,64,0],dtype=bfloat16,"
                    "train_dtype=bfloat16"))
DENSE_RESUME = DENSE + ",ckpt_full_every=2,ckpt_dtype=int8"
DENSE_MULTI = MULTI + ",model_name=Tiramisu,dropout_rate=0.2,b=4"
# (name, overrides, queries): fi's picks shrink round over round (59,
# 31, 22, 10, 5, 1 on an H100 80GB HBM3), so it runs on 64 queries
DENSE_MULTI_RUNS = (("entropy", DENSE_MULTI, 128), ("fi", DENSE_MULTI, 64))
DENSE_GFLOP = 13.0          # per 128x128x2 slice, convs and convTs
SWEEP_SHAPE = (256, 256, 64)        # bench.py's subject
# the classification campaign (phase_cls): AlexNet at 227x227x3 on 4,096
# synthetic 8-class images, run_querying.DEFAULT_CLS_PARS as they are
CLS_N, CLS_HW, CLS_NCLASS, CLS_K = 4096, 227, 8, 10
CLS_MT = ("consistency_coeff=1.0,consistency_measure=CE,consistency_ramp=20,"
          "ema_decay=0.99")
CLS_RUNS = (tuple((m, "") for m in cls_mod.METHODS)
            + (("entropy@mt", CLS_MT), ("entropy@lwf", "lwf_lambda=1.0,lwf_T=2"),
               ("random@bf16", "train_dtype=bfloat16")))
CLS_ONE_ROUND = {"random", "MC-entropy", "BALD", "BatchBALD", "rep-entropy",
                 "BADGE", "entropy@lwf", "random@bf16"}
CLS_VGG_N, CLS_VGG_HW = 512, 224
SWEEP_Z_CHUNK = 4


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, reps: int, warmup: int = 2, queued: bool = False) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events.
    ``queued`` first parks the stream behind a ~10 ms sleep kernel, so the
    host has enqueued every call before the card starts them: the events
    then time the device alone, whatever each call costs the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def card_state() -> str:
    """SM clock, power draw and temperature, read once."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_F32_FLOPS):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sass_counts(kernel, opcodes=("HGMMA", "UTMALDG", "SYNCS")) -> dict:
    """Count SASS instructions in a built kernel library (``cuobjdump``),
    the evidence that the tensor cores and TMA are in the binary."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        return {}
    sass = subprocess.run([exe, "-sass", str(kernel.lib_path())],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in opcodes}


def k1_adversarial(dev, d=4096, m=512, n=4096):
    """Full-width rows that stress the split: equal entries 1/sqrt(d),
    entries straddling a TF32 rounding boundary, magnitudes 1e-3 and 1
    mixed in one row, and pool rows repeated in R (max exactly 1)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    q = n // 4

    def rand(*shape):
        return torch.rand(*shape, device=dev, generator=gen)

    def signs(*shape):
        return torch.where(rand(*shape) < 0.5, -1.0, 1.0)

    equal = torch.full((q, d), d ** -0.5, device=dev)
    k = torch.randint(0, 4, (q, d), device=dev, generator=gen).double()
    delta = torch.randint(-1, 2, (q, d), device=dev,
                          generator=gen).double() * 2.0 ** -23
    boundary = (signs(q, d).double() * 2.0 ** -6
                * (1 + k * 2.0 ** -10 + 2.0 ** -11 + delta)).float()
    mixed = normalize_rows(torch.where(rand(q, d) < 0.5, 1e-3, 1.0)
                           * signs(q, d))
    plain = normalize_rows(torch.randn(n - 3 * q, d, device=dev,
                                       generator=gen))
    P = torch.cat([equal, boundary, mixed, plain]).contiguous()
    R = torch.cat([P[::n // (m // 2)][: m // 2],
                   normalize_rows(torch.randn(m - m // 2, d, device=dev,
                                              generator=gen))]).contiguous()
    return P, R


def phase_k1(dev, n=65536, d=4096):
    gen = torch.Generator(device=dev).manual_seed(0)
    P = normalize_rows(torch.randn(n, d, device=dev, generator=gen))
    R = normalize_rows(torch.randn(512, d, device=dev, generator=gen))
    base = ops.similarity.KERNEL.launches
    errs = {}

    def held(name, Pc, Rc, tol=1e-5):
        got = rowmax_similarity(Pc, Rc)
        torch.cuda.synchronize()
        err = float((got - rowmax_similarity_plain(Pc, Rc)).abs().max())
        check(bool(torch.isfinite(got).all()) and err <= tol,
              f"K1 {name}: max |delta| {err} > {tol}")
        errs[name] = err
        return got

    # the main path: core-set round 0 (256 labeled rows) and round 1 (320
    # rows repeat-padded to 512), and the ragged 320 itself
    for m in (256, 512, 320):
        held(f"R{m}", P, R[:m].contiguous())
    # d a multiple of 4 but not of the 32-wide k tile: TMA zero-fills
    held("d132", P[:1000, :132].contiguous(), R[:, :132].contiguous())
    # adversarial rows: the f32 plain version (cuBLAS) itself strays from
    # the float64 truth there, so the kernel is held to the truth and both
    # deviations are reported
    Pa, Ra = k1_adversarial(dev)
    got_a = rowmax_similarity(Pa, Ra).double()
    plain_a = rowmax_similarity_plain(Pa, Ra).double()
    truth = (Pa.double() @ Ra.double().T).amax(1)
    errs["adversarial_vs_f64"] = float((got_a - truth).abs().max())
    errs["adversarial_plain_vs_f64"] = float((plain_a - truth).abs().max())
    errs["adversarial_vs_plain"] = float((got_a - plain_a).abs().max())
    check(bool(torch.isfinite(got_a).all())
          and errs["adversarial_vs_f64"] <= 1e-5,
          f"K1 adversarial vs f64 {errs['adversarial_vs_f64']} > 1e-5")
    check(bool((got_a[: len(Pa) // 4] == 1.0).all()),
          "K1 equal-entry rows repeated in R do not give exactly 1")
    # padded / ragged R rows must never win the max
    Pp = torch.zeros(600, 64, device=dev)
    Pp[:, 0] = 1.0
    Rp = torch.zeros(5, 64, device=dev)
    Rp[:, 0] = -1.0
    check(bool((rowmax_similarity(Pp, Rp) == -1.0).all()),
          "K1 padding leaked into the max")
    # zero rows (normalized with the clamp) give exactly 0
    Pz = P[:300].clone()
    Pz[::7] = 0.0
    check(bool((rowmax_similarity(Pz, R)[::7] == 0.0).all()),
          "K1 zero rows are not 0")
    # d not a multiple of 4, and P rows not 16-byte aligned, take the f32
    # FMA path
    held("ragged_d", P[:1000, :130].contiguous(), R[:, :130].contiguous())
    buf = torch.empty(1000 * 64 + 1, device=dev)
    Pu = buf[1:].view(1000, 64)
    Pu.copy_(P[:1000, :64])
    held("unaligned", Pu, R[:, :64].contiguous())
    # an unaligned R is only read by the split: the tensor-core path
    Ru = torch.empty(512 * 64 + 1, device=dev)[1:].view(512, 64)
    Ru.copy_(R[:, :64])
    held("unaligned_R", P[:1000, :64].contiguous(), Ru)
    torch.cuda.synchronize()
    times = {}
    for m in (512, 256):
        Rm = R[:m].contiguous()
        times[m] = (time_ms(lambda: rowmax_similarity(P, Rm), reps=10),
                    time_ms(lambda: rowmax_similarity_plain(P, Rm), reps=5),
                    time_ms(lambda: torch.matmul(P, Rm.T).amax(dim=1),
                            reps=10))
    # three more blocks of the kernel alone, with the card's clocks read
    # right after: the spread inside one run, beside its SM clock
    blocks = [time_ms(lambda: rowmax_similarity(P, R), reps=10)
              for _ in range(3)]
    clocks = card_state()
    ops.similarity.KERNEL.launches = base
    m = 512
    k_ms, p_ms, lib_ms = times[m]
    flops, nbytes = 2.0 * n * m * d, (n * d + m * d + n) * 4
    simt_ms, _ = bound(flops, nbytes)
    tc_ms, tc_by = bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
    print(f"K1 ok: max|delta| vs plain {errs}; at R 512 kernel "
          f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, matmul+amax {lib_ms:.4f} "
          f"ms, bound {tc_ms:.4f} ms (3xTF32 on tensor cores, {tc_by}), "
          f"f32 SIMT bound {simt_ms:.4f} ms; at R 256 kernel "
          f"{times[256][0]:.4f} ms, plain {times[256][1]:.4f} ms, "
          f"matmul+amax {times[256][2]:.4f} ms; R 512 again {blocks} ms, "
          f"then {clocks}")
    return {"name": "rowmax_similarity", "route": "cuda",
            "source": "nnal_tpu_torch/csrc/rowmax_similarity.cu",
            "replaces": ops.similarity.REPLACES,
            "max_abs_err": max(v for k, v in errs.items()
                               if not k.startswith("adversarial")),
            "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": tc_ms, "bound_by": tc_by, "library_ms": lib_ms,
            "bound_f32_simt_ms": simt_ms, "errors": errs,
            "ms_blocks": blocks, "card_after": clocks,
            "at_R256": {"ms": times[256][0], "plain_ms": times[256][1],
                        "library_ms": times[256][2],
                        "bound_ms": tc_ms / 2},
            "shapes": {"P": [n, d], "R": [m, d]}}


def k2_bound(padded, inds, ps):
    """Bytes this run's data needs: every output once, the indices and
    stats once, and each distinct volume element the windows touch once;
    one subtract and one divide per output element."""
    dev = padded.device
    m, D1p, D2p, D3p = padded.shape
    d1, d2, d3 = ps
    touched = torch.zeros(padded.numel(), dtype=torch.bool, device=dev)
    z = inds % SHAPE[2]
    y = (inds // SHAPE[2]) % SHAPE[1]
    x = inds // (SHAPE[2] * SHAPE[1])
    a = torch.arange(d1, device=dev)[:, None]
    c = torch.arange(d2, device=dev)[None, :]
    for j in range(m):
        flat = (((j * D1p + x[:, None, None] + a) * D2p
                 + y[:, None, None] + c) * D3p + z[:, None, None])
        touched[flat.reshape(-1)] = True
    n_out = len(inds) * d1 * d2 * m * d3
    nbytes = n_out * 4 + len(inds) * 8 + 4 * m * 2 + int(touched.sum()) * 4
    return bound(2.0 * n_out, nbytes)


def k2_profile(padded, inds, mu, sd, ps, reps=50):
    """Device time per call from a ``torch.profiler`` window over ``reps``
    calls (None if the profiler sees no device time), and the host's cost
    per call, by a host clock around 200 calls with no synchronization
    inside (the card, at a few us per launch, never holds the host back),
    split into the wrapper's parts."""
    from torch.profiler import ProfilerActivity, profile

    def call():
        return gather_patches_normalized(padded, inds, mu, sd, ps, SHAPE)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    dev_us = None
    for ev in prof.key_averages():
        if "gather_patches_kernel" in ev.key:
            total = getattr(ev, "device_time_total", None)
            if total is None:
                total = getattr(ev, "cuda_time_total", 0.0)
            dev_us = total / max(ev.count, 1) if total else None

    def host_us(fn, n=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        dt = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return dt

    out = torch.empty((len(inds),) + tuple(ps[:2]) + (2 * ps[2],),
                      device=padded.device)
    yvol = ops.gather.y_contiguous(padded)
    args = (yvol.data_ptr(), inds.data_ptr(), mu.data_ptr(), sd.data_ptr(),
            out.data_ptr(), len(inds),
            ctypes.byref(ops.gather._params(yvol, ps, SHAPE)),
            stream_ptr(padded))
    launch = ops.gather.KERNEL._bind()
    host = {"call": host_us(call),
            "torch_empty": host_us(lambda: torch.empty(
                out.shape, dtype=torch.float32, device=padded.device)),
            "stream_lookup": host_us(lambda: stream_ptr(padded)),
            "current_stream": host_us(
                lambda: torch.cuda.current_stream(padded.device).cuda_stream),
            "ctypes_launch": host_us(lambda: launch(*args))}
    return host, dev_us


def phase_k2(dev, n=4096):
    vols, _ = synthetic_subject(shape=SHAPE, n_modalities=2, seed=0)
    rng = np.random.default_rng(0)
    inds = torch.as_tensor(rng.integers(0, int(np.prod(SHAPE)), size=n)
                           ).to(dev)
    mu = torch.tensor([60.0, 75.0], device=dev)
    sd = torch.tensor([30.0, 31.0], device=dev)
    base = ops.gather.KERNEL.launches
    timed = None
    for ps in ((25, 25, 1), (25, 25, 3), (24, 24, 1)):
        padded = pad_volumes(vols, ps, dev)
        got = gather_patches_normalized(padded, inds, mu, sd, ps, SHAPE)
        want = gather_patches_plain(padded, inds, mu, sd, ps, SHAPE)
        torch.cuda.synchronize()
        check(got.shape == want.shape and torch.equal(got, want),
              f"K2 differs from its plain version at patch {ps}")
        if ps == (25, 25, 1):
            timed = (padded, ps)
    # a 64-wide window of 4 channels (2 modalities x d3 2) on a wider
    # volume: two 32-lane column passes per window row
    wide_shape, wide_ps = (160, 192, 16), (64, 64, 2)
    wvols, _ = synthetic_subject(shape=wide_shape, n_modalities=2, seed=2)
    wpad = pad_volumes(wvols, wide_ps, dev)
    winds = torch.as_tensor(rng.integers(0, int(np.prod(wide_shape)),
                                         size=512)).to(dev)
    check(torch.equal(
        gather_patches_normalized(wpad, winds, mu, sd, wide_ps, wide_shape),
        gather_patches_plain(wpad, winds, mu, sd, wide_ps, wide_shape)),
        f"K2 differs from its plain version at patch {wide_ps}")
    del wpad
    # an odd channel count (3 modalities, d3 1) takes the one-channel path
    ovols, _ = synthetic_subject(shape=SHAPE, n_modalities=3, seed=4)
    opad = pad_volumes(ovols, (25, 25, 1), dev)
    mu3 = torch.tensor([60.0, 75.0, 50.0], device=dev)
    sd3 = torch.tensor([30.0, 31.0, 29.0], device=dev)
    check(torch.equal(
        gather_patches_normalized(opad, inds, mu3, sd3, (25, 25, 1), SHAPE),
        gather_patches_plain(opad, inds, mu3, sd3, (25, 25, 1), SHAPE)),
        "K2 differs from its plain version with 3 modalities")
    del opad
    padded, ps = timed
    # the y-contiguous copy is made once per volume
    yv = ops.gather.y_contiguous(padded)
    gather_patches_normalized(padded, inds, mu, sd, ps, SHAPE)
    check(ops.gather.y_contiguous(padded) is yv,
          "K2's y-contiguous copy was rebuilt for the same volume")
    k_ms = time_ms(lambda: gather_patches_normalized(
        padded, inds, mu, sd, ps, SHAPE), reps=50, queued=True)
    p_ms = time_ms(lambda: gather_patches_plain(
        padded, inds, mu, sd, ps, SHAPE), reps=50)
    # the campaign's own gather: round 1's 384 labeled patches
    small = inds[:384]
    check(torch.equal(
        gather_patches_normalized(padded, small, mu, sd, ps, SHAPE),
        gather_patches_plain(padded, small, mu, sd, ps, SHAPE)),
        "K2 differs from its plain version at 384 patches")
    k384_ms = time_ms(lambda: gather_patches_normalized(
        padded, small, mu, sd, ps, SHAPE), reps=50, queued=True)
    loop384_ms = time_ms(lambda: gather_patches_normalized(
        padded, small, mu, sd, ps, SHAPE), reps=50)
    p384_ms = time_ms(lambda: gather_patches_plain(
        padded, small, mu, sd, ps, SHAPE), reps=50)
    host, prof_us = k2_profile(padded, small, mu, sd, ps)
    # fi's candidate gather: B = 200 uncertainty-filtered voxels
    cand = inds[-200:].contiguous()
    check(torch.equal(
        gather_patches_normalized(padded, cand, mu, sd, ps, SHAPE),
        gather_patches_plain(padded, cand, mu, sd, ps, SHAPE)),
        "K2 differs from its plain version at 200 patches")
    at200 = {
        "ms": time_ms(lambda: gather_patches_normalized(
            padded, cand, mu, sd, ps, SHAPE), reps=50, queued=True),
        "loop_ms": time_ms(lambda: gather_patches_normalized(
            padded, cand, mu, sd, ps, SHAPE), reps=50),
        "plain_ms": time_ms(lambda: gather_patches_plain(
            padded, cand, mu, sd, ps, SHAPE), reps=50),
        "bound_ms": k2_bound(padded, cand, ps)[0]}
    at200["host_us"], at200["profiler_device_us"] = k2_profile(
        padded, cand, mu, sd, ps)
    ops.gather.KERNEL.launches = base
    b_ms, b_by = k2_bound(padded, inds, ps)
    b384_ms, _ = k2_bound(padded, small, ps)
    print(f"K2 ok: bit-equal at (25,25,1) (25,25,3) (24,24,1) {wide_ps} "
          "and with 3 modalities; "
          f"device {k_ms:.5f} ms, plain {p_ms:.4f} ms, bound {b_ms:.5f} ms "
          f"({b_by}); at 384 patches device {k384_ms:.5f} ms (profiler "
          f"{prof_us} us), back-to-back loop {loop384_ms:.5f} ms, host "
          f"us per call {host}, plain {p384_ms:.4f} ms, bound "
          f"{b384_ms:.5f} ms; at fi's 200 candidates bit-equal, {at200}")
    return {"name": "gather_patches_normalized", "route": "cuda",
            "source": "nnal_tpu_torch/csrc/gather_patches.cu",
            "replaces": ops.gather.REPLACES, "max_abs_err": 0.0,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "shapes": {"padded": list(padded.shape), "inds": [n],
                       "patch": list(ps)},
            "at_384": {"ms": k384_ms, "profiler_device_us": prof_us,
                       "loop_ms": loop384_ms, "host_us": host,
                       "plain_ms": p384_ms, "bound_ms": b384_ms},
            "at_200": at200}


def phase_forward(dev, n=1024):
    spec = create_pw1(2, 0.5, (25, 25, 2))
    model_c = init_cnn(spec, seed=0, device="cpu")
    model_g = init_cnn(spec, seed=0, device=dev)
    vols, _ = synthetic_subject(shape=SHAPE, n_modalities=2, seed=1)
    padded = pad_volumes(vols, (25, 25, 1), dev)
    inds = torch.as_tensor(np.random.default_rng(1).integers(
        0, int(np.prod(SHAPE)), size=n)).to(dev)
    x = gather_patches_normalized(padded, inds,
                                  torch.tensor([60.0, 75.0], device=dev),
                                  torch.tensor([30.0, 31.0], device=dev),
                                  (25, 25, 1), SHAPE)
    with torch.no_grad():
        p_g = model_g(x).posteriors.cpu()
        p_c = model_c(x.cpu()).posteriors
    err = float((p_g - p_c).abs().max())
    check(bool(torch.isfinite(p_g).all()) and err <= 1e-4,
          f"PW1 posteriors card vs host max |delta| {err} > 1e-4")
    # off-grid voxels take the evaluator's per-patch gather route (K2 on
    # the card): the same route on the host must agree
    rng = np.random.default_rng(2)
    off = np.ravel_multi_index(
        (2 * rng.integers(0, SHAPE[0] // 2, 256) + 1,
         rng.integers(0, SHAPE[1], 256), rng.integers(0, SHAPE[2], 256)),
        SHAPE)
    stats = (np.array([60.0, 75.0]), np.array([30.0, 31.0]))
    evs = [GridPoolEvaluator(spec, pad_volumes(vols, (25, 25, 1), d),
                             *stats, (25, 25, 1), SHAPE, grid_spacing=2)
           for d in (dev, "cpu")]
    p_off = [ev.evaluate(m, off)["posteriors"]
             for ev, m in zip(evs, (model_g, model_c))]
    err_off = float(np.abs(p_off[0] - p_off[1]).max())
    check(err_off <= 1e-4, f"off-grid evaluate card vs host {err_off}")
    print(f"PW1 forward ok: {n} patches 25x25x2, card vs host "
          f"max|delta| {err:.3g}; off-grid evaluator {err_off:.3g}")


def _patches(dev, n, seed=1):
    vols, _ = synthetic_subject(shape=SHAPE, n_modalities=2, seed=seed)
    padded = pad_volumes(vols, (25, 25, 1), dev)
    inds = torch.as_tensor(np.random.default_rng(seed).integers(
        0, int(np.prod(SHAPE)), size=n)).to(dev)
    return gather_patches_normalized(padded, inds,
                                     torch.tensor([60.0, 75.0], device=dev),
                                     torch.tensor([30.0, 31.0], device=dev),
                                     (25, 25, 1), SHAPE)


def phase_bf16_forward(dev, n=1024):
    """PW1 25x25x2 at bf16: card vs host (the host upcasts each conv and
    fc, one rounding; the card rounds each conv's sum before the bias),
    bf16 vs f32 on the card, and the card's f32-output fc GEMM with its
    hand-written backward against autograd on upcast operands."""
    spec = create_pw1(2, 0.5, (25, 25, 2))
    model_c = init_cnn(spec, seed=0, device="cpu")
    model_g = init_cnn(spec, seed=0, device=dev)
    x = _patches(dev, n)
    with torch.no_grad():
        p16 = model_g(x.bfloat16()).posteriors[:, 1].cpu()
        p32 = model_g(x).posteriors[:, 1].cpu()
        h16 = model_c(x.cpu().bfloat16()).posteriors[:, 1]
    err = float((p16 - h16).abs().max())
    err_mean = float((p16 - h16).abs().mean())
    err32 = float((p16 - p32).abs().max())
    top = [set(torch.argsort((p - 0.5).abs(), stable=True)[:64].tolist())
           for p in (p16, h16, p32)]
    # the GEMM route of the fcs (fc1's shapes) and its backward
    gen = torch.Generator(device=dev).manual_seed(6)
    h = torch.randn(256, 1536, device=dev, generator=gen).bfloat16()
    W = (torch.randn(4096, 1536, device=dev, generator=gen)
         * 0.03).bfloat16()
    g = torch.randn(256, 4096, device=dev, generator=gen).bfloat16().float()
    hs, Ws = h.clone().requires_grad_(), W.clone().requires_grad_()
    y = linear_f32acc(hs, Ws)
    y.backward(g)
    hu, Wu = h.float().requires_grad_(), W.float().requires_grad_()
    yu = hu @ Wu.t()
    yu.backward(g)
    y, yu = y.detach(), yu.detach()
    mm = {"out_rel": float((y - yu).abs().max() / yu.abs().max()),
          "dh_rel": float((hs.grad.float() - hu.grad).abs().max()
                          / hu.grad.abs().max()),
          "dW_rel": float((Ws.grad.float() - Wu.grad).abs().max()
                          / Wu.grad.abs().max()),
          "dtypes": [str(y.dtype), str(hs.grad.dtype), str(Ws.grad.dtype)]}
    res = {"p1_card_vs_host_max": err, "p1_card_vs_host_mean": err_mean,
           "p1_bf16_vs_f32_card_max": err32,
           "top64_overlap_card_host": len(top[0] & top[1]),
           "top64_overlap_bf16_f32": len(top[0] & top[2]),
           "fc_gemm_f32acc": mm}
    check(bool(torch.isfinite(p16).all()) and err <= 2e-2
          and err_mean <= 2e-3, f"bf16 forward card vs host: {res}")
    # f32 accumulation: the output within f32 summation order; each
    # gradient is one bf16 GEMM, so within one bf16 rounding (2^-8)
    check(mm["out_rel"] <= 1e-5 and mm["dh_rel"] <= 2 ** -8
          and mm["dW_rel"] <= 2 ** -8 and mm["dtypes"] == [
              "torch.float32", "torch.bfloat16", "torch.bfloat16"],
          f"f32-output bf16 GEMM vs upcast autograd: {mm}")
    print(f"bf16 forward ok: {json.dumps(res)}")
    return res


class HostDraws:
    """Replace the port's draw functions with numpy draws keyed on what
    the port passes them (the dropout layer, the fold tag, the shape), on
    whichever device is asked: the card and the host then use the same
    dropout uniforms, noise and samples, and their results can be held
    to each other."""

    def __init__(self, seed: int):
        self.seed = seed

    def _rng(self, *tag):
        return np.random.default_rng((self.seed,) + tuple(int(t) for t in tag))

    def __enter__(self):
        self.saved = [(cnn_mod, "_dropout_uniform"),
                      (perturb_mod, "_gaussian_noise"),
                      (bb_mod, "_t_assign"), (bb_mod, "_uniform"),
                      (core_rng, "gumbel"), (rep_mod, "_first_index"),
                      (hessian_mod, "_lanczos_start")]
        self.saved = [(m, n, getattr(m, n)) for m, n in self.saved]

        def t(a, device, dtype=None):
            return torch.from_numpy(np.asarray(a)).to(device, dtype)

        def gumbel(shape, gen, device, tag):
            u = np.maximum(self._rng(3, tag).random(tuple(shape),
                                                    np.float32),
                           np.finfo(np.float32).tiny)
            return t(-np.log(-np.log(u)), device)

        cnn_mod._dropout_uniform = lambda shape, gen, device, i: t(
            self._rng(0, i, *shape).random(tuple(shape), np.float32), device)
        perturb_mod._gaussian_noise = lambda shape, dtype, gen, device: t(
            self._rng(1, *shape).standard_normal(tuple(shape), np.float32),
            device, dtype)
        bb_mod._t_assign = lambda M, T, gen, device, tag=0: t(
            self._rng(2, tag).integers(0, T, M), device)
        bb_mod._uniform = lambda M, gen, device, tag: t(
            self._rng(2, tag).random(M, np.float32), device)
        core_rng.gumbel = gumbel
        rep_mod._first_index = lambda n, gen, device: t(
            self._rng(4).integers(0, n), device)
        hessian_mod._lanczos_start = lambda params, key, device: t(
            self._rng(5, key).standard_normal(
                sum(v.numel() for v in params.values()), np.float32), device)
        return self

    def __exit__(self, *exc):
        for m, n, f in reversed(self.saved):
            setattr(m, n, f)


class _Key:
    """Stands in for a ``torch.Generator``: carries the key it was made
    from."""

    def __init__(self, key):
        self.key = key


class KeyedDraws(HostDraws):
    """:class:`HostDraws` for the finetune: ``core_rng.key_generator``
    hands out its key, and the dropout uniforms and the aleatoric normals
    are numpy draws keyed on it, so the labeled pass, the student's
    unlabeled pass and the aleatoric noise each draw their own values,
    the same on the card and the host."""

    def __enter__(self):
        super().__enter__()
        self.saved += [(m, n, getattr(m, n)) for m, n in (
            (core_rng, "key_generator"), (core_rng, "key_stream"),
            (cnn_mod, "_dropout_uniform"),
            (losses_mod, "_aleatoric_normal"))]
        fold = core_rng.fold_key

        def t(a, device):
            return torch.from_numpy(np.asarray(a)).to(device)

        core_rng.key_generator = lambda key, tag, device: _Key(
            fold(key, tag))
        core_rng.key_stream = lambda key, device: _Key(key)
        cnn_mod._dropout_uniform = lambda shape, gen, device, i: t(
            self._rng(5, gen.key, i).random(tuple(shape), np.float32),
            device)
        losses_mod._aleatoric_normal = lambda shape, gen, device: t(
            self._rng(6, gen.key).standard_normal(tuple(shape), np.float32),
            device)
        return self


def phase_mc_forward(dev, n=1024):
    """MC dropout (fc1, fc2 and the logits layer) on 1024 PW1 25x25x2
    patches, the same uniforms fed to card and host: posteriors within
    1e-4; and at rate 0, ``mc_dropout`` is the deterministic forward bit
    for bit on the card."""
    spec = create_pw1(2, 0.5, (25, 25, 2))
    model_c = init_cnn(spec, seed=0, device="cpu")
    model_g = init_cnn(spec, seed=0, device=dev)
    x = _patches(dev, n)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad(), HostDraws(11):
        p_g = model_g(x, mc_dropout=True, generator=gen).posteriors.cpu()
        p_c = model_c(x.cpu(), mc_dropout=True,
                      generator=torch.Generator()).posteriors
        det = model_g(x).posteriors.cpu()
    err = float((p_g - p_c).abs().max())
    moved = float((p_g - det).abs().max())
    check(bool(torch.isfinite(p_g).all()) and err <= 1e-4 and moved > 1e-3,
          f"MC forward card vs host max |delta| {err} (> 1e-4?), "
          f"MC vs deterministic {moved}")
    spec0 = create_pw1(2, 0.0, (25, 25, 2))
    m0 = init_cnn(spec0, seed=0, device=dev)
    with torch.no_grad():
        same = torch.equal(m0(x, mc_dropout=True, generator=gen).posteriors,
                           m0(x).posteriors)
    check(same, "mc_dropout at rate 0 is not the deterministic forward")
    res = {"patches": n, "p_card_vs_host_max": err,
           "mc_vs_deterministic_max": moved, "rate0_bit_equal": same}
    print(f"MC forward ok: {json.dumps(res)}")
    return res


def _lever_model(case, device):
    """PW1 25x25x2 from seed 0 on ``device``; for the aleatoric case with
    the head added by ``surgery`` (log-sigma columns zero: sigma 1)."""
    spec = create_pw1(2, 0.5, (25, 25, 2))
    model = init_cnn(spec, seed=0, device="cpu")
    if case.get("aleatoric"):
        params = extend_params_to_aleatoric(
            to_jax_params(model.state_dict()), "fc3")
        model = CNN(with_aleatoric_head(spec))
        model.load_state_dict(from_jax_params(params))
    return model.to(device)


LEVER_CASES = {"mt-CE": {"mt": "CE"}, "mt-MSE": {"mt": "MSE"},
               "lwf": {"lwf": True}, "aleatoric": {"aleatoric": True},
               "train_layers": {"train_layers": True}}


def _lever_state(case, device, x, xu, old, opt="SGD"):
    """A train state for ``case`` on ``device`` and the step's levers: the
    teacher is the model plus the same numpy noise on either device."""
    model = _lever_model(case, device)
    state = TrainState(model, make_optimizer(opt, 1e-3, model.parameters()))
    kw = {"mc_t": 10}
    if "mt" in case:
        state.teacher = make_teacher(model)
        noise = np.random.default_rng(4)
        with torch.no_grad():
            for p in state.teacher.parameters():
                p.add_(torch.from_numpy(noise.normal(
                    scale=0.02, size=tuple(p.shape)).astype(np.float32)
                ).to(device))
        kw["mt"] = MeanTeacher(
            xu_all=xu.to(device), u_idx=np.arange(xu.shape[0])[None],
            coeff=1.0, measure=case["mt"], ramp=20, ema_decay=0.99,
            step0=10)
    if case.get("lwf"):
        kw["lwf"] = LwF(old.to(device), 1.0, 2.0)
    if case.get("train_layers"):
        kw["grad_mask"] = layer_train_mask(model, FC_LAYERS)
    return state, kw


def phase_train_levers(dev, n=128, reps=5):
    """One finetune step of each training lever on PW1 25x25x2 from the
    same weights and the same 128-patch labeled and unlabeled batches,
    card vs host, with the same dropout uniforms and aleatoric normals
    fed to both (:class:`KeyedDraws`), plain SGD at lr 1e-3: the mean
    teacher (CE and MSE; loss within 1e-4, params and the EMA teacher
    within 1e-5), LwF and the aleatoric CE (loss within 1e-5, params
    within 1e-5), and ``train_layers`` [fc1, fc2, fc3] (conv weights
    bit-identical before and after).  Then the card's seconds per Adam
    step of each lever beside the plain step's, on a 384-patch labeled
    set (3 steps of 128) and, for the mean teacher, 256 unlabeled
    patches."""
    x = _patches(dev, n, seed=1)
    xu = _patches(dev, n, seed=2)
    y = torch.from_numpy(np.eye(2, dtype=np.float32)[
        np.random.default_rng(3).integers(0, 2, n)])
    with torch.no_grad():
        old = init_cnn(create_pw1(2, 0.5, (25, 25, 2)), seed=1,
                       device="cpu")(x.cpu()).logits
    idx, w = np.arange(n)[None], np.ones((1, n), np.float32)
    res = {}
    for name, case in LEVER_CASES.items():
        out = {}
        for side, d in (("card", dev), ("host", torch.device("cpu"))):
            state, kw = _lever_state(case, d, x, xu, old)
            before = {k: v.clone() for k, v in
                      state.model.state_dict().items()}
            with KeyedDraws(21), deterministic_cudnn():
                loss = finetune_steps(state, x.to(d), y.to(d), idx, w,
                                      torch.ones(2, device=d), 1234, **kw)
            after = state.model.state_dict()
            out[side] = {
                "loss": loss[0], "params": to_jax_params(after),
                "teacher": (None if state.teacher is None else
                            to_jax_params(state.teacher.state_dict())),
                "convs_unchanged": all(
                    torch.equal(after[k], before[k]) for k in after
                    if k.startswith("conv"))}
        g, h = out["card"], out["host"]

        def maxdiff(a, b):
            return max(float(np.abs(a[l][k] - b[l][k]).max())
                       for l in a for k in a[l])

        r = {"loss_card": g["loss"], "loss_host": h["loss"],
             "loss_err": abs(g["loss"] - h["loss"]),
             "params_err": maxdiff(g["params"], h["params"])}
        if g["teacher"] is not None:
            r["teacher_err"] = maxdiff(g["teacher"], h["teacher"])
        if case.get("train_layers"):
            r["convs_bit_identical"] = (g["convs_unchanged"]
                                        and h["convs_unchanged"])
            check(r["convs_bit_identical"], f"train_layers moved a conv: {r}")
        loss_tol = 1e-4 if "mt" in case else 1e-5
        check(np.isfinite(g["loss"]) and r["loss_err"] <= loss_tol
              and r["params_err"] <= 1e-5
              and r.get("teacher_err", 0.0) <= 1e-5,
              f"{name} step card vs host: {r}")
        res[name] = r
    # seconds per Adam step on the card, each lever beside the plain step
    xl = _patches(dev, 384, seed=4)
    yl = torch.from_numpy(np.eye(2, dtype=np.float32)[
        np.random.default_rng(5).integers(0, 2, 384)]).to(dev)
    xu2 = _patches(dev, 256, seed=6)
    idx_mat, w_mat = build_batch_index_matrix(384, 128, 1,
                                              np.random.default_rng(0))
    steps = int((w_mat.sum(1) > 0).sum())
    with torch.no_grad():
        old_l = init_cnn(create_pw1(2, 0.5, (25, 25, 2)), seed=1,
                         device=dev)(xl).logits
    timing = {}
    for name, case in {"plain": {}, **LEVER_CASES}.items():
        state, kw = _lever_state(case, dev, xl, xu2, old_l, opt="Adam")
        if "mt" in kw:
            kw["mt"].u_idx = np.random.default_rng(7).integers(
                0, 256, size=(idx_mat.shape[0], 128))
        times = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with deterministic_cudnn():
                finetune_steps(state, xl, yl, idx_mat, w_mat,
                               torch.ones(2, device=dev), 99, **kw)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        timing[name] = float(np.median(times[1:])) / steps
    res["seconds_per_step"] = timing
    res["steps_per_finetune"] = steps
    print(f"training levers ok: {json.dumps(res)}")
    return res


def phase_mc_sweep(dev):
    """On the campaign subject (grid 131,072 rows, z_chunk 4): slab rows
    == whole-sweep rows bit for bit for one key, on the card; then the
    MC sweep's rate, ``MC_ITERS`` passes over the whole grid, f32 and
    bf16."""
    ps = (25, 25, 1)
    spec = create_pw1(2, 0.5, (25, 25, 2))
    model = init_cnn(spec, seed=0, device=dev)
    vols, _ = synthetic_subject(shape=SHAPE, n_modalities=2, seed=0)
    padded = pad_volumes(vols, ps, dev)
    stats = (np.array([v.mean() for v in vols]),
             np.array([v.std() for v in vols]))
    ev = GridPoolEvaluator(spec, padded, *stats, ps, SHAPE, grid_spacing=2)
    g = np.arange(0, SHAPE[0], 2)
    X, Y, Z = np.meshgrid(g, g, np.arange(SHAPE[2]), indexing="ij")
    grid = np.ravel_multi_index((X.ravel(), Y.ravel(), Z.ravel()), SHAPE)
    nz = SHAPE[2]
    # rows of two z-chunks (the second and third quarter's last ones)
    two_slabs = grid[np.isin(grid % nz, [nz // 2 - 2, nz // 2 - 1,
                                         3 * nz // 4])]
    key = 20251017
    slab = ev.evaluate(model, two_slabs, ("posteriors",), mc_rng=key)
    whole = ev.evaluate(model, two_slabs, ("posteriors",), as_device=True,
                        mc_rng=key)["posteriors"].cpu().numpy()
    det = ev.evaluate(model, two_slabs, ("posteriors",))["posteriors"]
    check(np.array_equal(slab["posteriors"], whole)
          and np.abs(whole - det).max() > 1e-3,
          "MC slab rows differ from the whole sweep's (or dropout is off)")
    res = {"slab_rows": len(two_slabs), "slab_equals_whole": True,
           "grid_rows": len(grid), "mc_iters": MC_ITERS}
    for cd in (None, torch.bfloat16):
        ev.compute_dtype = cd
        mc_stack_posteriors(ev, model, grid[:1], 1, key, as_device=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mc = mc_stack_posteriors(ev, model, grid, MC_ITERS, key,
                                 as_device=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(mc.shape == (MC_ITERS, len(grid))
              and bool(torch.isfinite(mc).all()), "MC sweep output")
        name = "float32" if cd is None else "bfloat16"
        res[name] = {"seconds": secs,
                     "rows_per_s": MC_ITERS * len(grid) / secs,
                     "max_memory_allocated": torch.cuda.max_memory_allocated()}
        del mc
    print(f"MC sweep ok: {json.dumps(res)}")
    return res


def phase_perturb(dev, n=1024):
    """``rotate_2d`` card vs host at 0.3 rad and pi/2 (1e-5), AU_4U's CE
    and L2 card vs host with the same noise (1e-4), and the perturb
    sweep's rows/s over the campaign subject's grid, f32 and bf16."""
    spec = create_pw1(2, 0.5, (25, 25, 2))
    model_c = init_cnn(spec, seed=0, device="cpu")
    model_g = init_cnn(spec, seed=0, device=dev)
    x = _patches(dev, n, seed=2)
    res = {}
    for angle in (0.3, np.pi / 2):
        err = float((perturb_mod.rotate_2d(x, angle).cpu()
                     - perturb_mod.rotate_2d(x.cpu(), angle)).abs().max())
        res[f"rotate_{angle:.4f}_max"] = err
        check(err <= 1e-5, f"rotate_2d({angle}) card vs host {err}")
    with HostDraws(12):
        for measure, angle in (("CE", None), ("L2", None), ("CE", 0.3)):
            kw = dict(measure=measure, gaussian_std=0.05,
                      rotation_angle=angle)
            got = perturb_mod.measure_output_perturbation(
                model_g, x, None, **kw).cpu()
            want = perturb_mod.measure_output_perturbation(
                model_c, x.cpu(), None, **kw)
            err = float((got - want).abs().max())
            res[f"{measure}_rot{angle}_max"] = err
            check(bool(torch.isfinite(got).all()) and err <= 1e-4,
                  f"AU_4U {measure} (rotation {angle}) card vs host {err}")
    vols, _ = synthetic_subject(shape=SHAPE, n_modalities=2, seed=0)
    ev = GridPoolEvaluator(spec, pad_volumes(vols, (25, 25, 1), dev),
                           np.array([60.0, 75.0]), np.array([30.0, 31.0]),
                           (25, 25, 1), SHAPE, grid_spacing=2)
    rows = ev.nz * ev.nx * ev.ny
    for cd in (None, torch.bfloat16):
        ev.compute_dtype = cd
        ev.perturb_sweep(model_g, 1, as_device=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = ev.perturb_sweep(model_g, 2, as_device=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(d.shape == (rows,) and bool(torch.isfinite(d).all()),
              "perturb_sweep output")
        res["sweep_" + ("float32" if cd is None else "bfloat16")] = {
            "rows": rows, "seconds": secs, "rows_per_s": rows / secs}
    print(f"perturbation ok: {json.dumps(res)}")
    return res


def phase_batch_select(dev, k=64, B=200):
    """BatchBALD (T 10 x 200 candidates from a seeded stack), rep-entropy
    and BADGE (features and posteriors of 1024 PW1 patches from the card,
    200 uncertainty-filtered candidates), card vs host with the same
    draws: identical picks."""
    stack = np.random.default_rng(9).uniform(
        0.02, 0.98, size=(MC_ITERS, B)).astype(np.float32)
    spec = create_pw1(2, 0.5, (25, 25, 2))
    model = init_cnn(spec, seed=0, device=dev)
    with torch.no_grad():
        out = model(_patches(dev, 1024, seed=3))
    p1, F = out.posteriors[:, 1], out.feature
    sel = binary_uncertainty_filter(p1, B)
    rest = np.setdiff1d(np.arange(len(p1)), sel)
    sel_t = torch.as_tensor(sel).to(dev)
    picks, secs = {}, {}
    with HostDraws(13):
        for side, d in (("card", dev), ("host", torch.device("cpu"))):
            gen = torch.Generator(device=d)
            E = rep_mod.badge_embeddings(F[sel_t].to(d), p1[sel_t].to(d))
            runs = {
                "BatchBALD": lambda: bb_mod.batchbald_select(
                    torch.from_numpy(stack).to(d), k, gen),
                "rep-entropy": lambda: rep_mod.rep_entropy_from_features(
                    F.to(d), rest, sel, k),
                "BADGE": lambda: rep_mod.badge_kmeanspp(E, k, gen)}
            for name, fn in runs.items():
                t0 = time.perf_counter()
                picks[(name, side)] = fn()
                secs[(name, side)] = time.perf_counter() - t0
    res = {}
    for name in ("BatchBALD", "rep-entropy", "BADGE"):
        a, b = picks[(name, "card")], picks[(name, "host")]
        same = np.array_equal(a, b)
        first = None if same else int(np.nonzero(a != b)[0][0])
        res[name] = {"identical": same, "k": len(a),
                     "distinct": len(set(a.tolist())),
                     "first_difference": first,
                     "card_s": secs[(name, "card")],
                     "host_s": secs[(name, "host")]}
        check(same and len(set(a.tolist())) == k,
              f"{name} picks card vs host: {res[name]}, card {a.tolist()}, "
              f"host {b.tolist()}")
    print(f"batch selections ok: {json.dumps(res)}")
    return res


def _subject_rows(dev, n, seed):
    """``n`` distinct voxels of the campaign subject (seed 0): PW1 25x25x2
    patches (K2 on the card) and their labels as one-hot rows."""
    vols, mask = synthetic_subject(shape=SHAPE, n_modalities=2, seed=0)
    inds = np.random.default_rng(seed).choice(int(np.prod(SHAPE)), n,
                                              replace=False)
    x = gather_patches_normalized(
        pad_volumes(vols, (25, 25, 1), dev), torch.as_tensor(inds).to(dev),
        torch.tensor([60.0, 75.0], device=dev),
        torch.tensor([30.0, 31.0], device=dev), (25, 25, 1), SHAPE)
    y = np.eye(2, dtype=np.float32)[
        np.asarray(mask).reshape(-1)[inds].astype(np.int64)]
    return x, torch.from_numpy(y).to(dev)


def _flat_cpu(tree):
    return infl_mod.flatten(tree).cpu()


def _rel(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def phase_second_order(dev, n=256, B=200, damping=0.1, kink=3e-7, reps=5):
    """The second-order path at full width, card vs host: PW1 25x25x2 from
    seed 0, 256 labeled rows and 200 candidates of the campaign subject.

    A row whose forward comes within ``kink`` (3e-7, relative) of a relu
    or max-pool kink (:func:`kink_margins`, on the host) can take the
    other branch on the other device, which moves its gradient by O(1);
    such labeled rows are put last and weighted out (the ``n_valid``
    padding contract) of every batch quantity held below, and their
    effect is printed (the HVP over all rows, held at 1e-2 only).  Held:
    one HVP of the labeled gradient (within 1e-4 of max |Hv|); truncated
    CG at a fixed 8 iterations (the same iteration count and curvature
    exit; within 1e-3 of max |t|, CG amplifies rounding); the jvp scores
    of the 200 candidates along that s_test (candidates away from a kink
    within 1e-4 of max |score|, the others within 0.1), and the card's
    against the ``vmap(grad)`` oracle on 16 of them (1e-4); Lanczos and
    ``arnoldi_s_test`` at rank 4 from the same numpy start
    (:class:`HostDraws`; eigenvalues within 1e-3 of max |lambda|, s_test
    within 1e-3); ``per_sample_grads`` of 8 rows (each row within 1e-5 of
    its leaves' max |.|, a row near a kink within 0.1) and
    ``diagonal_fisher`` of the first 8 rows away from a kink (1e-5).
    Then the card's ms per HVP at the 256- and 512-row buckets, with the
    TFLOP/s of the FLOPs PyTorch's counter sees in one call, and seconds
    per Lanczos basis at rank 8."""
    from torch.utils.flop_counter import FlopCounterMode

    spec = create_pw1(2, 0.5, (25, 25, 2))
    x, y = _subject_rows(dev, 2 * n + B, seed=4)
    host_model = init_cnn(spec, seed=0, device="cpu")
    m_tr = kink_margins(host_model, x[:n].cpu())
    m_c = kink_margins(host_model, x[2 * n:].cpu())
    order = np.argsort(m_tr < kink, kind="stable")      # far rows first
    n_far = int((m_tr >= kink).sum())
    far_c = m_c >= kink
    out = {}
    for side, d in (("card", dev), ("host", torch.device("cpu"))):
        m = init_cnn(spec, seed=0, device=d)
        p = infl_mod.param_dict(m)
        perm = torch.as_tensor(order).to(x.device)
        tx, ty = x[:n][perm].to(d), y[:n][perm].to(d)
        cx, cy = x[2 * n:].to(d), y[2 * n:].to(d)
        w = (torch.arange(n, device=d) < n_far).float()
        g = infl_mod.query_gradient(m, p, tx, ty, n_far)
        r = {"hv": _flat_cpu(infl_mod.hvp(m, p, tx, ty, g, w)),
             "hv_all": _flat_cpu(infl_mod.hvp(m, p, tx, ty, g))}
        t0 = time.perf_counter()
        st, r["cg"] = infl_mod.cg_solve_hvp(m, p, tx, ty, g, damping,
                                            max_iter=8, tol=0.0, w=w)
        r["t"], r["cg_s"] = _flat_cpu(st), time.perf_counter() - t0
        r["scores"] = infl_mod.influence_scores_jvp(m, p, st, cx, cy).cpu()
        if side == "card":
            r["oracle"] = infl_mod._chunk_influence(m, p, st, cx[:16],
                                                    cy[:16]).cpu()
        with HostDraws(17):
            ev, _, _ = hessian_mod.lanczos_eigsh(m, p, tx, ty, 4, key=5,
                                                 w=w)
            ast, _ = hessian_mod.arnoldi_s_test(
                m, p, tx, ty, tx, ty, 4, key=5, damping=damping,
                n_valid=n_far, q_n_valid=n_far)
        r["evals"], r["arnoldi"] = ev.cpu(), _flat_cpu(ast)
        r["psg"] = {k: v.cpu() for k, v in per_sample_grads(
            m, p, x[:8].to(d), y[:8].to(d)).items()}
        r["fisher"] = {k: v.cpu() for k, v in diagonal_fisher(
            m, p, tx[:8], ty[:8], chunk=4).items()}
        out[side] = r
    c, h = out["card"], out["host"]
    sc = (c["scores"] - h["scores"]).abs() / h["scores"].abs().max()
    psg_rows = [max(float((c["psg"][k][i] - h["psg"][k][i]).abs().max()
                          / h["psg"][k][i].abs().max()) for k in c["psg"])
                for i in range(8)]
    res = {"rows_near_a_kink": n - n_far,
           "candidates_near_a_kink": int((~far_c).sum()),
           "hvp_rel": _rel(c["hv"], h["hv"]),
           "hvp_all_rows_rel": _rel(c["hv_all"], h["hv_all"]),
           "cg_card": c["cg"], "cg_host": h["cg"],
           "cg_rel": _rel(c["t"], h["t"]), "cg8_card_s": c["cg_s"],
           "cg8_host_s": h["cg_s"],
           "scores_rel": float(sc[torch.as_tensor(far_c)].max()),
           "scores_near_kink_rel": float(sc[torch.as_tensor(~far_c)].max())
           if (~far_c).any() else None,
           "scores_vs_oracle_rel": _rel(c["scores"][:16], c["oracle"]),
           "evals_card": c["evals"].tolist(),
           "evals_host": h["evals"].tolist(),
           "evals_rel": _rel(c["evals"], h["evals"]),
           "arnoldi_rel": _rel(c["arnoldi"], h["arnoldi"]),
           "psg_rows_rel": psg_rows,
           "psg_rows_near_kink": (m_tr[:8] < kink).tolist(),
           "fisher_rel": max(_rel(c["fisher"][k], h["fisher"][k])
                             for k in c["fisher"])}
    check(res["hvp_rel"] <= 1e-4 and res["hvp_all_rows_rel"] <= 1e-2,
          f"HVP card vs host: {res}")
    check(c["cg"] == h["cg"] and res["cg_rel"] <= 1e-3,
          f"CG (8 iterations) card vs host: {res}")
    check(res["scores_rel"] <= 1e-4 and (res["scores_near_kink_rel"]
                                         or 0.0) <= 0.1
          and res["scores_vs_oracle_rel"] <= 1e-4,
          f"influence scores: {res}")
    check(res["evals_rel"] <= 1e-3 and res["arnoldi_rel"] <= 1e-3,
          f"Lanczos / Arnoldi card vs host: {res}")
    check(all(e <= (0.1 if near else 1e-5) for e, near in
              zip(psg_rows, res["psg_rows_near_kink"]))
          and res["fisher_rel"] <= 1e-5,
          f"per-sample grads / diagonal Fisher card vs host: {res}")

    m = init_cnn(spec, seed=0, device=dev)
    p = infl_mod.param_dict(m)
    torch.cuda.reset_peak_memory_stats()
    for rows in (n, 2 * n):
        tx, ty = x[:rows], y[:rows]
        v = infl_mod.loss_grad(m, p, tx, ty)
        with FlopCounterMode(display=False) as fc:
            infl_mod.hvp(m, p, tx, ty, v)
        ms = time_ms(lambda: infl_mod.hvp(m, p, tx, ty, v), reps)
        flops = fc.get_total_flops()
        res[f"hvp_{rows}"] = {"ms": ms, "flops": flops,
                              "tflops_per_s": flops / ms / 1e9}
    # the port's own start (a Philox draw on the card), as the campaign's
    tx, ty = x[:n], y[:n]
    hessian_mod.lanczos_eigsh(m, p, tx, ty, 2, key=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hessian_mod.lanczos_eigsh(m, p, tx, ty, 8, key=5)
    torch.cuda.synchronize()
    res["lanczos8_s"] = time.perf_counter() - t0
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    print(f"second order ok (CG at 8 iterations: {c['cg']}): "
          f"{json.dumps(res)}")
    return res


def phase_slic_variance(dev, n_segments=64, slices=(0, 8, 16, 24)):
    """SLIC native vs numpy on 4 slices of the campaign subject (label maps
    equal), seconds per volume of the native ``oversegment_volume``, and
    ``high_variance_filter`` (25x25 patches, threshold 2.0, the campaign
    grid) card vs host: the same positions."""
    vols, _ = synthetic_subject(shape=SHAPE, n_modalities=2, seed=0)
    vol = vols[0]
    res = {"differing_share": {}, "numpy_s_per_slice": 0.0}
    sp_mod.slic_2d(vol[:, :, 0], n_segments, backend="native")   # build
    for z in slices:
        nat = sp_mod.slic_2d(vol[:, :, z], n_segments, backend="native")
        t0 = time.perf_counter()
        ref = sp_mod.slic_2d(vol[:, :, z], n_segments, backend="numpy")
        res["numpy_s_per_slice"] += (time.perf_counter() - t0) / len(slices)
        res["differing_share"][z] = float((nat != ref).mean())
    check(not any(res["differing_share"].values()),
          f"SLIC native vs numpy: {res}")
    t0 = time.perf_counter()
    seg = sp_mod.oversegment_volume(vol, n_segments, backend="native")
    res["native_s_per_volume"] = time.perf_counter() - t0
    res["segments_per_slice"] = int(seg[:, :, 0].max()) + 1
    grid = generate_grid_samples(SHAPE, 2)
    card = high_variance_filter(vol, (25, 25, 1), 2.0, grid, device=dev)
    host = high_variance_filter(vol, (25, 25, 1), 2.0, grid, device="cpu")
    res["hv_positions"] = len(card)
    check(np.array_equal(card, host),
          f"variance filter card vs host: {len(card)} vs {len(host)}")
    res["hv_filter_ms"] = time_ms(lambda: high_variance_filter(
        vol, (25, 25, 1), 2.0, grid, device=dev), 5)
    print(f"SLIC and variance filter ok: {json.dumps(res)}")
    return res


def phase_finetune_wpool(dev, root, n_pseudo=256, n_check=4096):
    """``finetune_wpool`` once on the f32 campaign's entropy state (its
    weights, a fresh Adam, the whole pool, 256 pseudo-labels), timed, with
    K2 gathering labels plus pseudo-labels; then the confident picks card
    vs host from the same weights on the first 4096 pool voxels (the host
    cannot sweep the whole pool in time): the same voxels and labels."""
    expr = create_expr(root, synthetic=True, device=str(dev))
    spec = expr.build_model()
    train, pool = MethodJournal(root, "entropy").membership()
    params = ckpt.load_checkpoint(os.path.join(
        root, "entropy", "curr_weights.npz"))[0]
    state = init_train_state(expr._load_model(spec, params), "Adam", 1e-3)
    picks = {}
    orig = pw_experiment.confident_samples

    def spy(*a, **kw):
        picks["call"] = orig(*a, **kw)
        return picks["call"]

    pw_experiment.confident_samples = spy
    try:
        k2 = ops.gather.KERNEL.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        expr.finetune_wpool(spec, state, train, pool, n_pseudo)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        k2 = ops.gather.KERNEL.launches - k2
    finally:
        pw_experiment.confident_samples = orig
    check(len(picks["call"][0]) == n_pseudo and k2 >= 1,
          f"finetune_wpool: {len(picks['call'][0])} picks, K2 +{k2}")
    sub = pool[:n_check]
    conf = {}
    for side, d in (("card", dev), ("host", torch.device("cpu"))):
        e = expr if side == "card" else create_expr(root, synthetic=True,
                                                    device="cpu")
        mu, sd = e._stats_arrays()
        ev = PoolEvaluator(spec, e.padded(), mu, sd,
                           tuple(e.config.model.patch_shape),
                           e._load_subject()[0][0].shape)
        p1 = ev.evaluate(e._load_model(spec, params), sub)["posteriors"]
        conf[side] = confident_samples(p1, sub, n_pseudo)
    same = (set(conf["card"][0].tolist()) == set(conf["host"][0].tolist())
            and np.array_equal(conf["card"][1][np.argsort(conf["card"][0])],
                               conf["host"][1][np.argsort(conf["host"][0])]))
    res = {"seconds": secs, "k2_launches": k2, "n_pseudo": n_pseudo,
           "pseudo_ones": int(picks["call"][1].sum()),
           "card_vs_host_same_set": same}
    check(same, f"finetune_wpool's confident picks card vs host: {res}")
    print(f"finetune_wpool ok: {json.dumps(res)}")
    return res


def kink_margins(model, x):
    """Per patch (NHWC ``x``), how close its forward comes to a point where
    f32 rounding on another device can change the gradient: the smallest
    |relu input|, and the smallest nonzero gap between the two largest
    positive inputs of a max-pool window, each relative to the largest
    |value| of that layer for that patch."""
    layers = model.spec.layers
    zs = {}
    hooks = [getattr(model, l.name).register_forward_hook(
        lambda m, i, o, n=l.name: zs.__setitem__(n, o))
        for l in layers if l.kind in ("conv", "fc") and "A" in l.op_order]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    n = len(x)
    margin = torch.full((n,), float("inf"), device=x.device)
    for z in zs.values():
        zf = z.reshape(n, -1).abs()
        margin = torch.minimum(margin, zf.amin(1)
                               / zf.amax(1).clamp_min(1e-30))
    for i, l in enumerate(layers):
        if l.kind != "pool":
            continue
        h = model.act(zs[layers[i - 1].name])
        hp = model.pad_input(l, h)
        (kh, kw), (sh, sw) = l.ksize, l.strides
        w = hp.unfold(2, kh, sh).unfold(3, kw, sw)
        top = w.reshape(w.shape[:4] + (-1,)).topk(2, -1).values
        gap = top[..., 0] - top[..., 1]
        gap = torch.where((top[..., 0] > 0) & (gap > 0), gap, float("inf"))
        margin = torch.minimum(margin, gap.reshape(n, -1).amin(1)
                               / h.reshape(n, -1).amax(1).clamp_min(1e-30))
    return margin.cpu().numpy()


def row_errors(got, want, p1):
    """Per row of (n, c, L) shrunk gradients, the largest |delta| over the
    layer columns relative to each column's max |want|, and the head's
    largest |value| over classes >= 1 relative to the largest column's.
    Class 0 comes from the zero-sum identity ``g0 = -p1 g1 / p0``, which
    divides f32 rounding (of ``1 - p1`` inside g1, and of the head's zero
    column) by p0, so it is left out of both where p0 < 1e-3 (below that
    a 6e-8 rounding already moves it by more than 6e-5)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want[..., :-1]).max(axis=(0, 1))
    rel = np.abs(got - want)[..., :-1] / scale
    rel[np.asarray(p1) > 1 - 1e-3, 0] = 0.0
    err = rel.max(axis=(1, 2))
    head = max(np.abs(got[:, 1:, -1]).max(),
               np.abs(want[:, 1:, -1]).max()) / scale.max()
    return err, head


def rows_verdict(name, err, margins, extra, p1, rtol=1e-4, loose=0.1,
                 bad_frac=0.05, kink=3e-7):
    """The row rule of the module docstring: rows beyond ``rtol`` must sit
    near a relu or max-pool kink (margin < ``kink``), be at most
    ``bad_frac`` of the rows, and stay within ``loose``."""
    bad = np.nonzero(err > rtol)[0]
    res = {"max_rel_err": float(err.max()),
           "median_rel_err": float(np.median(err)), "rows": len(err),
           "rows_beyond_tol": len(bad),
           "beyond_tol_err_kink_margin_p1": [
               [float(err[i]), float(margins[i]), float(p1[i])]
               for i in bad],
           "rows_near_a_kink": int((margins < kink).sum()), **extra}
    check(len(bad) <= bad_frac * len(err) and err.max() <= loose
          and all(margins[i] < kink for i in bad),
          f"{name} card vs host: {res}")
    return res


def shrunk_check(name, got, want, p1, margins):
    err, head = row_errors(got, want, p1)
    check(head <= 1e-4, f"{name}: head column {head} is not near zero")
    p1 = np.asarray(p1)
    return rows_verdict(name, err, margins, {
        "head_rel": float(head),
        "rows_p0_below_1e-3": int((p1 > 1 - 1e-3).sum())}, p1)


def a_check(name, got, want, diag_load, p1, margins):
    """(n, L, L) A-matrices, card vs host: the layers' block per sample and
    column by the row rule; the head's row and column (products with its
    rounding noise) near zero, its diagonal at the load."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    blk_g, blk_w = got[:, :-1, :-1], want[:, :-1, :-1]
    scale = np.abs(blk_w).max(axis=(0, 1))
    err = (np.abs(blk_g - blk_w) / scale).max(axis=(1, 2))
    off = max(np.abs(a[:, -1, :-1]).max() for a in (got, want)) / \
        np.abs(want).max()
    diag = max(np.abs(a[:, -1, -1] / diag_load - 1).max()
               for a in (got, want))
    check(off <= 1e-4 and diag <= 1e-3,
          f"{name}: head row/column {off}, head diagonal {diag}")
    return rows_verdict(name, err, margins,
                        {"head_offdiag_rel": float(off),
                         "head_diag_vs_load": float(diag)}, np.asarray(p1))


def sdp_kwargs(A, lambda_, X, cap_peak, k=64):
    """``solve_a_optimal``'s arguments as ``fi_query_distribution`` builds
    them."""
    kw = {"cap": 1.0 / k if cap_peak else 1.0, "tol": 1e-4}
    if lambda_ > 0:
        F = torch.as_tensor(X, dtype=torch.float32, device=A.device)
        kw.update(lin=-lambda_ * (F ** 2).sum(0), F=F, rho=10.0)
    return kw


def objective64(q, A, kw):
    q = np.asarray(q, np.float64)
    f = np.trace(np.linalg.inv(np.einsum(
        "n,nab->ab", q, A.cpu().numpy().astype(np.float64))))
    if "F" in kw:
        F = kw["F"].cpu().numpy().astype(np.float64)
        f += kw["lin"].cpu().numpy().astype(np.float64) @ q
        f += 0.5 * kw["rho"] * np.sum((F @ q) ** 2)
    return f


def timed_solve(A, kw, graph=None):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = sdp.solve_a_optimal(A, graph=graph, **kw)
    q = sol.q.cpu().numpy()
    return q, float(sol.rel_gap), sol.iters, time.perf_counter() - t0


def phase_fim_parity(dev, n=256, B=200, diag_load=1e-5):
    """The fused scorer, the candidate tail and the solver, card vs host."""
    ps = (25, 25, 1)
    spec = create_pw1(2, 0.5, (25, 25, 2))
    models = {"card": init_cnn(spec, seed=0, device=dev),
              "host": init_cnn(spec, seed=0, device="cpu")}
    vols, _ = synthetic_subject(shape=SHAPE, n_modalities=2, seed=1)
    inds = np.random.default_rng(3).integers(0, int(np.prod(SHAPE)), n)
    on = {}
    for side, d in (("card", dev), ("host", "cpu")):
        on[side] = (pad_volumes(vols, ps, d), torch.tensor([60.0, 75.0],
                    device=d), torch.tensor([30.0, 31.0], device=d))
    x = gather_patches_normalized(on["card"][0], torch.as_tensor(inds).to(
        dev), on["card"][1], on["card"][2], ps, SHAPE)
    out = {"card": pool_score_fused(models["card"], x),
           "host": pool_score_fused(models["host"], x.cpu())}
    p1_err = float((out["card"]["p1"].cpu() - out["host"]["p1"]).abs().max())
    check(p1_err <= 1e-4, f"pool_score_fused p1 card vs host {p1_err}")
    margins = kink_margins(models["card"], x)
    res = {"p1_max_abs_err": p1_err,
           "shrunk": shrunk_check("pool_score_fused shrunk",
                                  out["card"]["shrunk"].cpu(),
                                  out["host"]["shrunk"],
                                  out["host"]["p1"], margins)}
    # fi's tail at B = 200: the most uncertain candidates, gathered by K2
    p1 = out["card"]["p1"]
    sel = torch.sort((p1 - 0.5).abs(), stable=True).indices[:B]
    cand = torch.as_tensor(inds).to(dev)[sel].contiguous()
    k2_0 = ops.gather.KERNEL.launches
    A = {"card": gather_shrunk_a_matrices(models["card"], on["card"][0],
                                          cand, *on["card"][1:], ps, SHAPE,
                                          p1[sel], diag_load)}
    check(ops.gather.KERNEL.launches == k2_0 + 1,
          "gather_shrunk_a_matrices did not launch K2 on the card")
    A["host"] = gather_shrunk_a_matrices(models["host"], on["host"][0],
                                         cand.cpu(), *on["host"][1:], ps,
                                         SHAPE, p1[sel].cpu(), diag_load)
    res["A"] = a_check("gather_shrunk_a_matrices", A["card"].cpu(),
                       A["host"], diag_load, p1[sel].cpu().numpy(),
                       margins[sel.cpu().numpy()])
    # the solver on the card's A, card vs host
    with torch.no_grad():
        feats = models["card"](x[sel]).feature.cpu().numpy()
    ref = refine_feature_matrix(feats.T, B)
    X = ref - ref.mean(axis=1, keepdims=True)
    res["sdp"] = {}
    for case, lam, cap_peak in (("lambda0", 0.0, False),
                                ("lambda0_cap_peak", 0.0, True),
                                ("lambda0.5", 0.5, False)):
        kw_c = sdp_kwargs(A["card"], lam, X, cap_peak)
        kw_h = sdp_kwargs(A["card"].cpu(), lam, X, cap_peak)
        q_c, gap_c, it_c, s_cold = timed_solve(A["card"], kw_c)
        q_c2, _, _, s_warm = timed_solve(A["card"], kw_c)
        q_e, _, it_e, s_eager = timed_solve(A["card"], kw_c, graph=False)
        q_h, gap_h, it_h, s_host = timed_solve(A["card"].cpu(), kw_h)
        f_c, f_h = objective64(q_c, A["card"], kw_c), \
            objective64(q_h, A["card"], kw_c)
        r = {"max_abs_dq": float(np.abs(q_c - q_h).max()),
             "objective_rel": float(abs(f_c - f_h) / abs(f_h)),
             "iters_card": it_c, "iters_host": it_h,
             "rel_gap_card": gap_c, "rel_gap_host": gap_h,
             "graph_s_first": s_cold, "graph_s_again": s_warm,
             "eager_s": s_eager, "host_s": s_host, "eager_iters": it_e,
             "graph_vs_eager_max_abs_dq": float(np.abs(q_c - q_e).max()),
             "repeat_identical": bool(np.array_equal(q_c, q_c2))}
        res["sdp"][case] = r
        check(np.isfinite(q_c).all() and abs(q_c.astype(np.float64).sum()
                                             - 1) < 1e-4,
              f"SDP {case}: card q is not a PMF")
        if lam == 0:
            check(r["max_abs_dq"] <= 1e-4 and r["objective_rel"] <= 1e-5,
                  f"SDP {case} card vs host: {r}")
        else:
            check(r["objective_rel"] <= 1e-4,
                  f"SDP {case} card vs host: {r}")
        check(r["graph_vs_eager_max_abs_dq"] == 0.0 and it_e == it_c,
              f"SDP {case}: the CUDA graph and the eager loop differ: {r}")
        print(f"SDP {case}: {json.dumps(r)}")
    print(f"FIM parity ok: p1 {p1_err:.3g}, shrunk {res['shrunk']}, "
          f"A {res['A']}")
    return res


def fim_flops_per_patch(spec):
    """Operations of the eps-injected forward (with each conv's window
    sum: a channel sum, then a 1 -> 1 channel ones conv) plus its
    input-gradient backward: every conv and fc again, except the first
    conv (the patches need no gradient)."""
    h, w, c = spec.input_shape
    fwd = ones = first = 0.0
    for layer in spec.layers:
        if layer.kind == "conv":
            kk = float(np.prod(layer.ksize))
            fwd += 2 * h * w * layer.out * c * kk
            ones += h * w * c + 2 * h * w * kk
            first = first or 2 * h * w * layer.out * c * kk
            c = layer.out
        elif layer.kind == "pool":
            h, w = -(-h // layer.strides[0]), -(-w // layer.strides[1])
        else:
            fwd += 2 * h * w * c * layer.out
            h, w, c = 1, 1, layer.out
    return 2 * fwd - first + ones


def sweep_profile(model, ev, cd=None):
    """``torch.profiler`` window over one z-chunk (extraction included):
    top device kernels, device time by aten op, the card's idle share
    between the first and last kernel, and the weight-gradient check."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    z = SWEEP_Z_CHUNK
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        x = extract_normalize(ev._slices[z:2 * z], 25, 25, ev.grid_spacing,
                              ev._mu_c, ev._sd_c)
        pool_score_fused(model, x, True, cd, nchw=True)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_kernel = {}
    for e in kernels:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + \
            e.time_range.elapsed_us()
    busy = sum(by_kernel.values())
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels))
    by_op, calls = {}, {}
    for ev_ in prof.key_averages():
        if ev_.key.startswith("aten::"):
            t = getattr(ev_, "self_device_time_total", None)
            if t is None:
                t = getattr(ev_, "self_cuda_time_total", 0.0)
            if t:
                by_op[ev_.key] = t
            calls[ev_.key] = ev_.count
    wgrad = sorted(k for k in by_kernel if "wgrad" in k.lower())
    dgrad = sorted(k for k in by_kernel if "dgrad" in k.lower())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    n_conv = sum(1 for l in model.spec.layers if l.kind == "conv")
    n_fc = sum(1 for l in model.spec.layers if l.kind == "fc")
    res = {"device_busy_us": busy, "span_us": span,
           "idle_share": 1.0 - busy / span,
           "top_kernels_us": top,
           "aten_self_device_us": dict(sorted(by_op.items(),
                                              key=lambda kv: -kv[1])),
           "calls": {k: calls.get(k, 0) for k in (
               "aten::convolution_backward", "aten::mm", "aten::addmm",
               "aten::cudnn_convolution", "aten::im2col")},
           "wgrad_kernels": wgrad, "dgrad_kernels": dgrad}
    # no weight gradient: no cuDNN wgrad kernel, one convolution backward
    # per conv but the first (the patches need no gradient), and one mm
    # per fc layer (its input gradient)
    check(not wgrad, f"weight-gradient kernels ran: {wgrad}")
    check(res["calls"]["aten::convolution_backward"] == n_conv - 1,
          f"backward op counts {res['calls']} (expected {n_conv - 1} conv "
          f"backward)")
    # f32: the forward fcs are addmm, so each mm is an fc input gradient;
    # bf16: the forward fcs are f32-output mms too
    n_mm = n_fc if cd is None else 2 * n_fc
    check(res["calls"]["aten::mm"] == n_mm,
          f"mm calls {res['calls']['aten::mm']} (expected {n_mm})")
    return res


def bf16_rows(got, want, p1):
    """bf16 rows against a reference (the JAX package's own bf16 rule,
    ``tests/test_bf16_fim.py``): correlation and max |delta| relative to
    the reference's max |.|, over every layer column but the head's (zero
    in exact arithmetic) and without class 0 where p0 < 1e-3."""
    got = np.asarray(got, np.float64)[..., :-1]
    want = np.asarray(want, np.float64)[..., :-1]
    keep = np.ones(got.shape[:2], bool)
    keep[:, 0] = np.asarray(p1) < 1 - 1e-3
    g, w = got[keep], want[keep]
    return {"corr": float(np.corrcoef(g.ravel(), w.ravel())[0, 1]),
            "max_rel": float(np.abs(g - w).max() / np.abs(w).max())}


def phase_fim_sweep(dev, n_check=64, cd=None, ref_unc=None):
    """``GridPoolEvaluator.fim_sweep`` over bench.py's 1,048,576-patch
    pool, timed on the card after a one-chunk warm-up.  With ``cd`` the
    sweep runs at ``make_pool_scorer``'s compute dtype and its top
    ``TOP_B`` uncertainties are compared with ``ref_unc`` (the f32
    sweep's)."""
    scorer = make_pool_scorer(cd) if cd is not None else None
    cd = scorer.compute_dtype if scorer is not None else None
    ps = (25, 25, 1)
    spec = create_pw1(2, 0.5, (25, 25, 2))
    model = init_cnn(spec, seed=0, device=dev)
    t0 = time.perf_counter()
    vols, _ = synthetic_subject(shape=SWEEP_SHAPE, n_modalities=2, seed=3)
    setup_s = time.perf_counter() - t0
    mu = np.array([v.mean() for v in vols])
    sd = np.array([v.std() for v in vols])
    ev = GridPoolEvaluator(spec, pad_volumes(vols, ps, dev), mu, sd, ps,
                           SWEEP_SHAPE, grid_spacing=2,
                           z_chunk=SWEEP_Z_CHUNK)
    n = ev.nz * ev.nx * ev.ny
    s1, s2, s3 = SWEEP_SHAPE
    check(n == (s1 // 2) * (s2 // 2) * s3, f"sweep pool has {n} patches")
    x = extract_normalize(ev._slices[:SWEEP_Z_CHUNK], 25, 25, 2, ev._mu_c,
                          ev._sd_c)
    (scorer or pool_score_fused)(model, x, nchw=True)
    del x
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = ev.fim_sweep(model, compute_dtype=cd, as_device=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(res["p1"].shape == (n,) and res["shrunk"].shape == (n, 2, 7)
          and bool(torch.isfinite(res["shrunk"]).all())
          and bool(torch.isfinite(res["p1"]).all()),
          "fim_sweep output shape or values")
    # rows of the sweep against the host's gather route
    rows = np.sort(np.random.default_rng(4).choice(n, n_check,
                                                   replace=False))
    z, rem = rows // (ev.nx * ev.ny), rows % (ev.nx * ev.ny)
    vox = np.ravel_multi_index((rem // ev.ny * 2, rem % ev.ny * 2, z),
                               SWEEP_SHAPE)
    host = init_cnn(spec, seed=0, device="cpu")
    xh = gather_patches_normalized(
        pad_volumes(vols, ps, "cpu"), torch.as_tensor(vox),
        torch.as_tensor(mu, dtype=torch.float32),
        torch.as_tensor(sd, dtype=torch.float32), ps, SWEEP_SHAPE)
    want = pool_score_fused(host, xh, True, cd)
    rows_t = torch.as_tensor(rows).to(dev)
    p1_err = float((res["p1"][rows_t].cpu() - want["p1"]).abs().max())
    if cd is None:
        check(p1_err <= 1e-4, f"fim_sweep p1 vs host {p1_err}")
        rows_res = shrunk_check("fim_sweep rows",
                                res["shrunk"][rows_t].cpu(), want["shrunk"],
                                want["p1"], kink_margins(host, xh))
    else:
        rows_res = bf16_rows(res["shrunk"][rows_t].cpu(), want["shrunk"],
                             want["p1"])
        check(p1_err <= 2e-2 and rows_res["corr"] > 0.995
              and rows_res["max_rel"] < 0.1,
              f"bf16 fim_sweep rows vs host: p1 {p1_err}, {rows_res}")
    unc = res["uncertainty"]
    overlap = None
    if ref_unc is not None:
        top = [torch.argsort(u, stable=True)[:TOP_B] for u in (unc, ref_unc)]
        # tie-aware: f32 picks whose bf16 uncertainty is no worse than
        # the bf16 B-th (bf16 logits take few distinct values)
        kth = unc[top[0][-1]]
        overlap = {"B": TOP_B, "overlap": len(set(top[0].tolist())
                                               & set(top[1].tolist())),
                   "f32_picks_within_bf16_cut": int(
                       (unc[top[1]] <= kth).sum()),
                   "distinct_bf16_uncertainties_in_top": int(
                       torch.unique(unc[top[0]]).numel())}
    del res
    flops = fim_flops_per_patch(spec) * n
    peak_flops = PEAK_F32_FLOPS if cd is None else PEAK_BF16_FLOPS
    out = {"dtype": str(cd or torch.float32), "patches": n, "seconds": secs,
           "patches_per_s": n / secs,
           "z_chunk": ev.z_chunk, "patches_per_chunk":
           ev.z_chunk * ev.nx * ev.ny, "max_memory_allocated": peak,
           "flop_per_patch": flops / n, "tflop_per_s": flops / secs / 1e12,
           "bound_s": bound(flops, 0.0, peak_flops)[0] / 1e3,
           "bound_peak_tflop_per_s": peak_flops / 1e12,
           "subject_setup_s": setup_s,
           "host_rows": {"p1_max_abs_err": p1_err, **rows_res},
           "top_b_vs_f32": overlap}
    print(f"FIM sweep {out['dtype']}: {n} patches in {secs:.3f} s, "
          f"{n / secs:.1f} patches/s, z_chunk {ev.z_chunk}, peak "
          f"{peak / 2**30:.2f} GiB, {out['tflop_per_s']:.2f} TFLOP/s; "
          f"rows vs host {out['host_rows']}")
    print(f"FIM sweep {out['dtype']} bound {out['bound_s']:.4f} s at "
          f"{peak_flops / 1e12:.0f} TFLOP/s; top-{TOP_B} vs f32 {overlap}")
    out["profile"] = prof = sweep_profile(model, ev, cd)
    print(f"FIM sweep profile ok: idle share {prof['idle_share']:.4f}, "
          f"op calls {prof['calls']}, top kernels "
          f"{prof['top_kernels_us'][:8]}, by aten op "
          f"{list(prof['aten_self_device_us'].items())[:10]}")
    del ev
    torch.cuda.empty_cache()
    return out, unc


def phase_campaign(dev):
    """Each run in its own experiment directory: the f32 campaign,
    ``finetune_wpool`` and the checkpoint codecs on its entropy state,
    then the bf16
    campaign, each with the launch counts zeroed just before it and read
    just after.  A run's ~0.2-0.4 GB checkpoints are removed once it is
    checked (the f32 entropy state after the codecs), the directories at
    the end."""
    top = os.path.join(ROOT, "_smoke_expr")
    shutil.rmtree(top, ignore_errors=True)
    try:
        f32 = _campaign(dev, top, F32_RUNS, "")
        wpool = phase_finetune_wpool(dev, os.path.join(top, "entropy"))
        codecs = phase_ckpt_codecs(
            dev, os.path.join(top, "entropy", "entropy", "curr_weights.npz"),
            top)
        bf16 = _campaign(dev, os.path.join(top, "bf16"), BF16_RUNS, "bf16/")
        return f32, bf16, codecs, wpool
    finally:
        shutil.rmtree(top, ignore_errors=True)


def _campaign(dev, top, runs, tag):
    """Each run in its own directory (the runs differ in their overrides,
    and a directory's ``parameters.txt`` fixes its configuration); a run's
    name is its method, with an ``@variant`` suffix for a second
    configuration of the same method.  Returns the launch counts, phases,
    seconds, per-run launches, each run's peak device memory
    (``max_memory_allocated``) and notes (whether the TensorBoard mirror
    wrote events, each influence round's CG iterations and curvature
    exit)."""
    counts = {}
    seconds = {}
    phases = {}
    by_method = {}
    peaks = {}
    notes = {}
    ops.reset_launch_counts()
    for name, overrides in runs:
        method = name.split("@")[0]
        key = tag + name
        root = os.path.join(top, name)
        k1_0 = ops.similarity.KERNEL.launches
        k2_0 = ops.gather.KERNEL.launches
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cg_log = []
        cg_solve = infl_mod.cg_solve_hvp

        def logged_cg(*a, **kw):
            out = cg_solve(*a, **kw)
            cg_log.append(out[1])
            return out

        infl_mod.cg_solve_hvp = logged_cg
        n_rounds = 1 if not tag and name in ONE_ROUND else 2
        t0 = time.perf_counter()
        try:
            res = do_expr(root, method,
                          SUPIX_BUDGET if method == "SuPix"
                          else 64 * n_rounds,
                          overrides, synthetic=True, device=str(dev))
        finally:
            infl_mod.cg_solve_hvp = cg_solve
        seconds[key] = time.perf_counter() - t0
        peaks[key] = torch.cuda.max_memory_allocated()
        init_pool = np.loadtxt(os.path.join(root, "init_pool_inds.txt"),
                               dtype=np.int64)
        train, pool = res["train_inds"], res["pool_inds"]
        picks = [np.atleast_1d(np.loadtxt(
            os.path.join(root, method, "queries", f"{i}.txt"),
            dtype=np.int64)) for i in range(len(res["perf"]))]
        check(len(init_pool) == 65536, f"pool size {len(init_pool)}")
        check(len(res["perf"]) == n_rounds and res["n_queries"]
              == sum(len(q) for q in picks),
              f"{key}: {res['n_queries']} queries, "
              f"{len(res['perf'])} rounds")
        if method == "fi":
            # the PMF is drawn with replacement and deduplicated
            check(all(1 <= len(q) <= 64 and len(set(q.tolist())) == len(q)
                      for q in picks),
                  f"{key}: picks per round {[len(q) for q in picks]}")
        elif method == "SuPix":
            # every pool member of 64 superpixels a round
            check(all(len(q) > 64 and len(set(q.tolist())) == len(q)
                      for q in picks),
                  f"{key}: picks per round {[len(q) for q in picks]}")
        else:
            check(res["n_queries"] == 64 * n_rounds, f"{key}: "
                  f"{res['n_queries']} queries")
        n_lab = 256 + res["n_queries"]
        check(len(train) == n_lab and len(set(train.tolist())) == n_lab,
              f"{key}: labeled set has {len(train)} entries")
        check(not set(train.tolist()) & set(pool.tolist())
              and set(train.tolist()) | set(pool.tolist())
              == set(init_pool.tolist()), f"{key}: membership broken")
        check(bool(np.isfinite(res["perf"]).all()),
              f"{key}: non-finite F {res['perf']}")
        dk1 = ops.similarity.KERNEL.launches - k1_0
        dk2 = ops.gather.KERNEL.launches - k2_0
        by_method[key] = {"rowmax_similarity": dk1,
                          "gather_patches_normalized": dk2}
        check(dk2 >= n_rounds,
              f"{key}: K2 launched {dk2} times in finetune")
        if method == "core-set":
            check(dk1 >= 2, f"{key}: K1 launched {dk1} times")
        if method in COMMITTEE:
            # every round: n_ensemble member finetunes and the main one
            check(dk2 >= n_rounds * (N_ENSEMBLE + 1),
                  f"{key}: K2 launched {dk2} times in the committee rounds")
        with open(os.path.join(root, method, "phases.jsonl")) as f:
            phases[key] = [json.loads(line) for line in f]
        rounds = [r for r in phases[key] if not r.get("tail")]
        check(len(rounds) == n_rounds, f"{key}: phases rows {rounds}")
        check(all(("committee" in r) == (method in COMMITTEE)
                  for r in rounds),
              f"{key}: the committee phase where it does not belong, or "
              f"missing: {rounds}")
        if method == "influence":
            # each round: the labeled bucket, the candidates, the finetune
            check(dk2 >= 3 * n_rounds, f"{key}: K2 launched {dk2} times")
            check(all(INFLUENCE_SUBS <= set(r.get("sub", {}))
                      for r in rounds),
                  f"{key}: sub spans missing from phases.jsonl: "
                  f"{[r.get('sub') for r in rounds]}")
            cg_mode = "influence_mode=arnoldi" not in overrides
            check(len(cg_log) == (n_rounds if cg_mode else 0),
                  f"{key}: {len(cg_log)} CG solves")
            notes[key + " cg"] = cg_log
        if method == "fi":
            # 2 candidate gathers and 2 finetunes
            check(dk2 >= 4, f"{key}: K2 launched {dk2} times")
            check(all(FI_SUBS <= set(r.get("sub", {})) for r in rounds),
                  f"{key}: sub spans missing from phases.jsonl: "
                  f"{[r.get('sub') for r in rounds]}")
        if tag:
            # anchors every 2 rounds: the round-2 save, no loop-end save
            with np.load(os.path.join(root, method, "curr_weights.npz")) \
                    as z:
                al = json.loads(z["__al_state__"].tobytes().decode())
                mark = "@i8" if "ckpt_dtype=int8" in overrides else "@bf16"
                check(al["round"] == 2 and any(k.endswith(mark)
                                               for k in z.files),
                      f"{key}: anchor {al}, keys {z.files[:4]}")
        curr = os.path.join(root, method, "curr_weights.npz")
        if "consistency_coeff" in overrides:
            # each MT round gathers the labeled set and 256 unlabeled
            # patches through K2
            check(dk2 >= 2 * n_rounds,
                  f"{key}: K2 launched {dk2} times in {n_rounds} MT rounds")
            with np.load(curr) as z:
                check(any(k.startswith("teacher/") for k in z.files),
                      f"{key}: no teacher group in {z.files[:6]}")
        if "train_layers" in overrides:
            p_end = ckpt.load_checkpoint(curr)[0]
            p_0 = ckpt.load_checkpoint(os.path.join(root,
                                                    "init_weights.npz"))[0]
            frozen = {l: all(np.array_equal(p_end[l][k], p_0[l][k])
                             for k in ("W", "b")) for l in p_end}
            check(all(v == l.startswith("conv") for l, v in frozen.items()),
                  f"{key}: layers unchanged since round 0: {frozen}")
            notes[key + " convs_bit_identical"] = True
        if "tb_logdir" in overrides:
            tb = os.path.join(TB_DIR, method)
            notes["tensorboard_active"] = os.path.isdir(tb) and any(
                f.startswith("events.out.tfevents") for f in os.listdir(tb))
        if tag or method != "entropy" or "@" in name:
            # the codecs phase reads the f32 entropy state; the rest of
            # the ~0.4 GB checkpoints go now
            _drop_checkpoints(root)
        print(f"campaign {key}: F per round {res['perf'].tolist()}, "
              f"picks per round {[len(q) for q in picks]}, "
              f"{seconds[key]:.3f} s, K1 +{dk1}, K2 +{dk2}, peak "
              f"{peaks[key] / 2**30:.2f} GiB")
    for k in ops.KERNELS:
        counts[k.name] = k.launches
        check(k.launches > 0,
              f"{k.name} never launched in the {tag or 'f32/'} campaign")
    return counts, phases, seconds, by_method, peaks, notes


def _drop_checkpoints(root):
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".npz"):
                os.remove(os.path.join(dirpath, f))


def round_seconds(phases, names):
    """Per-round phase seconds of the named runs (rounds 0 and 1)."""
    keys = ("score_select", "committee", "train", "eval", "checkpoint")
    return {n: [{k: r[k] for k in keys if k in r}
                for r in phases[n] if not r.get("tail")]
            for n in names if n in phases}


def numpy_bf16_round_trip(a):
    """f32 -> bf16 (round to nearest even) -> f32 in numpy integer ops."""
    b = a.view(np.uint32).astype(np.uint64)
    return ((((b + 0x7FFF + ((b >> 16) & 1)) >> 16) << 16)
            .astype(np.uint32).view(np.float32))


def numpy_int8_round_trip(a):
    """The JAX package's host int8 encode (``checkpoint.py:119-127``, per
    last axis of the JAX layout), decoded."""
    s = (np.max(np.abs(a), axis=tuple(range(a.ndim - 1)), keepdims=True)
         / np.float32(127.0)).astype(np.float32)
    safe = np.where(s > 0, s, np.float32(1.0))
    q = np.clip(np.round(a / safe), -127, 127).astype(np.int8)
    return q.astype(np.float32) * s


def phase_ckpt_codecs(dev, path, top):
    """The anchor codecs on the f32 campaign's PW1 state, Adam moments
    included: ``round_trip_bf16`` / ``round_trip_int8`` on the card
    (port layout) bit-equal to the numpy encode-decode (JAX layout), the
    card's file encode bit-equal to the host's, and the seconds and bytes
    of one engine-style save (device snapshot, encode, pull, write) at
    f32, bf16 and int8."""
    params, _, _, _ = ckpt.load_checkpoint(path)
    spec = create_pw1(2, 0.5, (25, 25, 2))
    model = CNN(spec)
    model.load_state_dict(from_jax_params(params))
    model = model.to(dev)
    opt = make_optimizer("Adam", 1e-3, model.parameters())
    load_opt_state(opt, model, ckpt.load_opt_leaves(path))
    check(len(opt.state) == len(list(model.parameters())),
          "the campaign's checkpoint carries no Adam moments")
    mism = []
    for name, p in model.named_parameters():
        tensors = {"": p.detach()}
        tensors.update({k: opt.state[p][k] for k in ("exp_avg",
                                                     "exp_avg_sq")})
        for what, t in tensors.items():
            host = to_jax_params({name: t.cpu()})
            (layer, kv), = host.items()
            (kind, arr), = kv.items()
            card = to_jax_params({name: ckpt.round_trip_bf16(t)})
            want = numpy_bf16_round_trip(arr)
            if not np.array_equal(card[layer][kind].view(np.uint32),
                                  want.view(np.uint32)):
                mism.append(f"bf16 {name} {what}")
            if what == "" and t.dim() >= 2:
                card = to_jax_params({name: ckpt.round_trip_int8(t, 0)})
                want = numpy_int8_round_trip(arr)
                if not np.array_equal(card[layer][kind].view(np.uint32),
                                      want.view(np.uint32)):
                    mism.append(f"int8 {name}")
    check(not mism, f"codec round trips card vs numpy differ: {mism}")
    res = {}
    sd = model.state_dict()
    for dt in ("float32", "bfloat16", "int8"):
        f = os.path.join(top, f"codec_{dt}.npz")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_checkpoint(f, to_jax_tensors(sd), al_state={"round": 1},
                             opt_state=opt_state_tensors(opt, model),
                             dtype=dt)
        res[dt] = {"seconds": time.perf_counter() - t0,
                   "bytes": os.path.getsize(f)}
        if dt != "float32":
            h = os.path.join(top, f"codec_{dt}_host.npz")
            ckpt.save_checkpoint(h, to_jax_params(sd),
                                 al_state={"round": 1},
                                 opt_state=opt_state_leaves(opt, model),
                                 dtype=dt)
            with np.load(f) as a, np.load(h) as b:
                check(sorted(a.files) == sorted(b.files) and all(
                    np.array_equal(a[k], b[k]) for k in a.files),
                      f"{dt}: the card's file encode differs from the host's")
            os.remove(h)
        os.remove(f)
    for dt in ("float32", "bfloat16", "int8"):
        # the mean teacher's resume point: one more copy of the params
        f = os.path.join(top, f"codec_{dt}_teacher.npz")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_checkpoint(f, to_jax_tensors(sd), al_state={"round": 1},
                             teacher_params=to_jax_tensors(sd),
                             opt_state=opt_state_tensors(opt, model),
                             dtype=dt)
        res[f"{dt}_with_teacher"] = {"seconds": time.perf_counter() - t0,
                                     "bytes": os.path.getsize(f)}
        os.remove(f)
    f = os.path.join(top, "codec_int8_noopt.npz")
    t0 = time.perf_counter()
    ckpt.save_checkpoint(f, to_jax_tensors(sd), dtype="int8")
    res["int8_opt_reset_per_round"] = {"seconds": time.perf_counter() - t0,
                                       "bytes": os.path.getsize(f)}
    os.remove(f)
    print(f"ckpt codecs ok: round trips card == numpy on "
          f"{len(list(model.parameters()))} tensors and their moments; "
          f"saves {json.dumps(res)}")
    return res


def phase_determinism_cost(dev, n=384, reps=7):
    """What the finetune's deterministic cuDNN costs: one campaign
    round's finetune (384 labeled PW1 25x25x2 patches, b 128, Adam, the
    bucket's step count) timed with ``deterministic_cudnn()`` and with
    cuDNN's default choice, interleaved, f32 and bf16; medians of the
    repetitions after the first."""
    spec = create_pw1(2, 0.5, (25, 25, 2))
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(n, 25, 25, 2, device=dev, generator=gen)
    y = torch.eye(2, device=dev)[torch.randint(0, 2, (n,), device=dev,
                                               generator=gen)]
    idx_mat, w_mat = build_batch_index_matrix(n, 128, 1,
                                              np.random.default_rng(0))
    res = {}
    for cd in (None, torch.bfloat16):
        states = {det: init_train_state(init_cnn(spec, 0, dev), "Adam",
                                        1e-3) for det in (False, True)}
        times = {False: [], True: []}
        for _ in range(reps):
            for det in (False, True):
                ctx = (deterministic_cudnn() if det else
                       torch.backends.cudnn.flags(
                           enabled=True, benchmark=False,
                           deterministic=False, allow_tf32=False))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with ctx:
                    finetune_steps(states[det], x, y, idx_mat, w_mat,
                                   torch.ones(2, device=dev), 7,
                                   compute_dtype=cd)
                torch.cuda.synchronize()
                times[det].append(time.perf_counter() - t0)
        name = "float32" if cd is None else "bfloat16"
        res[name] = {"default_s": float(np.median(times[False][1:])),
                     "deterministic_s": float(np.median(times[True][1:])),
                     "steps": int((w_mat.sum(1) > 0).sum())}
    print(f"finetune determinism cost: {json.dumps(res)}")
    return res


def _suppressed_resume_writes(orig):
    """``save_checkpoint`` with the resume point's writes dropped — what a
    crash before them leaves on disk."""
    dropped = []

    def patched(path, *a, **kw):
        if os.path.basename(path) == "curr_weights.npz":
            dropped.append(path)
            return None
        return orig(path, *a, **kw)

    return patched, dropped


def phase_resume(dev, mt=False):
    """resume == continue on the card (``tests/test_ckpt_every.py``): a
    4-round random campaign with int8 anchors every 3 rounds runs once
    uninterrupted; a second run loses its resume-point writes for 3
    rounds (the round-3 anchor was adopted live but never landed), then a
    fresh ``PWExperiment`` replays from the initial weights to round 4.
    The final ``curr_weights.npz``, the query journal and
    ``perf_evals.txt`` must be bit-identical.  ``mt``: the same under the
    mean teacher, whose int8 ``teacher/`` group must be in the file (the
    replay rebuilds the teacher from the initial weights)."""
    top = os.path.join(ROOT, "_smoke_expr", "resume")
    shutil.rmtree(top, ignore_errors=True)
    vols, mask = synthetic_subject(shape=SHAPE, n_modalities=2, n_blobs=3,
                                   seed=0)
    cfg_pars = set_parameters(DEFAULT_PARS,
                              RESUME_OVERRIDES + (MT if mt else ""))

    def fresh(root):
        expr = pw_experiment.PWExperiment(
            root, ExperimentConfig.from_pars(cfg_pars), device=dev)
        expr.attach_subject(vols, mask)
        return expr

    def artifacts(root):
        mdir = os.path.join(root, "random")
        qdir = os.path.join(mdir, "queries")
        with np.load(os.path.join(mdir, "curr_weights.npz")) as z:
            w = {k: z[k] for k in z.files}
        with open(os.path.join(mdir, "perf_evals.txt")) as f:
            ev = f.read()
        q = {n: open(os.path.join(qdir, n)).read()
             for n in sorted(os.listdir(qdir))}
        return w, q, ev

    try:
        t0 = time.perf_counter()
        a = fresh(os.path.join(top, "a"))
        a.prep_data()
        a.add_method("random")
        a.run_method("random", 256)
        a_s = time.perf_counter() - t0
        b = fresh(os.path.join(top, "b"))
        b.prep_data()
        b.add_method("random")
        orig = pw_experiment.save_checkpoint
        pw_experiment.save_checkpoint, dropped = \
            _suppressed_resume_writes(orig)
        try:
            b.run_method("random", 192)
        finally:
            pw_experiment.save_checkpoint = orig
        check(len(dropped) == 1, f"resume: dropped writes {dropped}")
        t0 = time.perf_counter()
        fresh(os.path.join(top, "b")).run_method("random", 256)
        resume_s = time.perf_counter() - t0
        wa, qa, ea = artifacts(os.path.join(top, "a"))
        wb, qb, eb = artifacts(os.path.join(top, "b"))
        diff = sorted(k for k in set(wa) | set(wb)
                      if k not in wa or k not in wb
                      or wa[k].dtype != wb[k].dtype
                      or not np.array_equal(wa[k], wb[k]))
        res = {"rounds": 4, "ckpt_full_every": 3, "ckpt_dtype": "int8",
               "entries": len(wa), "differing_entries": diff,
               "queries_equal": qa == qb, "perf_evals_equal": ea == eb,
               "uninterrupted_s": a_s, "resume_with_replay_s": resume_s,
               "al_state": json.loads(wa["__al_state__"].tobytes().decode()),
               "mean_teacher": mt}
        check(not diff and qa == qb and ea == eb and len(qa) == 4
              and any(k.endswith("@i8") for k in wa)
              and (not mt or "teacher/fc1/W@i8" in wa),
              f"resume != continue on the card: {res}")
        print(f"resume == continue ok: {json.dumps(res)}")
        return res
    finally:
        shutil.rmtree(top, ignore_errors=True)


def _memo_evaluate(ev):
    """``ev.evaluate`` answering from one whole-grid sweep per (model, MC
    key), posteriors and features at once, so the host's side of the
    picks check sweeps each pass once (the rows a slab evaluation would
    give: each z-chunk is keyed on its global index)."""
    cache, ops2 = {}, ("posteriors", "feature_layer")

    def evaluate(model, inds, ops=("posteriors",), as_device=False, *,
                 mc_rng=None):
        key = (id(model), mc_rng)
        if key not in cache:
            with torch.no_grad():
                cache[key] = dict(zip(ops2, ev._whole_sweep(model, ops2,
                                                            mc_rng)))
        rows = torch.as_tensor(np.asarray(ev._grid_rows(inds), np.int64))
        return {op: cache[key][op][rows] if as_device
                else cache[key][op][rows].numpy() for op in ops}

    ev.evaluate = evaluate
    return ev


class _CardResults:
    """An evaluator that answers with the card evaluator's results copied
    to the host."""

    def __init__(self, ev, model):
        self.ev, self.model = ev, model
        self.device = torch.device("cpu")

    def evaluate(self, model, inds, ops=("posteriors",), as_device=False, *,
                 mc_rng=None):
        r = self.ev.evaluate(self.model, inds, ops, True, mc_rng=mc_rng)
        return {op: v.cpu() if as_device else v.cpu().numpy()
                for op, v in r.items()}


def phase_multi_picks(dev, k=64, B=200, mc_iters=2, n_members=3, seed=77):
    """``query_multimg`` with all 15 strategies on the card over three
    64x64x16 subjects (PW1 25x25x2 from seed 0, grid spacing 4, every
    17th grid voxel labeled), every draw a numpy draw keyed on what the
    port passes (``KeyedDraws``; each subject's context keyed ``seed``);
    then the host's picks of entropy, core-set, rep-entropy, BALD,
    BatchBALD and BADGE from the same weights and draws (equal per
    subject), and fi's A-matrices of the card's candidates recomputed on
    the host (the FIM parity rule).  BADGE's host run starts from the
    card's posteriors and features (``_CardResults``): its k-means++ draw
    is an argmax of Gumbel noise plus log squared distances of gradient
    embeddings, where the two devices' f32 rounding of near-duplicate
    candidates moves log d2 enough to flip a draw (the first card run
    parted at the 8th of 16 picks); on equal inputs the picks agree."""
    subjects = [synthetic_subject(shape=PICKS_SHAPE, n_modalities=2,
                                  n_blobs=3, seed=10 + s) for s in range(3)]
    stats = multimg_stats(subjects)
    spec = create_pw1(2, 0.5, (25, 25, 2))
    models = {"card": init_cnn(spec, 0, dev),
              "host": init_cnn(spec, 0, "cpu")}
    members = {d: [init_cnn(spec, 100 + i, d) for i in range(n_members)]
               for d in (dev, "cpu")}
    grids = [generate_grid_samples(PICKS_SHAPE, 4, m)[0]
             for _, m in subjects]
    trains = [g[s::17] for s, g in enumerate(grids)]
    pools = [np.setdiff1d(g, t) for g, t in zip(grids, trains)]

    def evaluators(d):
        return [GridPoolEvaluator(spec, pad_volumes(v, (25, 25, 1), d),
                                  stats[i, 0::2], stats[i, 1::2],
                                  (25, 25, 1), PICKS_SHAPE, grid_spacing=4,
                                  ntb=4096)
                for i, (v, _) in enumerate(subjects)]

    evs = {"card": evaluators(dev),
           "host": [_memo_evaluate(e) for e in evaluators("cpu")]}

    def contexts(side, m):
        rng = np.random.default_rng(5)
        d = dev if side == "card" else "cpu"
        side_evs = ([_CardResults(e, models["card"]) for e in evs["card"]]
                    if (side, m) == ("host", "BADGE") else evs[side])
        return [strat_mod.QueryContext(
            spec=spec, params=models[side], evaluator=side_evs[s],
            pool_inds=pools[s], k=k, rng=rng, B=B, MC_iters=mc_iters,
            train_inds=trains[s], seed=seed, raw_volume=subjects[s][0][0],
            ensemble_params=members[d], extra={"mask": subjects[s][1]})
            for s in range(3)], rng

    picks, secs, a_calls = {}, {}, []
    plain_a = strat_mod.gather_shrunk_a_matrices

    def spy_a(*a, **kw):
        out = plain_a(*a, **kw)
        a_calls.append((a, out))
        return out

    with KeyedDraws(13):
        for side in ("card", "host"):
            for m in (STRATEGIES if side == "card" else HELD_PICKS):
                ctxs, rng = contexts(side, m)
                strat_mod.gather_shrunk_a_matrices = (
                    spy_a if (side, m) == ("card", "fi") else plain_a)
                try:
                    t0 = time.perf_counter()
                    picks[(m, side)] = strat_mod.query_multimg(ctxs, m, k,
                                                               rng)
                    if side == "card":
                        torch.cuda.synchronize()
                    secs[(m, side)] = time.perf_counter() - t0
                finally:
                    strat_mod.gather_shrunk_a_matrices = plain_a
    res = {"card_s": {m: secs[(m, "card")] for m in STRATEGIES},
           "host_s": {m: secs[(m, "host")] for m in HELD_PICKS},
           "pool_per_subject": [len(p) for p in pools]}
    for m in STRATEGIES:
        got = picks[(m, "card")]
        n = sum(len(g) for g in got)
        check(len(got) == 3 and all(
            len(np.unique(g)) == len(g) and np.all((g >= 0) & (g < len(p)))
            for g, p in zip(got, pools))
            and (n > k if m == "SuPix" else 1 <= n <= k),
            f"multi picks {m} on the card: {[len(g) for g in got]}")
        res.setdefault("picks_per_subject", {})[m] = [len(g) for g in got]
    for m in HELD_PICKS:
        a, b = picks[(m, "card")], picks[(m, "host")]
        same = all(np.array_equal(np.sort(x), np.sort(y))
                   for x, y in zip(a, b))
        check(same, f"multi picks {m} card vs host: card "
              f"{[x.tolist() for x in a]}, host {[y.tolist() for y in b]}")
    # fi: the card's candidates (padded to B) through the host's gather,
    # shrunk gradients and A-matrices
    check(len(a_calls) >= 1, "fi gathered no candidates")
    a_res = []
    for (model, padded, inds, mu, sd, ps, orig, pv, diag), A in a_calls:
        s = next(i for i, e in enumerate(evs["card"]) if e.padded is padded)
        hp = evs["host"][s].padded
        A_host = gather_shrunk_a_matrices(
            models["host"], hp, inds.cpu(), mu.cpu(), sd.cpu(), ps, orig,
            pv.cpu(), diag)
        x = gather_patches_normalized(hp, inds.cpu(), mu.cpu(), sd.cpu(),
                                      ps, orig)
        a_res.append(a_check(f"multi fi A (subject {s})", A.cpu(), A_host,
                             diag, pv.cpu().numpy(),
                             kink_margins(models["host"], x)))
    res["fi_a_matrices"] = a_res
    print(f"multi picks ok: {json.dumps(res)}")
    return res


def multi_subjects():
    """Three training subjects, a test and a held one (128x128x32, two
    modalities)."""
    s = [synthetic_subject(shape=SHAPE, n_modalities=2, n_blobs=3, seed=i)
         for i in range(5)]
    return s[:3], s[3:4], s[4:]


def _multi_expr(root, overrides, dev, subjects):
    cfg = ExperimentConfig.from_pars(set_parameters(DEFAULT_PARS,
                                                    overrides))
    expr = multi_experiment.MultiImgExperiment(root, cfg, device=dev)
    expr.attach_subjects(*subjects)
    return expr


def _multi_campaign(dev, top, runs, tag, subjects):
    """Each run in its own experiment directory (a fresh
    ``MultiImgExperiment`` and its subjects' volumes), 128 queries (64
    for the f32 runs of ``MULTI_ONE_ROUND``): the
    journal, membership, rounds, sub-spans, history copies and each run's
    K1 / K2 launches checked, its checkpoints removed once checked.  The
    launch counts and K2's copy-cache counters are zeroed just before the
    runs and read just after; the copies made must equal the distinct
    volumes gathered from (no copy rebuilt)."""
    out = {"seconds": {}, "phases": {}, "by_method": {}, "peaks": {},
           "rounds": {}}
    ops.reset_launch_counts()
    ops.gather.reset_ycache_stats()
    padded_built = 0
    for name, overrides in runs:
        method = name.split("@")[0]
        key = tag + name
        root = os.path.join(top, name)
        k1_0 = ops.similarity.KERNEL.launches
        k2_0 = ops.gather.KERNEL.launches
        drain_subphases()      # spans left by the phases before this run
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        expr = _multi_expr(root, overrides, dev, subjects)
        expr.prep_data()
        j = expr.add_method(method)
        seeded = 0
        if method == "influence":
            # influence needs labels: 64 global ids seeded
            train_g, pool_g = j.membership()
            seed_g = np.random.default_rng(1).choice(pool_g, 64,
                                                     replace=False)
            j.init_membership(seed_g, np.setdiff1d(pool_g, seed_g))
            seeded = 64
        k = expr.config.query.k
        want = 1 if not tag and name in MULTI_ONE_ROUND else 2
        res = expr.run_method(method, want * k)
        torch.cuda.synchronize()
        out["seconds"][key] = time.perf_counter() - t0
        out["peaks"][key] = torch.cuda.max_memory_allocated()
        padded_built += len(expr._padded)
        sizes = [len(p) for p in expr._pools()]
        n_rounds = len(res["perf"])
        qmats = [np.loadtxt(os.path.join(j.queries_dir, f"{r}.txt"),
                            dtype=np.int64, ndmin=2)
                 for r in range(n_rounds)]
        check(sizes == [len(generate_grid_samples(SHAPE, 2))] * 3,
              f"{key}: pools {sizes}")
        check(res["n_queries"] == want * k
              == sum(q.shape[1] for q in qmats)
              and (n_rounds >= 2 if method == "fi" else n_rounds == want),
              f"{key}: {res['n_queries']} queries in {n_rounds} rounds")
        pools = expr._pools()
        check(all(q.shape[0] == 2 and set(q[1].tolist()) <= {0, 1, 2}
                  and all(v in set(pools[s].tolist()) for v, s in q.T)
                  for q in qmats), f"{key}: journal columns off the pools")
        tr, po = res["train_global"], res["pool_global"]
        check(len(tr) == want * k + seeded == len(set(tr.tolist()))
              and not set(tr.tolist()) & set(po.tolist())
              and len(tr) + len(po) == sum(sizes),
              f"{key}: membership broken")
        check(bool(np.isfinite(res["perf"]).all()),
              f"{key}: non-finite F {res['perf']}")
        dk1 = ops.similarity.KERNEL.launches - k1_0
        dk2 = ops.gather.KERNEL.launches - k2_0
        out["by_method"][key] = {"rowmax_similarity": dk1,
                                 "gather_patches_normalized": dk2}
        # every round's finetune gathers at least one subject's labels
        need = {"fi": 4, "QBC-JS": 5 * want // 2, "influence": 3 * want,
                "entropy@mt": 8}
        check(dk2 >= need.get(name, 2),
              f"{key}: K2 launched {dk2} times")
        if method == "core-set":
            check(dk1 >= 2, f"{key}: K1 launched {dk1} times")
        with open(j.path("phases.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        out["phases"][key] = rows
        rounds = [r for r in rows if not r.get("tail")]
        check(len(rounds) == n_rounds and rows[-1].get("tail")
              and all(("committee" in r) == (method == "QBC-JS")
                      for r in rounds)
              and all(MULTI_SUBS.get(method, set()) <= set(r.get("sub", {}))
                      for r in rounds),
              f"{key}: phases rows {rows}")
        times = os.listdir(os.path.join(root, "AL_running_times"))
        check(len(times) == n_rounds, f"{key}: dt files {times}")
        hist = sorted(f for f in os.listdir(j.dir)
                      if f.startswith("curr_weights_"))
        every = 2 if tag else 1
        check(hist == [f"curr_weights_{r}.npz" for r in
                       range(1, n_rounds + 1) if r % every == 0],
              f"{key}: history copies {hist}")
        with np.load(j.path(hist[0])) as z:
            hd = np.float16 if tag else np.float32
            check(all(z[k].dtype == hd for k in z.files),
                  f"{key}: history dtypes {[z[k].dtype for k in z.files]}")
        if tag:
            with np.load(j.path("curr_weights.npz")) as z:
                al = json.loads(z["__al_state__"].tobytes().decode())
                # the anchor, or the loop end's save after an odd round
                check(al["round"] == n_rounds and any(k.endswith("@i8")
                                                      for k in z.files),
                      f"{key}: anchor {al}")
        if "consistency_coeff" in overrides:
            with np.load(j.path("curr_weights.npz")) as z:
                check(any(k.startswith("teacher/") for k in z.files),
                      f"{key}: no teacher group")
        out["rounds"][key] = [{k: r[k] for k in (
            "score_select", "committee", "train", "eval", "checkpoint",
            "sub") if k in r} for r in rows]
        shutil.rmtree(root, ignore_errors=True)
        print(f"multi campaign {key}: F per round {res['perf'].tolist()}, "
              f"picks per round {[q.shape[1] for q in qmats]}, "
              f"{out['seconds'][key]:.3f} s, K1 +{dk1}, K2 +{dk2}, peak "
              f"{out['peaks'][key] / 2**30:.2f} GiB")
    out["counts"] = {k.name: k.launches for k in ops.KERNELS}
    # K2 in every run; K1 where core-set runs
    for k in ops.KERNELS:
        if k is ops.gather.KERNEL or any(n.startswith("core-set")
                                         for n, _ in runs):
            check(k.launches > 0, f"{k.name} never launched in the multi "
                  f"{tag or 'f32/'} campaign")
    yc = ops.gather.YCACHE_STATS
    out["ycopy"] = {"rebuilds": yc["rebuilds"],
                    "distinct_volumes": yc["volumes"],
                    "padded_volumes_built": padded_built}
    check(len(runs) <= yc["rebuilds"] == yc["volumes"] <= padded_built,
          f"K2's copy cache in the multi {tag or 'f32/'} campaign: "
          f"{out['ycopy']}")
    print(f"K2 y-copy rebuilds in the multi {tag or 'f32/'} campaign: "
          f"{json.dumps(out['ycopy'])}")
    return out


def phase_multi_resume(dev, top, subjects):
    """Multi resume == continue on the card: ``random``, 4 rounds, int8
    anchors every 3 rounds, run uninterrupted; a second run loses its
    resume-point writes for 3 rounds and a fresh ``MultiImgExperiment``
    replays from the initial weights: the final ``curr_weights.npz``, the
    (voxel, subject) journal and ``perf_evals.txt`` bit-identical."""
    def artifacts(root):
        mdir = os.path.join(root, "random")
        with np.load(os.path.join(mdir, "curr_weights.npz")) as z:
            w = {k: z[k] for k in z.files}
        q = {n: open(os.path.join(mdir, "queries", n)).read()
             for n in sorted(os.listdir(os.path.join(mdir, "queries")))}
        with open(os.path.join(mdir, "perf_evals.txt")) as f:
            return w, q, f.read()

    roots = [os.path.join(top, "resume", n) for n in ("a", "b")]
    t0 = time.perf_counter()
    for i, root in enumerate(roots):
        expr = _multi_expr(root, MULTI_RESUME, dev, subjects)
        k = expr.config.query.k
        expr.prep_data()
        expr.add_method("random")
        if i == 0:
            expr.run_method("random", 4 * k)
            a_s = time.perf_counter() - t0
            continue
        orig = multi_experiment.save_checkpoint
        multi_experiment.save_checkpoint, dropped = \
            _suppressed_resume_writes(orig)
        try:
            expr.run_method("random", 3 * k)
        finally:
            multi_experiment.save_checkpoint = orig
        check(len(dropped) == 1, f"multi resume: dropped writes {dropped}")
    t0 = time.perf_counter()
    _multi_expr(roots[1], MULTI_RESUME, dev, subjects).run_method("random",
                                                                  4 * k)
    resume_s = time.perf_counter() - t0
    (wa, qa, ea), (wb, qb, eb) = artifacts(roots[0]), artifacts(roots[1])
    diff = sorted(k for k in set(wa) | set(wb)
                  if k not in wa or k not in wb or wa[k].dtype != wb[k].dtype
                  or not np.array_equal(wa[k], wb[k]))
    res = {"rounds": 4, "ckpt_full_every": 3, "ckpt_dtype": "int8",
           "entries": len(wa), "differing_entries": diff,
           "queries_equal": qa == qb, "perf_evals_equal": ea == eb,
           "uninterrupted_s": a_s, "resume_with_replay_s": resume_s}
    check(not diff and qa == qb and ea == eb and len(qa) == 4
          and any(k.endswith("@i8") for k in wa),
          f"multi resume != continue on the card: {res}")
    shutil.rmtree(os.path.join(top, "resume"), ignore_errors=True)
    print(f"multi resume == continue ok (bit for bit): {json.dumps(res)}")
    return res


def phase_sequential(dev, top):
    """``sequential_al`` over two 64x64x16 subjects (entropy, 64 labels
    to start, one round of 64 each), the second warm-started from the
    first's final weights; a second call resumes and queries nothing."""
    subjects = [synthetic_subject(shape=PICKS_SHAPE, n_modalities=2,
                                  n_blobs=3, seed=20 + s) for s in range(2)]
    cfg = ExperimentConfig.from_pars(set_parameters(
        DEFAULT_PARS, OVERRIDES.replace("synthetic_shape=[128,128,32],", "")
        .replace("init_size=256", "init_size=64")))
    root = os.path.join(top, "sequential")
    t0 = time.perf_counter()
    k = cfg.query.k
    res = sequential_al(root, subjects, "entropy", k, cfg, device=dev)
    secs = time.perf_counter() - t0
    steps = [ckpt.load_checkpoint(os.path.join(
        root, f"subject_{i}", "entropy", "curr_weights.npz"))[3]["step"]
        for i in range(2)]
    again = sequential_al(root, subjects, "entropy", k, cfg, device=dev)
    out = {"n_queries": [r["n_queries"] for r in res],
           "f_measure": [r["perf"].tolist() for r in res],
           "final_steps": steps, "seconds": secs,
           "resumed_n_queries": [r["n_queries"] for r in again]}
    check(out["n_queries"] == [k, k] == out["resumed_n_queries"]
          and steps[1] > steps[0] > 0, f"sequential_al: {out}")
    shutil.rmtree(root, ignore_errors=True)
    print(f"sequential_al ok (warm-started): {json.dumps(out)}")
    return out


def phase_loader(dev, n=8192, b=128, epochs=2):
    """Batches of labeled patches from host-RAM volumes (the campaign
    subject, 2 x 152 x 152 x 56 padded) through the native gather and
    ``PrefetchLoader`` onto the card: each batch equal to the host source's
    and within 1 ulp of K2 on the card's copy of the volume; then the
    loader's rate with a consumer that only reads each batch."""
    vols, mask = synthetic_subject(shape=SHAPE, n_modalities=2, seed=0)
    ps = (25, 25, 1)
    padded = pad_volumes(vols, ps, "cpu")
    host = [padded[j].numpy() for j in range(2)]
    inds = np.random.default_rng(3).choice(int(np.prod(SHAPE)), n,
                                           replace=False)
    mu, sd = np.array([60.0, 75.0]), np.array([30.0, 31.0])
    args = (host, mask, inds, ps, SHAPE, mu, sd, b, 2)
    want = patch_batch_source(*args, np.random.default_rng(0), epochs=1)
    card_vol = padded.to(dev)
    worst = 0.0
    for (x, y), (wx, wy) in zip(prefetched_patch_batches(
            *args, np.random.default_rng(0), epochs=1, device=dev), want):
        check(x.device.type == torch.device(dev).type
              and np.array_equal(x.cpu().numpy(), wx)
              and np.array_equal(y.cpu().numpy(), wy),
              "the loader's batch differs from the host source's")
    bidx = np.random.default_rng(0).permutation(n)[:b]
    k2 = gather_patches_normalized(
        card_vol, torch.as_tensor(inds[bidx]).to(dev),
        torch.tensor(mu, dtype=torch.float32, device=dev),
        torch.tensor(sd, dtype=torch.float32, device=dev), ps, SHAPE).cpu()
    nat = gather_patches_native(host, inds[bidx], ps, SHAPE, mu, sd)
    ulp = np.spacing(np.maximum(np.abs(nat), np.abs(k2.numpy())))
    worst = float((np.abs(nat - k2.numpy()) / ulp).max())
    check(worst <= 1.0, f"native gather vs K2: {worst} ulp")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc = torch.zeros((), device=dev)
    n_batches = 0
    for x, _ in prefetched_patch_batches(*args, np.random.default_rng(1),
                                         epochs=epochs, device=dev):
        acc += x[0, 0, 0, 0]
        n_batches += 1
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    res = {"batches": n_batches, "batch": b, "seconds": secs,
           "batches_per_s": n_batches / secs,
           "patches_per_s": n_batches * b / secs,
           "native_vs_k2_max_ulp": worst}
    print(f"loader ok: {json.dumps(res)}")
    return res


def phase_multi(dev):
    """The multi-subject phases: picks card vs host, the f32 and the bf16
    campaigns, resume == continue, ``sequential_al`` and the loader."""
    top = os.path.join(ROOT, "_smoke_expr", "multi")
    shutil.rmtree(top, ignore_errors=True)
    try:
        picks = phase_multi_picks(dev)
        subjects = multi_subjects()
        f32 = _multi_campaign(dev, top, MULTI_RUNS, "", subjects)
        bf16 = _multi_campaign(dev, os.path.join(top, "bf16"),
                               MULTI_BF16_RUNS, "bf16/", subjects)
        resume = phase_multi_resume(dev, top, subjects)
        seq = phase_sequential(dev, top)
        loader = phase_loader(dev)
        return {"picks": picks, "f32": f32, "bf16": bf16, "resume": resume,
                "sequential": seq, "loader": loader}
    finally:
        shutil.rmtree(top, ignore_errors=True)


# ------------------------------------------------------------ dense models
def dense_flops(spec, hw) -> float:
    """FLOPs (2 per multiply-add) of the convs and transposed convs of
    one forward of ``spec`` on an ``hw`` slice, from the spec's shapes."""
    total = 0.0
    model = CNN(spec)
    h, w = hw
    sizes = {"__input__": (h, w)}
    prev = "__input__"
    for layer in spec.layers:
        src = layer.sources[0] if layer.sources else prev
        hh, ww = (min(sizes[s][0] for s in layer.sources),
                  min(sizes[s][1] for s in layer.sources)) \
            if layer.sources else sizes[src]
        if layer.kind in ("conv", "convT"):
            W = getattr(model, layer.name).weight
            macs_per_pixel = W.numel()          # out * in * kh * kw
            if layer.kind == "conv":
                out_hw = (hh, ww)
                total += 2.0 * macs_per_pixel * hh * ww
            else:
                out_hw = (hh * layer.strides[0], ww * layer.strides[1])
                total += 2.0 * macs_per_pixel * hh * ww
            sizes[layer.name] = out_hw
        elif layer.kind in ("pool", "avgpool"):
            sizes[layer.name] = (-(-hh // layer.strides[0]),
                                 -(-ww // layer.strides[1]))
        prev = layer.name
    return total


def _dense_subject():
    vols, mask = synthetic_subject(shape=SHAPE, n_modalities=2, n_blobs=3,
                                   seed=0)
    stats = multimg_stats([(vols, mask)])[0]
    inds, _ = generate_grid_samples(SHAPE, 2, mask)
    pool, _ = even_odd_slice_split(inds, SHAPE)
    return vols, mask, stats[0::2], stats[1::2], pool


def _state_rel(got, want) -> float:
    """max |got - want| / max |want| over every BN statistic."""
    return max(float((got[l][k].cpu() - want[l][k].cpu()).abs().max()
                     / want[l][k].abs().max().clamp(min=1e-30))
               for l in want for k in ("mean", "var"))


def _param_rel(a, b) -> float:
    sa, sb = a.state_dict(), b.state_dict()
    return max(float((sa[n].cpu() - sb[n].cpu()).abs().max()
                     / sb[n].abs().max().clamp(min=1e-30)) for n in sb)


def phase_dense_parity(dev, n=4, seed=31):
    """Full-width FC-DenseNet-103 card vs host from one seed's weights:
    the forward in eval mode (running statistics) and train mode (batch
    statistics, the moved state), one finetune step with the same dropout
    uniforms (``KeyedDraws``) and plain SGD, plain and under the mean
    teacher, then the BN refresh; and seconds per Adam step of each."""
    vols, mask, mu, sd, pool = _dense_subject()
    spec = create_model("Tiramisu", nclass=2, input_shape=(128, 128, 2),
                        dropout_rate=0.2)
    host = init_cnn(spec, seed, device="cpu")
    n_params = sum(p.numel() for p in host.parameters())
    check(len(spec.layers) == 108 and abs(n_params - 9.32e6) < 0.01e6,
          f"FC-DenseNet-103: {len(spec.layers)} rows, {n_params} params")
    gflop = dense_flops(spec, (128, 128)) / 1e9
    check(abs(gflop - DENSE_GFLOP) < 0.1, f"{gflop} GFLOP per slice")
    slices = torch.from_numpy(normalized_slices(vols, mu, sd))
    x = slices[:n].contiguous()
    # a running state off its init: a refresh over 8 slices at decay 0.6
    bn = bn_refresh(host, host.init_state(), slices[8:16], 0.6)
    card = copy.deepcopy(host).to(dev)
    bn_c = {l: {k: v.to(dev) for k, v in d.items()} for l, d in bn.items()}
    res = {"spec_rows": len(spec.layers), "params": n_params,
           "gflop_per_slice": gflop}
    with torch.no_grad():
        for mode in ("eval", "train"):
            tr = mode == "train"
            oh = host(x, train=tr, state=bn, bn_decay=0.9)
            oc = card(x.to(dev), train=tr, state=bn_c, bn_decay=0.9)
            res[mode] = {
                "posteriors": float((oc.posteriors.cpu()
                                     - oh.posteriors).abs().max()),
                "feature_rel": float((oc.feature.cpu() - oh.feature).abs()
                                     .max() / oh.feature.abs().max()),
                "state_rel": _state_rel(oc.state, oh.state)}
            check(res[mode]["posteriors"] <= 1e-4
                  and res[mode]["state_rel"] <= 1e-4
                  and res[mode]["feature_rel"] <= 1e-4,
                  f"dense forward {mode} card vs host: {res[mode]}")
    # one finetune step: 4 slices, ~2% of their pixels labeled.  The f32
    # gradient of this 108-layer net with batch-statistic BN is only good
    # to ~2e-3 of the update (host and card alike, against float64), so
    # both are held to a float64 step on the card, the card no worse
    # than the host; the parameters themselves are reported card vs host
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, 2, (n, 128, 128))
    y = torch.from_numpy(np.eye(2, dtype=np.float32)[lab])
    wpix = (rng.random((n, 128, 128)) < 0.02).astype(np.float32)
    idx, w = np.arange(n)[None], np.ones((1, n), np.float32)
    xu = slices[16:16 + n].contiguous()

    def stepped(device, mt, dtype=torch.float32):
        m = copy.deepcopy(host).to(device, dtype)
        st = init_train_state(m, "SGD", 0.1)
        mt_obj = None
        if mt:
            st.teacher = make_teacher(m)
            mt_obj = MeanTeacher(xu_all=xu.to(device, dtype),
                                 u_idx=idx.copy(), coeff=1.0, ramp=20,
                                 ema_decay=0.99)
        with deterministic_cudnn():
            finetune_fcn_steps(st, x.to(device, dtype), y.to(device, dtype),
                               wpix, idx, w, 5, mt=mt_obj)
        return m, st.teacher

    def cpu64(mod):
        return {k: v.detach().cpu().double()
                for k, v in mod.state_dict().items()}

    p0 = {k: v.double() for k, v in host.state_dict().items()}

    def update_err(p, want):
        """max |update - float64 update| over max |float64 update|."""
        big = max(float((want[k] - p0[k]).abs().max()) for k in p0)
        return max(float((p[k] - want[k]).abs().max()) for k in p0) / big

    for mt in (False, True):
        name = "step_mt" if mt else "step"
        with KeyedDraws(seed):
            (mh, th), (mc, tc) = stepped("cpu", mt), stepped(dev, mt)
            m64, t64 = stepped(dev, mt, torch.float64)
        sh, sc, s64 = cpu64(mh), cpu64(mc), cpu64(m64)
        r = {"update_err_card": update_err(sc, s64),
             "update_err_host": update_err(sh, s64),
             "params_card_vs_host": max(
                 float((sc[k] - sh[k]).abs().max()) for k in p0)
             / max(float(sh[k].abs().max()) for k in p0)}
        if mt:
            r["teacher_err_card"] = update_err(cpu64(tc), cpu64(t64))
            r["teacher_err_host"] = update_err(cpu64(th), cpu64(t64))
        # the BN refresh on one set of stepped weights (the float64
        # step's, in f32) card vs host, as the forward checks above
        m32 = m64.float().cpu()
        with deterministic_cudnn():
            bh = bn_refresh(m32, bn, x, 0.6)
            bcard = bn_refresh(copy.deepcopy(m32).to(dev), bn_c,
                               x.to(dev), 0.6)
        r["bn_refresh_rel"] = _state_rel(bcard, bh)
        res[name] = r
        pairs = [("update_err_card", "update_err_host")]
        if mt:
            pairs.append(("teacher_err_card", "teacher_err_host"))
        check(all(r[c] <= max(2.0 * r[h], r[h] + 1e-4) and r[c] <= 1e-2
                  for c, h in pairs) and r["bn_refresh_rel"] <= 1e-4,
              f"dense finetune {name}: {r}")
        del mh, mc, m64, m32
    # seconds per Adam step on the card (own generators), plain and MT
    secs = {}
    for mt in (False, True):
        m = copy.deepcopy(card)
        st = init_train_state(m, "Adam", 1e-3)
        mt_obj = None
        if mt:
            st.teacher = make_teacher(m)
            mt_obj = MeanTeacher(xu_all=xu.to(dev), u_idx=idx.copy(),
                                 coeff=1.0)
        xs, ys = x.to(dev), y.to(dev)
        times = []
        with deterministic_cudnn():
            for r in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                finetune_fcn_steps(st, xs, ys, wpix, idx, w, 7 + r,
                                   mt=mt_obj)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        secs["mt" if mt else "plain"] = min(times[1:])
        del m, st
    res["adam_step_s"] = secs
    print(f"dense parity ok (FC-DenseNet-103, {n_params} params, "
          f"{gflop:.3f} GFLOP a 128x128x2 slice): {json.dumps(res)}")
    return res, card, bn_c, (vols, mask, mu, sd, pool)


def phase_dense_sweep(dev, card, bn_c, subject, reps=3):
    """The whole-slice sweep at f32 and bf16 (32 slices, batches of 4):
    slices/s and TFLOP/s at ``DENSE_GFLOP`` per slice, peak memory, and
    the bf16 sweep's top-``TOP_B`` uncertainty overlap with the f32 one
    (tie-aware, as the bf16 FIM sweep's)."""
    vols, _, mu, sd, pool = subject
    out, unc = {}, {}
    for cd in (None, torch.bfloat16):
        ev = FCNGridPoolEvaluator(card.spec, vols, mu, sd, SHAPE,
                                  compute_dtype=cd, bn_state=bn_c,
                                  device=dev)
        name = "float32" if cd is None else "bfloat16"
        ev._sweep(card, None, False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = []
        for _ in range(reps):
            t0 = time.perf_counter()
            ev._sweep(card, None, False)
            torch.cuda.synchronize()
            t.append(time.perf_counter() - t0)
        best = min(t)
        z = ev.slices.shape[0]
        out[name] = {"seconds": best, "slices_per_s": z / best,
                     "tflops": z * DENSE_GFLOP / best / 1e3,
                     "peak_bytes": torch.cuda.max_memory_allocated()}
        p1 = ev.evaluate(card, pool, ("posteriors",),
                         as_device=True)["posteriors"]
        unc[name] = (p1.float() - 0.5).abs()
    top = {k: torch.argsort(u, stable=True)[:TOP_B] for k, u in unc.items()}
    kth = unc["bfloat16"][top["bfloat16"][-1]]
    out["top_b_vs_f32"] = {
        "B": TOP_B, "overlap": len(set(top["float32"].tolist())
                                   & set(top["bfloat16"].tolist())),
        "f32_picks_within_bf16_cut": int(
            (unc["bfloat16"][top["float32"]] <= kth).sum())}
    check(out["top_b_vs_f32"]["f32_picks_within_bf16_cut"] >= 0.8 * TOP_B,
          f"dense bf16 ranks vs f32: {out['top_b_vs_f32']}")
    print(f"dense sweep ok (32 slices of 128x128x2, batches of 4): "
          f"{json.dumps(out)}")
    return out


def phase_dense_k1(dev, card, bn_c, subject):
    """K1 at the dense path's d = 16: P the campaign pool's per-pixel
    features (65,536 x 16), R 256 and 512 x 16 of them, and a ragged
    320, against the plain version within 1e-5; ms beside the bound."""
    vols, _, mu, sd, pool = subject
    ev = FCNGridPoolEvaluator(card.spec, vols, mu, sd, SHAPE, bn_state=bn_c,
                              device=dev)
    F = ev.evaluate(card, pool, ("feature_layer",),
                    as_device=True)["feature_layer"]
    P = normalize_rows(F).contiguous()
    n, d = P.shape
    check((n, d) == (65536, 16), f"dense pool features {tuple(P.shape)}")
    gen = torch.Generator().manual_seed(3)
    R = P[torch.randperm(n, generator=gen)[:512].to(dev)].contiguous()
    base = ops.similarity.KERNEL.launches
    errs = {}
    for m in (256, 512, 320):
        Rm = R[:m].contiguous()
        got = rowmax_similarity(P, Rm)
        torch.cuda.synchronize()
        errs[f"R{m}"] = float((got - rowmax_similarity_plain(P, Rm))
                              .abs().max())
    check(all(e <= 1e-5 for e in errs.values()),
          f"K1 at d = 16: max |delta| {errs}")
    times = {}
    for m in (512, 256):
        Rm = R[:m].contiguous()
        times[m] = (time_ms(lambda: rowmax_similarity(P, Rm), reps=50),
                    time_ms(lambda: rowmax_similarity_plain(P, Rm), reps=50),
                    time_ms(lambda: torch.matmul(P, Rm.T).amax(dim=1),
                            reps=50))
    ops.similarity.KERNEL.launches = base
    rows = {}
    for m in (512, 256):
        flops, nbytes = 2.0 * n * m * d, (n * d + m * d + n) * 4
        b_ms, b_by = bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
        rows[m] = {"ms": times[m][0], "plain_ms": times[m][1],
                   "library_ms": times[m][2], "bound_ms": b_ms,
                   "bound_by": b_by,
                   "bytes_bound_ms": nbytes / PEAK_HBM_BYTES * 1e3}
    res = {"errors": errs, "shapes": {"P": [n, d], "R": [512, d]},
           "at_R512": rows[512], "at_R256": rows[256]}
    print(f"K1 at d = 16 ok: {json.dumps(res)}")
    return res


def _dense_run_checks(key, method, root, res, n_rounds, dk1, dk2, k=64):
    picks = [np.atleast_1d(np.loadtxt(
        os.path.join(root, method, "queries", f"{i}.txt"), dtype=np.int64))
        for i in range(len(res["perf"]))]
    check(len(res["perf"]) == n_rounds
          and res["n_queries"] == sum(len(q) for q in picks)
          and all(1 <= len(q) <= k for q in picks)
          and (method == "fi" or res["n_queries"] == k * n_rounds),
          f"{key}: {res['n_queries']} queries, picks "
          f"{[len(q) for q in picks]}")
    check(bool(np.isfinite(res["perf"]).all()), f"{key}: F {res['perf']}")
    # the dense path gathers no patches; core-set's similarity is K1
    check(dk2 == 0, f"{key}: K2 launched {dk2} times on the dense path")
    if method == "core-set":
        check(dk1 >= n_rounds, f"{key}: K1 launched {dk1} times")
    with np.load(os.path.join(root, method, "curr_weights.npz")) as z:
        files = z.files
    check(any(f.startswith("bn/") for f in files),
          f"{key}: no bn/ group in the resume point")
    return picks


def _dense_campaign(dev, top, runs, tag):
    """2 rounds (1 for ``DENSE_ONE_ROUND``) of each run through
    ``do_expr`` on the campaign subject, launch counts zeroed just before
    each run and read just after."""
    out = {"seconds": {}, "phases": {}, "by_method": {}, "peaks": {}}
    ops.reset_launch_counts()
    for name, overrides in runs:
        method = name.split("@")[0]
        key = tag + name
        root = os.path.join(top, name)
        n_rounds = 1 if not tag and name in DENSE_ONE_ROUND else 2
        k1_0 = ops.similarity.KERNEL.launches
        k2_0 = ops.gather.KERNEL.launches
        drain_subphases()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = do_expr(root, method, 64 * n_rounds, overrides,
                      synthetic=True, device=str(dev))
        out["seconds"][key] = time.perf_counter() - t0
        out["peaks"][key] = torch.cuda.max_memory_allocated()
        dk1 = ops.similarity.KERNEL.launches - k1_0
        dk2 = ops.gather.KERNEL.launches - k2_0
        out["by_method"][key] = {"rowmax_similarity": dk1,
                                 "gather_patches_normalized": dk2}
        picks = _dense_run_checks(key, method, root, res, n_rounds, dk1,
                                  dk2)
        with open(os.path.join(root, method, "phases.jsonl")) as f:
            out["phases"][key] = [json.loads(line) for line in f]
        rounds = [r for r in out["phases"][key] if not r.get("tail")]
        check(all(("committee" in r) == (method == "QBC-JS")
                  for r in rounds), f"{key}: committee phase rows {rounds}")
        if method == "fi":
            check(all({"fi/posteriors", "fi/filter", "fi/gather_grads_A",
                       "fi/sdp", "fi/pmf"} <= set(r.get("sub", {}))
                      for r in rounds), f"{key}: fi sub-spans {rounds}")
        if "consistency_coeff" in overrides:
            with np.load(os.path.join(root, method,
                                      "curr_weights.npz")) as z:
                check(any(f.startswith("teacher/") for f in z.files),
                      f"{key}: no teacher group")
        _drop_checkpoints(root)
        print(f"dense campaign {key}: F per round {res['perf'].tolist()}, "
              f"picks per round {[len(q) for q in picks]}, "
              f"{out['seconds'][key]:.3f} s, K1 +{dk1}, K2 +{dk2}, peak "
              f"{out['peaks'][key] / 2**30:.2f} GiB")
    out["counts"] = {k.name: k.launches for k in ops.KERNELS}
    check(out["counts"]["rowmax_similarity"] > 0
          or all(n.split("@")[0] != "core-set" for n, _ in runs),
          f"K1 never launched in the dense {tag or 'f32/'} campaign")
    return out


def phase_dense_resume(dev, top):
    """Dense resume == continue on the card: 3 rounds of entropy with
    int8 anchors every 2; the second run loses its resume-point writes
    for 2 rounds and a fresh ``PWExperiment`` replays both finetunes (and
    their BN refreshes) from the initial weights: ``curr_weights.npz``
    (``bn/`` included), the journal and ``perf_evals.txt`` bit-identical."""
    vols, mask = synthetic_subject(shape=SHAPE, n_modalities=2, n_blobs=3,
                                   seed=0)
    pars = set_parameters(DEFAULT_PARS, DENSE_RESUME)

    def fresh(root):
        expr = pw_experiment.PWExperiment(
            root, ExperimentConfig.from_pars(pars), device=dev)
        expr.attach_subject(vols, mask)
        return expr

    def artifacts(root):
        mdir = os.path.join(root, "entropy")
        with np.load(os.path.join(mdir, "curr_weights.npz")) as z:
            w = {k: z[k] for k in z.files}
        q = {f: open(os.path.join(mdir, "queries", f)).read()
             for f in sorted(os.listdir(os.path.join(mdir, "queries")))}
        with open(os.path.join(mdir, "perf_evals.txt")) as f:
            return w, q, f.read()

    roots = [os.path.join(top, "resume", n) for n in ("a", "b")]
    t0 = time.perf_counter()
    for i, root in enumerate(roots):
        expr = fresh(root)
        expr.prep_data()
        expr.add_method("entropy")
        if i == 0:
            expr.run_method("entropy", 192)
            a_s = time.perf_counter() - t0
            continue
        orig = pw_experiment.save_checkpoint
        pw_experiment.save_checkpoint, dropped = \
            _suppressed_resume_writes(orig)
        try:
            expr.run_method("entropy", 128)
        finally:
            pw_experiment.save_checkpoint = orig
        check(len(dropped) == 1, f"dense resume: dropped writes {dropped}")
    t0 = time.perf_counter()
    fresh(roots[1]).run_method("entropy", 192)
    resume_s = time.perf_counter() - t0
    (wa, qa, ea), (wb, qb, eb) = artifacts(roots[0]), artifacts(roots[1])
    diff = sorted(k for k in set(wa) | set(wb)
                  if k not in wa or k not in wb or wa[k].dtype != wb[k].dtype
                  or not np.array_equal(wa[k], wb[k]))
    res = {"rounds": 3, "ckpt_full_every": 2, "ckpt_dtype": "int8",
           "entries": len(wa), "differing_entries": diff,
           "bn_entries": sum(k.startswith("bn/") for k in wa),
           "queries_equal": qa == qb, "perf_evals_equal": ea == eb,
           "uninterrupted_s": a_s, "resume_with_replay_s": resume_s}
    check(not diff and qa == qb and ea == eb and len(qa) == 3
          and res["bn_entries"] > 0 and any(k.endswith("@i8") for k in wa),
          f"dense resume != continue on the card: {res}")
    shutil.rmtree(os.path.join(top, "resume"), ignore_errors=True)
    print(f"dense resume == continue ok (bit for bit): {json.dumps(res)}")
    return res


def phase_dense_multi(dev, top):
    """The multi-subject dense campaign: entropy (128 queries, 2 rounds)
    and fi (64) over two 128x128x32 subjects and one 96x96x32, so two
    shape groups train; a 128x128x32 test subject and a held one."""
    s = [synthetic_subject(shape=sh, n_modalities=2, n_blobs=3, seed=i)
         for i, sh in enumerate((SHAPE, SHAPE, (96, 96, 32), SHAPE, SHAPE))]
    subjects = (s[:3], s[3:4], s[4:])
    out = {"seconds": {}, "phases": {}, "by_method": {}, "peaks": {}}
    ops.reset_launch_counts()
    for name, overrides, budget in DENSE_MULTI_RUNS:
        root = os.path.join(top, "multi", name)
        expr = _multi_expr(root, overrides, dev, subjects)
        expr.prep_data()
        expr.add_method(name)
        k1_0 = ops.similarity.KERNEL.launches
        k2_0 = ops.gather.KERNEL.launches
        drain_subphases()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = expr.run_method(name, budget)
        out["seconds"][name] = time.perf_counter() - t0
        out["peaks"][name] = torch.cuda.max_memory_allocated()
        dk2 = ops.gather.KERNEL.launches - k2_0
        out["by_method"][name] = {
            "rowmax_similarity": ops.similarity.KERNEL.launches - k1_0,
            "gather_patches_normalized": dk2}
        qdir = os.path.join(root, name, "queries")
        qs = [np.loadtxt(os.path.join(qdir, f"{i}.txt"),
                         dtype=np.int64).reshape(2, -1)
              for i in range(len(res["perf"]))]
        check(len(res["perf"]) >= budget // 64 and dk2 == 0
              and bool(np.isfinite(res["perf"]).all())
              and res["n_queries"] == sum(q.shape[1] for q in qs) == budget,
              f"dense multi {name}: {res['n_queries']} queries, F "
              f"{res['perf']}, K2 +{dk2}")
        check(all(ev.bn_state is expr._bn_sync for ev in expr._test_evs),
              f"dense multi {name}: test evaluators off the BN state")
        with open(os.path.join(root, name, "phases.jsonl")) as f:
            out["phases"][name] = [json.loads(line) for line in f]
        _drop_checkpoints(root)
        print(f"dense multi campaign {name}: F per round "
              f"{res['perf'].tolist()}, picks per round "
              f"{[q.shape[1] for q in qs]} (subjects "
              f"{[np.bincount(q[1], minlength=3).tolist() for q in qs]}), "
              f"{out['seconds'][name]:.3f} s, peak "
              f"{out['peaks'][name] / 2**30:.2f} GiB")
    out["counts"] = {k.name: k.launches for k in ops.KERNELS}
    return out


def phase_dense(dev):
    """The dense-model phases (FC-DenseNet-103, module docstring)."""
    top = os.path.join(ROOT, "_smoke_expr", "dense")
    shutil.rmtree(top, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        parity, card, bn_c, subject = phase_dense_parity(dev)
        sweep = phase_dense_sweep(dev, card, bn_c, subject)
        k1 = phase_dense_k1(dev, card, bn_c, subject)
        del card, bn_c
        f32 = _dense_campaign(dev, top, DENSE_RUNS, "")
        bf16 = _dense_campaign(dev, os.path.join(top, "bf16"),
                               DENSE_BF16_RUNS, "bf16/")
        resume = phase_dense_resume(dev, top)
        multi = phase_dense_multi(dev, top)
        return {"parity": parity, "sweep": sweep, "k1": k1, "f32": f32,
                "bf16": bf16, "resume": resume, "multi": multi,
                "seconds": time.perf_counter() - t0}
    finally:
        shutil.rmtree(top, ignore_errors=True)


def cls_flops(spec) -> float:
    """FLOPs (2 per multiply-add) of one image's forward through the
    convs and fcs of a classification spec, from its traced shapes."""
    total = 0.0
    for layer, (in_c, in_d, out) in zip(spec.layers,
                                        cnn_mod._trace_channels(spec)):
        if layer.kind == "conv":
            total += 2.0 * np.prod(out) * np.prod(layer.ksize) * in_c
        elif layer.kind == "fc":
            total += 2.0 * in_d * layer.out
    return float(total)


def cls_dataset(dev, n, hw, nclass=CLS_NCLASS, sigma=1.0, seed=0):
    """``benchmarks/cls_campaigns.make_dataset``'s oriented gratings (one
    orientation per class, random phase) under additive noise, at hw x hw
    x 3 with the period scaled by hw / 16; drawn on the card in chunks and
    kept as a host float32 array, as a user's image pool is."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    y = torch.randint(0, nclass, (n,), generator=gen, device=dev)
    yy, xx = torch.meshgrid(torch.arange(hw, device=dev, dtype=torch.float32),
                            torch.arange(hw, device=dev, dtype=torch.float32),
                            indexing="ij")
    angles = np.pi * torch.arange(nclass, device=dev) / nclass
    period = 6.0 * hw / 16.0
    X = np.empty((n, hw, hw, 3), np.float32)
    for lo in range(0, n, 256):
        yc = y[lo:lo + 256]
        phase = 2 * np.pi * torch.rand(len(yc), generator=gen, device=dev)
        t = (torch.cos(angles[yc])[:, None, None] * xx
             + torch.sin(angles[yc])[:, None, None] * yy)
        g = torch.sin(2 * np.pi * t / period + phase[:, None, None])
        x = g[..., None] + sigma * torch.randn((len(yc), hw, hw, 3),
                                               generator=gen, device=dev)
        X[lo:lo + len(yc)] = x.cpu().numpy()
    return X, y.cpu().numpy()


def _update_errs(p, want, p0):
    """(max |update - float64 update| over max |float64 update|, the same
    in the 2-norm over every parameter)."""
    big = max(float((want[k] - p0[k]).abs().max()) for k in p0)
    worst = max(float((p[k] - want[k]).abs().max()) for k in p0)
    num = sum(float(((p[k] - want[k]) ** 2).sum()) for k in p0)
    den = sum(float(((want[k] - p0[k]) ** 2).sum()) for k in p0)
    return worst / big, (num / den) ** 0.5


def phase_cls_parity(dev, X, y, seed=41):
    """AlexNet at 227x227x3 card vs host from one seed's weights: the
    posteriors and fc7 features of 4 images, one SGD and one Adam (eps
    1e-3) step of ``make_train_step`` on a padded batch of 32 with the
    same dropout uniforms (``KeyedDraws``), each device's update held to a
    float64 step on the card within 1e-2 of its size (in the 2-norm, and
    at its worst element for SGD); VGG19 at 224x224x3 on 2 images; the pool
    sweep's images/s and TFLOP/s at f32 and bf16; seconds per Adam
    step."""
    spec = create_model("Alex", nclass=CLS_NCLASS, dropout_rate=0.5,
                        input_shape=(CLS_HW, CLS_HW, 3))
    host = init_cnn(spec, seed, device="cpu")
    n_params = sum(p.numel() for p in host.parameters())
    gflop = cls_flops(spec) / 1e9
    check(n_params == 71_945_608 and abs(gflop - 2.5244) < 1e-3,
          f"AlexNet: {n_params} params, {gflop} GFLOP")
    card = copy.deepcopy(host).to(dev)
    res = {"params": n_params, "gflop_per_image": gflop}
    x4 = torch.from_numpy(X[:4])
    with torch.no_grad():
        oh, oc = host(x4), card(x4.to(dev))
    res["posteriors"] = float((oc.posteriors.cpu() - oh.posteriors)
                              .abs().max())
    res["feature_rel"] = float((oc.feature.cpu() - oh.feature).abs().max()
                               / oh.feature.abs().max())
    check(res["posteriors"] <= 1e-5 and res["feature_rel"] <= 1e-4,
          f"AlexNet forward card vs host: {res}")
    # one step on the engine's padded batch: 28 images and 4 zero rows of
    # weight 0, one-hots, the inverse-frequency class weights
    b, n_real = 32, 28
    xb = X[:b].copy()
    xb[n_real:] = 0.0
    lab = y[:b].copy()
    lab[n_real:] = 0
    w = (np.arange(b) < n_real).astype(np.float32)
    cw = np.bincount(lab[:n_real], minlength=CLS_NCLASS).astype(np.float64)
    cw = (cw.sum() / np.maximum(cw, 1.0))
    cw = (cw / cw.sum() * CLS_NCLASS).astype(np.float32)
    onehot = np.eye(CLS_NCLASS, dtype=np.float32)[lab]
    p0 = {k: v.double() for k, v in host.state_dict().items()}

    def stepped(device, opt, dtype=torch.float32):
        m = copy.deepcopy(host).to(device, dtype)
        o = (torch.optim.SGD(m.parameters(), lr=0.01) if opt == "sgd" else
             torch.optim.Adam(m.parameters(), lr=1e-3, eps=1e-3))
        st = TrainState(model=m, optimizer=o, step=3)

        def t(a):
            return torch.from_numpy(a).to(device, dtype)

        with deterministic_cudnn():
            make_train_step(mc_t=10)(st, t(xb), t(onehot), 17, t(w), None,
                                     t(cw), 1.0)
        return {k: v.detach().cpu().double()
                for k, v in m.state_dict().items()}

    for opt in ("sgd", "adam"):
        with KeyedDraws(seed):
            sh, sc = stepped("cpu", opt), stepped(dev, opt)
            s64 = stepped(dev, opt, torch.float64)
        (mc, nc), (mh, nh) = _update_errs(sc, s64, p0), _update_errs(
            sh, s64, p0)
        r = {"update_err_card": mc, "update_err_host": mh,
             "update_norm_err_card": nc, "update_norm_err_host": nh,
             "params_card_vs_host": max(float((sc[k] - sh[k]).abs().max())
                                        for k in p0)}
        res[f"step_{opt}"] = r
        # f32 puts AlexNet's forward ~2e-6 off float64, which moves some
        # argmaxes of the overlapping 3x3 max-pools: the f32 update is only
        # good to ~1e-3 of its size on either device (a wrong mask, weight
        # or pad would be off by O(0.1-1)).  Adam's first step divides
        # each entry by its own |g|, so an entry a moved argmax touches
        # may move by lr: its worst element says nothing, its norm does
        worst_ok = opt == "adam" or max(mc, mh) <= 1e-2
        check(worst_ok and max(nc, nh) <= 1e-2,
              f"AlexNet {opt} step card vs float64: {r}")
        del sh, sc, s64
    # seconds per Adam step (eps 1e-8, the engine's) on the card
    st = TrainState(model=copy.deepcopy(card),
                    optimizer=None, step=0)
    st.optimizer = make_optimizer("Adam", 1e-3, st.model.parameters())
    fn = make_train_step(mc_t=10)
    args = [torch.from_numpy(a).to(dev) for a in (xb, onehot, w, cw)]
    times = []
    with deterministic_cudnn():
        for r in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(st, args[0], args[1], 100 + r, args[2], None, args[3], 1.0)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    res["adam_step_s"] = min(times[1:])
    del st
    # VGG19 at 224x224x3: 2 images card vs host
    vspec = create_model("VGG19", nclass=CLS_NCLASS, dropout_rate=0.5,
                         input_shape=(CLS_VGG_HW, CLS_VGG_HW, 3))
    vhost = init_cnn(vspec, seed, device="cpu")
    xv = torch.from_numpy(np.ascontiguousarray(
        X[4:6, :CLS_VGG_HW, :CLS_VGG_HW]))
    with torch.no_grad():
        vh = vhost(xv)
        vc = copy.deepcopy(vhost).to(dev)(xv.to(dev))
    res["vgg19"] = {"params": sum(p.numel() for p in vhost.parameters()),
                    "gflop_per_image": cls_flops(vspec) / 1e9,
                    "posteriors": float((vc.posteriors.cpu() - vh.posteriors)
                                        .abs().max()),
                    "feature_rel": float((vc.feature.cpu() - vh.feature)
                                         .abs().max()
                                         / vh.feature.abs().max())}
    check(res["vgg19"]["posteriors"] <= 1e-5
          and res["vgg19"]["feature_rel"] <= 1e-4,
          f"VGG19 forward card vs host: {res['vgg19']}")
    del vhost, vh, vc
    # the pool sweep (posteriors + features, chunks of 256 from host
    # memory) at f32 and bf16, and the forward of one resident chunk
    sweep = {}
    xs = torch.from_numpy(X[:256]).to(dev)
    for name, cd in (("float32", None), ("bfloat16", torch.bfloat16)):
        cls_mod.batched_forward(spec, card, X[:512], 256,
                                ("posteriors", "feature_layer"),
                                as_device=True, compute_dtype=cd)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cls_mod.batched_forward(spec, card, X, 256,
                                ("posteriors", "feature_layer"),
                                as_device=True, compute_dtype=cd)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        with torch.no_grad():
            fwd_ms = time_ms(lambda: card(xs if cd is None else xs.to(cd)),
                             reps=5)
        sweep[name] = {"seconds": sec, "images_per_s": len(X) / sec,
                       "tflops": len(X) * gflop / sec / 1e3,
                       "peak_bytes": torch.cuda.max_memory_allocated(),
                       "resident_chunk_ms": fwd_ms,
                       "resident_tflops": 256 * gflop / fwd_ms}
    res["sweep"] = sweep
    print(f"cls parity ok (AlexNet {n_params} params, {gflop:.4f} GFLOP an "
          f"image; VGG19 {res['vgg19']['params']} params, "
          f"{res['vgg19']['gflop_per_image']:.3f} GFLOP): "
          f"{json.dumps(res)}")
    return res, spec, card


def phase_cls_k1(dev, spec, card, X):
    """K1 at the classification shape: P the campaign pool's ``pad_rows``
    bucket (3,257 AlexNet fc7 rows zero-padded to 4,096) x 4096, R the
    labeled bucket of rounds 0 and 1 (20 and 30 rows, repeat-padded to
    256) x 4096, against the plain version within 1e-5; ms beside the
    bound and ``matmul + amax``."""
    n_pool = CLS_N - int(0.2 * CLS_N) - 20
    F = cls_mod.batched_forward(spec, card, X[:n_pool + 30], 256,
                                ("feature_layer",),
                                as_device=True)["feature_layer"]
    P = normalize_rows(rep_mod.pad_rows(F[:n_pool])[0]).contiguous()
    n, d = P.shape
    check((n, d) == (4096, 4096), f"cls pool bucket {tuple(P.shape)}")
    base = ops.similarity.KERNEL.launches
    errs, Rs = {}, {}
    for m in (20, 30):
        R = normalize_rows(rep_mod.pad_rows_repeat(F[n_pool:n_pool + m],
                                                   256)).contiguous()
        Rs[m] = R
        got = rowmax_similarity(P, R)
        torch.cuda.synchronize()
        errs[f"labeled{m}"] = float((got - rowmax_similarity_plain(P, R))
                                    .abs().max())
    check(all(e <= 1e-5 for e in errs.values()),
          f"K1 at the classification shape: max |delta| {errs}")
    R = Rs[30]
    ms = time_ms(lambda: rowmax_similarity(P, R), reps=50)
    plain = time_ms(lambda: rowmax_similarity_plain(P, R), reps=20)
    lib = time_ms(lambda: torch.matmul(P, R.T).amax(dim=1), reps=50)
    ops.similarity.KERNEL.launches = base
    m = R.shape[0]
    flops, nbytes = 2.0 * n * m * d, (n * d + m * d + n) * 4
    b_ms, b_by = bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
    res = {"errors": errs, "shapes": {"P": [n, d], "R": [m, d]},
           "ms": ms, "plain_ms": plain, "library_ms": lib,
           "bound_ms": b_ms, "bound_by": b_by,
           "bytes_bound_ms": nbytes / PEAK_HBM_BYTES * 1e3}
    print(f"K1 at the classification shape ok: {json.dumps(res)}")
    return res


def _drop_method_npz(root, method):
    mdir = os.path.join(root, "0", method)
    if os.path.isdir(mdir):
        _drop_checkpoints(mdir)


def _cls_runs(dev, top, pool, runs, tag, k=CLS_K):
    """Each run through ``run_classification_al(..., device="cuda")``: the
    13 strategies share one root (one split and initial model), each
    extra run has its own; launch counts zeroed just before each run and
    read just after, its checkpoints dropped once checked."""
    out = {"seconds": {}, "phases": {}, "by_method": {}, "peaks": {},
           "accs": {}}
    ops.reset_launch_counts()
    for name, overrides, rounds in runs:
        method = name.split("@")[0]
        key = tag + name
        root = os.path.join(top, name.replace("@", "_") if "@" in name
                            else "main")
        # fi may return fewer than k picks a round (its PMF is drawn with
        # replacement and deduplicated): it runs to k queries, in as many
        # rounds as that takes
        budget = k if rounds is None else k * rounds
        k1_0 = ops.similarity.KERNEL.launches
        k2_0 = ops.gather.KERNEL.launches
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        accs = run_querying.run_classification_al(
            root, pool, [method], budget, overrides, device=str(dev))
        out["seconds"][key] = time.perf_counter() - t0
        out["peaks"][key] = torch.cuda.max_memory_allocated()
        dk1 = ops.similarity.KERNEL.launches - k1_0
        dk2 = ops.gather.KERNEL.launches - k2_0
        out["by_method"][key] = {"rowmax_similarity": dk1,
                                 "gather_patches_normalized": dk2}
        accs = np.atleast_1d(accs[method])
        out["accs"][key] = accs.tolist()
        mdir = os.path.join(root, "0", method)
        picks = [np.atleast_1d(np.loadtxt(os.path.join(
            mdir, "queries", f"{i}.txt"), dtype=np.int64))
            for i in range(len(accs))]
        n_rounds = len(accs)
        check((n_rounds == rounds if rounds else 1 <= n_rounds <= k)
              and bool(np.isfinite(accs).all())
              and bool(((accs >= 0) & (accs <= 1)).all())
              and all(1 <= len(q) <= k for q in picks)
              and sum(len(q) for q in picks) == budget
              and (method == "fi" or all(len(q) == k for q in picks)),
              f"cls {key}: accs {accs}, picks {[len(q) for q in picks]}")
        check(dk2 == 0, f"cls {key}: K2 launched {dk2} times")
        if method == "core-set":
            check(dk1 >= n_rounds, f"cls {key}: K1 launched {dk1} times")
        with open(os.path.join(mdir, "phases.jsonl")) as f:
            out["phases"][key] = [json.loads(line) for line in f]
        rows = out["phases"][key]
        check(len(rows) == n_rounds and all(
            ("committee" in r) == (method in COMMITTEE) for r in rows),
            f"cls {key}: phase rows {rows}")
        if "consistency_coeff" in overrides:
            with np.load(os.path.join(mdir, "curr_weights.npz")) as z:
                check(any(f.startswith("teacher/") for f in z.files),
                      f"cls {key}: no teacher group")
        _drop_method_npz(root, method)
        print(f"cls campaign {key}: accuracy per round {accs.tolist()}, "
              f"picks per round {[len(q) for q in picks]}, "
              f"{out['seconds'][key]:.3f} s, K1 +{dk1}, K2 +{dk2}, peak "
              f"{out['peaks'][key] / 2**30:.2f} GiB, rounds "
              + json.dumps([{p: r[p] for p in (
                  "score_select", "committee", "train", "eval",
                  "checkpoint") if p in r} for r in rows]))
    out["counts"] = {kk.name: kk.launches for kk in ops.KERNELS}
    return out


def phase_cls_resume(dev, top, pool):
    """Classification resume == continue: entropy, 3 rounds, anchors every
    2 rounds; the second run loses its resume-point writes for 2 rounds
    and the next ``run_classification_al`` call replays both retrains:
    ``queries/``, ``accs.txt``, ``predicts.txt`` and ``curr_weights.npz``
    bit-identical."""
    roots = [os.path.join(top, "resume", n) for n in ("a", "b")]
    ov = "ckpt_full_every=2"

    def artifacts(root):
        mdir = os.path.join(root, "0", "entropy")
        with np.load(os.path.join(mdir, "curr_weights.npz")) as z:
            w = {k: z[k] for k in z.files}
        txt = {f: open(os.path.join(mdir, f)).read()
               for f in ("accs.txt", "predicts.txt")}
        txt.update({f: open(os.path.join(mdir, "queries", f)).read()
                    for f in sorted(os.listdir(os.path.join(mdir,
                                                            "queries")))})
        return w, txt

    t0 = time.perf_counter()
    run_querying.run_classification_al(roots[0], pool, ["entropy"],
                                       3 * CLS_K, ov, device=str(dev))
    a_s = time.perf_counter() - t0
    # the run and the method first (0 queries), then 2 rounds whose
    # resume-point writes are lost
    run_querying.run_classification_al(roots[1], pool, ["entropy"], 0, ov,
                                       device=str(dev))
    orig = experiment_mod.save_checkpoint
    experiment_mod.save_checkpoint, dropped = _suppressed_resume_writes(orig)
    try:
        run_querying.run_classification_al(roots[1], pool, ["entropy"],
                                           2 * CLS_K, ov, device=str(dev))
    finally:
        experiment_mod.save_checkpoint = orig
    check(len(dropped) >= 1, f"cls resume: dropped writes {dropped}")
    t0 = time.perf_counter()
    run_querying.run_classification_al(roots[1], pool, ["entropy"],
                                       3 * CLS_K, ov, device=str(dev))
    resume_s = time.perf_counter() - t0
    (wa, ta), (wb, tb) = artifacts(roots[0]), artifacts(roots[1])
    diff = sorted(k for k in set(wa) | set(wb)
                  if k not in wa or k not in wb
                  or not np.array_equal(wa[k], wb[k]))
    res = {"rounds": 3, "ckpt_full_every": 2, "entries": len(wa),
           "differing_entries": diff, "texts_equal": ta == tb,
           "files": sorted(ta), "uninterrupted_s": a_s,
           "resume_with_replay_s": resume_s}
    check(not diff and ta == tb and len(ta) == 5,
          f"cls resume != continue on the card: {res}")
    shutil.rmtree(os.path.join(top, "resume"), ignore_errors=True)
    print(f"cls resume == continue ok (bit for bit): {json.dumps(res)}")
    return res


def phase_cls(dev):
    """The classification phases (module docstring)."""
    top = os.path.join(ROOT, "_smoke_expr", "cls")
    shutil.rmtree(top, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        X, y = cls_dataset(dev, CLS_N, CLS_HW)
        data_s = time.perf_counter() - t0
        parity, spec, card = phase_cls_parity(dev, X, y)
        k1 = phase_cls_k1(dev, spec, card, X)
        del card
        pool = InMemoryPool(X, y)
        runs = [(n, ov, None if n == "fi" else
                 1 if n in CLS_ONE_ROUND else 2) for n, ov in CLS_RUNS]
        campaign = _cls_runs(dev, top, pool, runs, "")
        resume = phase_cls_resume(dev, top, pool)
        del pool, X, y
        Xv, yv = cls_dataset(dev, CLS_VGG_N, CLS_VGG_HW, seed=1)
        vgg = _cls_runs(dev, os.path.join(top, "vgg"), InMemoryPool(Xv, yv),
                        [(m, "model_name=VGG19", 1)
                         for m in ("entropy", "core-set")], "vgg19/")
        del Xv, yv
        Xs, ys = synthetic_mnist()
        t1 = time.perf_counter()
        harness = run_comparison(Xs, ys, 10, device=str(dev))
        harness_s = time.perf_counter() - t1
        check(all(len(c) == 10 and np.isfinite(c).all()
                  for c in harness.values()), f"softmax harness {harness}")
        print("softmax harness on the card ok ({:.3f} s): {}".format(
            harness_s, json.dumps({m: c.tolist()
                                   for m, c in harness.items()})))
        return {"parity": parity, "k1": k1, "campaign": campaign,
                "resume": resume, "vgg": vgg, "data_s": data_s,
                "harness": {"seconds": harness_s,
                            "curves": {m: c.tolist()
                                       for m, c in harness.items()}},
                "seconds": time.perf_counter() - t0}
    finally:
        shutil.rmtree(top, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    set_precision()
    card = card_line()
    print(card)

    t0 = time.perf_counter()
    ops.build_kernels()
    build_s = time.perf_counter() - t0
    print(f"kernel build {build_s:.3f} s (one nvcc per source, in "
          "parallel): " + ", ".join(f"{k.name} {k.build_s:.3f} s"
                                    for k in ops.KERNELS))
    for k in ops.KERNELS:
        for line in k.build_log.splitlines():
            if any(w in line for w in ("registers", "spill", "smem",
                                       "Compiling entry")):
                print(f"  {k.name}: {line.strip()}")
    sass = sass_counts(ops.similarity.KERNEL)
    print(f"  rowmax_similarity SASS: {sass or 'cuobjdump not found'}")
    check(not sass or (sass["HGMMA"] > 0 and sass["UTMALDG"] > 0),
          f"K1's binary lacks wgmma or TMA loads: {sass}")

    rows = [phase_k1(dev), phase_k2(dev)]
    phase_forward(dev)
    bf16_fwd = phase_bf16_forward(dev)
    mc_fwd = phase_mc_forward(dev)
    levers = phase_train_levers(dev)
    mc_sweep = phase_mc_sweep(dev)
    perturb = phase_perturb(dev)
    batch_select = phase_batch_select(dev)
    second_order = phase_second_order(dev)
    slic = phase_slic_variance(dev)
    fim = phase_fim_parity(dev)
    sweep, unc32 = phase_fim_sweep(dev)
    sweep16, _ = phase_fim_sweep(dev, cd=torch.bfloat16, ref_unc=unc32)
    del unc32
    f32, bf16, codecs, wpool = phase_campaign(dev)
    resume = phase_resume(dev)
    resume_mt = phase_resume(dev, mt=True)
    determinism = phase_determinism_cost(dev)
    multi = phase_multi(dev)
    dense = phase_dense(dev)
    cls = phase_cls(dev)
    phases, seconds, by_method, peaks, notes = {}, {}, {}, {}, {}
    for _, ph, sec, bym, pk, nt in (f32, bf16):
        phases.update(ph)
        seconds.update(sec)
        by_method.update(bym)
        peaks.update(pk)
        notes.update(nt)
    new_runs = ([n for n, _ in F32_RUNS if n.split("@")[0] in NEW_METHODS]
                + ["bf16/BALD", "bf16/QBC-JS"])
    print("per-round seconds of the new methods (NVIDIA card above): "
          + json.dumps(round_seconds(phases, new_runs)))
    print("MC sweep rate: " + json.dumps({
        k: mc_sweep[k]["rows_per_s"] for k in ("float32", "bfloat16")})
        + f" rows/s ({MC_ITERS} passes x {mc_sweep['grid_rows']} rows); "
        "AU_4U perturb sweep: " + json.dumps({
            k: perturb[k]["rows_per_s"]
            for k in ("sweep_float32", "sweep_bfloat16")}) + " rows/s")
    print("peak max_memory_allocated of the committee campaigns: "
          + json.dumps({n: peaks[n] for n in peaks
                        if n.split("/")[-1] in COMMITTEE}))
    lever_runs = [n for n, _ in LEVER_RUNS] + ["bf16/entropy@mt"]
    print("per-round seconds of the lever runs (NVIDIA card above): "
          + json.dumps(round_seconds(phases, lever_runs)))
    print("finetune seconds per step (Adam, b 128, card above): "
          + json.dumps(levers["seconds_per_step"]))
    print("checkpoint bytes with the teacher: " + json.dumps(
        {dt: codecs[f"{dt}_with_teacher"]["bytes"]
         for dt in ("float32", "bfloat16", "int8")}) + "; without: "
        + json.dumps({dt: codecs[dt]["bytes"]
                      for dt in ("float32", "bfloat16", "int8")}))
    print(f"TensorBoard mirror active: "
          f"{notes.get('tensorboard_active', False)}")
    rest_runs = [n for n, _ in REST_RUNS] + ["bf16/influence"]
    print("per-round seconds of influence, ps-random and SuPix (card "
          "above), with the influence/* spans, CG iterations and peak "
          "bytes: " + json.dumps({
              n: {"rounds": [{k: r[k] for k in ("score_select", "train",
                                                "eval", "checkpoint", "sub")
                              if k in r}
                             for r in phases[n] if not r.get("tail")],
                  "cg": notes.get(n + " cg"), "peak_bytes": peaks[n],
                  "campaign_s": seconds[n]}
              for n in rest_runs}))
    mf, mb = multi["f32"], multi["bf16"]
    print("per-round seconds of the multi-subject runs (card above), with "
          "their sub-spans, campaign seconds and peak bytes: " + json.dumps({
              k: {"rounds": c["rounds"][k], "campaign_s": c["seconds"][k],
                  "peak_bytes": c["peaks"][k]}
              for c in (mf, mb) for k in c["rounds"]}))
    print("K2 y-copy rebuilds in the multi campaigns: " + json.dumps(
        {"f32": mf["ycopy"], "bf16": mb["ycopy"]}))
    df, db, dm = dense["f32"], dense["bf16"], dense["multi"]
    print("per-round seconds of the dense (FC-DenseNet-103) runs (card "
          "above), with campaign seconds and peak bytes: " + json.dumps({
              tag + k: {"rounds": [{p: r[p] for p in (
                  "score_select", "committee", "train", "eval",
                  "checkpoint", "sub") if p in r}
                  for r in c["phases"][k] if not r.get("tail")],
                  "campaign_s": c["seconds"][k],
                  "peak_bytes": c["peaks"][k]}
              for tag, c in (("", df), ("", db), ("multi/", dm))
              for k in c["phases"]}))
    print("dense sweep (32 slices of 128x128x2, card above): " + json.dumps(
        {k: {m: dense["sweep"][k][m] for m in ("slices_per_s", "tflops",
                                               "peak_bytes")}
         for k in ("float32", "bfloat16")})
        + f" at {DENSE_GFLOP} GFLOP a slice; dense phases "
        f"{dense['seconds']:.3f} s")
    cc, cv = cls["campaign"], cls["vgg"]
    print("per-round seconds of the classification runs (AlexNet "
          "227x227x3, VGG19 224x224x3; card above), with campaign seconds "
          "and peak bytes: " + json.dumps({
              k: {"rounds": [{p: r[p] for p in (
                  "score_select", "committee", "train", "eval",
                  "checkpoint") if p in r} for r in c["phases"][k]],
                  "campaign_s": c["seconds"][k],
                  "peak_bytes": c["peaks"][k]}
              for c in (cc, cv) for k in c["phases"]}))
    print("classification pool sweep (AlexNet, 4,096 images of "
          "227x227x3, card above): " + json.dumps(cls["parity"]["sweep"])
          + f"; classification phases {cls['seconds']:.3f} s")
    for r in rows:
        n = r["name"]
        r["launches"] = (f32[0][n] + bf16[0][n] + mf["counts"][n]
                         + mb["counts"][n] + df["counts"][n]
                         + db["counts"][n] + dm["counts"][n]
                         + cc["counts"][n] + cv["counts"][n])
        r["launches_cls_campaign"] = cc["counts"][n]
        r["launches_cls_vgg19"] = cv["counts"][n]
        r["launches_by_cls_run"] = {m: c[n] for d in (cc, cv)
                                    for m, c in d["by_method"].items()}
        r["launches_dense_f32_campaign"] = df["counts"][n]
        r["launches_dense_bf16_campaign"] = db["counts"][n]
        r["launches_dense_multi_campaign"] = dm["counts"][n]
        r["launches_by_dense_run"] = {m: c[n] for d in (df, db, dm)
                                      for m, c in d["by_method"].items()}
        r["launches_f32_campaign"] = f32[0][n]
        r["launches_bf16_campaign"] = bf16[0][n]
        r["launches_multi_f32_campaign"] = mf["counts"][n]
        r["launches_multi_bf16_campaign"] = mb["counts"][n]
        r["launches_by_method"] = {m: c[n] for m, c in by_method.items()}
        r["launches_by_multi_run"] = {m: c[n] for d in (mf, mb)
                                      for m, c in d["by_method"].items()}
        r["kernel_ms"], r["max_err"] = r["ms"], r["max_abs_err"]
        if n == "rowmax_similarity":
            r["at_d16"] = dense["k1"]
            r["at_cls"] = cls["k1"]
    print(json.dumps({"phases": phases, "campaign_s": seconds,
                      "build_s": build_s,
                      "build_s_per_kernel": {k.name: k.build_s
                                             for k in ops.KERNELS},
                      "k1_sass": sass, "fim_parity": fim,
                      "fim_sweep": sweep, "fim_sweep_bf16": sweep16,
                      "bf16_forward": bf16_fwd, "ckpt_codecs": codecs,
                      "resume": resume, "resume_mt": resume_mt,
                      "train_levers": levers, "lever_notes": notes,
                      "finetune_determinism": determinism,
                      "mc_forward": mc_fwd, "mc_sweep": mc_sweep,
                      "perturbation": perturb,
                      "batch_selections": batch_select,
                      "second_order": second_order, "slic_variance": slic,
                      "finetune_wpool": wpool,
                      "campaign_peak_bytes": peaks,
                      "dense": {k: dense[k] for k in (
                          "parity", "sweep", "resume", "seconds")},
                      "cls": {k: cls[k] for k in (
                          "parity", "resume", "harness", "data_s",
                          "seconds")},
                      "cls_phases": {**cc["phases"], **cv["phases"]},
                      "cls_accs": {**cc["accs"], **cv["accs"]},
                      "dense_phases": {**df["phases"], **db["phases"],
                                       **{"multi/" + k: v for k, v in
                                          dm["phases"].items()}},
                      "multi": {"picks": multi["picks"],
                                "resume": multi["resume"],
                                "sequential": multi["sequential"],
                                "loader": multi["loader"],
                                "phases": {**mf["phases"],
                                           **mb["phases"]}}}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
