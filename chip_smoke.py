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
   ``entropy``, ``core-set`` and ``fi`` (init 256, k 64, b
   128, Adam 1e-3; fi: B 200, lambda_ 0), and of ``MC-entropy``,
   ``BALD``, ``BatchBALD``, ``ensemble``, ``QBC-JS``, ``AU_4U`` (noise
   then a 0.3 rad rotation), ``rep-entropy`` and ``BADGE`` at
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
14. the bf16 campaign: 2 rounds each of core-set, entropy with the mean
   teacher (bf16 anchors, the teacher's too) and influence (cg; bf16
   posteriors, f32 s_test) and fi (int8 anchors), bf16 sweeps and
   finetunes
   (the committee's and the teacher's forwards too), ``ckpt_full_every``
   2,
   ``async_checkpoint``; its launch counts are zeroed before and read
   after it, and K1 and K2 must launch;
15. resume == continue: a 3-round random campaign with int8 anchors every
   2 rounds (the campaign subject cut to 16 slices, ``RESUME_SHAPE``),
   run uninterrupted and then crashed after round 2 and
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
   campaigns (64 for ``MULTI_ONE_ROUND``: QBC-JS, influence, and fi at
   f32 and bf16 in 2-3 rounds) over three 128x128x8 subjects
   (``MULTI_SHAPE``, 16,384 grid voxels each; 32 slices before the
   rank-3 phase, 16 before the examples' phase), a test and a held
   subject, from an empty start: f32
   core-set (round 0
   from the held subject's features through K1), fi, QBC-JS (3
   members), influence (64 labels seeded) and entropy with the mean
   teacher (its directory kept for phase 21), every finetune gathering
   each subject's labels through K2,
   and bf16 fi (int8 anchors every 2 rounds, async writes, a
   float16 history copy every 2 rounds), each checked (journal columns,
   membership, rounds, sub-spans, history copies, anchors, K1 / K2
   launches) with the launch counts zeroed just before each campaign and
   read just after; K2's copy cache must make one copy per distinct
   volume; multi resume == continue (random, int8 anchors every 2
   rounds, crashed after round 2, the five subjects cut to 8 slices)
   bit for bit; ``sequential_al`` over
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
   either device; the card within 2x the host's error and 1e-2), with
   the first layer from the loss backwards whose weight gradient sits
   10x further from float64's on the card than on the host (its name,
   kind and both errors; a ReLU or max-pool decision that differs from
   float64's sends such a layer's output gradient astray) and the
   precision flags at the step (the IEEE policy, checked), then
   the BN refresh on the float64 step's weights card vs host (1e-4
   relative), and the seconds per Adam step of each; the whole-slice sweep's
   slices/s and TFLOP/s at f32 and bf16 (32 slices, batches of 4) and the
   bf16 sweep's top-1024 uncertainty overlap with f32 (tie-aware, at
   least 80%); K1 at d = 16 (P the pool's 65,536 per-pixel features, R
   256, 512 and a ragged 320) against its plain version within 1e-5,
   with its ms beside the bound; one-round dense campaigns (their second
   rounds run no new code, ``DENSE_ONE_ROUND``; f32: core-set, fi, BALD
   with 10 MC passes,
   BADGE, QBC-JS with 3 members, entropy with the mean teacher; bf16:
   fi) on the campaign subject cut to 16 slices, each checked
   (rounds, picks, membership, no K2 launch, K1 in core-set, the ``bn/``
   group, fi's sub-spans, the committee phase, the teacher group); dense
   resume == continue bit for bit (entropy, 3 rounds, int8 anchors every
   2, crashed after round 2, the subject cut to 16 slices); and a
   multi-subject dense fi campaign
   over two 128x128x8 subjects and one 96x96x8 (two shape groups; 64
   queries), every test evaluator on the engine's BN state;
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
   host RAM): 2 rounds of each of the 13 strategies but ``random`` and
   ``entropy`` (1 for ``CLS_ONE_ROUND``; fi to ``CLS_FI_QUERIES``
   queries), ``entropy`` with the mean teacher and with LwF, and
   ``random`` with ``train_dtype`` bfloat16,
   each checked (accuracies, picks, membership, K1 in every core-set
   round, no K2 launch, the committee phase, the teacher group);
   classification resume == continue bit for bit (entropy, 3 rounds,
   anchors every 2, crashed after round 2); one round of core-set with
   VGG19 on 512 images of 224x224x3 (K1 on VGG's fc2 features); and
   ``softmax_harness.run_comparison`` on the card;
19. serving (``phase_serving``; ``run_on_subjects`` runs inside the
   f32 campaign, on its entropy state): PW1 full-volume segmentation of
   inference_bench.py's two-modality subject cut to 256x256x32, at
   stride 1 (2,097,152 voxels) through ``full_volume_patchwise``, posteriors at
   f32, bf16 and int8 (``models/quant``, bf16 around it), each after a
   one-slice warm-up: voxels/s, TFLOP/s, peak memory; bf16's and int8's
   p1 against f32's (agreement at least 0.9 where |p1 - 0.5| > 0.05);
   card vs host at f32 on 256 voxels of each of 4 slices (the host's
   gather route, atol 1e-4); a ``torch.profiler`` window over one int8
   z-chunk (device time under the ``int8/quantize``, ``int8/im2col``,
   ``int8/int_mm`` and ``int8/rescale`` ranges, the idle share); the
   off-grid routes at bf16 (65,536 scattered voxels through the K2
   gather, K2 launched; a 6-slice ROI through the stride-1 slab sweep,
   K2 not launched; slab and gather within 2e-2); FC-DenseNet-103
   ``FCNInference`` over 64 slices of 256x256x2, batch 2, at f32, bf16
   and int8, and its ``MC-posteriors`` (T 10) card vs host on two
   128x128 crops with the same draws (1e-4); ``int8_matmul``
   (``torch._int_mm``) bit-equal to the host's exact sums for every PW1
   layer and FC-DenseNet-103's widest conv, timed; ``meanfield_crf_2d``
   card vs host on 256x256 (1e-5) and the native 2-D and 3-D dense CRF
   (128x128x32), timed, deterministic and lowering the error;
   ``run_on_subjects`` over two held 128x128x32 subjects, float and int8
   (F-measures, seconds, the files; int8 segmentations agree with float's
   on at least 90% of voxels), and again at f32 in a fresh child process
   that never applies the precision policy itself
   (``phase_fresh_precision``): the campaign subject
   served through a bare stride-1 ``GridPoolEvaluator`` and through
   ``run_on_subjects``, the child's flags after each the IEEE policy
   (TF32 off in cuDNN and matmuls, no bf16 reduced-precision reduction)
   and its posteriors equal to this process's (bit for bit, or 1e-6 with
   equal predictions) with the same F-measure; and a 2-round ``random`` campaign under
   ``optimizer_name: RMSProp`` (the subject cut to 8 slices) stopped
   after round 1 and resumed, equal to the uninterrupted run bit for
   bit;
20. the multi-device phases (``phase_parallel``; 2 data shards on the
   one card, given as an explicit device list): ``ShardedGridPoolEvaluator``
   against the unsharded evaluator on the f32 campaign's subject with its
   entropy weights (the 131,072-row test grid): posteriors, the
   ``MC_ITERS`` MC passes averaged, ``fim_sweep`` and ``perturb_sweep``
   bit for bit, each timed on both; one round each of entropy and
   core-set at ``data_parallel`` 2 through ``PWExperiment(...,
   mesh=...)``, whose round-0 picks must equal the f32 campaign's at
   ``data_parallel`` 1 (K1 in core-set); the sharded pool selector (K2 per
   shard over the 65,536-voxel pool), grid selector (top 64) and FIM-grid
   selector (top 200) and the bf16 dense segmenter over the serving
   phase's 256x256x32 subject, values and volumes bit-equal to their
   unsharded references and indices equal; an in-process ``nccl`` group
   of world size 1 whose DP step equals a plain Adam step bit for bit, on
   PW1 and on 2-D FC-DenseNet-103 (batch norm over the group's batch,
   skips, per-pixel CE), and whose ``sharded_pool_topk`` equals a plain
   top-k; ``make_mesh(2)``
   without a device list must raise on one card; launch counts zeroed
   just before the campaigns and read just after the selectors;
21. the analysis routines (``phase_analysis``): ``full_model_eval`` and
   ``full_model_pred_dcrf`` (native CRF) on one slice of a held
   64x64x32 subject with the f32 entropy weights, card against host
   (predictions equal wherever the card's p1 is more than 1e-4 from 0.5,
   F within 1e-3, CRF labels on at least 99.9% of the slice);
   ``test_scores_matrix`` over the kept multi-subject ``entropy@mt`` run's
   history copies, and resumed from its file (equal); and
   ``train_with_registries`` for 6 Adam steps of PW1 on 128 patches
   gathered by K2 (streams, best-model files, finite losses);
22. NRRD / NIfTI subjects (``phase_formats``): the f32 campaign's subject
   written as gzip NRRD in the ``hakim`` convention and as ``.nii`` in
   the ``iseg2017`` one, plus ``.nii.gz`` copies read through
   ``SubjectRegistry.from_lists``; each read back through
   ``registry_for`` / ``Subject.load`` bit-equal to the subject in
   memory (write and read seconds); one core-set round of the f32
   campaign's configuration from the NRRD files
   (``config.data.img_paths``), launch counts zeroed just before and read
   just after, whose round-0 picks must equal the f32 campaign's core-set
   round 0, and K1 (1e-5) and K2 (bit-equal) held to their plain
   versions on the inputs that round gave them; ``repeat_runs``' ``main``
   on the card (2 runs of ``random``, one round each, on the subject cut
   to 8 slices), then a third run interrupted inside its round and
   resumed from ``counter.txt``; a ``weight_decay`` step of PW1 25x25x2
   card vs host (loss and params within 1e-5), a ``focal_gamma`` step of
   FC-DenseNet-103's dense loss on 2 slices (a third of the pixels
   unlabeled, class weights), card and host each held to a float64 step
   on the card (the update's worst element and 2-norm within 1e-2 of its
   size, the rule of phase 18's AlexNet steps; the first diverging layer
   reported as in phase 17), and ``apply_with_branch``
   on PW1's probe card vs host (1e-4);
23. the 3-D path (``phase_rank3``): FC-DenseNet-103 at its published
   width and depth, 3-D on 2 modalities (26,167,922 parameters, 190.0
   GFLOP a 64x64x32x2 sub-volume, 760.2 the 128x128x32x2 subject) from
   one seed's weights: card vs host vs float64 (on the card) on a
   32x32x32 sub-volume of the campaign subject at batch 1
   (``update_bn_stats`` over two others, the eval forward: card vs host
   posteriors 1e-4 and state 1e-4 relative, the card's float64 error
   within 2x the host's; one ``make_train_step(fcn=True)`` Adam step, a
   third of the voxels unlabeled, each device's update within 1e-2 of
   the float64 update in the 2-norm); steps/s, TFLOP/s and peak memory of
   f32 and bf16 Adam steps at 64x64x32x2, batch 2, under deterministic
   cuDNN and without it; ``FCNInference`` over the whole subject at f32,
   bf16 and int8 (voxels/s, TFLOP/s, p1 against f32, 95% agreement where
   f32's p1 is more than 0.05 from 0.5), and int8 card vs host on a
   32x32x32 crop within 0.1 with 95% agreement (the quant tests' rule);
   launch
   counts zeroed just before and read just after (no kernel on this
   path); ``gather_patches_multimg`` through K2 on the multi subjects
   (counts zeroed just before, read just after; bit-equal to K2's plain
   version, labels equal); ``wait_device`` exits 0 on its first probe
   and ``prime_cache`` finds every build present;
24. the examples (``phase_examples``): each of the six
   ``nnal_tpu_torch.examples`` scripts' ``main`` on the card at its
   documented defaults (``EXAMPLES`` names those run at ``--tiny``:
   ``dense_model_al``, with ``--mt``):
   ``patchwise_al`` at ``DEMO_CAMPAIGN_OVERRIDES`` (entropy and random,
   3 rounds of k 20), ``multi_subject_al``, ``classification_al``,
   ``serving``, ``dense_model_al`` (entropy and BADGE) and
   ``multichip_campaign``, whose every round's picks at ``data_parallel``
   8 (the card listed 8 times) must equal ``data_parallel`` 1's; one
   ``example <name>`` line each (seconds, F per round of each method;
   serving's F float / int8 and agreement; launches), each curve finite
   in [0, 1] with the rounds its settings give; launch counts zeroed
   just before the first example and read after the last; the first K2
   call of ``patchwise_al``'s finetunes bit-equal to K2's plain version;
25. lines with the new methods' per-round seconds, the MC and perturb
   sweeps' rates, the committee campaigns' peak memory, the lever runs'
   per-round seconds, each lever's seconds per finetune step, the
   checkpoint bytes with the teacher, whether the TensorBoard mirror
   was active (it needs the ``tensorboard`` package), and the influence,
   ps-random and SuPix runs' per-round seconds with the ``influence/*``
   spans, CG iterations and peak memory, then a ``phase seconds`` line
   (each phase's wall seconds and the whole script's), one ``phases``
   JSON line (per-round seconds from ``phases.jsonl`` of both campaigns,
   build seconds, K1's SASS counts, the FIM, bf16, codec, resume, MC,
   perturbation, selection, second-order, SLIC and ``finetune_wpool``
   phases, the multi-subject, dense, multi-device, analysis, formats and
   rank-3 and examples ones) and one ``kernels`` JSON line (times,
   bounds, launches in every campaign and in the serving, multi-device,
   analysis, formats, ``gather_patches_multimg`` and examples phases,
   ``launches_by_example``; each row's check at the formats
   round's shapes under
   ``at_formats``; K1's row also its times at d = 16 under ``at_d16`` and
   at the classification shape under ``at_cls``).

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

import contextlib
import copy
import ctypes
import importlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as nnf
from torch.overrides import TorchFunctionMode

from nnal_tpu_torch import ops
from nnal_tpu_torch.cli import prime_cache, wait_device
from nnal_tpu_torch.ops._build import stream_ptr
from nnal_tpu_torch.cli.expr_handler import DEFAULT_PARS, create_expr, do_expr
from nnal_tpu_torch.cli.run_on_subjects import run_on_subjects
from nnal_tpu_torch.cli import repeat_runs as repeat_runs_mod
from nnal_tpu_torch.cli import run_querying
from nnal_tpu_torch.cli.softmax_harness import run_comparison, synthetic_mnist
from nnal_tpu_torch.data.image_pool import InMemoryPool
from nnal_tpu_torch.engine import experiment as experiment_mod
from nnal_tpu_torch.core import rng as core_rng
from nnal_tpu_torch.core.config import ExperimentConfig, set_parameters
from nnal_tpu_torch.core.profiling import drain_subphases
from nnal_tpu_torch.core.device import deterministic_cudnn, set_precision
from nnal_tpu_torch.data.datasets import CONVENTIONS as DATASET_CONVENTIONS
from nnal_tpu_torch.data.datasets import registry_for
from nnal_tpu_torch.data.formats import write_nifti, write_nrrd
from nnal_tpu_torch.data.io import SubjectRegistry, synthetic_subject
from nnal_tpu_torch.core.journal import MethodJournal
from nnal_tpu_torch.data.patches import gather_patches_multimg, pad_volumes
from nnal_tpu_torch.data.samplers import (
    even_odd_slice_split,
    generate_grid_samples,
    high_variance_filter,
)
from nnal_tpu_torch.engine import multi_experiment, pw_experiment
from nnal_tpu_torch.engine.analysis import test_scores_matrix
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
from nnal_tpu_torch.models.branches import (
    apply_with_branch,
    branch_input_shape,
    init_branch,
)
from nnal_tpu_torch.models.cnn import (
    CNN,
    count_parameters,
    init_cnn,
    int8_matmul,
    linear_f32acc,
)
from nnal_tpu_torch.models.quant import (
    is_quantized,
    quantize_model,
    quantize_params,
)
from nnal_tpu_torch.evaluation.crf import (
    dcrf_postprocess_2d,
    dcrf_postprocess_3d,
    meanfield_crf_2d,
)
from nnal_tpu_torch.evaluation.inference import (
    FCNInference,
    full_slice_patchwise,
    full_volume_patchwise,
)
from nnal_tpu_torch.runtime import crf_native, slic_native
from nnal_tpu_torch.runtime import native as native_gather
from nnal_tpu_torch.evaluation.analysis import (
    full_model_eval,
    full_model_pred_dcrf,
)
from nnal_tpu_torch.evaluation.registry import (
    MetricRegistry,
    train_with_registries,
)
from nnal_tpu_torch.parallel.dryrun import free_port
from nnal_tpu_torch.parallel.grid_sharded import ShardedGridPoolEvaluator
from nnal_tpu_torch.parallel.mesh import make_mesh, stable_topk
from nnal_tpu_torch.parallel.multihost import (
    init_distributed,
    make_multihost_mesh,
)
from nnal_tpu_torch.parallel.pool_sharded import (
    grid_row_to_voxel,
    make_sharded_dense_segmenter,
    make_sharded_fim_grid_selector,
    make_sharded_grid_selector,
    make_sharded_pool_selector,
)
from nnal_tpu_torch.parallel.sharding import (
    make_sharded_train_step,
    shard_params,
    sharded_pool_topk,
)
from nnal_tpu_torch.models.optim import (
    layer_train_mask,
    load_opt_state,
    make_optimizer,
    opt_state_leaves,
    opt_state_tensors,
)
from nnal_tpu_torch.models.specs import (
    CNNSpec,
    create_model,
    create_pw1,
    with_aleatoric_head,
)
from nnal_tpu_torch.models.specs import Layer as SpecLayer
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
    update_bn_stats,
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
from nnal_tpu_torch.scoring.pool_eval import (
    PoolEvaluator,
    mc_average_posteriors,
    mc_stack_posteriors,
)
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

T_START = time.perf_counter()
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
# (``entropy``, ``BALD`` and ``QBC-JS`` alone are left out:
# ``entropy@mt`` drives the bf16 entropy selection, the MC sweep phase
# the bf16 MC passes, the f32 runs BALD's selection and the committee,
# the other bf16 runs the bf16 finetune and anchors)
BF16_RUNS = (("core-set", OVERRIDES + BF16 + ",ckpt_dtype=bfloat16"),
             ("fi", OVERRIDES_FI + BF16 + ",ckpt_dtype=int8"))
# ``random`` alone is left out: ``random@train_layers`` drives its
# selection, every other run the plain finetune
F32_RUNS = (tuple((m, OVERRIDES_FI if m == "fi" else OVERRIDES)
                  for m in METHODS if m != "random")
            + tuple((m, OVERRIDES_NEW) for m in NEW_METHODS if m != "AU_4U")
            # noise, then a 0.3 rad rotation: AU_4U's noise-only path too
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
ONE_ROUND = {"entropy", "MC-entropy", "BALD", "BatchBALD", "AU_4U",
             "AU_4U@rotation", "rep-entropy", "BADGE", "entropy@lwf",
             "entropy@aleatoric", "random@train_layers", "ps-random",
             "influence@arnoldi", "ensemble", "QBC-JS", "entropy@mt",
             "influence"}
BF16_RUNS += (("influence", INFLUENCE + BF16 + ",ckpt_dtype=bfloat16"),)
INFLUENCE_SUBS = {"influence/labeled_gather", "influence/s_test",
                  "influence/posteriors", "influence/filter",
                  "influence/cand_scores"}
# resume == continue: 3 rounds of random, int8 anchors every 2 rounds;
# again with the mean teacher.  The resume phases (these, the multi,
# dense and RMSProp ones) check equality, not speed: they run on the
# campaign subject cut to 16 slices
RESUME_SHAPE = (128, 128, 16)
RESUME_OVERRIDES = OVERRIDES + ",ckpt_full_every=2,ckpt_dtype=int8"
# the multi-subject engine: three 128x128x32 training subjects (pools of
# 65,536 grid voxels each), a test and a held subject, an empty start
# (influence: 64 labels seeded), k 64, B 200, 128 queries a run
# their subjects cut to 16 slices (``MULTI_SHAPE``) since the rank-3
# phase, to 8 since the examples' phase: the multi-subject code they
# drive is the same at any depth
MULTI_SHAPE = (128, 128, 8)
MULTI = ("patch_shape=[25,25,1],grid_spacing=2,k=64,B=200,b=128,epochs=1,"
         "learning_rate=1e-3,optimizer_name=Adam,ntb=4096,seed=0")
# (``entropy`` alone is left out: ``entropy@mt`` and the bf16 run drive
# its selection, core-set and fi the plain multi finetune)
MULTI_RUNS = (("core-set", MULTI), ("fi", MULTI),
              ("QBC-JS", MULTI + ",n_ensemble=3"), ("influence", MULTI),
              ("entropy@mt", MULTI + MT))
# multi runs whose second round runs no code their first does not (64
# queries); fi's picks shrink round over round (8, 53, 53, 13, 1 at 128
# queries on an H100 80GB HBM3 at 700 W), so at 64 it still runs 2-3
# rounds
MULTI_ONE_ROUND = {"QBC-JS", "influence", "fi", "bf16/fi"}
MULTI_BF16 = (",dtype=bfloat16,train_dtype=bfloat16,ckpt_full_every=2,"
              "ckpt_dtype=int8,async_checkpoint=true,hist_every=2,"
              "hist_dtype=float16")
# (bf16 ``entropy`` alone is left out: fi drives the bf16 multi finetune,
# the bf16 test sweeps, the anchors and the float16 history copies, the
# f32 ``entropy@mt`` the entropy selection)
MULTI_BF16_RUNS = (("fi", MULTI + MULTI_BF16),)
MULTI_RESUME = MULTI + ",ckpt_full_every=2,ckpt_dtype=int8,hist_every=0"
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
# on the campaign subject's whole 128x128 slices, PW1's grid and budget;
# the campaigns on the subject cut to 16 slices since the rank-3 phase
# (the sweep phase times all 32)
DENSE = ("model_name=Tiramisu,dropout_rate=0.2,patch_shape=[25,25,1],"
         "grid_spacing=2,k=64,B=200,b=4,epochs=1,init_size=256,"
         "learning_rate=1e-3,optimizer_name=Adam,ntb=4096,"
         "synthetic_shape=[128,128,16],seed=0")
# ``entropy`` alone is left out: ``entropy@mt``, the bf16 run and the
# resume phase drive its selection, every other run the plain finetune
DENSE_RUNS = (("core-set", DENSE),
              ("fi", DENSE + ",iter_k=[64,0]"),
              ("BALD", DENSE + ",MC_iters=10"), ("BADGE", DENSE),
              ("QBC-JS", DENSE + ",n_ensemble=3"), ("entropy@mt", DENSE + MT))
# dense runs whose second round runs no code their first does not
DENSE_ONE_ROUND = {"BALD", "BADGE", "QBC-JS", "core-set", "entropy@mt",
                   "fi", "bf16/fi"}
# (bf16 ``entropy`` is left out: fi drives the bf16 dense finetune and
# sweep, the f32 runs entropy's selection)
DENSE_BF16_RUNS = (("fi", DENSE + ",iter_k=[64,0],dtype=bfloat16,"
                    "train_dtype=bfloat16"),)
DENSE_RESUME = DENSE + ",ckpt_full_every=2,ckpt_dtype=int8"
DENSE_MULTI = MULTI + ",model_name=Tiramisu,dropout_rate=0.2,b=4"
# (name, overrides, queries): fi's picks shrink round over round (59,
# 31, 22, 10, 5, 1 on an H100 80GB HBM3), so it runs on 64 queries;
# entropy is left out (the single-subject dense runs drive its
# selection, fi the multi dense finetune over both shape groups)
DENSE_MULTI_RUNS = (("fi", DENSE_MULTI, 64),)
DENSE_GFLOP = 13.0          # per 128x128x2 slice, convs and convTs
SWEEP_SHAPE = (256, 256, 64)        # bench.py's subject
# the classification campaign (phase_cls): AlexNet at 227x227x3 on 4,096
# synthetic 8-class images, run_querying.DEFAULT_CLS_PARS as they are
CLS_N, CLS_HW, CLS_NCLASS, CLS_K = 4096, 227, 8, 10
CLS_MT = ("consistency_coeff=1.0,consistency_measure=CE,consistency_ramp=20,"
          "ema_decay=0.99")
# ``random`` and ``entropy`` alone are left out: ``random@bf16`` and the
# two entropy levers drive their selections, every other run the f32
# retrain
CLS_RUNS = (tuple((m, "") for m in cls_mod.METHODS
                  if m not in ("random", "entropy"))
            + (("entropy@mt", CLS_MT), ("entropy@lwf", "lwf_lambda=1.0,lwf_T=2"),
               ("random@bf16", "train_dtype=bfloat16")))
# runs whose second round runs no code their first does not (the
# committees build their members the same way every round without
# pretrained_paths); fi runs to CLS_FI_QUERIES queries, in as many rounds
# as that takes (its picks shrink: 3, 3, 2, 2 at 10 on an H100 80GB HBM3
# at 700 W; one query, one round, since the fresh-process precision
# phase)
CLS_FI_QUERIES = 1
CLS_ONE_ROUND = {"ensemble", "QBC-JS", "egl", "influence", "entropy@mt",
                 "core-set", "MC-entropy", "BALD", "BatchBALD",
                 "rep-entropy", "BADGE", "entropy@lwf", "random@bf16"}
CLS_VGG_N, CLS_VGG_HW = 512, 224
SWEEP_Z_CHUNK = 4
# serving (phase_serving): PW1 25x25 patches at stride 1 over SERVE_SHAPE,
# SWEEP_SHAPE cut to 32 slices (the rates are per voxel or patch) since
# the fresh-process precision phase; card vs host on 256 voxels of each
# of 4 slices; inference_bench.py's 65,536 scattered off-grid voxels; its
# fcn_volume (64 slices of 256x256x2, batch 2); the CRF's 256x256 map and
# 128x128x32 volume; two held subjects for run_on_subjects; RMSProp's
# resume == continue
SERVE_PS = (25, 25, 1)
SERVE_SHAPE = (256, 256, 32)
SERVE_CHECK_SLICES = (0, 10, 21, 31)
SERVE_CHECK_N = 256
SERVE_SCATTERED = 65536
FCN_SERVE = (64, 256, 2)
CRF_2D, CRF_VOL = 256, (128, 128, 32)
HELD_SEEDS = (41, 42)
RMSPROP = OVERRIDES.replace("optimizer_name=Adam", "optimizer_name=RMSProp")
RMSPROP_SHAPE = (128, 128, 8)
# the multi-device phases: 2 data shards, on the one card given explicitly
PARALLEL_DP = 2
# the analysis phase's held subject: a slice of it goes through PW1 on
# the host twice (card vs host), so it is kept to 64x64
ANALYSIS_SHAPE = (64, 64, 32)
MULTI_KEPT = os.path.join(ROOT, "_smoke_expr", "kept_multi_entropy")
# the formats phase's repeat_runs: the f32 campaign's configuration on a
# subject cut to 8 slices, plain SGD (smaller saves), one round a run
REPEAT_OVERRIDES = OVERRIDES.replace(
    "synthetic_shape=[128,128,32]", "synthetic_shape=[128,128,8]").replace(
    "optimizer_name=Adam", "optimizer_name=SGD")
# the 3-D (rank-3) path (phase_rank3): FC-DenseNet-103 at its published
# width and depth on volumes of 2 modalities; card vs host on a
# 32x32x32 sub-volume at batch 1, the training rate on 64x64x32 at batch
# 2, serving on the campaign subject whole (128x128x32)
R3_PARITY = (32, 32, 32)
R3_TRAIN = (64, 64, 32)
R3_BATCH = 2
R3_PARAMS = 26_167_922
R3_STEPS = 3            # timed train steps per configuration, after one
# gather_patches_multimg on the multi subjects: indices per subject (one
# empty)
MULTIMG_INDS = (512, 0, 256)
# the examples (phase_examples), in the order a user meets them; True
# runs one at its ``--tiny`` settings, False at its documented defaults
# (``patchwise_al`` always at its protocol, DEMO_CAMPAIGN_OVERRIDES).
# ``dense_model_al``'s defaults (a growth-8 FC-DenseNet on 128x128x32,
# 25 epochs) took 17.3 s of the phase's 46.0 on an H100 80GB HBM3 at
# 700 W; phase 17 drives the full-width dense path, so it runs at
# ``--tiny`` (6 rounds of k 4)
EXAMPLES = {"patchwise_al": False, "multi_subject_al": False,
            "classification_al": False, "serving": False,
            "dense_model_al": True, "multichip_campaign": False}
PHASE_S = {}


def timed(name, fn, *args, **kw):
    """``fn(*args, **kw)``, its wall seconds kept under ``name`` (the
    ``phase seconds`` line)."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kw)
    finally:
        PHASE_S[name] = time.perf_counter() - t0


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


def precision_flags() -> dict:
    """This process's precision flags: ``core/device.set_precision``'s
    three, and cuDNN's convolution precision where this torch has it."""
    b = torch.backends
    return {"cudnn.allow_tf32": b.cudnn.allow_tf32,
            "cuda.matmul.allow_tf32": b.cuda.matmul.allow_tf32,
            "bf16_reduced_precision_reduction":
                b.cuda.matmul.allow_bf16_reduced_precision_reduction,
            "cudnn.conv.fp32_precision": getattr(
                getattr(b.cudnn, "conv", None), "fp32_precision", None)}


IEEE_FLAGS = {"cudnn.allow_tf32": False, "cuda.matmul.allow_tf32": False,
              "bf16_reduced_precision_reduction": False}


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
    ``finetune_wpool``, the checkpoint codecs and ``run_on_subjects`` on
    its entropy state, then the bf16
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
        served = phase_run_on_subjects(dev, os.path.join(top, "entropy"))
        served["fresh_process"] = timed(
            "fresh_precision", phase_fresh_precision, dev,
            os.path.join(top, "entropy"))
        # what the multi-device and analysis phases reuse: the entropy
        # state and the round-0 picks at data_parallel 1
        kept = {"entropy_params": ckpt.load_checkpoint(os.path.join(
            top, "entropy", "entropy", "curr_weights.npz"))[0],
            "picks0": {m: np.loadtxt(os.path.join(top, m, m, "queries",
                                                  "0.txt"), dtype=np.int64)
                       for m in ("entropy", "core-set")}}
        bf16 = _campaign(dev, os.path.join(top, "bf16"), BF16_RUNS, "bf16/")
        return f32, bf16, codecs, wpool, served, kept
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
    3-round random campaign with int8 anchors every 2 rounds runs once
    uninterrupted; a second run loses its resume-point writes for 2
    rounds (the round-2 anchor was adopted live but never landed), then a
    fresh ``PWExperiment`` replays from the initial weights to round 3.
    The final ``curr_weights.npz``, the query journal and
    ``perf_evals.txt`` must be bit-identical.  ``mt``: the same under the
    mean teacher, whose int8 ``teacher/`` group must be in the file (the
    replay rebuilds the teacher from the initial weights)."""
    top = os.path.join(ROOT, "_smoke_expr", "resume")
    shutil.rmtree(top, ignore_errors=True)
    vols, mask = synthetic_subject(shape=RESUME_SHAPE, n_modalities=2,
                                   n_blobs=3, seed=0)
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
        a.run_method("random", 192)
        a_s = time.perf_counter() - t0
        b = fresh(os.path.join(top, "b"))
        b.prep_data()
        b.add_method("random")
        orig = pw_experiment.save_checkpoint
        pw_experiment.save_checkpoint, dropped = \
            _suppressed_resume_writes(orig)
        try:
            b.run_method("random", 128)
        finally:
            pw_experiment.save_checkpoint = orig
        check(len(dropped) == 1, f"resume: dropped writes {dropped}")
        t0 = time.perf_counter()
        fresh(os.path.join(top, "b")).run_method("random", 192)
        resume_s = time.perf_counter() - t0
        wa, qa, ea = artifacts(os.path.join(top, "a"))
        wb, qb, eb = artifacts(os.path.join(top, "b"))
        diff = sorted(k for k in set(wa) | set(wb)
                      if k not in wa or k not in wb
                      or wa[k].dtype != wb[k].dtype
                      or not np.array_equal(wa[k], wb[k]))
        res = {"rounds": 3, "ckpt_full_every": 2, "ckpt_dtype": "int8",
               "entries": len(wa), "differing_entries": diff,
               "queries_equal": qa == qb, "perf_evals_equal": ea == eb,
               "uninterrupted_s": a_s, "resume_with_replay_s": resume_s,
               "al_state": json.loads(wa["__al_state__"].tobytes().decode()),
               "mean_teacher": mt}
        check(not diff and qa == qb and ea == eb and len(qa) == 3
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


def multi_subjects(shape=SHAPE):
    """Three training subjects, a test and a held one (128x128x32, two
    modalities; ``shape`` cuts them)."""
    s = [synthetic_subject(shape=shape, n_modalities=2, n_blobs=3, seed=i)
         for i in range(5)]
    return s[:3], s[3:4], s[4:]


def _multi_expr(root, overrides, dev, subjects):
    cfg = ExperimentConfig.from_pars(set_parameters(DEFAULT_PARS,
                                                    overrides))
    expr = multi_experiment.MultiImgExperiment(root, cfg, device=dev)
    expr.attach_subjects(*subjects)
    return expr


def _multi_campaign(dev, top, runs, tag, subjects, keep=None):
    """Each run in its own experiment directory (a fresh
    ``MultiImgExperiment`` and its subjects' volumes), 128 queries (64
    for the f32 runs of ``MULTI_ONE_ROUND``): the
    journal, membership, rounds, sub-spans, history copies and each run's
    K1 / K2 launches checked, its checkpoints removed once checked.  The
    launch counts and K2's copy-cache counters are zeroed just before the
    runs and read just after; the copies made must equal the distinct
    volumes gathered from (no copy rebuilt).  ``keep`` ``(name,
    directory)``: that run's directory is moved there instead of removed
    (``phase_analysis`` reads its history copies)."""
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
        want = 1 if key in MULTI_ONE_ROUND else 2
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
        shape = np.shape(subjects[0][0][0][0])
        check(sizes == [len(generate_grid_samples(shape, 2))] * 3,
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
        if keep and keep[0] == key:
            shutil.rmtree(keep[1], ignore_errors=True)
            shutil.move(root, keep[1])
        else:
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
    """Multi resume == continue on the card: ``random``, 3 rounds, int8
    anchors every 2 rounds, run uninterrupted; a second run loses its
    resume-point writes for 2 rounds and a fresh ``MultiImgExperiment``
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
            expr.run_method("random", 3 * k)
            a_s = time.perf_counter() - t0
            continue
        orig = multi_experiment.save_checkpoint
        multi_experiment.save_checkpoint, dropped = \
            _suppressed_resume_writes(orig)
        try:
            expr.run_method("random", 2 * k)
        finally:
            multi_experiment.save_checkpoint = orig
        check(len(dropped) == 1, f"multi resume: dropped writes {dropped}")
    t0 = time.perf_counter()
    _multi_expr(roots[1], MULTI_RESUME, dev, subjects).run_method("random",
                                                                  3 * k)
    resume_s = time.perf_counter() - t0
    (wa, qa, ea), (wb, qb, eb) = artifacts(roots[0]), artifacts(roots[1])
    diff = sorted(k for k in set(wa) | set(wb)
                  if k not in wa or k not in wb or wa[k].dtype != wb[k].dtype
                  or not np.array_equal(wa[k], wb[k]))
    res = {"rounds": 3, "ckpt_full_every": 2, "ckpt_dtype": "int8",
           "entries": len(wa), "differing_entries": diff,
           "queries_equal": qa == qb, "perf_evals_equal": ea == eb,
           "uninterrupted_s": a_s, "resume_with_replay_s": resume_s}
    check(not diff and qa == qb and ea == eb and len(qa) == 3
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
        subjects = multi_subjects(MULTI_SHAPE)
        f32 = _multi_campaign(dev, top, MULTI_RUNS, "", subjects,
                              keep=("entropy@mt", MULTI_KEPT))
        bf16 = _multi_campaign(dev, os.path.join(top, "bf16"),
                               MULTI_BF16_RUNS, "bf16/", subjects)
        resume = phase_multi_resume(dev, top, multi_subjects(RESUME_SHAPE))
        seq = phase_sequential(dev, top)
        loader = phase_loader(dev)
        return {"picks": picks, "f32": f32, "bf16": bf16, "resume": resume,
                "sequential": seq, "loader": loader, "kept": MULTI_KEPT}
    finally:
        shutil.rmtree(top, ignore_errors=True)


# ------------------------------------------------------------ dense models
def dense_flops(spec, hw) -> float:
    """FLOPs (2 per multiply-add) of the convs and transposed convs of
    one forward of ``spec`` on an ``hw`` slice (or volume, for a 3-D
    spec), from the spec's shapes."""
    total = 0.0
    with torch.device("meta"):
        model = CNN(spec)
    sizes = {"__input__": tuple(hw)}
    prev = "__input__"
    for layer in spec.layers:
        size = (tuple(min(sizes[s][d] for s in layer.sources)
                      for d in range(len(hw)))
                if layer.sources else sizes[prev])
        if layer.kind in ("conv", "convT"):
            # out * in * prod(k) multiply-adds at each input voxel
            total += 2.0 * getattr(model, layer.name).weight.numel() \
                * float(np.prod(size))
            sizes[layer.name] = size if layer.kind == "conv" else tuple(
                n * st for n, st in zip(size, layer.strides))
        elif layer.kind in ("pool", "avgpool"):
            sizes[layer.name] = tuple(-(-n // st) for n, st in
                                      zip(size, layer.strides))
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


def _rel64(got, want) -> float:
    """max |got - want| over max |want|, in float64 on the host."""
    return float((got.double().cpu() - want).abs().max()
                 / want.abs().max().clamp(min=1e-300))


def first_diverging_layer(spec, g_card, g_host, g64, ratio=10.0):
    """From the loss backwards, the first conv or transposed conv whose
    weight gradient sits more than ``ratio`` times further from the
    float64 step's on the card than on the host (each max |g - g64| over
    max |g64| of the layer's weight), with both figures; None when no
    layer does.  The gradients are ``{parameter name: tensor}``."""
    for layer in reversed(spec.layers):
        if layer.kind not in ("conv", "convT"):
            continue
        w = f"{layer.name}.weight"
        card, host = _rel64(g_card[w], g64[w]), _rel64(g_host[w], g64[w])
        if card > ratio * host:
            return {"layer": layer.name, "kind": layer.kind,
                    "wgrad_err_card": card, "wgrad_err_host": host}
    return None


def step_grads(model) -> dict:
    """The gradients a train step left on ``model``, float64 on the host."""
    return {n: p.grad.detach().cpu().double()
            for n, p in model.named_parameters()}


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
            flags[str(device)] = precision_flags()
        return m, st.teacher

    def cpu64(mod):
        return {k: v.detach().cpu().double()
                for k, v in mod.state_dict().items()}

    p0 = {k: v.double() for k, v in host.state_dict().items()}
    flags = {}

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
        else:
            # the first layer from the loss backwards whose weight
            # gradient is 10x further from float64's on the card than on
            # the host, and the precision the step ran at
            r["first_diverging_layer"] = first_diverging_layer(
                spec, step_grads(mc), step_grads(mh), step_grads(m64))
            r["precision_at_step"] = dict(flags)
            check(all(f[k] is v for f in flags.values()
                      for k, v in IEEE_FLAGS.items()),
                  f"the dense step ran outside the IEEE policy: {flags}")
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


CUDNN_SETTINGS = {
    "deterministic": deterministic_cudnn,
    "nondeterministic": lambda: torch.backends.cudnn.flags(
        enabled=True, benchmark=False, deterministic=False, allow_tf32=False),
    "cudnn_off": lambda: torch.backends.cudnn.flags(
        enabled=False, benchmark=False, deterministic=False,
        allow_tf32=False)}


class _Branches(TorchFunctionMode):
    """Every 2-D convolution's arguments and output gradient, and every
    ReLU's sign mask and max-pool's argmax, in call order (``mode``
    "record"); with ``ref`` (a recorded run's decisions), "count" counts
    this run's decisions that differ from them and "pin" imposes them
    (a ReLU as ``x * mask``, a max-pool as a gather at the argmax)."""

    def __init__(self, mode="record", ref=None):
        super().__init__()
        self.mode, self.ref = mode, ref
        self.convs, self.decisions, self.flips = [], [], 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if func in (nnf.conv2d, nnf.conv_transpose2d):
            out = func(*args, **kwargs)
            rec = {"func": func, "args": args, "kwargs": kwargs, "gy": None}
            self.convs.append(rec)
            if out.requires_grad:
                out.register_hook(lambda g, rec=rec: rec.update(gy=g))
            return out
        if func is not nnf.relu and name not in ("max_pool2d", "_max_pool2d"):
            return func(*args, **kwargs)
        x = args[0]
        if func is nnf.relu:
            mine = x.detach() > 0
        else:
            _, mine = nnf.max_pool2d(
                x.detach(), args[1], args[2] if len(args) > 2
                else kwargs["stride"], return_indices=True)
        if self.mode == "record":
            self.decisions.append(mine)
            return func(*args, **kwargs)
        ref = self.ref[len(self.decisions)].to(mine.device)
        self.decisions.append(mine)
        self.flips += int((ref != mine).sum())
        if self.mode == "count":
            return func(*args, **kwargs)
        if func is nnf.relu:
            return x * ref.to(x.dtype)
        return x.flatten(2).gather(2, ref.flatten(2)).view(ref.shape)


def _gap_inputs(kind, seed=31):
    """The inputs of the dense parity phase's plain SGD step (4 slices,
    2% of the pixels labeled) or of ``formats_steps``' ``focal_gamma``
    step (2 slices, a third unlabeled, class weights), from ``seed``'s
    FC-DenseNet-103."""
    vols, mask, mu, sd, _ = _dense_subject()
    spec = create_model("Tiramisu", nclass=2, input_shape=(128, 128, 2),
                        dropout_rate=0.2)
    host = init_cnn(spec, seed, device="cpu")
    slices = normalized_slices(vols, mu, sd)
    rng = np.random.default_rng(seed)
    if kind == "plain":
        lab = rng.integers(0, 2, (4, 128, 128))
        return spec, host, (
            torch.from_numpy(slices[:4].copy()),
            torch.from_numpy(np.eye(2, dtype=np.float32)[lab]),
            (rng.random((4, 128, 128)) < 0.02).astype(np.float32))
    lab = np.nan_to_num(np.moveaxis(mask[:, :, 10:12], 2, 0)).astype(int)
    ys = np.eye(2, dtype=np.float32)[lab]
    ys[rng.random(lab.shape) < 1 / 3] = np.nan
    return spec, host, (torch.from_numpy(slices[10:12].copy()),
                        torch.from_numpy(ys), torch.tensor([0.4, 1.6]))


def _gap_step(kind, host, inputs, device, dtype, ctx, mode="record",
              ref=None):
    """One SGD step (lr 0.1) of ``kind`` from ``host``'s weights at
    ``dtype`` on ``device`` under the cuDNN context ``ctx``, with
    ``KeyedDraws(31)``'s dropout: its gradients, its branch record and
    the precision flags it ran at."""
    m = copy.deepcopy(host).to(device, dtype)
    st = init_train_state(m, "SGD", 0.1)
    br = _Branches(mode, ref)
    with KeyedDraws(31), ctx, br:
        flags = precision_flags()
        if kind == "plain":
            x, y, wpix = inputs
            finetune_fcn_steps(st, x.to(device, dtype), y.to(device, dtype),
                               wpix, np.arange(4)[None],
                               np.ones((1, 4), np.float32), 5)
        else:
            xs, ys, cw = inputs
            make_train_step(fcn=True, focal_gamma=2.0)(
                st, xs.to(device, dtype), ys.to(device, dtype), 5,
                cw=cw.to(device, dtype))
    return step_grads(m), br, flags


def _conv_alone(c, device, dtype, ctx):
    """A recorded convolution replayed alone on its float64 inputs and
    output gradient: its forward, data gradient and filter gradient."""
    x = c["args"][0].detach().to(device, dtype).requires_grad_(True)
    w = c["args"][1].detach().to(device, dtype).requires_grad_(True)
    rest = [a.detach().to(device, dtype) if torch.is_tensor(a) else a
            for a in c["args"][2:]]
    with ctx:
        out = c["func"](x, w, *rest, **c["kwargs"])
        gx, gw = torch.autograd.grad(out, (x, w), c["gy"].to(device, dtype))
    return [t.detach().double().cpu() for t in (out, gx, gw)]


def dev_dense_gap(dev=None) -> int:
    """``python3 chip_smoke.py --dense-gap``: a development measurement,
    not a smoke phase.  For the 2-D FC-DenseNet-103 f32 steps of the
    dense parity phase (plain SGD) and of ``formats_steps``
    (``focal_gamma``), against a float64 step on the card, the host and
    the card under ``CUDNN_SETTINGS``: the whole step's error (max |g -
    g64| over max |g64|), per conv layer the weight gradient's and the
    output gradient's, the first layer from the loss backwards where the
    card errs 10x the host, how many ReLU / max-pool decisions differ from
    float64's; every convolution alone on float64's inputs (forward, data
    and filter gradient); and the step again with float64's decisions
    imposed."""
    dev = torch.device("cuda") if dev is None else dev
    set_precision()
    print(card_line() if dev.type == "cuda" else dev)
    for kind in ("plain", "focal"):
        spec, host, inputs = _gap_inputs(kind)
        convs = [l for l in spec.layers if l.kind in ("conv", "convT")]
        g64, ref, _ = _gap_step(kind, host, inputs, dev, torch.float64,
                                deterministic_cudnn())
        big = max(float(v.abs().max()) for v in g64.values())
        sides = {"host": ("cpu", contextlib.nullcontext)}
        sides.update({f"card_{k}": (dev, c) for k, c in
                      CUDNN_SETTINGS.items()})
        res = {"decisions": sum(int(d.numel()) for d in ref.decisions)}
        grads, out_grads = {}, {}
        for side, (d, ctx) in sides.items():
            r = {}
            for mode in ("count", "pin"):
                g, br, flags = _gap_step(kind, host, inputs, d,
                                         torch.float32, ctx(), mode,
                                         ref.decisions)
                r[mode] = {"step_err": max(
                    float((g[p] - g64[p]).abs().max()) for p in g64) / big,
                    "flips": br.flips}
                if mode == "count":
                    grads[side], r["precision"] = g, flags
                    out_grads[side] = {
                        l.name: _rel64(c["gy"], ref.convs[i]["gy"].cpu())
                        for i, (l, c) in enumerate(zip(convs, br.convs))}
            res[side] = r
        res["first_diverging"] = {}
        for side in sides:
            if side == "host":
                continue
            hit = first_diverging_layer(spec, grads[side], grads["host"],
                                        g64)
            if hit:
                hit.update(gy_err_card=out_grads[side][hit["layer"]],
                           gy_err_host=out_grads["host"][hit["layer"]])
            res["first_diverging"][side] = hit
        alone = {}
        for side, (d, ctx) in sides.items():
            worst = [0.0, 0.0, 0.0]
            for c in ref.convs:
                want = _conv_alone(c, dev, torch.float64,
                                   deterministic_cudnn())
                got = _conv_alone(c, d, torch.float32, ctx())
                worst = [max(a, _rel64(g, w_))
                         for a, g, w_ in zip(worst, got, want)]
            alone[side] = dict(zip(("fwd", "dgrad", "wgrad"), worst))
        res["conv_alone_worst"] = alone
        print(f"dense gap, {kind} step (card above): " + json.dumps(res))
    return 0


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
        n_rounds = 1 if key in DENSE_ONE_ROUND else 2
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
    vols, mask = synthetic_subject(shape=RESUME_SHAPE, n_modalities=2,
                                   n_blobs=3, seed=0)
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
    """The multi-subject dense campaign (``DENSE_MULTI_RUNS``) over two
    ``MULTI_SHAPE`` subjects and one 96x96 of its depth, so two shape
    groups train; a ``MULTI_SHAPE`` test subject and a held one."""
    small = (96, 96, MULTI_SHAPE[2])
    s = [synthetic_subject(shape=sh, n_modalities=2, n_blobs=3, seed=i)
         for i, sh in enumerate((MULTI_SHAPE, MULTI_SHAPE, small,
                                 MULTI_SHAPE, MULTI_SHAPE))]
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
        budget = CLS_FI_QUERIES if rounds is None else k * rounds
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
        # core-set alone: it drives VGG19's forward, retrain and
        # evaluation, and K1 at VGG's fc2 width; entropy's selection runs
        # in the AlexNet levers
        vgg = _cls_runs(dev, os.path.join(top, "vgg"), InMemoryPool(Xv, yv),
                        [("core-set", "model_name=VGG19", 1)], "vgg19/")
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


# ---------------------------------------------------------------- serving
def forward_flops(model, x) -> float:
    """FLOPs (2 per multiply-add) of the convs and fcs of one forward of a
    float :class:`CNN` on the one-row batch ``x``, read off its shapes."""
    total = [0.0]

    def hook(mod, inp, out):
        per_out = mod.weight[0].numel()         # in * kh * kw, or in
        total[0] += 2.0 * per_out * out[0].numel()

    hooks = [m.register_forward_hook(hook) for m in model.children()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def _serve_subject(dev):
    """inference_bench.py's pw_full_volume subject cut to 256x256x32
    (``SERVE_SHAPE``), two modalities, seed 0, padded for 25x25 patches
    on the card."""
    vols, mask = synthetic_subject(shape=SERVE_SHAPE, n_modalities=2, seed=0)
    mu = np.array([float(v.mean()) for v in vols])
    sd = np.array([float(v.std()) for v in vols])
    return vols, mask, mu, sd, pad_volumes(vols, SERVE_PS, dev)


def _serve_ev(spec, padded, mu, sd, cd):
    """The bench's evaluator: grid spacing 2, z-chunk 4 (its stride-1
    clone sweeps one 65,536-patch slice a chunk)."""
    return GridPoolEvaluator(spec, padded, mu, sd, SERVE_PS, SERVE_SHAPE,
                             grid_spacing=2, z_chunk=SWEEP_Z_CHUNK,
                             compute_dtype=cd)


def int8_profile(qmodel, ev):
    """``torch.profiler`` window over one stride-1 int8 z-chunk (65,536
    patches: extraction, the int8 layers, softmax): device time under each
    ``int8/*`` range of ``models/cnn._int8_main``, the rest, the top
    kernels and the card's idle share between the first and last
    kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ev1 = ev.with_spacing(1)
    torch.cuda.synchronize()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        ev1._sweep_block(qmodel, 5, ("posteriors",))
        torch.cuda.synchronize()
    # the int8/* ranges also appear on the device timeline: kernels only
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith("int8/")]
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels))
    parts = {}
    for e in prof.key_averages():
        if e.key.startswith("int8/"):
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = getattr(e, "cuda_time_total", 0.0)
            parts[e.key] = t
    by_kernel = {}
    for e in kernels:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + \
            e.time_range.elapsed_us()
    res = {"device_busy_us": busy, "span_us": span,
           "idle_share": 1.0 - busy / span,
           "int8_range_device_us": parts,
           "outside_int8_ranges_us": busy - sum(parts.values()),
           "top_kernels_us": sorted(by_kernel.items(),
                                    key=lambda kv: -kv[1])[:10]}
    check(set(parts) >= {"int8/quantize", "int8/im2col", "int8/int_mm",
                         "int8/rescale"} and busy > 0,
          f"int8 profile ranges missing: {sorted(parts)}")
    return res


def phase_serve_pw(dev):
    """PW1 full-volume serving (inference_bench.py's pw_full_volume): every
    voxel of the 256x256x32 subject at stride 1, ``posteriors``, at f32,
    bf16 and int8 (bf16 surroundings), each after a one-slice warm-up;
    int8's and bf16's p1 against f32's, card vs host at f32 on 256
    voxels of each of 4 slices (the host's gather route, atol 1e-4), and
    a profiler window over one int8 z-chunk."""
    spec = create_pw1(2, 0.5, (25, 25, 2))
    model = init_cnn(spec, seed=0, device=dev)
    qmodel = quantize_model(model)
    check(is_quantized(qmodel), "quantize_model left float layers")
    vols, _, mu, sd, padded = _serve_subject(dev)
    n = int(np.prod(SERVE_SHAPE))
    flops = forward_flops(model, torch.zeros((1, 25, 25, 2), device=dev))
    res, vol = {"flops_per_voxel": flops}, {}
    for name, cd, m in (("float32", None, model),
                        ("bfloat16", torch.bfloat16, model),
                        ("int8", torch.bfloat16, qmodel)):
        ev = _serve_ev(spec, padded, mu, sd, cd)
        full_slice_patchwise(ev, m, [0], "posteriors")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        v = full_volume_patchwise(ev, m, "posteriors")
        secs = time.perf_counter() - t0
        check(v.shape == SERVE_SHAPE and v.dtype == np.float32
              and bool(np.isfinite(v).all()) and 0.0 <= v.min()
              and v.max() <= 1.0, f"{name} volume {v.shape} {v.dtype}")
        res[name] = {"voxels_per_s": n / secs, "wall_s": secs,
                     "tflops": n * flops / secs / 1e12,
                     "peak_bytes": torch.cuda.max_memory_allocated()}
        vol[name] = v
        if name == "int8":
            res["int8_profile"] = int8_profile(m, ev)
    p32 = vol["float32"]
    sure = np.abs(p32 - 0.5) > 0.05
    for name in ("bfloat16", "int8"):
        agree = (float(np.mean((vol[name][sure] > 0.5) == (p32[sure] > 0.5)))
                 if sure.any() else 1.0)
        res[name].update(
            max_abs_dp1_vs_f32=float(np.abs(vol[name] - p32).max()),
            agree_vs_f32=agree, confident_share=float(sure.mean()))
        check(agree >= 0.9, f"{name} agrees with f32 on {agree:.4f} of the "
              "confident voxels")
    s1, s2, s3 = SERVE_SHAPE
    rng = np.random.default_rng(7)
    inds = np.concatenate([rng.choice(s1 * s2, SERVE_CHECK_N, replace=False)
                           * s3 + z for z in SERVE_CHECK_SLICES])
    host_ev = PoolEvaluator(spec, pad_volumes(vols, SERVE_PS, "cpu"), mu, sd,
                            SERVE_PS, SERVE_SHAPE, ntb=1024)
    host = host_ev.evaluate(init_cnn(spec, seed=0, device="cpu"), inds,
                            ("posteriors",))["posteriors"]
    err = float(np.abs(host - p32.reshape(-1)[inds]).max())
    res["card_vs_host_f32"] = {"voxels": len(inds),
                               "slices": list(SERVE_CHECK_SLICES),
                               "max_abs": err}
    check(err <= 1e-4, f"full-volume p1 card vs host {err}")
    print("PW1 full-volume serving ok (256x256x32, stride 1; card above): "
          + json.dumps({k: res[k] for k in ("float32", "bfloat16", "int8",
                                            "card_vs_host_f32")}))
    print("int8 z-chunk profile: " + json.dumps(res["int8_profile"]))
    return res, spec, model, qmodel, padded, mu, sd, vol["bfloat16"]


def phase_int8_mm(dev, qmodel, dense_q):
    """``int8_matmul`` (``torch._int_mm``) on the card against its int32
    plain version on the host, on the same int8 codes: every PW1 layer's
    weight against a 256-patch batch of codes (convs at their unfolded
    row counts), and FC-DenseNet-103's widest conv against one 128x128
    slice.  The accumulators must be bit-equal; each call is timed."""
    gen = torch.Generator(device=dev).manual_seed(11)
    res = {}
    layers = [(l.name, getattr(qmodel, l.name), {"conv1": 625, "conv2": 625,
                                                 "conv3": 169, "conv4": 169
                                                 }.get(l.name, 1) * 256)
              for l in qmodel.spec.layers if l.kind in ("conv", "fc")]
    widest = max((l for l in dense_q.spec.layers if l.kind == "conv"),
                 key=lambda l: getattr(dense_q, l.name).W_q[0].numel())
    layers.append((f"dense/{widest.name}", getattr(dense_q, widest.name),
                   128 * 128))
    for name, mod, rows in layers:
        w = mod.W_q.reshape(mod.W_q.shape[0], -1)
        a = torch.randint(-127, 128, (rows, w.shape[1]), generator=gen,
                          device=dev, dtype=torch.int8)
        card = int8_matmul(a, w)
        host = int8_matmul(a.cpu(), w.cpu())
        equal = bool(torch.equal(card.cpu(), host))
        res[name] = {"m": rows, "k": int(w.shape[1]), "n": int(w.shape[0]),
                     "bit_equal": equal,
                     "ms": time_ms(lambda: int8_matmul(a, w), 5)}
        check(equal, f"_int_mm vs its int32 plain version at {name}")
    print("int8 GEMM card == host (bit for bit): " + json.dumps(res))
    return res


def phase_serve_offgrid(dev, spec, model, padded, mu, sd):
    """inference_bench.py's offgrid_pool at bf16: 65,536 scattered voxels
    (the router keeps the per-patch gather: K2 must launch) and a
    clustered ROI of 80% of 6 slices (the router takes the stride-1 slab
    sweep), with the gather route's rate on 8,192 of its voxels."""
    ev = _serve_ev(spec, padded, mu, sd, torch.bfloat16)
    s1, s2, s3 = SERVE_SHAPE
    rng = np.random.RandomState(0)
    scat = (rng.randint(0, s1, SERVE_SCATTERED) * s2
            + rng.randint(0, s2, SERVE_SCATTERED)) * s3 \
        + rng.randint(0, s3, SERVE_SCATTERED)
    scat[0] = (1 * s2 + 1) * s3 + 1
    check(not ev._offgrid_dense_worthwhile(scat), "scattered set routed "
          "to the slab sweep")
    plane = np.nonzero(rng.rand(s1, s2) < 0.8)
    base = (plane[0] * s2 + plane[1]) * s3
    clus = np.concatenate([base + z for z in range(6)])
    clus[0] = (1 * s2 + 1) * s3
    check(ev._offgrid_dense_worthwhile(clus), "ROI routed to the gather")

    def timed(fn, inds):
        fn(inds[:4096])
        torch.cuda.synchronize()
        k2 = ops.gather.KERNEL.launches
        t0 = time.perf_counter()
        out = fn(inds)
        return time.perf_counter() - t0, out, ops.gather.KERNEL.launches - k2

    def routed(inds):
        return ev.evaluate(model, inds, ("posteriors",))["posteriors"]

    def gather(inds):
        return PoolEvaluator.evaluate(ev, model, inds,
                                      ("posteriors",))["posteriors"]

    dt_s, out_s, k2_s = timed(routed, scat)
    dt_c, out_c, k2_c = timed(routed, clus)
    dt_g, out_g, k2_g = timed(gather, clus[:8192])
    err = float(np.abs(out_c[:8192] - out_g).max())
    res = {"scattered": {"n": len(scat), "patches_per_s": len(scat) / dt_s,
                         "wall_s": dt_s, "k2_launches": k2_s},
           "clustered": {"n": len(clus), "slices": 6,
                         "patches_per_s": len(clus) / dt_c, "wall_s": dt_c,
                         "k2_launches": k2_c},
           "clustered_gather_route": {"n": 8192,
                                      "patches_per_s": 8192 / dt_g,
                                      "k2_launches": k2_g},
           "slab_vs_gather_max_abs_bf16": err}
    check(k2_s >= len(scat) // 4096 and k2_c == 0 and k2_g >= 2,
          f"K2 launches: scattered {k2_s}, ROI {k2_c}, gather {k2_g}")
    check(bool(np.isfinite(out_s).all()) and err <= 2e-2,
          f"off-grid routes part: {err}")
    print("off-grid serving ok (bf16, card above): " + json.dumps(res))
    return res


def phase_serve_fcn(dev):
    """inference_bench.py's fcn_volume: ``FCNInference`` on FC-DenseNet-103
    at its published width and depth over 64 random 256x256x2 slices,
    batch 2, posteriors at f32, bf16 and int8 (the transposed convs
    float), on the model's BN state; then ``MC-posteriors`` (T 10) card vs
    host on two 128x128 crops with the same numpy dropout draws
    (``KeyedDraws``), atol 1e-4."""
    n, hw, batch = FCN_SERVE
    spec = create_model("Tiramisu", nclass=2, input_shape=(hw, hw, 2),
                        dropout_rate=0.2)
    model = init_cnn(spec, seed=0, device=dev)
    qmodel = quantize_model(model)
    bn = model.init_state()
    x = np.random.default_rng(0).normal(size=(n, hw, hw, 2)).astype(
        np.float32)
    flops = dense_flops(spec, (hw, hw))
    res, post = {"gflop_per_slice": flops / 1e9}, {}
    for name, cd, m in (("float32", None, model),
                        ("bfloat16", torch.bfloat16, model),
                        ("int8", None, qmodel)):
        inf = FCNInference(spec, batch=batch, compute_dtype=cd, bn_state=bn,
                           device=dev)
        inf.segment(m, x[:batch], "posteriors")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        p = inf.segment(m, x, "posteriors")
        secs = time.perf_counter() - t0
        check(p.shape == (n, hw, hw, 2) and bool(np.isfinite(p).all()),
              f"FCN {name} posteriors {p.shape}")
        res[name] = {"voxels_per_s": n * hw * hw / secs, "wall_s": secs,
                     "slices_per_s": n / secs,
                     "tflops": n * flops / secs / 1e12,
                     "peak_bytes": torch.cuda.max_memory_allocated()}
        post[name] = p[..., 1]
    for name in ("bfloat16", "int8"):
        res[name]["max_abs_dp1_vs_f32"] = float(
            np.abs(post[name] - post["float32"]).max())
        res[name]["agree_vs_f32"] = float(np.mean(
            (post[name] > 0.5) == (post["float32"] > 0.5)))
    crop = x[:2, :128, :128]
    host = init_cnn(spec, seed=0, device="cpu")
    with KeyedDraws(17):
        t0 = time.perf_counter()
        mc_card = FCNInference(spec, batch=batch, bn_state=bn, device=dev
                               ).segment(model, crop, "MC-posteriors",
                                         mc_T=10, rng=5)
        mc_s = time.perf_counter() - t0
        mc_host = FCNInference(spec, batch=batch,
                               bn_state=host.init_state(), device="cpu"
                               ).segment(host, crop, "MC-posteriors",
                                         mc_T=10, rng=5)
    err = float(np.abs(mc_card - mc_host).max())
    res["mc_posteriors_card_vs_host"] = {"T": 10, "slices": 2, "side": 128,
                                         "max_abs": err, "card_s": mc_s}
    check(err <= 1e-4, f"FCN MC-posteriors card vs host {err}")
    print("FCN serving ok (FC-DenseNet-103, 64 x 256x256x2, card above): "
          + json.dumps(res))
    return res, qmodel


def _noisy_map(shape, seed, corrupt=True):
    """A blob, its guide image and a noisy posterior of it (the JAX
    package's CRF test fixture at a larger size)."""
    rng = np.random.default_rng(seed)
    truth = np.zeros(shape)
    sl = tuple(slice(s // 4, 3 * s // 4) for s in shape)
    truth[sl] = 1.0
    img = truth * 60 + rng.normal(0, 3, shape)
    p1 = np.clip(0.8 * truth + 0.1 + rng.normal(0, 0.2, shape), 0.01, 0.99)
    return p1.astype(np.float32), img.astype(np.float32), truth


def phase_serve_crf(dev):
    """``meanfield_crf_2d`` card vs host on a 256x256 map (q within 1e-5),
    timed; the native solver's ``dcrf_postprocess_2d`` (``native`` equal
    to ``auto``) and ``dcrf_postprocess_3d`` on a 128x128x32 posterior
    volume, timed, each deterministic and lowering the error against the
    blob it was made from (the JAX package's CRF tests' rules)."""
    p1, img, truth = _noisy_map((CRF_2D, CRF_2D), 3)
    posts = torch.from_numpy(np.stack([1 - p1, p1], -1))
    imgt = torch.from_numpy(img)
    q_card = meanfield_crf_2d(posts.to(dev), imgt.to(dev))
    ms = time_ms(lambda: meanfield_crf_2d(posts.to(dev), imgt.to(dev)), 3,
                 warmup=1)
    t0 = time.perf_counter()
    q_host = meanfield_crf_2d(posts, imgt)
    host_s = time.perf_counter() - t0
    err = float((q_card.cpu() - q_host).abs().max())
    check(err <= 1e-5, f"meanfield_crf_2d card vs host {err}")
    check(crf_native.crf_native_available(), "native CRF did not build")
    t0 = time.perf_counter()
    lab = dcrf_postprocess_2d(p1, img, backend="native")
    native_2d_s = time.perf_counter() - t0
    check(np.array_equal(lab, dcrf_postprocess_2d(p1, img, backend="auto"))
          and np.mean(lab != truth) <= np.mean((p1 > 0.5) != truth),
          "native 2-D CRF")
    p3, img3, truth3 = _noisy_map(CRF_VOL, 4)
    t0 = time.perf_counter()
    lab3 = dcrf_postprocess_3d(p3, img3)
    native_3d_s = time.perf_counter() - t0
    err3 = (float(np.mean((p3 > 0.5) != truth3)),
            float(np.mean(lab3 != truth3)))
    check(lab3.shape == CRF_VOL and err3[1] < err3[0]
          and np.array_equal(lab3, dcrf_postprocess_3d(p3, img3)),
          f"native 3-D CRF errors {err3}")
    res = {"meanfield_2d": {"side": CRF_2D, "card_ms": ms, "host_s": host_s,
                            "card_vs_host_max_abs": err},
           "native_2d_s": native_2d_s, "native_3d_s": native_3d_s,
           "native_3d_shape": list(CRF_VOL),
           "native_3d_error_before_after": err3}
    print("CRF ok (card above; the native solver runs on the host): "
          + json.dumps(res))
    return res


def phase_run_on_subjects(dev, root):
    """``run_on_subjects`` on the f32 campaign's entropy weights over two
    synthetic held subjects (the campaign's shape, other seeds), float
    and int8: F-measures, seconds per subject, the files written."""
    expr = create_expr(root, synthetic=True, device=str(dev))
    held = [synthetic_subject(shape=SHAPE, n_modalities=2, n_blobs=3,
                              seed=s) for s in HELD_SEEDS]
    params = ckpt.load_checkpoint(os.path.join(
        root, "entropy", "curr_weights.npz"))[0]
    res, segs = {}, {}
    for name, p in (("float32", None),
                    ("int8", quantize_params(expr.build_model(), params))):
        out_dir = os.path.join(root, f"served_{name}")
        t0 = time.perf_counter()
        f = run_on_subjects(expr, "entropy", held, save_dir=out_dir,
                            params=p, device=str(dev))
        secs = time.perf_counter() - t0
        files = sorted(os.path.relpath(os.path.join(d, x), out_dir)
                       for d, _, fs in os.walk(out_dir) for x in fs)
        segs[name] = [np.load(os.path.join(out_dir, str(i), "segs.npy"))
                      for i in range(len(held))]
        check(files == [f"{i}/{x}" for i in range(len(held))
                        for x in ("F1_score.txt", "segs.npy")]
              and all(s.shape == SHAPE and s.dtype == np.uint8
                      for s in segs[name])
              and all(np.isfinite(v) for v in f.values()),
              f"run_on_subjects {name}: {files} {f}")
        res[name] = {"f_measure": [f[i] for i in range(len(held))],
                     "seconds_per_subject": secs / len(held),
                     "files": files}
    res["int8_vs_float_voxel_agreement"] = float(np.mean(
        [np.mean(a == b) for a, b in zip(segs["int8"], segs["float32"])]))
    check(res["int8_vs_float_voxel_agreement"] >= 0.9,
          f"int8 segmentations part from float: {res}")
    print("run_on_subjects ok (card above): " + json.dumps(res))
    return res


def fresh_serve(root, device):
    """The campaign subject served at f32 with the entropy weights of the
    experiment at ``root``, twice: through a bare stride-1
    ``GridPoolEvaluator`` made before any engine (the engine-less route),
    then through ``run_on_subjects``, whose posteriors a spy on the
    ``full_volume_patchwise`` it calls keeps.  Returns the flags read at
    the start and after each route, both posterior volumes (p1) and
    ``run_on_subjects``' F-measure."""
    ros = sys.modules[run_on_subjects.__module__]
    flags = {"at_start": precision_flags()}
    cfg = ExperimentConfig.from_yaml(os.path.join(root, "parameters.txt"))
    shape = tuple(cfg.synthetic_shape)
    vols, mask = synthetic_subject(shape=shape, n_modalities=2, n_blobs=3,
                                   seed=cfg.seed)
    d1, d2, d3 = ps = tuple(cfg.model.patch_shape)
    spec = create_model(cfg.model.model_name, nclass=cfg.model.nclass,
                        dropout_rate=cfg.model.dropout_rate,
                        patch_shape=(d1, d2, 2 * d3))
    params = ckpt.load_checkpoint(os.path.join(
        root, "entropy", "curr_weights.npz"))[0]
    stats = multimg_stats([(vols, mask)])[0]
    ev = GridPoolEvaluator(spec, pad_volumes(vols, ps, device=device),
                           stats[0::2], stats[1::2], ps, shape,
                           grid_spacing=1, ntb=cfg.query.ntb)
    bare = full_volume_patchwise(ev, ros.serving_model(spec, params, device),
                                 "posteriors")
    flags["after_bare"] = precision_flags()
    del ev
    kept, orig = [], ros.full_volume_patchwise

    def spy(evaluator, model, op="prediction"):
        kept.append(orig(evaluator, model, "posteriors"))
        return orig(evaluator, model, op)

    expr = create_expr(root, synthetic=True, device=device)
    ros.full_volume_patchwise = spy
    try:
        f = ros.run_on_subjects(expr, "entropy", [(vols, mask)],
                                device=device)[0]
    finally:
        ros.full_volume_patchwise = orig
    flags["after_run_on_subjects"] = precision_flags()
    return flags, bare, kept[0], f


def fresh_child(root, out, device="cuda") -> int:
    """The child of :func:`compare_fresh`, a process that applies no
    precision policy of its own: writes both posterior volumes of
    :func:`fresh_serve` to ``out`` (npz) and prints the flags and the
    F-measure as JSON."""
    flags, bare, served, f = fresh_serve(root, device)
    np.savez(out, bare=bare, run_on_subjects=served)
    print(json.dumps({"flags": flags, "f_measure": f}))
    return 0


def compare_fresh(dev, root, port=ROOT) -> dict:
    """:func:`fresh_serve` in a child process that never calls
    ``set_precision`` (this file loaded by path, with the port tree
    ``port`` first on its path) against the same call in this process,
    which did: the child's flags and seconds, and per route the distance
    of its posteriors from this process's."""
    t0 = time.perf_counter()
    out = os.path.join(root, "fresh_child.npz")
    code = ("import importlib.util, sys; sys.path.insert(0, %r); "
            "s = importlib.util.spec_from_file_location('chip_smoke_child', "
            "%r); m = importlib.util.module_from_spec(s); "
            "s.loader.exec_module(m); sys.exit(m.fresh_child(%r, %r, %r))"
            % (port, os.path.abspath(__file__), root, out, str(dev)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=port,
                          capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"the fresh-process child failed (rc "
          f"{proc.returncode}): {proc.stderr[-3000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    res = {"port": port, "child": child, "child_s": time.perf_counter() - t0}
    t1 = time.perf_counter()
    flags, bare, served, f = fresh_serve(root, dev)
    res["in_process"] = {"flags": flags, "f_measure": f,
                         "s": time.perf_counter() - t1}
    with np.load(out) as z:
        got = {"bare": z["bare"], "run_on_subjects": z["run_on_subjects"]}
    os.remove(out)
    for name, want in (("bare", bare), ("run_on_subjects", served)):
        g, d = got[name], np.abs(got[name] - want)
        res[name] = {"voxels": int(g.size),
                     "bit_equal": bool(np.array_equal(g, want)),
                     "max_abs_dp1": float(d.max()),
                     "mean_abs_dp1": float(d.mean()),
                     "predictions_differing": int(np.sum(
                         (g > 0.5) != (want > 0.5)))}
    return res


def phase_fresh_precision(dev, root):
    """The precision policy in a fresh process (:func:`compare_fresh`):
    after each route the child's flags are the IEEE policy
    (``cudnn.allow_tf32``, ``cuda.matmul.allow_tf32`` and bf16
    reduced-precision reduction False), and each route's posteriors equal
    this process's bit for bit, or within 1e-6 with equal predictions,
    and so does the F-measure."""
    res = compare_fresh(dev, root)
    child = res["child"]
    ok_flags = all(child["flags"][k][n] is v for k in (
        "after_bare", "after_run_on_subjects") for n, v in IEEE_FLAGS.items())
    check(ok_flags and child["f_measure"] == res["in_process"]["f_measure"]
          and all(r["bit_equal"] or (r["max_abs_dp1"] <= 1e-6
                                     and not r["predictions_differing"])
                  for r in (res["bare"], res["run_on_subjects"])),
          f"fresh-process f32 serving differs from in-process: {res}")
    print("fresh-process precision ok (card above): " + json.dumps(res))
    return res


def dev_fresh_precision(port) -> int:
    """``python3 chip_smoke.py --fresh-precision-port PORT``: a
    development measurement, not a smoke phase.  :func:`compare_fresh`
    with the port tree at ``PORT`` in the child (an earlier commit's tree
    from ``git archive``, say) on the f32 campaign's configuration and
    ``add_method``'s initial entropy weights; printed, not checked."""
    dev = torch.device("cuda")
    set_precision()
    print(card_line())
    root = os.path.join(ROOT, "_smoke_expr", "fresh_dev")
    shutil.rmtree(root, ignore_errors=True)
    try:
        create_expr(root, OVERRIDES, synthetic=True,
                    device=dev).add_method("entropy")
        print("fresh-process precision against the port at "
              f"{port}: " + json.dumps(compare_fresh(dev, root, port)))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


def phase_rmsprop_resume(dev):
    """``optimizer_name: RMSProp``: a 2-round random campaign on the
    campaign subject cut to 8 slices run uninterrupted, and again
    stopped after round 1 and resumed by a fresh
    ``PWExperiment`` from its resume point (``nu`` and ``trace`` in the
    file): the final ``curr_weights.npz``, the journal and
    ``perf_evals.txt`` bit-identical."""
    top = os.path.join(ROOT, "_smoke_expr", "rmsprop")
    shutil.rmtree(top, ignore_errors=True)
    vols, mask = synthetic_subject(shape=RMSPROP_SHAPE, n_modalities=2,
                                   n_blobs=3, seed=0)
    pars = set_parameters(DEFAULT_PARS, RMSPROP)

    def fresh(root):
        expr = pw_experiment.PWExperiment(
            root, ExperimentConfig.from_pars(pars), device=dev)
        expr.attach_subject(vols, mask)
        return expr

    def artifacts(root):
        mdir = os.path.join(root, "random")
        with np.load(os.path.join(mdir, "curr_weights.npz")) as z:
            w = {k: z[k] for k in z.files}
        q = {n: open(os.path.join(mdir, "queries", n)).read()
             for n in sorted(os.listdir(os.path.join(mdir, "queries")))}
        with open(os.path.join(mdir, "perf_evals.txt")) as f:
            return w, q, f.read()

    try:
        t0 = time.perf_counter()
        for name, stops in (("a", (128,)), ("b", (64, 128))):
            expr = fresh(os.path.join(top, name))
            expr.prep_data()
            expr.add_method("random")
            for n_q in stops:
                expr.run_method("random", n_q)
                expr = fresh(os.path.join(top, name))
        wa, qa, ea = artifacts(os.path.join(top, "a"))
        wb, qb, eb = artifacts(os.path.join(top, "b"))
        diff = sorted(k for k in set(wa) | set(wb)
                      if k not in wa or k not in wb
                      or not np.array_equal(wa[k], wb[k]))
        n_opt = sum(k.startswith("opt/") for k in wa)
        res = {"rounds": 2, "opt_leaves": n_opt, "differing_entries": diff,
               "queries_equal": qa == qb, "perf_evals_equal": ea == eb,
               "seconds": time.perf_counter() - t0}
        check(not diff and qa == qb and ea == eb and len(qa) == 2
              and n_opt == 2 * 14, f"RMSProp resume != continue: {res}")
        print(f"RMSProp resume == continue ok (bit for bit): "
              f"{json.dumps(res)}")
        return res
    finally:
        shutil.rmtree(top, ignore_errors=True)


def phase_serving(dev):
    """The serving phases (module docstring), the launch counts zeroed
    just before and read just after."""
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    pw, spec, model, qmodel, padded, mu, sd, vol16 = phase_serve_pw(dev)
    # the bf16 volume and what made it: the sharded segmenter's reference
    serve = (model, padded, mu, sd, vol16)
    offgrid = phase_serve_offgrid(dev, spec, model, padded, mu, sd)
    del padded
    fcn, dense_q = phase_serve_fcn(dev)
    int8_mm = phase_int8_mm(dev, qmodel, dense_q)
    del model, qmodel, dense_q
    crf = phase_serve_crf(dev)
    rmsprop = phase_rmsprop_resume(dev)
    counts = {k.name: k.launches for k in ops.KERNELS}
    check(counts["gather_patches_normalized"] > 0,
          "K2 never launched in the serving phases")
    return {"pw": pw, "offgrid": offgrid, "fcn": fcn, "int8_mm": int8_mm,
            "crf": crf, "rmsprop_resume": rmsprop, "counts": counts,
            "seconds": time.perf_counter() - t0, "serve": serve}


# ------------------------------------------------------------ multi-device
def _dp_mesh(dev):
    """The 2-shard mesh over the one card, given explicitly (a mesh of
    distinct cards needs two)."""
    card = torch.device("cuda", torch.cuda.current_device())
    return make_mesh(PARALLEL_DP, device=[card] * PARALLEL_DP)


def _campaign_subject(dev):
    """The f32 campaign's subject as ``create_expr`` builds it, its
    training statistics and its padded volume on the card."""
    vols, mask = synthetic_subject(shape=SHAPE, n_modalities=2, n_blobs=3,
                                   seed=0)
    stats = multimg_stats([(vols, mask)])
    return vols, mask, stats[0, 0::2], stats[0, 1::2], pad_volumes(
        vols, (25, 25, 1), dev)


def _equal(name, a, b):
    """Fail unless ``a`` (sharded) and ``b`` (unsharded) are bit-equal."""
    a, b = (x.cpu().numpy() if isinstance(x, torch.Tensor) else
            np.asarray(x) for x in (a, b))
    if a.shape != b.shape:
        raise SmokeFailure(f"{name}: shapes {a.shape} != {b.shape}")
    if not np.array_equal(a, b):
        gap = np.abs(a.astype(np.float64) - b).max()
        raise SmokeFailure(f"{name}: sharded != unsharded (max |d| {gap})")


def phase_sharded_evaluator(dev, model, padded, mu, sd, mesh):
    """``ShardedGridPoolEvaluator`` (2 shards on the card) against the
    unsharded evaluator on the campaign subject's test grid (131,072
    rows): posteriors, the campaign's MC passes (running average of
    ``MC_ITERS`` keyed passes), ``fim_sweep`` and ``perturb_sweep``, bit
    for bit; each timed on both."""
    ps = (25, 25, 1)
    args = (model.spec, padded, mu, sd, ps, SHAPE)
    ev1 = GridPoolEvaluator(*args, grid_spacing=2, ntb=4096)
    evs = ShardedGridPoolEvaluator(mesh, *args, grid_spacing=2, ntb=4096)
    test = generate_grid_samples(SHAPE, 2)
    out = {"rows": len(test), "shards": len(evs._shard_evs),
           "z_chunks_per_shard": [len(s) for _, s in evs._shard_evs]}
    sweeps = {
        "posteriors": lambda ev: ev.evaluate(model, test)["posteriors"],
        "mc": lambda ev: mc_average_posteriors(ev, model, test, MC_ITERS,
                                               17, as_device=True),
        "fim": lambda ev: ev.fim_sweep(model, as_device=True),
        "perturb": lambda ev: ev.perturb_sweep(model, 23, as_device=True)}
    for name, fn in sweeps.items():
        got = {}
        for tag, ev in (("unsharded", ev1), ("sharded", evs)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got[tag] = fn(ev)
            torch.cuda.synchronize()
            out[f"{name}_{tag}_s"] = time.perf_counter() - t0
        a, b = got["sharded"], got["unsharded"]
        if isinstance(a, dict):
            for k in a:
                _equal(f"{name}/{k}", a[k], b[k])
        else:
            _equal(name, a, b)
    out["bytes_moved"] = evs.bytes_moved
    return out


def phase_dp_campaigns(dev, mesh, picks0):
    """One round each of entropy and core-set at ``data_parallel`` 2, the
    mesh handed to the engine; round 0's picks must equal the f32
    campaign's (``data_parallel`` 1, the same configuration)."""
    out = {"seconds": {}, "by_method": {}}
    for method in ("entropy", "core-set"):
        root = os.path.join(ROOT, "_smoke_expr", "parallel", method)
        shutil.rmtree(root, ignore_errors=True)
        k1_0 = ops.similarity.KERNEL.launches
        k2_0 = ops.gather.KERNEL.launches
        t0 = time.perf_counter()
        cfg = ExperimentConfig.from_pars(set_parameters(
            DEFAULT_PARS, OVERRIDES + f",data_parallel={PARALLEL_DP}"))
        expr = pw_experiment.PWExperiment(root, cfg, device=dev, mesh=mesh)
        expr.attach_subject(*synthetic_subject(
            shape=SHAPE, n_modalities=2, n_blobs=3, seed=cfg.seed))
        expr.prep_data()
        ev = expr.make_evaluator(expr.build_model())
        check(isinstance(ev, ShardedGridPoolEvaluator) and ev.mesh is mesh,
              f"dp {method}: evaluator {type(ev).__name__}")
        del ev
        expr.add_method(method)
        res = expr.run_method(method, 64)
        torch.cuda.synchronize()
        out["seconds"][method] = time.perf_counter() - t0
        dk1 = ops.similarity.KERNEL.launches - k1_0
        dk2 = ops.gather.KERNEL.launches - k2_0
        out["by_method"][method] = {"rowmax_similarity": dk1,
                                    "gather_patches_normalized": dk2}
        got = np.loadtxt(os.path.join(root, method, "queries", "0.txt"),
                         dtype=np.int64)
        check(len(res["perf"]) == 1 and np.array_equal(got, picks0[method]),
              f"dp {method}: round 0 picks part from data_parallel 1's")
        check(dk2 >= 1 and (dk1 >= 1 if method == "core-set" else True),
              f"dp {method}: K1 +{dk1}, K2 +{dk2}")
        with open(os.path.join(root, method, "phases.jsonl")) as f:
            out.setdefault("rounds", {})[method] = [
                json.loads(line) for line in f]
        shutil.rmtree(root, ignore_errors=True)
    return out


def phase_selectors(dev, model, padded, mu, sd, mesh, serve):
    """The sharded selectors at 2 shards on the card (the pool selector
    through K2, the grid and FIM-grid selectors, top 64 / B 200) and the
    bf16 dense segmenter on the serving subject; then, outside the counted
    window, their unsharded references: values and volumes bitwise,
    indices equal."""
    ps = (25, 25, 1)
    pool, _ = even_odd_slice_split(generate_grid_samples(SHAPE, 2), SHAPE)
    res, t = {}, {}

    def run(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[name] = fn()
        torch.cuda.synchronize()
        t[name] = time.perf_counter() - t0

    run("pool", lambda: make_sharded_pool_selector(
        mesh, ps, SHAPE, 64, ntb_per_shard=4096)(model, padded, mu, sd, pool))
    run("grid", lambda: make_sharded_grid_selector(
        mesh, ps, SHAPE, 2, 64, z_inner=2)(model, padded, mu, sd))
    run("fim_grid", lambda: make_sharded_fim_grid_selector(
        mesh, ps, SHAPE, 2, 200, z_inner=2)(model, padded, mu, sd))
    smodel, spadded, smu, ssd, svol = serve
    run("segmenter_bf16", lambda: make_sharded_dense_segmenter(
        mesh, SERVE_PS, SERVE_SHAPE, z_inner=1,
        compute_dtype=torch.bfloat16)(smodel, spadded, smu, ssd))
    counts = {k.name: k.launches for k in ops.KERNELS}
    # the references (launches not counted)
    p1 = torch.as_tensor(PoolEvaluator(model.spec, padded, mu, sd, ps,
                                       SHAPE, ntb=4096).evaluate(
        model, pool)["posteriors"])
    v, i = stable_topk(-(p1 - 0.5).abs(), 64)
    _equal("pool selector values", res["pool"][0], v)
    _equal("pool selector positions", res["pool"][1], i)
    ev2 = GridPoolEvaluator(model.spec, padded, mu, sd, ps, SHAPE,
                            grid_spacing=2, z_chunk=2)
    rows = grid_row_to_voxel(np.arange(ev2.nx * ev2.ny * ev2.nz), SHAPE, 2)
    p1 = torch.as_tensor(ev2.evaluate(model, rows)["posteriors"])
    v, i = stable_topk(-(p1 - 0.5).abs(), 64)
    _equal("grid selector values", res["grid"][0], v)
    _equal("grid selector rows", res["grid"][1], i)
    ref = ev2.fim_sweep(model, as_device=True)
    v, i = stable_topk(-ref["uncertainty"], 200)
    for name, a, b in (("values", res["fim_grid"][0], v),
                       ("rows", res["fim_grid"][1], i),
                       ("p1", res["fim_grid"][2], ref["p1"][i]),
                       ("shrunk", res["fim_grid"][3], ref["shrunk"][i])):
        _equal(f"FIM grid selector {name}", a, b)
    _equal("bf16 dense segmenter", res["segmenter_bf16"], svol)
    return {"seconds": t, "counts": counts,
            "pool_candidates": len(pool), "grid_rows": len(rows),
            "segmenter_voxels": int(np.prod(SERVE_SHAPE))}


def phase_nccl(dev, model):
    """An in-process ``nccl`` group of world size 1: its DP step (Adam,
    deterministic cuDNN, dropout from one key) equals a plain Adam step on
    the same masks bit for bit, and ``sharded_pool_topk`` equals a plain
    top-k; then the group is destroyed."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    init_distributed(f"localhost:{free_port()}", 1, 0)
    try:
        check(dist.get_backend() == "nccl", dist.get_backend())
        pmesh = make_multihost_mesh(1)
        g = torch.Generator().manual_seed(5)
        x = torch.randn((128, 25, 25, 2), generator=g).to(dev)
        y = torch.nn.functional.one_hot(torch.arange(128) % 2, 2).float().to(
            dev)
        with deterministic_cudnn():
            local = shard_params(model, pmesh)
            state = TrainState(local, make_optimizer("Adam", 1e-3,
                                                     local.parameters()))
            loss = make_sharded_train_step(pmesh)(state, x, y, 9)
            ref = copy.deepcopy(model)
            opt = make_optimizer("Adam", 1e-3, ref.parameters())
            logits = ref(x, train=True,
                         generator=core_rng.key_stream(9, dev)).logits
            ref_loss = (-(y * torch.log_softmax(logits, -1)).sum(-1)).sum() \
                / x.shape[0]
            ref_loss.backward()
            opt.step()
        check(float(loss) == float(ref_loss.detach()) and all(
            torch.equal(a, b) for a, b in zip(local.parameters(),
                                              ref.parameters())),
              "the world-size-1 DP step part from the plain step")
        dense = dense_dp_step(dev, pmesh, g)
        scores = torch.randn(4096, generator=g).to(dev)
        scores[100] = scores[7] = scores.max()
        vals, idx = sharded_pool_topk(pmesh, lambda m, s: s, 64)(None,
                                                                 scores)
        v, i = stable_topk(scores, 64)
        check(torch.equal(vals, v) and torch.equal(idx, i)
              and idx[:2].tolist() == [7, 100],
              "sharded_pool_topk part from the plain top-k")
    finally:
        dist.destroy_process_group()
    return {"seconds": time.perf_counter() - t0, "loss": float(loss),
            "dense": dense}


def dense_dp_step(dev, pmesh, g):
    """The DP step on batch norm and skips: 2-D FC-DenseNet-103 (the dense
    phase's model) on 2 slices of 128x128x2 with per-pixel labels, Adam,
    dropout from one key, deterministic cuDNN, in the world-size-1 group:
    loss and parameters equal to the plain step's bit for bit."""
    spec = create_model("Tiramisu", nclass=2, input_shape=(128, 128, 2),
                        dropout_rate=0.2)
    model = init_cnn(spec, 3, device=dev)
    x = torch.randn((2, 128, 128, 2), generator=g).to(dev)
    y = torch.nn.functional.one_hot(torch.randint(0, 2, (2, 128, 128),
                                                  generator=g), 2).float()
    y = y.to(dev)
    t0 = time.perf_counter()
    with deterministic_cudnn():
        local = shard_params(model, pmesh)
        state = TrainState(local, make_optimizer("Adam", 1e-3,
                                                 local.parameters()))
        loss = make_sharded_train_step(pmesh)(state, x, y, 11)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        ref = copy.deepcopy(model)
        opt = make_optimizer("Adam", 1e-3, ref.parameters())
        logits = ref(x, train=True,
                     generator=core_rng.key_stream(11, dev)).logits
        per = -(y * torch.log_softmax(logits, -1)).sum(-1)
        ref_loss = per.sum() / per.numel()
        ref_loss.backward()
        opt.step()
    check(float(loss) == float(ref_loss.detach()) and all(
        torch.equal(a, b) for a, b in zip(local.parameters(),
                                          ref.parameters())),
          "the world-size-1 DP step of FC-DenseNet-103 part from the plain "
          "step")
    return {"loss": float(loss), "step_s": step_s, "bit_equal": True}


def phase_parallel(dev, kept, serve):
    """The multi-device phases (module docstring): the counts zeroed just
    before the data_parallel campaigns and the sharded selectors, read
    just after."""
    t0 = time.perf_counter()
    mesh = _dp_mesh(dev)
    _, _, mu, sd, padded = _campaign_subject(dev)
    model = CNN(create_pw1(2, 0.5, (25, 25, 2)))
    model.load_state_dict(from_jax_params(kept["entropy_params"]))
    model = model.to(dev)
    torch.cuda.reset_peak_memory_stats()
    evaluator = phase_sharded_evaluator(dev, model, padded, mu, sd, mesh)
    ops.reset_launch_counts()
    campaigns = phase_dp_campaigns(dev, mesh, kept["picks0"])
    counts_campaigns = {k.name: k.launches for k in ops.KERNELS}
    selectors = phase_selectors(dev, model, padded, mu, sd, mesh, serve)
    # read just after the selectors' counted window: campaigns + selectors
    counts = selectors["counts"]
    for k in ops.KERNELS:
        check(counts[k.name] > 0,
              f"{k.name} never launched on the multi-device path")
    nccl = phase_nccl(dev, model)
    try:
        make_mesh(2)
        raised = None
    except ValueError as e:
        raised = str(e)
    check(torch.cuda.device_count() > 1 or (raised is not None
                                            and "found 1" in raised),
          f"make_mesh(2) on one card: {raised}")
    out = {"evaluator": evaluator, "campaigns": campaigns,
           "selectors": selectors, "nccl": nccl,
           "make_mesh_2_raises": raised, "counts": counts,
           "counts_campaigns": counts_campaigns,
           "bytes_moved_between_devices": evaluator["bytes_moved"],
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "seconds": time.perf_counter() - t0}
    print("multi-device ok (2 shards on the card above): " + json.dumps(
        {k: v for k, v in out.items() if k != "campaigns"}
        | {"campaign_s": campaigns["seconds"],
           "campaign_launches": campaigns["by_method"]}))
    return out


def phase_analysis(dev, kept, multi_root):
    """The analysis routines on the card: ``full_model_eval`` and
    ``full_model_pred_dcrf`` (native CRF) of the f32 entropy weights on one
    slice of a held subject, card against host; ``test_scores_matrix``
    over the kept multi-subject ``entropy@mt`` run's rounds (resumed from
    its file); ``train_with_registries`` for 6 steps of PW1 on 128
    campaign patches gathered by K2."""
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    top = os.path.join(ROOT, "_smoke_expr", "analysis")
    shutil.rmtree(top, ignore_errors=True)
    out = {}
    try:
        spec = create_pw1(2, 0.5, (25, 25, 2))
        vols, mask, mu, sd, padded = _campaign_subject(dev)
        hvols, hmask = synthetic_subject(shape=ANALYSIS_SHAPE,
                                         n_modalities=2, n_blobs=3,
                                         seed=HELD_SEEDS[0])
        z = ANALYSIS_SHAPE[2] // 2
        res = {}
        for side, d in (("card", dev), ("host", torch.device("cpu"))):
            m = CNN(spec)
            m.load_state_dict(from_jax_params(kept["entropy_params"]))
            m = m.to(d)
            ev = GridPoolEvaluator(spec, pad_volumes(hvols, (25, 25, 1), d),
                                   mu, sd, (25, 25, 1), ANALYSIS_SHAPE,
                                   grid_spacing=2, ntb=4096)
            t1 = time.perf_counter()
            preds, f1 = full_model_eval(ev, m, hmask, [z],
                                        save_dir=os.path.join(top, side))
            dpreds, df1 = full_model_pred_dcrf(
                ev, m, hvols[0], hmask, [z], save_dir=os.path.join(top, side),
                backend="native")
            res[side] = {"preds": preds[:, :, z], "f1": f1,
                         "dcrf": dpreds[:, :, z], "dcrf_f1": df1,
                         "seconds": time.perf_counter() - t1}
            if side == "card":
                p1 = full_slice_patchwise(ev, m, [z], "posteriors")[z]
        sure = np.abs(p1 - 0.5) > 1e-4
        c, h = res["card"], res["host"]
        agree = float(np.mean(c["dcrf"] == h["dcrf"]))
        check(np.array_equal(c["preds"][sure], h["preds"][sure])
              and abs(c["f1"] - h["f1"]) <= 1e-3 and agree >= 0.999
              and abs(c["dcrf_f1"] - h["dcrf_f1"]) <= 1e-3
              and all(os.path.exists(os.path.join(top, s, f))
                      for s in ("card", "host")
                      for f in ("segs.npy", "F1_score.txt",
                                "dcrf_segs.npy", "F1_score_dcrf.txt")),
              f"analysis card vs host: F {c['f1']} / {h['f1']}, dcrf F "
              f"{c['dcrf_f1']} / {h['dcrf_f1']}, dcrf agreement {agree}")
        out["full_model"] = {
            "slice": z, "voxels": int(np.prod(ANALYSIS_SHAPE[:2])),
            "f1": {"card": c["f1"], "host": h["f1"]},
            "dcrf_f1": {"card": c["dcrf_f1"], "host": h["dcrf_f1"]},
            "dcrf_agreement": agree,
            "unsure_voxels": int((~sure).sum()),
            "seconds": {"card": c["seconds"], "host": h["seconds"]}}
        # test_scores_matrix over the multi entropy run's history copies
        train, test, held = multi_subjects(MULTI_SHAPE)
        mexpr = multi_experiment.MultiImgExperiment(multi_root, device=dev)
        mexpr.attach_subjects(train, test, held)
        t1 = time.perf_counter()
        scores = test_scores_matrix(mexpr, "entropy")
        out["test_scores"] = {"matrix": scores.tolist(),
                              "seconds": time.perf_counter() - t1}
        again = test_scores_matrix(mexpr, "entropy", start_ind=1)
        check(scores.shape == (1, 2) and bool(np.isfinite(scores).all())
              and np.array_equal(again, scores),
              f"test_scores_matrix {scores} / resumed {again}")
        # train_with_registries: 6 steps of PW1 at full width
        pool, _ = even_odd_slice_split(generate_grid_samples(SHAPE, 2),
                                       SHAPE)
        inds = torch.as_tensor(np.random.default_rng(3).choice(
            pool, 256, replace=False)).to(dev)
        x = gather_patches_normalized(
            padded, inds, torch.as_tensor(mu, dtype=torch.float32).to(dev),
            torch.as_tensor(sd, dtype=torch.float32).to(dev), (25, 25, 1),
            SHAPE)
        lab = np.nan_to_num(mask.ravel()[inds.cpu().numpy()]).astype(int)
        y = torch.nn.functional.one_hot(torch.as_tensor(lab), 2).float().to(
            dev)
        xt, yt, xv, yv = x[:128], y[:128], x[128:], y[128:]

        def gen():
            while True:
                yield xt, yt

        model = init_cnn(spec, seed=1, device=dev)
        state = TrainState(model, make_optimizer("Adam", 1e-3,
                                                 model.parameters()))
        regs = [MetricRegistry(("av_acc", "av_loss"), lambda: (xv, yv)),
                MetricRegistry(("F1",), lambda: (xv, yv))]
        t1 = time.perf_counter()
        state = train_with_registries(
            state, make_train_step(), gen(), step_limit=6, rng=4,
            registries=regs, eval_every=3, save_path=os.path.join(top, "reg"),
            track="av_acc")
        losses = state.metrics["train_loss"]
        check(state.step == 6 and len(losses) == 6
              and bool(np.isfinite(losses).all())
              and len(regs[0].history["av_acc"]) == 3
              and all(os.path.exists(os.path.join(top, "reg", f)) for f in (
                  "av_acc_0.txt", "av_loss_0.txt", "F1_1.txt",
                  "max_valid_iter.txt", "max_model_pars.npz")),
              f"train_with_registries: {losses} {regs[0].history}")
        out["registries"] = {"train_loss": losses,
                             "history": [r.history for r in regs],
                             "seconds": time.perf_counter() - t1}
    finally:
        shutil.rmtree(top, ignore_errors=True)
        shutil.rmtree(multi_root, ignore_errors=True)
    out["counts"] = {k.name: k.launches for k in ops.KERNELS}
    check(out["counts"]["gather_patches_normalized"] > 0,
          "K2 never launched in the analysis phase")
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["bytes_moved_between_devices"] = 0
    out["seconds"] = time.perf_counter() - t0
    print("analysis ok (card above): " + json.dumps(out))
    return out


class _FirstCall:
    """Stand in for ``module.name`` while active: remember the arguments of
    the first call, then call through (the kernel checks below re-run a
    kernel on the inputs the main path gave it)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.args = None

    def __call__(self, *args, **kw):
        if self.args is None:
            self.args = (args, kw)
        return self.orig(*args, **kw)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class _Interrupted(Exception):
    pass


def _write_volume(path, arr):
    if path.endswith(".nrrd"):
        write_nrrd(path, arr)
    else:
        write_nifti(path, arr)


def _held_bit_equal(name, got, want):
    vols, mask = got
    check(len(vols) == len(want[0])
          and all(a.dtype == b.dtype and np.array_equal(a, b)
                  for a, b in zip(vols, want[0]))
          and mask.dtype == want[1].dtype
          and np.array_equal(mask, want[1], equal_nan=True),
          f"formats: the subject read from {name} is not the one in memory")


def formats_files(top, vols, mask):
    """The campaign's subject written as gzip NRRD (``hakim``) and as
    ``.nii`` (``iseg2017``) plus ``.nii.gz`` copies; each read back through
    ``registry_for`` / ``SubjectRegistry.from_lists`` and ``Subject.load``
    and held bit-equal to the subject in memory.  Returns the ``hakim``
    subject and the write and read seconds."""
    out = {"write_s": {}, "read_s": {}, "bytes": {}}
    subjects = {}
    for conv_name in ("hakim", "iseg2017"):
        conv = DATASET_CONVENTIONS[conv_name]
        sdir = os.path.join(top, conv_name, "subject0")
        os.makedirs(sdir)
        t0 = time.perf_counter()
        for name, v in zip(conv.modalities, vols):
            _write_volume(os.path.join(sdir, name), v)
        _write_volume(os.path.join(sdir, conv.mask), mask)
        out["write_s"][conv_name] = time.perf_counter() - t0
        out["bytes"][conv_name] = sum(
            os.path.getsize(os.path.join(sdir, f)) for f in os.listdir(sdir))
        t0 = time.perf_counter()
        reg = registry_for(conv_name, os.path.join(top, conv_name))
        check(len(reg.subjects) == 1, f"formats: {conv_name} registry "
              f"holds {len(reg.subjects)} subjects")
        loaded = reg.subjects[0].load()
        out["read_s"][conv_name] = time.perf_counter() - t0
        _held_bit_equal(conv_name, loaded, (vols, mask))
        subjects[conv_name] = reg.subjects[0]
    iseg = subjects["iseg2017"]
    gz = [p + ".gz" for p in iseg.modality_paths + [iseg.mask_path]]
    t0 = time.perf_counter()
    for p, v in zip(gz, list(vols) + [mask]):
        write_nifti(p, v)
    out["write_s"]["nii.gz"] = time.perf_counter() - t0
    out["bytes"]["nii.gz"] = sum(os.path.getsize(p) for p in gz)
    t0 = time.perf_counter()
    (sub,) = SubjectRegistry.from_lists([gz[:-1]], [gz[-1]]).subjects
    loaded = sub.load()
    out["read_s"]["nii.gz"] = time.perf_counter() - t0
    _held_bit_equal("nii.gz", loaded, (vols, mask))
    return subjects["hakim"], out


def formats_round(dev, top, subject, picks0):
    """One core-set round of the f32 campaign's configuration from the
    subject's files (``config.data.img_paths`` / ``mask_path``), the launch
    counts zeroed just before and read just after; its round-0 picks must
    equal the in-memory campaign's.  Then K1 and K2 are held against their
    plain versions on the inputs the round gave them."""
    root = os.path.join(top, "core-set")
    pars = set_parameters(DEFAULT_PARS, OVERRIDES)
    pars.update(img_paths=subject.modality_paths,
                mask_path=subject.mask_path)
    out = {}
    with _FirstCall(ops.similarity, "rowmax_similarity") as k1, \
            _FirstCall(pw_experiment, "gather_patches_normalized") as k2:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        expr = pw_experiment.PWExperiment(
            root, ExperimentConfig.from_pars(pars), device=dev)
        expr.prep_data()
        expr.add_method("core-set")
        res = expr.run_method("core-set", 64)
        torch.cuda.synchronize()
        out["round_s"] = time.perf_counter() - t0
        out["counts"] = {k.name: k.launches for k in ops.KERNELS}
    got = np.loadtxt(os.path.join(root, "core-set", "queries", "0.txt"),
                     dtype=np.int64)
    out["f_measure"] = res["perf"].tolist()
    check(len(res["perf"]) == 1 and res["n_queries"] == 64
          and np.array_equal(got, picks0),
          "formats: the core-set round from the files picks other voxels "
          "than the in-memory campaign's round 0")
    c = out["counts"]
    check(c["rowmax_similarity"] >= 1 and c["gather_patches_normalized"] >= 1,
          f"formats: the round launched {c}")
    (P, R), _ = k1.args
    with torch.no_grad():
        err1 = float((rowmax_similarity(P, R)
                      - rowmax_similarity_plain(P, R)).abs().max())
    (padded, inds, mu, sd, ps, shape), _ = k2.args
    err2 = float((gather_patches_normalized(padded, inds, mu, sd, ps, shape)
                  - gather_patches_plain(padded, inds, mu, sd, ps, shape))
                 .abs().max())
    out["kernels"] = {
        "rowmax_similarity": {"shapes": {"P": list(P.shape),
                                         "R": list(R.shape)},
                              "max_abs_err": err1},
        "gather_patches_normalized": {"n": int(inds.numel()),
                                      "patch": list(ps),
                                      "max_abs_err": err2}}
    check(err1 <= 1e-5 and err2 == 0.0,
          f"formats: K1 |delta| {err1} (<= 1e-5?), K2 {err2} (== 0?)")
    del k1, k2, P, R, padded
    _drop_checkpoints(root)
    return out


def formats_repeat_runs(dev, top):
    """``repeat_runs`` on the card: its ``main`` (no ``--device``: the
    card) for 2 runs of ``random``, one round each; then a third run
    interrupted inside its round and resumed by a later call from
    ``counter.txt``."""
    root = os.path.join(top, "repeat_runs")
    t0 = time.perf_counter()
    check(repeat_runs_mod.main([root, "random", "64", "2",
                                REPEAT_OVERRIDES]) == 0,
          "formats: repeat_runs main failed")
    out = {"two_runs_s": time.perf_counter() - t0}
    _drop_checkpoints(root)
    orig = pw_experiment.PWExperiment.run_method

    def crash(self, method, nqueries):
        raise _Interrupted(method)

    pw_experiment.PWExperiment.run_method = crash
    try:
        repeat_runs_mod.repeat_runs(root, ["random"], 64, 3,
                                    REPEAT_OVERRIDES, device=str(dev))
        interrupted = False
    except _Interrupted:
        interrupted = True
    finally:
        pw_experiment.PWExperiment.run_method = orig
    with open(os.path.join(root, "counter.txt")) as f:
        counter_mid = f.read()
    t0 = time.perf_counter()
    repeat_runs_mod.repeat_runs(root, ["random"], 64, 3, REPEAT_OVERRIDES,
                                device=str(dev))
    out["resumed_run_s"] = time.perf_counter() - t0
    with open(os.path.join(root, "counter.txt")) as f:
        counter = f.read()
    with open(os.path.join(root, "durations.txt")) as f:
        durations = [line.split() for line in f]
    picks = [np.loadtxt(os.path.join(root, f"run_{r}", "random", "queries",
                                     "0.txt"), dtype=np.int64)
             for r in range(3)]
    out.update(counter=counter, durations=durations,
               distinct_picks=len({p.tobytes() for p in picks}))
    check(interrupted and counter_mid == "2" and counter == "3"
          and [d[0] for d in durations] == ["0", "1", "2"]
          and all(len(p) == 64 for p in picks)
          and out["distinct_picks"] == 3,
          f"formats: repeat_runs {out}, interrupted {interrupted}, "
          f"counter after the interruption {counter_mid}")
    _drop_checkpoints(root)
    return out


def formats_steps(dev, seed=31):
    """The library's two train-step levers and a branch, card against
    host: ``weight_decay`` on PW1 25x25x2 (loss and params within 1e-5, the
    training levers' rule); ``focal_gamma`` on FC-DenseNet-103's dense step
    over 2 slices with a third of the pixels unlabeled and class weights,
    card and host each held to a float64 step on the card
    (``make_train_step``'s rule in ``phase_cls_parity``: the update's
    worst element and 2-norm within 1e-2 of its size);
    ``apply_with_branch`` on PW1's probe (posteriors within 1e-4)."""
    out = {}
    x = _patches(dev, 128, seed=1)
    y = torch.from_numpy(np.eye(2, dtype=np.float32)[
        np.random.default_rng(3).integers(0, 2, 128)])
    sides = {}
    for side, d in (("card", dev), ("host", torch.device("cpu"))):
        model = _lever_model({}, d)
        state = TrainState(model, make_optimizer("SGD", 1e-3,
                                                 model.parameters()))
        with KeyedDraws(22), deterministic_cudnn():
            loss = make_train_step(weight_decay=1e-4)(
                state, x.to(d), y.to(d), 1234)
        sides[side] = (float(loss), to_jax_params(model.state_dict()))
    (lc, pc), (lh, ph) = sides["card"], sides["host"]
    out["weight_decay"] = {
        "loss_card": lc, "loss_host": lh, "loss_err": abs(lc - lh),
        "params_err": max(float(np.abs(pc[l][k] - ph[l][k]).max())
                          for l in pc for k in pc[l])}
    r = out["weight_decay"]
    check(np.isfinite(lc) and r["loss_err"] <= 1e-5
          and r["params_err"] <= 1e-5, f"weight_decay step card vs host: {r}")
    # focal_gamma: make_train_step's dense step on 2 slices of the
    # campaign subject.  Card and host are each held to a float64 step on
    # the card by make_train_step's rule (the AlexNet steps of
    # phase_cls_parity: the worst element and the 2-norm of the update
    # within 1e-2 of its size)
    vols, mask, mu, sd, _ = _dense_subject()
    spec = create_model("Tiramisu", nclass=2, input_shape=(128, 128, 2),
                        dropout_rate=0.2)
    host = init_cnn(spec, seed, device="cpu")
    xs = torch.from_numpy(normalized_slices(vols, mu, sd)[10:12]).contiguous()
    rng = np.random.default_rng(seed)
    lab = np.nan_to_num(np.moveaxis(mask[:, :, 10:12], 2, 0)).astype(int)
    ys = np.eye(2, dtype=np.float32)[lab]
    ys[rng.random(lab.shape) < 1 / 3] = np.nan
    ys = torch.from_numpy(ys)
    cw = torch.tensor([0.4, 1.6])
    p0 = {k: v.double() for k, v in host.state_dict().items()}

    def stepped(device, dtype=torch.float32):
        m = copy.deepcopy(host).to(device, dtype)
        st = TrainState(m, torch.optim.SGD(m.parameters(), lr=0.1))
        with deterministic_cudnn():
            loss = make_train_step(fcn=True, focal_gamma=2.0)(
                st, xs.to(device, dtype), ys.to(device, dtype), 5,
                cw=cw.to(device, dtype))
        return ({k: v.detach().cpu().double()
                 for k, v in m.state_dict().items()}, float(loss),
                step_grads(m))

    with KeyedDraws(seed):
        (sh, lh, gh), (sc, lc, gc) = stepped("cpu"), stepped(dev)
        s64, l64, g64 = stepped(dev, torch.float64)
    (mc, nc), (mh, nh) = _update_errs(sc, s64, p0), _update_errs(sh, s64, p0)
    r = {"loss_card": lc, "loss_host": lh, "loss_f64": l64,
         "update_err_card": mc, "update_err_host": mh,
         "update_norm_err_card": nc, "update_norm_err_host": nh,
         "first_diverging_layer": first_diverging_layer(spec, gc, gh, g64)}
    out["focal_gamma"] = r
    check(np.isfinite(lc) and max(mc, mh, nc, nh) <= 1e-2,
          f"focal_gamma dense step card and host vs float64: {r}")
    del host, sh, sc, s64, gh, gc, g64
    # a branch on PW1's probe (layer 4)
    tspec = create_pw1(2, 0.5, (25, 25, 2))
    shape = branch_input_shape(tspec, 4)
    bspec = CNNSpec("aux", (SpecLayer("bfc", "fc", 3, (), (), "VALID", "M"),),
                    shape, 3)
    xb = _patches(dev, 256, seed=5)
    res = {}
    for side, d in (("card", dev), ("host", torch.device("cpu"))):
        trunk = init_cnn(tspec, 0, device=d)
        branch = init_branch(bspec, 1, device=d)
        with torch.no_grad():
            t_out, b_out = apply_with_branch(trunk, branch, xb.to(d), 4)
        res[side] = (t_out.posteriors.cpu(), b_out.posteriors.cpu())
    out["branch"] = {"probe_shape": list(shape),
                     "trunk_err": float((res["card"][0]
                                         - res["host"][0]).abs().max()),
                     "branch_err": float((res["card"][1]
                                          - res["host"][1]).abs().max())}
    check(out["branch"]["trunk_err"] <= 1e-4
          and out["branch"]["branch_err"] <= 1e-4,
          f"apply_with_branch card vs host: {out['branch']}")
    return out


def phase_formats(dev, picks0):
    """NRRD / NIfTI subjects into the engine on the card (module
    docstring, phase 22): the files, one core-set round from them (K1 and
    K2 launched and held to their plain versions), ``repeat_runs`` with an
    interrupted run resumed, and the library's train steps and branch.
    The files and run directories are removed at the end."""
    t0 = time.perf_counter()
    top = os.path.join(ROOT, "_smoke_expr", "formats")
    shutil.rmtree(top, ignore_errors=True)
    vols, mask = synthetic_subject(shape=SHAPE, n_modalities=2, n_blobs=3,
                                   seed=0)
    try:
        subject, out = formats_files(top, vols, mask)
        out["round"] = formats_round(dev, top, subject, picks0)
        out["repeat_runs"] = formats_repeat_runs(dev, top)
        out["steps"] = formats_steps(dev)
    finally:
        shutil.rmtree(top, ignore_errors=True)
    out["counts"] = out["round"]["counts"]
    out["seconds"] = time.perf_counter() - t0
    print("formats ok (card above): " + json.dumps(out))
    return out


# ------------------------------------------------------- rank-3 (3-D) path
def _r3_data(seed):
    """The campaign subject (128x128x32, 2 modalities) normalized per
    modality, channels last, and per-voxel one-hots of its mask with a
    third of the voxels unlabeled (NaN)."""
    vols, mask, mu, sd, _ = _dense_subject()
    vol = np.stack([(np.asarray(v, np.float32) - m) / sd_
                    for v, m, sd_ in zip(vols, mu, sd)], -1)
    lab = np.eye(2, dtype=np.float32)[np.nan_to_num(mask).astype(int)]
    lab[np.random.default_rng(seed).random(mask.shape) < 1 / 3] = np.nan
    return vol.astype(np.float32), lab


def _crops(a, shape, corners):
    return torch.from_numpy(np.ascontiguousarray(np.stack([
        a[x:x + shape[0], y:y + shape[1], z:z + shape[2]]
        for x, y, z in corners])))


def rank3_parity(dev, spec, host, vol, lab, seed):
    """Card vs host vs float64 (on the card) from one seed's weights on a
    32x32x32x2 sub-volume at batch 1: ``update_bn_stats`` over two other
    sub-volumes (decay 0.6), the eval forward on that state (card vs host
    posteriors 1e-4, state 1e-4 relative: the 2-D dense rule; each
    device's error against float64 reported, the card within 2x the
    host's or 1e-4 of it), and one ``make_train_step(fcn=True)`` Adam step
    (lr 1e-3, eps 1e-3) with the same dropout uniforms (``KeyedDraws``):
    each device's update within 1e-2 of the float64 update's size in the
    2-norm, the rule ``phase_cls_parity`` holds ``make_train_step``'s Adam
    step to (Adam's first update is about lr times the gradient's sign,
    so an element whose float64 gradient is near 0 can move by lr on
    either device; the worst element is reported beside it)."""
    x = _crops(vol, R3_PARITY, [(0, 0, 0)])
    y = _crops(lab, R3_PARITY, [(0, 0, 0)])
    refresh = [_crops(vol, R3_PARITY, [c]) for c in ((32, 32, 0),
                                                     (64, 64, 0))]
    sides = {"card": (dev, torch.float32), "host": ("cpu", torch.float32),
             "f64": (dev, torch.float64)}
    fwd, states = {}, {}
    for side, (d, dt) in sides.items():
        m = copy.deepcopy(host).to(d, dt)
        it = iter(refresh)
        with torch.no_grad():
            st = update_bn_stats(m, m.init_state(), lambda: next(it).to(d, dt),
                                 iters=2, bn_decay=0.6)
            fwd[side] = m(x.to(d, dt), state=st).posteriors.double().cpu()
        states[side] = {l: {k: v.double().cpu() for k, v in v2.items()}
                        for l, v2 in st.items()}
        del m
    res = {"forward": {
        "posteriors_card_vs_host": float((fwd["card"] - fwd["host"]).abs()
                                         .max()),
        "state_rel_card_vs_host": _state_rel(states["card"],
                                             states["host"]),
        "posteriors_err_card": float((fwd["card"] - fwd["f64"]).abs().max()),
        "posteriors_err_host": float((fwd["host"] - fwd["f64"]).abs().max()),
        "state_err_card": _state_rel(states["card"], states["f64"]),
        "state_err_host": _state_rel(states["host"], states["f64"])}}
    r = res["forward"]
    check(r["posteriors_card_vs_host"] <= 1e-4
          and r["state_rel_card_vs_host"] <= 1e-4
          and all(r[f"{q}_err_card"] <= max(2 * r[f"{q}_err_host"],
                                            r[f"{q}_err_host"] + 1e-4)
                  for q in ("posteriors", "state")),
          f"rank-3 forward card vs host vs float64: {r}")
    p0 = {k: v.double() for k, v in host.state_dict().items()}

    def stepped(d, dt):
        m = copy.deepcopy(host).to(d, dt)
        st = TrainState(m, torch.optim.Adam(m.parameters(), lr=1e-3,
                                            eps=1e-3))
        ctx = deterministic_cudnn() if dt == torch.float32 \
            else contextlib.nullcontext()
        with ctx:
            loss = make_train_step(fcn=True)(st, x.to(d, dt), y.to(d, dt),
                                             5)
        return ({k: v.detach().cpu().double()
                 for k, v in m.state_dict().items()}, float(loss))

    t0 = time.perf_counter()
    with KeyedDraws(seed):
        (sc, lc), (sh, lh) = stepped(dev, torch.float32), stepped(
            "cpu", torch.float32)
        s64, l64 = stepped(dev, torch.float64)
    (mc, nc), (mh, nh) = _update_errs(sc, s64, p0), _update_errs(sh, s64, p0)
    res["adam_step"] = {"loss_card": lc, "loss_host": lh, "loss_f64": l64,
                        "update_err_card": mc, "update_err_host": mh,
                        "update_norm_err_card": nc,
                        "update_norm_err_host": nh,
                        "seconds_three_steps": time.perf_counter() - t0}
    r = res["adam_step"]
    check(np.isfinite(lc) and max(nc, nh) <= 1e-2,
          f"rank-3 Adam step card and host vs float64: {r}")
    return res


def rank3_train_rate(dev, host, vol, lab, flops):
    """Steps/s, TFLOP/s (3x the forward's convs) and peak memory of
    ``make_train_step(fcn=True)`` Adam steps at f32 and bf16 on 64x64x32x2
    sub-volumes at batch ``R3_BATCH``, under deterministic cuDNN (as the
    dense finetune runs; a layer without a deterministic 3-D algorithm
    raises) and without it."""
    corners = [(0, 0, 0), (64, 64, 0)][:R3_BATCH]
    x = _crops(vol, R3_TRAIN, corners).to(dev)
    y = _crops(lab, R3_TRAIN, corners).to(dev)
    res = {}
    for name, cd in (("float32", None), ("bfloat16", torch.bfloat16)):
        res[name] = {}
        for det in (True, False):
            m = copy.deepcopy(host).to(dev)
            st = TrainState(m, make_optimizer("Adam", 1e-3, m.parameters()))
            fn = make_train_step(fcn=True, compute_dtype=cd)
            ctx = deterministic_cudnn() if det else torch.backends.cudnn.flags(
                enabled=True, benchmark=False, deterministic=False,
                allow_tf32=False)
            with ctx:
                fn(st, x, y, 0)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                for i in range(R3_STEPS):
                    loss = fn(st, x, y, 1 + i)
                torch.cuda.synchronize()
                step_s = (time.perf_counter() - t0) / R3_STEPS
            check(bool(torch.isfinite(loss)), f"rank-3 {name} step loss")
            res[name]["deterministic" if det else "nondeterministic"] = {
                "step_s": step_s, "steps_per_s": 1.0 / step_s,
                "tflops": 3.0 * flops * R3_BATCH / step_s / 1e12,
                "peak_bytes": torch.cuda.max_memory_allocated(),
                "loss": float(loss)}
            del m, st
    return res


def rank3_serve(dev, spec, host, bn, vol):
    """``FCNInference`` posteriors of the whole campaign subject
    (128x128x32x2, one volume a batch) on ``bn`` at f32, bf16 and int8
    (``quantize_model``; the transposed convs float), each after one
    warm-up call: voxels/s, TFLOP/s, peak memory, and p1 against f32's
    (bf16 and int8 agree with f32 on at least 95% of the voxels where
    f32's p1 is more than 0.05 from 0.5).  int8 is held to
    ``tests/test_torch_quant.py``'s dense rule, which compares two runs
    of one quantized net: the card's int8 against the host's on a
    32x32x32 crop, within 0.1 and the same prediction on at least 95% of
    the voxels where the host's p1 is more than 0.05 from 0.5 (against
    f32 the rounding of 108 quantized layers reaches further, so that
    distance is reported, not bounded)."""
    card = copy.deepcopy(host).to(dev)
    bn_c = {l: {k: v.to(dev) for k, v in d.items()} for l, d in bn.items()}
    x = vol[None]
    flops = dense_flops(spec, vol.shape[:3])
    res, post = {"gflop_per_volume": flops / 1e9}, {}
    qcard = quantize_model(card)
    for name, cd, m in (("float32", None, card),
                        ("bfloat16", torch.bfloat16, card),
                        ("int8", None, qcard)):
        inf = FCNInference(spec, batch=1, compute_dtype=cd, bn_state=bn_c,
                           device=dev)
        inf.segment(m, x, "posteriors")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        p = inf.segment(m, x, "posteriors")
        secs = time.perf_counter() - t0
        check(p.shape == x.shape[:4] + (2,) and bool(np.isfinite(p).all()),
              f"rank-3 {name} posteriors {p.shape}")
        res[name] = {"voxels_per_s": x[0, ..., 0].size / secs,
                     "wall_s": secs, "tflops": flops / secs / 1e12,
                     "peak_bytes": torch.cuda.max_memory_allocated()}
        post[name] = p[0, ..., 1]
    sure = np.abs(post["float32"] - 0.5) > 0.05
    for name in ("bfloat16", "int8"):
        res[name]["max_abs_dp1_vs_f32"] = float(
            np.abs(post[name] - post["float32"]).max())
        res[name]["agree_vs_f32"] = float(np.mean(
            (post[name] > 0.5) == (post["float32"] > 0.5)))
        res[name]["agree_sure_vs_f32"] = float(np.mean(
            (post[name] > 0.5)[sure] == (post["float32"] > 0.5)[sure]))
    check(all(res[n]["agree_sure_vs_f32"] >= 0.95
              for n in ("bfloat16", "int8")),
          f"rank-3 bf16 / int8 serving vs f32: {res}")
    crop = np.ascontiguousarray(vol[None, :R3_PARITY[0], :R3_PARITY[1]])
    qhost = quantize_model(host)
    got = FCNInference(spec, batch=1, bn_state=bn_c, device=dev).segment(
        qcard, crop, "posteriors")[..., 1]
    t0 = time.perf_counter()
    want = FCNInference(spec, batch=1, bn_state=bn, device="cpu").segment(
        qhost, crop, "posteriors")[..., 1]
    sure = np.abs(want - 0.5) > 0.05
    res["int8_card_vs_host"] = {
        "crop": list(crop.shape[1:4]),
        "max_abs_dp1": float(np.abs(got - want).max()),
        "agree_sure": float(np.mean((got > 0.5)[sure] == (want > 0.5)[sure])),
        "host_s": time.perf_counter() - t0}
    r = res["int8_card_vs_host"]
    check(r["max_abs_dp1"] <= 0.1 and r["agree_sure"] >= 0.95,
          f"rank-3 int8 card vs host: {r}")
    return res


def rank3_multimg_gather(dev):
    """``gather_patches_multimg`` through K2 on the multi phase's
    training subjects (``MULTI_SHAPE``; ``MULTIMG_INDS`` voxels each, one
    subject empty), launch counts zeroed just before and read just after;
    patches bit-equal to K2's plain version (the same call on host
    volumes) and labels equal."""
    subjects = multi_subjects(MULTI_SHAPE)[0]
    ps = (25, 25, 1)
    padded = [pad_volumes(v, ps, device=dev) for v, _ in subjects]
    stats = multimg_stats(subjects)
    masks = [m for _, m in subjects]
    rng = np.random.default_rng(12)
    n_vox = int(np.prod(MULTI_SHAPE))
    inds = [np.sort(rng.choice(n_vox, n, replace=False)) if n
            else np.zeros(0, np.int64) for n in MULTIMG_INDS]
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bp, bl = gather_patches_multimg(padded, inds, ps, stats, masks)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {k.name: k.launches for k in ops.KERNELS}
    hp, hl = gather_patches_multimg([p.cpu() for p in padded], inds, ps,
                                    stats, masks)
    for j, n in enumerate(MULTIMG_INDS):
        if n == 0:
            check(bp[j] == [] and bl[j] == [] and hp[j] == [],
                  f"gather_patches_multimg: subject {j} is empty")
        else:
            check(bp[j].shape == (n,) + ps[:2] + (2,)
                  and torch.equal(bp[j].cpu(), hp[j])
                  and np.array_equal(bl[j], hl[j]),
                  f"gather_patches_multimg: subject {j} card vs plain")
    k2 = ops.gather.KERNEL.name
    check(counts[k2] == sum(1 for n in MULTIMG_INDS if n)
          and counts[ops.similarity.KERNEL.name] == 0,
          f"gather_patches_multimg launches {counts}")
    return {"counts": counts, "seconds": secs,
            "patches": int(sum(MULTIMG_INDS))}


def rank3_probe_prime():
    """``wait_device`` on the card exits 0 on its first probe (a
    subprocess matmul on ``cuda``; a retry would print "unresponsive"),
    and ``prime_cache.prime_builds`` finds every CUDA kernel and host
    library already built (``wait_device --prime`` runs the same in a
    subprocess, then the micro-campaigns, whose engine the multi phase
    drives)."""
    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = wait_device.main(["--max-wait", "600", "--interval", "10"])
    probe_s = time.perf_counter() - t0
    builds = prime_cache.prime_builds()
    want = {k.name for k in ops.KERNELS} | {
        m.STEM for m in (slic_native, native_gather, crf_native)}
    check(rc == 0 and "unresponsive" not in log.getvalue()
          and set(builds) == want and set(builds.values()) == {"present"},
          f"wait_device: rc {rc} ({log.getvalue()!r}); prime_cache "
          f"builds {builds}")
    return {"rc": rc, "probe_s": probe_s, "builds": builds,
            "seconds": time.perf_counter() - t0}


def phase_rank3(dev, seed=31):
    """The 3-D path (module docstring): FC-DenseNet-103 at its published
    width and depth, 3-D on 2 modalities, card vs host, its training rate
    and whole-subject serving (launch counts zeroed just before and read
    just after: neither kernel is on this path), then
    ``gather_patches_multimg`` through K2, and the probe and priming."""
    t0 = time.perf_counter()
    spec = create_model("Tiramisu", nclass=2, input_shape=R3_TRAIN + (2,),
                        dropout_rate=0.2)
    host = init_cnn(spec, seed, device="cpu")
    n_params = count_parameters(host)
    check(n_params == R3_PARAMS and isinstance(host.first_conv,
                                               torch.nn.Conv3d),
          f"3-D FC-DenseNet-103: {n_params} parameters")
    flops = dense_flops(spec, R3_TRAIN)
    vol, lab = _r3_data(seed)
    res = {"params": n_params, "gflop_per_64x64x32": flops / 1e9,
           "gflop_per_32x32x32": dense_flops(spec, R3_PARITY) / 1e9}
    ops.reset_launch_counts()
    res["parity"] = rank3_parity(dev, spec, host, vol, lab, seed)
    res["train"] = rank3_train_rate(dev, host, vol, lab, flops)
    # the serving state: a refresh over the two training crops at decay
    # 0.6, on the host
    it = iter([_crops(vol, R3_TRAIN, [(0, 0, 0)]),
               _crops(vol, R3_TRAIN, [(64, 64, 0)])])
    with torch.no_grad():
        bn = update_bn_stats(host, host.init_state(), lambda: next(it),
                             iters=2, bn_decay=0.6)
    res["serve"] = rank3_serve(dev, spec, host, bn, vol)
    res["counts_path"] = {k.name: k.launches for k in ops.KERNELS}
    check(not any(res["counts_path"].values()),
          f"a kernel launched on the 3-D path: {res['counts_path']}")
    res["multimg_gather"] = rank3_multimg_gather(dev)
    res["probe_prime"] = rank3_probe_prime()
    res["counts"] = res["multimg_gather"]["counts"]
    res["seconds"] = time.perf_counter() - t0
    print(f"rank-3 ok (3-D FC-DenseNet-103, {n_params} params, "
          f"{flops / 1e9:.3f} GFLOP a 64x64x32x2 sub-volume; card above): "
          + json.dumps(res))
    return res


# ----------------------------------------------------------- the examples
def _run_example(name, root, dev, tiny):
    """One example's ``main`` on the card; returns the line's results."""
    mod = importlib.import_module(f"nnal_tpu_torch.examples.{name}")
    if name == "serving":
        res = mod.main(tiny, device=dev)
        check(all(0.0 <= res[k] <= 1.0 for k in res),
              f"serving example: {res}")
        return {k: float(v) for k, v in res.items()}
    if name == "multichip_campaign":
        try:
            mod.main(root, tiny, device=dev)
        except AssertionError as e:
            raise SmokeFailure(f"multichip_campaign example: {e}")
        rounds = sorted(os.listdir(os.path.join(root, "dp8", "entropy",
                                                "queries")))
        equal = all(np.array_equal(
            *(np.loadtxt(os.path.join(root, tag, "entropy", "queries", r),
                         dtype=np.int64) for tag in ("dp8", "dp1")))
            for r in rounds)
        check(equal and len(rounds) == (2 if tiny else 6),
              f"multichip_campaign example: dp 8 selections equal dp 1's "
              f"in every round? {equal}, rounds {rounds}")
        perf = {tag: np.loadtxt(os.path.join(root, tag, "entropy",
                                             "perf_evals.txt")).tolist()
                for tag in ("dp8", "dp1")}
        return {"selections_equal": equal, "rounds": len(rounds),
                "f_per_round": perf}
    if name == "multi_subject_al":
        nq = 6 if tiny else 24
        res = mod.main(root, "entropy", nq, tiny, device=dev)
        curves = {"entropy": np.atleast_1d(res["perf"])}
        check(res["n_queries"] == nq, f"{name}: {res['n_queries']} queries")
    elif name == "classification_al":
        curves = mod.main(root, ("entropy", "random"), 30, tiny, device=dev)
    elif name == "dense_model_al":
        # at --tiny with the dense mean teacher, as the JAX package's test
        curves = mod.main(root, ("entropy", "BADGE"), 24, tiny, mt=tiny,
                          device=dev)
    else:
        curves = mod.main(root, ("entropy", "random"), 60, tiny, device=dev)
    f = {m: np.atleast_1d(c).astype(float).tolist() for m, c in curves.items()}
    want_rounds = {"patchwise_al": 2 if tiny else 3,
                   "multi_subject_al": 2 if tiny else 3,
                   "classification_al": 2 if tiny else 6,
                   "dense_model_al": 6 if tiny else 1}[name]
    check(all(len(c) == want_rounds and np.isfinite(c).all()
              and all(0.0 <= v <= 1.0 for v in c) for c in f.values()),
          f"{name}: curves {f}, {want_rounds} rounds each?")
    return {"f_per_round": f}


def phase_examples(dev):
    """The six examples' ``main`` on the card (module docstring, phase
    24), each in a directory of its own that is removed after it; launch
    counts zeroed just before the first and read after the last (and per
    example); the first K2 call of ``patchwise_al``'s finetunes held to
    K2's plain version, bit-equal."""
    t0 = time.perf_counter()
    top = os.path.join(ROOT, "_smoke_expr", "examples")
    shutil.rmtree(top, ignore_errors=True)
    out = {"examples": {}}
    try:
        with _FirstCall(pw_experiment, "gather_patches_normalized") as k2:
            ops.reset_launch_counts()
            for name, tiny in EXAMPLES.items():
                before = {k.name: k.launches for k in ops.KERNELS}
                t = time.perf_counter()
                res = _run_example(name, os.path.join(top, name), dev, tiny)
                torch.cuda.synchronize()
                res = {"seconds": time.perf_counter() - t,
                       "settings": "--tiny" if tiny else "defaults", **res,
                       "launches": {k.name: k.launches - before[k.name]
                                    for k in ops.KERNELS}}
                out["examples"][name] = res
                print(f"example {name} (card above): " + json.dumps(res))
                shutil.rmtree(os.path.join(top, name), ignore_errors=True)
            out["counts"] = {k.name: k.launches for k in ops.KERNELS}
        (padded, inds, mu, sd, ps, shape), _ = k2.args
        err = float((gather_patches_normalized(padded, inds, mu, sd, ps,
                                               shape)
                     - gather_patches_plain(padded, inds, mu, sd, ps, shape))
                    .abs().max())
        out["k2_check"] = {"n": int(inds.numel()), "patch": list(ps),
                           "max_abs_err": err}
        check(err == 0.0, f"examples: K2 |delta| {err} on patchwise_al's "
              "finetune gather (== 0?)")
        check(out["counts"]["gather_patches_normalized"] >= 1,
              f"examples: K2 never launched ({out['counts']})")
        del k2, padded
    finally:
        shutil.rmtree(top, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    print("examples ok (card above): " + json.dumps(
        {k: out[k] for k in ("counts", "k2_check", "seconds")}))
    return out


def _npz_rel(a, b):
    """max |a - b| over max |b|, over the float arrays both hold."""
    keys = [k for k in b if k in a and b[k].dtype.kind == "f"]
    return (max(float(np.abs(a[k] - b[k]).max()) for k in keys)
            / max(float(np.abs(b[k]).max()) for k in keys))


def dev_dense_example_replay(devices=("cuda", "cpu")) -> int:
    """``python3 chip_smoke.py --dense-example-replay``: a development
    measurement, not a smoke phase.  ``dense_model_al`` at ``--tiny``
    (its seed 3, BADGE, rounds of k 4) on the card and on the host with
    the same dropout uniforms and BADGE draws (``KeyedDraws``), over 1
    round and then 6: the initial weights and the weights after the last
    round card vs host (max |delta| over max |host|), whether each
    round's picks are equal, and each one's F per round; printed, not
    checked.  It tells a fault of the card's path from one trajectory's
    drift (ROADMAP Queue 3)."""
    print(card_line())
    mod = importlib.import_module("nnal_tpu_torch.examples.dense_model_al")
    top = os.path.join(ROOT, "_smoke_expr", "dense_example_replay")
    try:
        for nq in (4, 24):
            runs = {}
            for dev in devices:
                root = os.path.join(top, dev)
                shutil.rmtree(root, ignore_errors=True)
                with KeyedDraws(3):
                    f = mod.main(root, ("BADGE",), nq, True, device=dev)
                d = os.path.join(root, "BADGE")
                qdir = os.path.join(d, "BADGE", "queries")
                runs[dev] = {
                    "f": np.atleast_1d(f["BADGE"]).tolist(),
                    "w0": dict(np.load(os.path.join(d, "init_weights.npz"))),
                    "w": dict(np.load(os.path.join(d, "BADGE",
                                                   "curr_weights.npz"))),
                    "picks": [np.loadtxt(os.path.join(qdir, r),
                                         dtype=np.int64)
                              for r in sorted(os.listdir(qdir),
                                              key=lambda r: int(r[:-4]))]}
            card, host = (runs[d] for d in devices)
            res = {"rounds": len(card["f"]),
                   "init_weights_rel": _npz_rel(card["w0"], host["w0"]),
                   "weights_rel": _npz_rel(card["w"], host["w"]),
                   "picks_equal": [bool(np.array_equal(a, b)) for a, b in
                                   zip(card["picks"], host["picks"])],
                   "f_card": card["f"], "f_host": host["f"]}
            print("dense example replay: " + json.dumps(res))
    finally:
        shutil.rmtree(top, ignore_errors=True)
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--fresh-precision-port"]:
        return dev_fresh_precision(os.path.abspath(sys.argv[2]))
    if sys.argv[1:2] == ["--dense-example-replay"]:
        return dev_dense_example_replay()
    if sys.argv[1:2] == ["--dense-gap"]:
        return dev_dense_gap()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    set_precision()
    card = card_line()
    print(card)

    t0 = time.perf_counter()
    timed("build", ops.build_kernels)
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

    rows = [timed("k1", phase_k1, dev), timed("k2", phase_k2, dev)]
    timed("forward", phase_forward, dev)
    bf16_fwd = timed("bf16_forward", phase_bf16_forward, dev)
    mc_fwd = timed("mc_forward", phase_mc_forward, dev)
    levers = timed("train_levers", phase_train_levers, dev)
    mc_sweep = timed("mc_sweep", phase_mc_sweep, dev)
    perturb = timed("perturb", phase_perturb, dev)
    batch_select = timed("batch_select", phase_batch_select, dev)
    second_order = timed("second_order", phase_second_order, dev)
    slic = timed("slic_variance", phase_slic_variance, dev)
    fim = timed("fim_parity", phase_fim_parity, dev)
    sweep, unc32 = timed("fim_sweep_f32", phase_fim_sweep, dev)
    sweep16, _ = timed("fim_sweep_bf16", phase_fim_sweep, dev,
                       cd=torch.bfloat16, ref_unc=unc32)
    del unc32
    f32, bf16, codecs, wpool, served, kept = timed("campaign",
                                                   phase_campaign, dev)
    resume = timed("resume", phase_resume, dev)
    resume_mt = timed("resume_mt", phase_resume, dev, mt=True)
    determinism = timed("determinism", phase_determinism_cost, dev)
    multi = timed("multi", phase_multi, dev)
    dense = timed("dense", phase_dense, dev)
    cls = timed("cls", phase_cls, dev)
    serving = timed("serving", phase_serving, dev)
    parallel = timed("parallel", phase_parallel, dev, kept,
                     serving.pop("serve"))
    analysis = timed("analysis", phase_analysis, dev, kept, multi["kept"])
    formats = timed("formats", phase_formats, dev,
                    kept["picks0"]["core-set"])
    del kept
    rank3 = timed("rank3", phase_rank3, dev)
    examples = timed("examples", phase_examples, dev)
    phases, seconds, by_method, peaks, notes = {}, {}, {}, {}, {}
    for _, ph, sec, bym, pk, nt in (f32, bf16):
        phases.update(ph)
        seconds.update(sec)
        by_method.update(bym)
        peaks.update(pk)
        notes.update(nt)
    new_runs = [n for n, _ in F32_RUNS if n.split("@")[0] in NEW_METHODS]
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
    sp = serving["pw"]
    print("serving (card above): PW1 full volume voxels/s " + json.dumps(
        {k: sp[k]["voxels_per_s"] for k in ("float32", "bfloat16", "int8")})
        + ", FC-DenseNet-103 voxels/s " + json.dumps(
            {k: serving["fcn"][k]["voxels_per_s"]
             for k in ("float32", "bfloat16", "int8")})
        + ", off-grid patches/s " + json.dumps(
            {k: serving["offgrid"][k]["patches_per_s"]
             for k in ("scattered", "clustered")})
        + ", CRF s " + json.dumps(
            {"meanfield_2d_card": serving["crf"]["meanfield_2d"]["card_ms"]
             / 1e3, "native_2d": serving["crf"]["native_2d_s"],
             "native_3d": serving["crf"]["native_3d_s"]})
        + ", run_on_subjects F " + json.dumps(
            {k: served[k]["f_measure"] for k in ("float32", "int8")})
        + f"; serving phases {serving['seconds']:.3f} s")
    for r in rows:
        n = r["name"]
        r["launches"] = (f32[0][n] + bf16[0][n] + mf["counts"][n]
                         + mb["counts"][n] + df["counts"][n]
                         + db["counts"][n] + dm["counts"][n]
                         + cc["counts"][n] + cv["counts"][n]
                         + serving["counts"][n] + parallel["counts"][n]
                         + analysis["counts"][n] + formats["counts"][n]
                         + rank3["counts"][n] + examples["counts"][n])
        r["launches_examples"] = examples["counts"][n]
        r["launches_by_example"] = {
            e: v["launches"][n] for e, v in examples["examples"].items()}
        r["launches_multimg_gather"] = rank3["counts"][n]
        r["launches_rank3_path"] = rank3["counts_path"][n]
        r["launches_formats"] = formats["counts"][n]
        r["at_formats"] = formats["round"]["kernels"][n]
        r["launches_serving"] = serving["counts"][n]
        r["launches_parallel"] = parallel["counts"][n]
        r["launches_parallel_by_run"] = {
            m: c[n] for m, c in parallel["campaigns"]["by_method"].items()}
        r["launches_analysis"] = analysis["counts"][n]
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
    rt, rs = rank3["train"], rank3["serve"]
    print("rank-3 (3-D FC-DenseNet-103, card above): train steps/s at "
          f"{R3_TRAIN} x {R3_BATCH} " + json.dumps(
              {k: {d: rt[k][d]["steps_per_s"] for d in rt[k]} for k in rt})
          + ", TFLOP/s " + json.dumps(
              {k: {d: rt[k][d]["tflops"] for d in rt[k]} for k in rt})
          + "; serving voxels/s " + json.dumps(
              {k: rs[k]["voxels_per_s"]
               for k in ("float32", "bfloat16", "int8")})
          + ", TFLOP/s " + json.dumps(
              {k: rs[k]["tflops"] for k in ("float32", "bfloat16", "int8")})
          + f"; rank-3 phase {rank3['seconds']:.3f} s")
    PHASE_S["total"] = time.perf_counter() - T_START
    print("phase seconds: " + json.dumps(PHASE_S))
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
                      "serving": {**{k: serving[k] for k in (
                          "pw", "offgrid", "fcn", "int8_mm", "crf",
                          "rmsprop_resume", "seconds")},
                          "run_on_subjects": served},
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
                      "parallel": {k: parallel[k] for k in (
                          "evaluator", "selectors", "nccl", "seconds",
                          "peak_bytes", "bytes_moved_between_devices")},
                      "analysis": analysis, "formats": formats,
                      "rank3": rank3, "examples": examples,
                      "phase_seconds": PHASE_S,
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
