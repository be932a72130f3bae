"""Whole-subject patch-wise segmentation: ``full_volume_patchwise`` over a
``GridPoolEvaluator``, which it re-spaces to stride 1, so every voxel of
the subject is the centre of one patch through the model.

``inputs`` makes the weights on the card from the seed and a ring of
subjects (``modalities`` volumes of ``subject_shape``) in host memory;
set-up builds the model and warms up with one whole subject.  In the
window each subject is handed to the program as a user would:
``pad_volumes`` copies it to the card, a ``GridPoolEvaluator`` is built
on it, and ``full_volume_patchwise`` returns the posterior volume on the
host.  The window ends at the first subject boundary after ``seconds``.

``check`` compares the posteriors at a sample of voxels of a sample of
the window's subjects, both drawn from the seed, with the reference's,
as log-odds (``logodds_err``) at the voxels whose reference posterior
lies in [0.01, 0.99], where a float32 posterior still holds the
log-odds to about 1e-5; nearer 0 or 1 a posterior says too little about
the logits for a comparison to see a lower precision.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

import harness
import inputs as inputs_mod
import reference
from reference import counts, patches as ref_patches, pw1 as ref


FAMILY = "patchwise"


def inputs(ctx) -> dict:
    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    m, nclass = int(cfg["modalities"]), int(cfg["nclass"])
    d1, d2, d3 = cfg["patch_shape"]
    params = inputs_mod.weights(ref.param_shapes((d1, d2), m * d3, nclass),
                                ctx.seed, dev)
    ctx.part("weights")
    ring = []
    for i in range(int(mix["ring"])):
        v, _ = inputs_mod.volumes(tuple(mix["subject_shape"]), m,
                                  mix["blobs"], ctx.seed, 10 + i, dev)
        vols = v.cpu().numpy()
        ring.append((list(vols), *ref_patches.stats(vols)))
    ctx.part("subject")
    return {"params": params, "ring": ring}


def setup(ctx, inp):
    from nnal_tpu_torch.models.cnn import CNN
    from nnal_tpu_torch.models.specs import create_pw1

    cfg, mix = ctx.cfg, ctx.mix
    d1, d2, d3 = cfg["patch_shape"]
    model = CNN(create_pw1(int(cfg["nclass"]), cfg["dropout_rate"],
                           (d1, d2, int(cfg["modalities"]) * d3))
                ).to(ctx.device)
    model.load_state_dict(inp["params"])
    ctx.part("model")
    st = {"model": model, "ring": inp["ring"]}
    _serve(ctx, st, inp["ring"][0])
    ctx.part("warm_up")
    rng = np.random.default_rng(ctx.seed)
    st["keep"] = {0, int(rng.integers(1, int(mix["ring"]) * 2))}
    return st


def _serve(ctx, st, subject):
    from nnal_tpu_torch.data.patches import pad_volumes
    from nnal_tpu_torch.evaluation.inference import full_volume_patchwise
    from nnal_tpu_torch.scoring.grid_eval import GridPoolEvaluator

    cfg, mix = ctx.cfg, ctx.mix
    vols, mu, sd = subject
    ps = tuple(cfg["patch_shape"])
    ev = GridPoolEvaluator(st["model"].spec,
                           pad_volumes(vols, ps, ctx.device), mu, sd, ps,
                           tuple(mix["subject_shape"]),
                           grid_spacing=int(mix["grid_spacing"]),
                           z_chunk=int(mix["z_chunk"]))
    return full_volume_patchwise(ev, st["model"], mix["op"])


def window(ctx, st, win) -> dict:
    ring = st["ring"]
    kept, last = {}, None
    i = 0
    win.begin()
    while True:
        with win.span("subject"):
            last = _serve(ctx, st, ring[i % len(ring)])
        if i in st["keep"]:
            kept[i] = last
        i += 1
        if win.expired():
            break
    win.end()
    kept[i - 1] = last
    voxels = int(np.prod(ctx.mix["subject_shape"]))
    return {"units": i, "elapsed": win.elapsed, "voxels": i * voxels,
            "kept": kept}


def end_to_end(ctx, res) -> Dict[str, float]:
    return {f"serve_vox_per_s.{FAMILY}":
            res["voxels"] / res["elapsed"]}


def record(ctx, st, res) -> dict:
    cfg = ctx.cfg
    d1, d2, d3 = cfg["patch_shape"]
    f = counts.pw1_flops((d1, d2), cfg["modalities"] * d3, cfg["nclass"])
    return {"units": res["units"], "elapsed": res["elapsed"],
            "model_flops": f * res["voxels"]}


def outputs(ctx, st, res) -> dict:
    return {"kept": res["kept"]}


def _samples(ctx, kept) -> List:
    """``(subject, sorted voxel indices)`` of each kept subject, in order,
    drawn from the seed."""
    n_vox = int(np.prod(ctx.mix["subject_shape"]))
    rng = np.random.default_rng(ctx.seed + 1)
    return [(i, np.sort(rng.choice(n_vox, int(ctx.mix["check_voxels"]),
                                   replace=False))) for i in sorted(kept)]


def check(ctx, inp, out) -> List[dict]:
    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    d1, d2, _ = cfg["patch_shape"]
    shape = tuple(mix["subject_shape"])
    block = int(mix["check_block"])
    worst, compared, ok = 0.0, 0, True
    for i, inds in _samples(ctx, out["kept"]):
        got = out["kept"][i]
        if got.shape != shape:
            ok = False
            continue
        vols = np.stack(inp["ring"][i % len(inp["ring"])][0])
        P = ref_patches.Patches(vols, (d1, d2), dev)
        for lo in range(0, len(inds), block):
            sel = inds[lo:lo + block]
            with torch.no_grad():
                lg = ref.forward(inp["params"], P(sel)).double()
            want = lg[:, 1] - lg[:, 0]
            p_ref = torch.sigmoid(want)
            on = torch.minimum(p_ref, 1.0 - p_ref) >= 1e-2
            p = torch.as_tensor(got.reshape(-1)[sel], device=dev).double()
            have = torch.log(p) - torch.log1p(-p)
            gap = (have - want).abs()[on]
            compared += int(on.sum())
            if len(gap):
                g = float(gap.max())
                worst = max(worst, g if g == g else float("inf"))
    harness.log(f"voxels compared as log-odds: {compared}")
    return [{"name": "logodds_err", "value": worst if ok else float("inf"),
             "limit": ctx.limits["logodds_err"]}]


def control(ctx, inp, fault=None) -> dict:
    """The reference at TF32 in the program's place: the posteriors of two
    subjects at the voxels ``check`` samples (0.5 elsewhere)."""
    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    d1, d2, _ = cfg["patch_shape"]
    shape = tuple(mix["subject_shape"])
    block = int(mix["check_block"])
    kept = {}
    for i, inds in _samples(ctx, (0, 1)):
        vols = np.stack(inp["ring"][i % len(inp["ring"])][0])
        P = ref_patches.Patches(vols, (d1, d2), dev)
        vol = np.full(int(np.prod(shape)), 0.5, np.float32)
        for lo in range(0, len(inds), block):
            sel = inds[lo:lo + block]
            with reference.precision(tf32=True), torch.no_grad():
                vol[sel] = torch.softmax(ref.forward(inp["params"], P(sel)),
                                         -1)[:, 1].cpu().numpy()
        kept[i] = vol.reshape(shape)
    return {"kept": kept}
