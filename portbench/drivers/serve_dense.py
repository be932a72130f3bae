"""Whole-subject dense segmentation: ``FCNInference.segment``.

``inputs`` makes the weights and batch-norm running statistics on the
card from the seed, and a ring of subjects (``n`` axial slices of ``H x
W`` with ``modalities`` channels, float32) in host memory, as a user
hands the program a loaded volume.  Set-up builds the model and warms
up by segmenting the first subject once.  The window segments the ring's
subjects in turn until the first subject boundary after ``seconds``:
each call copies its slices to the card in batches, runs the model and
copies the posteriors back, as a user pays for them.

``check`` compares the posteriors of a sample of the window's subjects,
drawn from the seed, with the reference's, computed slice block by slice
block after the program's state is freed.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

import inputs as inputs_mod
import reference
from reference import counts, fcd103 as ref


def _spec(cfg, mix):
    from nnal_tpu_torch.models.specs import create_tiramisu103

    return create_tiramisu103(
        cfg["nclass"], (mix["height"], mix["width"], cfg["modalities"]),
        growth=cfg["growth"], depths=tuple(cfg["depths"]),
        dropout_rate=cfg["dropout_rate"])


FAMILY = "dense"


def inputs(ctx) -> dict:
    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    c, nclass = int(cfg["modalities"]), int(cfg["nclass"])
    params = inputs_mod.weights(ref.param_shapes(c, nclass), ctx.seed, dev)
    stats = inputs_mod.bn_stats(ref.bn_names(c, nclass), ctx.seed, dev)
    ctx.part("weights")
    ring = []
    for i in range(int(mix["ring"])):
        v, _ = inputs_mod.volumes((mix["height"], mix["width"],
                                   mix["slices"]), c, mix["blobs"], ctx.seed,
                                  10 + i, dev)
        mu = v.mean(dim=(1, 2, 3), keepdim=True)
        sd = v.std(dim=(1, 2, 3), keepdim=True)
        ring.append(((v - mu) / sd).permute(3, 1, 2, 0).contiguous()
                    .cpu().numpy())
    ctx.part("subject")
    return {"params": params, "stats": stats, "ring": ring}


def setup(ctx, inp):
    from nnal_tpu_torch.evaluation.inference import FCNInference
    from nnal_tpu_torch.models.cnn import CNN

    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    model = CNN(_spec(cfg, mix)).to(dev)
    model.load_state_dict(inp["params"])
    inf = FCNInference(model.spec, batch=int(mix["batch"]),
                       bn_state=inp["stats"], device=dev)
    ctx.part("model")
    ring = inp["ring"]
    inf.segment(model, ring[0], mix["op"])
    ctx.part("warm_up")
    rng = np.random.default_rng(ctx.seed)
    keep = {0, int(rng.integers(1, int(mix["ring"]) * 2))}
    return {"model": model, "inf": inf, "ring": ring, "keep": keep}


def window(ctx, st, win) -> dict:
    ring, model, inf, op = st["ring"], st["model"], st["inf"], ctx.mix["op"]
    kept, last = {}, None
    i = 0
    win.begin()
    while True:
        with win.span("subject"):
            last = inf.segment(model, ring[i % len(ring)], op)
        if i in st["keep"]:
            kept[i] = last
        i += 1
        if win.expired():
            break
    win.end()
    kept[i - 1] = last
    n, h, w, _ = ring[0].shape
    return {"units": i, "elapsed": win.elapsed, "voxels": i * n * h * w,
            "kept": kept}


def end_to_end(ctx, res) -> Dict[str, float]:
    return {f"serve_vox_per_s.{FAMILY}":
            res["voxels"] / res["elapsed"]}


def record(ctx, st, res) -> dict:
    cfg, mix = ctx.cfg, ctx.mix
    f = counts.fcd103_flops((mix["height"], mix["width"]),
                            cfg["modalities"], cfg["nclass"])
    return {"units": res["units"], "elapsed": res["elapsed"],
            "model_flops": f * mix["slices"] * res["units"]}


def outputs(ctx, st, res) -> dict:
    return {"kept": res["kept"]}


def _posteriors(ctx, inp, subj, tf32: bool = False):
    """The reference's posteriors of one subject, ``block`` slices at a
    time, channels last, on the device."""
    block = int(ctx.mix["check_block"])
    out = []
    for lo in range(0, subj.shape[0], block):
        x = torch.as_tensor(subj[lo:lo + block], device=ctx.device)
        with reference.precision(tf32=tf32), torch.no_grad():
            out.append(torch.softmax(ref.forward(
                inp["params"], inp["stats"], x.permute(0, 3, 1, 2),
                int(ctx.cfg["nclass"])), dim=1).permute(0, 2, 3, 1))
    return out


def check(ctx, inp, out) -> List[dict]:
    nclass, block = int(ctx.cfg["nclass"]), int(ctx.mix["check_block"])
    worst, shape_ok = 0.0, True
    for i, got in out["kept"].items():
        subj = inp["ring"][i % len(inp["ring"])]
        if got.shape != subj.shape[:3] + (nclass,):
            shape_ok = False
            continue
        for j, p in enumerate(_posteriors(ctx, inp, subj)):
            g = torch.as_tensor(got[j * block:(j + 1) * block],
                                device=ctx.device)
            worst = max(worst, float((g - p).abs().max()))
    return [{"name": "post_err", "value": worst if shape_ok
             else float("inf"), "limit": ctx.limits["post_err"]}]


def control(ctx, inp, fault=None) -> dict:
    """The reference at TF32 in the program's place: the posteriors of the
    ring's first two subjects."""
    return {"kept": {i: torch.cat(_posteriors(ctx, inp, inp["ring"][i],
                                              tf32=True)).cpu().numpy()
                     for i in range(2)}}
