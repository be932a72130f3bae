"""Smoke run of the PyTorch port (``nnal_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which passes or exits non-zero:

1. the card: ``nvidia-smi`` name and power limit;
2. the kernel build: every ``nnal_tpu_torch/csrc`` source through nvcc
   (one process per source, in parallel), timed;
3. K1 ``rowmax_similarity`` vs its plain version on the card at the
   core-set shapes (P 65,536 x 4096, R 512 x 4096), plus the
   padding-never-wins, zero-row and ragged-d cases; max |delta| <= 1e-5;
4. K2 ``gather_patches_normalized`` vs its plain version on the card,
   bit-equal, for patch shapes (25,25,1), (25,25,3), (24,24,1) on a
   2-modality 128x128x32 subject, 4096 random indices, and at the
   campaign's 384;
5. PW1 25x25x2 posteriors on 1024 patches, and the evaluator's off-grid
   (per-patch gather) route on 256 voxels, card vs host, atol 1e-4;
6. the campaign: ``do_expr(..., device="cuda")`` on a synthetic
   128x128x32 subject (pool of 65,536 grid voxels), 2 rounds each of
   ``entropy``, ``core-set`` and ``random`` (init 256, k 64, b 128, Adam
   1e-3);
   launch counts are zeroed just before and read just after, and every
   kernel must have launched;
7. one ``kernels`` JSON line (times, bounds, launches) and one ``phases``
   JSON line (per-round seconds from ``phases.jsonl``).

The last line is ``{"ok": true, "device": {...}}``.  Without CUDA the
script exits non-zero and prints no result.  The campaign runs under
``_smoke_expr/`` beside this file (git-ignored) and is removed at the end.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from nnal_tpu_torch import ops
from nnal_tpu_torch.cli.expr_handler import do_expr
from nnal_tpu_torch.core.device import set_precision
from nnal_tpu_torch.data.io import synthetic_subject
from nnal_tpu_torch.data.patches import pad_volumes
from nnal_tpu_torch.models.cnn import init_cnn
from nnal_tpu_torch.models.specs import create_pw1
from nnal_tpu_torch.scoring.grid_eval import GridPoolEvaluator
from nnal_tpu_torch.ops.gather import (
    gather_patches_normalized,
    gather_patches_plain,
)
from nnal_tpu_torch.ops.similarity import (
    normalize_rows,
    rowmax_similarity,
    rowmax_similarity_plain,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
# published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12        # float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12
SHAPE = (128, 128, 32)
METHODS = ("entropy", "core-set", "random")
OVERRIDES = ("patch_shape=[25,25,1],grid_spacing=2,k=64,B=128,b=128,"
             "epochs=1,init_size=256,learning_rate=1e-3,"
             "optimizer_name=Adam,ntb=4096,synthetic_shape=[128,128,32],"
             "seed=0")


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
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


def bound(flops: float, nbytes: float):
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_k1(dev, n=65536, m=512, d=4096):
    gen = torch.Generator(device=dev).manual_seed(0)
    P = normalize_rows(torch.randn(n, d, device=dev, generator=gen))
    R = normalize_rows(torch.randn(m, d, device=dev, generator=gen))
    base = ops.similarity.KERNEL.launches
    got = rowmax_similarity(P, R)
    torch.cuda.synchronize()
    err = float((got - rowmax_similarity_plain(P, R)).abs().max())
    check(err <= 1e-5, f"K1 max |delta| {err} > 1e-5")
    # padded / ragged R rows must never win the max
    Pp = torch.zeros(600, 64, device=dev)
    Pp[:, 0] = 1.0
    Rp = torch.zeros(5, 64, device=dev)
    Rp[:, 0] = -1.0
    got_p = rowmax_similarity(Pp, Rp)
    check(bool((got_p == -1.0).all()), "K1 padding leaked into the max")
    # zero rows (normalized with the clamp) give exactly 0
    Pz = P[:300].clone()
    Pz[::7] = 0.0
    got_z = rowmax_similarity(Pz, R)
    check(bool((got_z[::7] == 0.0).all()), "K1 zero rows are not 0")
    # d not a multiple of 4 takes the scalar-load path
    Pr, Rr = P[:1000, :130].contiguous(), R[:, :130].contiguous()
    err_r = float((rowmax_similarity(Pr, Rr)
                   - rowmax_similarity_plain(Pr, Rr)).abs().max())
    check(err_r <= 1e-5, f"K1 ragged-d max |delta| {err_r}")
    torch.cuda.synchronize()
    k_ms = time_ms(lambda: rowmax_similarity(P, R), reps=10)
    p_ms = time_ms(lambda: rowmax_similarity_plain(P, R), reps=10)
    lib_ms = time_ms(lambda: torch.matmul(P, R.T).amax(dim=1), reps=10)
    ops.similarity.KERNEL.launches = base
    b_ms, b_by = bound(2.0 * n * m * d, (n * d + m * d + n) * 4)
    print(f"K1 ok: max|delta| {err:.3g} (ragged d {err_r:.3g}), "
          f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
          f"matmul+amax {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"name": "rowmax_similarity", "route": "cuda",
            "source": "nnal_tpu_torch/csrc/rowmax_similarity.cu",
            "replaces": ops.similarity.REPLACES,
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "shapes": {"P": [n, d], "R": [m, d]}}


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
    padded, ps = timed
    k_ms = time_ms(lambda: gather_patches_normalized(
        padded, inds, mu, sd, ps, SHAPE), reps=50)
    p_ms = time_ms(lambda: gather_patches_plain(
        padded, inds, mu, sd, ps, SHAPE), reps=50)
    # the campaign's own gather: round 1's 384 labeled patches
    small = inds[:384]
    check(torch.equal(
        gather_patches_normalized(padded, small, mu, sd, ps, SHAPE),
        gather_patches_plain(padded, small, mu, sd, ps, SHAPE)),
        "K2 differs from its plain version at 384 patches")
    k384_ms = time_ms(lambda: gather_patches_normalized(
        padded, small, mu, sd, ps, SHAPE), reps=50)
    p384_ms = time_ms(lambda: gather_patches_plain(
        padded, small, mu, sd, ps, SHAPE), reps=50)
    ops.gather.KERNEL.launches = base
    # bytes this run's data needs: every output once, the indices and
    # stats once, and each distinct volume element the windows touch once
    touched = torch.zeros(padded.numel(), dtype=torch.bool, device=dev)
    d1, d2, _ = ps
    _, D1p, D2p, D3p = padded.shape
    z = inds % SHAPE[2]
    y = (inds // SHAPE[2]) % SHAPE[1]
    x = inds // (SHAPE[2] * SHAPE[1])
    a = torch.arange(d1, device=dev)[:, None]
    c = torch.arange(d2, device=dev)[None, :]
    for j in range(padded.shape[0]):
        flat = (((j * D1p + x[:, None, None] + a) * D2p
                 + y[:, None, None] + c) * D3p + z[:, None, None])
        touched[flat.reshape(-1)] = True
    n_out = n * d1 * d2 * padded.shape[0]
    nbytes = n_out * 4 + n * 8 + 4 * 4 + int(touched.sum()) * 4
    # one subtract and one divide per output element
    b_ms, b_by = bound(2.0 * n_out, nbytes)
    print(f"K2 ok: bit-equal at (25,25,1) (25,25,3) (24,24,1); "
          f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}); at 384 patches kernel "
          f"{k384_ms:.4f} ms, plain {p384_ms:.4f} ms")
    return {"name": "gather_patches_normalized", "route": "cuda",
            "source": "nnal_tpu_torch/csrc/gather_patches.cu",
            "replaces": ops.gather.REPLACES, "max_abs_err": 0.0,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "shapes": {"padded": list(padded.shape), "inds": [n],
                       "patch": list(ps)},
            "at_384": {"ms": k384_ms, "plain_ms": p384_ms}}


def phase_forward(dev, n=1024):
    spec = create_pw1(2, 0.5, (25, 25, 2))
    model_c = init_cnn(spec, seed=0)
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


def phase_campaign(dev):
    """Each method in its own experiment directory (a reloaded
    ``parameters.txt`` does not carry ``synthetic_shape``); the
    directories, with their ~0.4 GB checkpoints, are removed at the end."""
    top = os.path.join(ROOT, "_smoke_expr")
    shutil.rmtree(top, ignore_errors=True)
    try:
        return _campaign(dev, top)
    finally:
        shutil.rmtree(top, ignore_errors=True)


def _campaign(dev, top):
    counts = {}
    seconds = {}
    phases = {}
    ops.reset_launch_counts()
    for method in METHODS:
        root = os.path.join(top, method)
        k1_0 = ops.similarity.KERNEL.launches
        k2_0 = ops.gather.KERNEL.launches
        t0 = time.perf_counter()
        res = do_expr(root, method, 128, OVERRIDES, synthetic=True,
                      device=str(dev))
        seconds[method] = time.perf_counter() - t0
        init_pool = np.loadtxt(os.path.join(root, "init_pool_inds.txt"),
                               dtype=np.int64)
        train, pool = res["train_inds"], res["pool_inds"]
        check(len(init_pool) == 65536, f"pool size {len(init_pool)}")
        check(res["n_queries"] == 128 and len(res["perf"]) == 2,
              f"{method}: {res['n_queries']} queries, "
              f"{len(res['perf'])} rounds")
        check(len(train) == 256 + 128 and len(set(train.tolist())) == 384,
              f"{method}: labeled set has {len(train)} entries")
        check(not set(train.tolist()) & set(pool.tolist())
              and set(train.tolist()) | set(pool.tolist())
              == set(init_pool.tolist()), f"{method}: membership broken")
        check(bool(np.isfinite(res["perf"]).all()),
              f"{method}: non-finite F {res['perf']}")
        dk1 = ops.similarity.KERNEL.launches - k1_0
        dk2 = ops.gather.KERNEL.launches - k2_0
        check(dk2 >= 2, f"{method}: K2 launched {dk2} times in finetune")
        if method == "core-set":
            check(dk1 >= 2, f"core-set: K1 launched {dk1} times")
        print(f"campaign {method}: F per round {res['perf'].tolist()}, "
              f"{seconds[method]:.3f} s, K1 +{dk1}, K2 +{dk2}")
        with open(os.path.join(root, method, "phases.jsonl")) as f:
            phases[method] = [json.loads(line) for line in f]
    for k in ops.KERNELS:
        counts[k.name] = k.launches
        check(k.launches > 0, f"{k.name} never launched in the campaign")
    return counts, phases, seconds


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
    print(f"kernel build {build_s:.3f} s")
    for k in ops.KERNELS:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {k.name}: {line.strip()}")

    rows = [phase_k1(dev), phase_k2(dev)]
    phase_forward(dev)
    counts, phases, seconds = phase_campaign(dev)
    for r in rows:
        r["launches"] = counts[r["name"]]
        r["kernel_ms"], r["max_err"] = r["ms"], r["max_abs_err"]
    print(json.dumps({"phases": phases, "campaign_s": seconds,
                      "build_s": build_s}))
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
