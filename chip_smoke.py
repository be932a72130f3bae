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
   wider volume, 3 modalities, and at the campaign's 384; the
   y-contiguous copy is made once per volume; device time (CUDA events
   behind a sleep kernel, and a ``torch.profiler`` window at 384) apart
   from the host's cost per call;
5. PW1 25x25x2 posteriors on 1024 patches, and the evaluator's off-grid
   (per-patch gather) route on 256 voxels, card vs host, atol 1e-4;
6. the campaign: ``do_expr(..., device="cuda")`` on a synthetic
   128x128x32 subject (pool of 65,536 grid voxels), 2 rounds each of
   ``entropy``, ``core-set`` and ``random`` (init 256, k 64, b 128, Adam
   1e-3);
   launch counts are zeroed just before and read just after, and every
   kernel must have launched;
7. one ``phases`` JSON line (per-round seconds from ``phases.jsonl``,
   build seconds, K1's SASS counts) and one ``kernels`` JSON line (times,
   bounds, launches).

The last line is ``{"ok": true, "device": {...}}``.  Without CUDA the
script exits non-zero and prints no result.  The campaign runs under
``_smoke_expr/`` beside this file (git-ignored) and is removed at the end.
"""

from __future__ import annotations

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
PEAK_TF32_FLOPS = 495e12      # TF32 on the tensor cores, dense
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
    ops.gather.KERNEL.launches = base
    b_ms, b_by = k2_bound(padded, inds, ps)
    b384_ms, _ = k2_bound(padded, small, ps)
    print(f"K2 ok: bit-equal at (25,25,1) (25,25,3) (24,24,1) {wide_ps} "
          "and with 3 modalities; "
          f"device {k_ms:.5f} ms, plain {p_ms:.4f} ms, bound {b_ms:.5f} ms "
          f"({b_by}); at 384 patches device {k384_ms:.5f} ms (profiler "
          f"{prof_us} us), back-to-back loop {loop384_ms:.5f} ms, host "
          f"us per call {host}, plain {p384_ms:.4f} ms, bound "
          f"{b384_ms:.5f} ms")
    return {"name": "gather_patches_normalized", "route": "cuda",
            "source": "nnal_tpu_torch/csrc/gather_patches.cu",
            "replaces": ops.gather.REPLACES, "max_abs_err": 0.0,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "shapes": {"padded": list(padded.shape), "inds": [n],
                       "patch": list(ps)},
            "at_384": {"ms": k384_ms, "profiler_device_us": prof_us,
                       "loop_ms": loop384_ms, "host_us": host,
                       "plain_ms": p384_ms, "bound_ms": b384_ms}}


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
    counts, phases, seconds = phase_campaign(dev)
    for r in rows:
        r["launches"] = counts[r["name"]]
        r["kernel_ms"], r["max_err"] = r["ms"], r["max_abs_err"]
    print(json.dumps({"phases": phases, "campaign_s": seconds,
                      "build_s": build_s,
                      "build_s_per_kernel": {k.name: k.build_s
                                             for k in ops.KERNELS},
                      "k1_sass": sass}))
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
