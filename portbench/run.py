"""The benchmark of ``nnal_tpu_torch`` on NVIDIA GPUs: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

``BENCHMARK.json`` (beside this directory) names the cell's configuration
and traffic mix; :mod:`harness` finds their files and the driver.  A run
makes its inputs from the seed, sets up and warms up (``setup_s``),
measures for ``--seconds`` up to the next whole round or subject, checks
what the window produced against the plain reference, and prints one JSON
line last: the end-to-end metrics with ``--trace 0``, the per-layer
metrics (from a profiler trace of the window) with ``--trace 1``.  The
numbers compared for ``correct`` are printed last on standard error too,
each beside its limit.  Without a CUDA card the run exits with code 2 and
prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _environment() -> None:
    """Compile caches at fixed paths inside the checkout; no JAX backend
    for libraries that would load one by themselves."""
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (HERE, ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)


def run_cell(cell: dict, cfg: dict, mix: dict, limits: dict, seed: int,
             seconds: float, trace: bool, device, t0: float) -> dict:
    """One run of ``cell``; returns the result object (without printing)."""
    import torch

    import devtrace
    import harness
    import reference

    workdir = os.path.join(tempfile.gettempdir(), "portbench",
                           cell["name"])
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    ctx = harness.Context(cell, cfg, mix, limits, seed, seconds, device,
                          workdir, t0)
    drv = harness.driver(mix, cfg)
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ctx.part("start")
    inp = drv.inputs(ctx)
    st = drv.setup(ctx, inp)
    win = harness.Window(seconds, trace, ctx.device)
    try:
        res = drv.window(ctx, st, win)
        setup_s = win.t0 - t0
        peak = (torch.cuda.max_memory_allocated(ctx.device)
                if ctx.device.type == "cuda" else 0)
        e2e = drv.end_to_end(ctx, res)
        rec = drv.record(ctx, st, res) if trace else None
        out = drv.outputs(ctx, st, res)
        st.clear()          # the program's state goes before the check
        del st
        gc.collect()
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        with reference.precision(tf32=False):
            checks = drv.check(ctx, inp, out)
        del out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    harness.log("setup parts (s): " + json.dumps(
        {k: round(v, 4) for k, v in ctx.parts.items()}))
    if "launches" in res:
        harness.log("kernel launches (ops.KERNELS): "
                    + json.dumps(res["launches"]))
    correct = harness.correct(checks)
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(ctx.device)
                    if ctx.device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    metrics = {}
    out = {"correct": bool(correct), "attempted": int(res["units"]),
           "failed": 0}
    if trace:
        red = devtrace.reduce(win.prof)
        rec.update(trace=red, peaks=harness.load_json(
            os.path.join(HERE, "peaks.json")), device=dev["kind"])
        dev.update(busy_s=red["busy_s"], window_s=red["window_s"])
        units = {m["name"]: m["unit"] for m in harness.manifest()["per_layer"]}
        for m in harness.manifest()["per_layer"]:
            if cell["name"] not in m.get("workloads", [cell["name"]]):
                continue
            v = harness.metric_reader(m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v),
                                      "unit": units[m["name"]]}
        out["breakdown"] = red["breakdown"]
    else:
        e2e["setup_s"] = setup_s
        units = {m["name"]: m["unit"]
                 for m in harness.manifest()["end_to_end"]}
        metrics = {k: {"value": float(v), "unit": units[k]}
                   for k, v in e2e.items()}
    out["metrics"] = metrics
    out["device"] = dev
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    harness.log("end to end: " + json.dumps(
        {k: v for k, v in e2e.items()}) + f" setup_s {setup_s}")
    for c in checks:
        harness.log(f"check {c['name']}: {c['value']!r} "
                    f"(limit {c['limit']!r})")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch

    import harness

    man = harness.manifest()
    cell = harness.cell(man, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        harness.log(f"{args.workload} needs {cell['chips']} CUDA card(s); "
                    f"this machine has {have}")
        return 2
    cfg = harness.config(cell["config"])
    mix = harness.traffic(cell["traffic"], cfg["family"])
    limits = harness.load_json(os.path.join(HERE, "limits",
                                            f"{cell['name']}.json"))
    out = run_cell(cell, cfg, mix, limits, args.seed, args.seconds,
                   bool(args.trace), "cuda", T0)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"modules that must not load: {found}")
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
