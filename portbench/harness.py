"""What every cell of the benchmark shares: the measured window, its spans,
the run's context and the result line.

A cell is a configuration (``configs/<config>.json``) under a traffic mix
(``traffic/<mix>.json``, overlaid by ``traffic/<mix>.<family>.json`` where
the configuration's family needs its own shapes).  The mix names its
driver and the configuration its family; the driver module is
``drivers/<driver>_<family>.py``, with ``inputs(ctx)`` (what the harness
makes from the seed), ``setup(ctx, inputs)``, ``window(ctx, st, win)``,
``end_to_end(ctx, res)``, ``record(ctx, st, res)``, ``outputs(ctx, st,
res)`` (what the timed path produced), ``check(ctx, inputs, outputs)``
and ``control(ctx, inputs, fault)`` (the outputs of the plain reference
put in the program's place, for ``check`` to judge).  A per-layer metric is
``metrics/<name>.py``, whose ``read(record)`` returns a number or None.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from typing import Dict, Optional

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# the top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "nnal_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, here: str = HERE) -> dict:
    return load_json(os.path.join(here, "configs", f"{name}.json"))


def traffic(mix: str, family: str, here: str = HERE) -> dict:
    """The mix's parameters, with the family's overlay merged over them."""
    out = load_json(os.path.join(here, "traffic", f"{mix}.json"))
    overlay = os.path.join(here, "traffic", f"{mix}.{family}.json")
    if os.path.exists(overlay):
        out.update(load_json(overlay))
    return out


def _load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(mix: dict, cfg: dict, here: str = HERE):
    name = f"{mix['driver']}_{cfg['family']}"
    return _load_file(os.path.join(here, "drivers", f"{name}.py"),
                      f"portbench_driver_{name}")


def metric_reader(name: str, here: str = HERE):
    return _load_file(os.path.join(here, "metrics", f"{name}.py"),
                      f"portbench_metric_{name.replace('.', '_')}")


def correct(checks) -> bool:
    """A run is correct when every number compared is finite and within
    its limit."""
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


class Window:
    """The measured window.  ``begin`` waits for the card, starts the
    profiler when tracing and opens the ``portbench/window`` span;
    ``end`` waits for the card and closes both.  ``span(name)`` is a
    profiler range of the harness's own."""

    def __init__(self, seconds: float, trace: bool, device):
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.prof = None
        self.t0: Optional[float] = None
        self.t1: Optional[float] = None
        self._span = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def begin(self) -> None:
        self.sync()
        if self.trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        self._span = torch.profiler.record_function("portbench/window")
        self._span.__enter__()
        self.t0 = time.perf_counter()

    def expired(self) -> bool:
        return time.perf_counter() - self.t0 >= self.seconds

    def end(self) -> None:
        self.sync()
        self.t1 = time.perf_counter()
        self._span.__exit__(None, None, None)
        if self.prof is not None:
            self.prof.__exit__(None, None, None)

    @property
    def elapsed(self) -> float:
        return self.t1 - self.t0

    @staticmethod
    def span(name: str):
        return torch.profiler.record_function(f"portbench/{name}")


class Context:
    """One run: the cell, its configuration, mix and limits, the seed, the
    device, a scratch directory under ``TMPDIR``, and the set-up's parts
    (seconds, the first counted from ``t0``)."""

    def __init__(self, cell: dict, cfg: dict, mix: dict, limits: dict,
                 seed: int, seconds: float, device, workdir: str,
                 t0: Optional[float] = None):
        self.cell, self.cfg, self.mix, self.limits = cell, cfg, mix, limits
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.device = torch.device(device)
        self.workdir = workdir
        self.parts: Dict[str, float] = {}
        self._t = time.perf_counter() if t0 is None else t0

    def part(self, name: str) -> None:
        """Close the set-up part ``name`` (seconds since the last part)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.parts[name] = self.parts.get(name, 0.0) + now - self._t
        self._t = now


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
