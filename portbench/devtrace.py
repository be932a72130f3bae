"""Reduce a traced window to what the per-layer metrics and the result's
``device`` and ``breakdown`` read.

From the profiler's events: the window (the ``portbench/window`` span),
every operation that ran on the device (kernels, copies, fills) clipped to
it, the seconds in which at least one ran (``busy_s``), device seconds by
operation name, and the idle gaps between operations, each named by the
innermost harness span (``portbench/...``) and the outermost host
operation that were open at the gap's middle.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple


def _events(prof):
    """``(name, device, start_ns, end_ns, is_annotation)`` of each event."""
    out = []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        out.append((e.name(), e.device_type().name == "CUDA", s,
                    s + e.duration_ns(), bool(e.is_user_annotation())))
    return out


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def _open_at(spans, starts, t):
    """Spans of ``spans`` (sorted by start) that are open at ``t``."""
    i = bisect.bisect_right(starts, t)
    return [sp for sp in spans[:i] if sp[2] > t]


def reduce(prof, top: int = 10) -> dict:
    evs = _events(prof)
    win = [e for e in evs if e[0] == "portbench/window" and not e[1]]
    if not win:
        raise RuntimeError("the trace holds no portbench/window span")
    w0, w1 = win[0][2], win[0][3]
    dev = []
    by_name: Dict[str, float] = defaultdict(float)
    harness, host = [], []
    for name, on_dev, s, e, ann in evs:
        if on_dev and (ann or name.startswith("portbench/")):
            continue        # the device track's copy of a host range
        if on_dev:
            s, e = max(s, w0), min(e, w1)
            if e > s:
                dev.append((s, e))
                by_name[name] += (e - s) * 1e-9
        elif name.startswith("portbench/") and name != "portbench/window":
            harness.append((s, name, e))
        elif not ann and e > w0 and s < w1:
            host.append((s, name, e))
    busy = _merge(dev)
    busy_s = sum(e - s for s, e in busy) * 1e-9
    gaps = []
    prev = w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    harness.sort()
    host.sort()
    h_starts = [sp[0] for sp in harness]
    o_starts = [sp[0] for sp in host]
    named = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (s + e) // 2
        hs = _open_at(harness, h_starts, mid)
        ops = _open_at(host, o_starts, mid)
        label = hs[-1][1] if hs else "portbench/window"
        if ops:
            label += "|" + ops[0][1]
        named.append([label[:64], (e - s) * 1e-9])
    ops_top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": busy_s,
        "device_by_name": dict(by_name),
        "breakdown": {"device_ops": [[n[:64], v] for n, v in ops_top],
                      "idle_gaps": named},
    }
