"""Reduce a ``torch.profiler`` trace of the window to device numbers.

The trace is exported as Chrome JSON into ``TMPDIR``, read, and deleted.
Device activity is every event of category ``kernel``, ``gpu_memcpy`` or
``gpu_memset``; busy time is the union of their intervals. What the host
was doing in an idle gap is the benchmark's span (a
``record_function`` annotation, category ``user_annotation``) open at
the gap's start, the innermost where two nest, or ``bench`` when none
is.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"      # the annotation around the whole window
NEST = 4                     # spans looked back over for an open one


def read_trace(prof) -> List[dict]:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    return doc["traceEvents"] if isinstance(doc, dict) else doc


def _union(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: List[dict], t0_us: float, t1_us: float) -> dict:
    """Device busy seconds, summed kernel seconds, the 10 device ops that
    took most time and the idle seconds by host span, over [t0, t1] (µs
    on the trace's clock)."""
    dev, kernel_s, by_op = [], 0.0, defaultdict(float)
    spans = []
    for e in events:
        if e.get("ph") != "X":
            continue
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            a, b = max(ts, t0_us), min(ts + dur, t1_us)
            if b <= a:
                continue
            dev.append((a, b))
            by_op[e.get("name", "?")] += (b - a) * 1e-6
            if cat == "kernel":
                kernel_s += (b - a) * 1e-6
        elif cat == "user_annotation" and e.get("name") != WINDOW:
            spans.append((ts, ts + dur, e.get("name", "?")))
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    spans.sort()
    starts = [s[0] for s in spans]
    idle = defaultdict(float)
    edges = [t0_us] + [x for iv in busy for x in iv] + [t1_us]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        k = bisect.bisect_right(starts, a) - 1
        name = "bench"
        for j in range(k, max(k - NEST, -1), -1):   # latest started, open
            if spans[j][1] > a:
                name = spans[j][2]
                break
        idle[name] += (b - a) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(),  # noqa: E731
                                                key=lambda kv: -kv[1])[:10]]
    return {"busy_s": busy_s, "window_s": (t1_us - t0_us) * 1e-6,
            "kernel_s": kernel_s, "device_ops": top(by_op),
            "idle_gaps": top(idle)}


def window_bounds(events: List[dict], name: str = WINDOW
                  ) -> Tuple[float, float]:
    """[start, end] µs of the annotation ``name`` (the window's own)."""
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                and e.get("name") == name:
            ts = float(e["ts"])
            return ts, ts + float(e["dur"])
    raise ValueError(f"the trace holds no {name!r} annotation")

