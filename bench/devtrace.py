"""Reduce a ``torch.profiler`` trace of the window to device numbers.

The trace is exported as Chrome JSON into ``TMPDIR``, read, and deleted.
Device activity is every event of category ``kernel``, ``gpu_memcpy`` or
``gpu_memset``; busy time is the union of their intervals. What the host
was doing while the card idled is ``idlesplit``'s to say.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"      # the annotation around the whole window


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


def top(seconds: Dict[str, float], n: Optional[int] = 10) -> List[list]:
    """``[name, seconds]`` pairs, most seconds first, the first ``n`` (all
    when None)."""
    return [[k, v] for k, v in sorted(seconds.items(),
                                      key=lambda kv: -kv[1])[:n]]


def summarize(events: List[dict], t0_us: float, t1_us: float) -> dict:
    """Device busy seconds, summed kernel seconds and the 10 device ops
    that took most time, over [t0, t1] (µs on the trace's clock)."""
    dev, kernel_s, by_op = [], 0.0, defaultdict(float)
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
    busy_s = sum(b - a for a, b in _union(dev)) * 1e-6
    return {"busy_s": busy_s, "window_s": (t1_us - t0_us) * 1e-6,
            "kernel_s": kernel_s, "device_ops": top(by_op)}


def window_bounds(events: List[dict], name: str = WINDOW
                  ) -> Tuple[float, float]:
    """[start, end] µs of the annotation ``name`` (the window's own)."""
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                and e.get("name") == name:
            ts = float(e["ts"])
            return ts, ts + float(e["dur"])
    raise ValueError(f"the trace holds no {name!r} annotation")

