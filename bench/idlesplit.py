"""Split a traced window's device idle time by what the host was doing,
and its kernel time by the call that issued each kernel.

``devtrace.summarize`` names a whole idle gap by the span open at the
gap's start. Here every instant of the window in which no kernel, copy or
memset runs goes to the innermost of the program's host spans
(``repro_torch.obs.Tracer.host_span``) open at that instant, or where
none is open to the innermost of the benchmark's own ``user_annotation``s
on the window's thread, named ``bench:<name>``. A gap that begins in
``device_store.sync`` and goes on into the call after it is split between
the two by overlap. Instants under neither go to ``bench``.

The program's spans are timed on ``perf_counter_ns`` and open no
annotation, so the profiler's own cost stays out of them; they are put
on the trace's clock by ``host_to_trace``, from ``ANCHOR`` annotations
whose host times were read around them at the window's two ends.

Kernel time by issuer: each kernel's ``cudaLaunchKernel`` (the runtime
event of the same correlation id) lies inside the span that issued it.
Kernels issued inside a ``LAUNCH`` span carry that span's key (its
operand count).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, Dict, List, Sequence, Tuple

from .devtrace import DEVICE_CATS, WINDOW, _union

OUTSIDE = "bench"            # the benchmark's loop outside any annotation
BENCH = "bench:"             # the benchmark's annotations, by name
LAUNCH = "device_store.launch"
SYNC = "device_store.sync"
ANCHOR = "host.anchor"       # an annotation whose host time was read

#: ``(start_us, end_us, name, key)``: a program span on the trace's clock
Span = Tuple[float, float, str, object]


def _annotations(events: List[dict]) -> List[Tuple[float, float, str]]:
    """The window's thread's annotations (the window's own and the
    anchors left out)."""
    win = next(e for e in events if e.get("ph") == "X"
               and e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW)
    thread = (win.get("pid"), win.get("tid"))
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
             e.get("name", "?")) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e.get("name") not in (WINDOW, ANCHOR)
            and (e.get("pid"), e.get("tid")) == thread]


def host_to_trace(events: List[dict],
                  brackets: Sequence[Sequence[Tuple[int, int]]]
                  ) -> Tuple[Callable[[float], float], float]:
    """The map of ``perf_counter_ns`` onto the trace's µs, and its
    uncertainty in µs. ``brackets`` holds two groups (the window's two
    ends) of ``(before_ns, after_ns)``: the host's clock read before and
    after each ``ANCHOR`` annotation opened, in the order the trace's
    anchors start. At each end the clocks' offset lies in every one of
    its group's intervals; the map runs through the two ends' offsets,
    so a difference in the clocks' rates is taken out too."""
    ts = sorted(float(e["ts"]) for e in events if e.get("ph") == "X"
                and e.get("cat") == "user_annotation"
                and e.get("name") == ANCHOR)
    if len(brackets) != 2 or len(ts) != sum(map(len, brackets)):
        raise ValueError(f"{len(ts)} anchors in the trace for brackets "
                         f"of {[len(g) for g in brackets]}")
    ends, err, it = [], 0.0, iter(ts)
    for group in brackets:
        lo, hi = -float("inf"), float("inf")
        for (before, after), t in zip(group, it):
            lo, hi = max(lo, t - after * 1e-3), min(hi, t - before * 1e-3)
        ends.append((sum(b for b, _ in group) / len(group), (lo + hi) / 2))
        err = max(err, abs(hi - lo) / 2)
    (h0, off0), (h1, off1) = ends
    rate = (off1 - off0) / (h1 - h0)

    def to_us(ns: float) -> float:
        return ns * 1e-3 + off0 + rate * (ns - h0)
    return to_us, err


def innermost(spans: List[Tuple[float, float, str]], t0: float, t1: float
              ) -> List[Tuple[float, float, int]]:
    """[t0, t1] cut into pieces ``(start, end, k)``, ``k`` the index in
    ``spans`` of the innermost span open over the piece, -1 for none.
    Spans of one thread nest; one that outlives its parent by a rounding
    ends with it."""
    order = sorted(range(len(spans)),
                   key=lambda k: (spans[k][0], -spans[k][1]))
    out: List[Tuple[float, float, int]] = []
    stack: List[Tuple[float, int]] = []      # (end, k), innermost last
    cur = t0

    def close(upto: float) -> None:
        nonlocal cur
        while stack and stack[-1][0] <= upto:
            end, k = stack.pop()
            if end > cur:
                out.append((cur, end, k))
                cur = end

    for k in order:
        a, b = max(spans[k][0], t0), min(spans[k][1], t1)
        if b <= a:
            continue
        close(a)
        if a > cur:
            out.append((cur, a, stack[-1][1] if stack else -1))
            cur = a
        stack.append((b, k))
    close(t1)
    if cur < t1:
        out.append((cur, t1, -1))
    return out


def _label(spans, pieces, named) -> List[Tuple[float, float, object]]:
    """``innermost`` pieces with each span index put through ``named``
    (None outside every span)."""
    return [(a, b, named(spans[k]) if k >= 0 else None)
            for a, b, k in pieces]


def _overlay(top, under) -> List[Tuple[float, float, object]]:
    """Pieces of one range labelled by ``top`` where it names a span, by
    ``under`` elsewhere."""
    out, i, j = [], 0, 0
    while i < len(top) and j < len(under):
        a, b = max(top[i][0], under[j][0]), min(top[i][1], under[j][1])
        if b > a:
            out.append((a, b, top[i][2] if top[i][2] is not None
                        else under[j][2]))
        if top[i][1] < under[j][1]:
            i += 1
        else:
            j += 1
    return out


def split(events: List[dict], t0_us: float, t1_us: float,
          program: Sequence[Span] = ()) -> dict:
    """``idle_s``: idle seconds of [t0, t1] (µs on the trace's clock) by
    the innermost program span, else the innermost benchmark annotation
    (``bench:<name>``), else ``bench``; ``kernels``: ``[issuer, key,
    kernel, seconds, count]`` rows, most seconds first; ``window_s``."""
    bench = _annotations(events)
    pieces = _overlay(
        _label(program, innermost([s[:3] for s in program], t0_us, t1_us),
               lambda s: (s[2], s[3] if s[2] == LAUNCH else None)),
        _label(bench, innermost(bench, t0_us, t1_us),
               lambda s: (BENCH + s[2], None)))
    pieces = [(a, b, lab or (OUTSIDE, None)) for a, b, lab in pieces]
    dev, kernels, launch_ts = [], [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            ts = float(e.get("ts", 0.0))
            a, b = max(ts, t0_us), min(ts + float(e.get("dur", 0.0)), t1_us)
            if b > a:
                dev.append((a, b))
                if cat == "kernel":
                    kernels.append((e, b - a))
        elif cat == "cuda_runtime" and "LaunchKernel" in e.get("name", ""):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = float(e["ts"])
    idle = defaultdict(float)
    gaps = _complement(_union(dev), t0_us, t1_us)
    i = j = 0
    while i < len(gaps) and j < len(pieces):
        a = max(gaps[i][0], pieces[j][0])
        b = min(gaps[i][1], pieces[j][1])
        if b > a:
            idle[pieces[j][2][0]] += (b - a) * 1e-6
        if gaps[i][1] < pieces[j][1]:
            i += 1
        else:
            j += 1
    starts = [p[0] for p in pieces]
    by = defaultdict(lambda: [0.0, 0])
    for e, dur in kernels:
        ts = launch_ts.get((e.get("args") or {}).get("correlation"))
        i = bisect.bisect_right(starts, ts) - 1 if ts is not None else -1
        issuer, key = pieces[i][2] if i >= 0 and ts < pieces[i][1] \
            else (OUTSIDE, None)
        row = by[(issuer, key, e.get("name", "?"))]
        row[0] += dur * 1e-6
        row[1] += 1
    rows = sorted(([n, key, kern, s, c] for (n, key, kern), (s, c)
                   in by.items()), key=lambda r: -r[3])
    return {"window_s": (t1_us - t0_us) * 1e-6, "idle_s": dict(idle),
            "kernels": rows}


def _complement(busy: List[List[float]], t0: float, t1: float
                ) -> List[Tuple[float, float]]:
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]


def shares(result: dict) -> Dict[str, float]:
    """% of the window the card idles under ``SYNC``, and under any other
    of the program's spans (every name but the benchmark's)."""
    w, idle = result["window_s"], result["idle_s"]
    in_program = sum(v for k, v in idle.items()
                     if k != SYNC and k != OUTSIDE and not k.startswith(BENCH))
    return {"idle_in_sync": 100.0 * idle.get(SYNC, 0.0) / w,
            "idle_in_program": 100.0 * in_program / w}
