"""Trace and metrics exporters.

``chrome_trace`` renders a Tracer's events as Chrome/Perfetto
trace-event JSON (load in https://ui.perfetto.dev or chrome://tracing):
each track's first name becomes the process, the full track tuple the
thread, so banks and devices show up as parallel swimlanes on the
simulated clock. Everything is deterministic - pids/tids are assigned
from the *sorted* track list, events stay in recorded order, and
``write_chrome_trace`` serialises with sorted keys - so identical runs
produce byte-identical files and CI diffs them directly.

Timestamps: Chrome's ``ts`` field is microseconds; we emit ``ns/1000``
for display but keep the exact simulated ``ns`` (and ``dur_ns``) in each
event's ``args`` so reports and tests reconcile without float-division
loss.

A tracer's host spans (``Tracer.host_events``, on the host's
``perf_counter_ns`` clock) follow the simulated events, on a process of
their own numbered after every simulated one, so the simulated part of
the file is the same with host spans on or off.
"""

from __future__ import annotations

import json
from typing import Dict

from .tracer import Tracer, Track


def chrome_trace(tracer: Tracer, process_name: str = "repro") -> dict:
    """Render events as a trace-event JSON object (dict, not string)."""
    tracks = sorted({e.track for e in tracer.events})
    tracks += sorted({e.track for e in tracer.host_events} - set(tracks))
    pids: Dict[str, int] = {}
    tids: Dict[Track, int] = {}
    for track in tracks:
        group = track[0] if track else ""
        if group not in pids:
            pids[group] = len(pids) + 1
        if track not in tids:
            tids[track] = len(tids) + 1

    events = []
    for group in sorted(pids, key=pids.get):
        events.append({
            "ph": "M", "name": "process_name", "pid": pids[group], "tid": 0,
            "args": {"name": f"{process_name}:{group}"},
        })
    for track in tracks:
        events.append({
            "ph": "M", "name": "thread_name", "pid": pids[track[0]],
            "tid": tids[track],
            "args": {"name": "/".join(track)},
        })
    for e in tracer.events + tracer.host_events:
        ev = {
            "ph": e.kind,
            "name": e.name,
            "cat": e.cat,
            "pid": pids[e.track[0]],
            "tid": tids[e.track],
            "ts": e.ts_ns / 1000.0,
            "args": dict(e.args or {}),
        }
        ev["args"]["ns"] = e.ts_ns
        if e.kind == "X":
            ev["dur"] = e.dur_ns / 1000.0
            ev["args"]["dur_ns"] = e.dur_ns
        if e.kind == "i":
            ev["s"] = "t"
        if e.span_id is not None:
            ev["id"] = e.span_id
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ns"}


def write_chrome_trace(tracer: Tracer, path: str,
                       process_name: str = "repro") -> None:
    """Serialise deterministically (sorted keys, fixed separators,
    trailing newline) so byte-level diffs work in CI."""
    doc = chrome_trace(tracer, process_name=process_name)
    with open(path, "w") as f:
        json.dump(doc, f, sort_keys=True, separators=(",", ":"),
                  allow_nan=False)
        f.write("\n")
