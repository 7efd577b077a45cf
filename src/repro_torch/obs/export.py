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

``utilization_report`` turns a drained runtime's metrics + drain report
into the text summary the benchmarks print: per-bank busy%, epoch
packing efficiency, channel-vs-compute overlap.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

from .tracer import Tracer, Track


def chrome_trace(tracer: Tracer, process_name: str = "repro") -> dict:
    """Render events as a trace-event JSON object (dict, not string)."""
    tracks = sorted({e.track for e in tracer.events})
    pids: Dict[str, int] = {}
    tids: Dict[Track, int] = {}
    for track in tracks:
        group = track[0] if track else ""
        if group not in pids:
            pids[group] = len(pids) + 1
        if track not in tids:
            tids[track] = len(tids) + 1

    events = []
    for group in sorted(pids):
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
    for e in tracer.events:
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


def utilization_report(tracer: Optional[Tracer] = None,
                       registry=None,
                       drain=None,
                       max_batch: Optional[int] = None) -> str:
    """Text utilization summary from any subset of {tracer, registry,
    drain report}; sections for absent inputs are skipped.

    - per-bank busy% comes from the ``bank_busy_ns`` counter over the
      drain wall time;
    - packing efficiency = queries / (epochs * max_batch) when
      ``max_batch`` is known, else mean queries-per-epoch;
    - channel-vs-compute overlap compares serialized channel ns with
      the compute-only epoch ns.
    """
    lines = []
    if drain is not None:
        wall = getattr(drain, "wall_ns", None)
        if wall is None:
            wall = sum(e.ns for e in drain.epochs)
        n_q = sum(len(e.tickets) for e in drain.epochs)
        lines.append("== drain ==")
        lines.append(f"epochs={len(drain.epochs)} queries={n_q} "
                     f"wall_ns={wall:.1f} serial_ns={drain.serial_ns:.1f}")
        if drain.epochs:
            chan = sum(e.channel_ns for e in drain.epochs)
            comp = sum(e.ns - e.channel_ns for e in drain.epochs)
            denom = chan + comp
            pct = (100.0 * chan / denom) if denom else 0.0
            lines.append(f"channel_ns={chan:.1f} compute_ns={comp:.1f} "
                         f"channel_share={pct:.1f}%")
            stall = getattr(drain, "refresh_stall_ns", 0.0)
            if stall:
                share = 100.0 * stall / wall if wall else 0.0
                lines.append(f"refresh_stall_ns={stall:.1f} "
                             f"refresh_share={share:.1f}%")
            if max_batch:
                eff = 100.0 * n_q / (len(drain.epochs) * max_batch)
                lines.append(f"packing_efficiency={eff:.1f}% "
                             f"(max_batch={max_batch})")
            else:
                lines.append(
                    f"queries_per_epoch={n_q / len(drain.epochs):.2f}")
    if registry is not None:
        busy = registry.counters.get("bank_busy_ns")
        if busy is not None and busy.series:
            lines.append("== per-bank busy ==")
            wall = None
            if drain is not None:
                wall = getattr(drain, "wall_ns", None)
            for key in sorted(busy.series):
                ns = busy.series[key]
                label = ",".join(f"{k}={v}" for k, v in key)
                if wall:
                    lines.append(f"bank[{label}] busy_ns={ns:.1f} "
                                 f"busy={100.0 * ns / wall:.1f}%")
                else:
                    lines.append(f"bank[{label}] busy_ns={ns:.1f}")
        stolen = registry.counters.get("refresh_stolen_ns")
        if stolen is not None and stolen.series:
            # The planner's steady-state refresh tax per bank: tRFC out
            # of every tREFI interleaved with the busy time above.
            lines.append("== refresh ==")
            for key in sorted(stolen.series):
                ns = stolen.series[key]
                label = ",".join(f"{k}={v}" for k, v in key)
                lines.append(f"refresh[{label}] stolen_ns={ns:.1f}")
        io = registry.counters.get("store_io_bytes")
        if io is not None and io.series:
            lines.append("== bytes by cause ==")
            for key in sorted(io.series):
                label = ",".join(f"{k}={v}" for k, v in key)
                lines.append(f"io[{label}] bytes={int(io.series[key])}")
    if tracer is not None and tracer.events:
        cats: Dict[str, int] = {}
        for e in tracer.events:
            cats[e.cat] = cats.get(e.cat, 0) + 1
        lines.append("== trace ==")
        lines.append(f"events={len(tracer.events)} " + " ".join(
            f"{c}={n}" for c, n in sorted(cats.items())))
    return "\n".join(lines)
