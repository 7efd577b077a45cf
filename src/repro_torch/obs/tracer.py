"""Deterministic simulated-clock span tracer.

Every number this repo reports is model-derived (DRAM timing rules, the
channel cost model, the scheduler's epoch timeline) - never wall clock -
so a trace of a run is *reproducible*: identical inputs produce
byte-identical traces, and CI can diff them the same way it diffs
ledgers. The tracer records spans on that simulated clock:

  * **clocked spans** carry explicit ``[start_ns, start_ns + dur_ns)``
    positions on a caller-owned simulated clock (the scheduler's drain
    timeline, the serving frontend's arrival clock);
  * **cursor spans** (``tick``) land on a per-track *busy-time* cursor -
    each track is its own cumulative timeline of simulated busy ns
    (engine AAP batches, RowClone/PSM migrations), advanced only by the
    spans recorded on it;
  * **sequence instants** mark unclocked events (store IO, fused
    dispatches) in deterministic call order on their track.

Zero overhead when disabled: every method returns immediately off a
single ``enabled`` check and records nothing - the disabled singleton
``NULL_TRACER`` is the default everywhere, so untraced runs execute the
exact same accounting code paths (the differential tests assert the
ledgers are bit-identical with tracing on and off).

A ``track`` is a tuple of names, e.g. ``("device0", "bank3")`` or
``("scheduler",)``: the first element becomes the Perfetto process, the
full tuple the thread (see obs.export).

**Host spans** are the one exception to the simulated clock: with
``host_enabled`` (a switch of its own, off by default and independent of
``enabled``) each ``host_span`` site records a complete span on the
host's ``time.perf_counter_ns`` clock, on the ``HOST_TRACK``, into
``host_events``, with its parent span's id and, where the layer knows
it, the query's id (the frontend's ``seq``). A span reads the clock
twice and opens no ``torch.profiler.record_function``: under a profiler
one costs about 15 µs, which the card would wait for. A reader that sets
the spans beside a profiler's trace maps ``perf_counter_ns`` onto the
trace's clock from a few annotations of its own whose host times it
read (``bench/idlesplit.py``).
Off, a site costs one attribute check and a shared no-op context: no
clock read, no event.
``host_summary`` gives each name's count, total and self seconds. Spans
nest on one stack a tracer: a tracer's host spans belong to one thread.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

Track = Tuple[str, ...]

#: The track every host span lands on (its own Perfetto process).
HOST_TRACK: Track = ("host",)


@dataclasses.dataclass
class TraceEvent:
    """One recorded event. ``kind`` follows the Chrome trace-event
    phases: "X" complete span, "i" instant, "b"/"e" async span begin/end
    (``span_id`` scopes the pair)."""

    kind: str
    track: Track
    name: str
    cat: str
    ts_ns: float
    dur_ns: float = 0.0
    span_id: Optional[int] = None
    args: Optional[dict] = None


class Tracer:
    """Span recorder over simulated clocks (see module docstring).

    ``events`` is the append-only record in call order; exporters decide
    the wire format (obs.export.chrome_trace). ``enabled=False``
    constructs a no-op tracer - ``NULL_TRACER`` is the shared disabled
    instance layers default to."""

    def __init__(self, enabled: bool = True, host_enabled: bool = False):
        self.enabled = enabled
        self.host_enabled = host_enabled
        self.events: List[TraceEvent] = []
        self.host_events: List[TraceEvent] = []
        self._cursors: Dict[Track, float] = {}
        self._seq: Dict[Track, int] = {}
        self._host_stack: List[int] = []    # ids of the open host spans
        self._host_ids = 0

    def clear(self) -> None:
        self.events.clear()
        self.host_events.clear()
        self._cursors.clear()
        self._seq.clear()

    # -- clocked spans --------------------------------------------------------

    def span(self, track: Track, name: str, cat: str, start_ns: float,
             dur_ns: float, args: Optional[dict] = None) -> None:
        """Complete span at an explicit simulated-clock position."""
        if not self.enabled:
            return
        self.events.append(TraceEvent("X", track, name, cat,
                                      float(start_ns), float(dur_ns), None,
                                      args))

    def instant(self, track: Track, name: str, cat: str,
                ts_ns: Optional[float] = None,
                args: Optional[dict] = None) -> None:
        """Instant event. With ``ts_ns=None`` the event lands at the
        track's sequence position (deterministic call order) instead of
        a clock position - unclocked layers (store IO) use this."""
        if not self.enabled:
            return
        if ts_ns is None:
            ts_ns = float(self._seq.get(track, 0))
            self._seq[track] = int(ts_ns) + 1
        self.events.append(TraceEvent("i", track, name, cat,
                                      float(ts_ns), 0.0, None, args))

    def async_begin(self, track: Track, name: str, cat: str, span_id: int,
                    ts_ns: float, args: Optional[dict] = None) -> None:
        """Begin an async (overlappable) span - query lifetimes overlap
        freely on one track, scoped by ``span_id``."""
        if not self.enabled:
            return
        self.events.append(TraceEvent("b", track, name, cat,
                                      float(ts_ns), 0.0, span_id, args))

    def async_end(self, track: Track, name: str, cat: str, span_id: int,
                  ts_ns: float, args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        self.events.append(TraceEvent("e", track, name, cat,
                                      float(ts_ns), 0.0, span_id, args))

    # -- cursor (busy-time) spans ---------------------------------------------

    def cursor(self, track: Track) -> float:
        """The track's cumulative busy-time position."""
        return self._cursors.get(track, 0.0)

    def advance(self, track: Track, dur_ns: float) -> None:
        if not self.enabled:
            return
        self._cursors[track] = self._cursors.get(track, 0.0) + float(dur_ns)

    def tick(self, track: Track, name: str, cat: str, dur_ns: float,
             args: Optional[dict] = None) -> None:
        """Span at the track's busy-time cursor; advances the cursor by
        ``dur_ns`` so successive ticks lay end to end."""
        if not self.enabled:
            return
        t0 = self._cursors.get(track, 0.0)
        self.events.append(TraceEvent("X", track, name, cat, t0,
                                      float(dur_ns), None, args))
        self._cursors[track] = t0 + float(dur_ns)

    # -- host-clock spans -----------------------------------------------------

    def host_span(self, name: str, query: Optional[int] = None, **args):
        """Context manager timing its block on the host's clock (see the
        module docstring); ``args`` land in the event's ``args`` beside
        ``parent`` and ``query``. The context's ``note(**args)`` adds
        args known only inside the block."""
        if not self.host_enabled:
            return _NO_SPAN
        return _HostSpan(self, name, query, args)

    def host_summary(self) -> Dict[str, Dict[str, float]]:
        """``{name: {"count", "total_s", "self_s"}}`` over ``host_events``:
        a span's self time is its duration less its child spans' (which
        lie inside it, one after another, on its thread)."""
        child_ns: Dict[int, int] = {}
        for e in self.host_events:
            parent = e.args["parent"]
            if parent is not None:
                child_ns[parent] = child_ns.get(parent, 0) + e.dur_ns
        out: Dict[str, Dict[str, float]] = {}
        for e in self.host_events:
            s = out.setdefault(e.name, {"count": 0, "total_s": 0.0,
                                        "self_s": 0.0})
            s["count"] += 1
            s["total_s"] += e.dur_ns * 1e-9
            s["self_s"] += (e.dur_ns - child_ns.get(e.span_id, 0)) * 1e-9
        return out

    # -- introspection --------------------------------------------------------

    def __len__(self) -> int:
        return len(self.events)

    def spans(self, cat: Optional[str] = None) -> List[TraceEvent]:
        """Complete ("X") events, optionally filtered by category."""
        return [e for e in self.events
                if e.kind == "X" and (cat is None or e.cat == cat)]

    def __repr__(self):
        state = "enabled" if self.enabled else "disabled"
        return f"<Tracer {state} events={len(self.events)}>"


class _NoSpan:
    """The shared context of a host span site while host spans are off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def note(self, **args) -> None:
        pass


_NO_SPAN = _NoSpan()


class _HostSpan:
    """One open host span: a ``perf_counter_ns`` interval recorded into
    the tracer on exit."""

    __slots__ = ("tracer", "name", "args", "span_id", "t0")

    def __init__(self, tracer: Tracer, name: str, query: Optional[int],
                 args: dict):
        self.tracer, self.name = tracer, name
        self.args = {"parent": None, "query": query, **args}

    def note(self, **args) -> None:
        self.args.update(args)

    def __enter__(self):
        tr = self.tracer
        tr._host_ids += 1
        self.span_id = tr._host_ids
        self.args["parent"] = tr._host_stack[-1] if tr._host_stack else None
        tr._host_stack.append(self.span_id)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        tr = self.tracer
        tr._host_stack.pop()
        tr.host_events.append(TraceEvent(
            "X", HOST_TRACK, self.name, "host", self.t0, t1 - self.t0,
            self.span_id, self.args))
        return False


#: Shared disabled tracer: the default for every layer, so untraced runs
#: pay one boolean check per trace point and record nothing.
NULL_TRACER = Tracer(enabled=False)
