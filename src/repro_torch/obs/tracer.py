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
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

Track = Tuple[str, ...]


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

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.events: List[TraceEvent] = []
        self._cursors: Dict[Track, float] = {}
        self._seq: Dict[Track, int] = {}

    def clear(self) -> None:
        self.events.clear()
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


#: Shared disabled tracer: the default for every layer, so untraced runs
#: pay one boolean check per trace point and record nothing.
NULL_TRACER = Tracer(enabled=False)
