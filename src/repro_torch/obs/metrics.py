"""Labeled counters/gauges/histograms with one-source-of-truth intent.

The repo accounts everything in model units (simulated ns, nJ, bytes,
AAP macros) across several ad-hoc ledgers - ``OpStats``,
``ChannelLedger``, per-store byte counters, the serving frontend's
latency list. ``MetricsRegistry`` is the superset view: the layers
increment named, labeled series at the *same call sites* that update the
legacy ledgers, so the two stay bit-exactly reconciled (asserted by
tests/test_obs.py) and the legacy structs become views that can
eventually retire.

Design points:

  * label sets are canonicalised to sorted ``(key, value)`` tuples, so
    series identity never depends on kwarg order or dict iteration;
  * metrics are *always on* - increments are a dict add, cheap enough
    to not need gating, which is what makes reconciliation with the
    legacy ledgers unconditional (the opt-in knob is the span tracer);
  * ``Histogram.percentile`` uses the same nearest-rank definition as
    serve/frontend and returns ``None`` (never NaN, never raises) on an
    empty series - the p50/p99-on-0-or-1-completions edge cases;
  * ``snapshot()`` emits plain JSON-safe dicts with
    ``name{k=v,...}`` flat keys, byte-stable under ``json.dumps``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_key(name: str, key: LabelKey) -> str:
    if not key:
        return name
    inner = ",".join(f"{k}={v}" for k, v in key)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotone sum per label set."""

    def __init__(self, name: str):
        self.name = name
        self.series: Dict[LabelKey, float] = {}

    def inc(self, value: float = 1.0, **labels) -> None:
        key = _labels_key(labels)
        self.series[key] = self.series.get(key, 0.0) + value

    def value(self, **labels) -> float:
        return self.series.get(_labels_key(labels), 0.0)

    def total(self) -> float:
        return sum(self.series.values())


class Gauge:
    """Last-set value per label set."""

    def __init__(self, name: str):
        self.name = name
        self.series: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels) -> None:
        self.series[_labels_key(labels)] = value

    def value(self, **labels) -> Optional[float]:
        return self.series.get(_labels_key(labels))


class Histogram:
    """Full-sample histogram (observations are kept, not bucketed -
    sample counts here are thousands, not billions, and exact
    percentiles are what the differential tests compare)."""

    def __init__(self, name: str):
        self.name = name
        self.series: Dict[LabelKey, List[float]] = {}

    def observe(self, value: float, **labels) -> None:
        self.series.setdefault(_labels_key(labels), []).append(value)

    def values(self, **labels) -> List[float]:
        return self.series.get(_labels_key(labels), [])

    def count(self, **labels) -> int:
        return len(self.values(**labels))

    def sum(self, **labels) -> float:
        return sum(self.values(**labels))

    def percentile(self, p: float, **labels) -> Optional[float]:
        """Nearest-rank percentile; ``None`` on an empty series (a
        single observation is every percentile of itself)."""
        vals = sorted(self.values(**labels))
        if not vals:
            return None
        import math
        k = min(len(vals) - 1, max(0, math.ceil(p * len(vals)) - 1))
        return vals[k]


class MetricsRegistry:
    """Namespace of metrics; ``counter``/``gauge``/``histogram`` are
    idempotent get-or-create so layers can share series by name."""

    def __init__(self):
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(name)
        return h

    def snapshot(self) -> dict:
        """JSON-safe dump: flat ``name{k=v}`` keys, sorted; histograms
        summarised as count/sum/p50/p99 (``None`` percentiles stay
        ``None`` -> JSON null, never NaN)."""
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for name in sorted(self.counters):
            c = self.counters[name]
            for key in sorted(c.series):
                out["counters"][_fmt_key(name, key)] = c.series[key]
        for name in sorted(self.gauges):
            g = self.gauges[name]
            for key in sorted(g.series):
                out["gauges"][_fmt_key(name, key)] = g.series[key]
        for name in sorted(self.histograms):
            h = self.histograms[name]
            for key in sorted(h.series):
                vals = sorted(h.series[key])
                import math
                def _pct(p: float) -> Optional[float]:
                    if not vals:
                        return None
                    k = min(len(vals) - 1, max(0, math.ceil(p * len(vals)) - 1))
                    return vals[k]
                out["histograms"][_fmt_key(name, key)] = {
                    "count": len(vals),
                    "sum": sum(vals),
                    "p50": _pct(0.50),
                    "p99": _pct(0.99),
                }
        return out
