"""Deterministic observability: simulated-clock tracing + metrics.

See tracer.py (spans, and host-clock spans beside them), metrics.py
(registry), export.py (Perfetto JSON). Layers accept
``tracer=``/``metrics=`` and default to the disabled ``NULL_TRACER`` / a
private registry.
"""

from .tracer import NULL_TRACER, TraceEvent, Tracer
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .export import chrome_trace, write_chrome_trace

__all__ = [
    "NULL_TRACER",
    "TraceEvent",
    "Tracer",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "chrome_trace",
    "write_chrome_trace",
]
