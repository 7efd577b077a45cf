"""p99_ms: the nearest-rank 99th percentile latency over every query of
the window, from its due time to its count on the host. End to end in the
closed cells; ``p99_ms.open``, the open cell's tail, is read per layer over
a traced window (a queue near saturation on one host thread spreads too
widely between runs for an end-to-end bound)."""

from bench import stats


def read(run):
    return stats.nearest_rank(run.latencies_ms, 0.99)
