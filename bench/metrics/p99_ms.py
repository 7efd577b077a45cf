"""p99_ms: the nearest-rank 99th percentile latency over every query of
the window, from its due time to its count on the host."""

from bench import stats


def read(run):
    return stats.nearest_rank(run.latencies_ms, 0.99)
