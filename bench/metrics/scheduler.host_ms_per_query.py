"""scheduler.host_ms_per_query: ms inside AmbitRuntime.drain, which the
frontend runs for each window (the scheduler's epochs, the device store's
planning and the kernels' launches on the host; the benchmark's span
``scheduler.drain``), per query answered in the traced window. Also reads
scheduler.host_ms_per_query.open: the closed cells' entry moves qps, the
open cells' p99_ms."""


def read(run):
    return run.span_s("scheduler.drain") * 1e3 / run.answered \
        if run.answered else None
