"""runtime.answer_ms_per_query: ms inside AmbitRuntime.popcount and free
(where the host waits for the card) per query answered in the traced
window. Closed-loop cells; moves qps."""


def read(run):
    return run.span_s("runtime.") * 1e3 / run.answered if run.answered \
        else None
