"""scheduler.queries_per_launch: queries a fused launch served, from the
program's counters over the traced window (fused_queries over
fused_dispatches: a stacked epoch is one launch for all its queries).
Closed-loop cells; moves qps."""


def read(run):
    launches = run.counters.get("fused_dispatches", 0)
    return run.counters["fused_queries"] / launches if launches else None
