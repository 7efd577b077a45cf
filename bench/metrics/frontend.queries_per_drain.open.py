"""frontend.queries_per_drain.open: queries a window drain took, from the
program's counters over the traced window (serve_batched_queries over
serve_drains). Open-loop cells, where deadline drains leave windows part
filled; moves p50_ms."""


def read(run):
    drains = run.counters.get("serve_drains", 0)
    return run.counters["serve_batched_queries"] / drains if drains else None
