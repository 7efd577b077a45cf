"""frontend.host_ms_per_query: ms of the frontend's own host work per query
answered in the traced window: time inside QueryFrontend.submit, tick,
flush and take_completed (the benchmark's spans around each call) less
the runtime drains those calls run (span ``scheduler.drain``, read by
scheduler.host_ms_per_query). Also reads frontend.host_ms_per_query.open:
the closed cells' entry moves qps, the open cells' p99_ms."""


def read(run):
    if not run.answered:
        return None
    own = run.span_s("frontend.") - run.span_s("scheduler.drain")
    return own * 1e3 / run.answered
