"""scheduler.self_ms_per_query: ms of the scheduler's own host work per
query answered in the traced window: the self time of the program's
``scheduler.drain`` spans (epochs and planning, less the launches inside
them), over the window's answers. Also reads
scheduler.self_ms_per_query.open: the closed cells' entry moves qps, the
open cell's p50_ms."""


def read(run):
    return run.ms_per_answer(run.host_s("scheduler.drain", "self_s"))
