"""frontend.self_ms_per_query: ms of the frontend's own host work per query
answered in the traced window, from the program's own spans: the self
time (each span less the spans inside it) of every ``frontend.*`` span
(submit, tick, flush, take_completed, drain), over the window's
``runtime.popcount`` spans, one an answer. Also reads
frontend.self_ms_per_query.open: the closed cells' entry moves qps, the
open cell's p50_ms."""


def read(run):
    return run.ms_per_answer(sum(s["self_s"] for name, s in run.host.items()
                                 if name.startswith("frontend.")))
