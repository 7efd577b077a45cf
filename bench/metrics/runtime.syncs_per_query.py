"""runtime.syncs_per_query: blocking reads of the card per query answered
in the traced window: the count of the program's ``device_store.sync``
spans over the window's ``runtime.popcount`` spans, one an answer (1.00
where each answer waits once, for its own count). Closed-loop cells;
moves qps."""


def read(run):
    return run.syncs / run.host_answers if run.host_answers else None
