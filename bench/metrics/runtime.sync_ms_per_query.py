"""runtime.sync_ms_per_query: ms the host blocks on the card per query
answered in the traced window: the total time of the program's
``device_store.sync`` spans (every read that waits for the card), over
the window's answers. Also reads runtime.sync_ms_per_query.open: the
closed cells' entry moves qps, the open cell's p50_ms."""


def read(run):
    return run.ms_per_answer(run.host_s("device_store.sync"))
