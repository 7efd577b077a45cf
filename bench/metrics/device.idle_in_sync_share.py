"""device.idle_in_sync_share (%): the share of the traced window in which
the card idles while the host is inside the program's
``device_store.sync`` (waiting for the card, which has nothing left to
run), by overlap (``idlesplit``). Closed-loop cells; moves qps."""


def read(run):
    return None if run.idle_split is None else run.idle_split["idle_in_sync"]
