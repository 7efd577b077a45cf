"""qps: counts delivered on the host inside the window, over the window's
seconds (closed loops; in an open loop it would only be the offered
rate)."""


def read(run):
    return run.answered / run.seconds if run.loop == "closed" else None
