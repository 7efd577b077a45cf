"""device.idle_share (%): the share of the traced window in which no
kernel, copy or memset ran on the card (1 - the union of their intervals
over the window, from torch.profiler). Moves qps."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
