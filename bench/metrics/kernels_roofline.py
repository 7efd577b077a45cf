"""kernels_roofline (%): the least device time the window's queries need,
over the summed device time of every kernel in the traced window,
whatever its name. The least time is the bytes the queries must read at
the data sheet's HBM rate (3.35 TB/s): for each call into the frontend,
the union of the bit planes the queries it completed read, each plane
once, plus 4 B a count (``harness.Meter``). A plane is 4.5x the L2, so
any implementation streams that union from HBM: the share stays under
100% whether a later change fuses, dedupes or removes kernels. Not read
where operands fit the L2 (the bitmap cells). Moves qps."""


def read(run):
    if run.trace is None or run.trace["kernel_s"] <= 0 \
            or run.roofline_bytes <= 0:
        return None
    least_s = run.roofline_bytes / run.hbm_bytes_per_s
    return 100.0 * least_s / run.trace["kernel_s"]
