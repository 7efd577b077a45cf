"""device.idle_in_program_share (%): the share of the traced window in
which the card idles while the host is inside one of the program's other
spans (the frontend, the scheduler, a launch, a count, a free), by
overlap (``idlesplit``): the host work the card waits for. Closed-loop
cells; moves qps."""


def read(run):
    return None if run.idle_split is None \
        else run.idle_split["idle_in_program"]
