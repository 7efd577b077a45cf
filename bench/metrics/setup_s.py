"""setup_s: seconds from the start of ``bench/run.py`` to the window:
imports, building the kernels where they are not built yet, drawing the
data on the card, bit-slicing, and warming every query of the mix."""


def read(run):
    return run.setup_s
