"""The benchmark of ``repro_torch``: one cell of ``BENCHMARK.json`` a run.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` serves the cell's traffic through the port's serving
stack on the card and prints one JSON line. Everything one configuration,
traffic mix or metric needs sits in a file of its own, found by name:
``configs/<config>.json`` (with its deployment kind in ``deploy/<kind>.py``
and its plain reference in ``reference/<kind>.py``),
``traffic/<mix>.json`` and ``metrics/<metric>.py``.
"""
