"""Rehearsal sizes for deployment kinds added to the benchmark after
``bench/test_bench_cells.py`` was written.

That file rehearses every cell of ``BENCHMARK.json`` on the CPU, each
deployment cut to the size its kind has in the file's ``TINY`` table. A
change that adds a cell adds files to the benchmark and edits none of
those it has, so a new kind's size is given here, after collection.
"""

# the Star Schema deployment (bench/configs/ssb-sf300-flat.json): rows
# enough that its queries match from one to hundreds of rows, and a
# window drain stacks repeated queries as at full size
TINY_KINDS = {"ssb": {"n_rows": 20_011}}


def pytest_collection_modifyitems(session, config, items):
    for mod in {getattr(item, "module", None) for item in items}:
        if mod is not None and mod.__name__.split(".")[-1] == \
                "test_bench_cells":
            for kind, size in TINY_KINDS.items():
                mod.TINY.setdefault(kind, size)
