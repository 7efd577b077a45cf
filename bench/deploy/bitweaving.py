"""The BitWeaving lineitem deployment (Ambit Section 8.2) on the port.

Each column's values are drawn on the card in row chunks (``datagen``)
and bit-sliced there by the port's ``kernels/ref.bitslice`` into one
``(bits, words)`` plane tensor, the ``BitWeavingColumn`` of a
``TpchTable``; a query's plan joins one ``predicate_plan`` a range, which
puts the planes into the runtime on first use (sharing them), by the
spec's AND, OR and NOT (``compose``).
"""

from __future__ import annotations

import torch

from repro_torch.apps.bitweaving_db import (BitWeavingColumn, TpchTable,
                                            predicate_plan)
from repro_torch.kernels import ref

from .. import datagen
from . import compose


class Deployment:
    def __init__(self, cfg: dict, seed: int, runtime):
        device = runtime.tensor_device
        n_rows = int(cfg["n_rows"])
        words = datagen.words_for(n_rows)
        planes = {c["name"]: torch.empty((int(c["bits"]), words),
                                         dtype=torch.int32, device=device)
                  for c in cfg["columns"]}
        for row0, rows, values in datagen.column_chunks(cfg, seed, device):
            w0, pad = row0 // datagen.WORD, (-rows) % datagen.WORD
            w1 = w0 + (rows + pad) // datagen.WORD
            for c in cfg["columns"]:
                v = values[c["name"]]
                if pad:
                    v = torch.nn.functional.pad(v, (0, pad))
                planes[c["name"]][:, w0:w1] = ref.bitslice(v, int(c["bits"]))
            del values
        self.table = TpchTable(n_rows, {}, {
            c["name"]: BitWeavingColumn(planes[c["name"]], n_rows,
                                        int(c["bits"]))
            for c in cfg["columns"]})
        self.runtime = runtime

    def plan(self, spec):
        return compose(spec, self._range)

    def _range(self, element):
        if element[0] != "range":
            raise ValueError(f"a BitWeaving deployment serves ranges, got "
                             f"{element!r}")
        return predicate_plan(self.table, [element[1:]], self.runtime)
