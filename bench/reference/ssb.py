"""Plain reference of the Star Schema deployment: the columns' values
drawn again from the seed, and for each distinct query the count of rows
it selects (each range compared value by value, joined by AND, OR and
NOT), a chunk of rows at a time (six columns of codes are too many for
the BitWeaving reference's joint histogram: 2^48 bins)."""

from __future__ import annotations

from typing import Dict, Iterable

import torch

from .. import datagen, traffic
from .bitweaving import operand_bytes

__all__ = ["Reference", "operand_bytes"]


class Reference:
    def __init__(self, cfg: dict, seed: int, device, control: bool = False):
        self.cfg, self.seed, self.device = cfg, seed, device
        self.control = control
        self.bits = {c["name"]: int(c["bits"]) for c in cfg["columns"]}

    def counts(self, specs: Iterable) -> Dict[tuple, int]:
        """``{spec: count}`` in one pass over the data; the control counts
        every second row and doubles the count."""
        specs = list(dict.fromkeys(specs))
        totals = {s: 0 for s in specs}
        for _, _, values in datagen.column_chunks(self.cfg, self.seed,
                                                  self.device):
            for name, v in values.items():
                if int(v.min()) < 0 or int(v.max()) >= 1 << self.bits[name]:
                    raise ValueError(f"{name} drew a value outside its "
                                     f"{self.bits[name]} bits")
            if self.control:
                values = {k: v[::2] for k, v in values.items()}

            def selects(t, values=values):
                v = values[t[1]]
                return (v >= int(t[2])) & (v <= int(t[3]))

            for s in specs:
                totals[s] += int(traffic.fold(s, selects).sum())
            del values, selects
        scale = 2 if self.control else 1
        return {s: scale * c for s, c in totals.items()}
