"""Plain reference of the Star Schema deployment: the columns' values
drawn again from the seed, and for each distinct query the count of rows
whose every column lies in its range, compared value by value a chunk of
rows at a time (six columns of codes are too many for the BitWeaving
reference's joint histogram: 2^48 bins)."""

from __future__ import annotations

from typing import Dict, Iterable

import torch

from .. import datagen
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
            for s in specs:
                match = None
                for _, column, lo, hi in s:
                    v = values[column]
                    term = (v >= int(lo)) & (v <= int(hi))
                    match = term if match is None else match.logical_and_(
                        term)
                totals[s] += int(match.sum())
            del values
        scale = 2 if self.control else 1
        return {s: scale * c for s, c in totals.items()}
