"""Plain reference of the BitWeaving deployment: a joint histogram of the
columns' values, drawn again from the seed, and a box sum over it for
each conjunction of ranges."""

from __future__ import annotations

import math
from typing import Dict, Iterable

import torch

from .. import datagen


def operand_bytes(cfg: dict, spec) -> Dict[tuple, int]:
    """The bit planes a query reads (every plane of each column it
    ranges over), each with its bytes."""
    plane = datagen.words_for(int(cfg["n_rows"])) * 4
    bits = {c["name"]: int(c["bits"]) for c in cfg["columns"]}
    out = {}
    for t in spec:
        for i in range(bits[t[1]]):
            out[("plane", t[1], i)] = plane
    return out


class Reference:
    def __init__(self, cfg: dict, seed: int, device, control: bool = False):
        self.columns = [c["name"] for c in cfg["columns"]]
        self.dims = [1 << int(c["bits"]) for c in cfg["columns"]]
        size = math.prod(self.dims)
        hist = torch.zeros(size, dtype=torch.int64, device=device)
        for _, _, values in datagen.column_chunks(cfg, seed, device):
            idx = None
            for name, dim in zip(self.columns, self.dims):
                v = values[name]
                if int(v.min()) < 0 or int(v.max()) >= dim:
                    raise ValueError(f"{name} drew a value outside its "
                                     f"{dim} codes")
                idx = v if idx is None else idx.mul_(dim).add_(v)
            if control:
                idx = idx[::2]
            hist += torch.bincount(idx, minlength=size)
            del values, idx
        self.hist = hist.view(self.dims)
        self.scale = 2 if control else 1

    def count(self, spec) -> int:
        lo = [0] * len(self.dims)
        hi = [d - 1 for d in self.dims]
        for t in spec:
            k = self.columns.index(t[1])
            lo[k], hi[k] = max(lo[k], int(t[2])), min(hi[k], int(t[3]))
        if any(a > b for a, b in zip(lo, hi)):
            return 0
        box = self.hist[tuple(slice(a, b + 1) for a, b in zip(lo, hi))]
        return self.scale * int(box.sum())

    def counts(self, specs: Iterable) -> Dict[tuple, int]:
        return {s: self.count(s) for s in specs}
