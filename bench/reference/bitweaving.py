"""Plain reference of the BitWeaving deployment: a joint histogram of the
columns' values, drawn again from the seed, and for each query the sum of
the bins its ranges, joined by AND, OR and NOT, select."""

from __future__ import annotations

import math
from typing import Dict, Iterable

import torch

from .. import datagen, traffic


def operand_bytes(cfg: dict, spec) -> Dict[tuple, int]:
    """The bit planes a query reads (every plane of each column it
    ranges over), each once with its bytes."""
    plane = datagen.words_for(int(cfg["n_rows"])) * 4
    bits = {c["name"]: int(c["bits"]) for c in cfg["columns"]}
    out = {}
    for t in traffic.leaves(spec):
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
        return self.scale * int((self.hist * traffic.fold(
            spec, self._bins)).sum())

    def _bins(self, element) -> torch.Tensor:
        """The bins a range selects, a bool tensor shaped to broadcast
        over the histogram."""
        k = self.columns.index(element[1])
        codes = torch.arange(self.dims[k], device=self.hist.device)
        shape = [1] * len(self.dims)
        shape[k] = self.dims[k]
        return ((codes >= int(element[2])) & (codes <= int(element[3]))
                ).view(shape)

    def counts(self, specs: Iterable) -> Dict[tuple, int]:
        return {s: self.count(s) for s in specs}
