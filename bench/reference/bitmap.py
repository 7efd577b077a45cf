"""Plain reference of the bitmap deployment: AND the query's bitmaps and
count the set bits (SWAR in int64)."""

from __future__ import annotations

from typing import Dict, Iterable

import torch

from .. import datagen


def popcount(words: torch.Tensor) -> int:
    """Set bits of int32 words, summed."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return int((((x * 0x01010101) & 0xFFFFFFFF) >> 24).sum())


def operand_bytes(cfg: dict, spec) -> Dict[tuple, int]:
    """The bitmaps a query reads, each with its bytes."""
    nbytes = datagen.words_for(int(cfg["n_users"])) * 4
    return {("bitmap", t[1]): nbytes for t in spec}


class Reference:
    def __init__(self, cfg: dict, seed: int, device, control: bool = False):
        self.words = datagen.bitmap_words(cfg, seed, device)
        self.row = {nm: i for i, nm in enumerate(datagen.bitmap_names(cfg))}
        self.control = control

    def count(self, spec) -> int:
        acc = None
        for t in spec:
            w = self.words[self.row[t[1]]]
            acc = w if acc is None else acc & w
        if self.control:
            return 2 * popcount(acc[::2])
        return popcount(acc)

    def counts(self, specs: Iterable) -> Dict[tuple, int]:
        return {s: self.count(s) for s in specs}
