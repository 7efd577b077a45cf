"""Plain reference of the bitmap deployment: evaluate the query word by
word (AND, OR, and NOT within the users) over its bitmaps and count the
set bits (SWAR in int64)."""

from __future__ import annotations

from typing import Dict, Iterable

import torch

from .. import datagen, traffic


def popcount(words: torch.Tensor) -> int:
    """Set bits of int32 words, summed."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return int((((x * 0x01010101) & 0xFFFFFFFF) >> 24).sum())


def operand_bytes(cfg: dict, spec) -> Dict[tuple, int]:
    """The bitmaps a query reads, each once with its bytes."""
    nbytes = datagen.words_for(int(cfg["n_users"])) * 4
    return {("bitmap", t[1]): nbytes for t in traffic.leaves(spec)}


class Reference:
    def __init__(self, cfg: dict, seed: int, device, control: bool = False):
        self.words = datagen.bitmap_words(cfg, seed, device)
        self.row = {nm: i for i, nm in enumerate(datagen.bitmap_names(cfg))}
        self.control = control
        # the words' bits that are users: a NOT sets none past them
        n_users = int(cfg["n_users"])
        self.users = torch.full((datagen.words_for(n_users),), -1,
                                dtype=torch.int32, device=device)
        if n_users % datagen.WORD:
            self.users[-1] = (1 << n_users % datagen.WORD) - 1

    def count(self, spec) -> int:
        acc = traffic.fold(spec, lambda t: self.words[self.row[t[1]]],
                           lambda w: ~w & self.users)
        if self.control:
            return 2 * popcount(acc[::2])
        return popcount(acc)

    def counts(self, specs: Iterable) -> Dict[tuple, int]:
        return {s: self.count(s) for s in specs}
