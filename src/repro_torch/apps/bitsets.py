"""Bitvector sets vs ordered-set baseline (paper Section 8.3, Fig. 24).

Set union/intersection/difference over m input sets with domain 1..N:
  * BitSet  - N-bit bitvectors through the BulkBitwiseEngine (the paper's
              "Bitset with SIMD" accelerated by Ambit).
  * SortedSet - numpy sorted-array set ops (the RB-tree stand-in: same
              O(n) merge behaviour without pointer chasing, an optimistic
              baseline).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..core import BitVector, BulkBitwiseEngine


class BitSetOps:
    def __init__(self, domain: int, engine: BulkBitwiseEngine):
        self.domain = domain
        self.engine = engine

    def make(self, elems: np.ndarray) -> BitVector:
        """The set as a bitvector packed on the engine's device."""
        bits = np.zeros(self.domain, bool)
        bits[elems] = True
        return BitVector.from_bits(bits, device=self.engine.device)

    def union(self, sets: List[BitVector]) -> BitVector:
        acc = sets[0]
        for s in sets[1:]:
            acc = self.engine.or_(acc, s)
        return acc

    def intersection(self, sets: List[BitVector]) -> BitVector:
        acc = sets[0]
        for s in sets[1:]:
            acc = self.engine.and_(acc, s)
        return acc

    def difference(self, base: BitVector, sets: List[BitVector]) -> BitVector:
        acc = base
        for s in sets:
            acc = self.engine.masked_clear(acc, s)
        return acc


class SortedSetOps:
    @staticmethod
    def union(sets: List[np.ndarray]) -> np.ndarray:
        acc = sets[0]
        for s in sets[1:]:
            acc = np.union1d(acc, s)
        return acc

    @staticmethod
    def intersection(sets: List[np.ndarray]) -> np.ndarray:
        acc = sets[0]
        for s in sets[1:]:
            acc = np.intersect1d(acc, s)
        return acc

    @staticmethod
    def difference(base: np.ndarray, sets: List[np.ndarray]) -> np.ndarray:
        acc = base
        for s in sets:
            acc = np.setdiff1d(acc, s)
        return acc
