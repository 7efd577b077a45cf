"""ECC for in-memory bitwise computation (paper Section 5.5).

Conventional SECDED is not homomorphic over bitwise ops: if Ambit computes
C = A and B directly in DRAM, ECC(C) != f(ECC(A), ECC(B)) for any bitwise
f, so the stored check bits go stale. The paper notes the ONLY known
homomorphic scheme is triple modular redundancy (TMR): ECC(A) = AA (store
the word multiple times); every bitwise op applied replica-wise commutes
with encoding, and decode is a bitwise majority vote - which Ambit itself
computes natively with one TRA.

This module implements TMR over BitVectors: encode (x3 storage), any
engine op applied replica-wise, majority-vote decode (via the engine's
MAJ, i.e. a TRA on the device model), and error detection/scrubbing.
"""

from __future__ import annotations

from typing import List, Tuple

from .bitvector import BitVector
from .engine import BulkBitwiseEngine


class TMRCodec:
    """Triple-modular-redundancy codec over the bulk bitwise engine."""

    REPLICAS = 3

    def __init__(self, engine: BulkBitwiseEngine):
        self.engine = engine

    def encode(self, x: BitVector) -> List[BitVector]:
        # Each replica gets its OWN storage: aliasing one buffer three
        # times would let a single underlying flip corrupt all votes,
        # which defeats the entire point of modular redundancy.
        return [BitVector(x.data.clone(), x.n_bits)
                for _ in range(self.REPLICAS)]

    def apply(self, op: str, a: List[BitVector], b: List[BitVector]
              ) -> List[BitVector]:
        """Replica-wise bitwise op: homomorphism means no re-encoding."""
        fn = getattr(self.engine, op)
        return [fn(ra, rb) for ra, rb in zip(a, b)]

    def apply1(self, op: str, a: List[BitVector]) -> List[BitVector]:
        fn = getattr(self.engine, op)
        return [fn(ra) for ra in a]

    def decode(self, replicas: List[BitVector]) -> BitVector:
        """Majority vote = one TRA on the Ambit device model."""
        return self.engine.maj(*replicas)

    def scrub(self, replicas: List[BitVector]
              ) -> Tuple[List[BitVector], int]:
        """Correct single-replica bit flips in place; returns (clean
        replicas, #corrected bits)."""
        voted = self.decode(replicas)
        corrected = 0
        for r in replicas:
            diff = self.engine.xor(r, voted)
            corrected += int(self.engine.popcount(diff))
        return self.encode(voted), corrected

    def storage_overhead(self) -> float:
        return float(self.REPLICAS)  # 3x, as the paper notes (costly)
