"""BitFunnel-style document filtering (paper Section 8.4.1).

Documents are Bloom-filter bit columns: a document-major bit matrix where
row r is "documents whose Bloom filter has bit r set". A query ANDs the
rows of its terms' hash positions; surviving bits are candidate documents
(supersets: Bloom false positives are verified downstream). Bulk bitwise
AND over thousands of documents per word is exactly Ambit's sweet spot.

With an ``AmbitRuntime``, the filter rows are uploaded once (``freeze``)
and every query lowers as a single AND tree over the resident rows - the
term count no longer multiplies host traffic. The runtime's
``torch``/``cuda`` backends keep the rows on the card (one fused launch
per query); cold rows LRU-spill on a full device and fault back in at
query time, and ``freeze(pin=True)`` exempts the filter from eviction
entirely.

Without a runtime or an engine, queries run on ``BulkBitwiseEngine("torch")``
on ``device``: the card unless the caller names another.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

import numpy as np

from ..core import BitVector, BulkBitwiseEngine, Expr


def _hashes(term: str, k: int, m: int) -> List[int]:
    out = []
    h = 2166136261
    for i in range(k):
        for ch in f"{term}/{i}":
            h = (h ^ ord(ch)) * 16777619 % (1 << 32)
        out.append(h % m)
    return out


class BitFunnelIndex:
    def __init__(self, n_docs: int, filter_bits: int = 512, k: int = 3,
                 engine: BulkBitwiseEngine = None, runtime=None,
                 device=None):
        self.n_docs = n_docs
        self.m = filter_bits
        self.k = k
        self.runtime = runtime
        self.engine = engine or (None if runtime is not None
                                 else BulkBitwiseEngine("torch",
                                                        device=device))
        # rows[r] = bitvector over documents having Bloom bit r
        self._rows = np.zeros((filter_bits, n_docs), bool)
        self._resident: Dict[int, object] = {}  # row -> DeviceBitVector

    def add_document(self, doc_id: int, terms: Iterable[str]) -> None:
        for t in terms:
            for h in _hashes(t, self.k, self.m):
                self._rows[h, doc_id] = True
        if self._resident:          # index mutated: resident copy is stale
            self.thaw()

    # -- resident lifecycle --------------------------------------------------

    def freeze(self, pin: bool = False) -> None:
        """Upload every non-empty filter row to the device (idempotent).
        Queries then run fully resident until the next add_document.
        ``pin=True`` exempts the rows from LRU eviction (use when the
        device is shared and the filter must stay hot)."""
        if self.runtime is None:
            raise ValueError("freeze() needs an AmbitRuntime")
        if self._resident:
            return
        near = None
        for r in np.nonzero(self._rows.any(axis=1))[0]:
            bv = BitVector.from_bits(self._rows[r],
                                     device=self.runtime.device)
            rbv = self.runtime.put(bv, name=f"bloom{r}", near=near, pin=pin)
            self._resident[int(r)] = rbv
            near = rbv.slots if rbv.slots else near

    def thaw(self) -> None:
        """Free the resident copy (after index mutation)."""
        for rbv in self._resident.values():
            self.runtime.free(rbv)
        self._resident.clear()

    # -- queries -------------------------------------------------------------

    def query(self, terms: Sequence[str]) -> np.ndarray:
        """Candidate doc ids containing ALL terms (Bloom superset)."""
        rows = sorted({h for t in terms for h in _hashes(t, self.k, self.m)})
        if self.runtime is not None:
            return self._query_resident(rows)
        dev = self.engine.device
        acc = BitVector.from_bits(self._rows[rows[0]], device=dev)
        for r in rows[1:]:
            acc = self.engine.and_(
                acc, BitVector.from_bits(self._rows[r], device=dev))
        bits = acc.bits().cpu().numpy()[:self.n_docs]
        return np.nonzero(bits)[0]

    def _query_resident(self, rows: List[int]) -> np.ndarray:
        self.freeze()
        # A queried Bloom row no document sets was never uploaded: the AND
        # is all-zeros, no device work needed.
        if any(r not in self._resident for r in rows):
            return np.empty(0, np.int64)
        expr = Expr.var(f"r{rows[0]}")
        for r in rows[1:]:
            expr = expr & Expr.var(f"r{r}")
        env = {f"r{r}": self._resident[r] for r in rows}
        out = self.runtime.eval(expr, env)
        bits = self.runtime.get(out).bits().cpu().numpy()[:self.n_docs]
        self.runtime.free(out)
        return np.nonzero(bits)[0]
