"""Bitmap index (paper Section 8.1).

Tracks user characteristics/activity as bitvectors (bit u = user u).
The paper's workload: "how many unique users were active every week for
the past w weeks?" = popcount(AND of w weekly bitmaps); "how many male
users were active each week?" = w popcounts of (weekly AND gender).

Two execution paths:

  * host (non-resident) baseline - all bulk ops route through the
    BulkBitwiseEngine, one binop at a time, each op paying the
    host<->device round-trip;
  * resident - pass an ``AmbitRuntime``: bitmaps are packed on the
    runtime's device and uploaded once at ``add`` time, whole queries
    lower as one expression tree, and only the final popcount crosses
    back. Weekly queries drain as fused launches.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import BitVector, BulkBitwiseEngine, Expr
from ..core.engine import OpStats


class BitmapIndex:
    def __init__(self, n_users: int,
                 engine: Optional[BulkBitwiseEngine] = None,
                 runtime=None, pin_bitmaps: bool = False):
        if (engine is None) == (runtime is None):
            raise ValueError("pass exactly one of engine= (host path) or "
                             "runtime= (resident path)")
        self.n_users = n_users
        self.engine = engine
        self.runtime = runtime
        self.pin_bitmaps = pin_bitmaps
        self.bitmaps: Dict[str, BitVector] = {}
        self.resident: Dict[str, object] = {}  # name -> DeviceBitVector

    def add(self, name: str, members: np.ndarray) -> None:
        bits = np.zeros(self.n_users, bool)
        bits[members] = True
        if self.runtime is not None:
            if name in self.resident:
                self.runtime.free(self.resident.pop(name))
            # pack where the runtime keeps its data: put() then shares it
            bv = BitVector.from_bits(bits, device=self.runtime.device)
            self.resident[name] = self.runtime.put(
                bv, name=name, pin=self.pin_bitmaps)
        else:
            self.bitmaps[name] = BitVector.from_bits(
                bits, device=self.engine.device)

    @staticmethod
    def _and_tree(names: List[str]) -> Expr:
        acc = Expr.var(names[0])
        for nm in names[1:]:
            acc = acc & Expr.var(nm)
        return acc

    def query_plan(self, names: List[str]) -> Tuple[Expr, Dict[str, object]]:
        """The popcount(AND over names) query as a submittable plan:
        (expression, resident-operand env) for ``AmbitRuntime.submit`` /
        ``serve.QueryFrontend.submit``."""
        if self.runtime is None:
            raise ValueError("plans need the resident path - pass runtime=")
        return self._and_tree(names), {nm: self.resident[nm] for nm in names}

    def query_and_all(self, names: List[str]) -> Tuple[int, OpStats]:
        """popcount(AND over names) + accumulated engine stats."""
        total = OpStats()
        if self.runtime is not None:
            rt = self.runtime
            out = rt.eval(self._and_tree(names),
                          {nm: self.resident[nm] for nm in names})
            total += rt.last_stats
            count = rt.popcount(out)     # the only host read-back
            total += rt.last_stats
            rt.free(out)
            return count, total
        acc = self.bitmaps[names[0]]
        for nm in names[1:]:
            acc = self.engine.and_(acc, self.bitmaps[nm])
            if self.engine.last_stats:
                total += self.engine.last_stats
        count = int(self.engine.popcount(acc))
        total += self.engine.last_stats      # fresh per-entry-point ledger
        return count, total

    def weekly_active_query(self, weeks: List[str], gender: str
                            ) -> Tuple[int, List[int], OpStats]:
        """The paper's two-part query (Section 8.1).

        Resident path: the AND-over-all-weeks root and the per-week
        (week AND gender) roots are submitted as ONE multi-root batch and
        executed by a single scheduler drain. Only the popcounts read
        data back."""
        total = OpStats()
        if self.runtime is not None:
            rt = self.runtime
            g = self.resident[gender]
            uniq_t = rt.submit(self._and_tree(weeks),
                               {nm: self.resident[nm] for nm in weeks})
            week_ts = [rt.submit(Expr.var("w") & Expr.var("g"),
                                 {"w": self.resident[wk], "g": g})
                       for wk in weeks]
            rt.drain()
            total += rt.last_stats
            unique_all = rt.popcount(uniq_t.result)
            total += rt.last_stats
            rt.free(uniq_t.result)
            per_week = []
            for t in week_ts:
                per_week.append(rt.popcount(t.result))
                total += rt.last_stats
                rt.free(t.result)
            return unique_all, per_week, total
        unique_all, st = self.query_and_all(weeks)
        total += st
        per_week = []
        g = self.bitmaps[gender]
        for wk in weeks:
            inter = self.engine.and_(self.bitmaps[wk], g)
            if self.engine.last_stats:
                total += self.engine.last_stats
            per_week.append(int(self.engine.popcount(inter)))
            total += self.engine.last_stats  # the popcount's own ledger
        return unique_all, per_week, total


def baseline_cpu_ns(n_users: int, n_ops: int,
                    bw_bytes_per_s: float = 34e9) -> float:
    """Model of the DDR3-channel-bound CPU baseline (Section 7): each bulk
    AND streams 2 reads + 1 write of n_users/8 bytes at channel bandwidth."""
    bytes_moved = 3 * (n_users / 8) * n_ops
    return bytes_moved / bw_bytes_per_s * 1e9
