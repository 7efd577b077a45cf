"""BitWeaving-V column scans (paper Section 8.2).

Stores an integer column bit-sliced (plane i = bit i of every value,
packed 32 values/word) and evaluates `select count(*) where c1<=v<=c2`
with bulk bitwise ops + a popcount - the exact query of Fig. 23.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..core import BitVector, BulkBitwiseEngine
from ..core.engine import resolve_device
from ..kernels import bitweaving as kbv
from ..kernels import ops, ref


@dataclasses.dataclass
class BitWeavingColumn:
    planes: torch.Tensor  # (b, words) int32, MSB-first
    n_rows: int
    bits: int

    @staticmethod
    def from_values(values: np.ndarray, bits: int,
                    device=None) -> "BitWeavingColumn":
        """Bit-slice ``values`` on ``device``: the card unless the caller
        names another (raises when the card is asked for and absent)."""
        n = len(values)
        pad = (-n) % 32
        v = np.pad(values.astype(np.uint32), (0, pad)).astype(np.int64)
        planes = ref.bitslice(torch.from_numpy(v).to(resolve_device(device)),
                              bits)
        return BitWeavingColumn(planes, n, bits)

    def scan_between(self, c1: int, c2: int,
                     use_kernel: bool = True) -> torch.Tensor:
        """Packed predicate bitvector for c1 <= v <= c2."""
        fn = ops.bitweaving_scan if use_kernel else ref.bitweaving_scan
        return fn(self.planes, int(c1), int(c2))

    def count_between(self, c1: int, c2: int,
                      use_kernel: bool = True) -> int:
        """Rows with c1 <= v <= c2: the scan masked to ``n_rows`` (in the
        kernel's store) and one row's popcount, read as it is."""
        scan = ops.bitweaving_scan if use_kernel else kbv.bitweaving_scan_plain
        sel = scan(self.planes, int(c1), int(c2), n_bits=self.n_rows)
        count = ops.popcount if use_kernel else ref.popcount
        return int(count(sel[None, :]))

    def oracle_count(self, values: np.ndarray, c1: int, c2: int) -> int:
        return int(((values >= c1) & (values <= c2)).sum())


def word_at_a_time_scan(values: np.ndarray, c1: int, c2: int) -> int:
    """The paper's CPU baseline: per-value comparisons on word-aligned
    integers (numpy vectorized = an optimistic SIMD baseline)."""
    return int(((values >= c1) & (values <= c2)).sum())


def scan_expr(bits: int, c1: int, c2: int, prefix: str = "p"):
    """The BitWeaving-V predicate c1 <= v <= c2 as ONE expression DAG over
    plane variables {prefix}0..{prefix}{b-1} (MSB first) - the exact
    recurrence of kernels/ref.bitweaving_scan, but lowered as a whole
    tree so the PIM planner can schedule it as a single batched AAP
    program. Constant folding (expr.py) prunes the ZERO/ONE seeds; CSE
    shares the plane loads between the two comparisons. ``prefix``
    namespaces the plane variables so predicates over several columns
    compose into one conjunction (the TPC-H suite below)."""
    from ..core.expr import Expr, ONE, ZERO

    def cmp(const: int):
        gt, lt, eq = ZERO, ZERO, ONE
        for i in range(bits):
            cbit = (const >> (bits - 1 - i)) & 1
            p = Expr.var(f"{prefix}{i}")
            if cbit:
                lt = lt | (eq & ~p)
            else:
                gt = gt | (eq & p)
            eq = eq & ~(p ^ (ONE if cbit else ZERO))
        return gt, lt, eq

    gt1, lt1, eq1 = cmp(c1)
    gt2, lt2, eq2 = cmp(c2)
    return (gt1 | eq1) & (lt2 | eq2)


def ensure_resident_planes(col: BitWeavingColumn, runtime,
                           pin_planes: bool = False):
    """Upload the column's bit planes to ``runtime`` and cache them on the
    column (keyed by runtime identity), so repeated scans pay zero upload
    traffic; planes previously resident on a *different* runtime are freed
    first. The ``near=`` chain co-locates corresponding chunks so the
    predicate runs without inter-device transfers on sharded runtimes.
    Returns ``(plane_handles, upload_stats)`` - the stats are zero when
    the planes were already resident."""
    from ..core.engine import OpStats

    up = OpStats()
    resident = getattr(col, "_resident_planes", None)
    if resident is not None and resident[0] is runtime:
        return resident[1], up
    if resident is not None:         # planes on a previous runtime: free
        for rbv in resident[1]:
            resident[0].free(rbv)
    near = None
    planes = []
    for i in range(col.bits):
        rbv = runtime.put(BitVector(col.planes[i], col.n_rows),
                          name=f"p{i}", near=near, pin=pin_planes)
        up += runtime.last_stats
        planes.append(rbv)
        near = rbv.slots if rbv.slots else near
    col._resident_planes = (runtime, planes)
    return planes, up


def scan_plan(col: BitWeavingColumn, c1: int, c2: int, runtime,
              pin_planes: bool = False):
    """The c1 <= v <= c2 scan as a submittable plan: (expression, env of
    resident plane handles) for ``AmbitRuntime.submit`` /
    ``serve.QueryFrontend.submit``. A serving frontend batches many
    tenants' scans into one drain; planes upload on first use and are
    shared by every later plan against the same runtime."""
    planes, _ = ensure_resident_planes(col, runtime, pin_planes=pin_planes)
    return (scan_expr(col.bits, int(c1), int(c2)),
            {f"p{i}": rbv for i, rbv in enumerate(planes)})


def ambit_scan_resident(col: BitWeavingColumn, c1: int, c2: int,
                        runtime, keep_resident: bool = False,
                        pin_planes: bool = False):
    """Run the scan fully resident: planes are uploaded once, the whole
    predicate executes in-DRAM as one planner call, and only the selection
    bitvector is read back for the popcount. Returns (count, OpStats,
    selection) - ``selection`` is the still-resident predicate bitvector
    when ``keep_resident`` (caller frees it), else None.

    Planes stay resident across calls (cached on the column), so repeated
    scans with different constants pay zero upload traffic. On a full
    device cold planes LRU-spill to host (free - they are clean) and the
    next scan faults them back in, charged to that scan's ledger;
    ``pin_planes=True`` exempts them from eviction. The whole predicate
    runs as one fused kernel launch."""
    from ..core.engine import OpStats

    total = OpStats()
    planes, up = ensure_resident_planes(col, runtime,
                                        pin_planes=pin_planes)
    total += up
    env = {f"p{i}": rbv for i, rbv in enumerate(planes)}
    out = runtime.eval(scan_expr(col.bits, int(c1), int(c2)), env)
    total += runtime.last_stats
    sel = runtime.get(out)           # the only per-query read-back
    total += runtime.last_stats
    # get() masked bits beyond n_bits=n_rows, so tail rows can't count
    count = int(sel.popcount())
    if not keep_resident:
        runtime.free(out)
        return count, total, None
    return count, total, out


# -- TPC-H-flavoured multi-predicate suite ------------------------------------
#
# "Understanding Bulk-Bitwise Processing In-Memory Through Database
# Analytics" measures Ambit-class hardware on database scans: thousands
# of tenants issuing overlapping range predicates over a handful of
# columns. This suite reproduces that shape - a lineitem-flavoured table
# of ~8 bit-sliced columns, per-column pools of range predicates sharing
# their lower bound (so the comparator recurrence for the shared prefix
# is the SAME Expr subtree across queries), and a Zipfian tenant mix -
# as the workload the drain-time query optimizer is measured on
# (``kern_pim_optimizer`` in benchmarks/kernels_micro.py).

# (name, bits) - widths keep whole-mix programs small enough for compact
# test geometries while giving every column a distinct selectivity.
TPCH_COLUMNS = (
    ("quantity", 6), ("discount", 4), ("tax", 4), ("shipmode", 3),
    ("priority", 3), ("suppkey", 7), ("extprice", 8), ("status", 2),
)


@dataclasses.dataclass
class TpchTable:
    """A synthetic lineitem-flavoured table: each column bit-sliced for
    BitWeaving-V scans, with the raw values kept for oracle checks."""

    n_rows: int
    values: "dict[str, np.ndarray]"
    columns: "dict[str, BitWeavingColumn]"

    @staticmethod
    def synthesize(n_rows: int = 4096, seed: int = 0,
                   columns=TPCH_COLUMNS, device=None) -> "TpchTable":
        """Values drawn from numpy ``default_rng(seed)`` as the reference
        draws them; the planes are bit-sliced on ``device`` (the card
        unless the caller names another)."""
        device = resolve_device(device)
        rng = np.random.default_rng(seed)
        values, cols = {}, {}
        for name, bits in columns:
            v = rng.integers(0, 1 << bits, n_rows, dtype=np.uint32)
            values[name] = v
            cols[name] = BitWeavingColumn.from_values(v, bits, device)
        return TpchTable(n_rows, values, cols)

    def oracle(self, specs) -> np.ndarray:
        """Row-selection bits for a conjunction of
        ``(column, c1, c2)`` range predicates (numpy ground truth)."""
        sel = np.ones(self.n_rows, bool)
        for col, c1, c2 in specs:
            v = self.values[col]
            sel &= (v >= c1) & (v <= c2)
        return sel


def shared_prefix_ranges(bits: int, n: int, rng) -> list:
    """``n`` range predicates over a ``bits``-wide column sharing their
    lower bound: ``c1`` is fixed, the upper bounds spread above it. The
    shared bound makes the whole lower-comparator subtree of
    ``scan_expr`` identical across the pool - exactly the structure
    cross-ticket CSE materializes once."""
    lo = int(rng.integers(0, 1 << max(bits - 1, 1)))
    his = sorted({int(h) for h in rng.integers(lo, 1 << bits, n)})
    if not his:
        his = [(1 << bits) - 1]
    return [(lo, hi) for hi in his]


def predicate_plan(table: TpchTable, specs, runtime,
                   pin_planes: bool = False):
    """A multi-column conjunction as one submittable
    ``(expression, env)`` plan: each ``(column, c1, c2)`` term is the
    BitWeaving comparator over that column's resident planes (uploaded
    once per runtime, shared by every later plan), ANDed together.
    Column names namespace the plane variables, so plans over different
    column sets compose in one drain."""
    expr, env = None, {}
    for col, c1, c2 in specs:
        column = table.columns[col]
        planes, _ = ensure_resident_planes(column, runtime,
                                           pin_planes=pin_planes)
        term = scan_expr(column.bits, int(c1), int(c2), prefix=f"{col}_b")
        env.update({f"{col}_b{i}": rbv for i, rbv in enumerate(planes)})
        expr = term if expr is None else expr & term
    return expr, env


def zipf_tenant_queries(table: TpchTable, n_tenants: int, n_queries: int,
                        seed: int = 0, s: float = 1.2,
                        ranges_per_column: int = 3,
                        cols_per_query: int = 2) -> list:
    """A Zipfian tenant mix over shared predicate templates: every
    tenant owns one fixed conjunction template (columns + ranges drawn
    from the per-column shared-prefix pools), and queries sample tenants
    with Zipf(s) popularity. Hot tenants repeat their template verbatim
    (the result cache serves them); distinct tenants overlap on the
    pooled column predicates (cross-ticket CSE shares them). Returns
    ``[(tenant_id, specs), ...]`` with ``specs`` as taken by
    ``predicate_plan`` / ``TpchTable.oracle``."""
    rng = np.random.default_rng(seed)
    names = list(table.columns)
    pools = {c: shared_prefix_ranges(table.columns[c].bits,
                                     ranges_per_column, rng)
             for c in names}
    templates = []
    for t in range(n_tenants):
        trng = np.random.default_rng(seed * 7919 + 31 * t + 1)
        picks = trng.choice(len(names), size=min(cols_per_query,
                                                 len(names)),
                            replace=False)
        specs = []
        for ci in sorted(int(c) for c in picks):
            col = names[ci]
            pool = pools[col]
            specs.append((col, *pool[int(trng.integers(len(pool)))]))
        templates.append(tuple(specs))
    ranks = np.arange(1, n_tenants + 1, dtype=np.float64) ** -s
    probs = ranks / ranks.sum()
    return [(int(t), templates[int(t)])
            for t in rng.choice(n_tenants, size=n_queries, p=probs)]


def ambit_scan_stats(col: BitWeavingColumn, c1: int, c2: int,
                     engine: BulkBitwiseEngine) -> Tuple[int, float]:
    """Run the BitWeaving predicate THROUGH the Ambit device model to get
    paper-units timing: each plane op is a row-wide bulk bitwise op.

    The predicate needs ~6 bulk ops per bit-plane (gt/lt/eq updates for
    both constants) + 1 final AND; we model rows of 65,536 bits."""
    # count through the scan and popcount kernels; no n_bits, so the
    # padding rows count as the reference counts them
    sel = ops.bitweaving_scan(col.planes, c1, c2)
    count = int(ops.popcount(sel[None, :]))
    # DRAM-time model: ops per plane from the BitWeaving recurrence
    n_ops = 6 * col.bits + 1
    rows = max(1, (col.n_rows + 65535) // 65536)
    # each bulk op = one Figure-20 'and'-class program (4 AAPs) per row
    ns = n_ops * rows * 4 * 49.0
    return count, ns
