"""Compiler: bitwise expression DAG -> AAP/AP command program (Section 4.2).

The naive strategy expands one Figure-20 template per DAG node, staging every
operand into the designated rows with RowClone-FPM copies. The paper notes
("standard compilation techniques... dead-store elimination") that much of
this copy overhead is removable. The optimizing compiler implements:

  * CSE              - the expression DAG is hash-consed at construction.
  * constant folding - in expr.py (`x & 1 -> x`, `maj(a,b,0) -> a & b`, ...).
  * negation fusion  - Not(And) -> nand template, Not(Or) -> nor,
                       Not(Xor) -> xnor, Not(x) at the root via DCC.
  * designated-row state tracking - after a TRA, *all three* activated rows
    hold the result (Section 3.1, issue 3); after AAP(Di,B8), DCC0 holds
    !Di and T0 holds Di, etc. The compiler tracks the symbolic contents of
    T0..T3/DCC0/DCC1 and skips staging AAPs whose target row already holds
    the needed value. Left-deep AND/OR reduction chains drop from 4 AAPs
    per op to ~2 this way (dead stores never emitted).
  * spill minimization - intermediates with a single consumer are consumed
    directly out of the designated rows; only multi-consumer nodes are
    spilled to scratch D-rows.

Outputs a `CompiledProgram` with the macro list, scratch usage, and a
timing/energy cost summary (timing.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from . import commands as cmd
from .commands import AAP, AP, B, C, D, Macro, RowAddr
from .expr import Expr, ZERO, ONE, consumer_counts, topo_order
from .timing import DEFAULT_TIMING, CommandStats, TimingParams, program_stats

# Wordline -> B-group address that activates exactly that wordline.
_WL_ADDR = {"T0": B(0), "T1": B(1), "T2": B(2), "T3": B(3),
            "DCC0": B(4), "DCC0N": B(5), "DCC1": B(6), "DCC1N": B(7)}


@dataclasses.dataclass
class CompiledProgram:
    """An immutable compiled AAP/AP program.

    ``program`` and ``scratch_rows`` are tuples so one CompiledProgram can
    be shared safely by the engine's compile cache across many eval calls
    (the program depends only on the expression shape, the variable-name
    ordering, the optimize flag and the D-group size - never on operand
    data or batch size)."""

    program: Tuple[Macro, ...]
    out_row: RowAddr
    scratch_rows: Tuple[int, ...]
    stats: CommandStats

    @property
    def n_aap(self) -> int:
        return self.stats.aap_count

    @property
    def n_ap(self) -> int:
        return self.stats.ap_count


class _RowState:
    """Symbolic contents of the designated/DCC rows.

    Values are (expr_id, negated) pairs; None = unknown/clobbered.
    """

    def __init__(self):
        self.state: Dict[str, Optional[tuple]] = {
            wl: None for wl in ("T0", "T1", "T2", "T3", "DCC0", "DCC1")}

    def holds(self, wl: str, value: tuple) -> bool:
        return self.state.get(wl) == value

    def set(self, wl: str, value: Optional[tuple]):
        self.state[wl] = value

    def find(self, value: tuple) -> Optional[str]:
        for wl, v in self.state.items():
            if v == value:
                return wl
        return None


class Compiler:
    def __init__(self, var_rows: Dict[str, int], dst_row: int,
                 n_data_rows: int = 1006, optimize: bool = True,
                 timing: TimingParams = DEFAULT_TIMING):
        self.var_rows = dict(var_rows)
        self.dst_row = dst_row
        self.optimize = optimize
        self.timing = timing
        self.prog: List[Macro] = []
        self.rows = _RowState()
        # expr id -> D-row address for spilled/variable values
        self.loc: Dict[int, RowAddr] = {}
        self.scratch: List[int] = []
        self._next_scratch = n_data_rows - 1
        used = set(var_rows.values()) | {dst_row}
        while self._next_scratch in used:
            self._next_scratch -= 1
        self._used = used

    # -- emission helpers ----------------------------------------------------

    def _emit(self, m: Macro):
        self.prog.append(m)

    def _alloc_scratch(self) -> int:
        r = self._next_scratch
        while r in self._used:
            r -= 1
        if r < 0:
            raise RuntimeError("out of scratch rows")
        self._used.add(r)
        self._next_scratch = r - 1
        self.scratch.append(r)
        return r

    def _source_addr(self, value: tuple) -> Optional[RowAddr]:
        """Address whose single ACTIVATE yields `value` in the row buffer."""
        eid, neg = value
        if eid in self.loc and not neg:
            return self.loc[eid]
        wl = self.rows.find(value)
        if wl is not None:
            return _WL_ADDR[wl]
        # A negated value can be read from a DCC capacitor's n-wordline.
        wl = self.rows.find((eid, not neg))
        if wl in ("DCC0", "DCC1"):
            return _WL_ADDR[wl + "N"]
        return None

    def _stage(self, wl: str, value: tuple):
        """Ensure designated row `wl` holds `value`, emitting an AAP if not."""
        if self.optimize and self.rows.holds(wl, value):
            return
        src = self._source_addr(value) if self.optimize else None
        if src is None:
            eid, neg = value
            if neg:
                raise RuntimeError("negated value not materialized")
            src = self.loc[eid]
        dst = _WL_ADDR[wl]
        self._emit(AAP(src, dst))
        self._apply_copy_effects(src, dst)

    def _apply_copy_effects(self, src: RowAddr, dst: RowAddr):
        """Update symbolic row state for AAP(src, dst)."""
        # Value resolved by activating src:
        val = self._value_of_activate(src)
        for wl in cmd.wordlines_for(dst):
            if cmd.is_n_wordline(wl):
                cap = cmd.dcc_capacitor(wl)
                self.rows.set(cap, _negate(val))
            else:
                self.rows.set(wl, val)

    def _value_of_activate(self, addr: RowAddr) -> Optional[tuple]:
        if addr.group == "B":
            wls = cmd.wordlines_for(addr)
            if len(wls) == 1:
                wl = wls[0]
                if cmd.is_n_wordline(wl):
                    return _negate(self.rows.state[cmd.dcc_capacitor(wl)])
                return self.rows.state[wl]
            return None  # TRA handled separately
        if addr.group == "C":
            return (id(ZERO) if addr.index == 0 else id(ONE), False)
        for eid, loc in self.loc.items():
            if loc == addr:
                return (eid, False)
        return None

    def _tra(self, dst: Optional[RowAddr], result: tuple,
             negate_into_dcc: Optional[str] = None):
        """Emit the B12 TRA over T0,T1,T2; result lands in all three rows
        and is optionally copied out to `dst` (AAP) or kept (AP)."""
        if negate_into_dcc is not None:
            self._emit(AAP(B(12), _WL_ADDR[negate_into_dcc + "N"]))
            for wl in ("T0", "T1", "T2"):
                self.rows.set(wl, result)
            self.rows.set(negate_into_dcc, _negate(result))
        elif dst is None:
            self._emit(AP(B(12)))
            for wl in ("T0", "T1", "T2"):
                self.rows.set(wl, result)
        else:
            self._emit(AAP(B(12), dst))
            for wl in ("T0", "T1", "T2"):
                self.rows.set(wl, result)

    # -- op lowering ---------------------------------------------------------

    def compile(self, root: Expr) -> CompiledProgram:
        counts = consumer_counts(root)
        topo = [n for n in topo_order(root) if n.op not in ("var", "lit")]
        for v, r in self.var_rows.items():
            self.loc[id(Expr.var(v))] = D(r)
        self.loc[id(ZERO)] = C(0)
        self.loc[id(ONE)] = C(1)

        if not topo:  # trivial: output is a var/lit -> RowClone copy
            self._emit(AAP(self.loc[id(root)], D(self.dst_row)))
            return self._finish()

        # Negation fusion: a single-consumer and/or/xor feeding a `not` is
        # lowered inside the `not` (nand/nor/xnor templates), never alone.
        self.fused: Dict[int, Expr] = {}  # id(not-node) -> fused child
        if self.optimize:
            for n in topo:
                if n.op == "not":
                    (ch,) = n.args
                    if ch.op in ("and", "or", "xor") and \
                            counts.get(id(ch), 0) == 1:
                        self.fused[id(n)] = ch
        fused_children = {id(ch) for ch in self.fused.values()}
        order = [n for n in topo if id(n) not in fused_children]

        def effective(n: Expr):
            ch = self.fused.get(id(n))
            return ch if ch is not None else n

        # A rows-resident (unspilled) value survives only until the next
        # lowering clobbers the designated rows, so an intermediate may stay
        # unspilled ONLY if (a) its unique consumer is lowered immediately
        # next AND (b) that consumer's staging can reuse it in place
        # (and/or/maj via T-row holds; xor re-loads via an 80 ns B->B AAP
        # which is *slower* than spill+load, so xor consumers force a spill).
        consumer_pos: Dict[int, int] = {}
        for i, n in enumerate(order):
            for a in effective(n).args:
                consumer_pos[id(a)] = i

        for i, n in enumerate(order):
            is_root = n is root
            multi_use = counts.get(id(n), 0) > 1
            consumed_next = consumer_pos.get(id(n)) == i + 1
            next_op = (effective(order[i + 1]).op
                       if i + 1 < len(order) else None)
            keep_in_rows = (self.optimize and not multi_use and consumed_next
                            and next_op in ("and", "or", "maj")
                            and not is_root)
            out_addr = D(self.dst_row) if is_root else (
                None if keep_in_rows else D(self._alloc_scratch()))
            self._lower(n, out_addr)
            if out_addr is not None:
                self.loc[id(n)] = out_addr
        return self._finish()

    def _finish(self) -> CompiledProgram:
        st = program_stats(self.prog, self.timing)
        return CompiledProgram(tuple(self.prog), D(self.dst_row),
                               tuple(self.scratch), st)

    def _val(self, e: Expr) -> tuple:
        return (id(e), False)

    def _lower(self, n: Expr, out: Optional[RowAddr]):
        op = n.op
        res = self._val(n)
        if op == "not":
            (x,) = n.args
            self._lower_not(x, n, out)
            return
        if op in ("and", "or"):
            x, y = n.args
            ctrl = C(0) if op == "and" else C(1)
            self._stage("T0", self._val(x))
            self._stage("T1", self._val(y))
            self._stage_ctrl(ctrl)
            self._tra(out, res)
            return
        if op == "maj":
            x, y, z = n.args
            self._stage("T0", self._val(x))
            self._stage("T1", self._val(y))
            self._stage("T2", self._val(z))
            self._tra(out, res)
            return
        if op == "xor":
            self._lower_xor(n, out, negate=False)
            return
        raise KeyError(op)

    def _stage_ctrl(self, ctrl: RowAddr):
        want = (id(ZERO) if ctrl.index == 0 else id(ONE), False)
        if self.optimize and self.rows.holds("T2", want):
            return
        self._emit(AAP(ctrl, B(2)))
        self.rows.set("T2", want)

    def _lower_not(self, x: Expr, n: Expr, out: Optional[RowAddr]):
        """not x -> fuse with the child op when possible (nand/nor/xnor)."""
        res = self._val(n)
        fused = getattr(self, "fused", {}).get(id(n)) is x
        if fused and x.op in ("and", "or"):
            a, b = x.args
            ctrl = C(0) if x.op == "and" else C(1)
            self._stage("T0", self._val(a))
            self._stage("T1", self._val(b))
            self._stage_ctrl(ctrl)
            # TRA, negating through DCC0 (nand/nor template tail). The DCC0
            # capacitor captures !(a op b) = res; read it back via its
            # d-wordline (B4), exactly as Figure 20b does.
            self._tra(None, self._val(x), negate_into_dcc="DCC0")
            # DCC0 holds the *not-node's* value (same bits as !(x)): record
            # it under the not-node id so later staging can find it.
            self.rows.set("DCC0", res)
            self._copy_out(B(4), res, out)
            return
        if fused and x.op == "xor":
            self._lower_xor(x, out, negate=True, res_override=res)
            return
        # plain NOT via DCC (Fig. 18 / Section 4.2).
        src = self._source_addr(self._val(x))
        if src is None:
            src = self.loc[id(x)]
        self._emit(AAP(src, B(5)))       # DCC0 = !x
        self.rows.set("DCC0", res)       # DCC0 capacitor holds !x == res
        self._copy_out(B(4), res, out)

    def _copy_out(self, src: RowAddr, res: tuple, out: Optional[RowAddr]):
        """Copy a value readable via `src` to `out` (or leave it in rows)."""
        if out is not None:
            self._emit(AAP(src, out))
            self._apply_copy_effects(src, out)

    def _lower_xor(self, n: Expr, out: Optional[RowAddr], negate: bool,
                   res_override: Optional[tuple] = None):
        """Figure 20c (+ xnor variant routing the combine through DCC0N)."""
        x, y = n.args
        res = res_override if res_override is not None else self._val(n)
        # xor is commutative: if y's only residence is the DCC0 capacitor
        # (clobbered by the first copy below), stage it first by swapping.
        if (self.optimize and id(y) not in self.loc
                and self.rows.holds("DCC0", self._val(y))):
            x, y = y, x
        vx, vy = self._val(x), self._val(y)
        # Resolve each source address right before its ACTIVATE: the first
        # copy clobbers T0/DCC0, which may have been y's resident row.
        sx = (self._source_addr(vx) if self.optimize else None) \
            or self.loc[id(x)]
        self._emit(AAP(sx, B(8)))    # DCC0 = !x, T0 = x
        self._apply_copy_effects(sx, B(8))
        sy = (self._source_addr(vy) if self.optimize else None) \
            or self.loc[id(y)]
        self._emit(AAP(sy, B(9)))    # DCC1 = !y, T1 = y
        self._apply_copy_effects(sy, B(9))
        self._emit(AAP(C(0), B(10)))  # T2 = T3 = 0
        self._emit(AP(B(14)))        # T1 = !x & y
        self._emit(AP(B(15)))        # T0 = x & !y
        self._emit(AAP(C(1), B(2)))  # T2 = 1
        # rows now: T0 = x&!y, T1 = !x&y, T2 = 1, T3 = x&!y-ish
        for wl in ("T3", "DCC0", "DCC1"):
            self.rows.set(wl, None)
        if negate:
            self._emit(AAP(B(12), B(5)))   # DCC0 = xnor
            for wl in ("T0", "T1", "T2"):
                self.rows.set(wl, _negate(res))
            self.rows.set("DCC0", res)
            self._copy_out(B(4), res, out)
        else:
            if out is None:
                self._emit(AP(B(12)))
            else:
                self._emit(AAP(B(12), out))
            for wl in ("T0", "T1", "T2"):
                self.rows.set(wl, res)


def _negate(val: Optional[tuple]) -> Optional[tuple]:
    if val is None:
        return None
    return (val[0], not val[1])


def compile_expr(root: Expr, var_rows: Dict[str, int], dst_row: int,
                 n_data_rows: int = 1006, optimize: bool = True,
                 timing: TimingParams = DEFAULT_TIMING) -> CompiledProgram:
    return Compiler(var_rows, dst_row, n_data_rows, optimize,
                    timing).compile(root)
