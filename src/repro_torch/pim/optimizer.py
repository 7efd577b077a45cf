"""Cost-based multi-query optimizer over ticket DAGs.

``AsyncScheduler.drain`` packs queries as submitted but never *rewrites*
them. Database-shaped traffic (thousands of tenants issuing overlapping
predicates - see "Understanding Bulk-Bitwise Processing In-Memory
Through Database Analytics") repeats the same sub-ANDs across queries,
so naive per-query execution pays for every shared subtree once per
ticket. This pass runs between submit and epoch formation and applies
three rewrites, all provably bit-exact (tests/test_torch_optimizer.py
executes every mix optimized, unoptimized and through the numpy oracle,
and holds each against the reference package):

  1. **Cross-ticket CSE.** Every ticket expression is canonicalized
     (commutative-operand sorting, De Morgan/double-NOT normalization,
     xor polarity extraction, maj self-duality) and each subtree is
     value-numbered by ``(canonical structure, operand handle identity,
     handle generation)``. A subtree worth >= ``min_subtree_ops`` device
     ops that appears under >= 2 tickets of the drain is materialized
     ONCE into a synthetic scratch ticket; the consuming tickets
     reference it as a DAG dependency (the scheduler's existing
     ticket-operand machinery orders, holds and releases it, and the
     scratch result is freed at the end of the drain). Consumers keep
     their ORIGINAL expression shape minus the shared subtree -
     canonicalization is used for *keying only* - so a rewritten
     program never costs more device ops than the submitted one.

  2. **Placement-aware rewriting.** On a cluster, sharing is only
     profitable when the scratch result's chunks live where the
     consumer computes; otherwise every chunk crosses the channel. Per
     consumer the pass compares the modeled move cost
     (``ChannelModel.device_to_device_ns`` over the chunks whose homes
     differ) against the modeled recompute cost (subtree ops x chunks x
     per-op ns) and leaves the consumer recomputing inline - "move the
     compute to the data" - when moving loses.

  3. **Result caching.** Read-only queries (no ``out=``, handle-only
     operands) are keyed by their full canonical value number and their
     results are cached across drains; a repeat query is served without
     executing anything. Entries are invalidated by dirty-tracking
     writes: ``out=`` rebinds, ``free`` and spill->fault-in all bump
     the store's per-handle *generation* (``LruSpillBase.generation``)
     and notify the cache, and intra-drain writes are tracked with a
     virtual-generation overlay so a write queued between two
     structurally equal reads forces the second read to execute.

Everything the pass does is observable: ``opt_cse_hits``,
``opt_cache_hits``/``opt_cache_misses``, ``opt_cse_materialized``,
``opt_rewrite_ns_saved{device}`` and ``opt_placement_skips`` land in
the store's MetricsRegistry (reconciled against ``OptReport`` and the
conservation ledgers by tests/CI), rewrite decisions are traced as
``opt`` events (tools/trace_report.py summarizes them), and
``Ticket.rewritten_from`` records the submitted expression of every
rewritten ticket.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from ..core import expr as E
from ..core.engine import OpStats
from ..core.expr import Expr, ONE, ZERO
from ..core.simulator import AmbitError

# -- expression canonicalization ---------------------------------------------
#
# The canonical form is the CSE/cache *key*, chosen so boolean-equal
# shapes collide: commutative operands sort by a structural key, NOT is
# pushed through AND/OR (De Morgan) so it only ever tops var/xor/maj
# nodes, xor operand polarity is extracted to one outer NOT, and an
# all-negated maj hoists its negation (maj is self-dual). The form is
# idempotent and PYTHONHASHSEED-independent (structural keys only, no
# hash-order iteration anywhere) - tests/test_torch_optimizer.py
# tests both.

_SKEY: Dict[int, tuple] = {}
_NOPS: Dict[int, int] = {}


def struct_key(e: Expr) -> tuple:
    """Deterministic structural sort key (Expr nodes are interned and
    immortal, so a global id-keyed memo is safe)."""
    k = _SKEY.get(id(e))
    if k is None:
        k = (e.op, e.name) + tuple(struct_key(a) for a in e.args)
        _SKEY[id(e)] = k
    return k


def _c_bin(op: str, a: Expr, b: Expr) -> Expr:
    """Canonical commutative binary node: operands sorted, built through
    the overloaded operators so interning + algebraic folds apply. (A
    sort tie means structurally identical operands, which intern to the
    same object and fold away - ordering is always strict.)"""
    if struct_key(b) < struct_key(a):
        a, b = b, a
    if op == "and":
        return a & b
    if op == "or":
        return a | b
    return a ^ b


def _c_not(x: Expr) -> Expr:
    """Canonical negation of an already-canonical node."""
    if x is ZERO:
        return ONE
    if x is ONE:
        return ZERO
    if x.op == "not":
        return x.args[0]
    if x.op == "and":    # De Morgan: push the NOT below AND/OR
        return _c_bin("or", _c_not(x.args[0]), _c_not(x.args[1]))
    if x.op == "or":
        return _c_bin("and", _c_not(x.args[0]), _c_not(x.args[1]))
    return Expr("not", (x,))    # var/xor/maj keep the NOT on top


def _c_maj(xs: List[Expr]) -> Expr:
    a, b, c = sorted(xs, key=struct_key)
    if a is b:
        return a                # maj(x, x, y) = x
    if b is c:
        return b
    if ZERO in (a, b, c):       # maj(0, x, y) = x & y
        o = [x for x in (a, b, c) if x is not ZERO]
        return _c_bin("and", o[0], o[1])
    if ONE in (a, b, c):        # maj(1, x, y) = x | y
        o = [x for x in (a, b, c) if x is not ONE]
        return _c_bin("or", o[0], o[1])
    return Expr("maj", (a, b, c))


def canonicalize(e: Expr, _memo: Optional[Dict[int, Expr]] = None) -> Expr:
    """Semantics-preserving canonical form of ``e`` (see module doc).
    Expressions boolean-equal under {commutativity, De Morgan,
    double-NOT, xor polarity, maj self-duality} map to the SAME
    interned node, so hash-cons identity is the equality test."""
    if _memo is None:
        _memo = {}
    r = _memo.get(id(e))
    if r is not None:
        return r
    if e.op in ("var", "lit"):
        c = e
    elif e.op == "not":
        c = _c_not(canonicalize(e.args[0], _memo))
    elif e.op in ("and", "or"):
        c = _c_bin(e.op, canonicalize(e.args[0], _memo),
                   canonicalize(e.args[1], _memo))
    elif e.op == "xor":
        a = canonicalize(e.args[0], _memo)
        b = canonicalize(e.args[1], _memo)
        par = 0
        if a.op == "not":
            a, par = a.args[0], par ^ 1
        if b.op == "not":
            b, par = b.args[0], par ^ 1
        if a is ONE:            # lits only survive in hand-built nodes
            a, par = ZERO, par ^ 1
        if b is ONE:
            b, par = ZERO, par ^ 1
        base = _c_bin("xor", a, b)
        c = _c_not(base) if par else base
    elif e.op == "maj":
        xs = [canonicalize(x, _memo) for x in e.args]
        if all(x.op == "not" for x in xs):
            c = _c_not(_c_maj([x.args[0] for x in xs]))
        else:
            c = _c_maj(xs)
    else:
        raise AmbitError(f"cannot canonicalize unknown op {e.op!r}")
    _memo[id(e)] = c
    return c


def n_ops(e: Expr) -> int:
    """Device ops (non-leaf nodes) in the DAG under ``e`` - the unit the
    CSE threshold and the recompute cost model are stated in."""
    n = _NOPS.get(id(e))
    if n is None:
        n = sum(1 for m in E.topo_order(e) if m.op not in ("var", "lit"))
        _NOPS[id(e)] = n
    return n


def _value_key(c: Expr, leaf, memo: Dict[int, tuple]) -> tuple:
    """Value number of canonical node ``c``: its structure with every
    var replaced by ``leaf(name)`` - operand handle identity plus
    generation - and commutative children re-sorted at the *value*
    level, so the same computation over the same handles keys equal
    regardless of operand naming."""
    k = memo.get(id(c))
    if k is None:
        if c.op == "var":
            k = ("leaf", leaf(c.name))
        elif c.op == "lit":
            k = ("lit", c.name)
        else:
            ks = [_value_key(a, leaf, memo) for a in c.args]
            if c.op in ("and", "or", "xor", "maj"):
                ks.sort()
            k = (c.op, *ks)
        memo[id(c)] = k
    return k


# -- result cache -------------------------------------------------------------


@dataclasses.dataclass
class _CacheEntry:
    key: tuple
    handles: Tuple[object, ...]     # strong refs: operand ids stay valid
    gens: Tuple[int, ...]
    result: object                  # held in the store while cached


class ResultCache:
    """Canonical-value-number -> result handle, LRU-bounded.

    The cache *holds* each cached result (the LRU spiller treats it
    like a queued operand: spilled only under real pressure, faulted
    back in on use) and keeps strong references to the operand handles
    so their ids cannot be reused while an entry depends on them.
    Invalidation is push-based: the store's ``_invalidate`` fan-out
    (out= rebind, free, spill->fault-in) drops every entry whose
    operands or result the mutated handle backs."""

    def __init__(self, store, capacity: int = 64):
        self.store = store
        self.capacity = max(1, capacity)
        self._entries: "OrderedDict[tuple, _CacheEntry]" = OrderedDict()
        self._by_handle: Dict[int, set] = {}    # id(handle) -> {keys}
        store._invalidation_hooks.append(self._on_invalidate)

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, key: tuple) -> Optional[_CacheEntry]:
        e = self._entries.get(key)
        if e is None:
            return None
        if getattr(e.result, "freed", False):   # defensive: drop stale
            self._drop(key)
            return None
        self._entries.move_to_end(key)
        return e

    def insert(self, key: tuple, handles: Tuple[object, ...],
               gens: Tuple[int, ...], result) -> None:
        if key in self._entries:
            return
        while len(self._entries) >= self.capacity:
            self._drop(next(iter(self._entries)))
        self.store.hold(result)
        entry = _CacheEntry(key=key, handles=tuple(handles),
                            gens=tuple(gens), result=result)
        self._entries[key] = entry
        for h in (*entry.handles, entry.result):
            self._by_handle.setdefault(id(h), set()).add(key)
        self.store.metrics.counter("opt_cache_inserts").inc(1)

    def _drop(self, key: tuple) -> None:
        entry = self._entries.pop(key, None)
        if entry is None:
            return
        for h in (*entry.handles, entry.result):
            keys = self._by_handle.get(id(h))
            if keys is not None:
                keys.discard(key)
                if not keys:
                    del self._by_handle[id(h)]
        self.store.release(entry.result)

    def _on_invalidate(self, rbv) -> None:
        keys = self._by_handle.get(id(rbv))
        if keys:
            self.store.metrics.counter("opt_cache_invalidations").inc(
                len(keys))
            for key in list(keys):
                self._drop(key)

    def flush(self) -> None:
        for key in list(self._entries):
            self._drop(key)


# -- the optimizer pass -------------------------------------------------------


@dataclasses.dataclass
class OptReport:
    """What one optimized drain rewrote (mirrored into the metrics
    registry: the ``opt_*`` counters advance by exactly these
    integers)."""

    cse_hits: int = 0           # occurrence replacements beyond the
    cse_materialized: int = 0   # materializing one per shared subtree
    cache_hits: int = 0
    cache_misses: int = 0
    placement_skips: int = 0    # consumers left recomputing (move cost)
    ns_saved_est: float = 0.0   # cost-model estimate of rewrite savings


_CSE_PREFIX = "__cse"

# Modeled per-op per-chunk cost for the share-vs-recompute decision: a
# bbop is ~4 AAPs at the split-decoder latency (timing.py). Only the
# ratio against ChannelModel link costs matters here; the measured
# ledgers stay the ground truth the tests reconcile.
_OP_NS_EST = 4 * 49.0


@dataclasses.dataclass
class _Group:
    """One shared-subtree equivalence class: its value number, where it
    occurs, who shares it, and the scratch ticket that materializes it
    (created lazily at its first rewritten occurrence)."""

    gid: int
    key: tuple
    occs: List[tuple] = dataclasses.field(default_factory=list)
    ticket_ids: set = dataclasses.field(default_factory=set)
    # (ticket position, id(node)) pairs that reference the scratch
    participants: set = dataclasses.field(default_factory=set)
    gains: Dict[tuple, float] = dataclasses.field(default_factory=dict)
    ticket: object = None           # the synthetic scratch Ticket
    replaced: int = 0               # replace events in the final rewrite

    @property
    def var_name(self) -> str:
        return f"{_CSE_PREFIX}{self.gid}"

    def first_occ(self) -> Optional[tuple]:
        """First (info, node) occurrence still participating - the one
        whose original subtree the scratch ticket computes."""
        for info, node in self.occs:
            if (info.pos, id(node)) in self.participants:
                return (info, node)
        return None

    def n_tickets(self) -> int:
        return len({pos for pos, _ in self.participants})


class _TicketInfo:
    """Per-ticket rewrite state for one optimized drain."""

    __slots__ = ("ticket", "pos", "leaf", "env", "keys", "rw_memo",
                 "used_cse", "scratch_before")

    def __init__(self, ticket, pos, leaf):
        self.ticket = ticket
        self.pos = pos
        self.leaf = leaf
        # The ticket's env as it was at scan time. ``_prune_env`` later
        # rebinds ``ticket.env`` to the vars of the rewritten expression,
        # but a nested group first seen in this ticket may still need a
        # var the rewrite dropped: scratch tickets resolve from this copy.
        self.env: Dict[str, object] = dict(ticket.env)
        self.keys: Dict[int, tuple] = {}    # id(original node) -> vkey
        self.rw_memo: Dict[int, Expr] = {}
        self.used_cse: Dict[int, object] = {}   # gid -> scratch ticket
        self.scratch_before: List[object] = []  # scratch to insert


class QueryOptimizer:
    """The drain-time rewrite pass. One instance per AsyncScheduler
    (created lazily on the first ``drain(optimize=True)``); the result
    cache persists across drains."""

    def __init__(self, scheduler, min_subtree_ops: int = 1,
                 cache_capacity: int = 64):
        self.sched = scheduler
        self.store = scheduler.store
        self.planner = scheduler.planner
        self.min_subtree_ops = min_subtree_ops
        self.cache = ResultCache(self.store, capacity=cache_capacity)
        self.last_report: Optional[OptReport] = None
        self._insert_candidates: List[tuple] = []
        self._groups: Dict[tuple, _Group] = {}
        self._selected: Dict[tuple, _Group] = {}
        self._scratch_sink: Optional[List[object]] = None

    # -- placement cost model ----------------------------------------------

    def _chunk_devices(self, handle) -> Optional[List[int]]:
        """Device index per chunk, or None when unknown (spilled /
        partially spilled, or a store without per-chunk placement)."""
        if getattr(handle, "spilled", False):
            return None
        slots = getattr(handle, "slots", None)
        if not slots:
            return None
        devs = []
        for s in slots:
            if s is None:                   # partially spilled chunk
                return None
            # cluster slots are (device, (bank, sub, row)); single-
            # device slots are (bank, sub, row) -> device 0
            devs.append(s[0] if len(s) == 2 and isinstance(s[1], tuple)
                        else 0)
        return devs

    def _first_handle(self, t, node: Optional[Expr] = None):
        """First operand handle (sorted name order) of ticket ``t``,
        restricted to the vars under ``node`` when given."""
        from .scheduler import Ticket
        names = None
        if node is not None:
            names = {n.name for n in E.topo_order(node) if n.op == "var"}
        for nm in sorted(t.env):
            if names is not None and nm not in names:
                continue
            if not isinstance(t.env[nm], Ticket):
                return t.env[nm]
        return None

    def _share_gain_ns(self, g: _Group, info: "_TicketInfo",
                       node: Expr) -> float:
        """Modeled ns saved if this consumer references the shared
        scratch instead of recomputing ``node`` inline. Positive =
        share; negative = the scratch chunks live on other devices and
        moving them costs more than recomputing ("move the compute to
        the data")."""
        recompute_per_chunk = float(n_ops(node)) * _OP_NS_EST
        channel = getattr(self.store, "channel", None)
        h = self._first_handle(info.ticket, node)
        n_chunks = getattr(h, "n_slots", 1) if h is not None else 1
        if channel is None:
            # single device or accelerator store: sharing never moves
            # data, the saved ops are the whole story
            return recompute_per_chunk * float(n_chunks)
        src_info, src_node = g.occs[0]
        src = self._first_handle(src_info.ticket, src_node)
        src_devs = self._chunk_devices(src) if src is not None else None
        dst = self._first_handle(info.ticket)
        dst_devs = self._chunk_devices(dst) if dst is not None else None
        if src_devs is None or dst_devs is None or \
                len(src_devs) != len(dst_devs):
            # placement unknown (spilled operand faults in wherever the
            # allocator chooses): assume co-located
            return recompute_per_chunk * float(n_chunks)
        row_bytes = getattr(self.store, "row_bytes", 0)
        move = sum(channel.device_to_device_ns(s, d, row_bytes)
                   for s, d in zip(src_devs, dst_devs) if s != d)
        return recompute_per_chunk * float(len(dst_devs)) - move

    # -- the pass ----------------------------------------------------------

    def rewrite(self, tickets: List[object], now_ns: float = 0.0
                ) -> List[object]:
        """Rewrite one drain's ticket list. Returns the execution list:
        cache-served tickets removed (already DONE), synthetic scratch
        tickets inserted before their first consumer. The scheduler
        calls ``commit`` after executing it (cache inserts) and frees
        the scratch results."""
        from .scheduler import Ticket
        rep = OptReport()
        self.last_report = rep
        self._insert_candidates = []
        m = self.store.metrics
        tr = self.store.tracer
        vgen: Dict[int, int] = {}       # intra-queue write overlay
        infos: List[_TicketInfo] = []
        groups: "OrderedDict[tuple, _Group]" = OrderedDict()

        # -- scan: canonical value numbers, cache serving ----------------
        for t in tickets:
            # consumers of a ticket this drain already served from the
            # cache read the cached handle directly
            for nm in sorted(t.env):
                v = t.env[nm]
                if isinstance(v, Ticket) and v.cache_hit:
                    self.store.hold(v.result)
                    t.env[nm] = v.result

            def leaf(name, _t=t):
                v = _t.env[name]
                if isinstance(v, Ticket):
                    return ("t", v.index)
                return ("h", id(v),
                        self.store.generation(v) + vgen.get(id(v), 0))

            info = _TicketInfo(t, len(infos), leaf)
            cmemo: Dict[int, Expr] = {}
            vmemo: Dict[int, tuple] = {}
            root_c = canonicalize(t.expression, cmemo)
            root_key = _value_key(root_c, leaf, vmemo)
            cacheable = t.out is None and not any(
                isinstance(v, Ticket) for v in t.env.values())
            if cacheable:
                hit = self.cache.lookup(root_key)
                if hit is not None:
                    self._serve_hit(t, hit, now_ns)
                    rep.cache_hits += 1
                    m.counter("opt_cache_hits").inc(1)
                    if tr.enabled:
                        tr.instant(("scheduler", "optimizer"),
                                   f"cache_hit#{t.index}", "opt",
                                   args={"ticket": t.index})
                    continue
                rep.cache_misses += 1
                m.counter("opt_cache_misses").inc(1)
                handles = tuple(t.env[nm] for nm in sorted(t.env))
                gens = tuple(self.store.generation(h) +
                             vgen.get(id(h), 0) for h in handles)
                self._insert_candidates.append(
                    (t, root_key, handles, gens))
            # register shareable subtrees (proper subtrees only: a root
            # replacement would leave a bare-var program behind)
            for node in E.topo_order(t.expression):
                if node is t.expression or node.op in ("var", "lit"):
                    continue
                if n_ops(node) < self.min_subtree_ops:
                    continue
                key = _value_key(cmemo[id(node)], leaf, vmemo)
                info.keys[id(node)] = key
                g = groups.get(key)
                if g is None:
                    g = _Group(gid=len(groups), key=key)
                    groups[key] = g
                g.occs.append((info, node))
                g.ticket_ids.add(id(t))
            infos.append(info)
            if t.out is not None:
                vgen[id(t.out)] = vgen.get(id(t.out), 0) + 1

        # -- select: shared across >= 2 tickets, placement-gated ---------
        self._groups = groups
        selected: Dict[tuple, _Group] = {}
        for key, g in groups.items():
            if len(g.ticket_ids) < 2:
                continue
            for info, node in g.occs:
                gain = self._share_gain_ns(g, info, node)
                occ = (info.pos, id(node))
                g.gains[occ] = gain
                if gain > 0.0:
                    g.participants.add(occ)
                else:
                    rep.placement_skips += 1
                    m.counter("opt_placement_skips").inc(
                        1, reason="placement")
            if g.n_tickets() >= 2:
                selected[key] = g
            else:
                g.participants.clear()
        self._selected = selected

        # -- degenerate-fold fixpoint: a rewrite that folds a ticket's
        # whole expression to a bare var/lit (e.g. xor of two
        # value-equal subtrees) would leave the planner no program -
        # withdraw that ticket from every group and re-check viability
        while selected:
            demoted = False
            for info in infos:
                if not self._participates(info):
                    continue
                info.rw_memo = {}
                dry = self._rw(info, info.ticket.expression,
                               is_root=True, dry=True)
                if dry.op in ("var", "lit"):
                    for g in selected.values():
                        g.participants = {
                            occ for occ in g.participants
                            if occ[0] != info.pos}
                    demoted = True
            if not demoted:
                break
            selected = {k: g for k, g in selected.items()
                        if g.n_tickets() >= 2}
            for key, g in self._groups.items():
                if key not in selected:
                    g.participants.clear()
            self._selected = selected

        # -- rewrite + scratch materialization ---------------------------
        exec_list: List[object] = []
        for info in infos:
            t = info.ticket
            info.rw_memo = {}
            self._scratch_sink = info.scratch_before
            new_expr = self._rw(info, t.expression, is_root=True,
                                dry=False)
            if new_expr is not t.expression:
                t.rewritten_from = t.expression
                t.expression = new_expr
                self._prune_env(info, new_expr)
                if tr.enabled:
                    tr.instant(("scheduler", "optimizer"),
                               f"rewrite#{t.index}", "opt",
                               args={"ticket": t.index,
                                     "cse_vars": sorted(info.used_cse)})
            exec_list.extend(info.scratch_before)
            exec_list.append(t)
        self._scratch_sink = None
        # A group's scratch computes its subtree once; every replaced
        # reference beyond that first computation is a CSE hit.
        rep.cse_hits = sum(max(0, g.replaced - 1)
                           for g in selected.values()
                           if g.ticket is not None)
        for g in selected.values():
            first = g.first_occ()
            for occ in sorted(g.participants):
                if first is not None and occ == (first[0].pos,
                                                 id(first[1])):
                    continue        # the materializer pays the compute
                gain = max(g.gains.get(occ, 0.0), 0.0)
                rep.ns_saved_est += gain
                h = self._first_handle(infos[occ[0]].ticket)
                devs = self._chunk_devices(h) if h is not None else None
                m.counter("opt_rewrite_ns_saved").inc(
                    gain, device=f"d{devs[0] if devs else 0}")
        m.counter("opt_cse_hits").inc(rep.cse_hits)
        m.counter("opt_cse_materialized").inc(rep.cse_materialized)
        return exec_list

    def _participates(self, info: "_TicketInfo") -> bool:
        return any(occ[0] == info.pos for g in self._selected.values()
                   for occ in g.participants)

    def _rw(self, info: "_TicketInfo", node: Expr, is_root: bool,
            dry: bool) -> Expr:
        """Top-down rewrite: a participating occurrence of a selected
        group becomes a reference to the group's scratch ticket (never
        at the root); everything else is rebuilt bottom-up, letting the
        constructor folds simplify. ``dry`` builds the same expression
        without materializing scratch tickets (the fixpoint probe)."""
        if node.op in ("var", "lit"):
            return node
        if not is_root:
            hit = info.rw_memo.get(id(node))
            if hit is not None:
                return hit
            key = info.keys.get(id(node))
            g = self._selected.get(key) if key is not None else None
            if g is not None and (info.pos, id(node)) in g.participants:
                if not dry:
                    info.used_cse[g.gid] = self._materialize(g)
                    g.replaced += 1
                out = Expr.var(g.var_name)
                info.rw_memo[id(node)] = out
                return out
        new_args = tuple(self._rw(info, a, False, dry)
                         for a in node.args)
        if all(n is o for n, o in zip(new_args, node.args)):
            out = node
        elif node.op == "not":
            out = ~new_args[0]
        elif node.op == "and":
            out = new_args[0] & new_args[1]
        elif node.op == "or":
            out = new_args[0] | new_args[1]
        elif node.op == "xor":
            out = new_args[0] ^ new_args[1]
        elif node.op == "maj":
            out = E.maj(*new_args)
        else:
            raise AmbitError(f"cannot rewrite unknown op {node.op!r}")
        if not is_root:
            info.rw_memo[id(node)] = out
        return out

    def _materialize(self, g: _Group):
        """Build (once) the synthetic scratch ticket computing group
        ``g``'s subtree, recursively materializing nested shared
        subtrees first (they become its dependencies). The scratch is
        queued immediately before its first consumer, so every epoch-
        formation invariant (deps before consumers) holds by
        construction."""
        if g.ticket is not None:
            return g.ticket
        from .scheduler import Ticket
        info0, node0 = g.first_occ()
        sexpr = self._rw(info0, node0, is_root=True, dry=False)
        senv: Dict[str, object] = {}
        for n in E.topo_order(sexpr):
            if n.op != "var" or n.name in senv:
                continue
            if n.name in info0.env:
                v = info0.env[n.name]
                senv[n.name] = v
                if not isinstance(v, Ticket):
                    self.store.hold(v)
            else:               # a nested __cse var: scratch dependency
                gid = int(n.name[len(_CSE_PREFIX):])
                senv[n.name] = info0.used_cse[gid]
        sched = self.sched
        st = Ticket(scheduler=sched, index=sched._submitted,
                    expression=sexpr, env=senv, synthetic=True,
                    submitted_ns=info0.ticket.submitted_ns)
        sched._submitted += 1
        g.ticket = st
        self._scratch_sink.append(st)
        self.last_report.cse_materialized += 1
        if self.store.tracer.enabled:
            self.store.tracer.instant(
                ("scheduler", "optimizer"), f"materialize#{st.index}",
                "opt", args={"ticket": st.index, "ops": n_ops(node0),
                             "consumers": g.n_tickets()})
        return st

    def _prune_env(self, info: "_TicketInfo", new_expr: Expr) -> None:
        """Rebuild the consumer's env from the vars its rewritten
        expression actually reads: dropped handle operands release
        their submit-time hold, CSE vars bind their scratch tickets."""
        from .scheduler import Ticket
        t = info.ticket
        used = {n.name for n in E.topo_order(new_expr) if n.op == "var"}
        new_env: Dict[str, object] = {}
        for nm in sorted(used):
            if nm in t.env:
                new_env[nm] = t.env[nm]
            else:
                gid = int(nm[len(_CSE_PREFIX):])
                new_env[nm] = info.used_cse[gid]
        for nm in sorted(set(t.env) - used):
            v = t.env[nm]
            if not isinstance(v, Ticket):
                self.store.release(v)
        t.env = new_env

    def _serve_hit(self, t, entry: _CacheEntry, now_ns: float) -> None:
        """Complete a ticket from the cache without executing anything:
        zero stats, released operand holds, the cached handle as its
        result. The ticket never enters epoch formation."""
        from .scheduler import DONE
        for nm in sorted(t.env):
            self.store.release(t.env[nm])
        t.result = entry.result
        t.cache_hit = True
        t.state = DONE
        t.stats = OpStats()
        t.resource_ns = {}
        t.channel_ns = 0.0
        t.epoch = -1
        t.deferred = []
        t.started_ns = now_ns
        t.finished_ns = now_ns

    def commit(self, executed: List[object]) -> None:
        """Post-drain: insert the results of read-only queries whose
        operand generations are still current. A write later in the
        same drain (or a pressure-driven fault-in) bumped a generation
        past the recorded key, making it unreachable for every future
        lookup - skip those instead of caching dead entries."""
        from .scheduler import DONE
        for t, key, handles, gens in self._insert_candidates:
            if t.state != DONE or t.result is None or t.cache_hit:
                continue
            if getattr(t.result, "freed", False):
                continue
            if any(self.store.generation(h) != gen
                   for h, gen in zip(handles, gens)):
                continue
            self.cache.insert(key, handles, gens, t.result)
        self._insert_candidates = []
