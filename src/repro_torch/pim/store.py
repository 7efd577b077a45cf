"""LRU bookkeeping and the spill lifecycle of resident bitvectors.

Only ``LruSpillBase`` is ported so far (shared by the reference's
PimStore and PimCluster; here by ``DeviceStore``). ``PimStore`` and its
row layout come with the ``ambit_sim`` PIM runtime (ROADMAP queue 1
item 9).

Dirty tracking: a handle is *dirty* when the device content has never been
read back (planner results are born dirty); ``get`` on a clean handle
returns the cached host copy without touching the device, so the
bytes-touched ledger only grows for real host<->device transfers.

LRU spill: when the device fills, ``put`` (and the planner's result
allocation) evicts the least-recently-used unpinned resident bitvectors
instead of failing. A *clean* victim's host copy is already current, so
spilling it is free - zero ledger bytes; a *dirty* victim is read back
through the ledger first. Spilled handles stay valid: ``get`` serves the
host copy for free and ``ensure_resident`` faults them back in (charged
as a fresh upload). ``pin=True`` at put time (or ``rbv.pinned = True``)
exempts a handle from eviction, and operands of an in-flight call are
protected for the duration of the call.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterable, List, Optional

from ..core.bitvector import BitVector
from ..core.simulator import AmbitError
from ..obs import NULL_TRACER, MetricsRegistry


class LruSpillBase:
    """LRU bookkeeping + spill lifecycle shared by PimStore and PimCluster.

    One recency order, one eviction contract: ``spill`` frees a clean
    victim's rows for zero channel bytes (the host copy is current) and
    reads a dirty victim back through the ledger first; ``get`` serves
    spilled handles from the host copy for free. Subclasses provide the
    actual IO and row bookkeeping via ``_read_back`` / ``_release_rows``
    / ``_owner_of``."""

    _handle_desc = "resident bitvector"
    _obs_name = "store"

    def _lru_init(self) -> None:
        self.evicted_clean = 0
        self.evicted_dirty = 0
        # Observability (src/repro/obs): metrics are always on - every
        # channel transfer is charged through ``_charge_io`` so the
        # registry reconciles bit-exactly with the legacy byte counters;
        # the tracer defaults to the disabled NULL_TRACER (the runtime
        # swaps in live instances).
        self.metrics = MetricsRegistry()
        self.tracer = NULL_TRACER
        # Set by ``spill`` around the dirty read-back so _charge_io can
        # attribute those bytes to cause="spill" instead of "read_back".
        self._io_cause: Optional[str] = None
        self._lru: "OrderedDict[int, object]" = OrderedDict()
        # Hold refcounts: handles queued in an AsyncScheduler but not yet
        # executed must survive until their query runs - they are skipped
        # by eviction and cannot be freed or explicitly spilled.
        self._held: Dict[int, int] = {}
        # Pinning budget: ``pin``/``put(pin=True)`` charge the handle's
        # device bytes against ``pin_budget_bytes`` (None = unlimited), so
        # a shared device can cap how much of it tenants may exempt from
        # eviction. Only handles billed through ``pin`` are refunded at
        # unpin/free - a direct ``rbv.pinned = True`` poke stays the
        # documented unbudgeted escape hatch.
        self.pinned_bytes = 0
        self.pin_budget_bytes: Optional[int] = None
        self._pin_billed: set = set()
        # Dirty-tracking generations: every mutation of a handle's device
        # contents that is NOT an ordinary planner write into a fresh
        # result - ``out=`` rebind, free, spill->fault-in - bumps the
        # handle's generation and notifies the invalidation hooks. The
        # optimizer's result cache keys on (canonical expr, operand
        # generations), so a bumped operand makes stale entries
        # unreachable and the hook drops them eagerly.
        self._gen: Dict[int, int] = {}
        self._invalidation_hooks: List = []

    def generation(self, rbv) -> int:
        """Monotonic dirty-tracking counter for a handle (0 until its
        first invalidating mutation)."""
        return self._gen.get(id(rbv), 0)

    def _invalidate(self, rbv) -> None:
        """Bump a handle's generation and fan out to registered hooks
        (the optimizer's result cache)."""
        self._gen[id(rbv)] = self._gen.get(id(rbv), 0) + 1
        for hook in self._invalidation_hooks:
            hook(rbv)

    def _charge_io(self, direction: str, cause: str, nbytes: int) -> None:
        """THE accounting site for host<->device channel transfers.

        Every byte that crosses the channel is billed here exactly once:
        the legacy per-store counters, the MetricsRegistry series
        (``store_io_bytes``/``store_io_ops`` labeled by direction and
        cause: upload / fault_in / spill / read_back), and - when
        tracing - a store-track instant all update together, which is
        what keeps the registry bit-exactly reconciled with the legacy
        ledgers. ``direction`` is "to_device" or "from_device".
        PimCluster extends this to bill its ChannelLedger too."""
        if direction == "to_device":
            self.host_writes += 1
            self.bytes_to_device += nbytes
        else:
            self.host_reads += 1
            self.bytes_from_device += nbytes
        self.metrics.counter("store_io_bytes").inc(
            nbytes, direction=direction, cause=cause)
        self.metrics.counter("store_io_ops").inc(
            1, direction=direction, cause=cause)
        if self.tracer.enabled:
            self.tracer.instant(
                (self._obs_name, "io"), cause, "store",
                args={"direction": direction, "bytes": int(nbytes)})

    def pin(self, rbv) -> None:
        """Exempt a handle from eviction, charging its bytes against the
        pin budget. Raises AmbitError when the budget would overflow."""
        self._check_handle(rbv)
        if rbv.pinned:
            return
        nbytes = rbv.device_bytes
        if self.pin_budget_bytes is not None and \
                self.pinned_bytes + nbytes > self.pin_budget_bytes:
            raise AmbitError(
                f"pin budget exceeded: {self.pinned_bytes} B already "
                f"pinned + {nbytes} B would pass the "
                f"{self.pin_budget_bytes} B budget")
        rbv.pinned = True
        self.pinned_bytes += nbytes
        self._pin_billed.add(id(rbv))

    def unpin(self, rbv) -> None:
        """Make a pinned handle evictable again and refund its budget."""
        self._check_handle(rbv)
        if not rbv.pinned:
            return
        rbv.pinned = False
        if id(rbv) in self._pin_billed:
            self._pin_billed.discard(id(rbv))
            self.pinned_bytes -= rbv.device_bytes

    def hold(self, rbv) -> None:
        """Protect a handle from eviction/free until ``release``. Refcounted:
        the scheduler holds each operand once per queued query that reads
        it."""
        self._check_handle(rbv)
        self._held[id(rbv)] = self._held.get(id(rbv), 0) + 1

    def release(self, rbv) -> None:
        n = self._held.get(id(rbv), 0) - 1
        if n <= 0:
            self._held.pop(id(rbv), None)
        else:
            self._held[id(rbv)] = n

    def is_held(self, rbv) -> bool:
        return id(rbv) in self._held

    def _register(self, rbv) -> None:
        self._lru[id(rbv)] = rbv
        self._lru.move_to_end(id(rbv))

    def _touch(self, rbv) -> None:
        if id(rbv) in self._lru:
            self._lru.move_to_end(id(rbv))

    def _unregister(self, rbv) -> None:
        self._lru.pop(id(rbv), None)

    def spill(self, rbv, _force_held: bool = False) -> None:
        """Evict a handle's device rows back to host. Clean handles cost
        zero channel bytes; dirty ones are read back through the ledger
        first. Held (queued) handles refuse unless ``_force_held`` - the
        eviction loops set it only when nothing unheld can make room, and
        the spilled operand faults back in when its query executes."""
        self._check_live(rbv)
        if rbv.pinned:
            raise AmbitError(f"cannot spill pinned {rbv!r}")
        if self.is_held(rbv) and not _force_held:
            raise AmbitError(
                f"cannot spill {rbv!r}: a queued query still reads it")
        if rbv.dirty or rbv._host is None:
            self._io_cause = "spill"
            try:
                self._read_back(rbv)
            finally:
                self._io_cause = None
            self.evicted_dirty += 1
        else:
            self.evicted_clean += 1
        self._release_rows(rbv)
        rbv.spilled = True
        self._unregister(rbv)

    def get(self, rbv) -> BitVector:
        self._check_handle(rbv)
        if rbv.spilled:
            return rbv._host            # evicted clean: host copy current
        self._touch(rbv)
        if not rbv.dirty and rbv._host is not None:
            return rbv._host            # host copy is current: no traffic
        return self._read_back(rbv)

    def free(self, rbv) -> None:
        self._check_handle(rbv, allow_lost=True)
        rbv.lost = False                # freeing abandons the lost data
        # Notify BEFORE the held check: the result cache holds the
        # results (and references the operands) it caches, and dropping
        # those entries releases the cache's own hold - so a user can
        # free a handle whose only remaining holder is the cache.
        if self._invalidation_hooks:
            self._invalidate(rbv)
        if self.is_held(rbv):
            raise AmbitError(
                f"cannot free {rbv!r}: a queued query still reads it "
                "(drain the scheduler first)")
        if id(rbv) in self._pin_billed:     # refund the pin budget
            self._pin_billed.discard(id(rbv))
            self.pinned_bytes -= rbv.device_bytes
        rbv.pinned = False
        self._release_rows(rbv)
        self._unregister(rbv)
        rbv.spilled = False
        rbv._host = None
        self._gen.pop(id(rbv), None)    # id may be reused after gc
        # TMR planes live and die with their primary
        replicas, rbv.replicas = list(getattr(rbv, "replicas", ())), []
        for rep in replicas:
            if not rep.freed:
                self.free(rep)

    def rebind(self, out, res) -> object:
        """Move a fresh result's storage into an existing destination
        handle (``out=`` semantics: identity-preserving in-place write -
        no device copy, the destination's old storage is freed)."""
        if (out.n_bits, out.shape) != (res.n_bits, res.shape):
            raise AmbitError(
                f"out= handle shape mismatch: {out!r} vs result {res!r}")
        self._release_rows(out)         # no-op when out is spilled
        self._move_storage(out, res)
        self._unregister(res)
        out.spilled = False
        out.dirty = True
        out._host = None
        self._register(out)
        self._invalidate(out)           # out= is a dirty-tracked write
        return out

    def _move_storage(self, out, res) -> None:
        """Transfer ``res``'s device storage into ``out`` (slot lists by
        default; DeviceStore moves the device buffer instead)."""
        out.slots, res.slots = res.slots, []

    def _evict_lru(self, protect: Iterable, want=None, spill=None) -> bool:
        """Spill the least-recently-used evictable handle. Unheld victims
        are preferred; under capacity pressure a held (queued) operand of
        a not-yet-executed query spills as a last resort - it faults back
        in when its query runs, charged to that query. ``want`` narrows
        the candidate set (e.g. handles owning rows on one full device)
        and ``spill`` overrides how the victim is spilled (e.g. partial,
        per-device). Returns False when nothing evictable matched."""
        protected = {id(p) for p in protect}
        if spill is None:
            spill = lambda rbv, fh: self.spill(rbv, _force_held=fh)  # noqa: E731
        for force_held in (False, True):
            for rbv in list(self._lru.values()):
                if rbv.pinned or id(rbv) in protected or \
                        not self._resident_storage(rbv):
                    continue
                if want is not None and not want(rbv):
                    continue
                if self.is_held(rbv) and not force_held:
                    continue
                spill(rbv, force_held)
                return True
        return False

    def _resident_storage(self, rbv) -> bool:
        """Does the handle hold any device storage right now?"""
        return bool(rbv.slots)

    def _check_handle(self, rbv, allow_lost: bool = False) -> None:
        """Valid for get/free/ensure_resident: live OR spilled."""
        if rbv.freed:
            raise AmbitError(
                f"use of freed {self._handle_desc} {rbv!r}")
        if getattr(rbv, "lost", False) and not allow_lost:
            from .faults import FaultError
            raise FaultError(
                f"data loss: a failed device held the only copy of "
                f"{rbv!r}", kind="data_loss")
        if self._owner_of(rbv) is not self:
            raise AmbitError(
                f"{self._handle_desc} belongs to another store")

    def _check_live(self, rbv) -> None:
        """Valid for device-side ops: must actually hold rows."""
        self._check_handle(rbv)
