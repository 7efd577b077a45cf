"""Resident bitvectors: data that lives in the simulated DRAM across calls.

The seed engine re-shipped every operand host -> subarray -> host on each
eval - exactly the memory-channel round-trip Ambit exists to avoid. The
store keeps bitvectors *in* the device model between operations:

  * ``put``  - pack a host BitVector into device rows (one allocator slot
    per row-sized chunk) and return a ResidentBitVector handle;
  * ``get``  - read it back (counted as host traffic; skipped entirely when
    the handle is clean, i.e. the host copy is already current);
  * ``free`` - release the rows for reuse.

The device model's rows are ``torch.int64`` tensors on the model's device
(the card unless the caller names another), so the row layout helpers
below pack and unpack on that device: a read-back is a BitVector on the
device the rows live on, and nothing passes through numpy.

Dirty tracking: a handle is *dirty* when the device content has never been
read back (planner results are born dirty); ``get`` on a clean handle
returns the cached host copy without touching the device, so the
bytes-touched ledger only grows for real host<->DRAM transfers.

LRU spill: when the device fills, ``put`` (and the planner's
destination-row allocation) evicts the least-recently-used unpinned
resident bitvectors instead of failing. A *clean* victim's host copy is
already current, so spilling it is free - zero ledger bytes; a *dirty*
victim is read back through the ledger first. Spilled handles stay valid:
``get`` serves the host copy for free and ``ensure_resident`` faults the
rows back in (charged as a fresh upload). ``pin=True`` at put time (or
``rbv.pinned = True``) exempts a handle from eviction, and operands of an
in-flight planner call are protected for the duration of the call.

``LruSpillBase`` is shared by ``PimStore``, ``PimCluster`` and the
accelerator's ``DeviceStore``.

``colocate`` is the PSM/RowClone migration planner: operands of one op
whose corresponding chunks landed in different subarrays are migrated
(RowClone-PSM within a bank, channel copy across banks - both charged to
the device ledger) so the op can run fully in-subarray.
"""

from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from ..core.bitvector import BitVector, _mask_tail
from ..core.engine import _to_u32, _to_u64
from ..core.simulator import AmbitDevice, AmbitError
from ..obs import NULL_TRACER, MetricsRegistry
from .allocator import RowAllocator, Slot, STRIPED


# -- host <-> device-row layout (shared with pim.cluster) ---------------------


def _used32(n_bits: int, words32: int) -> int:
    """Meaningful packed 32-bit words: BitVector pads the trailing dim
    to a lane multiple (bitvector.py), but only ceil(n_bits/32) words
    carry data - the lane padding is zero by construction and is not
    worth device rows."""
    return min(words32, -(-n_bits // 32))


def chunk_rows(bv: BitVector, words: int,
               device: torch.device) -> torch.Tensor:
    """BitVector -> (n_chunks, words) int64 device-row chunks on
    ``device``."""
    data32 = bv.data.to(device)
    flat = data32.reshape(-1, data32.shape[-1])
    used = _used32(bv.n_bits, data32.shape[-1])
    u64 = _to_u64(flat[:, :used])
    pad = (-u64.shape[1]) % words
    if pad:
        u64 = torch.cat([u64, u64.new_zeros((u64.shape[0], pad))], dim=1)
    return u64.reshape(-1, words)


def unchunk_rows(rows: torch.Tensor, n_bits: int, shape: Tuple[int, ...],
                 words32: int, words: int) -> BitVector:
    """(n_chunks, words) int64 device rows -> the host BitVector layout,
    on the rows' device."""
    n_rows = math.prod(shape)
    u64 = rows.reshape(n_rows, -1)
    used = _used32(n_bits, words32)
    u32 = _to_u32(u64)[:, :used]
    if used < words32:              # restore the host lane padding
        u32 = torch.cat([u32, u32.new_zeros((n_rows, words32 - used))],
                        dim=1)
    out = u32.reshape(tuple(shape) + (words32,))
    return BitVector(_mask_tail(out, n_bits), n_bits)


@dataclasses.dataclass(eq=False)
class ResidentBitVector:
    """Handle to a bitvector resident in device rows. Handles compare
    (and hash) by identity.

    ``slots`` is logical-row-major, chunk-minor: logical row r of the host
    (rows, n_bits) layout occupies slots[r*chunks : (r+1)*chunks], each
    holding one device-row-sized chunk of the packed words.

    ``spilled`` handles hold no device rows (they were LRU-evicted) but
    remain fully usable: the host copy is current, ``get`` is free, and
    ``PimStore.ensure_resident`` re-uploads on demand. ``pinned`` handles
    are never chosen as eviction victims."""

    store: "PimStore"
    n_bits: int
    shape: Tuple[int, ...]       # leading (batch) dims of the host layout
    words32: int                 # packed uint32 words per logical row
    chunks: int                  # device rows per logical row
    slots: List[Slot]
    dirty: bool = False
    pinned: bool = False
    spilled: bool = False
    name: Optional[str] = None
    _host: Optional[BitVector] = None
    # TMR protection (pim.faults): a protected primary carries two
    # independently-placed replica handles; the reliability layer
    # executes queries replica-wise and majority-votes divergences.
    protected: bool = False
    replicas: List = dataclasses.field(default_factory=list)
    # Set when a device failure destroyed dirty, unspilled chunks: the
    # data is gone and any use raises FaultError(kind="data_loss").
    lost: bool = False

    @property
    def n_slots(self) -> int:
        return len(self.slots)

    @property
    def device_bytes(self) -> int:
        return self.n_slots * self.store.device.row_bytes

    @property
    def freed(self) -> bool:
        return not self.slots and not self.spilled

    def get(self) -> BitVector:
        return self.store.get(self)

    def free(self) -> None:
        self.store.free(self)

    def __repr__(self):
        nm = f" {self.name!r}" if self.name else ""
        flags = (" pinned" if self.pinned else "") + \
            (" spilled" if self.spilled else "")
        return (f"<ResidentBitVector{nm} n_bits={self.n_bits} "
                f"slots={self.n_slots} dirty={self.dirty}{flags}>")


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
        # Observability (obs): metrics are always on - every
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
        if rbv.spilled:
            raise AmbitError(
                f"device-side use of spilled {rbv!r} "
                "(ensure_resident re-uploads it)")

    # subclass hooks ---------------------------------------------------------

    def _read_back(self, rbv) -> BitVector:
        raise NotImplementedError

    def _release_rows(self, rbv) -> None:
        raise NotImplementedError

    def _owner_of(self, rbv):
        raise NotImplementedError


class PimStore(LruSpillBase):
    """put/get/free lifecycle for resident bitvectors on one device."""

    def __init__(self, device: AmbitDevice,
                 allocator: Optional[RowAllocator] = None,
                 policy: str = STRIPED, scratch_rows: int = 4):
        self.device = device
        if allocator is None:
            # Share the device's allocator: resident rows and raw
            # device.alloc_rows() calls must draw from ONE free list, or
            # the two would hand out the same physical rows.
            if device._allocator is None:
                device._allocator = RowAllocator.for_device(
                    device, scratch_rows=scratch_rows, policy=policy)
            allocator = device._allocator
        else:
            if device._allocator is not None and \
                    device._allocator is not allocator:
                raise AmbitError(
                    "device already has a different RowAllocator "
                    "(two allocators over one device hand out the same "
                    "physical rows)")
            device._allocator = allocator
        self.allocator = allocator
        self.policy = policy
        # Host-traffic ledger: only put/get move data over the channel.
        self.host_writes = 0
        self.host_reads = 0
        self.bytes_to_device = 0
        self.bytes_from_device = 0
        self.migrated_rows = 0
        # Eviction ledger + recency order (LruSpillBase): clean spills cost
        # nothing; dirty spills show up in host_reads/bytes_from_device.
        self._lru_init()
        # When this store is one device of a PimCluster, handles live in
        # the CLUSTER's LRU; the cluster installs a fallback here so a
        # full device can still evict during per-device sub-plans.
        self.spill_fallback = None

    # -- layout --------------------------------------------------------------

    def _chunk(self, bv: BitVector) -> torch.Tensor:
        return chunk_rows(bv, self.device.words, self.device.device)

    def _unchunk(self, rows: torch.Tensor,
                 rbv: ResidentBitVector) -> BitVector:
        return unchunk_rows(rows, rbv.n_bits, rbv.shape, rbv.words32,
                            self.device.words)

    # -- LRU / eviction (machinery in LruSpillBase) --------------------------

    def _owner_of(self, rbv: ResidentBitVector):
        return rbv.store

    def _release_rows(self, rbv: ResidentBitVector) -> None:
        if rbv.slots:
            self.allocator.free(rbv.slots)
        rbv.slots = []

    def adopt(self, rbv: ResidentBitVector) -> ResidentBitVector:
        """Track an externally-built handle (planner results) in the LRU so
        it participates in spill like any put() handle."""
        self._register(rbv)
        return rbv

    def disown(self, rbv: ResidentBitVector) -> ResidentBitVector:
        """Stop tracking a handle without freeing its rows (the cluster
        harvests per-device sub-results into cluster-level handles)."""
        self._unregister(rbv)
        return rbv

    def _evict_one(self, protect: Iterable[ResidentBitVector]) -> bool:
        """Spill the LRU evictable handle (loop in LruSpillBase); when
        every registered handle is pinned or protected, give a
        cluster-installed fallback the chance to evict at its scope."""
        if self._evict_lru(protect):
            return True
        if self.spill_fallback is not None:
            return self.spill_fallback()
        return False

    def alloc_slots(self, n_rows: int, policy: Optional[str] = None,
                    near: Optional[Sequence[Slot]] = None,
                    protect: Iterable[ResidentBitVector] = ()
                    ) -> List[Slot]:
        """Allocate rows, LRU-spilling unpinned resident bitvectors (not in
        ``protect``) when the device is full. Raises AmbitError when the
        request cannot fit even after evicting everything evictable."""
        while self.allocator.shortfall(n_rows):
            if not self._evict_one(protect):
                raise AmbitError(
                    f"device full ({self.allocator.live}/"
                    f"{self.allocator.capacity} rows live) and every "
                    f"resident bitvector is pinned or in use")
        return self.allocator.alloc(n_rows, policy=policy, near=near)

    # -- lifecycle -----------------------------------------------------------

    def put(self, bv: BitVector, policy: Optional[str] = None,
            near: Optional[Sequence[Slot]] = None,
            name: Optional[str] = None,
            pin: bool = False, protect: bool = False) -> ResidentBitVector:
        chunks = self._chunk(bv)
        if len(chunks) == 0:
            raise AmbitError("cannot make a zero-row bitvector resident")
        if near is not None and len(near) == len(chunks):
            # chunk-aligned affinity: chunk k lands in the subarray that
            # holds chunk k of the neighbor, so corresponding rows of
            # co-operating bitvectors share a subarray (the Section 5.2
            # co-location contract) without any later migration.
            slots = []
            try:
                for k in range(len(chunks)):
                    slots.extend(self.alloc_slots(
                        1, policy=policy, near=[near[k]]))
            except AmbitError:
                self.allocator.free(slots)
                raise
        else:
            slots = self.alloc_slots(len(chunks), policy=policy, near=near)
        self.device.write(slots, chunks)
        shape = tuple(bv.data.shape[:-1])
        rbv = ResidentBitVector(
            store=self, n_bits=bv.n_bits, shape=shape,
            words32=int(bv.data.shape[-1]),
            chunks=len(chunks) // max(1, math.prod(shape)),
            slots=slots, dirty=False, name=name, _host=bv)
        self._charge_io("to_device", "upload", rbv.device_bytes)
        self._register(rbv)
        if pin:
            try:
                self.pin(rbv)
            except AmbitError:          # over budget: undo the upload
                self.free(rbv)
                raise
        if protect:
            # TMR encode-on-put: two more independently-placed planes,
            # each a full honest upload (3x storage, 3x channel bytes -
            # the paper's stated price for the only homomorphic code).
            try:
                for k in (1, 2):
                    rbv.replicas.append(self.put(
                        bv, policy=policy, pin=pin,
                        name=f"{name}/plane{k}" if name else None))
            except AmbitError:
                self.free(rbv)
                raise
            rbv.protected = True
        return rbv

    def _read_back(self, rbv: ResidentBitVector) -> BitVector:
        rows = self.device.read(rbv.slots)
        out = self._unchunk(rows.reshape(len(rbv.slots), self.device.words),
                            rbv)
        rbv._host = out
        rbv.dirty = False
        self._charge_io("from_device", self._io_cause or "read_back",
                        rbv.device_bytes)
        return out

    def ensure_resident(self, rbv: ResidentBitVector,
                        protect: Iterable[ResidentBitVector] = ()
                        ) -> ResidentBitVector:
        """Fault a spilled handle back into device rows (charged as a fresh
        host->device upload). Live handles just refresh recency."""
        self._check_handle(rbv)
        if not rbv.spilled:
            self._touch(rbv)
            return rbv
        chunks = self._chunk(rbv._host)
        slots = self.alloc_slots(len(chunks), protect=(rbv, *protect))
        self.device.write(slots, chunks)
        rbv.slots = slots
        rbv.spilled = False
        rbv.dirty = False
        self._charge_io("to_device", "fault_in", rbv.device_bytes)
        self._register(rbv)
        self._invalidate(rbv)   # placement changed: generation bumps
        return rbv

    # -- migration planner ---------------------------------------------------

    def plan_migrations(self, operands: Sequence[ResidentBitVector]
                        ) -> List[Tuple[ResidentBitVector, int, Slot]]:
        """For each chunk index where the operands span subarrays, pick the
        plurality subarray as the target and list (rbv, slot_index,
        target_subarray_slot=(bank, sub, -1)) moves. Pure planning - no
        device mutation (``colocate`` executes the plan)."""
        moves: List[Tuple[ResidentBitVector, int, Slot]] = []
        if not operands:
            return moves
        n = operands[0].n_slots
        for rbv in operands:
            self._check_live(rbv)
            if rbv.n_slots != n:
                raise AmbitError("operands must be chunk-aligned "
                                 "(same n_bits and shape)")
        for i in range(n):
            homes = [(r.slots[i][0], r.slots[i][1]) for r in operands]
            if len(set(homes)) == 1:
                continue
            counts: Dict[Tuple[int, int], int] = {}
            for h in homes:
                counts[h] = counts.get(h, 0) + 1
            best = max(counts.values())
            # plurality target; ties break to the first operand's home
            target = next(h for h in homes if counts[h] == best)
            seen = set()    # an operand listed twice moves once
            for rbv, h in zip(operands, homes):
                if h != target and id(rbv) not in seen:
                    seen.add(id(rbv))
                    moves.append((rbv, i, (target[0], target[1], -1)))
        return moves

    def colocate(self, operands: Sequence[ResidentBitVector]) -> int:
        """Execute the migration plan: move spanning chunks into the target
        subarray via RowClone-PSM / channel copy (device-ledger cost).
        Best-effort: a full target subarray leaves that chunk in place (the
        planner will stage it through scratch at execution time). Returns
        the number of rows migrated."""
        moved = 0
        try:
            for rbv, i, (tb, ts, _) in self.plan_migrations(operands):
                try:
                    (new_slot,) = self.allocator.alloc_in(tb, ts, 1)
                except AmbitError:
                    continue
                try:
                    self.device.migrate_row(rbv.slots[i], new_slot)
                except AmbitError:  # injected fault: don't leak the row
                    self.allocator.free([new_slot])
                    raise
                self.allocator.free([rbv.slots[i]])
                rbv.slots[i] = new_slot
                moved += 1
        finally:
            # bill even when a migration faults mid-plan: the moved rows
            # really moved
            self.migrated_rows += moved
            if moved:
                self.metrics.counter("migrated_rows").inc(moved)
        return moved
