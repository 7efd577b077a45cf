"""PimCluster: N Ambit devices behind one PimStore-compatible API.

A real deployment is a DIMM/rank hierarchy of many chips, not one
``AmbitDevice`` - and cross-device operand movement reintroduces exactly
the memory-channel traffic the paper eliminates (PAPER.md Section 8;
Buddy-RAM makes the same multi-bank/chip parallelism argument). The
cluster models that step:

  * ``ChannelModel`` - per-hop ns/byte + fixed latency for the three
    classes of movement: host<->device uploads/read-backs, inter-device
    transfers (devices sit on a linear chain; cost scales with hop
    count), and intra-device RowClone (charged by the device model
    itself via ``AmbitDevice.migrate_row``; the model exposes the figure
    for reference). Every transfer is *measured* - bytes come from rows
    actually moved, never from an analytic formula - and lands in the
    cluster's ``ChannelLedger`` and the per-call ``OpStats``.

  * placement policies - ``round_robin`` stripes chunks across devices
    (device-level parallelism: the planner reports max-over-devices
    time), ``packed`` fills one device before spilling to the next, and
    ``affinity`` co-shards operands that are used together: with
    ``near=`` it follows the neighbor's chunk->device layout exactly,
    without it the whole vector lands on the least-loaded device.

  * ``colocate`` - cross-device migration planner: for each chunk whose
    operands span devices it picks the cheapest migration direction from
    the channel model (minimum total link cost over candidate target
    devices) and moves the minority rows, so every op executes fully
    on-device.

  * ``ClusterPlanner`` - lowers ONE expression tree across shards:
    cross-device colocation first (explicit, measured transfer ops),
    then one per-device sub-plan through the existing ``QueryPlanner``
    (subarray batching, scratch staging, per-bank ledgers). Devices run
    independent chunk groups in parallel, so the reported time is the
    max over devices plus the serialized channel time; energy and AAP
    counts are summed.

All N simulated devices keep their row state on one torch device (the
card unless the caller names another): an inter-device copy is a tensor
copy there, and its cost is the channel model's.

LRU spill works at cluster scope exactly as it does on ``PimStore``: a
full device evicts the least-recently-used unpinned cluster handle that
owns rows on it (clean handles spill for free, dirty ones are read back
through the ledger first), and spilled handles fault back in via
``ensure_resident``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from ..core import expr as E
from ..core.engine import OpStats
from ..core.simulator import AmbitDevice, AmbitError
from ..core.geometry import DEFAULT_GEOMETRY, DRAMGeometry
from ..core.timing import DEFAULT_TIMING, CommandStats, TimingParams
from .allocator import STRIPED, Slot
from .faults import DeviceLostError
from .planner import QueryPlanner
from .store import (LruSpillBase, PimStore, ResidentBitVector, chunk_rows,
                    unchunk_rows)
from ..core.bitvector import BitVector

ROUND_ROBIN = "round_robin"
PACKED = "packed"
AFFINITY = "affinity"
CLUSTER_POLICIES = (ROUND_ROBIN, PACKED, AFFINITY)

DeviceSlot = Tuple[int, Slot]  # (device index, (bank, subarray, row))


@dataclasses.dataclass(frozen=True)
class ChannelModel:
    """Per-hop cost model for data movement in the device hierarchy.

    Devices sit on a linear chain (device i <-> device i+1 is one hop), so
    an inter-device transfer costs ``fixed + hops * ns_per_byte * bytes``.
    Host transfers cross the memory channel once regardless of target.
    Intra-device RowClone is charged by ``AmbitDevice.migrate_row`` into
    the device ledger; ``intra_device_ns`` reproduces that figure so the
    three movement classes can be compared in one place."""

    host_ns_per_byte: float = 1.0 / 34.0     # ~34 GB/s host memory channel
    host_fixed_ns: float = 50.0
    link_ns_per_byte: float = 1.0 / 16.0     # ~16 GB/s inter-device hop
    link_fixed_ns: float = 100.0
    nj_per_byte: float = 0.0449              # ~46 nJ/KB channel energy

    def hops(self, src_dev: int, dst_dev: int) -> int:
        return abs(src_dev - dst_dev)

    def device_to_device_ns(self, src_dev: int, dst_dev: int,
                            nbytes: int) -> float:
        h = self.hops(src_dev, dst_dev)
        if h == 0:
            return 0.0
        return self.link_fixed_ns + h * self.link_ns_per_byte * nbytes

    def device_to_device_nj(self, src_dev: int, dst_dev: int,
                            nbytes: int) -> float:
        return self.hops(src_dev, dst_dev) * self.nj_per_byte * nbytes

    def host_transfer_ns(self, nbytes: int) -> float:
        return self.host_fixed_ns + self.host_ns_per_byte * nbytes

    def intra_device_ns(self, row_bytes: int,
                        timing: TimingParams = DEFAULT_TIMING) -> float:
        """RowClone-PSM row copy (mirrors AmbitBank.psm_copy accounting)."""
        from ..core.simulator import AmbitBank
        n_lines = row_bytes // 64
        return (2 * timing.tRAS + n_lines * AmbitBank.PSM_NS_PER_CACHELINE
                + timing.tRP)


DEFAULT_CHANNEL = ChannelModel()


@dataclasses.dataclass
class ChannelLedger:
    """Measured data-movement ledger for one cluster (bytes counted from
    rows actually transferred)."""

    host_writes: int = 0
    host_reads: int = 0
    host_to_device_bytes: int = 0
    device_to_host_bytes: int = 0
    host_ns: float = 0.0
    inter_device_rows: int = 0
    inter_device_bytes: int = 0
    inter_device_ns: float = 0.0
    inter_device_nj: float = 0.0

    def merge(self, other: "ChannelLedger") -> "ChannelLedger":
        for f in dataclasses.fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))
        return self


@dataclasses.dataclass(eq=False)
class ClusterBitVector:
    """Handle to a bitvector sharded across cluster devices.
    Handles compare (and hash) by identity.

    ``slots[i]`` is the ``(device, (bank, subarray, row))`` home of chunk
    ``i``; the chunk order is identical to ``ResidentBitVector.slots``
    (logical-row-major, chunk-minor), so ``near=other.slots`` aligns
    corresponding chunks across co-operating vectors.

    A slot of ``None`` marks a chunk that was *partially spilled* - a
    full device evicted only ITS chunks of this vector; the rest stayed
    hot. Spilled chunks of a dirty handle live in ``_stash`` (their
    device rows were read back through the ledger); clean ones are
    recoverable from the current host copy for free. ``ensure_resident``
    faults only the missing chunks back in."""

    cluster: "PimCluster"
    n_bits: int
    shape: Tuple[int, ...]
    words32: int
    chunks: int                  # device rows per logical row
    slots: List[Optional[DeviceSlot]]
    dirty: bool = False
    pinned: bool = False
    spilled: bool = False
    name: Optional[str] = None
    _host: Optional[BitVector] = None
    # chunk index -> (words,) int64 row for dirty partially-spilled chunks
    _stash: Dict[int, torch.Tensor] = dataclasses.field(default_factory=dict)
    # TMR protection (pim.faults): a protected primary carries two
    # independently-placed replica planes; ``lost`` marks a handle whose
    # only copy of some chunk died with its device - every use short of
    # free/plane-repair raises a data-loss FaultError.
    protected: bool = False
    replicas: List["ClusterBitVector"] = dataclasses.field(
        default_factory=list)
    lost: bool = False

    @property
    def n_slots(self) -> int:
        return len(self.slots)

    @property
    def live_chunks(self) -> List[int]:
        return [i for i, ds in enumerate(self.slots) if ds is not None]

    @property
    def partially_spilled(self) -> bool:
        return any(ds is None for ds in self.slots)

    @property
    def device_bytes(self) -> int:
        return self.n_slots * self.cluster.row_bytes

    @property
    def resident_bytes(self) -> int:
        return len(self.live_chunks) * self.cluster.row_bytes

    @property
    def devices(self) -> List[int]:
        return sorted({ds[0] for ds in self.slots if ds is not None})

    @property
    def freed(self) -> bool:
        return not self.slots and not self.spilled

    def get(self) -> BitVector:
        return self.cluster.get(self)

    def free(self) -> None:
        self.cluster.free(self)

    def __repr__(self):
        nm = f" {self.name!r}" if self.name else ""
        flags = (" pinned" if self.pinned else "") + \
            (" spilled" if self.spilled else "")
        return (f"<ClusterBitVector{nm} n_bits={self.n_bits} "
                f"slots={self.n_slots} devices={self.devices} "
                f"dirty={self.dirty}{flags}>")


class PimCluster(LruSpillBase):
    """N AmbitDevices behind one PimStore-compatible put/get/free API."""

    _handle_desc = "cluster bitvector"
    _obs_name = "cluster"

    def _charge_io(self, direction: str, cause: str, nbytes: int) -> None:
        """Cluster host IO additionally lands in the ChannelLedger with
        its modeled channel time - same single-site contract as the
        base: legacy counters, ledger, and metrics move together."""
        super()._charge_io(direction, cause, nbytes)
        hns = self.channel.host_transfer_ns(nbytes)
        if direction == "to_device":
            self.ledger.host_writes += 1
            self.ledger.host_to_device_bytes += nbytes
        else:
            self.ledger.host_reads += 1
            self.ledger.device_to_host_bytes += nbytes
        self.ledger.host_ns += hns
        self.metrics.counter("host_channel_ns").inc(hns)

    def __init__(self, devices: int = 2,
                 geometry: DRAMGeometry = DEFAULT_GEOMETRY,
                 timing: TimingParams = DEFAULT_TIMING,
                 banks: Optional[int] = None,
                 subarrays: Optional[int] = None,
                 words: Optional[int] = None,
                 placement: str = ROUND_ROBIN,
                 channel: Optional[ChannelModel] = None,
                 policy: str = STRIPED, scratch_rows: int = 4,
                 optimize: bool = True, colocate: bool = True,
                 seed: int = 0, device=None):
        if devices < 1:
            raise ValueError("need at least one device")
        if placement not in CLUSTER_POLICIES:
            raise ValueError(
                f"unknown placement {placement!r} (use {CLUSTER_POLICIES})")
        self.devices = [
            AmbitDevice(geometry, timing, banks=banks, subarrays=subarrays,
                        words=words, seed=seed + 7919 * d, device=device)
            for d in range(devices)]
        # Per-device stores share each device's allocator and give the
        # per-device QueryPlanners their staging/colocation machinery; the
        # cluster itself owns placement, the LRU and the channel ledger.
        self.stores = [PimStore(dev, policy=policy,
                                scratch_rows=scratch_rows)
                       for dev in self.devices]
        self.allocators = [st.allocator for st in self.stores]
        self.planners = [QueryPlanner(st, optimize=optimize,
                                      colocate=colocate)
                         for st in self.stores]
        self.planner = ClusterPlanner(self)
        self.placement = placement
        self.channel = channel or DEFAULT_CHANNEL
        self.ledger = ChannelLedger()
        self.device = self.devices[0].device     # where every row lives
        self.words = self.devices[0].words
        self.row_bytes = self.devices[0].row_bytes
        # PimStore-compatible host-traffic counters.
        self.host_writes = 0
        self.host_reads = 0
        self.bytes_to_device = 0
        self.bytes_from_device = 0
        self._lru_init()
        # Devices taken offline by the reliability layer: excluded from
        # placement, guarded in _alloc_on, populated by evacuate_device.
        self.dead_devices: set = set()
        # Operands of an in-flight ClusterPlanner call: protected from
        # eviction for its duration (set by ClusterPlanner.execute).
        self._in_flight: Tuple[ClusterBitVector, ...] = ()
        # A full device during a per-device sub-plan must be able to
        # evict CLUSTER handles (they are registered here, not in the
        # per-device store LRUs): install the cluster-scope fallback.
        for d, st in enumerate(self.stores):
            st.spill_fallback = \
                (lambda d=d: self._evict_one(d, self._in_flight))

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    @property
    def migrated_rows(self) -> int:
        """Intra-device subarray migrations (per-device store colocation)."""
        return sum(st.migrated_rows for st in self.stores)

    def total_stats(self) -> CommandStats:
        agg = CommandStats()
        for dev in self.devices:
            agg.merge(dev.total_stats())
        return agg

    # -- placement -----------------------------------------------------------

    def _place(self, n_chunks: int, placement: Optional[str],
               near: Optional[Sequence[DeviceSlot]],
               rotate: int = 0) -> List[int]:
        """chunk index -> device index, deterministically.

        Only devices still alive participate; ``rotate`` offsets the
        alive-device ordering so TMR replica planes shard onto staggered
        devices (chunk i of plane k lands k devices over - a single
        device loss then never takes out the same chunk of two planes).
        With no dead devices and ``rotate=0`` this reproduces the
        original placement exactly."""
        placement = self.placement if placement is None else placement
        if placement not in CLUSTER_POLICIES:
            raise ValueError(f"unknown placement {placement!r}")
        alive = [d for d in range(self.n_devices)
                 if d not in self.dead_devices]
        if not alive:
            raise DeviceLostError("every cluster device is offline")
        r = rotate % len(alive)
        alive = alive[r:] + alive[:r]
        if near is not None and len(near) == n_chunks and \
                all(ds is not None and ds[0] not in self.dead_devices
                    for ds in near):
            # chunk-aligned affinity: chunk k shares its neighbor's device
            return [d for d, _ in near]
        if placement == ROUND_ROBIN:
            return [alive[i % len(alive)] for i in range(n_chunks)]
        if placement == PACKED:
            free = {d: self.allocators[d].free_slots for d in alive}
            out = []
            for _ in range(n_chunks):
                d = next((i for i in alive if free[i] > 0), alive[0])
                free[d] -= 1
                out.append(d)
            return out
        # AFFINITY without a neighbor: whole vector on the least-loaded
        # device, so vectors put near= each other later share it.
        d = min(alive,
                key=lambda i: (self.allocators[i].utilization,
                               alive.index(i)))
        return [d] * n_chunks

    # -- LRU / eviction (machinery in LruSpillBase) ---------------------------
    # A full device evicts PARTIALLY: only the victim's chunks resident on
    # that device spill (the rest of the vector stays hot on its other
    # devices). Explicit ``spill`` still evicts the whole vector.

    def _owner_of(self, cbv: ClusterBitVector):
        return cbv.cluster

    def _check_fully_live(self, cbv) -> None:
        """Planner-side ops need every chunk on a device; ``spill`` and
        ``get`` remain legal on partially spilled handles."""
        self._check_live(cbv)
        if cbv.partially_spilled:
            raise AmbitError(
                f"device-side use of partially spilled {cbv!r} "
                "(ensure_resident faults the missing chunks back in)")

    def _release_rows(self, cbv: ClusterBitVector) -> None:
        by_dev: Dict[int, List[Slot]] = {}
        for ds in cbv.slots:
            if ds is not None:
                by_dev.setdefault(ds[0], []).append(ds[1])
        for d in sorted(by_dev):
            self.allocators[d].free(by_dev[d])
        cbv.slots = []
        cbv._stash.clear()

    def _evict_one(self, d: int,
                   protect: Iterable[ClusterBitVector]) -> bool:
        """Partial spill of the LRU unpinned handle owning rows on full
        device ``d``: only its device-``d`` chunks evict. Unheld victims
        first; a held (queued) operand spills only under capacity
        pressure and faults back in when its query executes."""
        return self._evict_lru(
            protect,
            want=lambda cbv: any(ds is not None and ds[0] == d
                                 for ds in cbv.slots),
            spill=lambda cbv, fh: self.spill_device(cbv, d,
                                                    _force_held=fh))

    def spill_device(self, cbv: ClusterBitVector, d: int,
                     _force_held: bool = False) -> None:
        """Evict only the chunks of ``cbv`` resident on device ``d``.
        Clean chunks cost zero ledger bytes (the host copy is current);
        dirty ones are read back - just those rows - through the ledger
        into the chunk stash. When every live chunk is on ``d`` this
        degenerates to a whole-vector ``spill``."""
        self._check_handle(cbv)
        if cbv.spilled:
            return                      # nothing resident anywhere
        if cbv.pinned:
            raise AmbitError(f"cannot spill pinned {cbv!r}")
        if self.is_held(cbv) and not _force_held:
            raise AmbitError(
                f"cannot spill {cbv!r}: a queued query still reads it")
        live = cbv.live_chunks
        idxs = [i for i in live if cbv.slots[i][0] == d]
        if not idxs:
            return                      # no rows on this device
        if len(idxs) == len(live):      # whole remainder lives on d
            self.spill(cbv, _force_held=_force_held)
            return
        if cbv.dirty or cbv._host is None:
            rows = self.devices[d].read([cbv.slots[i][1] for i in idxs])
            rows = rows.reshape(len(idxs), self.words)
            for k, i in enumerate(idxs):
                cbv._stash[i] = rows[k].clone()
            nbytes = len(idxs) * self.row_bytes
            self._charge_io("from_device", "spill", nbytes)
            self.evicted_dirty += 1
        else:
            self.evicted_clean += 1     # host copy current: free
        self.allocators[d].free([cbv.slots[i][1] for i in idxs])
        for i in idxs:
            cbv.slots[i] = None
        # still owns rows elsewhere: stays registered in the LRU

    def evacuate_device(self, d: int) -> None:
        """Take device ``d`` out of service after a whole-device failure.

        Every registered handle loses its device-``d`` chunks (their
        rows are gone - nothing is read back). Chunks with a current
        host/stash copy stay recoverable: ``ensure_resident`` faults
        them back in on the survivors for the usual ledger price. A
        dirty chunk whose only copy died marks the handle ``lost`` -
        only a TMR sibling repair (``_repair_plane``) or ``free`` may
        touch it again. Idempotent."""
        if d in self.dead_devices:
            return
        self.dead_devices.add(d)
        evacuated = 0
        for cbv in list(self._lru.values()):
            idxs = [i for i, ds in enumerate(cbv.slots)
                    if ds is not None and ds[0] == d]
            if not idxs:
                continue
            self.allocators[d].free([cbv.slots[i][1] for i in idxs])
            for i in idxs:
                cbv.slots[i] = None
            if (cbv.dirty or cbv._host is None) and \
                    any(i not in cbv._stash for i in idxs):
                cbv.lost = True
            evacuated += len(idxs)
            self._invalidate(cbv)   # placement changed: generation bumps
        if evacuated:
            self.metrics.counter("fault_evacuated_chunks").inc(evacuated)
        if self.tracer.enabled:
            self.tracer.instant(("faults", f"device{d}"), "evacuate",
                                "fault", args={"chunks": evacuated})

    def _alloc_on(self, d: int, n_rows: int,
                  near: Optional[Sequence[Slot]] = None,
                  protect: Iterable[ClusterBitVector] = ()) -> List[Slot]:
        if d in self.dead_devices:
            raise DeviceLostError(f"device {d} is offline", device=d)
        alloc = self.allocators[d]
        while alloc.shortfall(n_rows):
            if not self._evict_one(d, protect):
                raise AmbitError(
                    f"cluster device {d} full ({alloc.live}/"
                    f"{alloc.capacity} rows live) and every resident "
                    f"bitvector on it is pinned or in use")
        return alloc.alloc(n_rows, near=near)

    # -- lifecycle -----------------------------------------------------------

    def put(self, bv: BitVector, placement: Optional[str] = None,
            near: Optional[Sequence[DeviceSlot]] = None,
            name: Optional[str] = None,
            pin: bool = False, protect: bool = False,
            _rotate: int = 0) -> ClusterBitVector:
        chunks = chunk_rows(bv, self.words, self.device)
        if len(chunks) == 0:
            raise AmbitError("cannot make a zero-row bitvector resident")
        devmap = self._place(len(chunks), placement, near, rotate=_rotate)
        aligned = near is not None and len(near) == len(chunks)
        slots: List[Optional[DeviceSlot]] = [None] * len(chunks)
        try:
            for d in sorted(set(devmap)):
                idxs = [i for i, dd in enumerate(devmap) if dd == d]
                if aligned:
                    # chunk-aligned: each chunk lands in the subarray that
                    # holds the neighbor's corresponding chunk.
                    for i in idxs:
                        (s,) = self._alloc_on(d, 1, near=[near[i][1]])
                        slots[i] = (d, s)
                else:
                    got = self._alloc_on(d, len(idxs))
                    for i, s in zip(idxs, got):
                        slots[i] = (d, s)
                self.devices[d].write([slots[i][1] for i in idxs],
                                      chunks[idxs])
        except AmbitError:
            for ds in slots:
                if ds is not None:
                    self.allocators[ds[0]].free([ds[1]])
            raise
        shape = tuple(bv.data.shape[:-1])
        cbv = ClusterBitVector(
            cluster=self, n_bits=bv.n_bits, shape=shape,
            words32=int(bv.data.shape[-1]),
            chunks=len(chunks) // max(1, math.prod(shape)),
            slots=slots, dirty=False, name=name, _host=bv)
        self._charge_io("to_device", "upload", cbv.device_bytes)
        self._register(cbv)
        if pin:
            try:
                self.pin(cbv)
            except AmbitError:          # over budget: undo the upload
                self.free(cbv)
                raise
        if protect:
            # TMR encode-on-put: two more honestly-uploaded planes, each
            # sharded with a rotated chunk->device map so one device loss
            # never claims the same chunk of two planes (that chunk stays
            # repairable from a surviving sibling via _repair_plane).
            try:
                for k in (1, 2):
                    cbv.replicas.append(self.put(
                        bv, placement=placement, pin=pin,
                        name=f"{name}/plane{k}" if name else None,
                        _rotate=k))
            except AmbitError:
                self.free(cbv)
                raise
            cbv.protected = True
        return cbv

    def _read_back(self, cbv: ClusterBitVector) -> BitVector:
        rows = torch.empty((cbv.n_slots, self.words), dtype=torch.int64,
                           device=self.device)
        by_dev: Dict[int, List[int]] = {}
        for i, ds in enumerate(cbv.slots):
            if ds is None:              # partially spilled chunk: stashed
                rows[i] = cbv._stash[i]
                continue
            by_dev.setdefault(ds[0], []).append(i)
        for d in sorted(by_dev):
            idxs = by_dev[d]
            rows[idxs] = self.devices[d].read(
                [cbv.slots[i][1] for i in idxs])
        out = unchunk_rows(rows, cbv.n_bits, cbv.shape, cbv.words32,
                           self.words)
        cbv._host = out
        cbv.dirty = False
        cbv._stash.clear()              # host copy now covers every chunk
        # only rows that actually crossed the channel are charged
        self._charge_io("from_device", self._io_cause or "read_back",
                        cbv.resident_bytes)
        return out

    def ensure_resident(self, cbv: ClusterBitVector,
                        protect: Iterable[ClusterBitVector] = ()
                        ) -> ClusterBitVector:
        """Fault a spilled handle back in (fresh upload, default
        placement). Partially spilled handles re-upload ONLY the missing
        chunks - the rest never left. Live handles refresh recency."""
        self._check_handle(cbv)
        if not cbv.spilled:
            if cbv.partially_spilled:
                return self._fault_in_partial(cbv, protect)
            self._touch(cbv)
            return cbv
        chunks = chunk_rows(cbv._host, self.words, self.device)
        devmap = self._place(len(chunks), None, None)
        slots: List[Optional[DeviceSlot]] = [None] * len(chunks)
        try:
            for d in sorted(set(devmap)):
                idxs = [i for i, dd in enumerate(devmap) if dd == d]
                got = self._alloc_on(d, len(idxs),
                                     protect=(cbv, *protect))
                for i, s in zip(idxs, got):
                    slots[i] = (d, s)
                self.devices[d].write([slots[i][1] for i in idxs],
                                      chunks[idxs])
        except AmbitError:
            for ds in slots:
                if ds is not None:
                    self.allocators[ds[0]].free([ds[1]])
            raise
        cbv.slots = slots
        cbv.spilled = False
        cbv.dirty = False
        self._charge_io("to_device", "fault_in", cbv.device_bytes)
        self._register(cbv)
        self._invalidate(cbv)   # placement changed: generation bumps
        return cbv

    def _fault_in_partial(self, cbv: ClusterBitVector,
                          protect: Iterable[ClusterBitVector]
                          ) -> ClusterBitVector:
        """Re-upload only the missing (None-slot) chunks: dirty chunks
        come from the stash (their only current copy), clean ones from
        the host copy. Placement follows the vector's default chunk->
        device mapping; only the uploaded bytes are charged."""
        missing = [i for i, ds in enumerate(cbv.slots) if ds is None]
        host_chunks = None
        rows = torch.empty((len(missing), self.words), dtype=torch.int64,
                           device=self.device)
        for k, i in enumerate(missing):
            if i in cbv._stash:
                rows[k] = cbv._stash[i]
            else:
                if host_chunks is None:
                    host_chunks = chunk_rows(cbv._host, self.words,
                                             self.device)
                rows[k] = host_chunks[i]
        devmap = self._place(cbv.n_slots, None, None)
        try:
            for d in sorted({devmap[i] for i in missing}):
                ks = [k for k, i in enumerate(missing) if devmap[i] == d]
                got = self._alloc_on(d, len(ks), protect=(cbv, *protect))
                self.devices[d].write(got, rows[ks])
                for k, s in zip(ks, got):
                    cbv.slots[missing[k]] = (d, s)
        except AmbitError:
            for i in missing:           # roll back to a consistent state
                if cbv.slots[i] is not None:
                    self.allocators[cbv.slots[i][0]].free([cbv.slots[i][1]])
                    cbv.slots[i] = None
            raise
        for i in missing:
            cbv._stash.pop(i, None)     # device copy is current again
        self._charge_io("to_device", "fault_in",
                        len(missing) * self.row_bytes)
        self._touch(cbv)
        self._invalidate(cbv)   # placement changed: generation bumps
        return cbv

    # -- cross-device migration ----------------------------------------------

    def colocate(self, operands: Sequence[ClusterBitVector]) -> int:
        """Unify each chunk's operands onto one device, picking the
        cheapest migration direction from the channel model (minimum
        total link cost over the candidate target devices; ties break to
        the lowest device index). Transfers are executed immediately and
        measured into the ChannelLedger. Returns rows moved."""
        if not operands:
            return 0
        n = operands[0].n_slots
        for cbv in operands:
            self._check_fully_live(cbv)
            if cbv.n_slots != n:
                raise AmbitError("operands must be chunk-aligned "
                                 "(same n_bits and shape)")
        moved = 0
        rb = self.row_bytes
        for i in range(n):
            homes = [cbv.slots[i][0] for cbv in operands]
            if len(set(homes)) == 1:
                continue
            def cost(t):
                return sum(self.channel.device_to_device_ns(h, t, rb)
                           for h in homes if h != t)
            targets = sorted(set(homes), key=lambda t: (cost(t), t))
            last_err = None
            for target in targets:
                try:
                    moved += self._migrate_chunk(operands, i, homes, target)
                    break
                except AmbitError as e:     # target full: next-cheapest
                    last_err = e
            else:
                raise AmbitError(
                    f"cannot colocate chunk {i}: every candidate device "
                    f"is full ({last_err})")
        return moved

    def _migrate_chunk(self, operands: Sequence[ClusterBitVector], i: int,
                       homes: List[int], target: int) -> int:
        """Move chunk ``i`` of every operand not on ``target`` there."""
        anchor = next((cbv.slots[i][1] for cbv, h in zip(operands, homes)
                       if h == target), None)
        moved = 0
        for cbv, h in zip(operands, homes):
            if h == target or cbv.slots[i][0] == target:
                continue        # second clause: duplicate handle in env
            src_d, src_slot = cbv.slots[i]
            (new_slot,) = self._alloc_on(
                target, 1, near=[anchor] if anchor else None,
                protect=operands)
            try:
                data = self.devices[src_d].read([src_slot])
                self.devices[target].write([new_slot], data)
                inj = getattr(self.devices[target], "fault_injector", None)
                if inj is not None:
                    row = data.reshape(self.words)
                    out = inj.on_transfer(target, new_slot, row)
                    if out is not row:
                        self.devices[target].write([new_slot],
                                                   out.reshape(1, -1))
            except AmbitError:
                # landing row is stuck / a device died mid-hop: give the
                # fresh slot back so retry re-placement starts clean
                self.allocators[target].free([new_slot])
                raise
            self.allocators[src_d].free([src_slot])
            cbv.slots[i] = (target, new_slot)
            anchor = anchor or new_slot
            hop_ns = self.channel.device_to_device_ns(src_d, target,
                                                      self.row_bytes)
            self.ledger.inter_device_rows += 1
            self.ledger.inter_device_bytes += self.row_bytes
            self.ledger.inter_device_ns += hop_ns
            self.ledger.inter_device_nj += \
                self.channel.device_to_device_nj(src_d, target,
                                                 self.row_bytes)
            self.metrics.counter("inter_device_rows").inc(1)
            self.metrics.counter("inter_device_bytes").inc(self.row_bytes)
            self.metrics.counter("inter_device_ns").inc(hop_ns)
            if self.tracer.enabled:
                self.tracer.instant(
                    ("cluster", "channel"), "migrate_chunk", "channel",
                    args={"src": src_d, "dst": target,
                          "bytes": int(self.row_bytes)})
            moved += 1
        return moved


@dataclasses.dataclass
class ClusterReport:
    """What one sharded planner execution did, and what it cost.

    ``per_bank`` is the full ledger delta keyed by ``(device, bank)`` -
    the resource grain the async scheduler packs epochs by (banks of
    different devices are independent execution resources; channel
    transfers serialize and are reported separately in
    ``transfer_ns``)."""

    per_device_ns: Dict[int, float] = dataclasses.field(default_factory=dict)
    per_bank: Dict[Tuple[int, int], OpStats] = dataclasses.field(
        default_factory=dict)
    transferred_rows: int = 0       # cross-device colocation moves
    transfer_ns: float = 0.0
    transfer_bytes: int = 0
    stats: OpStats = dataclasses.field(default_factory=OpStats)
    #: the execution faulted partway: this report bills only the work
    #: actually done before the raise (the reliability layer absorbs it
    #: into the retrying query's accumulator).
    partial: bool = False


class ClusterPlanner:
    """Lower one expression tree across every shard of the cluster.

    Per chunk, operands are first unified onto one device (cheapest
    direction from the channel model - explicit, measured transfer ops);
    each device then runs ONE sub-plan over its chunk group through the
    existing QueryPlanner (subarray batching, scratch staging). Reported
    time is max-over-devices compute plus the serialized channel time;
    energy and AAP counts are summed (the Fig. 21 accounting, lifted one
    level up the hierarchy)."""

    def __init__(self, cluster: PimCluster):
        self.cluster = cluster
        self.last_report: Optional[ClusterReport] = None

    def footprint(self, env: Dict[str, ClusterBitVector]) -> frozenset:
        """``(device, bank)`` resources the operands occupy - the epoch
        admission signal for the async scheduler. A spilled operand
        faults back in at placement-chosen devices, so it conservatively
        claims every bank of every device."""
        cl = self.cluster
        out = set()
        for nm in sorted(env):
            cbv = env[nm]
            if cbv.spilled or cbv.partially_spilled:
                return frozenset(
                    (d, b) for d in range(cl.n_devices)
                    for b in range(len(cl.devices[d].banks)))
            out.update((ds[0], ds[1][0]) for ds in cbv.slots)
        return frozenset(out)

    def execute(self, expression: E.Expr,
                env: Dict[str, ClusterBitVector],
                out_name: Optional[str] = None) -> ClusterBitVector:
        cl = self.cluster
        self.last_report = None
        if not env:
            raise ValueError("planner needs at least one operand")
        names = sorted(env)
        operands = [env[nm] for nm in names]
        first = operands[0]
        for cbv in operands:
            cl._check_fully_live(cbv)
            if (cbv.n_bits, cbv.shape, cbv.n_slots) != (
                    first.n_bits, first.shape, first.n_slots):
                raise ValueError(
                    "bbop operands must be row-aligned and equal-sized "
                    "(Section 5.3)")
            cl._touch(cbv)
        report = ClusterReport()

        dst: List[Optional[DeviceSlot]] = [None] * first.n_slots
        dev_stats: Dict[int, OpStats] = {}
        cl._in_flight = tuple(operands)     # no eviction of operands
        led = cl.ledger
        rows0, ns0, bytes0, nj0 = (led.inter_device_rows,
                                   led.inter_device_ns,
                                   led.inter_device_bytes,
                                   led.inter_device_nj)
        try:
            try:
                if len(operands) > 1:
                    cl.colocate(operands)
                report.transferred_rows = led.inter_device_rows - rows0
                report.transfer_ns = led.inter_device_ns - ns0
                report.transfer_bytes = led.inter_device_bytes - bytes0
                transfer_nj = led.inter_device_nj - nj0

                by_dev: Dict[int, List[int]] = {}
                for i in range(first.n_slots):
                    by_dev.setdefault(operands[0].slots[i][0], []).append(i)

                for d in sorted(by_dev):
                    idxs = by_dev[d]
                    # Names bound to the same handle must share ONE view:
                    # distinct views over the same slots would each free
                    # the old slot when colocation migrates the chunk.
                    views: Dict[int, ResidentBitVector] = {}
                    sub_env = {}
                    for nm in names:
                        key = id(env[nm])
                        if key not in views:
                            views[key] = self._subview(env[nm], d, idxs)
                        sub_env[nm] = views[key]
                    try:
                        res = cl.planners[d].execute(expression, sub_env)
                    finally:
                        # Per-device colocation may have moved operand
                        # rows within the device - even on a faulted
                        # attempt, where the moves that completed are
                        # real. Write the sub-view slots back either
                        # way or a retry frees stale rows.
                        for nm in names:
                            sv = sub_env[nm]
                            for k, i in enumerate(idxs):
                                if k < len(sv.slots) and \
                                        sv.slots[k] is not None:
                                    env[nm].slots[i] = (d, sv.slots[k])
                    cl.stores[d].disown(res)
                    for k, i in enumerate(idxs):
                        dst[i] = (d, res.slots[k])
                    res.slots = []  # ownership moves to the cluster handle
                    sub_rep = cl.planners[d].last_report
                    sub_rep._cluster_absorbed = True
                    dev_stats[d] = sub_rep.stats
                    for b, st in sub_rep.per_bank.items():
                        report.per_bank[(d, b)] = st
            except AmbitError:
                for ds in dst:
                    if ds is not None:
                        cl.allocators[ds[0]].free([ds[1]])
                # Bill the work the fault interrupted: transfers already
                # on the wire plus the faulting device's own partial
                # sub-report (its planner frees the device rows; the
                # cost survives). The retry loop absorbs this report.
                report.transferred_rows = led.inter_device_rows - rows0
                report.transfer_ns = led.inter_device_ns - ns0
                report.transfer_bytes = led.inter_device_bytes - bytes0
                transfer_nj = led.inter_device_nj - nj0
                for d in range(cl.n_devices):
                    rep = cl.planners[d].last_report
                    if rep is not None and rep.partial and \
                            not getattr(rep, "_cluster_absorbed", False):
                        rep._cluster_absorbed = True
                        dev_stats[d] = rep.stats
                        for b, st in rep.per_bank.items():
                            report.per_bank[(d, b)] = st
                self._finalize(report, dev_stats, transfer_nj,
                               partial=True)
                raise
        finally:
            cl._in_flight = ()

        self._finalize(report, dev_stats, transfer_nj, partial=False)

        out = ClusterBitVector(
            cluster=cl, n_bits=first.n_bits, shape=first.shape,
            words32=first.words32, chunks=first.chunks, slots=dst,
            dirty=True, name=out_name)
        cl._register(out)
        return out

    def _finalize(self, report: ClusterReport,
                  dev_stats: Dict[int, OpStats], transfer_nj: float,
                  partial: bool) -> None:
        """Roll per-device sub-reports into the cluster report, publish
        it as ``last_report`` and emit the metrics/trace events. Shared
        by the success path and the partial (faulted) path so recovery
        costs hit the same ledgers as normal work."""
        cl = self.cluster
        report.per_device_ns = {d: st.ns for d, st in dev_stats.items()
                                if st.ns > 0.0}
        report.stats = OpStats(
            ns=max((st.ns for st in dev_stats.values()), default=0.0)
            + report.transfer_ns,
            energy_nj=sum(st.energy_nj for st in dev_stats.values())
            + transfer_nj,
            aap_count=sum(st.aap_count for st in dev_stats.values()),
            bytes_touched=0,        # resident: no host traffic
            channel_ns=report.transfer_ns,
            channel_bytes=report.transfer_bytes,
            refresh_stolen_ns=sum(st.refresh_stolen_ns
                                  for st in dev_stats.values()))
        report.partial = partial
        self.last_report = report

        # Per-(device,bank) busy time is the occupancy signal the
        # utilization report divides by the drain wall clock. Counted
        # here (not in the per-device QueryPlanners, whose registries
        # are private to their stores) so each bank-ns is billed once.
        m = cl.metrics
        if partial:
            m.counter("plan_faulted").inc(1)
        else:
            m.counter("plan_executions").inc(1)
        for (d, b) in sorted(report.per_bank):
            st = report.per_bank[(d, b)]
            if st.ns:
                m.counter("bank_busy_ns").inc(st.ns, device=d, bank=b)
            if st.refresh_stolen_ns:
                m.counter("refresh_stolen_ns").inc(
                    st.refresh_stolen_ns, device=d, bank=b)
        if cl.tracer.enabled:
            args = {"devices": len(report.per_device_ns),
                    "transfer_rows": report.transferred_rows,
                    "aaps": report.stats.aap_count}
            if partial:
                args["partial"] = True
            cl.tracer.tick(
                ("planner", "cluster"), "plan", "plan", report.stats.ns,
                args=args)

    def _subview(self, cbv: ClusterBitVector, d: int,
                 idxs: List[int]) -> ResidentBitVector:
        """A per-device ResidentBitVector view of the chunks living on
        device ``d``: each chunk becomes one full-row logical row, so the
        device planner can batch/stage/colocate them natively. Slot
        updates are written back by the caller after the sub-plan."""
        cl = self.cluster
        return ResidentBitVector(
            store=cl.stores[d], n_bits=cl.words * 64, shape=(len(idxs),),
            words32=cl.words * 2, chunks=1,
            slots=[cbv.slots[i][1] for i in idxs], dirty=True,
            name=cbv.name)
