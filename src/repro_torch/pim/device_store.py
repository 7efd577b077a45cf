"""DeviceStore: bitvectors resident on the accelerator across calls.

  * ``DeviceBitVector`` / ``DeviceStore`` - bitvectors ``put`` once live
    as int32 tensors on the store's device behind the same handle API as
    the reference's PimStore (put/get/free/pin, dirty tracking, LRU spill
    to host under a ``capacity_bytes`` budget). ``OpStats.bytes_touched``
    is zero for resident operands; only faulted-in / spilled bytes are
    charged.

  * ``DevicePlanner`` - one whole expression tree evaluates as ONE fused
    launch over resident tensors (``kernels.ops.fused_eval``), results
    stay resident (dirty: no host read-back until ``get``), and ``out=``
    rebinds of store-created buffers write the result in place into the
    destination's tensor, so chained queries update storage without
    allocation churn. (The reference donates the buffer to XLA instead.)

  * epoch execution - ``execute_epoch`` runs a whole scheduler epoch of
    shape-compatible queries as ONE launch that reads per-query operand
    and output pointers, one kernel launch per epoch instead of one per
    query, with no stacking copy.

  * early counts - on the "cuda" backend a result the scheduler marks
    terminal (no ticket of its drain reads it, no ``out=``) has its count
    issued on the stream right behind its own launch, copied into a slot
    of a host ring and marked by an event. ``popcount`` then waits for
    that event alone, not for every launch queued after the query, so
    the card keeps working while the host answers. Any write to the
    handle after the count was issued (``out=`` rebind, donation, spill,
    fault-in, free, a new or in-place written tensor) drops it, and the
    count is taken as before.

The DRAM-model fields of the ledger (ns / energy / AAPs) stay zero here:
the accelerator path measures *traffic*.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import expr as E
from ..core.bitvector import BitVector
from ..core.engine import OpStats, check_backend, resolve_device
from ..core.simulator import AmbitError
from ..kernels import bitwise as kbw
from ..kernels import ops as kops
from .store import LruSpillBase


@dataclasses.dataclass(eq=False)
class DeviceBitVector:
    """Handle to a bitvector resident on the accelerator as a packed
    int32 tensor. Compares (and hashes) by identity.

    ``spilled`` handles hold no device buffer (LRU-evicted under the
    capacity budget) but stay fully usable: the host copy is current,
    ``get`` is free, and ``ensure_resident`` re-uploads on demand.
    ``pinned`` handles are never chosen as eviction victims."""

    store: "DeviceStore"
    n_bits: int
    shape: Tuple[int, ...]       # leading (batch) dims of the host layout
    words32: int                 # packed 32-bit words per logical row
    _dev: Optional[torch.Tensor] = None   # shape + (words32,) int32
    dirty: bool = False
    pinned: bool = False
    spilled: bool = False
    name: Optional[str] = None
    _host: Optional[BitVector] = None
    # True when the store created _dev itself (planner results): only
    # such buffers may be overwritten in place - a put() buffer may be
    # shared with the caller's BitVector, which must never change.
    _private: bool = False
    # The count issued right behind the launch that wrote _dev, while no
    # write has followed it (DeviceStore.count_early).
    _early: Optional["_EarlyCount"] = None

    @property
    def device_bytes(self) -> int:
        n_rows = int(np.prod(self.shape)) if self.shape else 1
        return n_rows * self.words32 * 4

    @property
    def slots(self) -> list:
        """Placement-API compatibility: accelerator tensors have no row
        homes, so apps' ``near=handle.slots`` chains degrade to None."""
        return []

    @property
    def freed(self) -> bool:
        return self._dev is None and not self.spilled

    def get(self) -> BitVector:
        return self.store.get(self)

    def free(self) -> None:
        self.store.free(self)

    def __repr__(self):
        nm = f" {self.name!r}" if self.name else ""
        flags = (" pinned" if self.pinned else "") + \
            (" spilled" if self.spilled else "")
        return (f"<DeviceBitVector{nm} n_bits={self.n_bits} "
                f"bytes={self.device_bytes} dirty={self.dirty}{flags}>")


@dataclasses.dataclass(eq=False)
class _EarlyCount:
    """A count in flight: its ring slot, and what the handle held when it
    was issued - the tensor, that tensor's version and the handle's
    generation. The count is the handle's while all three still hold."""

    slot: int
    dev: torch.Tensor
    version: int
    generation: int


class _CountRing:
    """Host slots that early counts land in: pinned int32 words on the
    card's side, so the copy into them is asynchronous, each slot with an
    event of its own, so no event is made a launch. A slot released
    before its count was read goes back only once its event has
    completed; the ring grows by ``CHUNK`` slots when none is free."""

    CHUNK = 256

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self._words: List[torch.Tensor] = []     # slot -> (1,) int32 view
        self._host: List[np.ndarray] = []        # slot -> the same word
        self._events: List[object] = []
        self._ready: deque = deque()     # read after their event completed
        self._waiting: deque = deque()   # released unread: may be in flight

    def acquire(self) -> int:
        if self._ready:
            return self._ready.popleft()
        if self._waiting and (not self.cuda
                              or self._events[self._waiting[0]].query()):
            return self._waiting.popleft()
        base = len(self._words)
        chunk = torch.zeros(self.CHUNK, dtype=torch.int32,
                            pin_memory=self.cuda)
        view = chunk.numpy()
        for k in range(self.CHUNK):
            self._words.append(chunk[k:k + 1])
            self._host.append(view[k:k + 1])
            self._events.append(torch.cuda.Event() if self.cuda else None)
        self._ready.extend(range(base + 1, base + self.CHUNK))
        return base

    def issue(self, slot: int, total: torch.Tensor) -> None:
        """Copy a (1,) int32 device total into ``slot`` behind the work
        queued on the current stream, and record the slot's event after
        it (off the card the copy has finished when this returns)."""
        self._words[slot].copy_(total, non_blocking=True)
        if self.cuda:
            self._events[slot].record()

    def read(self, slot: int) -> int:
        """Wait for the slot's copy alone, then read its total."""
        if self.cuda:
            self._events[slot].synchronize()
        return int(self._host[slot][0])

    def release(self, slot: int, read: bool) -> None:
        (self._ready if read else self._waiting).append(slot)


def _host_copy(data: torch.Tensor) -> torch.Tensor:
    """A CPU tensor that shares no storage with ``data``: a host copy
    must neither keep card memory alive nor see later in-place writes."""
    return data.to("cpu", copy=True)


class DeviceStore(LruSpillBase):
    """put/get/free lifecycle for bitvectors resident on one accelerator.

    ``bytes_to_device`` / ``bytes_from_device`` count only genuine
    host<->accelerator transfers (uploads at put/fault-in, read-backs of
    dirty data), and the LRU spills the coldest unpinned handle when
    ``capacity_bytes`` would be exceeded - clean victims for free, dirty
    ones read back through the ledger first."""

    _handle_desc = "device bitvector"
    _obs_name = "device_store"

    def __init__(self, backend: str = "cuda", device=None,
                 capacity_bytes: Optional[int] = None):
        if backend == "ambit_sim":
            raise ValueError(
                f"DeviceStore backends are 'torch'/'cuda', got {backend!r} "
                "(the DRAM model path is PimStore)")
        check_backend(backend)
        self.backend = backend
        self.device = resolve_device(device)
        self.capacity_bytes = capacity_bytes
        self.resident_bytes = 0
        self.host_writes = 0
        self.host_reads = 0
        self.bytes_to_device = 0
        self.bytes_from_device = 0
        # Early counts issued behind their launches, and popcount() calls
        # that read one (hits) or counted the handle then (misses). Plain
        # attributes, outside the metrics registry, like the kernels'
        # ``<wrapper>.ring_launches``.
        self.early_counts = 0
        self.early_count_hits = 0
        self.early_count_misses = 0
        self._ring = _CountRing(self.device)
        self._lru_init()

    # -- LruSpillBase hooks ---------------------------------------------------

    def _owner_of(self, rbv: DeviceBitVector):
        return rbv.store

    def _resident_storage(self, rbv: DeviceBitVector) -> bool:
        return rbv._dev is not None

    def _release_rows(self, rbv: DeviceBitVector) -> None:
        if rbv._dev is not None:
            self.resident_bytes -= rbv.device_bytes
        rbv._dev = None
        self.drop_early(rbv)

    def _move_storage(self, out: DeviceBitVector,
                      res: DeviceBitVector) -> None:
        out._dev, res._dev = res._dev, None   # byte count rides along
        out._private = res._private
        self.drop_early(out)
        self.drop_early(res)

    def _read_back(self, rbv: DeviceBitVector) -> BitVector:
        with self.tracer.host_span("device_store.sync",
                                   site=self._io_cause or "read_back"):
            out = BitVector(_host_copy(rbv._dev), rbv.n_bits)
        rbv._host = out
        rbv.dirty = False
        self._charge_io("from_device", self._io_cause or "read_back",
                        rbv.device_bytes)
        return out

    def spill(self, rbv: DeviceBitVector, _force_held: bool = False) -> None:
        super().spill(rbv, _force_held=_force_held)
        # Clean victims skip _read_back, but their host copy may still be
        # the card tensor put() was given: move it to host memory so the
        # spill really frees the card.
        if rbv._host.data.is_cuda:
            with self.tracer.host_span("device_store.sync", site="spill"):
                rbv._host = BitVector(rbv._host.data.cpu(), rbv.n_bits)

    # -- capacity -------------------------------------------------------------

    def _make_room(self, nbytes: int,
                   protect: Iterable[DeviceBitVector] = ()) -> None:
        if self.capacity_bytes is None:
            return
        while self.resident_bytes + nbytes > self.capacity_bytes:
            if not self._evict_lru(protect):
                raise AmbitError(
                    f"device capacity full ({self.resident_bytes}/"
                    f"{self.capacity_bytes} B resident) and every device "
                    f"bitvector is pinned or in use")

    def adopt(self, rbv: DeviceBitVector) -> DeviceBitVector:
        """Track an externally built handle (planner results) in the LRU
        and the capacity ledger, like any put() handle."""
        self.resident_bytes += rbv.device_bytes
        self._register(rbv)
        return rbv

    # -- lifecycle ------------------------------------------------------------

    def put(self, bv: BitVector, policy=None, near=None,
            name: Optional[str] = None,
            pin: bool = False) -> DeviceBitVector:
        """Upload a host BitVector (``near``/``policy`` are accepted for
        PimStore API compatibility; an accelerator has no row placement).
        A BitVector already on the store's device is shared, not copied."""
        del policy, near
        data = bv.data.to(self.device).contiguous()
        rbv = DeviceBitVector(
            store=self, n_bits=bv.n_bits, shape=tuple(data.shape[:-1]),
            words32=int(data.shape[-1]), _dev=None, dirty=False,
            name=name, _host=bv)
        self._make_room(rbv.device_bytes)
        rbv._dev = data
        self.adopt(rbv)
        self._charge_io("to_device", "upload", rbv.device_bytes)
        if pin:
            try:
                self.pin(rbv)
            except AmbitError:          # over budget: undo the upload
                self.free(rbv)
                raise
        return rbv

    def ensure_resident(self, rbv: DeviceBitVector,
                        protect: Iterable[DeviceBitVector] = ()
                        ) -> DeviceBitVector:
        """Fault a spilled handle back onto the accelerator (charged as a
        fresh upload). Live handles just refresh recency."""
        self._check_handle(rbv)
        if not rbv.spilled:
            self._touch(rbv)
            return rbv
        self._make_room(rbv.device_bytes, protect=(rbv, *protect))
        rbv._dev = rbv._host.data.to(self.device).contiguous()
        rbv._private = False        # may share the host copy again
        rbv.spilled = False
        rbv.dirty = False
        self.adopt(rbv)
        self._charge_io("to_device", "fault_in", rbv.device_bytes)
        self._invalidate(rbv)   # placement changed: generation bumps
        return rbv

    # -- device-side reduction -------------------------------------------------

    def count_early(self, rbv: DeviceBitVector) -> None:
        """Issue ``rbv``'s count now, right behind the launch that wrote
        it (the popcount kernel, the rows summed on the card, the int32
        total copied into a ring slot), for a later ``popcount`` to read.
        No bytes are charged here: the read charges them, as before. A
        handle whose total could pass int32, or a store on the "torch"
        backend, is left to ``popcount``."""
        dev = rbv._dev.reshape(-1, rbv.words32)
        if self.backend != "cuda" or dev.shape[0] * rbv.n_bits >= 1 << 31:
            return
        counts = kops.popcount(dev)
        total = counts if counts.numel() == 1 else \
            counts.sum(dtype=torch.int32).reshape(1)
        slot = self._ring.acquire()
        self._ring.issue(slot, total)
        rbv._early = _EarlyCount(slot, rbv._dev, rbv._dev._version,
                                 self.generation(rbv))
        self.early_counts += 1

    def drop_early(self, rbv: DeviceBitVector) -> None:
        """Forget ``rbv``'s early count (a write is about to follow it, or
        its storage is going); its slot is reused once the copy is done."""
        early, rbv._early = rbv._early, None
        if early is not None:
            self._ring.release(early.slot, read=False)

    def _take_early(self, rbv: DeviceBitVector) -> Optional[_EarlyCount]:
        """The handle's early count if it still counts what the handle
        holds: the same tensor, unwritten since, at the same generation."""
        early = rbv._early
        if early is None:
            return None
        if rbv._dev is early.dev and early.dev._version == early.version \
                and self.generation(rbv) == early.generation:
            rbv._early = None
            return early
        self.drop_early(rbv)
        return None

    def popcount(self, rbv: DeviceBitVector) -> int:
        """Count set bits WITHOUT reading the bitvector back: the
        reduction runs on the accelerator (the popcount kernel on the
        cuda backend, plain tensor code on torch) and only the total
        crosses to the host - 4 ledger bytes instead of the whole array.
        Device tensors are tail-masked by construction, so the
        full-array count is exact. Spilled handles count their current
        host copy for free. A result counted early (``count_early``)
        waits for its own count's event and reads its slot; any other
        handle is counted now. Reading the total is the host span
        ``device_store.sync`` (site ``popcount``, ``early`` whether the
        early count served it), as every read here that waits for the
        device is."""
        self._check_handle(rbv)
        if rbv.spilled:
            self.early_count_misses += 1
            return int(rbv._host.popcount().sum())
        self._touch(rbv)
        early = self._take_early(rbv)
        if early is not None:
            with self.tracer.host_span("device_store.sync", site="popcount",
                                       early=True):
                total = self._ring.read(early.slot)
            self._ring.release(early.slot, read=True)
            self.early_count_hits += 1
        else:
            dev = rbv._dev.reshape(-1, rbv.words32)
            if self.backend == "cuda":
                counts = kops.popcount(dev)
                # one row (every 1-D handle): read its count, no sum launch
                with self.tracer.host_span("device_store.sync",
                                           site="popcount", early=False):
                    total = int(counts[0] if counts.numel() == 1
                                else counts.sum())
            else:
                counts = BitVector(dev, rbv.n_bits).popcount()
                with self.tracer.host_span("device_store.sync",
                                           site="popcount", early=False):
                    total = int(counts.sum())
            self.early_count_misses += 1
        self._charge_io("from_device", "popcount", 4)   # one int32 scalar
        return total


@dataclasses.dataclass
class DeviceReport:
    """What one accelerator planner execution (or epoch) did. ``per_bank``
    stays empty - an accelerator launch has no per-bank DRAM ledger -
    and exists so the async scheduler's accounting path is uniform."""

    queries: int = 0
    kernel_launches: int = 0
    donated: int = 0                # out= buffers overwritten in place
    per_bank: Dict[Tuple[int, int], OpStats] = dataclasses.field(
        default_factory=dict)
    stats: OpStats = dataclasses.field(default_factory=OpStats)


class DevicePlanner:
    """Whole-Expr execution over DeviceStore handles, sharing the
    reference QueryPlanner's ``execute`` / ``footprint`` / ``last_report``
    surface so AmbitRuntime and AsyncScheduler drive it."""

    def __init__(self, store: DeviceStore):
        self.store = store
        self.backend = store.backend
        self.kernel_launches = 0
        self.last_report: Optional[DeviceReport] = None

    # -- scheduler hooks ------------------------------------------------------

    def footprint(self, env: Dict[str, DeviceBitVector]) -> frozenset:
        """An accelerator epoch is one fused launch, not a set of banks:
        queries never contend for (device, bank) resources, so epoch
        admission is governed purely by data hazards and the stack key."""
        return frozenset()

    def stack_key(self, expression: E.Expr, env: Dict[str, object]):
        """Queries sharing this key run as ONE kernel launch: same
        expression DAG, operand names, and operand geometry. Ticket
        operands (results of earlier queries) inherit the geometry of
        their producers, so any concrete handle in the DAG decides."""
        handle = self._any_handle(env)
        if handle is None:
            return (expression, tuple(sorted(env)))
        return (expression, tuple(sorted(env)), handle.n_bits,
                handle.shape, handle.words32)

    def _any_handle(self, env: Dict[str, object]):
        for nm in sorted(env):
            v = env[nm]
            if isinstance(v, DeviceBitVector):
                return v
            sub = getattr(v, "env", None)   # a Ticket: recurse
            if sub is not None:
                h = self._any_handle(sub)
                if h is not None:
                    return h
        return None

    # -- execution ------------------------------------------------------------

    def _validate(self, env: Dict[str, DeviceBitVector]):
        if not env:
            raise ValueError("planner needs at least one operand")
        names = sorted(env)
        first = env[names[0]]
        for nm in names:
            rbv = env[nm]
            self.store._check_live(rbv)
            if (rbv.n_bits, rbv.shape, rbv.words32) != (
                    first.n_bits, first.shape, first.words32):
                raise ValueError(
                    "bbop operands must be row-aligned and equal-sized "
                    "(Section 5.3)")
            self.store._touch(rbv)
        return names, first

    def execute(self, expression: E.Expr,
                env: Dict[str, DeviceBitVector],
                out_name: Optional[str] = None,
                donate_to: Optional[DeviceBitVector] = None,
                count: bool = False) -> DeviceBitVector:
        """One fused launch over resident operands; the result stays
        resident (dirty). ``donate_to`` - the handle an ``out=`` rebind
        will overwrite - receives the result in place in its own tensor
        when that tensor is store-private and the handle is exactly one
        of the operands. ``count`` issues the result's count right behind
        the launch on "cuda" (``DeviceStore.count_early``)."""
        return self._run(expression, [env], [out_name], donate_to, [count])[0]

    def execute_epoch(self, jobs: Sequence[tuple],
                      count: Sequence[bool] = ()) -> List[DeviceBitVector]:
        """Run one scheduler epoch - ``(expression, env, out_name,
        out_handle)`` jobs sharing a stack key - as ONE kernel launch.
        A singleton epoch donates as ``execute`` does, so ``out=`` chains
        keep their in-place write. ``count[k]`` issues job k's count
        behind the launch, as ``execute``'s ``count`` does."""
        donate = None
        if len(jobs) == 1:
            _, env, _, out = jobs[0]
            if out is not None and any(v is out for v in env.values()):
                donate = out
        return self._run(jobs[0][0], [job[1] for job in jobs],
                         [job[2] for job in jobs], donate,
                         list(count) or [False] * len(jobs))

    def _run(self, expression: E.Expr, envs: List[Dict[str, DeviceBitVector]],
             out_names: List[Optional[str]],
             donate_to: Optional[DeviceBitVector],
             count: List[bool]) -> List[DeviceBitVector]:
        """The launch of ``execute`` and ``execute_epoch``: one query or
        an epoch of queries sharing (expression, names, shape)."""
        names, first = self._validate(envs[0])
        for env in envs[1:]:
            jnames, jfirst = self._validate(env)
            if jnames != names or (jfirst.n_bits, jfirst.shape) != (
                    first.n_bits, first.shape):
                raise AmbitError(
                    "epoch jobs must share (expression, names, shape) - "
                    "the scheduler's stack key guarantees this")
        out = None
        if donate_to is not None and donate_to._private:
            # only store-created buffers are overwritten (a put() buffer
            # may be the caller's); aliased twice is also unsafe
            matches = [nm for nm in names if envs[0][nm] is donate_to]
            if len(matches) == 1:
                out = donate_to._dev
                self.store.drop_early(donate_to)    # written in place
        operands = [[env[nm]._dev for nm in names] for env in envs]
        with self.store.tracer.host_span("device_store.launch",
                                         queries=len(envs),
                                         operands=len(names)) as span:
            if self.backend == "cuda":
                shared = kbw.fused_bitwise_stacked.shared_outputs
                outs = kops.fused_eval(expression, tuple(names), operands,
                                       first.n_bits, out)
                self._note_launch(
                    span, expression, names, len(envs), len(envs) -
                    kbw.fused_bitwise_stacked.shared_outputs + shared)
            else:           # plain: a fresh result, as off the accelerator
                outs = kbw.fused_bitwise_stacked_plain(
                    expression, names, operands, first.n_bits)
        # Budget the results AFTER the launch consumed the operands: cold
        # operands are now legal spill victims, so an exact-fit capacity
        # still runs arbitrarily long chains. A donated destination must
        # survive until the rebind.
        self.store._make_room(
            len(envs) * first.device_bytes,
            protect=() if out is None else (donate_to,))
        self.kernel_launches += 1
        results = []
        for out_name, out_dev, early in zip(out_names, outs, count):
            res = DeviceBitVector(
                store=self.store, n_bits=first.n_bits, shape=first.shape,
                words32=first.words32, _dev=out_dev, dirty=True,
                name=out_name, _private=True)
            self.store.adopt(res)
            if early:
                self.store.count_early(res)
            results.append(res)
        donated = 0 if out is None else 1
        self.last_report = DeviceReport(queries=len(envs), kernel_launches=1,
                                        donated=donated, stats=OpStats())
        self._record_dispatch(queries=len(envs), donated=donated)
        return results

    def _note_launch(self, span, expression: E.Expr, names, queries: int,
                     evaluations: int) -> None:
        """With host spans on, the launch span's program instructions, its
        evaluations (the epoch's distinct jobs: queries less the outputs
        the kernel shared) and pointer route (``kops.launch_args``)."""
        if self.store.tracer.host_enabled:
            span.note(**kops.launch_args(expression, tuple(names), queries,
                                         evaluations))

    def _record_dispatch(self, queries: int, donated: int = 0) -> None:
        m = self.store.metrics
        m.counter("fused_dispatches").inc(1)
        m.counter("fused_queries").inc(queries)
        if donated:
            m.counter("donated_buffers").inc(donated)
        tr = self.store.tracer
        if tr.enabled:
            tr.instant(("device_store", "dispatch"), "fused_dispatch",
                       "dispatch", args={"queries": queries,
                                         "backend": self.backend,
                                         "donated": donated})
