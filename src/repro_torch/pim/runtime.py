"""AmbitRuntime: the session API applications call instead of raw
``engine.eval``.

A runtime owns one simulated device (or, with ``devices > 1``, a
``PimCluster`` of them), a RowAllocator per device, a PimStore-compatible
store and a planner, and exposes the put / eval / get / free lifecycle:

    rt = AmbitRuntime(banks=4, subarrays=4, words=64, device="cuda")
    a, b = rt.put(bv_a), rt.put(bv_b)
    acc = rt.and_(a, b)            # stays in DRAM - no host read-back
    acc = rt.xor(acc, a)           # chains stay resident
    result = rt.get(acc)           # the only host transfer
    rt.free(acc)

Multi-device sessions shard every bitvector across the cluster
(``placement=`` picks round_robin / packed / affinity) and lower each
expression as per-device sub-plans with explicit, measured inter-device
transfers when operands span shards:

    rt = AmbitRuntime(devices=4, placement="round_robin")

Per-call DRAM cost lands in ``last_stats`` (time = max over banks - and,
sharded, max over devices plus serialized channel time; energy and AAPs
summed); ``session_stats`` accumulates across the session, and
``bytes_touched`` counts only genuine host<->device transfers, so a
resident chain's ledger shows exactly the data-movement win the paper is
about. Spilled operands (LRU eviction on a full device) fault back in
transparently at eval time; the re-upload is charged to the call.

Every session's data lives on one torch ``device``: the DRAM model's
rows (of every simulated device of a cluster) on ``"ambit_sim"``, the
resident tensors on ``"torch"``/``"cuda"``. It is the card unless the
caller names another (``device="cpu"``), and the runtime raises when the
card is asked for and absent. On ``"ambit_sim"``, ``rt.device`` is the
``AmbitDevice`` (as in the reference), whose ``.device`` is the torch
device; on ``"torch"``/``"cuda"`` it is the torch device itself.
``rt.tensor_device`` is the torch device on every backend.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from ..core import expr as E
from ..core.bitvector import BitVector
from ..core.engine import OpStats, binop_expr, check_backend
from ..core.geometry import DEFAULT_GEOMETRY, DRAMGeometry
from ..core.simulator import AmbitDevice, AmbitError
from ..core.timing import DEFAULT_TIMING, TimingParams
from ..obs import NULL_TRACER, MetricsRegistry, Tracer
from .allocator import STRIPED
from .cluster import (ChannelModel, ClusterBitVector, PimCluster,
                      ROUND_ROBIN)
from .device_store import DeviceBitVector, DevicePlanner, DeviceStore
from .faults import (FaultConfig, FaultInjector, ReliabilityManager,
                     _new_acc)
from .planner import QueryPlanner
from .scheduler import AsyncScheduler, DrainReport, Ticket
from .store import PimStore, ResidentBitVector


class AmbitRuntime:
    """Session API over one of three resident backends:

      * ``backend="ambit_sim"`` (default) - the DRAM device model:
        single device or a sharded ``PimCluster`` (``devices=N``).
      * ``backend="torch"`` / ``"cuda"`` - the accelerator-resident
        ``DeviceStore``: operands live as int32 tensors on ``device``,
        whole expressions run as one fused launch (the hand-written
        kernels on ``"cuda"``, plain tensor code on ``"torch"``), and
        ``submit``/``drain`` packs shape-compatible queries into ONE
        stacked launch per epoch. ``capacity_bytes`` bounds device
        memory (LRU spill to host, exactly like the DRAM path's row
        budget).
    """

    def __init__(self, geometry: DRAMGeometry = DEFAULT_GEOMETRY,
                 timing: TimingParams = DEFAULT_TIMING,
                 banks: Optional[int] = None,
                 subarrays: Optional[int] = None,
                 words: Optional[int] = None,
                 policy: str = STRIPED, optimize: bool = True,
                 colocate: bool = True, scratch_rows: int = 4,
                 devices: int = 1, placement: str = ROUND_ROBIN,
                 channel: Optional[ChannelModel] = None,
                 seed: int = 0, backend: str = "ambit_sim",
                 capacity_bytes: Optional[int] = None,
                 pin_budget_bytes: Optional[int] = None,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 fault_injector: Optional[FaultInjector] = None,
                 device=None):
        check_backend(backend)
        if fault_injector is not None and backend != "ambit_sim":
            raise ValueError(
                "fault injection models the DRAM device "
                "(backend='ambit_sim'); accelerator backends have no "
                "row-level fault surface")
        self.backend = backend
        if backend != "ambit_sim":
            if devices > 1:
                raise ValueError(
                    "devices>1 shards the DRAM model; the accelerator "
                    "store is one device")
            self.cluster = None
            self.allocator = None
            self.store = DeviceStore(backend=backend, device=device,
                                     capacity_bytes=capacity_bytes)
            self.device = self.store.device
            self.planner = DevicePlanner(self.store)
            self._handle_type = DeviceBitVector
        elif devices > 1:
            self.cluster = PimCluster(
                devices, geometry, timing, banks=banks,
                subarrays=subarrays, words=words, placement=placement,
                channel=channel, policy=policy, scratch_rows=scratch_rows,
                optimize=optimize, colocate=colocate, seed=seed,
                device=device)
            self.store = self.cluster
            self.device = self.cluster.devices[0]
            self.allocator = None       # per-device: cluster.allocators
            self.planner = self.cluster.planner
            self._handle_type = ClusterBitVector
        else:
            self.cluster = None
            self.device = AmbitDevice(geometry, timing, banks=banks,
                                      subarrays=subarrays, words=words,
                                      seed=seed, device=device)
            self.store = PimStore(self.device, policy=policy,
                                  scratch_rows=scratch_rows)
            self.allocator = self.store.allocator
            self.planner = QueryPlanner(self.store, optimize=optimize,
                                        colocate=colocate)
            self._handle_type = ResidentBitVector
        self.tensor_device = (self.device if backend != "ambit_sim"
                              else self.device.device)
        self.store.pin_budget_bytes = pin_budget_bytes
        self.scheduler = AsyncScheduler(self.store, self.planner,
                                        self._handle_type)
        self.session_stats = OpStats()
        self.last_stats: Optional[OpStats] = None
        # Observability (obs): the store owns the session's
        # MetricsRegistry (its IO sites charge it unconditionally - see
        # LruSpillBase._charge_io); a caller-supplied registry replaces
        # it, and a live tracer is threaded through every layer. The
        # disabled NULL_TRACER default makes untraced runs record
        # nothing at zero cost.
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if metrics is not None:
            self.store.metrics = metrics
        self.metrics = self.store.metrics
        self.store.tracer = self.tracer
        if self.cluster is not None:
            for d, dev in enumerate(self.cluster.devices):
                dev.tracer = self.tracer
                dev.trace_name = f"device{d}"
        elif backend == "ambit_sim":
            self.device.tracer = self.tracer
        # Reliability (pim.faults): an explicit injector, or the
        # chaos-CI env hook PIM_CHAOS_RATE / PIM_CHAOS_SEED. The env
        # hook injects stuck rows ONLY - detectable, positional,
        # deterministically recoverable faults - so a chaos run's
        # results stay bit-exact with the fault-free suite while every
        # retry/quarantine path gets exercised.
        self.fault_injector = fault_injector
        if backend == "ambit_sim" and self.fault_injector is None:
            rate = float(os.environ.get("PIM_CHAOS_RATE", "0") or 0)
            if rate > 0.0:
                self.fault_injector = FaultInjector(FaultConfig(
                    seed=int(os.environ.get("PIM_CHAOS_SEED", "0") or 0),
                    stuck_row_rate=rate))
        self.reliability: Optional[ReliabilityManager] = None
        if backend == "ambit_sim":
            inj = self.fault_injector
            if inj is not None:
                inj.bind(metrics=self.metrics, tracer=self.tracer,
                         data_rows=self.device.geom.data_rows,
                         device=self.tensor_device)
                if self.cluster is not None:
                    for d, dev in enumerate(self.cluster.devices):
                        dev.fault_injector = inj
                        dev.device_index = d
                else:
                    self.device.fault_injector = inj
                    self.device.device_index = 0
            self.reliability = ReliabilityManager(
                self.store, self.planner, injector=inj,
                cluster=self.cluster)
            self.scheduler.reliability = self.reliability
        # Session-simulated clock: advanced by every call's modeled ns.
        self.clock_ns = 0.0

    # -- lifecycle -----------------------------------------------------------

    def put(self, bv: BitVector, name: Optional[str] = None,
            near=None, pin: bool = False, protect: bool = False):
        """Upload a bitvector. ``protect=True`` stores it TMR-encoded
        (three independently-placed planes, Section 5.5): queries over
        it execute replica-wise with parity checks and majority-vote
        scrubbing - 3x the storage and upload bytes, billed honestly."""
        up0 = self.store.bytes_to_device
        rd0 = self.store.bytes_from_device
        kwargs = {}
        if protect:
            if self.backend != "ambit_sim":
                raise ValueError(
                    "protect=True (TMR planes) requires backend="
                    "'ambit_sim' - the accelerator stores have no "
                    "row-level fault model to protect against")
            kwargs["protect"] = True
        rbv = self.store.put(bv, near=near, name=name, pin=pin, **kwargs)
        # Upload bytes for every plane, plus read-backs of dirty victims
        # a full device LRU-spilled to make room: all this call's traffic.
        self._account(OpStats(
            bytes_touched=(self.store.bytes_to_device - up0)
            + (self.store.bytes_from_device - rd0)))
        return rbv

    def get(self, rbv) -> BitVector:
        before = self.store.bytes_from_device
        out = self.store.get(rbv)
        # Only what actually crossed the channel (zero for clean/spilled
        # handles; a partially spilled dirty handle reads just its
        # still-resident chunks).
        self._account(OpStats(
            bytes_touched=self.store.bytes_from_device - before))
        return out

    def free(self, rbv) -> None:
        self.store.free(rbv)

    def pin(self, rbv) -> None:
        """Exempt a resident handle from LRU eviction, charged against
        the store's pin budget (``pin_budget_bytes``)."""
        self.store.pin(rbv)

    def unpin(self, rbv) -> None:
        self.store.unpin(rbv)

    # -- evaluation ----------------------------------------------------------

    def eval(self, expression: E.Expr, env: Dict[str, object],
             out_name: Optional[str] = None, out=None):
        """Evaluate a whole expression tree over resident operands. The
        result is a new resident bitvector; nothing crosses the channel
        except fault-ins of previously spilled operands. ``out=`` rebinds
        the result into an existing handle in place (on the accelerator
        backends, when the destination is an operand holding a
        store-created tensor, the kernel writes the result straight into
        that tensor, so chained queries update storage without
        allocation churn)."""
        for nm, v in env.items():
            if not isinstance(v, self._handle_type):
                raise TypeError(
                    f"operand {nm!r} is not resident - call put() first "
                    "(the host path is BulkBitwiseEngine.eval)")
        if out is not None and not isinstance(out, self._handle_type):
            raise TypeError("out= must be an existing resident handle")
        operands = list(env.values())
        up_before = self.store.bytes_to_device
        rd_before = self.store.bytes_from_device
        if self.reliability is not None:
            # Full recovery path: bounded retry + quarantine on injected
            # faults, replica-wise TMR execution for protected operands.
            # Failed attempts' DRAM work is accounted even when the
            # query ultimately raises - the ledgers own failed work too.
            if out is not None and any(getattr(v, "protected", False)
                                       for v in operands):
                raise AmbitError(
                    "out= rebind is not supported for TMR-protected "
                    "queries (the planes' storage moves as a set)")
            acc = _new_acc()
            try:
                res = self.reliability.run_query(expression, env,
                                                 out_name=out_name,
                                                 acc=acc)
            finally:
                st = OpStats()
                st.merge(acc["stats"])
                st.bytes_touched += \
                    (self.store.bytes_to_device - up_before) + \
                    (self.store.bytes_from_device - rd_before)
                self._account(st)
            return self.store.rebind(out, res) if out is not None else res
        for v in operands:
            self.store.ensure_resident(v, protect=operands)
        kwargs = {}
        if out is not None and isinstance(self.planner, DevicePlanner) \
                and any(v is out for v in operands):
            kwargs["donate_to"] = out
        res = self.planner.execute(expression, env, out_name=out_name,
                                   **kwargs)
        st = OpStats()
        st += self.planner.last_report.stats
        # Fault-ins (and any spill read-backs they forced) are host
        # traffic this call caused: charge them here.
        st.bytes_touched += (self.store.bytes_to_device - up_before) + \
            (self.store.bytes_from_device - rd_before)
        self._account(st)
        return self.store.rebind(out, res) if out is not None else res

    # -- async multi-query sessions -------------------------------------------

    def submit(self, expression: E.Expr, env: Dict[str, object],
               out=None, out_name: Optional[str] = None,
               now_ns: float = 0.0) -> Ticket:
        """Enqueue a query for the next ``drain``. Operands are resident
        handles or tickets of earlier submits (multi-root DAGs execute in
        one drain); queued operands are protected from eviction until
        their query runs. ``now_ns`` stamps the ticket on the caller's
        simulated clock. Returns the query's Ticket."""
        for nm, v in env.items():
            if not isinstance(v, (self._handle_type, Ticket)):
                raise TypeError(
                    f"operand {nm!r} is not resident - call put() first "
                    "(the host path is BulkBitwiseEngine.eval)")
        return self.scheduler.submit(expression, env, out=out,
                                     out_name=out_name, now_ns=now_ns)

    def drain(self, now_ns: float = 0.0, epoch_cost=None,
              refresh: bool = False, optimize: bool = False):
        """Execute every queued query, overlapping bank/device-disjoint
        queries in epochs. Returns the tickets in submit order; the
        drain's combined cost (sum of epoch maxima, summed energy/AAPs,
        fault-in bytes) lands in ``last_stats`` / ``session_stats``.
        ``now_ns``/``epoch_cost`` lay the epochs on a simulated clock
        (per-ticket ``started_ns``/``finished_ns``) for serving
        frontends; ``refresh=True`` pauses that timeline through DRAM
        refresh windows; ``optimize=True`` runs the cost-based query
        optimizer (cross-ticket CSE + result cache, bit-identical
        results) - see ``AsyncScheduler.drain``. NOTE: distinct from
        this runtime's constructor flag ``optimize=``, which controls
        the per-program AAP peephole inside the planner."""
        tickets = self.scheduler.drain(now_ns=now_ns,
                                       epoch_cost=epoch_cost,
                                       refresh=refresh,
                                       optimize=optimize)
        if tickets:
            st = OpStats()
            st += self.scheduler.last_drain.stats
            self._account(st)
        return tickets

    @property
    def last_drain(self) -> Optional[DrainReport]:
        return self.scheduler.last_drain

    def _binop(self, op: str, a, b):
        return self.eval(binop_expr(op), {"a": a, "b": b})

    def and_(self, a, b):
        return self._binop("and", a, b)

    def or_(self, a, b):
        return self._binop("or", a, b)

    def xor(self, a, b):
        return self._binop("xor", a, b)

    def nand(self, a, b):
        return self._binop("nand", a, b)

    def nor(self, a, b):
        return self._binop("nor", a, b)

    def xnor(self, a, b):
        return self._binop("xnor", a, b)

    def not_(self, a):
        return self.eval(~E.Expr.var("a"), {"a": a})

    def maj(self, a, b, c):
        return self.eval(E.maj(E.Expr.var("a"), E.Expr.var("b"),
                               E.Expr.var("c")), {"a": a, "b": b, "c": c})

    def popcount(self, rbv) -> int:
        """Count the set bits of a resident bitvector.

        On the accelerator backends the reduction runs device-side
        (the popcount kernel on ``"cuda"``, plain tensor code on
        ``"torch"``) and only the int32 total crosses the channel -
        ``bytes_touched`` charges 4 bytes, not the whole array. The DRAM
        model has no reduction op
        (Section 9.1 future-op), so ``ambit_sim`` still reads the result
        back - the one transfer a resident query pays there - and counts
        it with plain tensor ops where the rows live."""
        if hasattr(self.store, "popcount"):
            before = self.store.bytes_from_device
            count = self.store.popcount(rbv)
            self._account(OpStats(
                bytes_touched=self.store.bytes_from_device - before))
            return count
        return int(self.get(rbv).popcount())

    # -- accounting ----------------------------------------------------------

    @property
    def host_reads(self) -> int:
        return self.store.host_reads

    @property
    def host_writes(self) -> int:
        return self.store.host_writes

    def _account(self, st: OpStats) -> None:
        self.last_stats = st
        self.session_stats += st
        self.clock_ns += st.ns
        m = self.metrics
        m.counter("runtime_calls").inc(1)
        m.counter("runtime_ns").inc(st.ns)
        m.counter("runtime_energy_nj").inc(st.energy_nj)
        m.counter("runtime_aaps").inc(st.aap_count)
        m.counter("runtime_bytes_touched").inc(st.bytes_touched)

    def metrics_snapshot(self) -> dict:
        """JSON-safe dump of the session's metrics registry."""
        return self.metrics.snapshot()
