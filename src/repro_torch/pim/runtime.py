"""AmbitRuntime: the session API applications call instead of raw
``engine.eval``.

A runtime owns one accelerator-resident ``DeviceStore`` and its
``DevicePlanner`` and exposes the put / eval / get / free lifecycle:

    rt = AmbitRuntime(backend="cuda")
    a, b = rt.put(bv_a), rt.put(bv_b)
    acc = rt.and_(a, b)            # stays on the card - no read-back
    acc = rt.xor(acc, a)           # chains stay resident
    result = rt.get(acc)           # the only host transfer
    rt.free(acc)

``submit``/``drain`` packs shape-compatible queries into ONE kernel
launch per epoch. ``bytes_touched`` counts only genuine host<->device
transfers, so a resident chain's ledger shows exactly the data-movement
win the paper is about. Spilled operands (LRU eviction under
``capacity_bytes``) fault back in transparently at eval time; the
re-upload is charged to the call.

The reference's DRAM-model runtime (``"ambit_sim"``: ``PimStore`` on one
device, ``PimCluster`` sharding, fault injection and TMR protection) is not
ported yet (ROADMAP queue 1 item 9); the DRAM model itself and the
engine's ``"ambit_sim"`` backend are (``core/simulator.py``,
``core/engine.py``).
"""

from __future__ import annotations

from typing import Dict, Optional

from ..core import expr as E
from ..core.bitvector import BitVector
from ..core.engine import OpStats, binop_expr, check_backend
from ..obs import NULL_TRACER, MetricsRegistry, Tracer
from .device_store import DeviceBitVector, DevicePlanner, DeviceStore
from .scheduler import AsyncScheduler, DrainReport, Ticket


class AmbitRuntime:
    """Session API over the accelerator-resident ``DeviceStore``:
    ``backend="cuda"`` runs the hand-written kernels, ``"torch"`` plain
    tensor code. Operands live as int32 tensors on ``device`` (default:
    the card; pass ``device="cpu"`` to run on the CPU), whole expressions
    run as one fused launch, and ``capacity_bytes`` bounds device memory
    (LRU spill to host)."""

    def __init__(self, backend: str = "cuda", device=None,
                 capacity_bytes: Optional[int] = None,
                 pin_budget_bytes: Optional[int] = None,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None):
        check_backend(backend)
        self.backend = backend
        self.store = DeviceStore(backend=backend, device=device,
                                 capacity_bytes=capacity_bytes)
        self.device = self.store.device
        self.planner = DevicePlanner(self.store)
        self._handle_type = DeviceBitVector
        self.store.pin_budget_bytes = pin_budget_bytes
        self.scheduler = AsyncScheduler(self.store, self.planner,
                                        self._handle_type)
        self.session_stats = OpStats()
        self.last_stats: Optional[OpStats] = None
        # Observability: the store owns the session's MetricsRegistry
        # (its IO sites charge it unconditionally - see
        # LruSpillBase._charge_io); a caller-supplied registry replaces
        # it, and a live tracer is threaded through every layer.
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if metrics is not None:
            self.store.metrics = metrics
        self.metrics = self.store.metrics
        self.store.tracer = self.tracer
        self.reliability = None         # the ambit_sim reliability layer
        # Session-simulated clock: advanced by every call's modeled ns.
        self.clock_ns = 0.0

    # -- lifecycle -----------------------------------------------------------

    def put(self, bv: BitVector, name: Optional[str] = None,
            near=None, pin: bool = False):
        """Upload a bitvector (``near`` is accepted for API compatibility
        with the DRAM-model runtime; the accelerator has no placement)."""
        up0 = self.store.bytes_to_device
        rd0 = self.store.bytes_from_device
        rbv = self.store.put(bv, near=near, name=name, pin=pin)
        # Upload bytes plus read-backs of dirty victims a full device
        # LRU-spilled to make room: all this call's traffic.
        self._account(OpStats(
            bytes_touched=(self.store.bytes_to_device - up0)
            + (self.store.bytes_from_device - rd0)))
        return rbv

    def get(self, rbv) -> BitVector:
        before = self.store.bytes_from_device
        out = self.store.get(rbv)
        # Only what actually crossed the channel (zero for clean/spilled
        # handles).
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
        the result into an existing handle in place (when the destination
        is an operand holding a store-created tensor, the kernel writes
        the result straight into that tensor)."""
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
        for v in operands:
            self.store.ensure_resident(v, protect=operands)
        kwargs = {}
        if out is not None and any(v is out for v in operands):
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
        """Execute every queued query, one launch per epoch. Returns the
        tickets in submit order; the drain's combined cost lands in
        ``last_stats`` / ``session_stats``. ``now_ns``/``epoch_cost`` lay
        the epochs on a simulated clock (per-ticket ``started_ns`` /
        ``finished_ns``) for serving frontends. ``refresh=True`` is a
        no-op here (no DRAM timing model); ``optimize=True`` raises until
        the query optimizer is ported - see ``AsyncScheduler.drain``."""
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
        """Count the set bits of a resident bitvector. The reduction runs
        device-side and only the total crosses the channel -
        ``bytes_touched`` charges 4 bytes, not the whole array."""
        before = self.store.bytes_from_device
        count = self.store.popcount(rbv)
        self._account(OpStats(
            bytes_touched=self.store.bytes_from_device - before))
        return count

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
