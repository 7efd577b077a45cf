"""Continuous-batching query frontend over ``AmbitRuntime.submit/drain``.

PRs 4-5 built the batch substrate - tickets, epoch packing, fused
stacked dispatch - but nothing *drove* it under load. ``QueryFrontend``
is the serving layer a deployment would run: many tenants submit bulk
bitwise queries, an admission queue applies per-tenant quotas, and a
batching window collects admitted queries until it either fills
(``max_batch`` queries - the epoch-packing sweet spot) or a deadline
expires (``window_ns`` on the simulated clock) - the continuous-batching
idiom from LLM serving, applied to in-DRAM analytics.

Everything is measured, nothing is wall clock:

  * the simulated clock advances by the scheduler's **drain timeline** -
    epochs laid end to end, each costing its measured DRAM-model ns
    (``ambit_sim``) or the reference's deterministic epoch-cost model
    over measured bytes (``roofline_epoch_cost``: the accelerator
    store's DRAM ledger is zero by design);
  * per-query latency = completion time minus *arrival* time on that
    clock, so it includes backlog wait (quota), window wait (batching)
    and execution (epoch packing);
  * ``report()`` derives p50/p99/mean latency and queries/sec from the
    recorded timestamps - the ledgers are the ground truth, so the
    numbers are bit-reproducible across machines (CI diffs them).

Per-tenant state: ``TenantQuota.max_inflight`` caps how many of a
tenant's queries may be admitted-but-unfinished (admission skips
over-quota tenants WITHOUT blocking the queue behind them - a greedy
tenant cannot starve the rest), and ``TenantQuota.pin_bytes`` budgets
the tenant's pinned working set (``pin_working_set``), layered on the
store-level ``pin_budget_bytes`` cap.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from ..core import expr as E
from ..core.engine import OpStats
from ..core.simulator import AmbitError
from ..obs import NULL_TRACER, MetricsRegistry
from ..pim.scheduler import DONE, EpochReport, Ticket


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Admission-control knobs for one tenant."""

    max_inflight: int = 4       # admitted-but-unfinished query cap
    pin_bytes: int = 0          # pinned working-set budget
    #: per-query deadline on the simulated clock (None = none). A
    #: backlogged query already past its deadline is rejected at
    #: admission (error result, never executed); one that finishes past
    #: it is delivered but flagged ``timed_out``.
    deadline_ns: Optional[float] = None


@dataclasses.dataclass(eq=False)
class QueryRecord:
    """One query's life through the frontend, on the simulated clock:
    arrival (submit call) -> admission (quota passed, ticket created) ->
    finish (its drain epoch completed)."""

    seq: int
    tenant: str
    expression: E.Expr
    env: Dict[str, object]
    arrival_ns: float
    admitted_ns: float = -1.0
    finished_ns: float = -1.0
    ticket: Optional[Ticket] = None
    result: Optional[object] = None
    # Reliability surface: unrecoverable faults land here as an error
    # string (result stays None unless the host fallback served it);
    # ``fallback`` marks results computed on the host after the PIM
    # path failed; ``timed_out`` marks deadline misses.
    error: Optional[str] = None
    timed_out: bool = False
    fallback: bool = False

    @property
    def ok(self) -> bool:
        """The query produced a result (PIM path or host fallback)."""
        return self.error is None

    @property
    def latency_ns(self) -> float:
        """Arrival-to-completion, including backlog + window wait."""
        return self.finished_ns - self.arrival_ns

    @property
    def queue_ns(self) -> float:
        """Backlog wait before admission (quota / window pressure)."""
        return self.admitted_ns - self.arrival_ns

    def __repr__(self):
        return (f"<QueryRecord #{self.seq} {self.tenant!r} "
                f"lat={self.latency_ns:.0f}ns>")


@dataclasses.dataclass
class ServingReport:
    """Ledger-derived serving metrics. Latency percentiles use the
    nearest-rank definition over completed queries' arrival-to-completion
    times on the simulated clock; ``qps`` is completed queries divided by
    the clock span from first arrival to last completion."""

    completed: int = 0
    drains: int = 0
    fill_drains: int = 0        # window filled (max_batch admitted)
    deadline_drains: int = 0    # window_ns expired on the oldest query
    flush_drains: int = 0       # explicit flush() at end of load
    epochs: int = 0
    span_ns: float = 0.0
    qps: float = 0.0
    p50_ns: float = 0.0
    p99_ns: float = 0.0
    mean_ns: float = 0.0
    max_ns: float = 0.0
    stats: OpStats = dataclasses.field(default_factory=OpStats)
    # Reliability: queries surfaced as errors (unrecoverable faults /
    # admission-time deadline rejections), deadline misses, and queries
    # served by the host (jnp) fallback after the PIM path failed.
    errors: int = 0
    timeouts: int = 0
    fallbacks: int = 0


def _nearest_rank(sorted_vals: List[float], p: float) -> float:
    if not sorted_vals:
        return 0.0
    k = min(len(sorted_vals) - 1,
            max(0, math.ceil(p * len(sorted_vals)) - 1))
    return sorted_vals[k]


def roofline_epoch_cost(launch_ns: float = 2_000.0,
                        bytes_per_ns: float = 819.0) -> Callable:
    """Deterministic epoch-cost model for the accelerator backends,
    whose DRAM-model ledger is zero by design (device_store.py): each
    epoch is ONE kernel launch (the DevicePlanner contract), so it costs
    a fixed launch overhead plus a streaming time for the bytes it
    touches - every distinct operand tensor once, plus each query's
    result. The defaults are the reference model's constants, kept so
    that the simulated-clock tokens (latency percentiles, queries/s on
    that clock) equal the reference's bit for bit. They are not a
    property of the GPU this runs on, and no statement about the card is
    derived from them. Built from handle sizes, not wall clock, so the
    serving numbers stay machine-independent."""

    def cost(erep: EpochReport, tickets: List[Ticket]) -> float:
        seen, nbytes = set(), 0
        for t in tickets:
            for nm in sorted(t.env):
                v = t.env[nm]
                h = v.result if isinstance(v, Ticket) else v
                if h is not None and id(h) not in seen:
                    seen.add(id(h))
                    nbytes += h.device_bytes
            if t.result is not None and id(t.result) not in seen:
                seen.add(id(t.result))
                nbytes += t.result.device_bytes
        return launch_ns + nbytes / bytes_per_ns

    return cost


class QueryFrontend:
    """Admission queue + batching window over one AmbitRuntime.

    ``submit()`` never executes anything by itself: queries join the
    backlog, admission moves them into the current batching window
    (scheduler tickets) as quotas allow, and the window drains when it
    fills (``max_batch``) or its oldest admitted query has waited
    ``window_ns`` on the simulated clock. ``take_completed()`` hands
    finished queries back; ``flush()`` force-drains at end of load.
    Under the runtime's tracer's host spans (``obs.tracer``) each of
    these calls, and each window drain (``frontend.drain``: its reason
    and the queries' ``seq``), also times itself on the host's clock."""

    def __init__(self, runtime, window_ns: float = 50_000.0,
                 max_batch: int = 16,
                 default_quota: TenantQuota = TenantQuota(),
                 quotas: Optional[Dict[str, TenantQuota]] = None,
                 epoch_cost: Optional[Callable] = None,
                 optimize: bool = False):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.runtime = runtime
        self.window_ns = float(window_ns)
        self.max_batch = int(max_batch)
        # optimize=True routes every window drain through the scheduler's
        # cost-based optimizer (CSE + result cache); cache hits are
        # attributed per tenant on the shared opt_cache_hits counter.
        self.optimize = bool(optimize)
        self.default_quota = default_quota
        self.quotas = dict(quotas or {})
        if epoch_cost is None and \
                getattr(runtime, "backend", "ambit_sim") != "ambit_sim":
            epoch_cost = roofline_epoch_cost()
        self._epoch_cost = epoch_cost
        self._host_engine = None    # lazy fallback engine
        self.clock_ns = 0.0
        self._first_arrival_ns: Optional[float] = None
        self._seq = 0
        self.backlog: deque = deque()       # arrived, not yet admitted
        self.window: List[QueryRecord] = []  # admitted, not yet drained
        self.completed: List[QueryRecord] = []
        self._inflight: Dict[str, int] = {}
        self._tenant_pinned: Dict[str, int] = {}
        self.report_counters = ServingReport()
        # Observability: share the runtime's registry/tracer so serving
        # series (admissions, quota skips, the latency histogram that
        # p50/p99 are views over) land next to the store/scheduler ones.
        self.metrics = getattr(runtime, "metrics", None)
        if self.metrics is None:
            self.metrics = MetricsRegistry()
        self.tracer = getattr(runtime, "tracer", NULL_TRACER)

    # -- quotas / pinned working sets -----------------------------------------

    def quota(self, tenant: str) -> TenantQuota:
        return self.quotas.get(tenant, self.default_quota)

    def inflight(self, tenant: str) -> int:
        return self._inflight.get(tenant, 0)

    def pin_working_set(self, tenant: str, handles: Iterable) -> int:
        """Pin a tenant's hot operands against BOTH budgets: the
        tenant's ``TenantQuota.pin_bytes`` and the store's global
        ``pin_budget_bytes``. All-or-nothing; returns bytes pinned."""
        handles = list(handles)
        budget = self.quota(tenant).pin_bytes
        used = self._tenant_pinned.get(tenant, 0)
        pinned: List[object] = []
        try:
            for h in handles:
                if used + h.device_bytes > budget:
                    raise AmbitError(
                        f"tenant {tenant!r} pin budget exceeded: "
                        f"{used} B pinned + {h.device_bytes} B would "
                        f"pass {budget} B")
                self.runtime.pin(h)     # store-level budget checks here
                pinned.append(h)
                used += h.device_bytes
        except AmbitError:
            for h in pinned:
                self.runtime.unpin(h)
            raise
        self._tenant_pinned[tenant] = used
        return sum(h.device_bytes for h in pinned)

    def unpin_working_set(self, tenant: str, handles: Iterable) -> None:
        for h in handles:
            self.runtime.unpin(h)
            self._tenant_pinned[tenant] = max(
                0, self._tenant_pinned.get(tenant, 0) - h.device_bytes)

    # -- submission / clock ----------------------------------------------------

    def submit(self, tenant: str, expression: E.Expr,
               env: Dict[str, object],
               arrival_ns: Optional[float] = None) -> QueryRecord:
        """Enqueue one query for ``tenant``. ``arrival_ns`` places the
        arrival on the simulated clock (defaults to "now"); the clock
        never runs backwards."""
        with self.tracer.host_span("frontend.submit", query=self._seq):
            if arrival_ns is not None:
                self.clock_ns = max(self.clock_ns, float(arrival_ns))
            q = QueryRecord(seq=self._seq, tenant=tenant,
                            expression=expression, env=env,
                            arrival_ns=self.clock_ns if arrival_ns is None
                            else float(arrival_ns))
            self._seq += 1
            if self._first_arrival_ns is None:
                self._first_arrival_ns = q.arrival_ns
            self.backlog.append(q)
            self.metrics.counter("serve_submitted").inc(1, tenant=tenant)
            if self.tracer.enabled:
                self.tracer.instant(("frontend",), "arrive", "serve",
                                    ts_ns=q.arrival_ns,
                                    args={"tenant": tenant, "seq": q.seq})
            self._pump()
        return q

    def tick(self, now_ns: float) -> None:
        """Advance the simulated clock (e.g. between sparse arrivals) and
        fire any deadline drain that became due."""
        with self.tracer.host_span("frontend.tick"):
            self.clock_ns = max(self.clock_ns, float(now_ns))
            self._pump()

    def take_completed(self) -> List[QueryRecord]:
        with self.tracer.host_span("frontend.take_completed"):
            done, self.completed = self.completed, []
        return done

    def flush(self) -> None:
        """Drain until no query is backlogged or windowed (end of load)."""
        with self.tracer.host_span("frontend.flush"):
            while self.window or self.backlog:
                if not self.window:
                    self._admit()
                    if not self.window:     # every backlogged tenant over
                        break               # quota with nothing in flight:
                self._drain("flush")        # impossible, but don't spin
                self._pump()

    # -- the batching window ---------------------------------------------------

    def _pump(self) -> None:
        """Admit from the backlog and drain the window until quiescent:
        fill drains when ``max_batch`` queries are admitted, deadline
        drains when the oldest admitted query has waited ``window_ns``."""
        while True:
            self._admit()
            if len(self.window) >= self.max_batch:
                self._drain("fill")
                continue
            if self.window and self.clock_ns - min(
                    q.admitted_ns for q in self.window) >= self.window_ns:
                self._drain("deadline")
                continue
            return

    def _admit(self) -> None:
        """FIFO admission with quota skips: walk the backlog in arrival
        order, admitting every query whose tenant is under its
        ``max_inflight`` quota until the window is full. Over-quota
        tenants are skipped, NOT blocked on - later tenants' queries
        admit past them, so one greedy tenant cannot starve the rest."""
        if len(self.window) >= self.max_batch:
            return
        keep: deque = deque()
        while self.backlog and len(self.window) < self.max_batch:
            q = self.backlog.popleft()
            ddl = self.quota(q.tenant).deadline_ns
            if ddl is not None and self.clock_ns - q.arrival_ns >= ddl:
                # Already overdue while backlogged: reject instead of
                # burning DRAM work on an answer nobody will take.
                q.error = (f"deadline exceeded in backlog "
                           f"({self.clock_ns - q.arrival_ns:.0f}ns "
                           f">= {ddl:.0f}ns)")
                q.timed_out = True
                q.admitted_ns = self.clock_ns
                q.finished_ns = self.clock_ns
                self.report_counters.timeouts += 1
                self.report_counters.errors += 1
                self.metrics.counter("serve_timeouts").inc(
                    1, tenant=q.tenant)
                self.metrics.counter("serve_errors").inc(1, tenant=q.tenant)
                if self.tracer.enabled:
                    self.tracer.instant(("frontend",), "timeout", "serve",
                                        ts_ns=self.clock_ns,
                                        args={"tenant": q.tenant,
                                              "seq": q.seq})
                self.completed.append(q)
                continue
            if self.inflight(q.tenant) >= self.quota(q.tenant).max_inflight:
                keep.append(q)          # over quota: skip, don't block
                self.metrics.counter("serve_quota_skips").inc(
                    1, tenant=q.tenant)
                if self.tracer.enabled:
                    self.tracer.instant(("frontend",), "quota_skip",
                                        "serve", ts_ns=self.clock_ns,
                                        args={"tenant": q.tenant,
                                              "seq": q.seq})
                continue
            q.ticket = self.runtime.submit(q.expression, q.env,
                                           now_ns=self.clock_ns)
            q.admitted_ns = self.clock_ns
            self._inflight[q.tenant] = self.inflight(q.tenant) + 1
            self.window.append(q)
            self.metrics.counter("serve_admitted").inc(1, tenant=q.tenant)
            if self.tracer.enabled:
                self.tracer.instant(("frontend",), "admit", "serve",
                                    ts_ns=self.clock_ns,
                                    args={"tenant": q.tenant,
                                          "seq": q.seq})
        keep.extend(self.backlog)
        self.backlog = keep

    def _drain(self, reason: str) -> None:
        group, self.window = self.window, []
        tr = self.tracer
        with tr.host_span("frontend.drain", reason=reason,
                          queries=[q.seq for q in group]
                          if tr.host_enabled else None):
            self._drain_group(group, reason)

    def _drain_group(self, group: List[QueryRecord], reason: str) -> None:
        start_ns = self.clock_ns
        self.runtime.drain(now_ns=self.clock_ns,
                           epoch_cost=self._epoch_cost,
                           optimize=self.optimize)
        rep = self.runtime.last_drain
        self.clock_ns = rep.end_ns
        rc = self.report_counters
        rc.drains += 1
        rc.epochs += len(rep.epochs)
        if reason == "fill":
            rc.fill_drains += 1
        elif reason == "deadline":
            rc.deadline_drains += 1
        else:
            rc.flush_drains += 1
        rc.stats += rep.stats
        lat_hist = self.metrics.histogram("serve_latency_ns")
        queue_hist = self.metrics.histogram("serve_queue_ns")
        for q in group:
            tk = q.ticket
            q.finished_ns = tk.finished_ns if tk.finished_ns >= 0.0 \
                else rep.end_ns
            self._inflight[q.tenant] = max(0, self.inflight(q.tenant) - 1)
            if tk.state == DONE:
                q.result = tk.result
                if tk.cache_hit:
                    # per-tenant attribution on the shared optimizer
                    # counter (total() stays the cross-tenant hit count)
                    self.metrics.counter("opt_cache_hits").inc(
                        1, tenant=q.tenant)
            elif not self._try_host_fallback(q):
                # PIM path unrecoverable and the host can't serve it:
                # surface the fault as an error result, never a crash.
                q.error = tk.error or f"ticket {tk.state}"
                rc.errors += 1
                self.metrics.counter("serve_errors").inc(1, tenant=q.tenant)
            ddl = self.quota(q.tenant).deadline_ns
            if ddl is not None and q.error is None \
                    and q.latency_ns > ddl:
                q.timed_out = True      # delivered, but past deadline
                rc.timeouts += 1
                self.metrics.counter("serve_timeouts").inc(
                    1, tenant=q.tenant)
            if q.error is None:
                lat_hist.observe(q.latency_ns)
                queue_hist.observe(q.queue_ns)
                rc.completed += 1
                self.metrics.counter("serve_completed").inc(
                    1, tenant=q.tenant)
            self.completed.append(q)
        self.metrics.counter("serve_drains").inc(1, reason=reason)
        self.metrics.counter("serve_batched_queries").inc(len(group))
        if self.tracer.enabled:
            self.tracer.span(("frontend",), f"drain:{reason}", "serve",
                             start_ns, rep.end_ns - start_ns,
                             args={"queries": len(group),
                                   "epochs": len(rep.epochs)})

    def _try_host_fallback(self, q: QueryRecord) -> bool:
        """Degraded-mode execution: when the PIM path failed, re-run the
        query on the host engine from the operands' host copies. Only
        possible for unprotected handles whose data still exists - a lost
        handle (the failed device held the only copy) or a broken ticket
        dependency cannot be served. Billed honestly: reading a
        device-resident dirty operand back is a normal charged ``get``.
        The engine is ``BulkBitwiseEngine("cuda")`` on the device the
        session's rows live on: the ``fused_bitwise`` kernel on the card,
        its plain version on the CPU."""
        env: Dict[str, object] = {}
        try:
            for nm in sorted(q.env):
                v = q.env[nm]
                if isinstance(v, Ticket):
                    return False    # upstream ticket failed with it
                if getattr(v, "lost", False):
                    return False    # the data died with its device
                env[nm] = self.runtime.get(v)
            if self._host_engine is None:
                from ..core.engine import BulkBitwiseEngine
                self._host_engine = BulkBitwiseEngine(
                    "cuda", device=self.runtime.tensor_device)
            q.result = self._host_engine.eval(q.expression, env)
        except AmbitError:
            return False
        q.fallback = True
        self.report_counters.fallbacks += 1
        self.metrics.counter("serve_host_fallbacks").inc(1, tenant=q.tenant)
        if self.tracer.enabled:
            self.tracer.instant(("frontend",), "host_fallback", "serve",
                                ts_ns=self.clock_ns,
                                args={"tenant": q.tenant, "seq": q.seq})
        return True

    # -- metrics ---------------------------------------------------------------

    def report(self) -> ServingReport:
        """Snapshot of the serving metrics so far, derived entirely from
        the recorded simulated-clock timestamps (see module docstring)."""
        rc = self.report_counters
        out = dataclasses.replace(rc, stats=OpStats())
        out.stats += rc.stats
        # p50/p99 are *views* over the shared registry's latency
        # histogram; with 0 completions everything degrades to 0.0 (and
        # the snapshot reports None, never NaN) - see metrics_snapshot().
        lat = sorted(self.metrics.histogram("serve_latency_ns").values())
        out.p50_ns = _nearest_rank(lat, 0.50)
        out.p99_ns = _nearest_rank(lat, 0.99)
        out.mean_ns = sum(lat) / len(lat) if lat else 0.0
        out.max_ns = lat[-1] if lat else 0.0
        t0 = self._first_arrival_ns or 0.0
        out.span_ns = max(0.0, self.clock_ns - t0)
        out.qps = (out.completed / out.span_ns * 1e9
                   if out.span_ns > 0 else 0.0)
        return out

    def metrics_snapshot(self) -> Dict[str, object]:
        """JSON-safe snapshot of the shared registry plus the derived
        serving view. Percentiles over 0 completions are ``None`` (JSON
        null) - never NaN, never an exception - so downstream tooling can
        serialize with ``allow_nan=False``."""
        lat = self.metrics.histogram("serve_latency_ns")
        rep = self.report()
        snap = self.metrics.snapshot()
        snap["serving"] = {
            "completed": rep.completed,
            "drains": rep.drains,
            "epochs": rep.epochs,
            "span_ns": rep.span_ns,
            "qps": rep.qps,
            "p50_ns": lat.percentile(0.50),
            "p99_ns": lat.percentile(0.99),
            "mean_ns": rep.mean_ns if lat.count() else None,
            "max_ns": rep.max_ns if lat.count() else None,
            "errors": rep.errors,
            "timeouts": rep.timeouts,
            "fallbacks": rep.fallbacks,
        }
        return snap


def run_closed_loop(frontend: QueryFrontend, tenants: List[str],
                    next_query: Callable[[str, int],
                                         Tuple[E.Expr, Dict[str, object]]],
                    total_queries: int,
                    on_complete: Optional[Callable[[QueryRecord],
                                                   None]] = None) -> int:
    """Closed-loop load generator: every tenant keeps exactly one query
    outstanding - its next arrival is scheduled at the simulated instant
    its previous query finished (the standard closed-loop workload
    model, so offered load adapts to measured service rate instead of
    assuming one). ``next_query(tenant, k)`` supplies tenant's k-th
    query as ``(expression, env)``; issuance stops after
    ``total_queries`` and the frontend is flushed. Returns the number of
    completed queries observed."""
    import heapq

    heap = [(0.0, i, t) for i, t in enumerate(tenants)]
    heapq.heapify(heap)
    order = len(tenants)
    issued = 0
    seen = 0
    per_tenant: Dict[str, int] = {}

    def collect(resubmit: bool) -> None:
        nonlocal order, seen
        for done in frontend.take_completed():
            seen += 1
            if on_complete is not None:
                on_complete(done)
            if resubmit:
                heapq.heappush(heap, (done.finished_ns, order, done.tenant))
                order += 1

    while heap and issued < total_queries:
        ready_ns, _, tenant = heapq.heappop(heap)
        k = per_tenant.get(tenant, 0)
        expression, env = next_query(tenant, k)
        per_tenant[tenant] = k + 1
        frontend.submit(tenant, expression, env, arrival_ns=ready_ns)
        issued += 1
        collect(resubmit=issued < total_queries)
    frontend.flush()
    collect(resubmit=False)
    return seen
