"""AsyncScheduler: overlap independent queries across banks and devices.

The paper's core claim is internal parallelism - every bank (and, one
level up, every device of a cluster) can run a bbop concurrently - yet
``QueryPlanner.execute`` serves ONE query at a time: it already reports
max-over-banks time *within* a query, but a second user's session waits
for the first. The scheduler converts the runtime to a queued execution
model that overlaps independent sessions:

  * ``submit(expr, env)`` enqueues a query and returns a ``Ticket``.
    Operands are *held* from the moment they are queued: the LRU spiller
    prefers any unheld victim and ``free`` refuses them, so a
    queued-but-not-executed operand is never evicted while anything else
    can make room (under genuine capacity pressure the coldest queued
    operand spills last-resort and faults back in when its query runs,
    charged to that query's ticket). Environment
    values may be other tickets (multi-root DAGs: a later query consumes
    an earlier query's result without a drain in between), and ``out=``
    rebinds the result into an existing handle in place.

  * ``drain()`` packs the queue into **epochs** by the ``(device, bank)``
    resources each query's operands occupy: queries touching disjoint
    banks land in the same epoch and run concurrently, so epoch time is
    the max over resources of the time charged to each resource - not the
    sum over queries. Conflicts force later epochs: overlapping bank
    footprints (a bank runs one bbop at a time), reading a handle an
    earlier query writes, and two queries writing the same destination
    handle never share an epoch; submit order is the deterministic
    tiebreak throughout (greedy first-fit in ticket order, no hash-order
    iteration anywhere).

Accounting is conservation-exact: queries execute in submit order under
the hood (epochs are a packing/accounting construct, never a reorder),
so summed energy and AAP counts are *identical* to serial ``eval`` of the
same queries, results are bit-identical, and reported time is the sum of
epoch maxima - always <= the serial sum, with equality when every query
contends for one bank. Cross-device channel transfers serialize within
an epoch (their ns adds on top of the epoch's compute max), and a
spilled operand faulting back in during ``drain`` is charged to that
query's ticket stats.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..core import expr as E
from ..core.engine import OpStats
from ..core.simulator import AmbitError
from ..core.timing import refresh_schedule
from .faults import FaultError

Resource = Tuple[int, int]          # (device index, bank index)

QUEUED = "queued"
DONE = "done"
FAILED = "failed"
CANCELLED = "cancelled"


@dataclasses.dataclass(eq=False)
class Ticket:
    """One submitted query. ``result`` and ``stats`` are populated by the
    drain that executes it; ``epoch`` is its position in the drain's
    epoch schedule. Tickets order (and resolve ties) by ``index``, the
    global submit sequence number."""

    scheduler: "AsyncScheduler"
    index: int
    expression: E.Expr
    env: Dict[str, object]          # name -> handle or Ticket
    out: Optional[object] = None    # existing handle to rebind in place
    out_name: Optional[str] = None
    state: str = QUEUED
    epoch: int = -1
    result: Optional[object] = None
    stats: OpStats = dataclasses.field(default_factory=OpStats)
    # per-resource ns this query charged, measured from the planner's
    # per-bank ledger deltas (keys normalized to (device, bank))
    resource_ns: Dict[Resource, float] = dataclasses.field(
        default_factory=dict)
    channel_ns: float = 0.0         # serialized cross-device transfer time
    # Simulated-clock timestamps (serving frontends): ``submitted_ns`` is
    # the ``now_ns`` the query was enqueued at; ``started_ns`` /
    # ``finished_ns`` are assigned by the drain that executes it from the
    # cumulative epoch timeline (measured epoch ns, or the drain's
    # ``epoch_cost`` model). -1.0 until the drain runs.
    submitted_ns: float = 0.0
    started_ns: float = -1.0
    finished_ns: float = -1.0
    # Optimizer provenance (drain(optimize=True)): the expression as
    # submitted when the pass rewrote it, whether this ticket is a
    # synthetic scratch materialization of a shared subtree, and whether
    # it was served from the result cache without executing.
    rewritten_from: Optional[E.Expr] = None
    synthetic: bool = False
    cache_hit: bool = False
    # Reliability (repro.pim.faults): a ticket whose recovery failed
    # lands in FAILED (or CANCELLED when a dependency failed) with the
    # fault message in ``error`` instead of crashing the drain;
    # ``retries``/``backoff_ns`` bill the recovery attempts the
    # reliability layer spent on it (backoff stretches the drain
    # timeline, never the conservation-exact work ledgers).
    error: Optional[str] = None
    retries: int = 0
    backoff_ns: float = 0.0
    # Why this query did not land in epoch 0: the packing constraints
    # that bound it (recorded by ``_form_epochs``). Each entry is one of
    # ``dep:#N`` (reads ticket N's result), ``read-after-write:<name>``,
    # ``write-conflict`` (out= destination clash), ``bank-conflict``
    # (resource overlap with an earlier epoch), ``stack-shape`` (epoch
    # key mismatch on a stacking backend). Empty = ran in the first
    # epoch it was eligible for with nothing in its way.
    deferred: List[str] = dataclasses.field(default_factory=list)

    @property
    def queue_ns(self) -> float:
        """Time spent queued before its epoch started."""
        return self.started_ns - self.submitted_ns

    @property
    def latency_ns(self) -> float:
        """Submit-to-completion time on the drain's simulated clock."""
        return self.finished_ns - self.submitted_ns

    def __repr__(self):
        return (f"<Ticket #{self.index} {self.state}"
                f"{f' epoch={self.epoch}' if self.epoch >= 0 else ''}>")


@dataclasses.dataclass
class EpochReport:
    """One epoch of a drain: the tickets that shared it, the resources
    they claimed, and the epoch's critical-path time (max over resources
    of summed per-resource ns, plus serialized channel transfers)."""

    tickets: List[int] = dataclasses.field(default_factory=list)
    resources: List[Resource] = dataclasses.field(default_factory=list)
    ns: float = 0.0
    channel_ns: float = 0.0
    # Position on the drain's simulated clock: [start_ns, end_ns) where
    # end - start is the measured epoch ns, or the caller's epoch_cost
    # model when the backend has no DRAM timing (accelerator stores).
    start_ns: float = 0.0
    end_ns: float = 0.0
    # Refresh stall inside this epoch's [start_ns, end_ns) interval -
    # nonzero only under ``drain(refresh=True)``, where end - start =
    # work + refresh_ns (the epoch paused through refresh windows).
    refresh_ns: float = 0.0


@dataclasses.dataclass
class DrainReport:
    """What one drain did. ``stats.ns`` is the sum of epoch maxima;
    energy/AAPs/bytes are plain sums over the drained tickets (identical
    to serial evaluation by construction). ``serial_ns`` is what the same
    queries would have reported executed one eval at a time.

    ``stats.refresh_stolen_ns`` is the tickets' steady-state refresh tax
    (planner ledger, always on); ``refresh_stall_ns`` is the event-level
    stall the timeline actually absorbed, nonzero only under
    ``drain(refresh=True)`` (= sum of epoch ``refresh_ns``)."""

    epochs: List[EpochReport] = dataclasses.field(default_factory=list)
    stats: OpStats = dataclasses.field(default_factory=OpStats)
    serial_ns: float = 0.0
    # Total bank-busy time: the sum of every drained ticket's summed
    # per-resource ns. Unlike ``stats.ns`` (epoch maxima) or
    # ``serial_ns`` (per-ticket maxima), this is pure work with no
    # packing artifacts - the quantity the optimizer conserves.
    busy_ns: float = 0.0
    start_ns: float = 0.0           # the drain's ``now_ns``
    end_ns: float = 0.0             # clock after the last epoch
    refresh_stall_ns: float = 0.0
    # The optimizer's OptReport when this drain ran with optimize=True
    # (None otherwise): CSE/cache hit counts, placement skips and the
    # cost-model savings estimate for this drain.
    opt: Optional[object] = None

    @property
    def n_queries(self) -> int:
        return sum(len(e.tickets) for e in self.epochs)

    @property
    def wall_ns(self) -> float:
        """Simulated wall time the drain occupied the device for."""
        return self.end_ns - self.start_ns


class AsyncScheduler:
    """Submit/drain queue over one PimStore+QueryPlanner (single device)
    or PimCluster+ClusterPlanner (sharded) pair."""

    def __init__(self, store, planner, handle_type):
        self.store = store
        self.planner = planner
        self._handle_type = handle_type
        self.pending: List[Ticket] = []
        self.drains = 0
        self.last_drain: Optional[DrainReport] = None
        self._submitted = 0
        self._optimizer = None
        # Set by the runtime when fault injection is configured: ticket
        # execution routes through ReliabilityManager.execute_ticket
        # (bounded retry, quarantine, TMR scrub) instead of _execute_plain.
        self.reliability = None
        # DRAM timing of the backing device(s): drives the refresh-aware
        # drain timeline. None on accelerator stores (no DRAM model - a
        # ``refresh=True`` drain degrades to the plain timeline there).
        dev = getattr(store, "device", None)
        if dev is not None and hasattr(dev, "timing"):
            self._timing = dev.timing
        else:
            devs = getattr(store, "devices", None) or ()
            self._timing = devs[0].timing if len(devs) else None

    @property
    def optimizer(self):
        """The drain-time query optimizer (created lazily on first use;
        its result cache persists across drains)."""
        if self._optimizer is None:
            from .optimizer import QueryOptimizer
            self._optimizer = QueryOptimizer(self)
        return self._optimizer

    # -- submission ----------------------------------------------------------

    def submit(self, expression: E.Expr, env: Dict[str, object],
               out=None, out_name: Optional[str] = None,
               now_ns: float = 0.0) -> Ticket:
        """Enqueue a query; returns its Ticket. Operands may be resident
        handles or tickets of earlier-submitted queries (their result is
        consumed without an intermediate drain). All operands are held -
        protected from eviction and free - until the query executes.
        ``now_ns`` stamps the ticket's submit time on the caller's
        simulated clock (serving frontends measure queueing delay from
        it)."""
        if not env:
            raise ValueError("scheduler needs at least one operand")
        resolved: Dict[str, object] = {}
        held: List[object] = []     # rollback on validation failure
        try:
            for nm in sorted(env):
                v = env[nm]
                if isinstance(v, Ticket):
                    if v.scheduler is not self:
                        raise AmbitError(
                            f"operand {nm!r} is a ticket of another "
                            "scheduler")
                    if v.state == DONE:  # earlier drain: use the result
                        v = v.result
                    elif v.state != QUEUED:
                        raise AmbitError(
                            f"operand {nm!r} is a {v.state} ticket")
                if isinstance(v, Ticket):
                    resolved[nm] = v
                elif isinstance(v, self._handle_type):
                    self.store._check_handle(v)
                    self.store.hold(v)
                    held.append(v)
                    resolved[nm] = v
                else:
                    raise TypeError(
                        f"operand {nm!r} is not resident or a ticket - "
                        "call put() first")
            if out is not None:
                if not isinstance(out, self._handle_type):
                    raise TypeError(
                        "out= must be an existing resident handle")
                self.store._check_handle(out)
                self.store.hold(out)
                held.append(out)
        except Exception:
            for h in held:
                self.store.release(h)
            raise
        t = Ticket(scheduler=self, index=self._submitted,
                   expression=expression, env=resolved, out=out,
                   out_name=out_name, submitted_ns=now_ns)
        self._submitted += 1
        self.pending.append(t)
        return t

    def oldest_pending_ns(self) -> Optional[float]:
        """Earliest ``submitted_ns`` among queued tickets (None when the
        queue is empty) - the deadline signal a batching window checks."""
        return min((t.submitted_ns for t in self.pending), default=None)

    def cancel(self, ticket: Ticket) -> None:
        """Drop a queued ticket and release its operand holds. Queries
        already submitted that consume this ticket will fail at drain."""
        if ticket.state != QUEUED or ticket not in self.pending:
            raise AmbitError(f"cannot cancel {ticket!r}")
        self.pending.remove(ticket)
        self._release_ticket_holds(ticket)
        ticket.state = CANCELLED

    def _release_ticket_holds(self, t: Ticket) -> None:
        for nm in sorted(t.env):
            v = t.env[nm]
            if isinstance(v, Ticket):
                if v.state == DONE:     # post-execution result hold
                    self.store.release(v.result)
            else:
                self.store.release(v)
        if t.out is not None:
            self.store.release(t.out)

    # -- footprints ----------------------------------------------------------

    def _footprint(self, t: Ticket,
                   cache: Dict[int, frozenset]) -> frozenset:
        """(device, bank) resources ticket ``t`` will touch. A dependency
        ticket contributes its own footprint (its result is co-located
        with its operands by the planner's destination policy)."""
        if id(t) in cache:
            fp = cache[id(t)]
            if fp is None:      # re-entered while still computing it
                raise AmbitError(
                    f"ticket dependency cycle involving #{t.index} - "
                    "the ticket DAG is corrupted (submit can only "
                    "reference earlier tickets)")
            return fp
        cache[id(t)] = None     # in-progress marker for cycle detection
        res: set = set()
        for nm in sorted(t.env):
            v = t.env[nm]
            if isinstance(v, Ticket):
                res |= self._footprint(v, cache)
            else:
                res |= self.planner.footprint({nm: v})
        if t.out is not None:
            res |= self.planner.footprint({"out": t.out})
        fp = frozenset(res)
        cache[id(t)] = fp
        return fp

    # -- epoch formation ------------------------------------------------------

    def _form_epochs(self, tickets: List[Ticket]) -> List[EpochReport]:
        """Greedy first-fit in submit order (the deterministic tiebreak):
        each ticket lands in the earliest epoch that (a) is after every
        epoch its dependencies and handle conflicts require, (b) has no
        (device, bank) resource overlap with tickets already in it, and
        (c) - when the planner defines a ``stack_key`` (accelerator
        backends dispatch each epoch as ONE stacked kernel) - matches the
        epoch's key, so every epoch is shape-compatible to stack."""
        cache: Dict[int, frozenset] = {}
        epochs: List[EpochReport] = []
        epoch_resources: List[set] = []
        epoch_keys: List[object] = []
        keyer = getattr(self.planner, "stack_key", None)
        this_drain = {id(t): t for t in tickets}
        assigned: Dict[int, int] = {}       # id(ticket) -> epoch
        last_writer: Dict[int, int] = {}    # id(handle) -> epoch
        last_reader: Dict[int, int] = {}
        for t in tickets:
            fp = self._footprint(t, cache)
            key = keyer(t.expression, t.env) if keyer else None
            floor = 0
            why: List[str] = []     # the binding defer reasons

            def bump(new_floor: int, reason: str) -> None:
                nonlocal floor
                if new_floor > floor:
                    floor = new_floor
                    why.clear()
                    why.append(reason)
                elif new_floor == floor and floor > 0 and reason not in why:
                    why.append(reason)

            for nm in sorted(t.env):
                v = t.env[nm]
                if isinstance(v, Ticket):       # result-after-execute
                    if id(v) not in this_drain:
                        raise AmbitError(
                            f"operand {nm!r} of ticket #{t.index} is a "
                            f"{v.state} ticket not part of this drain")
                    if id(v) not in assigned:   # deps precede consumers
                        raise AmbitError(
                            f"operand {nm!r} of ticket #{t.index} "
                            f"(ticket #{v.index}) is not scheduled "
                            "before its consumer - dependency cycle?")
                    bump(assigned[id(v)] + 1, f"dep:#{v.index}")
                else:                           # read-after-write
                    bump(last_writer.get(id(v), -1) + 1,
                         f"read-after-write:{nm}")
            if t.out is not None:
                # never share an epoch with another writer of the same
                # destination, nor with anyone still reading its old value
                bump(last_writer.get(id(t.out), -1) + 1, "write-conflict")
                bump(last_reader.get(id(t.out), -1) + 1, "write-conflict")
            e = floor
            while e < len(epochs) and ((epoch_resources[e] & fp)
                                       or epoch_keys[e] != key):
                why.append("bank-conflict" if (epoch_resources[e] & fp)
                           else "stack-shape")
                e += 1
            t.deferred = why
            if e == len(epochs):
                epochs.append(EpochReport())
                epoch_resources.append(set())
                epoch_keys.append(key)
            epochs[e].tickets.append(t.index)
            epoch_resources[e] |= fp
            assigned[id(t)] = e
            t.epoch = e
            for nm in sorted(t.env):
                v = t.env[nm]
                if isinstance(v, Ticket):
                    # result handles are born inside this drain, so no
                    # pre-existing out= can alias them: the dep's
                    # epoch+1 floor above is the only ordering needed
                    continue
                last_reader[id(v)] = max(last_reader.get(id(v), -1), e)
            if t.out is not None:
                last_writer[id(t.out)] = e
        for e, rep in enumerate(epochs):
            rep.resources = sorted(epoch_resources[e])
        return epochs

    # -- execution ------------------------------------------------------------

    def drain(self, now_ns: float = 0.0, epoch_cost=None,
              refresh: bool = False,
              optimize: bool = False) -> List[Ticket]:
        """Execute every queued query and return the tickets in submit
        order. Execution order IS submit order - epochs only change how
        time is accounted - so energy/AAP ledgers are identical to serial
        evaluation and results are bit-identical.

        ``now_ns`` is the simulated clock the drain starts at; epochs are
        laid end to end from it and every ticket gets ``started_ns`` /
        ``finished_ns`` from its epoch's interval. The interval length is
        the measured epoch ns; ``epoch_cost(erep, tickets) -> ns``
        overrides it for backends whose DRAM-model ns is zero (the
        accelerator stores), WITHOUT touching the conservation-exact
        ``stats`` ledger - the timeline is an overlay, never a
        re-measurement.

        ``refresh=True`` makes the timeline refresh-aware: each epoch
        pauses through the [k*tREFI, k*tREFI + tRFC) refresh windows it
        crosses (timing.refresh_schedule), so wall clock stretches by the
        stall while the measured epoch ns - and with it every
        conservation invariant - is untouched. The absorbed stall lands
        in ``EpochReport.refresh_ns`` / ``DrainReport.refresh_stall_ns``.
        No-op on accelerator stores (no DRAM timing model).

        ``optimize=True`` runs the cost-based query optimizer
        (``pim.optimizer``) between the queue and epoch formation:
        cross-ticket CSE materializes shared subtrees once into
        synthetic scratch tickets, placement-aware gating keeps sharing
        off when moving the shared chunks would cost more than
        recomputing, and repeated read-only queries are served from the
        result cache without executing. Results stay bit-identical to
        ``optimize=False`` and to serial eval (the differential suites
        prove it); the rewritten program never charges more device ops
        than the submitted one. The returned list is always the
        *submitted* tickets in submit order - synthetic scratch tickets
        are internal and their results are freed before drain returns.
        (Distinct from ``AmbitRuntime(optimize=True)``, which toggles
        the single-program AAP peephole inside the planner.)

        Under a tracer's host spans the call is the span
        ``scheduler.drain`` (args: queries, epochs)."""
        submitted, self.pending = self.pending, []
        if not submitted:
            return []
        with self.store.tracer.host_span("scheduler.drain",
                                         queries=len(submitted)) as span:
            out = self._drain(submitted, now_ns, epoch_cost, refresh,
                              optimize)
            span.note(epochs=len(self.last_drain.epochs))
        return out

    def _drain(self, submitted: List[Ticket], now_ns: float, epoch_cost,
               refresh: bool, optimize: bool) -> List[Ticket]:
        if optimize:
            tickets = self.optimizer.rewrite(submitted, now_ns=now_ns)
        else:
            tickets = submitted
        if not tickets:                 # everything served from cache
            report = DrainReport(start_ns=now_ns, end_ns=now_ns,
                                 opt=self.optimizer.last_report)
            self.last_drain = report
            self.drains += 1
            m = self.store.metrics
            m.counter("sched_drains").inc(1)
            m.counter("sched_queries").inc(len(submitted))
            self.optimizer.commit(submitted)
            if self.store.tracer.enabled:
                self._trace_cache_hits(submitted)
            return submitted
        consumers: Dict[int, int] = {}      # id(dep ticket) -> # readers
        for t in tickets:
            for v in t.env.values():
                if isinstance(v, Ticket):
                    consumers[id(v)] = consumers.get(id(v), 0) + 1
        current: Optional[Ticket] = None
        try:
            epochs = self._form_epochs(tickets)
            if hasattr(self.planner, "execute_epoch"):
                # Accelerator backends: each epoch is ONE fused stacked
                # dispatch. Epoch order respects every hazard (deps,
                # out= conflicts), so results match serial execution.
                by_idx = {t.index: t for t in tickets}
                for erep in epochs:
                    group = [by_idx[ti] for ti in erep.tickets]
                    current = group[0]
                    self._execute_epoch(group, consumers)
            else:
                for t in tickets:
                    current = t
                    try:
                        self._execute(t)
                    except FaultError as e:
                        # recovery lost: this ticket fails, the drain
                        # (and every independent ticket) keeps going
                        self._fail_ticket(t, e)
                        continue
                    # keep results alive for queued consumers
                    for _ in range(consumers.get(id(t), 0)):
                        self.store.hold(t.result)
        except Exception:
            # release every hold the dropped tickets still own (a failed
            # epoch formation drops them all) so no handle leaks a hold
            for u in tickets:
                if u.state == QUEUED:
                    u.state = FAILED if u is current else CANCELLED
                    self._release_ticket_holds(u)
            self._reap_scratch(tickets)     # no scratch handle outlives
            raise                           # the drain, even on failure
        # accounting: epoch ns = max over resources of summed per-resource
        # ns, plus the epoch's serialized channel transfers
        report = DrainReport(
            start_ns=now_ns,
            opt=self.optimizer.last_report if optimize else None)
        by_index = {t.index: t for t in tickets}
        total = OpStats()
        clock = now_ns
        for erep in epochs:
            per_res: Dict[Resource, float] = {}
            for ti in erep.tickets:
                t = by_index[ti]
                for r in sorted(t.resource_ns):
                    per_res[r] = per_res.get(r, 0.0) + t.resource_ns[r]
                erep.channel_ns += t.channel_ns
            erep.ns = max(per_res.values(), default=0.0) + erep.channel_ns
            dur = erep.ns if epoch_cost is None else float(
                epoch_cost(erep, [by_index[ti] for ti in erep.tickets]))
            # Retry backoff is waiting, not work: it stretches the
            # epoch's wall-clock interval (the latency-tail signal the
            # fault benchmarks measure) but never the measured epoch ns
            # or any conservation-exact ledger.
            dur += sum(by_index[ti].backoff_ns for ti in erep.tickets)
            erep.start_ns = clock
            if refresh and self._timing is not None and dur > 0.0:
                # Pausable epoch work threaded around refresh windows:
                # the epoch interval [start, end) absorbs the stall.
                _, end = refresh_schedule(clock, dur, self._timing)
                erep.end_ns = end
                erep.refresh_ns = (end - clock) - dur
                report.refresh_stall_ns += erep.refresh_ns
            else:
                erep.end_ns = clock + dur
            for ti in erep.tickets:
                by_index[ti].started_ns = erep.start_ns
                by_index[ti].finished_ns = erep.end_ns
            clock = erep.end_ns
            report.epochs.append(erep)
            total.ns += erep.ns
            total.channel_ns += erep.channel_ns
        report.end_ns = clock
        for t in tickets:
            total.energy_nj += t.stats.energy_nj
            total.aap_count += t.stats.aap_count
            total.bytes_touched += t.stats.bytes_touched
            total.channel_bytes += t.stats.channel_bytes
            total.refresh_stolen_ns += t.stats.refresh_stolen_ns
            report.serial_ns += t.stats.ns
            report.busy_ns += sum(t.resource_ns.values())
        report.stats = total
        self.last_drain = report
        self.drains += 1
        if optimize:
            self._reap_scratch(tickets)
            self.optimizer.commit(submitted)
        m = self.store.metrics
        m.counter("sched_drains").inc(1)
        m.counter("sched_epochs").inc(len(epochs))
        m.counter("sched_queries").inc(len(submitted))
        if refresh:
            m.counter("sched_refresh_stall_ns").inc(report.refresh_stall_ns)
        for t in tickets:
            for r in t.deferred:
                # label by reason class, not instance ("dep:#7" -> "dep")
                m.counter("sched_deferrals").inc(1, reason=r.split(":")[0])
        if self.store.tracer.enabled:
            self._trace_drain(report, by_index)
            if optimize:
                self._trace_cache_hits(submitted)
        return submitted

    def _reap_scratch(self, tickets: List[Ticket]) -> None:
        """Free the results of synthetic scratch tickets: every consumer
        has executed (or was cancelled) by now and released its hold, so
        no optimizer-introduced handle outlives the drain. Leak-checked
        by allocator occupancy in the test suite."""
        for t in tickets:
            if not t.synthetic or t.state != DONE or t.result is None:
                continue
            if not getattr(t.result, "freed", False):
                self.store.free(t.result)

    def _trace_cache_hits(self, submitted: List[Ticket]) -> None:
        """Async ticket spans for cache-served queries (they skip
        ``_trace_drain``'s by-index loop: they never entered an
        epoch)."""
        tr = self.store.tracer
        for t in submitted:
            if not t.cache_hit:
                continue
            tr.async_begin(("scheduler", "tickets"), f"q#{t.index}",
                           "ticket", t.index, t.submitted_ns,
                           args={"cache_hit": True})
            tr.async_end(("scheduler", "tickets"), f"q#{t.index}",
                         "ticket", t.index, t.finished_ns)

    def _trace_drain(self, report: DrainReport,
                     by_index: Dict[int, Ticket]) -> None:
        """Lay the drain on the trace: one span per epoch on the
        scheduler track (span durations tile [start_ns, end_ns) exactly -
        the sum-reconciliation contract tests/CI check), per-(device,
        bank) occupancy spans stacked in ticket order after the epoch's
        serialized channel time, a channel span when transfers happened,
        and one async span per ticket from submit to finish (defer
        reasons ride in its args)."""
        tr = self.store.tracer
        for k, erep in enumerate(report.epochs):
            eargs = {"tickets": list(erep.tickets),
                     "measured_ns": erep.ns,
                     "channel_ns": erep.channel_ns}
            if erep.refresh_ns:
                eargs["refresh_ns"] = erep.refresh_ns
            tr.span(("scheduler",), f"epoch{k}", "epoch", erep.start_ns,
                    erep.end_ns - erep.start_ns, args=eargs)
            if erep.refresh_ns:
                # Stall overlay: the refresh time this epoch absorbed,
                # summarized as one span on its own scheduler sub-track.
                tr.span(("scheduler", "refresh"), f"epoch{k}", "refresh",
                        erep.start_ns, erep.refresh_ns,
                        args={"epoch": k})
            if erep.channel_ns:
                tr.span(("channel",), f"epoch{k}", "channel",
                        erep.start_ns, erep.channel_ns)
            offsets: Dict[Resource, float] = {}
            for ti in erep.tickets:
                t = by_index[ti]
                for r in sorted(t.resource_ns):
                    d, b = r
                    off = offsets.get(r, 0.0)
                    tr.span((f"device{d}", f"bank{b}"), f"q#{t.index}",
                            "bank",
                            erep.start_ns + erep.channel_ns + off,
                            t.resource_ns[r],
                            args={"ticket": t.index, "epoch": k})
                    offsets[r] = off + t.resource_ns[r]
        for ti in sorted(by_index):
            t = by_index[ti]
            tr.async_begin(("scheduler", "tickets"), f"q#{t.index}",
                           "ticket", t.index, t.submitted_ns,
                           args={"epoch": t.epoch,
                                 "deferred": list(t.deferred),
                                 "started_ns": t.started_ns})
            tr.async_end(("scheduler", "tickets"), f"q#{t.index}",
                         "ticket", t.index, t.finished_ns)

    def _execute(self, t: Ticket) -> None:
        """Run one query: through the reliability layer when fault
        injection is wired (bounded retry / quarantine / TMR scrub),
        plainly otherwise. Tickets depending on a failed/cancelled
        ticket raise ``dep_failed`` here - their operand never
        materialized - and cancel instead of crashing the drain."""
        for nm in sorted(t.env):
            v = t.env[nm]
            if isinstance(v, Ticket) and v.state != DONE:
                raise FaultError(
                    f"operand {nm!r} of ticket #{t.index} is ticket "
                    f"#{v.index}, which {v.state}", kind="dep_failed")
        if self.reliability is not None:
            self.reliability.execute_ticket(self, t)
        else:
            self._execute_plain(t)

    def _fail_ticket(self, t: Ticket, e: FaultError) -> None:
        """Surface an unrecoverable fault as a FAILED (or, for a missing
        dependency, CANCELLED) ticket: error recorded, holds released,
        labeled metric + trace event emitted. The costs of its failed
        attempts were already committed to the ticket's ledgers."""
        t.state = CANCELLED if e.kind == "dep_failed" else FAILED
        t.error = str(e)
        self._release_ticket_holds(t)
        m = self.store.metrics
        m.counter("ticket_failures").inc(1, reason=e.kind)
        tr = self.store.tracer
        if tr.enabled:
            tr.instant(("scheduler", "failures"), "ticket_failed",
                       "fault", args={"ticket": t.index,
                                      "reason": e.kind})

    def _execute_plain(self, t: Ticket) -> None:
        """Run one query through the planner (fault-ins charged to its
        ticket), release its operand holds, and publish the result."""
        store = self.store
        env = {nm: (v.result if isinstance(v, Ticket) else v)
               for nm, v in t.env.items()}
        operands = list(env.values())
        up0, rd0 = store.bytes_to_device, store.bytes_from_device
        for v in operands:
            store.ensure_resident(v, protect=operands)
        res = self.planner.execute(t.expression, env, out_name=t.out_name)
        rep = self.planner.last_report
        st = OpStats()
        st += rep.stats
        st.bytes_touched += (store.bytes_to_device - up0) + \
            (store.bytes_from_device - rd0)
        t.stats = st
        t.resource_ns = {
            (k if isinstance(k, tuple) else (0, k)): bank_stats.ns
            for k, bank_stats in rep.per_bank.items()}
        t.channel_ns = getattr(rep, "transfer_ns", 0.0)
        t.result = self.store.rebind(t.out, res) if t.out is not None \
            else res
        self._release_ticket_holds(t)
        t.state = DONE

    def _execute_epoch(self, group: List[Ticket],
                       consumers: Dict[int, int]) -> None:
        """Dispatch one epoch through the planner's batched entry point
        (one fused stacked kernel launch). Fault-ins of each ticket's
        spilled operands are measured per ticket before the dispatch.
        A terminal ticket - one no ticket of the drain reads, with no
        ``out=`` - has its result counted right behind the launch, so a
        later count waits for that launch alone."""
        store = self.store
        jobs = []
        epoch_operands: List[object] = []   # every operand must survive
        for t in group:                     # until the stacked dispatch
            env = {nm: (v.result if isinstance(v, Ticket) else v)
                   for nm, v in t.env.items()}
            epoch_operands.extend(env.values())
            up0, rd0 = store.bytes_to_device, store.bytes_from_device
            for v in env.values():
                store.ensure_resident(v, protect=epoch_operands)
            t.stats = OpStats(
                bytes_touched=(store.bytes_to_device - up0)
                + (store.bytes_from_device - rd0))
            jobs.append((t.expression, env, t.out_name, t.out))
        terminal = [t.out is None and not consumers.get(id(t), 0)
                    for t in group]
        results = self.planner.execute_epoch(jobs, count=terminal)
        for t, res in zip(group, results):
            t.result = self.store.rebind(t.out, res) if t.out is not None \
                else res
            self._release_ticket_holds(t)
            t.state = DONE
            for _ in range(consumers.get(id(t), 0)):
                self.store.hold(t.result)
