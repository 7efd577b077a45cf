"""Placement-aware query planner: whole Expr trees over resident operands.

The seed path lowered one binop at a time, each eval paying a host write
of every operand and a host read of the result. The planner instead takes
an entire expression DAG (``(w0 & w1) & w2 ...``), compiles it once
through PR 1's process-wide compile cache, and executes it directly over
resident rows:

  * chunks (device rows) are grouped by the subarray that holds their
    operands - each group runs the compiled AAP program **once**, batched
    over the group's rows (the Section 7 subarray-level parallelism);
  * operands that still span subarrays after the store's migration pass
    are staged through the reserved scratch row (RowClone-PSM cost,
    charged to the destination bank), mirroring the device bbop slow path;
  * results are written to freshly allocated rows co-located with their
    operands and returned as a *dirty* ResidentBitVector - no host
    read-back happens until someone calls ``get``;
  * the batch subarray of each group is built on the device model's
    device (the card unless the caller names another), so the program
    runs where the rows live;
  * a per-bank stat ledger is kept for each call: banks execute
    independent row groups in parallel, so the reported time is the
    **max over banks** while energy/AAP counts are summed (matching the
    Fig. 21 bank-parallelism accounting).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core import expr as E
from ..core.engine import OpStats, _compile_cached
from ..core.simulator import AmbitError, AmbitSubarray
from ..core.timing import CommandStats
from .store import PimStore, ResidentBitVector


@dataclasses.dataclass
class PlanReport:
    """What one planner execution did, and what it cost.

    ``per_bank`` holds the full per-bank ledger delta (ns/energy/AAPs
    charged to each bank by THIS call) rather than only the merged
    totals: the async scheduler packs bank-disjoint queries into one
    epoch and needs per-resource deltas to account epoch time as
    max-over-resources."""

    groups: int = 0                 # batched program dispatches
    migrated_rows: int = 0          # PSM migrations performed up front
    staged_rows: int = 0            # scratch stagings at execution time
    per_bank: Dict[int, OpStats] = dataclasses.field(default_factory=dict)
    stats: OpStats = dataclasses.field(default_factory=OpStats)
    #: the call raised mid-execution (fault injection): the report holds
    #: the cost of the work that DID happen, and no result was adopted -
    #: the reliability layer absorbs it so retries bill honestly.
    partial: bool = False

    @property
    def per_bank_ns(self) -> Dict[int, float]:
        """Banks that burned time in this call (back-compat view)."""
        return {b: st.ns for b, st in self.per_bank.items() if st.ns > 0.0}


class QueryPlanner:
    def __init__(self, store: PimStore, optimize: bool = True,
                 colocate: bool = True):
        self.store = store
        self.optimize = optimize
        self.colocate = colocate
        self.last_report: Optional[PlanReport] = None

    # -- helpers -------------------------------------------------------------

    def _validate(self, env: Dict[str, ResidentBitVector]
                  ) -> Tuple[List[str], ResidentBitVector]:
        if not env:
            raise ValueError("planner needs at least one operand")
        names = sorted(env)
        first = env[names[0]]
        for nm in names:
            rbv = env[nm]
            self.store._check_live(rbv)
            if (rbv.n_bits, rbv.shape, rbv.n_slots) != (
                    first.n_bits, first.shape, first.n_slots):
                raise ValueError(
                    "bbop operands must be row-aligned and equal-sized "
                    "(Section 5.3)")
        return names, first

    def footprint(self, env: Dict[str, ResidentBitVector]
                  ) -> frozenset:
        """``(device, bank)`` resources the operands occupy (device is
        always 0 on a single-device store). Destinations are co-located
        with their operands, so this is the conservative resource set the
        async scheduler packs epochs by; spilled operands fault back in
        at an allocator-chosen location, so they claim every bank."""
        out = set()
        n_banks = len(self.store.device.banks)
        for nm in sorted(env):
            rbv = env[nm]
            if rbv.spilled:
                return frozenset((0, b) for b in range(n_banks))
            out.update((0, s[0]) for s in rbv.slots)
        return frozenset(out)

    def _bank_totals(self) -> Dict[int, CommandStats]:
        dev = self.store.device
        out = {}
        for bi, bank in enumerate(dev.banks):
            agg = CommandStats()
            agg.merge(bank.stats)
            for s in bank.subarrays:
                agg.merge(s.stats)
            out[bi] = agg
        return out

    # -- execution -----------------------------------------------------------

    def execute(self, expression: E.Expr,
                env: Dict[str, ResidentBitVector],
                out_name: Optional[str] = None) -> ResidentBitVector:
        """Evaluate ``expression`` over resident operands; the result stays
        resident (dirty). Appears in ``last_report`` with per-bank timing."""
        self.last_report = None
        names, first = self._validate(env)
        dev = self.store.device
        geom, timing = dev.geom, dev.timing
        report = PlanReport()
        before = self._bank_totals()

        dst_slots: List[tuple] = []
        try:
            operands = [env[nm] for nm in names]
            for rbv in operands:
                self.store._touch(rbv)  # in-use: refresh LRU recency
            if self.colocate and len(operands) > 1:
                report.migrated_rows = self.store.colocate(operands)

            # Destination rows co-located with their chunk's operands.
            # The fallback path may LRU-spill bystanders on a full
            # device, but the call's own operands are protected for the
            # duration.
            for i in range(first.n_slots):
                hb, hs, _ = operands[0].slots[i]
                try:
                    (slot,) = self.store.allocator.alloc_in(hb, hs, 1)
                except AmbitError:
                    (slot,) = self.store.alloc_slots(
                        1, near=[r.slots[i] for r in operands],
                        protect=operands)
                dst_slots.append(slot)

            compiled = _compile_cached(expression, tuple(names),
                                       self.optimize, geom.data_rows,
                                       timing)
            dst_row = len(names)

            # Group chunk indices by destination subarray; each group is
            # one batched program execution charged to that subarray's
            # ledger.
            groups: Dict[Tuple[int, int], List[int]] = {}
            for i, (b, s, _) in enumerate(dst_slots):
                groups.setdefault((b, s), []).append(i)

            inj = getattr(dev, "fault_injector", None)
            dev_idx = getattr(dev, "device_index", 0)
            for (gb, gs), idxs in sorted(groups.items()):
                sub = dev.banks[gb].subarrays[gs]
                n = len(idxs)
                batch = AmbitSubarray(geom, timing, words=dev.words,
                                      n_rows=n, device=dev.device)
                for vi, nm in enumerate(names):
                    rows = torch.empty((n, dev.words), dtype=torch.int64,
                                       device=dev.device)
                    for gi, i in enumerate(idxs):
                        rows[gi] = self._fetch(env[nm].slots[i], gb, gs,
                                               report)
                    batch.write_row(vi, rows)
                batch.run(compiled.program)
                # the TRAs already ran: bill the batch before the
                # scatter, so an injected fault can't lose their cost
                sub.stats.merge(batch.stats)
                out = batch.read_row(dst_row).reshape(n, dev.words)
                for gi, i in enumerate(idxs):
                    row = out[gi]
                    if inj is not None:
                        row = inj.on_compute_write(
                            dev_idx, dst_slots[i], row)
                    sub.write_row(dst_slots[i][2], row)
                report.groups += 1
        except AmbitError:
            # Failed evals never leak live rows, and the work already
            # performed (stagings, TRAs, partial scatters) stays billed
            # via a partial report the reliability layer absorbs.
            if dst_slots:
                self.store.allocator.free(dst_slots)
            self._finalize(report, before, partial=True)
            raise

        self._finalize(report, before, partial=False)
        return self.store.adopt(ResidentBitVector(
            store=self.store, n_bits=first.n_bits, shape=first.shape,
            words32=first.words32, chunks=first.chunks, slots=dst_slots,
            dirty=True, name=out_name))

    def _finalize(self, report: PlanReport, before: Dict[int, CommandStats],
                  partial: bool) -> None:
        """Close out one execution attempt: compute the per-bank ledger
        delta, publish ``last_report`` and bill the metric/trace series.
        Runs for failed (partial) attempts too - injected faults must
        not leak unbilled DRAM work."""
        dev = self.store.device
        timing = dev.timing
        after = self._bank_totals()
        deltas = {bi: _delta(after[bi], before[bi]) for bi in after}
        # Refresh interference: every ns of bank-busy time drags
        # tRFC/(tREFI - tRFC) of refresh along with it (timing.py). This
        # is THE single site that computes stolen time from busy time, so
        # the per-bank ledger, the metrics series and the tracer spans
        # reconcile bit-exactly.
        report.per_bank = {
            bi: OpStats(ns=d.ns, energy_nj=d.energy_nj,
                        aap_count=d.aap_count,
                        refresh_stolen_ns=timing.refresh_stolen_ns(d.ns))
            for bi, d in deltas.items()
            if d.ns > 0.0 or d.energy_nj > 0.0 or d.aap_count}
        report.stats = OpStats(
            ns=max((d.ns for d in deltas.values()), default=0.0),
            energy_nj=sum(d.energy_nj for d in deltas.values()),
            aap_count=sum(d.aap_count for d in deltas.values()),
            bytes_touched=0,        # resident: no host traffic
            refresh_stolen_ns=sum(
                st.refresh_stolen_ns for st in report.per_bank.values()))
        report.partial = partial
        self.last_report = report

        # Observability: per-bank busy ns is the occupancy series the
        # utilization report divides by wall time. ``device=0`` because a
        # lone PimStore is device 0; under a PimCluster these land in the
        # per-device store's private registry while the ClusterPlanner
        # bills the shared one with real device indices.
        m = self.store.metrics
        if partial:
            m.counter("plan_faulted").inc(1)
        else:
            m.counter("plan_executions").inc(1)
        if report.groups:
            m.counter("plan_groups").inc(report.groups)
        if report.staged_rows:
            m.counter("plan_staged_rows").inc(report.staged_rows)
        for b in sorted(report.per_bank):
            st = report.per_bank[b]
            if st.ns:
                m.counter("bank_busy_ns").inc(st.ns, device=0, bank=b)
            if st.refresh_stolen_ns:
                m.counter("refresh_stolen_ns").inc(
                    st.refresh_stolen_ns, device=0, bank=b)
        tr = self.store.tracer
        if tr.enabled:
            args = {"groups": report.groups,
                    "migrated_rows": report.migrated_rows,
                    "staged_rows": report.staged_rows,
                    "aaps": report.stats.aap_count}
            if partial:
                args["partial"] = True
            tr.tick(("planner", "device0"), "plan", "plan", report.stats.ns,
                    args=args)
        # Per-bank refresh-stall spans go through the DEVICE tracer: under
        # a cluster the runtime threads the session tracer + a
        # ``device<d>`` trace_name onto each AmbitDevice (the per-device
        # store tracer stays NULL), so these spans are emitted exactly
        # once per call with the real device track either way.
        dtr = getattr(dev, "tracer", None)
        if dtr is not None and dtr.enabled:
            dev_track = getattr(dev, "trace_name", "device0")
            for b in sorted(report.per_bank):
                st = report.per_bank[b]
                if st.refresh_stolen_ns:
                    dtr.tick((dev_track, f"bank{b}"), "refresh_stall",
                             "refresh", st.refresh_stolen_ns,
                             args={"busy_ns": st.ns})

    def _fetch(self, src: tuple, gb: int, gs: int,
               report: PlanReport) -> torch.Tensor:
        """Value of a source row for a group executing in subarray
        (gb, gs). Co-located rows are read in place; remote rows are
        PSM-staged into the reserved scratch row first (paper cost model),
        then read - one scratch row suffices because each staging is
        consumed before the next."""
        dev = self.store.device
        sb, ss, sr = src
        if (sb, ss) == (gb, gs):
            return dev.banks[gb].subarrays[gs].read_row(sr)
        if self.store.allocator.scratch_rows < 1:
            raise AmbitError(
                "non-co-located operand needs a reserved scratch row "
                "(RowAllocator scratch_rows >= 1)")
        scratch = dev.geom.data_rows - 1
        dev.migrate_row(src, (gb, gs, scratch))
        report.staged_rows += 1
        return dev.banks[gb].subarrays[gs].read_row(scratch)


def _delta(after: CommandStats, before: CommandStats) -> CommandStats:
    d = CommandStats()
    d.activates = after.activates - before.activates
    d.wordlines = after.wordlines - before.wordlines
    d.precharges = after.precharges - before.precharges
    d.aap_count = after.aap_count - before.aap_count
    d.ap_count = after.ap_count - before.ap_count
    d.ns = after.ns - before.ns
    d.energy_nj = after.energy_nj - before.energy_nj
    return d
