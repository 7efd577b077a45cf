"""Fault injection + end-to-end reliability for the PIM runtime.

Ambit's correctness rests on analog triple-row activation, and the paper
(Section 6, Table 3) shows TRA failing under process variation; Section
5.5 names triple-modular redundancy as the only protection that commutes
with bulk bitwise operation. This module wires both observations into
the runtime as one subsystem:

**inject** - a deterministic, seedable :class:`FaultInjector` the
simulator consults at TRA-result scatter time, RowClone/transfer time
and on every device touch:

  * *weak cells*: per-``(device, bank, subarray, row)`` bit masks
    sampled at the calibrated per-bit failure rate the ``core.analog``
    Monte-Carlo model produces for the configured process variation
    (Table 3), XORed into computed rows as they are written back;
  * *stuck rows*: a fixed fraction of data rows fail hard - any compute
    write or RowClone landing there raises, deterministically, forever
    (the persistent-fault class that makes quarantine meaningful);
  * *transient flips*: per-event single-bit upsets at a configured rate
    on compute writes and row transfers;
  * *device loss*: whole-device failure, either scheduled after the
    N-th event on a device or forced via :meth:`FaultInjector.fail_device`.

Draws stay on the host (numpy generators); masks and bit flips are
applied to the device rows as ``int64`` bit patterns on the rows' own
device, and the ledger's ``bits=`` counts are taken from the host mask.

All sampling is keyed **structurally** - ``default_rng((seed, tag,
device, bank, ...))`` - never by ``hash()``, so the fault sequence is a
pure function of the seed and the executed workload: byte-identical
across runs and across ``PYTHONHASHSEED``.

**detect** - TMR-protected planes (``put(..., protect=True)`` stores
three independently-placed replicas) are executed replica-wise and
cross-checked with XOR parity queries lowered through the planner
(billed DRAM work, not magic); raw-row zero-tests are the only free
telemetry, standing in for the DQ-level compare a memory controller
gets for free.

**recover** - :class:`ReliabilityManager` retries failed plans with
bounded exponential backoff, quarantines faulty rows back to the
``RowAllocator``, scrubs diverged TMR planes by re-voting them through
native MAJ queries, and (on a cluster) evacuates lost devices and
repairs protected planes chunk-by-chunk from surviving siblings. The
serving frontend adds the last layer: deadline timeouts, error results
and host fallback (see ``serve.frontend``).

Every fault, scrub, retry and quarantine is a labeled metric
(``fault_injected{kind}``, ``scrub_corrections``,
``ticket_retries{reason}``, ``quarantined_rows``) and a trace event,
and every retried/scrubbed attempt's DRAM work is absorbed into the
caller's ``OpStats`` - recovery inflates the ledgers honestly, never
silently.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..core import expr as E
from ..core.bitvector import popcount_words
from ..core.engine import OpStats
from ..core.simulator import AmbitError

__all__ = [
    "FaultError", "DeviceLostError", "FaultConfig", "FaultInjector",
    "ReliabilityManager",
]

#: Top data rows excluded from stuck-row sampling: the compiler stages
#: PSM copies through the last data row and the allocator's scratch zone
#: lives directly below it, so a stuck row there would wedge every
#: query instead of modeling a recoverable placement fault.
STUCK_GUARD_ROWS = 8


class FaultError(AmbitError):
    """An injected (or detected) fault. ``kind`` labels the metric
    series; ``device``/``slot`` name the faulty site so recovery can
    re-place away from it."""

    def __init__(self, msg: str, kind: str = "fault",
                 device: Optional[int] = None,
                 slot: Optional[Tuple[int, int, int]] = None):
        super().__init__(msg)
        self.kind = kind
        self.device = device
        self.slot = slot


class DeviceLostError(FaultError):
    """A whole device went away."""

    def __init__(self, msg: str, device: Optional[int] = None):
        super().__init__(msg, kind="device_lost", device=device)


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Deterministic fault model. All rates default to zero: a
    constructed-but-idle injector never perturbs anything."""

    seed: int = 0
    #: process variation fed to ``analog.tra_failure_rate``; the
    #: resulting per-bit TRA failure probability becomes the weak-cell
    #: density (Table 3: 0.0 at +-5%%, ~6e-2 at +-15%%).
    variation: float = 0.0
    #: explicit per-bit weak-cell rate; overrides ``variation`` when set
    #: (tests want small, targeted densities).
    weak_bit_rate: Optional[float] = None
    #: fraction of data rows that are hard-stuck (persistent faults).
    stuck_row_rate: float = 0.0
    #: per-compute-write probability of a single-bit transient upset.
    transient_rate: float = 0.0
    #: per-transfer probability of a single-bit flip at the destination.
    transfer_flip_rate: float = 0.0
    #: ``((device, after_n_events), ...)``: device fails permanently on
    #: its N-th injector-visible event.
    fail_device_after: Tuple[Tuple[int, int], ...] = ()
    #: Monte-Carlo trials for the analog calibration (kept modest: the
    #: rate is cached once per injector).
    analog_trials: int = 20_000


class FaultInjector:
    """Seeded, structurally-keyed fault source (see module docstring).

    The simulator calls :meth:`on_compute_write` when a TRA result row
    is scattered into its destination slot, :meth:`on_transfer` after a
    RowClone/inter-device row copy lands, and :meth:`check_alive` on
    every device touch. ``events`` is the execution-ordered fault
    ledger the determinism CI byte-diffs.

    ``device`` is where the analog calibration of ``variation`` runs (the
    card unless named; the runtime binds its own device). The sampled
    fault universe does not depend on it.
    """

    def __init__(self, config: Optional[FaultConfig] = None, device=None):
        self.config = config or FaultConfig()
        self.device = device
        self.dead: Set[int] = set()
        self.events: List[str] = []
        self.counts: Dict[str, int] = {}
        self.metrics = None
        self.tracer = None
        self.data_rows: Optional[int] = None
        self._weak_rate: Optional[float] = None
        self._weak_masks: Dict[Tuple[int, int, int, int],
                               Optional[np.ndarray]] = {}
        # the same masks as int64 tensors, per (slot key, torch device)
        self._weak_rows: Dict[tuple, torch.Tensor] = {}
        self._stuck: Dict[Tuple[int, int, int, int], bool] = {}
        self._dev_events: Dict[int, int] = {}
        self._fail_after = dict(self.config.fail_device_after)

    def bind(self, metrics=None, tracer=None,
             data_rows: Optional[int] = None, device=None) -> None:
        """Attach observability sinks + geometry + the session's torch
        device (runtime wiring)."""
        if device is not None:
            self.device = device
        if metrics is not None:
            self.metrics = metrics
        if tracer is not None:
            self.tracer = tracer
        if data_rows is not None:
            self.data_rows = data_rows

    # -- deterministic sampling ----------------------------------------------

    def _rng(self, *key: int) -> np.random.Generator:
        return np.random.default_rng((self.config.seed,) + tuple(key))

    @property
    def weak_rate(self) -> float:
        """Per-bit weak-cell density: explicit override, else the
        calibrated analog failure rate for the configured variation."""
        if self._weak_rate is None:
            cfg = self.config
            if cfg.weak_bit_rate is not None:
                self._weak_rate = float(cfg.weak_bit_rate)
            elif cfg.variation > 0.0:
                from ..core.analog import tra_failure_rate
                self._weak_rate = float(tra_failure_rate(
                    cfg.variation, n_trials=cfg.analog_trials,
                    seed=cfg.seed, device=self.device))
            else:
                self._weak_rate = 0.0
        return self._weak_rate

    def weak_mask(self, device: int, slot: Tuple[int, int, int],
                  words: int) -> Optional[np.ndarray]:
        """The slot's weak-cell XOR mask (None when clean). Sampled once
        per slot from a structural key and cached: the same cells stay
        weak for the life of the run."""
        key = (device,) + tuple(slot)
        if key not in self._weak_masks:
            rate = self.weak_rate
            mask = None
            if rate > 0.0:
                bits = self._rng(1, *key).random(words * 64) < rate
                if bits.any():
                    mask = np.packbits(
                        bits, bitorder="little").view(np.uint64).copy()
            self._weak_masks[key] = mask
        return self._weak_masks[key]

    def _weak_row(self, device: int, slot: Tuple[int, int, int],
                  mask: np.ndarray, where: torch.device) -> torch.Tensor:
        """``mask`` as an int64 row on ``where`` (cached per slot)."""
        key = (device,) + tuple(slot) + (str(where),)
        row = self._weak_rows.get(key)
        if row is None:
            row = torch.from_numpy(mask.view(np.int64).copy()).to(where)
            self._weak_rows[key] = row
        return row

    def row_stuck(self, device: int, slot: Tuple[int, int, int]) -> bool:
        """Persistent per-row stuck-at fault (guard band excluded)."""
        if self.config.stuck_row_rate <= 0.0:
            return False
        key = (device,) + tuple(slot)
        if key not in self._stuck:
            guard = (self.data_rows is not None
                     and slot[2] >= self.data_rows - STUCK_GUARD_ROWS)
            self._stuck[key] = bool(
                not guard
                and self._rng(2, *key).random()
                < self.config.stuck_row_rate)
        return self._stuck[key]

    def _flip_one_bit(self, row: torch.Tensor, tag: int, device: int,
                      bank: int, n: int) -> torch.Tensor:
        bit = int(self._rng(tag, device, bank, n).integers(
            0, row.numel() * 64))
        out = row.clone()
        flip = 1 << (bit & 63)
        if flip >= 1 << 63:             # bit 63: the int64 sign bit
            flip -= 1 << 64
        out[bit >> 6] ^= flip
        return out

    # -- fault ledger ---------------------------------------------------------

    def record(self, kind: str, device: int, detail: str) -> None:
        self.events.append(f"{kind} dev={device} {detail}")
        self.counts[kind] = self.counts.get(kind, 0) + 1
        if self.metrics is not None:
            self.metrics.counter("fault_injected").inc(1, kind=kind)
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.instant(("faults", f"device{device}"), kind,
                                "fault", args={"detail": detail})

    def note(self, line: str) -> None:
        """Recovery-side ledger line (scrub/quarantine/evacuation):
        recorded alongside injected faults so the determinism diff
        covers the *response*, not just the stimulus."""
        self.events.append(line)

    # -- device lifetime ------------------------------------------------------

    def check_alive(self, device: int) -> None:
        if device in self.dead:
            raise DeviceLostError(f"device {device} is offline",
                                  device=device)

    def fail_device(self, device: int) -> None:
        """Take a device offline permanently (manual or scheduled)."""
        if device not in self.dead:
            self.dead.add(device)
            self.record("device_lost", device, "offline")

    def _tick(self, device: int) -> None:
        n = self._dev_events.get(device, 0) + 1
        self._dev_events[device] = n
        after = self._fail_after.get(device)
        if after is not None and n >= after and device not in self.dead:
            self.fail_device(device)
            raise DeviceLostError(
                f"device {device} failed at event {n}", device=device)

    # -- simulator hooks ------------------------------------------------------

    def on_compute_write(self, device: int, slot: Tuple[int, int, int],
                         row: torch.Tensor) -> torch.Tensor:
        """A computed (TRA-result) row is about to be written into
        ``slot``. Returns the possibly-corrupted row; raises for
        persistent faults / device loss."""
        self.check_alive(device)
        self._tick(device)
        slot = tuple(slot)
        if self.row_stuck(device, slot):
            self.record("stuck_row", device, f"slot={slot} op=compute")
            raise FaultError(f"stuck row at dev{device} {slot}",
                             kind="stuck_row", device=device, slot=slot)
        out = row
        mask = self.weak_mask(device, slot, row.numel())
        if mask is not None:
            out = out ^ self._weak_row(device, slot, mask, row.device)
            self.record("weak_cell", device,
                        f"slot={slot} bits={int(np.unpackbits(mask.view(np.uint8)).sum())}")
        if self.config.transient_rate > 0.0:
            n = self._dev_events[device]
            if self._rng(3, device, slot[0], n).random() \
                    < self.config.transient_rate:
                out = self._flip_one_bit(out, 4, device, slot[0], n)
                self.record("transient", device, f"slot={slot}")
        return out

    def on_transfer(self, device: int, slot: Tuple[int, int, int],
                    row: torch.Tensor) -> torch.Tensor:
        """A RowClone/migration just landed a row at ``slot`` on
        ``device``. Returns the possibly-corrupted destination row;
        raises when the destination row is hard-stuck (write-verify)."""
        self.check_alive(device)
        self._tick(device)
        slot = tuple(slot)
        if self.row_stuck(device, slot):
            self.record("stuck_row", device, f"slot={slot} op=transfer")
            raise FaultError(f"stuck row at dev{device} {slot}",
                             kind="stuck_row", device=device, slot=slot)
        out = row
        if self.config.transfer_flip_rate > 0.0:
            n = self._dev_events[device]
            if self._rng(5, device, slot[0], n).random() \
                    < self.config.transfer_flip_rate:
                out = self._flip_one_bit(out, 6, device, slot[0], n)
                self.record("transfer_flip", device, f"slot={slot}")
        return out

    def ledger(self) -> str:
        """Execution-ordered fault/recovery ledger (CI byte-diffs it)."""
        return "; ".join(self.events)


def _nonzero_rows(differ: torch.Tensor) -> List[int]:
    """Indices of the rows of a (rows, words) bool tensor that hold any
    True, in order (one device-to-host read)."""
    return torch.nonzero(differ.any(dim=1)).flatten().tolist()


def _new_acc() -> dict:
    """Per-query cost accumulator threaded through retries: every
    attempt's DRAM work lands here whether or not the attempt (or even
    the query) succeeds - failed work is still work the ledgers own."""
    return {"stats": OpStats(), "res_ns": {}, "channel": 0.0,
            "backoff": 0.0, "retries": 0}


class ReliabilityManager:
    """Detection + recovery around a planner (see module docstring).

    The scheduler routes ticket execution through
    :meth:`execute_ticket`; ``AmbitRuntime.eval`` routes through
    :meth:`run_query`. Both share :meth:`run_plan`'s bounded
    retry/quarantine loop and the protected (TMR) execution path.
    """

    #: parity/scrub rounds before a protected query is declared failed.
    MAX_SCRUB_ROUNDS = 3

    def __init__(self, store, planner, injector: Optional[FaultInjector]
                 = None, max_retries: int = 3, backoff_ns: float = 2000.0,
                 cluster=None):
        self.store = store
        self.planner = planner
        self.injector = injector
        self.max_retries = max_retries
        self.backoff_ns = backoff_ns
        self.cluster = cluster

    @property
    def metrics(self):
        return getattr(self.store, "metrics", None)

    @property
    def tracer(self):
        return getattr(self.store, "tracer", None)

    # -- retry loop -----------------------------------------------------------

    def run_plan(self, expression, env, out_name=None, acc=None):
        """``planner.execute`` with bounded retry. Persistent-fault
        sites are quarantined between attempts so re-placement moves
        away from them; device loss triggers cluster evacuation. Raises
        the last ``FaultError`` when recovery is impossible (data loss,
        single-device loss, retries exhausted)."""
        acc = _new_acc() if acc is None else acc
        attempt = 0
        while True:
            try:
                res = self.planner.execute(expression, env,
                                           out_name=out_name)
            except FaultError as e:
                self._absorb(acc)
                if e.kind == "data_loss":
                    raise
                recovered = True
                if isinstance(e, DeviceLostError):
                    recovered = self._recover_device(e)
                else:
                    self._quarantine(e)
                attempt += 1
                acc["retries"] += 1
                if self.metrics is not None:
                    self.metrics.counter("ticket_retries").inc(
                        1, reason=e.kind)
                if not recovered or attempt > self.max_retries:
                    raise
                acc["backoff"] += self.backoff_ns * (2.0 ** (attempt - 1))
                self._refault(env)
                continue
            self._absorb(acc)
            return res

    def _absorb(self, acc: dict) -> None:
        """Fold the planner's last report - partial reports from failed
        attempts included - into the accumulator exactly once."""
        rep = getattr(self.planner, "last_report", None)
        if rep is None or getattr(rep, "_absorbed", False):
            return
        rep._absorbed = True
        acc["stats"].merge(rep.stats)
        for k, st in rep.per_bank.items():
            key = k if isinstance(k, tuple) else (0, k)
            acc["res_ns"][key] = acc["res_ns"].get(key, 0.0) + st.ns
        acc["channel"] += getattr(rep, "transfer_ns", 0.0)

    def _quarantine(self, e: FaultError) -> None:
        if e.device is None or e.slot is None:
            return
        self._quarantine_slot(e.device, e.slot)

    def _quarantine_slot(self, device: int, slot) -> None:
        """Retire a faulty row from its allocator so re-placement
        cannot land on it again. Scratch-zone rows (>= usable_rows) are
        device-managed, not allocator-owned, and are skipped."""
        alloc = self._allocator_for(device)
        if alloc is None:
            return
        slot = tuple(slot)
        if slot[2] >= alloc.usable_rows or alloc.is_live(slot) \
                or slot in alloc.quarantined_slots:
            return
        alloc.quarantine([slot])
        if self.metrics is not None:
            self.metrics.counter("quarantined_rows").inc(1)
        if self.injector is not None:
            self.injector.note(f"quarantine dev={device} slot={slot}")
        tr = self.tracer
        if tr is not None and tr.enabled:
            tr.instant(("faults", f"device{device}"), "quarantine",
                       "fault", args={"slot": list(slot)})

    def _allocator_for(self, device: int):
        if self.cluster is not None:
            allocs = getattr(self.cluster, "allocators", None)
            if allocs is not None and 0 <= device < len(allocs):
                return allocs[device]
            return None
        return getattr(self.store, "allocator", None)

    def _recover_device(self, e: DeviceLostError) -> bool:
        """Evacuate a lost device; recovery is possible iff survivors
        remain (a single-device runtime has none)."""
        cl = self.cluster
        if cl is None or e.device is None:
            return False
        if e.device not in cl.dead_devices:
            cl.evacuate_device(e.device)
            if self.metrics is not None:
                self.metrics.counter("devices_lost").inc(1)
            if self.injector is not None:
                self.injector.note(f"evacuate dev={e.device}")
        return len(cl.dead_devices) < cl.n_devices

    def _refault(self, env) -> None:
        """Bring evacuated/spilled operands back before a retry."""
        operands = list(env.values())
        for nm in sorted(env):
            self.store.ensure_resident(env[nm], protect=operands)

    # -- query entry points ---------------------------------------------------

    def run_query(self, expression, env, out_name=None, acc=None):
        """One query end to end: protected (TMR) execution when any
        operand is protected, plain retried execution otherwise."""
        acc = _new_acc() if acc is None else acc
        if any(getattr(v, "protected", False) for v in env.values()):
            return self._execute_protected(expression, env, out_name, acc)
        operands = list(env.values())
        for v in operands:
            self.store.ensure_resident(v, protect=operands)
        return self.run_plan(expression, env, out_name=out_name, acc=acc)

    def execute_ticket(self, sched, t) -> None:
        """Scheduler ticket execution with full recovery. Costs of
        failed attempts are committed to the ticket either way."""
        from .scheduler import DONE, Ticket
        store = sched.store
        env = {nm: (v.result if isinstance(v, Ticket) else v)
               for nm, v in t.env.items()}
        if t.out is not None and any(getattr(v, "protected", False)
                                     for v in env.values()):
            raise AmbitError(
                "out= rebind is not supported for TMR-protected queries")
        up0 = store.bytes_to_device
        rd0 = store.bytes_from_device
        acc = _new_acc()
        try:
            res = self.run_query(t.expression, env,
                                 out_name=t.out_name, acc=acc)
            t.result = store.rebind(t.out, res) if t.out is not None \
                else res
            sched._release_ticket_holds(t)
            t.state = DONE
        finally:
            t.stats.merge(acc["stats"])
            t.stats.bytes_touched += (store.bytes_to_device - up0) + \
                (store.bytes_from_device - rd0)
            for k, v in acc["res_ns"].items():
                t.resource_ns[k] = t.resource_ns.get(k, 0.0) + v
            t.channel_ns += acc["channel"]
            t.backoff_ns += acc["backoff"]
            t.retries += acc["retries"]

    # -- TMR-protected execution ----------------------------------------------

    def _execute_protected(self, expression, env, out_name, acc):
        """Execute replica-wise over three planes, parity-check the
        results through the planner (billed XOR queries), scrub
        divergences with native MAJ re-votes, and return the voted
        primary carrying two fresh replicas."""
        store = self.store
        names = sorted(env)
        planes = {}
        for nm in names:
            h = env[nm]
            reps = list(getattr(h, "replicas", None) or [])
            if getattr(h, "protected", False) and len(reps) == 2:
                planes[nm] = [h, reps[0], reps[1]]
            else:
                planes[nm] = [h, h, h]    # unprotected operand: reuse
        all_planes = [p for nm in names for p in dict.fromkeys(planes[nm])]
        results: List = []
        try:
            # A device can die *during* a plane pass, marking sibling
            # planes lost after the fact - so repair-then-execute is a
            # bounded loop, not a one-shot preamble.
            for attempt in range(3):
                for nm in names:
                    for h in dict.fromkeys(planes[nm]):
                        if getattr(h, "lost", False):
                            self._repair_plane(
                                h, [s for s in planes[nm] if s is not h])
                try:
                    for k in range(3):
                        env_k = {nm: planes[nm][k] for nm in names}
                        for nm in names:
                            store.ensure_resident(env_k[nm],
                                                  protect=all_planes)
                        results.append(
                            self.run_plan(expression, env_k, acc=acc))
                    self._parity_scrub(expression, results, acc)
                    for d_try in range(3):
                        try:
                            self._disperse(results, acc)
                            break
                        except FaultError as e:
                            if isinstance(e, DeviceLostError):
                                if not self._recover_device(e):
                                    raise
                            else:
                                self._quarantine(e)
                            if d_try == 2:
                                raise
                    break
                except FaultError as e:
                    # A device death mid-scrub can claim every
                    # (colocated) result plane at once: the inputs are
                    # still recoverable, so re-execute from them.
                    for r in results:
                        if r is not None and not getattr(r, "freed", True):
                            try:
                                store.free(r)
                            except AmbitError:
                                pass
                    del results[:]
                    if isinstance(e, DeviceLostError):
                        if not self._recover_device(e) or attempt == 2:
                            raise
                    elif e.kind != "data_loss" or attempt == 2:
                        raise
        except BaseException:
            for r in results:
                if r is not None and not getattr(r, "freed", True):
                    try:
                        store.free(r)
                    except AmbitError:
                        pass
            raise
        primary, r1, r2 = results
        primary.replicas = [r1, r2]
        primary.protected = True
        primary.name = out_name
        if self.metrics is not None:
            self.metrics.counter("protected_queries").inc(1)
        return primary

    def _parity_scrub(self, expression, results: List, acc) -> None:
        """Detect plane divergence with billed XOR parity queries; on
        mismatch re-vote all three planes through independent native
        MAJ queries (identical-corruption across independently-faulted
        planes is the one failure TMR cannot see). Bounded."""
        p0, p1, p2 = (E.Expr.var("p0"), E.Expr.var("p1"), E.Expr.var("p2"))
        for _ in range(self.MAX_SCRUB_ROUNDS + 1):
            x01 = self.run_plan(p0 ^ p1,
                                {"p0": results[0], "p1": results[1]},
                                acc=acc)
            x02 = self.run_plan(p0 ^ p2,
                                {"p0": results[0], "p2": results[2]},
                                acc=acc)
            r01 = self._raw_rows(x01)
            r02 = self._raw_rows(x02)
            bad = bool(r01.any()) or bool(r02.any())
            # Parity-result rows can themselves sit on weak cells; grab
            # their slots before free() so they can be quarantined
            # rather than recycled into the next round.
            par_slots = [self._slot_of(h, i)
                         for h, raw in ((x01, r01), (x02, r02))
                         for i in _nonzero_rows(raw != 0)]
            self.store.free(x01)
            self.store.free(x02)
            if self.metrics is not None:
                self.metrics.counter("parity_checks").inc(1)
            if not bad:
                return
            rows = [self._raw_rows(r) for r in results]
            vote = (rows[0] & rows[1]) | (rows[1] & rows[2]) \
                | (rows[0] & rows[2])
            diverged = [(k, i) for k in range(3)
                        for i in _nonzero_rows(rows[k] != vote)]
            if not diverged:
                # Planes agree: the mismatch came from the parity
                # query's own destination rows. Retire them and
                # re-check.
                for dev, slot in par_slots:
                    self._quarantine_slot(dev, slot)
                continue
            corrections = int(sum(
                int(popcount_words((r ^ vote).view(torch.int32)).sum())
                for r in rows))
            if self.metrics is not None:
                self.metrics.counter("scrub_corrections").inc(corrections)
                self.metrics.counter("fault_scrubs").inc(1)
            if self.injector is not None:
                self.injector.note(f"scrub corrections={corrections}")
            tr = self.tracer
            if tr is not None and tr.enabled:
                tr.instant(("faults", "scrub"), "scrub", "fault",
                           args={"corrections": corrections})
            env3 = {"p0": results[0], "p1": results[1], "p2": results[2]}
            fresh = [self.run_plan(E.maj(p0, p1, p2), env3, acc=acc)
                     for _ in range(3)]
            bad_slots = {self._slot_of(results[k], i) for k, i in diverged}
            for r in results:
                self.store.free(r)
            for dev, slot in sorted(bad_slots | set(par_slots)):
                self._quarantine_slot(dev, slot)
            results[:] = fresh
        # Query-based re-votes keep racing fresh transient flips; fall
        # back to the controller's authoritative scrub: write the voted
        # rows straight back into the planes (write-verified).
        self._writeback_vote(results)

    def _writeback_vote(self, results: List) -> None:
        """Majority-vote the planes on the host (free write-verify
        telemetry) and write the vote back into every diverging row.
        Raises ``scrub_failed`` when even write-back cannot stabilize
        the planes (e.g. a pathological transfer-flip rate)."""
        rows = [self._raw_rows(r) for r in results]
        vote = (rows[0] & rows[1]) | (rows[1] & rows[2]) \
            | (rows[0] & rows[2])
        inj = self.injector
        total = 0
        for _ in range(self.MAX_SCRUB_ROUNDS + 1):
            dirty = 0
            for r in results:
                cur = self._raw_rows(r)
                for i in _nonzero_rows(cur != vote):
                    dev, slot = self._slot_of(r, i)
                    device = (self.cluster.devices[dev]
                              if self.cluster is not None
                              else self.store.device)
                    out = vote[i].clone()
                    device.write([slot], out.reshape(1, -1))
                    if inj is not None:
                        got = inj.on_transfer(dev, slot, out)
                        if not torch.equal(got, out):
                            device.write([slot], got.reshape(1, -1))
                    dirty += 1
            total += dirty
            if dirty == 0:
                if total:
                    if self.metrics is not None:
                        self.metrics.counter(
                            "scrub_writeback_rows").inc(total)
                    if inj is not None:
                        inj.note(f"scrub writeback rows={total}")
                return
        raise FaultError("TMR scrub failed to converge", kind="scrub_failed")

    def _disperse(self, results: List, acc) -> None:
        """Parity/scrub queries colocate the three result planes onto
        the same devices, which would let a single device loss claim
        every copy of a chunk. Re-rotate the replica planes across the
        alive devices (billed inter-device migrations)."""
        cl = self.cluster
        if cl is None:
            return
        alive = [d for d in range(cl.n_devices) if d not in cl.dead_devices]
        if len(alive) < 2:
            return
        led = cl.ledger
        ns0, nj0, by0 = (led.inter_device_ns, led.inter_device_nj,
                         led.inter_device_bytes)
        primary = results[0]
        moved = 0
        old_flight = cl._in_flight
        cl._in_flight = tuple(results)
        try:
            for k, rep in enumerate(results[1:], start=1):
                for i, ds in enumerate(primary.slots):
                    if ds is None or rep.slots[i] is None:
                        continue          # lost chunk: repaired on next use
                    base = alive.index(ds[0]) if ds[0] in alive else 0
                    target = alive[(base + k) % len(alive)]
                    if rep.slots[i][0] != target:
                        moved += cl._migrate_chunk(
                            [rep], i, [rep.slots[i][0]], target)
        finally:
            cl._in_flight = old_flight
            dns = led.inter_device_ns - ns0
            acc["stats"].ns += dns
            acc["stats"].channel_ns += dns
            acc["stats"].channel_bytes += led.inter_device_bytes - by0
            acc["stats"].energy_nj += led.inter_device_nj - nj0
            acc["channel"] += dns
            if moved and self.metrics is not None:
                self.metrics.counter("tmr_disperse_rows").inc(moved)

    def _slot_of(self, h, i: int) -> Tuple[int, Tuple[int, int, int]]:
        """(device, slot) of a fully-resident handle's chunk ``i``."""
        ds = h.slots[int(i)]
        if getattr(self.store, "devices", None) is not None:
            return (ds[0], tuple(ds[1]))
        return (0, tuple(ds))

    def _raw_rows(self, h) -> torch.Tensor:
        """Raw device rows of a fully-resident handle - free telemetry
        (the zero-test a controller's write-verify gives you), never a
        billed channel transfer."""
        store = self.store
        devices = getattr(store, "devices", None)
        if devices is not None:          # cluster handle
            words = store.words
            out = torch.empty((h.n_slots, words), dtype=torch.int64,
                              device=devices[0].device)
            by_dev: Dict[int, List[int]] = {}
            for i, ds in enumerate(h.slots):
                by_dev.setdefault(ds[0], []).append(i)
            for d in sorted(by_dev):
                idxs = by_dev[d]
                out[idxs] = devices[d].read([h.slots[i][1] for i in idxs])
            return out
        return store.device.read(h.slots)

    def _repair_plane(self, h, siblings: List) -> None:
        """Rebuild a lost protected plane chunk-by-chunk from surviving
        siblings via on-device RowClone (billed through the device
        ledger). Chunks no sibling still holds stay lost."""
        cl = self.cluster
        if cl is None or not getattr(h, "slots", None):
            return
        repaired = 0
        for i, ds in enumerate(h.slots):
            if ds is not None or i in h._stash:
                continue
            if not h.dirty and h._host is not None:
                continue                  # host shadow will fault it in
            src = next((s for s in siblings
                        if getattr(s, "slots", None)
                        and i < len(s.slots)
                        and s.slots[i] is not None), None)
            if src is None:
                continue
            sd, sslot = src.slots[i]
            (new,) = cl._alloc_on(sd, 1, protect=[h] + siblings)
            try:
                cl.devices[sd].migrate_row(sslot, new)
            except AmbitError:
                cl.allocators[sd].free([new])
                raise
            h.slots[i] = (sd, new)
            repaired += 1
        if repaired and self.metrics is not None:
            self.metrics.counter("fault_repaired_chunks").inc(repaired)
        if repaired and self.injector is not None:
            self.injector.note(f"repair plane chunks={repaired}")
        if all(ds is not None or i in h._stash
               or (not h.dirty and h._host is not None)
               for i, ds in enumerate(h.slots)):
            h.lost = False
