"""Bit-accurate functional simulator of an Ambit DRAM device.

Executes raw ACTIVATE/PRECHARGE command streams (and the AAP/AP macros of
Section 4.2) against a modeled subarray with designated rows T0..T3, two
dual-contact-cell rows (DCC0/DCC1), control rows C0/C1, and D-group data
rows. Semantics follow Sections 2-4:

* ACTIVATE from the precharged state connects the addressed wordline(s) to
  the bitlines; charge sharing + sense amplification resolve the row buffer:
    - one d-wordline cell: row buffer = cell (and the cell is restored);
    - one n-wordline (DCC): the capacitor drives bitline-bar, so the row
      buffer resolves to the negated capacitor value (Section 3.2);
    - three cells (TRA): row buffer = bitwise MAJORITY, and *all three*
      cells are overwritten with the result (Section 3.1, issue 3);
    - two cells: only defined when both cells agree (Ambit only issues
      2-wordline addresses as the second ACTIVATE of an AAP); a 2-cell
      activation from precharged state with disagreeing cells is flagged.
* ACTIVATE while the bank is already activated (second ACTIVATE of an AAP)
  overwrites every newly-connected cell with the row-buffer value - through
  the bitline for d-wordlines, negated through bitline-bar for n-wordlines.
* PRECHARGE lowers all wordlines and disables the sense amplifiers.

Batched execution model
-----------------------
The paper's headline claim is *throughput*: every subarray executing an AAP
program operates on its full row buffer in parallel, and many subarrays and
banks run the same program simultaneously (Section 7). `AmbitSubarray`
models that with a leading batch dimension: all row state is held as
``(n_rows, words)`` int64 tensors, and one command stream executes **once**
over all batch rows. Batch row ``i`` behaves exactly like an independent
subarray executing the same program - TRA majority, DCC negation, 2-cell
agreement checks and restore-on-activate are all elementwise, so batching
is a pure vectorization with no behavioral change (the reference package's
differential tests prove bit- and stats-exactness against the per-row path;
tests/test_torch_simulator.py holds this module to the reference).
The timing/energy ledger scales per-macro costs by ``n_rows``: the batch
stands in for ``n_rows`` subarrays each spending the energy and (serially
accounted, as the per-row loop did) the latency.

D-group rows are materialized lazily: a row's backing tensor is only
allocated when first read or written, seeded deterministically per
``(seed, row_index)`` so boot content is independent of access order. This
keeps a 1006-row geometry with a 1024-deep batch from allocating ~0.5 GB of
untouched "undefined" cells.

Rows are stored bit-packed as ``torch.int64`` tensors holding the same bit
patterns as the reference package's ``uint64`` arrays (an all-ones word is
``-1``); all row-wide ops are elementwise tensor ops on the subarray's
device - the card unless the caller names another. Boot content is drawn
with the reference's numpy generators and moved to that device, so
undefined rows hold the reference's bits too. A timing/energy ledger
(timing.py) accumulates per-command costs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import commands as cmd
from .bitvector import resolve_device
from .commands import (AAP, AP, Activate, Command, Macro, Precharge, RowAddr,
                       dcc_capacitor, is_n_wordline, wordlines_for)
from .geometry import DEFAULT_GEOMETRY, DRAMGeometry
from .timing import DEFAULT_TIMING, CommandStats, TimingParams


class AmbitError(RuntimeError):
    """Raised when a command stream has undefined analog behaviour."""


def _rand_rows(rng: np.random.Generator, n: int, words: int,
               device: torch.device) -> torch.Tensor:
    rows = rng.integers(0, np.iinfo(np.uint64).max, size=(n, words),
                        dtype=np.uint64)
    return torch.from_numpy(rows.view(np.int64)).to(device)


def as_words(data, device: torch.device) -> torch.Tensor:
    """Row data -> an int64 tensor on ``device`` with the same bits: a
    tensor of int64 words, or anything numpy takes as ``uint64``."""
    if isinstance(data, torch.Tensor):
        return data.to(device=device, dtype=torch.int64)
    arr = np.ascontiguousarray(data, dtype=np.uint64)
    return torch.from_numpy(arr.view(np.int64)).to(device)


@dataclasses.dataclass
class _SenseAmpState:
    active: bool = False
    rowbuf: Optional[torch.Tensor] = None  # (n_rows, words) when active
    open_wordlines: List[str] = dataclasses.field(default_factory=list)


class AmbitSubarray:
    """One subarray: D-rows + designated/control/DCC rows + sense amps.

    ``n_rows`` is the batch dimension (number of independent subarray
    instances executing the same command stream in lockstep). All cell
    state is ``(n_rows, words)`` int64 on ``device``. The scalar API
    (``write_row`` / ``read_row`` with 1-D ``(words,)`` data) remains
    valid when
    ``n_rows == 1``; batched callers pass/receive ``(n_rows, words)``.
    """

    def __init__(self, geometry: DRAMGeometry = DEFAULT_GEOMETRY,
                 timing: TimingParams = DEFAULT_TIMING,
                 words: Optional[int] = None, seed: int = 0,
                 n_rows: int = 1, device=None):
        if n_rows < 1:
            raise ValueError("n_rows must be >= 1")
        self.device = resolve_device(device)
        self.geom = geometry
        self.timing = timing
        self.words = geometry.row_words if words is None else words
        self.n_rows = n_rows
        self._seed = seed
        # Data rows power up with undefined content (modeled as random);
        # materialized lazily per row index so huge geometries stay cheap.
        self._d_rows: Dict[int, torch.Tensor] = {}
        rng = np.random.default_rng(seed)
        # Designated rows T0..T3 and DCC capacitors also undefined at boot.
        self.t_rows: Dict[str, torch.Tensor] = {
            t: _rand_rows(rng, n_rows, self.words, self.device)
            for t in cmd.T_WORDLINES}
        self.dcc: Dict[str, torch.Tensor] = {
            d: _rand_rows(rng, n_rows, self.words, self.device)
            for d in cmd.DCC_D_WORDLINES}
        # Control rows are initialized at design time (Section 3.1.4).
        self.c_rows = [
            torch.zeros((n_rows, self.words), dtype=torch.int64,
                        device=self.device),
            torch.full((n_rows, self.words), -1, dtype=torch.int64,
                       device=self.device)]
        self.amp = _SenseAmpState()
        self.stats = CommandStats()

    # -- D-group storage (lazy, deterministic boot content) ------------------

    def _check_d_index(self, d_index: int) -> None:
        if not 0 <= d_index < self.geom.data_rows:
            raise IndexError(f"D{d_index} outside the D-group "
                             f"(0..{self.geom.data_rows - 1})")

    def _d_row(self, d_index: int) -> torch.Tensor:
        self._check_d_index(d_index)
        row = self._d_rows.get(d_index)
        if row is None:
            rng = np.random.default_rng((self._seed, d_index))
            row = _rand_rows(rng, self.n_rows, self.words, self.device)
            self._d_rows[d_index] = row
        return row

    # -- software-visible row access (models READ/WRITE via the controller) --

    def _coerce_row(self, data) -> torch.Tensor:
        """Validate/broadcast row data to the (n_rows, words) batch shape."""
        data = as_words(data, self.device)
        if tuple(data.shape) == (self.words,):
            return data.expand(self.n_rows, self.words).clone() \
                if self.n_rows > 1 else data.reshape(1, self.words).clone()
        if tuple(data.shape) == (self.n_rows, self.words):
            return data.clone()
        raise ValueError(
            f"row data must be ({self.words},) or "
            f"({self.n_rows}, {self.words}) uint64, got "
            f"{tuple(data.shape)}")

    def write_row(self, d_index: int, data) -> None:
        if self.amp.active:
            raise AmbitError("WRITE while bank activated is not modeled")
        self._check_d_index(d_index)  # never materialize just to overwrite
        self._d_rows[d_index] = self._coerce_row(data)

    def read_row(self, d_index: int) -> torch.Tensor:
        """Row content: (words,) when n_rows == 1, else (n_rows, words)."""
        row = self._d_row(d_index)
        return row[0].clone() if self.n_rows == 1 else row.clone()

    # -- cell plumbing ------------------------------------------------------

    def _cell_value(self, wl: str) -> torch.Tensor:
        if wl.startswith("T"):
            return self.t_rows[wl]
        if wl.startswith("DCC"):
            return self.dcc[dcc_capacitor(wl)]
        if wl.startswith("C"):
            return self.c_rows[int(wl[1:])]
        if wl.startswith("D"):
            return self._d_row(int(wl[1:]))
        raise KeyError(wl)

    def _set_cell(self, wl: str, value: torch.Tensor) -> None:
        # Cell state is updated by rebinding only (tensors are never mutated
        # in place anywhere in the simulator), so storing `value` without a
        # defensive copy is safe even when several cells alias the same
        # row-buffer array.
        if wl.startswith("T"):
            self.t_rows[wl] = value
        elif wl.startswith("DCC"):
            self.dcc[dcc_capacitor(wl)] = value
        elif wl.startswith("C"):
            # Control rows are pre-initialized constants: restoring the same
            # value (single-cell activate) is fine; overwriting is a bug in
            # the command stream (the controller never targets C rows).
            if not torch.equal(self.c_rows[int(wl[1:])], value):
                raise AmbitError(f"control row {wl} is read-only")
        elif wl.startswith("D"):
            self._check_d_index(int(wl[1:]))
            self._d_rows[int(wl[1:])] = value
        else:
            raise KeyError(wl)

    # -- command execution --------------------------------------------------

    def execute(self, stream: Sequence[Command]) -> None:
        for c in stream:
            if isinstance(c, Activate):
                self._activate(c.addr)
            elif isinstance(c, Precharge):
                self._precharge()
            else:
                raise TypeError(c)

    def run(self, prog: Sequence[Macro]) -> None:
        """Execute a macro (AAP/AP) program once over all batch rows,
        accounting macro-level timing/energy scaled by ``n_rows`` (the
        batch models ``n_rows`` subarrays executing in lockstep)."""
        for m in prog:
            self.stats.add_macro(m, self.timing, rows=self.n_rows)
            self.execute(m.expand())

    def _activate(self, addr: RowAddr) -> None:
        wls = wordlines_for(addr)
        if not self.amp.active:
            self._activate_from_precharged(wls)
        else:
            self._activate_while_active(wls)

    def _activate_from_precharged(self, wls: Sequence[str]) -> None:
        # Effective bitline contribution of each cell: d-wordline cells drive
        # the bitline with their value; an n-wordline DCC drives bitline-bar,
        # equivalent to driving the bitline with its complement.
        contribs = []
        for wl in wls:
            v = self._cell_value(wl)
            contribs.append(~v if is_n_wordline(wl) else v)
        k = len(contribs)
        if k == 1:
            rowbuf = contribs[0]  # aliasing is safe: updates rebind, never
        elif k == 2:              # mutate (see _set_cell)
            if not torch.equal(contribs[0], contribs[1]):
                raise AmbitError(
                    "2-wordline ACTIVATE from precharged state with "
                    "disagreeing cells: bitline deviation is ~0 (undefined). "
                    "Ambit only uses B8-B11 as AAP copy destinations.")
            rowbuf = contribs[0]
        elif k == 3:
            a, b, c = contribs
            rowbuf = (a & b) | (b & c) | (c & a)  # TRA majority, Section 3.1.1
        else:
            raise AmbitError(f"{k}-wordline activation not supported")
        # Sense amplification drives connected cells to the resolved value
        # (restores single cells; overwrites all cells of a TRA - issue 3).
        self.amp = _SenseAmpState(True, rowbuf, list(wls))
        self._drive_connected(wls)

    def _activate_while_active(self, wls: Sequence[str]) -> None:
        # Second ACTIVATE of an AAP: the sense amps are stable, so every
        # newly-raised wordline's cell is overwritten with the row buffer
        # (negated for n-wordline connections).
        assert self.amp.rowbuf is not None
        self._drive_connected(wls)
        self.amp.open_wordlines.extend(wls)

    def _drive_connected(self, wls: Sequence[str]) -> None:
        assert self.amp.rowbuf is not None
        for wl in wls:
            value = ~self.amp.rowbuf if is_n_wordline(wl) else self.amp.rowbuf
            self._set_cell(wl, value)

    def _precharge(self) -> None:
        self.amp = _SenseAmpState()

    # -- high-level op helpers (used by tests/engine) ------------------------

    def bbop(self, op: str, dst: int, *srcs: int) -> None:
        """Run a Figure-20 op on D-group rows: dst = op(*srcs)."""
        tmpl = cmd.OP_TEMPLATES[op]
        args = [cmd.D(s) for s in srcs] + [cmd.D(dst)]
        self.run(tmpl(*args))


class AmbitBank:
    """A bank: a set of subarrays sharing I/O. RowClone-FPM works within a
    subarray; inter-subarray/inter-bank copies use RowClone-PSM (TRANSFER,
    Section 2.4) at cache-line granularity over the internal bus."""

    PSM_NS_PER_CACHELINE = 5.0   # ~pipelined tCCD-limited transfer
    PSM_NJ_PER_CACHELINE = 4.39  # derived from DDR3 channel energy ~ internal

    def __init__(self, geometry: DRAMGeometry = DEFAULT_GEOMETRY,
                 timing: TimingParams = DEFAULT_TIMING,
                 subarrays: Optional[int] = None,
                 words: Optional[int] = None, seed: int = 0, device=None):
        self.geom = geometry
        self.device = resolve_device(device)
        n_sub = geometry.subarrays_per_bank if subarrays is None else subarrays
        self.subarrays = [AmbitSubarray(geometry, timing, words, seed + i,
                                        device=self.device)
                          for i in range(n_sub)]
        self.stats = CommandStats()

    def psm_copy(self, src_sub: int, src_row: int, dst_sub: int,
                 dst_row: int) -> None:
        """RowClone-PSM between subarrays/banks: both rows are activated and
        cache lines are TRANSFERred over the internal bus."""
        data = self.subarrays[src_sub].read_row(src_row)
        self.subarrays[dst_sub].write_row(dst_row, data)
        row_bytes = self.subarrays[src_sub].words * 8
        n_lines = row_bytes // 64
        self.stats.ns += 2 * DEFAULT_TIMING.tRAS + n_lines * \
            self.PSM_NS_PER_CACHELINE + DEFAULT_TIMING.tRP
        self.stats.energy_nj += n_lines * self.PSM_NJ_PER_CACHELINE
        self.stats.activates += 2
        self.stats.precharges += 1

    def total_stats(self) -> CommandStats:
        agg = CommandStats()
        agg.merge(self.stats)
        for s in self.subarrays:
            agg.merge(s.stats)
        return agg


class AmbitDevice:
    """Chip-level view: banks operating in parallel + the bbop ISA (S5.1).

    The driver/allocator abstraction (Section 5.2): `alloc` places bitvector
    pages so corresponding rows of co-operating bitvectors land in the same
    subarray, enabling RowClone-FPM for every staging copy.

    ``bbop`` groups the row slots of one call by destination ``(bank,
    subarray)`` and dispatches each group as a single batched subarray
    execution (the device-model analogue of subarray-level parallelism).
    Calls whose source slots alias destination slots fall back to the
    sequential per-slot path to preserve read-after-write ordering."""

    def __init__(self, geometry: DRAMGeometry = DEFAULT_GEOMETRY,
                 timing: TimingParams = DEFAULT_TIMING,
                 banks: Optional[int] = None, subarrays: Optional[int] = None,
                 words: Optional[int] = None, seed: int = 0,
                 batch_groups: bool = True, device=None):
        self.geom = geometry
        self.timing = timing
        self.device = resolve_device(device)
        n_banks = geometry.banks if banks is None else banks
        self.banks = [AmbitBank(geometry, timing, subarrays, words,
                                seed + 97 * b, device=self.device)
                      for b in range(n_banks)]
        self.words = self.banks[0].subarrays[0].words
        self.row_bytes = self.words * 8
        self.batch_groups = batch_groups
        self._allocator = None  # lazy RowAllocator (pim.allocator)
        # Opt-in span tracing (repro_torch.obs): the runtime swaps in a live
        # Tracer; migrate_row emits RowClone-PSM / inter-bank copy spans.
        from ..obs import NULL_TRACER
        self.tracer = NULL_TRACER
        self.trace_name = "device0"     # track prefix (cluster device idx)
        # Opt-in fault injection (pim.faults): the runtime wires a
        # FaultInjector in; row copies and host accesses then consult it.
        self.fault_injector = None
        self.device_index = 0

    # -- allocator (Section 5.2 driver) --------------------------------------

    @property
    def allocator(self):
        """The device's RowAllocator (created lazily; striped placement
        reproduces the seed bump-cursor order until rows are freed)."""
        if self._allocator is None:
            from ..pim.allocator import RowAllocator  # local: import cycle
            self._allocator = RowAllocator.for_device(self)
        return self._allocator

    def alloc_rows(self, n_rows: int, policy: str = None,
                   near: Sequence[tuple] = None) -> List[tuple]:
        """Allocate row slots (back-compat shim over pim.RowAllocator;
        default striped placement = the seed bump-cursor order).
        Returns [(bank, subarray, row), ...]."""
        return self.allocator.alloc(n_rows, policy=policy, near=near)

    def free_rows(self, slots: Sequence[tuple]) -> None:
        """Release previously allocated row slots for reuse."""
        self.allocator.free(slots)

    # -- bbop ISA (Section 5.1) ----------------------------------------------

    def bbop(self, op: str, dst: Sequence[tuple], *srcs: Sequence[tuple]
             ) -> None:
        """bbop dst, src1[, src2], size - operands are row-slot lists of the
        same length (size = len * row_bytes, a multiple of the row size).

        If corresponding slots are co-located in one subarray, the op runs
        fully in-subarray (RowClone-FPM staging). Otherwise sources are
        first PSM-copied into the destination's subarray (slow path).

        Slots are grouped by destination ``(bank, subarray)`` and each
        group executes its AAP program once, batched over the group's rows
        - unless a source slot aliases a destination slot, in which case
        the call runs slot-by-slot in order (sequential semantics)."""
        slots = [(d, [s[i] for s in srcs]) for i, d in enumerate(dst)]
        if not self.batch_groups or self._has_hazard(slots):
            for d, slot_srcs in slots:
                self._bbop_row(op, d, slot_srcs)
            return
        # fall through: no slot aliases another slot's destination or any
        # staging scratch row, so group execution order cannot matter
        groups: Dict[Tuple[int, int], List[tuple]] = {}
        for d, slot_srcs in slots:
            groups.setdefault((d[0], d[1]), []).append((d, slot_srcs))
        for (db, ds), group in groups.items():
            if len(group) == 1:
                d, slot_srcs = group[0]
                self._bbop_row(op, d, slot_srcs)
            else:
                self._bbop_group(op, db, ds, group)

    def _staging_rows(self, db: int, ds: int, n: int) -> List[int]:
        """Pick ``n`` staging rows in subarray ``(db, ds)``, top-down
        from the end of the D-group, SKIPPING rows the device's
        RowAllocator has live. The naive descending pick clobbered live
        data whenever the allocator's usable region reached the top row
        - an allocator with ``scratch_rows=0`` (the lazy default), or
        optimizer-introduced scratch handles landing in a full subarray
        next to user operands, put real bitvector rows exactly where
        staging writes. Row index never enters the cost model, so the
        skip leaves every ledger byte-identical."""
        alloc = self._allocator      # attribute, not property: never
        rows: List[int] = []         # instantiate one just to ask
        r = self.geom.data_rows - 1
        while len(rows) < n and r >= 0:
            if alloc is None or not alloc.is_live((db, ds, r)):
                rows.append(r)
            r -= 1
        if len(rows) < n:
            # Every row is live (an allocator with scratch_rows=0 can
            # fill the whole D-group): fall back to the legacy top-down
            # pick for the remainder. _has_hazard treats these rows as
            # staging targets, so any within-call alias still forces the
            # sequential path.
            r = self.geom.data_rows - 1
            while len(rows) < n and r >= 0:
                if r not in rows:
                    rows.append(r)
                r -= 1
        if len(rows) < n:
            raise AmbitError(
                f"bbop needs {n} staging rows but bank {db} subarray "
                f"{ds} has only {self.geom.data_rows} data rows")
        return rows

    def _has_hazard(self, slots: List[tuple]) -> bool:
        """True when batched grouping could reorder a read past a write:
        a source slot aliases a destination slot, or a destination/source
        slot aliases a PSM staging row (the allocator-aware top-of-
        D-group pick) that some slot's staging will overwrite."""
        dst_set = {d for d, _ in slots}
        scratch_set = set()
        for (db, ds, _), slot_srcs in slots:
            n_stage = sum(1 for s in slot_srcs if (s[0], s[1]) != (db, ds))
            if n_stage:
                scratch_set.update(
                    (db, ds, r) for r in self._staging_rows(db, ds, n_stage))
        if dst_set & scratch_set:
            return True
        return any(s in dst_set or s in scratch_set
                   for _, slot_srcs in slots for s in slot_srcs)

    def _bbop_group(self, op: str, db: int, ds: int,
                    group: List[tuple]) -> None:
        """One batched dispatch for all slots destined to subarray
        ``(db, ds)``: gather (PSM-staged if needed) source rows, execute the
        op template once over a batch of ``len(group)`` rows, scatter the
        results into the destination rows. Stats are identical to the
        per-slot path (macro costs scale by the batch size; staging costs
        accounted per slot)."""
        sub = self.banks[db].subarrays[ds]
        n = len(group)
        n_srcs = len(group[0][1])
        gathered = [torch.empty((n, self.words), dtype=torch.int64,
                                device=self.device)
                    for _ in range(n_srcs)]
        for gi, (_, slot_srcs) in enumerate(group):
            # Stage exactly as the sequential path does (the same
            # allocator-aware staging rows per slot), gathering each
            # source's value right after its staging so later slots'
            # staging cannot clobber it.
            n_stage = sum(1 for s in slot_srcs
                          if (s[0], s[1]) != (db, ds))
            stage_rows = iter(self._staging_rows(db, ds, n_stage)
                              if n_stage else ())
            for si, s in enumerate(slot_srcs):
                gathered[si][gi] = self._fetch_src(db, ds, s, stage_rows)
        batch = AmbitSubarray(self.geom, self.timing, words=self.words,
                              n_rows=n, device=self.device)
        for si in range(n_srcs):
            batch.write_row(si, gathered[si])
        batch.bbop(op, n_srcs, *range(n_srcs))
        out = batch.read_row(n_srcs).reshape(n, self.words)
        for gi, (d, _) in enumerate(group):
            sub.write_row(d[2], out[gi])
        sub.stats.merge(batch.stats)

    def _fetch_src(self, db: int, ds: int, src: tuple,
                   stage_rows) -> torch.Tensor:
        """Source row content for a slot destined to subarray (db, ds),
        accounting PSM staging cost when the source is not co-located
        (the data still physically lands in the destination subarray's
        next staging row from ``stage_rows``, mirroring the sequential
        path)."""
        sb, ss, sr = src
        bank = self.banks[db]
        if (sb, ss) == (db, ds):
            return bank.subarrays[ds].read_row(sr)
        scratch = next(stage_rows)
        self._stage_psm(db, ds, src, scratch)
        return bank.subarrays[ds].read_row(scratch)

    def migrate_row(self, src: tuple, dst: tuple) -> None:
        """Copy one row between arbitrary slots: intra-bank via
        RowClone-PSM, inter-bank over the channel (same latency/energy
        model, charged to the destination bank). Single cost-model site
        for bbop staging and the pim store's migration planner."""
        inj = self.fault_injector
        if inj is not None:
            inj.check_alive(self.device_index)
        sb, ss, sr = src
        db, ds, dr = dst
        bank = self.banks[db]
        n_lines = self.row_bytes // 64
        if sb == db:
            bank.psm_copy(ss, sr, ds, dr)
            if self.tracer.enabled:
                # mirror psm_copy's charge so the span length IS the cost
                dur = (2 * DEFAULT_TIMING.tRAS
                       + n_lines * AmbitBank.PSM_NS_PER_CACHELINE
                       + DEFAULT_TIMING.tRP)
                self.tracer.tick(
                    (self.trace_name, f"bank{db}", "migrate"),
                    "rowclone_psm", "migrate", dur,
                    args={"src": list(src), "dst": list(dst)})
            self._post_transfer(dst)
            return
        data = self.banks[sb].subarrays[ss].read_row(sr)
        bank.subarrays[ds].write_row(dr, data)
        dur = 2 * DEFAULT_TIMING.tRAS + \
            n_lines * AmbitBank.PSM_NS_PER_CACHELINE
        bank.stats.ns += dur
        bank.stats.energy_nj += n_lines * AmbitBank.PSM_NJ_PER_CACHELINE
        if self.tracer.enabled:
            self.tracer.tick(
                (self.trace_name, f"bank{db}", "migrate"),
                "interbank_copy", "migrate", dur,
                args={"src": list(src), "dst": list(dst)})
        self._post_transfer(dst)

    def _post_transfer(self, dst: tuple) -> None:
        """RowClone fault injection: the copy happened (and was billed);
        the injector may now corrupt the landed row or declare the
        destination stuck (write-verify raises)."""
        inj = self.fault_injector
        if inj is None:
            return
        db, ds, dr = dst
        sub = self.banks[db].subarrays[ds]
        row = sub.read_row(dr)
        out = inj.on_transfer(self.device_index, dst, row)
        if out is not row:
            sub.write_row(dr, out)

    def _stage_psm(self, db: int, ds: int, src: tuple, scratch: int) -> None:
        """Stage a non-co-located source row into scratch row `scratch` of
        subarray (db, ds)."""
        self.migrate_row(src, (db, ds, scratch))

    def _bbop_row(self, op: str, dst: tuple, srcs: List[tuple]) -> None:
        db, ds, dr = dst
        bank = self.banks[db]
        staged = []
        # Staging rows live at the top of the D-group, skipping any the
        # allocator has live (see _staging_rows).
        n_stage = sum(1 for s in srcs if (s[0], s[1]) != (db, ds))
        stage_rows = iter(self._staging_rows(db, ds, n_stage)
                          if n_stage else ())
        for src in srcs:
            if (src[0], src[1]) == (db, ds):
                staged.append(src[2])
            else:  # slow path: stage into the destination subarray
                scratch = next(stage_rows)
                self._stage_psm(db, ds, src, scratch)
                staged.append(scratch)
        bank.subarrays[ds].bbop(op, dr, *staged)

    # -- convenience ----------------------------------------------------------

    def write(self, slots: Sequence[tuple], data) -> None:
        if self.fault_injector is not None:
            self.fault_injector.check_alive(self.device_index)
        data = as_words(data, self.device).reshape(len(slots), self.words)
        for (b, s, r), row in zip(slots, data):
            self.banks[b].subarrays[s].write_row(r, row)

    def read(self, slots: Sequence[tuple]) -> torch.Tensor:
        if self.fault_injector is not None:
            self.fault_injector.check_alive(self.device_index)
        return torch.stack([self.banks[b].subarrays[s].read_row(r)
                         for (b, s, r) in slots])

    def total_stats(self) -> CommandStats:
        agg = CommandStats()
        for b in self.banks:
            agg.merge(b.total_stats())
        return agg
