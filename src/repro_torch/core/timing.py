"""Timing and energy model for the Ambit device.

Timing constants are DDR3-1600 (Table 1). AAP latency follows Section 4.3:
80 ns naive (2*tRAS + tRP), 49 ns with the split row decoder, which applies
whenever exactly one of the two ACTIVATEs targets a B-group address (the
paper notes one AAP in `nand` - AAP(B12, B5) - cannot overlap; plain
data->data AAPs are RowClone-FPM at 80 ns).

Energy follows Section 7: activation energy grows 22% per additional raised
wordline. The base activation energy E_ACT is calibrated so the per-op
energies reproduce Table 4 (nJ/KB) to within ~5%:

    op        paper   model
    not       1.6     1.53
    and/or    3.2     3.24
    nand/nor  4.0     4.01
    xor       5.5     5.36

DDR3 baseline energy is modeled as channel-energy-per-byte-moved, derived
from Table 4's DDR3 row (93.7 nJ/KB for `not` = 2 KB moved per KB of result
=> ~45.9-46.9 nJ per KB moved).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from .commands import AAP, AP, Macro, RowAddr, num_wordlines


@dataclasses.dataclass(frozen=True)
class TimingParams:
    # Table 1 (DDR3-1600), nanoseconds.
    tRAS: float = 35.0
    tRCD: float = 15.0
    tRP: float = 15.0
    tWR: float = 15.0
    # Section 4.3.
    aap_naive_ns: float = 80.0      # 2*tRAS + tRP, paper quotes 80 ns
    aap_overlap_extra_ns: float = 4.0  # back-to-back ACTs cost tRAS + 4 ns
    # Rank-level four-activate window (DDR3-1600 1KB-page tFAW).
    tFAW: float = 40.0
    # Refresh (DDR3 8Gb-class): one all-bank refresh every tREFI, each
    # stalling the bank for tRFC. Banks lose tRFC out of every tREFI of
    # wall clock, a steady-state ~4.7% throughput tax.
    tREFI: float = 7800.0
    tRFC: float = 350.0
    # Section 7 energy model.
    e_act_nj: float = 3.07           # calibrated base activation energy
    extra_wordline_factor: float = 0.22
    # DDR3 channel energy per KB moved (derived from Table 4, see module doc).
    ddr3_nj_per_kb_moved: float = 46.0

    @property
    def ap_ns(self) -> float:
        return self.tRAS + self.tRP  # 50 ns

    @property
    def refresh_overhead(self) -> float:
        """Steady-state stolen-time fraction: for every unit of useful busy
        time the bank also sits through tRFC/(tREFI - tRFC) of refresh."""
        return self.tRFC / (self.tREFI - self.tRFC)

    def refresh_stolen_ns(self, busy_ns: float) -> float:
        """Refresh time interleaved with ``busy_ns`` of useful bank work in
        steady state (amortized model; the event-accurate timeline lives in
        ``refresh_schedule``)."""
        return busy_ns * self.refresh_overhead

    @property
    def aap_opt_ns(self) -> float:
        # overlapped ACT-ACT (tRAS + 4 ns) + precharge
        return self.tRAS + self.aap_overlap_extra_ns + self.tRP  # 54 ns... see note

    def aap_ns(self, src: RowAddr, dst: RowAddr) -> float:
        """Latency of one AAP. The split decoder overlaps the two ACTIVATEs
        when exactly one address is in the B-group (Section 4.3)."""
        b_count = (src.group == "B") + (dst.group == "B")
        if b_count == 1:
            return 49.0  # paper's SPICE-derived figure for DDR3-1600
        return self.aap_naive_ns


DEFAULT_TIMING = TimingParams()


# -- refresh windows ----------------------------------------------------------
# The k-th refresh window occupies [k*tREFI, k*tREFI + tRFC), k >= 1 (the
# first refresh falls due one tREFI after the epoch starts). No command may
# issue inside a window; the two helpers below place work around them.


def _next_window(t_ns: float, params: TimingParams):
    """(start, end) of the first refresh window ending after ``t_ns``."""
    k = max(1, int(t_ns // params.tREFI))
    start = k * params.tREFI
    if t_ns >= start + params.tRFC:
        start += params.tREFI
    return start, start + params.tRFC


def defer_for_refresh(t_ns: float, dur_ns: float,
                      params: TimingParams = DEFAULT_TIMING) -> float:
    """Issue time for an *atomic* burst of ``dur_ns`` wanting to start at
    ``t_ns``: if the burst would start inside or straddle a refresh window
    it is deferred until the window closes. Bursts must fit between
    consecutive windows (every Ambit macro does: <= 85 ns vs 7450 ns)."""
    if dur_ns > params.tREFI - params.tRFC:
        raise ValueError(
            f"atomic burst of {dur_ns} ns cannot fit between refresh "
            f"windows ({params.tREFI - params.tRFC} ns apart)")
    while True:
        start, end = _next_window(t_ns, params)
        if t_ns + dur_ns <= start or t_ns >= end:
            return t_ns
        t_ns = end


def refresh_schedule(start_ns: float, work_ns: float,
                     params: TimingParams = DEFAULT_TIMING):
    """Lay ``work_ns`` of *pausable* work on the wall clock from
    ``start_ns``, pausing through every refresh window it crosses.
    Returns ``(work_start_ns, finish_ns)``; the stolen time is
    ``finish - work_start - work_ns``."""
    t = start_ns
    win_start, win_end = _next_window(t, params)
    if win_start <= t < win_end:
        t = win_end
    work_start = t
    remaining = work_ns
    while remaining > 0:
        win_start, win_end = _next_window(t, params)
        slice_ns = min(remaining, win_start - t)
        t += slice_ns
        remaining -= slice_ns
        if remaining > 0:
            t = win_end
    return work_start, t


@dataclasses.dataclass
class CommandStats:
    """Ledger accumulated while executing Ambit programs."""

    activates: int = 0
    wordlines: int = 0
    precharges: int = 0
    aap_count: int = 0
    ap_count: int = 0
    ns: float = 0.0
    energy_nj: float = 0.0

    def add_activate(self, addr: RowAddr, params: TimingParams,
                     rows: int = 1) -> None:
        n_wl = num_wordlines(addr)
        self.activates += rows
        self.wordlines += rows * n_wl
        self.energy_nj += rows * params.e_act_nj * (
            1.0 + params.extra_wordline_factor * (n_wl - 1))

    def add_macro(self, macro: Macro, params: TimingParams,
                  rows: int = 1) -> None:
        """Account one macro executed over a batch of ``rows`` subarray rows
        (batched execution: the costs of every lockstep instance are summed,
        exactly as the per-row loop summed them)."""
        if isinstance(macro, AAP):
            self.aap_count += rows
            self.ns += rows * params.aap_ns(macro.src, macro.dst)
            self.add_activate(macro.src, params, rows)
            self.add_activate(macro.dst, params, rows)
            self.precharges += rows
        elif isinstance(macro, AP):
            self.ap_count += rows
            self.ns += rows * params.ap_ns
            self.add_activate(macro.addr, params, rows)
            self.precharges += rows
        else:
            raise TypeError(macro)

    def merge(self, other: "CommandStats") -> None:
        self.activates += other.activates
        self.wordlines += other.wordlines
        self.precharges += other.precharges
        self.aap_count += other.aap_count
        self.ap_count += other.ap_count
        self.ns += other.ns
        self.energy_nj += other.energy_nj


def program_stats(prog: Sequence[Macro],
                  params: TimingParams = DEFAULT_TIMING) -> CommandStats:
    st = CommandStats()
    for m in prog:
        st.add_macro(m, params)
    return st


def op_energy_nj_per_kb(op: str, params: TimingParams = DEFAULT_TIMING,
                        row_bytes: int = 8192) -> float:
    """Modeled Ambit energy per KB of result for a Figure-20 op."""
    from .commands import D, OP_ARITY, OP_TEMPLATES  # local: avoid cycle

    tmpl = OP_TEMPLATES[op]
    args = [D(i) for i in range(OP_ARITY[op])]
    prog = tmpl(*args)
    st = program_stats(prog, params)
    return st.energy_nj / (row_bytes / 1024.0)


def ddr3_energy_nj_per_kb(op: str,
                          params: TimingParams = DEFAULT_TIMING) -> float:
    """Baseline: CPU reads sources over the channel and writes the result."""
    kb_moved = {"not": 2.0, "copy": 2.0, "zero": 1.0, "one": 1.0}.get(op, 3.0)
    return params.ddr3_nj_per_kb_moved * kb_moved


# Paper's Table 4 reference values (nJ/KB) for validation/benchmarks.
TABLE4_PAPER = {
    "ddr3": {"not": 93.7, "and": 137.9, "or": 137.9, "nand": 137.9,
             "nor": 137.9, "xor": 137.9, "xnor": 137.9},
    "ambit": {"not": 1.6, "and": 3.2, "or": 3.2, "nand": 4.0, "nor": 4.0,
              "xor": 5.5, "xnor": 5.5},
}

# Paper's Table 3: TRA failure rate vs process variation (for validation).
TABLE3_PAPER = {0.00: 0.0, 0.05: 0.0, 0.10: 0.0029, 0.15: 0.0601,
                0.20: 0.1636, 0.25: 0.2619}
