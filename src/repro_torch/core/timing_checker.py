"""DRAM timing-rule checker: a differential oracle for command streams.

The cost model (timing.py) *prices* AAP/AP/PSM macros; nothing until now
checked that the streams the compiler and simulator emit could legally
issue on a DDR3 bank. This module closes that gap: ``schedule_program``
replays a macro program into per-command issue times and ``TimingChecker``
validates the timed stream against a declarative rule table (tRP, tRCD,
tRAS, tRC, tWR, rank-level tFAW, refresh windows, and bank open/close
discipline), reporting structured ``TimingViolation`` records instead of
a pass/fail bit. Inspired by the timing checkers DRAM controller
generators ship for their command schedulers.

Replay semantics
----------------
The checker builds its own *rule-consistent* schedule rather than forcing
the paper's SPICE-derived cost figures onto the command clock:

  * optimized AAP (split row decoder, Section 4.3): ACT @ t, the paired
    ACT @ t + aap_overlap_extra_ns, PRE @ t + tRAS - restoration of both
    rows completes within one shared sense-amplifier cycle, so tRAS is
    honored from the *first* ACTIVATE. Macro occupancy tRAS + tRP.
  * naive AAP (RowClone-FPM): ACT @ t, ACT @ t + tRAS, PRE @ t + 2*tRAS;
    occupancy 2*tRAS + tRP.
  * AP: ACT @ t, PRE @ t + tRAS; occupancy tRAS + tRP.
  * PSM copy (``schedule_psm_copy``): source ACT, destination ACT one
    tRAS later, one column WRITE per cache line every
    ``PSM_NS_PER_CACHELINE``, PRE after the last write - this is the one
    stream exercising tRCD and tWR.

These occupancies are the *rule floor* (50/85 ns), intentionally looser
than the cost model's 49/80 ns SPICE figures - the checker answers "is
this stream legal?", the cost model answers "what does it cost?"; keeping
them independent is what makes the replay a differential oracle.

A second ACTIVATE to an already-open bank is legal only as the paired
ACT of the same macro (``macro_id`` ties commands to the macro that
emitted them); any other ACT-while-open is a missing PRECHARGE. tFAW is
checked at *rank* level - a rolling window over ACTs across all banks -
so cross-bank streams can violate it even when every bank is
individually legal.

Refresh: no command may issue inside a refresh window ([k*tREFI,
k*tREFI + tRFC), timing.py). ``schedule_program(refresh_aware=True)``
defers each macro past windows exactly like a controller holding
commands during REF; scheduling with ``refresh_aware=False`` documents
what the checker catches when nobody does.

Run ``python -m repro_torch.core.timing_checker`` to verify every
canonical program (Figure-20 templates plus compiled expressions,
optimized and naive); it prints the reference package's line.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .commands import AAP, AP, D, Macro, OP_ARITY, OP_TEMPLATES, RowAddr
from .simulator import AmbitBank, AmbitError
from .timing import DEFAULT_TIMING, TimingParams, defer_for_refresh

_EPS = 1e-6  # float-comparison slack, well under any real timing margin


# -- the rule table -----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TimingRule:
    """One named constraint; ``gap`` is the minimum spacing it demands."""

    name: str
    description: str
    gap: Optional[Callable[[TimingParams], float]] = None


RULES: Tuple[TimingRule, ...] = (
    TimingRule("tRP", "PRECHARGE -> next ACTIVATE, same bank",
               lambda p: p.tRP),
    TimingRule("tRCD", "ACTIVATE -> first column access, same bank",
               lambda p: p.tRCD),
    TimingRule("tRAS", "first ACTIVATE -> PRECHARGE, same bank",
               lambda p: p.tRAS),
    TimingRule("tRC", "ACTIVATE -> ACTIVATE of the next macro, same bank",
               lambda p: p.tRAS + p.tRP),
    TimingRule("tWR", "last WRITE -> PRECHARGE, same bank",
               lambda p: p.tWR),
    TimingRule("tFAW", "at most four ACTIVATEs across the rank per "
               "rolling tFAW window", lambda p: p.tFAW),
    TimingRule("refresh", "no command inside a [k*tREFI, k*tREFI+tRFC) "
               "refresh window", lambda p: p.tRFC),
    TimingRule("open-bank", "ACTIVATE while open only as a macro's paired "
               "second ACTIVATE; columns only while open; streams close "
               "every bank", None),
)

RULES_BY_NAME: Dict[str, TimingRule] = {r.name: r for r in RULES}


# -- timed command streams ----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TimedCommand:
    """One DRAM command on the wall clock. ``macro_id`` identifies the
    macro that emitted it (ties an AAP's paired ACTIVATEs together)."""

    t_ns: float
    kind: str  # "ACT" | "PRE" | "WR"
    bank: int
    macro_id: int
    addr: Optional[RowAddr] = None


@dataclasses.dataclass(frozen=True)
class TimingViolation:
    rule: str
    bank: int
    t_ns: float
    message: str


class TimingViolationError(AmbitError):
    """Raised by ``verify_program`` when a stream breaks the rule table."""

    def __init__(self, violations: Sequence[TimingViolation]):
        self.violations = list(violations)
        head = "; ".join(v.message for v in self.violations[:3])
        more = len(self.violations) - 3
        tail = f" (+{more} more)" if more > 0 else ""
        super().__init__(
            f"{len(self.violations)} timing violation(s): {head}{tail}")


def _is_split(m: AAP) -> bool:
    return ((m.src.group == "B") + (m.dst.group == "B")) == 1


def schedule_program(prog: Sequence[Macro],
                     params: TimingParams = DEFAULT_TIMING,
                     bank: int = 0, start_ns: float = 0.0,
                     refresh_aware: bool = True) -> List[TimedCommand]:
    """Replay a macro program into per-command issue times (semantics in
    the module docstring). With ``refresh_aware`` each macro is deferred
    past refresh windows, as a real controller would hold it."""
    events: List[TimedCommand] = []
    t = start_ns
    for mid, m in enumerate(prog):
        if isinstance(m, AAP):
            if _is_split(m):
                act2, pre = params.aap_overlap_extra_ns, params.tRAS
            else:
                act2, pre = params.tRAS, 2 * params.tRAS
            dur = pre + params.tRP
            if refresh_aware:
                t = defer_for_refresh(t, dur, params)
            events.append(TimedCommand(t, "ACT", bank, mid, m.src))
            events.append(TimedCommand(t + act2, "ACT", bank, mid, m.dst))
            events.append(TimedCommand(t + pre, "PRE", bank, mid))
            t += dur
        elif isinstance(m, AP):
            dur = params.ap_ns
            if refresh_aware:
                t = defer_for_refresh(t, dur, params)
            events.append(TimedCommand(t, "ACT", bank, mid, m.addr))
            events.append(TimedCommand(t + params.tRAS, "PRE", bank, mid))
            t += dur
        else:
            raise TypeError(m)
    return events


def schedule_psm_copy(n_lines: int, params: TimingParams = DEFAULT_TIMING,
                      bank: int = 0, start_ns: float = 0.0,
                      macro_id: int = 0,
                      refresh_aware: bool = True) -> List[TimedCommand]:
    """Replay one RowClone-PSM copy (simulator.AmbitBank.psm_copy): read
    the source row open, open the destination, stream ``n_lines`` column
    writes, precharge. Matches the cost model's
    2*tRAS + n*PSM_NS_PER_CACHELINE + tRP occupancy."""
    per_line = AmbitBank.PSM_NS_PER_CACHELINE
    dur = 2 * params.tRAS + n_lines * per_line + params.tRP
    t = start_ns
    if refresh_aware:
        t = defer_for_refresh(t, dur, params)
    events = [TimedCommand(t, "ACT", bank, macro_id),
              TimedCommand(t + params.tRAS, "ACT", bank, macro_id)]
    first_wr = t + params.tRAS + params.tRCD
    for i in range(n_lines):
        events.append(TimedCommand(first_wr + i * per_line, "WR", bank,
                                   macro_id))
    events.append(TimedCommand(t + dur - params.tRP, "PRE", bank, macro_id))
    return events


# -- the checker --------------------------------------------------------------


@dataclasses.dataclass
class _BankState:
    open_since: Optional[float] = None   # first ACT of the open macro
    open_macro: Optional[int] = None
    acts_in_macro: int = 0
    last_pre: Optional[float] = None
    last_act: Optional[float] = None     # first ACT of the previous macro
    last_wr: Optional[float] = None


class TimingChecker:
    """Validates a timed command stream against ``RULES``.

    ``check`` returns every violation found (empty list = legal stream);
    ``verify_program`` schedules a macro program and raises
    ``TimingViolationError`` if its replay is illegal.
    """

    def __init__(self, params: TimingParams = DEFAULT_TIMING,
                 check_refresh: bool = True):
        self.params = params
        self.check_refresh = check_refresh

    # rule helpers ------------------------------------------------------------

    def _gap(self, rule: str) -> float:
        return RULES_BY_NAME[rule].gap(self.params)

    def _in_refresh_window(self, t: float) -> bool:
        p = self.params
        k = int((t + _EPS) // p.tREFI)
        return k >= 1 and t < k * p.tREFI + p.tRFC - _EPS

    @staticmethod
    def _viol(rule: str, bank: int, t: float, msg: str) -> TimingViolation:
        return TimingViolation(rule, bank, t, f"[{rule}] {msg} @ {t:.1f} ns")

    # the replay --------------------------------------------------------------

    def check(self, events: Sequence[TimedCommand]) -> List[TimingViolation]:
        p = self.params
        out: List[TimingViolation] = []
        banks: Dict[int, _BankState] = {}
        rank_acts: deque = deque(maxlen=4)  # rank-level tFAW window

        for ev in sorted(events, key=lambda e: e.t_ns):
            st = banks.setdefault(ev.bank, _BankState())
            t = ev.t_ns
            if self.check_refresh and self._in_refresh_window(t):
                out.append(self._viol(
                    "refresh", ev.bank, t,
                    f"{ev.kind} issued inside a refresh window "
                    f"(tREFI={p.tREFI:g}, tRFC={p.tRFC:g})"))
            if ev.kind == "ACT":
                if st.open_since is not None:
                    if (ev.macro_id == st.open_macro
                            and st.acts_in_macro == 1):
                        st.acts_in_macro = 2  # the macro's paired ACT
                    else:
                        out.append(self._viol(
                            "open-bank", ev.bank, t,
                            f"ACT to bank {ev.bank} while row open since "
                            f"{st.open_since:.1f} ns (missing PRECHARGE)"))
                else:
                    if st.last_pre is not None and \
                            t - st.last_pre < self._gap("tRP") - _EPS:
                        out.append(self._viol(
                            "tRP", ev.bank, t,
                            f"ACT {t - st.last_pre:.1f} ns after PRECHARGE "
                            f"(tRP={p.tRP:g})"))
                    if st.last_act is not None and \
                            t - st.last_act < self._gap("tRC") - _EPS:
                        out.append(self._viol(
                            "tRC", ev.bank, t,
                            f"ACT {t - st.last_act:.1f} ns after previous "
                            f"ACT (tRC={p.tRAS + p.tRP:g})"))
                    st.open_since = t
                    st.open_macro = ev.macro_id
                    st.acts_in_macro = 1
                    st.last_act = t
                    st.last_wr = None
                if len(rank_acts) == 4 and \
                        t - rank_acts[0] < self._gap("tFAW") - _EPS:
                    out.append(self._viol(
                        "tFAW", ev.bank, t,
                        f"5th ACT across the rank only "
                        f"{t - rank_acts[0]:.1f} ns after the 4th-previous "
                        f"(tFAW={p.tFAW:g})"))
                rank_acts.append(t)
            elif ev.kind == "WR":
                if st.open_since is None:
                    out.append(self._viol(
                        "open-bank", ev.bank, t,
                        f"column WRITE to bank {ev.bank} with no open row"))
                else:
                    if t - st.open_since < self._gap("tRCD") - _EPS:
                        out.append(self._viol(
                            "tRCD", ev.bank, t,
                            f"WRITE {t - st.open_since:.1f} ns after ACT "
                            f"(tRCD={p.tRCD:g})"))
                    st.last_wr = t
            elif ev.kind == "PRE":
                if st.open_since is not None:
                    if t - st.open_since < self._gap("tRAS") - _EPS:
                        out.append(self._viol(
                            "tRAS", ev.bank, t,
                            f"PRECHARGE {t - st.open_since:.1f} ns after "
                            f"ACT (tRAS={p.tRAS:g})"))
                    if st.last_wr is not None and \
                            t - st.last_wr < self._gap("tWR") - _EPS:
                        out.append(self._viol(
                            "tWR", ev.bank, t,
                            f"PRECHARGE {t - st.last_wr:.1f} ns after "
                            f"WRITE (tWR={p.tWR:g})"))
                # PRE to an idle bank is a harmless no-op, as on real DDR.
                st.open_since = None
                st.open_macro = None
                st.acts_in_macro = 0
                st.last_pre = t
                st.last_wr = None
            else:
                raise ValueError(f"unknown command kind {ev.kind!r}")

        for b in sorted(banks):
            st = banks[b]
            if st.open_since is not None:
                out.append(self._viol(
                    "open-bank", b, st.open_since,
                    f"stream ends with bank {b} still activated "
                    "(missing final PRECHARGE)"))
        return out

    def verify_program(self, prog: Sequence[Macro], bank: int = 0,
                       start_ns: float = 0.0,
                       refresh_aware: bool = True) -> List[TimedCommand]:
        """Schedule + check; raises TimingViolationError on any violation,
        returns the legal timed stream otherwise."""
        events = schedule_program(prog, self.params, bank=bank,
                                  start_ns=start_ns,
                                  refresh_aware=refresh_aware)
        violations = self.check(events)
        if violations:
            raise TimingViolationError(violations)
        return events


# -- the CI oracle: canonical programs ---------------------------------------


def _rand_expr(rng, depth: int = 0):
    """Small deterministic expression generator (mirrors the compiler's
    property tests) so the oracle covers optimizer-shaped streams, not
    just the hand-written templates."""
    from . import expr as E
    names = ["a", "b", "c", "d"]
    if depth >= 3 or rng.random() < 0.3:
        e = E.Expr.var(names[int(rng.integers(len(names)))])
        return ~e if rng.random() < 0.3 else e
    k = rng.random()
    if k < 0.25:
        return ~_rand_expr(rng, depth + 1)
    if k < 0.45:
        return E.maj(_rand_expr(rng, depth + 1), _rand_expr(rng, depth + 1),
                     _rand_expr(rng, depth + 1))
    op = ["__and__", "__or__", "__xor__"][int(rng.integers(3))]
    return getattr(_rand_expr(rng, depth + 1), op)(
        _rand_expr(rng, depth + 1))


def canonical_programs(n_random: int = 24) -> List[Tuple[str, Sequence[Macro]]]:
    """The oracle's program set: every Figure-20 template at canonical
    addresses plus deterministic random expressions through the compiler,
    optimized and naive."""
    import numpy as np

    from .compiler import compile_expr

    progs: List[Tuple[str, Sequence[Macro]]] = []
    for op in sorted(OP_TEMPLATES):
        args = [D(i) for i in range(OP_ARITY[op])]
        progs.append((f"fig20:{op}", tuple(OP_TEMPLATES[op](*args))))
    var_rows = {"a": 0, "b": 1, "c": 2, "d": 3}
    for i in range(n_random):
        expr = _rand_expr(np.random.default_rng(3000 + i))
        for optimize in (False, True):
            cp = compile_expr(expr, var_rows, dst_row=4, optimize=optimize)
            tag = "opt" if optimize else "naive"
            progs.append((f"compile[{tag}]:{i}", cp.program))
    return progs


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Verify canonical Ambit command streams against the "
                    "DRAM timing-rule table.")
    ap.add_argument("--n-random", type=int, default=24,
                    help="random compiled expressions per optimize mode")
    ap.add_argument("--psm-lines", type=int, default=128,
                    help="cache lines in the PSM-copy stream (128 = 8KB row)")
    args = ap.parse_args(argv)

    checker = TimingChecker()
    n_cmds = 0
    failed: List[Tuple[str, List[TimingViolation]]] = []
    progs = canonical_programs(args.n_random)
    for name, prog in progs:
        events = schedule_program(prog)
        n_cmds += len(events)
        violations = checker.check(events)
        if violations:
            failed.append((name, violations))
    psm = schedule_psm_copy(args.psm_lines)
    n_cmds += len(psm)
    v = checker.check(psm)
    if v:
        failed.append((f"psm:{args.psm_lines}", v))

    total = len(progs) + 1
    if failed:
        print(f"timing-oracle: {len(failed)}/{total} streams ILLEGAL")
        for name, violations in failed:
            for viol in violations:
                print(f"  {name}: {viol.message}")
        return 1
    print(f"timing-oracle: {total} streams, {n_cmds} commands, "
          f"0 violations against {len(RULES)} rules "
          f"({', '.join(r.name for r in RULES)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
