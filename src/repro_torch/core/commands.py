"""Ambit command IR: row addresses, the Table-2 B-group mapping, and the
AAP/AP macro primitives with the Figure-20 operation templates.

Address spaces (Section 4.1):
  * B-group: B0..B15  -> reserved addresses that activate 1, 2 or 3 wordlines
    of the designated rows (T0..T3) and the dual-contact-cell rows.
  * C-group: C0 (all zeros), C1 (all ones).
  * D-group: D0..D<n> data rows.

Wordlines: "T0".."T3" are ordinary cells. Each DCC row has a d-wordline
("DCC0"/"DCC1": capacitor <-> bitline) and an n-wordline ("DCC0N"/"DCC1N":
capacitor <-> bitline-bar), per Section 3.2.

Macro timing/energy is a pure function of each macro's address *groups*
(B/C/D), never of concrete D-row indices - which is what lets the batched
simulator account a whole row batch by scaling per-macro costs
(CommandStats.add_macro(..., rows=n)) and lets the device dispatcher run
one canonical-address template for a group of row slots.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Sequence, Tuple, Union

# ---------------------------------------------------------------------------
# Wordline names
# ---------------------------------------------------------------------------

T_WORDLINES = ("T0", "T1", "T2", "T3")
DCC_D_WORDLINES = ("DCC0", "DCC1")
DCC_N_WORDLINES = ("DCC0N", "DCC1N")
ALL_B_WORDLINES = T_WORDLINES + DCC_D_WORDLINES + DCC_N_WORDLINES


def is_n_wordline(wl: str) -> bool:
    return wl.endswith("N")


def dcc_capacitor(wl: str) -> str:
    """Capacitor name backing a DCC wordline ("DCC0N" -> "DCC0")."""
    return wl[:-1] if wl.endswith("N") else wl


# ---------------------------------------------------------------------------
# Row addresses
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RowAddr:
    group: str  # "B" | "C" | "D"
    index: int

    def __post_init__(self):
        if self.group not in ("B", "C", "D"):
            raise ValueError(f"bad group {self.group}")
        if self.group == "B" and not (0 <= self.index < 16):
            raise ValueError("B-group has addresses B0..B15")
        if self.group == "C" and self.index not in (0, 1):
            raise ValueError("C-group has addresses C0, C1")
        if self.index < 0:
            raise ValueError("negative row index")

    def __repr__(self):
        return f"{self.group}{self.index}"


def B(i: int) -> RowAddr:
    return RowAddr("B", i)


def C(i: int) -> RowAddr:
    return RowAddr("C", i)


def D(i: int) -> RowAddr:
    return RowAddr("D", i)


# Table 2: mapping of B-group addresses to activated wordlines.
B_GROUP_WORDLINES: dict[int, Tuple[str, ...]] = {
    0: ("T0",),
    1: ("T1",),
    2: ("T2",),
    3: ("T3",),
    4: ("DCC0",),
    5: ("DCC0N",),
    6: ("DCC1",),
    7: ("DCC1N",),
    8: ("DCC0N", "T0"),
    9: ("DCC1N", "T1"),
    10: ("T2", "T3"),
    11: ("T0", "T3"),
    12: ("T0", "T1", "T2"),
    13: ("T1", "T2", "T3"),
    14: ("DCC0", "T1", "T2"),
    15: ("DCC1", "T0", "T3"),
}


def wordlines_for(addr: RowAddr) -> Tuple[str, ...]:
    """Wordlines raised by an ACTIVATE to `addr` (B-group fan-out per Table 2)."""
    if addr.group == "B":
        return B_GROUP_WORDLINES[addr.index]
    return (repr(addr),)  # C/D rows raise their own single wordline


def num_wordlines(addr: RowAddr) -> int:
    return len(wordlines_for(addr))


# ---------------------------------------------------------------------------
# Commands
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Activate:
    addr: RowAddr

    def __repr__(self):
        return f"ACTIVATE {self.addr!r}"


@dataclasses.dataclass(frozen=True)
class Precharge:
    def __repr__(self):
        return "PRECHARGE"


Command = Union[Activate, Precharge]


@dataclasses.dataclass(frozen=True)
class AAP:
    """ACTIVATE-ACTIVATE-PRECHARGE (Section 4.2).

    Copies the result of activating `src` into the row(s) mapped to `dst`.
    """

    src: RowAddr
    dst: RowAddr

    def expand(self) -> List[Command]:
        return [Activate(self.src), Activate(self.dst), Precharge()]

    def __repr__(self):
        return f"AAP({self.src!r}, {self.dst!r})"


@dataclasses.dataclass(frozen=True)
class AP:
    """ACTIVATE-PRECHARGE (Section 4.2)."""

    addr: RowAddr

    def expand(self) -> List[Command]:
        return [Activate(self.addr), Precharge()]

    def __repr__(self):
        return f"AP({self.addr!r})"


Macro = Union[AAP, AP]


def expand_program(prog: Sequence[Macro]) -> List[Command]:
    out: List[Command] = []
    for m in prog:
        out.extend(m.expand())
    return out


# ---------------------------------------------------------------------------
# Figure 20 operation templates
# ---------------------------------------------------------------------------
# Each template returns the macro program computing dst = op(srcs...).
# Comments mirror Figure 20's annotations.


def seq_not(di: RowAddr, dk: RowAddr) -> List[Macro]:
    return [
        AAP(di, B(5)),   # DCC0 = !Di   (n-wordline capture, Fig. 18)
        AAP(B(4), dk),   # Dk   = DCC0
    ]


def seq_and(di: RowAddr, dj: RowAddr, dk: RowAddr) -> List[Macro]:
    return [
        AAP(di, B(0)),    # T0 = Di
        AAP(dj, B(1)),    # T1 = Dj
        AAP(C(0), B(2)),  # T2 = 0
        AAP(B(12), dk),   # Dk = MAJ(T0,T1,0) = T0 & T1
    ]


def seq_or(di: RowAddr, dj: RowAddr, dk: RowAddr) -> List[Macro]:
    return [
        AAP(di, B(0)),    # T0 = Di
        AAP(dj, B(1)),    # T1 = Dj
        AAP(C(1), B(2)),  # T2 = 1
        AAP(B(12), dk),   # Dk = MAJ(T0,T1,1) = T0 | T1
    ]


def seq_nand(di: RowAddr, dj: RowAddr, dk: RowAddr) -> List[Macro]:
    return [
        AAP(di, B(0)),     # T0 = Di
        AAP(dj, B(1)),     # T1 = Dj
        AAP(C(0), B(2)),   # T2 = 0
        AAP(B(12), B(5)),  # DCC0 = !(T0 & T1)
        AAP(B(4), dk),     # Dk = DCC0
    ]


def seq_nor(di: RowAddr, dj: RowAddr, dk: RowAddr) -> List[Macro]:
    return [
        AAP(di, B(0)),     # T0 = Di
        AAP(dj, B(1)),     # T1 = Dj
        AAP(C(1), B(2)),   # T2 = 1
        AAP(B(12), B(5)),  # DCC0 = !(T0 | T1)
        AAP(B(4), dk),     # Dk = DCC0
    ]


def seq_xor(di: RowAddr, dj: RowAddr, dk: RowAddr) -> List[Macro]:
    # Dk = (Di & !Dj) | (!Di & Dj)   (Figure 20c)
    return [
        AAP(di, B(8)),    # DCC0 = !Di, T0 = Di
        AAP(dj, B(9)),    # DCC1 = !Dj, T1 = Dj
        AAP(C(0), B(10)),  # T2 = T3 = 0
        AP(B(14)),        # T1 = DCC0 & T1   (TRA DCC0,T1,T2)
        AP(B(15)),        # T0 = DCC1 & T0   (TRA DCC1,T0,T3)
        AAP(C(1), B(2)),  # T2 = 1
        AAP(B(12), dk),   # Dk = T0 | T1
    ]


def seq_xnor(di: RowAddr, dj: RowAddr, dk: RowAddr) -> List[Macro]:
    """Dk = !(Di xor Dj): the xor skeleton with the final combine routed
    through DCC0's n-wordline (the same negate-on-output trick nand uses).
    By the final step both DCC capacitors have been consumed as xor
    intermediates, so DCC0 is free to capture the negated combine."""
    return [
        AAP(di, B(8)),    # DCC0 = !Di, T0 = Di
        AAP(dj, B(9)),    # DCC1 = !Dj, T1 = Dj
        AAP(C(0), B(10)),  # T2 = T3 = 0
        AP(B(14)),        # T1 = DCC0 & T1 = !Di & Dj
        AP(B(15)),        # T0 = DCC1 & T0 = Di & !Dj
        AAP(C(1), B(2)),  # T2 = 1
        AAP(B(12), B(5)),  # DCC0 = !(T0 | T1) = xnor
        AAP(B(4), dk),    # Dk = DCC0
    ]


def seq_maj3(di: RowAddr, dj: RowAddr, dl: RowAddr, dk: RowAddr) -> List[Macro]:
    """Dk = MAJ(Di, Dj, Dl) - the raw TRA primitive exposed (Section 3.1.1)."""
    return [
        AAP(di, B(0)),   # T0 = Di
        AAP(dj, B(1)),   # T1 = Dj
        AAP(dl, B(2)),   # T2 = Dl
        AAP(B(12), dk),  # Dk = MAJ(T0,T1,T2)
    ]


def seq_copy(di: RowAddr, dk: RowAddr) -> List[Macro]:
    """RowClone-FPM: two back-to-back ACTIVATEs + PRECHARGE (Section 2.4)."""
    return [AAP(di, dk)]


def seq_zero(dk: RowAddr) -> List[Macro]:
    """Bulk initialization to zero via the C0 control row (Section 3.1.4)."""
    return [AAP(C(0), dk)]


def seq_one(dk: RowAddr) -> List[Macro]:
    return [AAP(C(1), dk)]


# Canonical op table used by the compiler and the energy/timing benchmarks.
OP_TEMPLATES = {
    "not": seq_not,
    "and": seq_and,
    "or": seq_or,
    "nand": seq_nand,
    "nor": seq_nor,
    "xor": seq_xor,
    "xnor": seq_xnor,
    "maj3": seq_maj3,
    "copy": seq_copy,
    "zero": seq_zero,
    "one": seq_one,
}

# Total row-address argument count per template (sources + destination).
# Shared by the timing model and the differential tests so per-op argument
# plumbing stays in one place.
OP_ARITY = {
    "not": 2, "and": 3, "or": 3, "nand": 3, "nor": 3, "xor": 3, "xnor": 3,
    "maj3": 4, "copy": 2, "zero": 1, "one": 1,
}
