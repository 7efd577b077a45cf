"""DRAM geometry for the Ambit device model.

Mirrors the organization described in Section 2 of the paper:
chips contain banks; banks contain subarrays; each subarray is a 2-D array of
cells (rows x row_bits) sharing one row of sense amplifiers (the row buffer).

Ambit reserves, per subarray (Section 4.1):
  * B-group: 4 designated rows T0..T3 + 2 dual-contact-cell rows (DCC0, DCC1),
    addressed through 16 reserved addresses B0..B15 (Table 2).
  * C-group: 2 control rows, C0 = all zeros, C1 = all ones.
  * D-group: the remaining rows, exposed to software as data rows.
"""

from __future__ import annotations

import dataclasses

WORD_BITS = 64  # simulator packing width (numpy uint64)


@dataclasses.dataclass(frozen=True)
class DRAMGeometry:
    """Geometry constants for the modeled DDR3-style device (Table 5-like)."""

    row_bytes: int = 8192          # 8 KB row (Table 5: "8 KB row size")
    rows_per_subarray: int = 1024  # typical MAT height (Section 2.2.3)
    subarrays_per_bank: int = 32   # 2Gb chip: 2^15 rows/bank / 1024
    banks: int = 8                 # Ambit config in Fig. 21 uses 8 banks
    dcc_rows: int = 2              # DCC0, DCC1 (Section 4.1)
    designated_rows: int = 4       # T0..T3
    control_rows: int = 2          # C0, C1

    @property
    def row_bits(self) -> int:
        return self.row_bytes * 8

    @property
    def row_words(self) -> int:
        """Packed uint64 words per row (simulator storage unit)."""
        return self.row_bits // WORD_BITS

    @property
    def reserved_rows(self) -> int:
        # Each DCC row costs ~2 regular rows of area (Section 5.6.1), but in
        # terms of *addressable* rows the B+C groups remove 4 + 2 + 2 = 8
        # row addresses; the paper quotes D0..D1005 for 1024-row subarrays,
        # i.e. 18 addresses reserved (16 B-group + 2 C-group).
        return 16 + self.control_rows

    @property
    def data_rows(self) -> int:
        """D-group rows exposed to software (paper: 1006 for 1024 rows)."""
        return self.rows_per_subarray - self.reserved_rows

    @property
    def subarray_data_bytes(self) -> int:
        return self.data_rows * self.row_bytes

    @property
    def bank_data_bytes(self) -> int:
        return self.subarrays_per_bank * self.subarray_data_bytes

    @property
    def chip_data_bytes(self) -> int:
        return self.banks * self.bank_data_bytes


DEFAULT_GEOMETRY = DRAMGeometry()
