"""Carry state between the reference package's arrays and the port.

The reference stores packed words as ``uint32``; the port stores the
same bit patterns as ``torch.int32``. These helpers move numpy arrays
(the reference's arrays after ``np.asarray``) into the port's tensors and
back with every bit preserved.

Raw words and bitvectors land on the CPU unless ``device`` says
otherwise: the runtime and the engine move them to their own device.
Columns and tables compute where their planes lie, so, like every entry
point of the port, they land on the card unless the caller names another.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .apps.bitweaving_db import TPCH_COLUMNS, BitWeavingColumn, TpchTable
from .core.bitvector import BitVector
from .core.engine import resolve_device


def from_numpy_u32(words_u32: np.ndarray, device="cpu") -> torch.Tensor:
    """uint32 words -> int32 tensor on ``device`` (same bits)."""
    arr = np.ascontiguousarray(words_u32, dtype=np.uint32)
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


def to_numpy_u32(tensor: torch.Tensor) -> np.ndarray:
    """int32 tensor (any device) -> uint32 numpy array (same bits)."""
    return tensor.detach().cpu().numpy().view(np.uint32)


def bitvector_from_numpy(words_u32: np.ndarray, n_bits: int,
                         device="cpu") -> BitVector:
    """A reference BitVector's packed words -> the port's BitVector."""
    return BitVector(from_numpy_u32(words_u32, device), int(n_bits))


def column_from_numpy(planes_u32: np.ndarray, n_rows: int, bits: int,
                      device=None) -> BitWeavingColumn:
    """A reference BitWeavingColumn's (b, words) planes -> the port's."""
    return BitWeavingColumn(
        from_numpy_u32(planes_u32, resolve_device(device)), int(n_rows),
        int(bits))


def table_from_numpy(values: Dict[str, np.ndarray], columns=TPCH_COLUMNS,
                     device=None) -> TpchTable:
    """A TPC-H table from its raw column values (``TpchTable.values`` of
    either package), bit-sliced on ``device``."""
    n_rows = len(next(iter(values.values())))
    cols = {name: BitWeavingColumn.from_values(values[name], bits, device)
            for name, bits in columns}
    return TpchTable(n_rows, {name: values[name] for name, _ in columns},
                     cols)
