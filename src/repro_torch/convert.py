"""Carry state between the reference package's arrays and the port.

The reference stores packed words as ``uint32``; the port stores the
same bit patterns as ``torch.int32``. These helpers move numpy arrays
(the reference's arrays after ``np.asarray``) into the port's tensors and
back with every bit preserved.

Like every entry point of the port, each helper lands its result on the
card unless the caller names another device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .apps.binary_lm import BitLinear
from .apps.bitweaving_db import TPCH_COLUMNS, BitWeavingColumn, TpchTable
from .core.bitvector import BitVector, resolve_device


def from_numpy_u32(words_u32: np.ndarray, device=None) -> torch.Tensor:
    """uint32 words -> int32 tensor on ``device`` (same bits)."""
    arr = np.ascontiguousarray(words_u32, dtype=np.uint32)
    return torch.from_numpy(arr.view(np.int32).copy()).to(
        resolve_device(device))


def to_numpy_u32(tensor: torch.Tensor) -> np.ndarray:
    """int32 tensor (any device) -> uint32 numpy array (same bits)."""
    return tensor.detach().cpu().numpy().view(np.uint32)


def bitvector_from_numpy(words_u32: np.ndarray, n_bits: int,
                         device=None) -> BitVector:
    """A reference BitVector's packed words -> the port's BitVector."""
    return BitVector(from_numpy_u32(words_u32, device), int(n_bits))


def column_from_numpy(planes_u32: np.ndarray, n_rows: int, bits: int,
                      device=None) -> BitWeavingColumn:
    """A reference BitWeavingColumn's (b, words) planes -> the port's."""
    return BitWeavingColumn(
        from_numpy_u32(planes_u32, device), int(n_rows),
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


def bitlinear_from_numpy(weight: np.ndarray, device=None) -> BitLinear:
    """A reference BitLinear weight (float32 ``(classes, d)``, the ``w``
    of ``examples/binary_lm.py``) -> the port's ``BitLinear`` on
    ``device``, every float kept."""
    return BitLinear(weight, device=device)
