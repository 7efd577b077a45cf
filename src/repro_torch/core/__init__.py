"""Ambit core: the paper's bulk bitwise execution engine, in PyTorch.

Public API:
  BitVector, BulkBitwiseEngine  - the bbop execution model (Section 5)
  Expr / maj                    - bitwise expression DAGs
  AmbitError                    - the device model's error type
"""

from .bitvector import BitVector, pack_bits, unpack_bits
from .engine import BulkBitwiseEngine, OpStats
from .expr import Expr, ONE, ZERO, eval_expr, maj
from .simulator import AmbitError

__all__ = [
    "AmbitError", "BitVector", "BulkBitwiseEngine", "Expr", "ONE",
    "OpStats", "ZERO", "eval_expr", "maj", "pack_bits", "unpack_bits",
]
