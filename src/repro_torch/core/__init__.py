"""Ambit core: the paper's bulk bitwise execution engine, in PyTorch.

Public API:
  BitVector, BulkBitwiseEngine  - the bbop execution model (Section 5)
  Expr / maj / compile_expr     - bitwise programs -> AAP command streams
  AmbitSubarray / AmbitDevice   - bit-accurate DRAM device model
"""

from .bitvector import BitVector, pack_bits, unpack_bits
from .commands import AAP, AP, B, C, D, OP_TEMPLATES, RowAddr
from .compiler import CompiledProgram, compile_expr
from .engine import (BulkBitwiseEngine, OpStats, compile_cache_clear,
                     compile_cache_info)
from .expr import Expr, ONE, ZERO, eval_expr, maj
from .geometry import DEFAULT_GEOMETRY, DRAMGeometry
from .simulator import AmbitDevice, AmbitError, AmbitSubarray
from .timing import (DEFAULT_TIMING, CommandStats, TABLE3_PAPER, TABLE4_PAPER,
                     TimingParams, ddr3_energy_nj_per_kb, op_energy_nj_per_kb,
                     program_stats)

__all__ = [
    "AAP", "AP", "AmbitDevice", "AmbitError", "AmbitSubarray", "B",
    "BitVector", "BulkBitwiseEngine", "C", "CommandStats", "CompiledProgram",
    "D", "DEFAULT_GEOMETRY", "DEFAULT_TIMING", "DRAMGeometry", "Expr", "ONE",
    "OP_TEMPLATES", "OpStats", "RowAddr", "TABLE3_PAPER", "TABLE4_PAPER",
    "TimingParams", "ZERO", "compile_cache_clear", "compile_cache_info",
    "compile_expr", "ddr3_energy_nj_per_kb", "eval_expr", "maj",
    "op_energy_nj_per_kb", "pack_bits", "program_stats", "unpack_bits",
]
