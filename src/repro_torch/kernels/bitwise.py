"""Fused bulk-bitwise expression kernel (CUDA, ``csrc/bitwise.cu``).

The TPU version traces one Pallas body per expression. Here each
``(expression, names)`` is lowered ONCE in Python into a register
program - ``(opcode, dst, src0, src1, src2)`` rows, packed four ints a
row - that one CUDA kernel interprets for every word, so serving a new
predicate template never runs the compiler. ``kernels.ops`` keeps the one
LRU of lowered programs; each program keeps its copy on the card.

Every wrapper here launches the kernel for CUDA tensors and counts the
launch in ``<wrapper>.launches``; CPU tensors take the plain PyTorch
version beside it. Nothing falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import expr as E
from ..core.bitvector import _mask_tail
from . import build

# Limits of csrc/bitwise.cu (MAX_OPERANDS / MAX_INSTR / MAX_REGS). A
# two-column TPC-H predicate_plan over 8-bit planes uses 15 operands and
# about 150 nodes.
MAX_OPERANDS = 32
MAX_INSTR = 512
MAX_REGS = 64
PARAM_PTRS = 384        # pointer table passed by value in the launch

OP_LOAD, OP_ZERO, OP_ONE, OP_NOT, OP_AND, OP_OR, OP_XOR, OP_MAJ = range(8)
_BINARY = {"and": OP_AND, "or": OP_OR, "xor": OP_XOR}


@dataclasses.dataclass(frozen=True)
class Program:
    """A lowered expression: ``code`` is (n_instr, 4) int32, one row per
    instruction ``(op | src2 << 16, dst, src0, src1)``; operand ``k`` of
    ``names`` is loaded by ``OP_LOAD dst, k``. ``result`` is the register
    holding the value to store. ``uploaded`` holds the code's copy on each
    device it has run on (see ``program_on``)."""

    code: np.ndarray
    n_regs: int
    result: int
    n_operands: int
    loads: Tuple[int, ...]          # operand indices the program reads
    uploaded: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict, compare=False, hash=False, repr=False)


def lower(expression: E.Expr, names: Sequence[str]) -> Program:
    """Lower ``expression`` over operands ``names`` to a register program
    (post-order from ``E.topo_order``; a register is reused as soon as
    its value's last consumer has read it). Raises ``ValueError`` past
    the kernel's operand, instruction or register limits."""
    names = tuple(names)
    if len(names) > MAX_OPERANDS:
        raise ValueError(f"fused_bitwise takes at most {MAX_OPERANDS} "
                         f"operands, got {len(names)}")
    index = {nm: k for k, nm in enumerate(names)}
    order = E.topo_order(expression)
    if len(order) > MAX_INSTR:
        raise ValueError(f"fused_bitwise takes at most {MAX_INSTR} "
                         f"instructions, the expression has {len(order)}")
    last_use: Dict[int, int] = {}
    for pos, node in enumerate(order):
        for a in node.args:
            last_use[id(a)] = pos
    reg_of: Dict[int, int] = {}
    free: List[int] = []
    n_regs = 0
    code = []
    loads = []
    for pos, node in enumerate(order):
        srcs = [reg_of[id(a)] for a in node.args]
        for a in node.args:                 # sources read before dst write
            if last_use[id(a)] == pos and id(a) in reg_of:
                free.append(reg_of.pop(id(a)))
        if free:
            dst = min(free)
            free.remove(dst)
        else:
            dst = n_regs
            n_regs += 1
        if n_regs > MAX_REGS:
            raise ValueError(f"fused_bitwise holds at most {MAX_REGS} live "
                             "values; the expression needs more")
        reg_of[id(node)] = dst
        if node.op == "var":
            code.append((OP_LOAD, dst, index[node.name], 0))
            loads.append(index[node.name])
        elif node.op == "lit":
            code.append((OP_ONE if node.name == "one" else OP_ZERO, dst, 0, 0))
        elif node.op == "not":
            code.append((OP_NOT, dst, srcs[0], 0))
        elif node.op in _BINARY:
            code.append((_BINARY[node.op], dst, srcs[0], srcs[1]))
        elif node.op == "maj":
            code.append((OP_MAJ | (srcs[2] << 16), dst, srcs[0], srcs[1]))
        else:
            raise KeyError(node.op)
    return Program(np.asarray(code, np.int32).reshape(-1, 4), n_regs,
                   reg_of[id(expression)], len(names), tuple(loads))


# -- plain versions -------------------------------------------------------------


def fused_bitwise_plain(expression: E.Expr, names: Sequence[str],
                        arrays: Sequence[torch.Tensor],
                        n_bits: Optional[int] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``E.eval_expr`` over equal
    shaped int32 tensors, tail-masked to ``n_bits`` when given."""
    out = E.eval_expr(expression, dict(zip(names, arrays)))
    return out if n_bits is None else _mask_tail(out, n_bits)


def fused_bitwise_stacked_plain(expression: E.Expr, names: Sequence[str],
                                operands: Sequence[Sequence[torch.Tensor]],
                                n_bits: Optional[int] = None
                                ) -> List[torch.Tensor]:
    """One plain evaluation per query of the epoch."""
    return [fused_bitwise_plain(expression, names, arrays, n_bits)
            for arrays in operands]


# -- kernel wrappers ------------------------------------------------------------


def _lib():
    lib = build.load("bitwise")
    fn = lib.fused_bitwise_launch
    if fn.argtypes is None:         # declare once: pointers stay 64-bit
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
    return lib


def program_on(program: Program, device: torch.device) -> torch.Tensor:
    """The program's code as an int32 tensor on ``device``, uploaded on
    its first launch there and kept with the program."""
    key = str(device)
    if key not in program.uploaded:
        program.uploaded[key] = torch.from_numpy(program.code.copy()).to(
            device)
    return program.uploaded[key]


def _check_operands(arrays: Sequence[torch.Tensor], like: torch.Tensor
                    ) -> None:
    for a in arrays:
        if a.dtype != torch.int32 or a.shape != like.shape or \
                a.device != like.device or not a.is_contiguous():
            raise ValueError(
                "fused_bitwise operands must be contiguous int32 tensors "
                f"of one shape {tuple(like.shape)} on {like.device}, got "
                f"{a.dtype} {tuple(a.shape)} on {a.device}")


def _launch(program: Program, table: List[List[torch.Tensor]], shape,
            n_bits: Optional[int]) -> None:
    """One launch over ``table`` = per query [operands..., output]."""
    device = table[0][-1].device
    code = program_on(program, device)
    if any(len(row) != program.n_operands + 1 for row in table):
        raise ValueError(f"the program reads {program.n_operands} operands")
    words = int(shape[-1]) if len(shape) else 1
    n = int(np.prod(shape)) if len(shape) else 1
    ptrs = [t.data_ptr() for row in table for t in row]
    vec = int(all(p % 16 == 0 for p in ptrs))
    if len(ptrs) <= PARAM_PTRS:         # by value in the launch
        host_ptrs, dev_table = (ctypes.c_ulonglong * len(ptrs))(*ptrs), None
    else:                               # a large epoch: a device table
        host_ptrs = None
        dev_table = torch.tensor(ptrs, dtype=torch.int64).pin_memory().to(
            device, non_blocking=True)
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.fused_bitwise_launch(
        host_ptrs, None if dev_table is None else dev_table.data_ptr(),
        code.data_ptr(), program.n_operands,
        int(program.code.shape[0]), program.result, n, words,
        -1 if n_bits is None else int(n_bits), vec, len(table), stream)
    build.check(lib, rc, "fused_bitwise launch")


def fused_bitwise(expression: E.Expr, names: Sequence[str],
                  arrays: Sequence[torch.Tensor], program: Program,
                  n_bits: Optional[int] = None,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Evaluate ``program`` (the lowering of ``expression`` over
    ``names``) over equal-shaped int32 tensors in ONE launch, masking
    bits past ``n_bits`` of each row when given. ``out`` may be one of
    the operands (an in-place update: each word is read before it is
    written, by the same thread)."""
    first = arrays[0]
    if not first.is_cuda:
        if first.device.type != "cpu":
            raise ValueError(f"unsupported device {first.device}")
        res = fused_bitwise_plain(expression, names, arrays, n_bits)
        if out is None:
            return res
        return out.copy_(res)
    _check_operands(arrays, first)
    if out is None:
        out = torch.empty_like(first)
    _check_operands([out], first)
    if first.numel() == 0:
        return out
    _launch(program, [list(arrays) + [out]], first.shape, n_bits)
    fused_bitwise.launches += 1
    return out


fused_bitwise.launches = 0


def fused_bitwise_stacked(expression: E.Expr, names: Sequence[str],
                          operands: Sequence[Sequence[torch.Tensor]],
                          program: Program,
                          n_bits: Optional[int] = None
                          ) -> List[torch.Tensor]:
    """Evaluate one program over an epoch of queries in ONE launch:
    ``operands[q]`` are query q's tensors (all of one shape across the
    epoch). Each result is a tensor of its own."""
    first = operands[0][0]
    if not first.is_cuda:
        if first.device.type != "cpu":
            raise ValueError(f"unsupported device {first.device}")
        return fused_bitwise_stacked_plain(expression, names, operands,
                                           n_bits)
    if len(operands) > 65535:
        raise ValueError("fused_bitwise_stacked takes at most 65535 "
                         "queries a launch")
    for arrays in operands:
        _check_operands(arrays, first)
    outs = [torch.empty_like(first) for _ in operands]
    if first.numel() == 0:
        return outs
    _launch(program,
            [list(arrays) + [o] for arrays, o in zip(operands, outs)],
            first.shape, n_bits)
    fused_bitwise_stacked.launches += 1
    return outs


fused_bitwise_stacked.launches = 0
