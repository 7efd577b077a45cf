"""Fused bulk-bitwise expression kernel (CUDA, ``csrc/bitwise.cu``).

The TPU version traces one Pallas body per expression. Here each
``(expression, names)`` is lowered ONCE in Python into a register
program - ``(opcode, dst, src0, src1, src2)`` rows, every load first -
that one CUDA kernel interprets for every word, so serving a new
predicate template never runs the compiler. ``kernels.ops`` keeps the one
LRU of lowered programs; each launch passes its program by value.

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
THREADS = 256           # threads a block
# (most registers, words a thread) of the kernel's instantiations: the
# register file in shared memory is n_regs * words * THREADS * 4 bytes
# (at most 64 KB, 96 KB, 128 KB), so small programs amortise each decoded
# instruction over more words.
BUCKETS = ((8, 8), (24, 4), (MAX_REGS, 2))
# Let a launch of few pointers and instructions pass the kernel's smaller
# parameter block (csrc/bitwise.cu SMALL_PTRS / SMALL_INSTR);
# chip_smoke.py times it against the larger one.
SMALL_PARAMS = True

OP_LOAD, OP_ZERO, OP_ONE, OP_NOT, OP_AND, OP_OR, OP_XOR, OP_MAJ = range(8)
_BINARY = {"and": OP_AND, "or": OP_OR, "xor": OP_XOR}


@dataclasses.dataclass(frozen=True)
class Program:
    """A lowered expression: ``code`` is (n_instr, 4) int32, one row per
    instruction ``(op | src2 << 16, dst, src0, src1)``, the ``n_loads``
    loads first; operand ``k`` of ``names`` is loaded by ``OP_LOAD dst,
    k``. ``result`` is the register holding the value to store.
    ``packed`` is the kernel's form: one uint32 an instruction, ``op |
    dst << 3 | src0 << 9 | src1 << 15 | src2 << 21``."""

    code: np.ndarray
    n_regs: int
    result: int
    n_operands: int
    loads: Tuple[int, ...]          # operand indices the program reads
    packed: np.ndarray = dataclasses.field(compare=False, repr=False)

    @property
    def n_loads(self) -> int:
        return len(self.loads)


def pack(code: np.ndarray) -> np.ndarray:
    """``code`` rows -> the kernel's 32-bit instruction words."""
    c = np.asarray(code, np.int64).reshape(-1, 4)
    op, s2 = c[:, 0] & 0xFFFF, c[:, 0] >> 16
    return (op | c[:, 1] << 3 | c[:, 2] << 9 | c[:, 3] << 15
            | s2 << 21).astype(np.uint32)


def lower(expression: E.Expr, names: Sequence[str]) -> Program:
    """Lower ``expression`` over operands ``names`` to a register program:
    every load first, each into a register of its own (the kernel has
    them all in flight at once), then the other nodes in the post-order of
    ``E.topo_order``, a register reused as soon as its value's last
    consumer has read it. Raises ``ValueError`` past the kernel's
    operand, instruction or register limits."""
    names = tuple(names)
    if len(names) > MAX_OPERANDS:
        raise ValueError(f"fused_bitwise takes at most {MAX_OPERANDS} "
                         f"operands, got {len(names)}")
    index = {nm: k for k, nm in enumerate(names)}
    order = E.topo_order(expression)
    if len(order) > MAX_INSTR:
        raise ValueError(f"fused_bitwise takes at most {MAX_INSTR} "
                         f"instructions, the expression has {len(order)}")
    leaves = [nd for nd in order if nd.op == "var"]
    inner = [nd for nd in order if nd.op != "var"]
    last_use: Dict[int, int] = {}
    for pos, node in enumerate(inner):
        for a in node.args:
            last_use[id(a)] = pos
    reg_of = {id(nd): r for r, nd in enumerate(leaves)}
    code = [(OP_LOAD, r, index[nd.name], 0) for r, nd in enumerate(leaves)]
    free: List[int] = []
    n_regs = len(leaves)
    for pos, node in enumerate(inner):
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
        if node.op == "lit":
            code.append((OP_ONE if node.name == "one" else OP_ZERO, dst, 0, 0))
        elif node.op == "not":
            code.append((OP_NOT, dst, srcs[0], 0))
        elif node.op in _BINARY:
            code.append((_BINARY[node.op], dst, srcs[0], srcs[1]))
        elif node.op == "maj":
            code.append((OP_MAJ | (srcs[2] << 16), dst, srcs[0], srcs[1]))
        else:
            raise KeyError(node.op)
    if n_regs > MAX_REGS:
        raise ValueError(f"fused_bitwise holds at most {MAX_REGS} live "
                         "values; the expression needs more")
    code = np.asarray(code, np.int32).reshape(-1, 4)
    return Program(code, n_regs, reg_of[id(expression)], len(names),
                   tuple(index[nd.name] for nd in leaves), pack(code))


def launch_shape(n_regs: int) -> Tuple[int, int]:
    """(words a thread, bytes of shared memory a block) of the kernel's
    instantiation for a program of ``n_regs`` registers (``BUCKETS``)."""
    for most, w in BUCKETS:
        if 1 <= n_regs <= most:
            return w, n_regs * w * THREADS * 4
    raise ValueError(f"fused_bitwise takes 1 to {MAX_REGS} registers, "
                     f"got {n_regs}")


def divmod_magic(d: int) -> Tuple[int, int]:
    """(mul, shift) with ``(umulhi(i, mul) + i) >> shift == i // d`` for
    every ``0 <= i < 2**31`` (round-up multiply-high division; the
    kernel's tail mask finds a word's column with it). Needs
    ``1 <= d < 2**31``; past that the kernel divides by ``%``."""
    if not 1 <= d < 2 ** 31:
        return 0, 0
    shift = (d - 1).bit_length()            # ceil(log2 d)
    mul = ((1 << 32) * ((1 << shift) - d)) // d + 1
    return mul, shift


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
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_uint, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


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
    if any(len(row) != program.n_operands + 1 for row in table):
        raise ValueError(f"the program reads {program.n_operands} operands")
    words = int(shape[-1]) if len(shape) else 1
    n = int(np.prod(shape)) if len(shape) else 1
    w, _ = launch_shape(program.n_regs)
    mul, shift = divmod_magic(words)
    ptrs = [t.data_ptr() for row in table for t in row]
    if len(ptrs) <= PARAM_PTRS:         # by value in the launch
        host_ptrs, dev_table = (ctypes.c_ulonglong * len(ptrs))(*ptrs), None
    else:                               # a large epoch: a device table
        host_ptrs = None
        dev_table = torch.tensor(ptrs, dtype=torch.int64).pin_memory().to(
            device, non_blocking=True)
    code = program.packed
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.fused_bitwise_launch(
        host_ptrs, None if dev_table is None else dev_table.data_ptr(),
        code.ctypes.data, program.n_operands, program.n_loads,
        int(code.shape[0]), program.result, program.n_regs, w, n, words,
        -1 if n_bits is None else int(n_bits), mul, shift, len(table),
        int(SMALL_PARAMS), stream)
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
