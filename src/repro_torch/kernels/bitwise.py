"""Fused bulk-bitwise expression kernel (CUDA, ``csrc/bitwise.cu``).

The TPU version traces one Pallas body per expression. Here each
``(expression, names)`` is lowered ONCE in Python into a register
program - ``(opcode, dst, src0, src1, src2)`` rows, every load first -
that one CUDA kernel interprets for every word, so serving a new
predicate template never runs the compiler. ``kernels.ops`` keeps the one
LRU of lowered programs; each launch passes its program by value.

The kernel's form of a program (``Program.packed``) carries marks the
register program does not need: which sources are the previous
instruction's result (the kernel reads them from its registers), which
results a later, non-adjacent instruction reads (only those go back to
the register file in shared memory), and which loads are read negated
(a NOT of a load folded into its readers). ``Program.smem_bytes_per_word``
is what that leaves in shared memory for each word.

Every wrapper here launches the kernel for CUDA tensors and counts the
launch in ``<wrapper>.launches``, a launch whose persistent blocks
walked more than one tile each in ``<wrapper>.ring_launches``, and a
launch of a program of more than ``WARP_LOADS`` loads (the kernel's wide
route) in ``<wrapper>.wide_launches``; ``fused_bitwise_stacked`` counts
an epoch whose pointers went in a device table in ``.table_launches``.
CPU tensors take the plain PyTorch version beside it. Nothing falls back.
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
# about 150 nodes; the four-column Star Schema Q4.2 and Q4.3 plans, 38.
MAX_OPERANDS = 48
# Loads the kernel's producer warp issues one a lane; a program of more
# takes the kernel's wide parameter block (csrc/bitwise.cu WideParams).
WARP_LOADS = 32
MAX_INSTR = 512
MAX_REGS = 64
PARAM_PTRS = 384        # pointer table passed by value in the launch
MAX_SMEM = 232_448      # shared memory an H100 block may opt in to
# The kernel's tiles (csrc/bitwise.cu ``cfg``): (words a thread, evaluating
# warps); a tile is their product times 32 words.
TILES = ((4, 4), (8, 2))
SM_SHARED = 233_472     # an H100 SM's shared memory; a block takes 1 KB more
# Let a launch of few pointers and instructions pass the kernel's smaller
# parameter block (csrc/bitwise.cu SMALL_PTRS / SMALL_INSTR);
# chip_smoke.py times it against the larger one.
SMALL_PARAMS = True
# The marks in a packed instruction's spare bits: source k (0, 1, 2) is
# the previous instruction's result (bit MARK_FWD + k); the result is read
# again after the next instruction (MARK_KEEP); source 1 is read negated
# (MARK_NEG).
MARK_FWD = 27
MARK_KEEP = 1 << 30
MARK_NEG = 1 << 31

OP_LOAD, OP_ZERO, OP_ONE, OP_NOT, OP_AND, OP_OR, OP_XOR, OP_MAJ = range(8)
_BINARY = {"and": OP_AND, "or": OP_OR, "xor": OP_XOR}


@dataclasses.dataclass(frozen=True)
class Program:
    """A lowered expression: ``code`` is (n_instr, 4) int32, one row per
    instruction ``(op | src2 << 16, dst, src0, src1)``, the ``n_loads``
    loads first, load k into register k; operand ``k`` of ``names`` is
    loaded by ``OP_LOAD dst, k``. ``result`` is the register holding the
    value to store. ``packed`` is the kernel's form of the same
    computation (``_kernel_form``): one uint32 an instruction, ``op | dst
    << 3 | src0 << 9 | src1 << 15 | src2 << 21`` and the marks
    (``MARK_FWD``, ``MARK_KEEP``, ``MARK_NEG``), the same loads first, NOTs
    of loads folded into their readers, registers only for loads and kept
    results (``shared_regs`` of them). ``smem_bytes_per_word`` is the
    shared memory the kernel moves for each word: each loaded operand
    copied in once, each source read that is not forwarded, each result
    kept."""

    code: np.ndarray
    n_regs: int
    result: int
    n_operands: int
    loads: Tuple[int, ...]          # operand indices the program reads
    packed: np.ndarray = dataclasses.field(compare=False, repr=False)
    smem_bytes_per_word: int = dataclasses.field(default=0, compare=False)
    shared_regs: int = dataclasses.field(default=0, compare=False)

    @property
    def n_loads(self) -> int:
        return len(self.loads)


def _kernel_form(expression: E.Expr, leaves: List[E.Expr],
                 inner: List[E.Expr], index: Dict[str, int]
                 ) -> Tuple[np.ndarray, int, int]:
    """The kernel's form of a lowered program: (packed words, registers in
    shared memory, shared-memory bytes a word).

    - A NOT of a loaded operand whose every reader is an and, or or xor
      (reading it once, beside no other such NOT) is folded into its
      readers: they read the operand negated (``MARK_NEG``, on source 1).
    - A source that is the previous instruction's result is forwarded
      (``MARK_FWD``); a result read past the next instruction is kept
      (``MARK_KEEP``). Only loads and kept results hold registers (the
      loads' first, a register reused once its value is dead); any other
      result is never stored (its reader takes it forwarded) and names
      register 0, as a forwarded source does.
    """
    users: Dict[int, List[E.Expr]] = {}
    for node in inner:
        for arg in node.args:
            users.setdefault(id(arg), []).append(node)
    folded = set()
    for node in inner:
        if node.op != "not" or node.args[0].op != "var" or \
                node is expression:
            continue
        if all(u.op in _BINARY and sum(a is node for a in u.args) == 1
               and not any(id(a) in folded for a in u.args)
               for u in users[id(node)]):
            folded.add(id(node))
    steps = [nd for nd in inner if id(nd) not in folded]
    pos = {id(nd): k for k, nd in enumerate(steps)}

    def operands(node):                 # (value node, negated), negated last
        ops = [(a.args[0], True) if id(a) in folded else (a, False)
               for a in node.args]
        return ops[::-1] if ops and ops[0][1] else ops

    reads: Dict[int, List[int]] = {}
    for k, node in enumerate(steps):
        for value, _ in operands(node):
            reads.setdefault(id(value), []).append(k)
    kept = {id(nd) for k, nd in enumerate(steps)
            if any(r >= k + 2 for r in reads.get(id(nd), ()))}
    last = {v: max(r) for v, r in reads.items()}
    reg_of = {id(nd): r for r, nd in enumerate(leaves)}
    free: List[int] = []
    n_regs = len(leaves)
    rows = []                           # (op, dst, srcs, fwd, neg, keep)
    for k, node in enumerate(steps):
        ops = operands(node)
        srcs, fwd = [], []
        for value, _ in ops:
            fwd.append(value.op != "var" and pos[id(value)] == k - 1)
            srcs.append(0 if fwd[-1] else reg_of[id(value)])
        for value, _ in ops:            # sources read before dst write
            if last[id(value)] == k and id(value) in reg_of:
                free.append(reg_of.pop(id(value)))
        dst = 0
        if id(node) in kept:
            if free:
                dst = min(free)
                free.remove(dst)
            else:
                dst = n_regs
                n_regs += 1
            reg_of[id(node)] = dst
        if node.op == "lit":
            op = OP_ONE if node.name == "one" else OP_ZERO
        else:
            op = {"not": OP_NOT, "maj": OP_MAJ}.get(node.op) or \
                _BINARY[node.op]
        rows.append((op, dst, srcs, fwd, ops and ops[-1][1], id(node) in kept))
    if n_regs > MAX_REGS:
        raise ValueError(f"fused_bitwise holds at most {MAX_REGS} live "
                         "values; the expression needs more")
    words = [OP_LOAD | r << 3 | index[nd.name] << 9
             for r, nd in enumerate(leaves)]
    reads_n = 0
    for op, dst, srcs, fwd, neg, keep in rows:
        srcs = srcs + [0] * (3 - len(srcs))
        word = op | dst << 3 | srcs[0] << 9 | srcs[1] << 15 | srcs[2] << 21
        for j, f in enumerate(fwd):
            word |= f << (MARK_FWD + j)
            reads_n += not f
        word |= (MARK_KEEP if keep else 0) | (MARK_NEG if neg else 0)
        words.append(word)
    smem = 4 * (len(leaves) + reads_n + len(kept) + (0 if rows else 1))
    return np.asarray(words, np.uint32), n_regs, smem


def lower(expression: E.Expr, names: Sequence[str]) -> Program:
    """Lower ``expression`` over operands ``names`` to a register program:
    every load first, each into a register of its own (the kernel's ring
    stage holds them all), then the other nodes in the post-order of
    ``E.topo_order``, a register reused as soon as its value's last
    consumer has read it; the root comes last, its value in the kernel's
    registers. Raises ``ValueError`` past the kernel's operand,
    instruction or register limits."""
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
    packed, shared_regs, smem = _kernel_form(expression, leaves, inner, index)
    return Program(code, n_regs, reg_of[id(expression)], len(names),
                   tuple(index[nd.name] for nd in leaves), packed, smem,
                   shared_regs)


def shared_bytes(program: Program, tile: int, stages: int) -> int:
    """Shared memory of a block of ``TILES[tile]`` with ``stages`` ring
    stages (csrc/bitwise.cu ``layout``): 64 bytes of barriers, the
    resolved program (16 bytes an instruction past the loads, and one)
    per stage, each stage's slots (a tile and 16 bytes of alignment slack
    per load), and the registers past the loads a tile each."""
    words = tile_words(tile)
    n_comp = program.packed.shape[0] - program.n_loads
    progs = 64 + stages * (n_comp + 1) * 16
    stage_off = (progs + 127) // 128 * 128
    slots = stages * program.n_loads * (4 * words + 16)
    return stage_off + slots + max(
        program.shared_regs - program.n_loads, 0) * 4 * words


def tile_words(tile: int) -> int:
    """Words of the kernel's tile ``tile`` (an index of ``TILES``)."""
    w, warps = TILES[tile]
    return w * warps * 32


def tile_for(program: Program) -> int:
    """The kernel's tile for ``program``. The interpreter hides its latency
    with many warps resident, and 8 words a thread halve each
    instruction's dispatch per word but leave 2 warps a block: so 8 words
    on 2 warps where six blocks of a one-stage ring fit an SM's shared
    memory (the 12-load TPC-H programs), else 4 words on 4 warps."""
    if 6 * (shared_bytes(program, 1, 1) + 1024) <= SM_SHARED:
        return 1
    if shared_bytes(program, 0, 1) <= MAX_SMEM:
        return 0
    raise ValueError("fused_bitwise: the program's registers do not fit a "
                     "block's shared memory")


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
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
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


def by_value(program: Program, queries: int) -> bool:
    """Whether a launch of ``queries`` evaluations of ``program`` passes
    its operand and output pointers by value in the launch (at most
    ``PARAM_PTRS``) rather than in a device table."""
    return queries * (program.n_operands + 1) <= PARAM_PTRS


def _launch(program: Program, table: List[List[torch.Tensor]], shape,
            n_bits: Optional[int]) -> bool:
    """One launch over ``table`` = per query [operands..., output].
    Returns whether its persistent blocks walked more than one tile each
    (more (query, tile) pairs than blocks)."""
    device = table[0][-1].device
    if any(len(row) != program.n_operands + 1 for row in table):
        raise ValueError(f"the program reads {program.n_operands} operands")
    words = int(shape[-1]) if len(shape) else 1
    n = int(np.prod(shape)) if len(shape) else 1
    tile = tile_for(program)
    mul, shift = divmod_magic(words)
    ptrs = [t.data_ptr() for row in table for t in row]
    if by_value(program, len(table)):
        host_ptrs, dev_table = (ctypes.c_ulonglong * len(ptrs))(*ptrs), None
    else:                               # a large epoch: a device table
        host_ptrs = None
        dev_table = torch.tensor(ptrs, dtype=torch.int64).pin_memory().to(
            device, non_blocking=True)
    code = program.packed
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    grid = ctypes.c_int(0)
    rc = lib.fused_bitwise_launch(
        host_ptrs, None if dev_table is None else dev_table.data_ptr(),
        code.ctypes.data, program.n_operands, program.n_loads,
        int(code.shape[0]), program.result, program.shared_regs, tile, n,
        words,
        -1 if n_bits is None else int(n_bits), mul, shift, len(table),
        int(SMALL_PARAMS), stream, ctypes.byref(grid))
    build.check(lib, rc, "fused_bitwise launch")
    pairs = -(-n // tile_words(tile)) * len(table)
    return pairs > grid.value


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
    ring = _launch(program, [list(arrays) + [out]], first.shape, n_bits)
    fused_bitwise.launches += 1
    fused_bitwise.ring_launches += ring
    fused_bitwise.wide_launches += program.n_loads > WARP_LOADS
    return out


fused_bitwise.launches = 0
fused_bitwise.ring_launches = 0
fused_bitwise.wide_launches = 0


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
    ring = _launch(program,
                   [list(arrays) + [o] for arrays, o in zip(operands, outs)],
                   first.shape, n_bits)
    fused_bitwise_stacked.launches += 1
    fused_bitwise_stacked.ring_launches += ring
    fused_bitwise_stacked.wide_launches += program.n_loads > WARP_LOADS
    fused_bitwise_stacked.table_launches += not by_value(program,
                                                         len(operands))
    return outs


fused_bitwise_stacked.launches = 0
fused_bitwise_stacked.ring_launches = 0
fused_bitwise_stacked.wide_launches = 0
fused_bitwise_stacked.table_launches = 0
