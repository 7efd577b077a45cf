"""Fused bulk-bitwise expression kernel (CUDA, ``csrc/bitwise.cu``).

The TPU version traces one Pallas body per expression. Here each
``(expression, names)`` is lowered ONCE in Python into a register
program (``Program.packed``: one word an instruction, every load first)
that one CUDA kernel interprets for every word, so serving a new
predicate template never runs the compiler. ``kernels.ops`` keeps the one
LRU of lowered programs; each launch passes its program by value.

Each instruction's spare bits carry marks: which sources are the
previous instruction's result (the kernel reads them from its
registers), whether a later, non-adjacent instruction reads the result
(only those go back to the register file in shared memory), and whether
a load is read negated (a NOT of a load folded into its readers).
``Program.smem_bytes_per_word`` is what that leaves in shared memory for
each word.

Every wrapper here launches the kernel for CUDA tensors and counts the
launch in ``<wrapper>.launches``, a launch whose persistent blocks
walked more than one tile each in ``<wrapper>.ring_launches``, and a
launch of a program of more than ``WARP_LOADS`` loads (the kernel's wide
route) in ``<wrapper>.wide_launches``; ``fused_bitwise_stacked`` counts
an epoch whose pointers went in a device table in ``.table_launches``.
An epoch's queries whose operand pointers are all equal are one job
(``group_jobs``): the kernel evaluates it once a tile and stores the
result into each query's own output; ``fused_bitwise_stacked`` counts
the outputs so served without an evaluation of their own in
``.shared_outputs``. CPU tensors take the plain PyTorch version beside
it. Nothing falls back.
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
# The marks in a packed instruction's spare bits: source k (0, 1, 2) is
# the previous instruction's result (bit MARK_FWD + k); the result is read
# again after the next instruction (MARK_KEEP); source 1 is read negated
# (MARK_NEG).
MARK_FWD = 27
MARK_KEEP = 1 << 30
MARK_NEG = 1 << 31

OP_LOAD, OP_ZERO, OP_ONE, OP_NOT, OP_AND, OP_OR, OP_XOR, OP_MAJ = range(8)
_BINARY = {"and": OP_AND, "or": OP_OR, "xor": OP_XOR}


@dataclasses.dataclass(frozen=True, eq=False)
class Program:
    """A lowered expression in the kernel's form: ``packed`` is one uint32
    an instruction, ``op | dst << 3 | src0 << 9 | src1 << 15 | src2 << 21``
    and the marks (``MARK_FWD``, ``MARK_KEEP``, ``MARK_NEG``), the
    ``n_loads`` loads first, load k into register k from operand
    ``loads[k]`` of the ``n_operands`` names, NOTs of loads folded into
    their readers, registers only for loads and kept results
    (``shared_regs`` of them). ``result`` is the register the kernel
    stores when the program is only its loads (any other program's root
    stays in the kernel's registers). ``smem_bytes_per_word`` is the
    shared memory the kernel moves for each word: each loaded operand
    copied in once, each source read that is not forwarded, each result
    kept."""

    packed: np.ndarray
    n_operands: int
    loads: Tuple[int, ...]          # operand indices the program reads
    shared_regs: int
    smem_bytes_per_word: int
    result: int = 0

    @property
    def n_loads(self) -> int:
        return len(self.loads)


def lower(expression: E.Expr, names: Sequence[str]) -> Program:
    """Lower ``expression`` over operands ``names`` to the kernel's
    program: every load first, each into a register of its own (the
    kernel's ring stage holds them all), then the other nodes in the
    post-order of ``E.topo_order``; the root comes last, its value in the
    kernel's registers. Raises ``ValueError`` past the kernel's operand,
    instruction or register limits.

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
    words = [OP_LOAD | r << 3 | index[nd.name] << 9
             for r, nd in enumerate(leaves)]
    reads_n = 0
    for k, node in enumerate(steps):
        ops = operands(node)
        word = 0
        for j, (value, _) in enumerate(ops):
            if value.op != "var" and pos[id(value)] == k - 1:
                word |= 1 << (MARK_FWD + j)
            else:
                word |= reg_of[id(value)] << (9 + 6 * j)
                reads_n += 1
        for value, _ in ops:            # sources read before dst write
            if last[id(value)] == k and id(value) in reg_of:
                free.append(reg_of.pop(id(value)))
        if id(node) in kept:
            if free:
                dst = min(free)
                free.remove(dst)
            else:
                dst = n_regs
                n_regs += 1
            reg_of[id(node)] = dst
            word |= dst << 3 | MARK_KEEP
        if node.op == "lit":
            word |= OP_ONE if node.name == "one" else OP_ZERO
        else:
            word |= {"not": OP_NOT, "maj": OP_MAJ}.get(node.op) or \
                _BINARY[node.op]
        if ops and ops[-1][1]:
            word |= MARK_NEG
        words.append(word)
    if n_regs > MAX_REGS:
        raise ValueError(f"fused_bitwise holds at most {MAX_REGS} live "
                         "values; the expression needs more")
    smem = 4 * (len(leaves) + reads_n + len(kept) + (0 if steps else 1))
    return Program(np.asarray(words, np.uint32), len(names),
                   tuple(index[nd.name] for nd in leaves), n_regs, smem,
                   reg_of.get(id(expression), 0))


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


def group_jobs(rows: Sequence[tuple]) -> List[List[int]]:
    """The distinct jobs of a launch whose query q reads the operand
    pointers ``rows[q]``: each job lists the queries of one row, first
    occurrence first, and the jobs come in the order of their first
    occurrences. One program over equal pointers gives equal bits, as no
    output of a stacked launch aliases an operand."""
    jobs: Dict[tuple, List[int]] = {}
    for q, row in enumerate(rows):
        jobs.setdefault(row, []).append(q)
    return list(jobs.values())


def pointer_table(rows: Sequence[tuple], jobs: Sequence[Sequence[int]],
                  outs: Sequence[int]) -> List[int]:
    """The pointers of a launch (csrc/bitwise.cu ``fused_bitwise_launch``)
    of queries reading ``rows[q]`` into ``outs[q]``, grouped into ``jobs``
    (``group_jobs``): each query's row and then its output while no job
    repeats; else each job's row and then the range ``start | end << 32``
    of its outputs in the list of every output, grouped by job, that
    follows the rows."""
    if len(jobs) == len(rows):
        return [p for row, o in zip(rows, outs) for p in (*row, o)]
    table: List[int] = []
    listed: List[int] = []
    for job in jobs:
        table += [*rows[job[0]], len(listed) | (len(listed) + len(job)) << 32]
        listed += [outs[q] for q in job]
    return table + listed


def pointer_count(program: Program, queries: int,
                  jobs: Optional[int] = None) -> int:
    """Pointers a launch of ``queries`` queries of ``program`` carries
    when they are ``jobs`` distinct jobs (all distinct by default): a row
    a job, and each output listed apart when jobs repeat."""
    jobs = queries if jobs is None else jobs
    return jobs * (program.n_operands + 1) + (queries if jobs < queries
                                              else 0)


def by_value(program: Program, queries: int,
             jobs: Optional[int] = None) -> bool:
    """Whether such a launch passes its operand and output pointers by
    value in the launch (at most ``PARAM_PTRS``) rather than in a device
    table."""
    return pointer_count(program, queries, jobs) <= PARAM_PTRS


def _launch(wrapper, expression: E.Expr, names: Sequence[str],
            operands: Sequence[Sequence[torch.Tensor]], program: Program,
            n_bits: Optional[int], outs: List[Optional[torch.Tensor]]
            ) -> List[torch.Tensor]:
    """The body of both wrappers: ONE launch over ``operands[q]``, query
    q's tensors (all of one shape), into ``outs[q]`` (None: a fresh
    tensor), counted on ``wrapper``; the queries of one job
    (``group_jobs``) are evaluated once. CPU tensors take the plain
    version."""
    first = operands[0][0]
    if not first.is_cuda:
        if first.device.type != "cpu":
            raise ValueError(f"unsupported device {first.device}")
        res = fused_bitwise_stacked_plain(expression, names, operands,
                                          n_bits)
        return [r if o is None else o.copy_(r) for r, o in zip(res, outs)]
    if len(operands) > 65535:
        raise ValueError("fused_bitwise_stacked takes at most 65535 "
                         "queries a launch")
    for arrays in operands:
        _check_operands(arrays, first)
    _check_operands([o for o in outs if o is not None], first)
    outs = [torch.empty_like(first) if o is None else o for o in outs]
    if first.numel() == 0:
        return outs
    if any(len(arrays) != program.n_operands for arrays in operands):
        raise ValueError(f"the program reads {program.n_operands} operands")
    shape = first.shape
    words = int(shape[-1]) if len(shape) else 1
    n = first.numel()
    tile = tile_for(program)
    mul, shift = divmod_magic(words)
    n_in = program.n_operands
    flat = [t.data_ptr() for arrays in operands for t in arrays]
    rows = [tuple(flat[k:k + n_in]) for k in range(0, len(flat), n_in)]
    jobs = group_jobs(rows)
    ptrs = pointer_table(rows, jobs, [o.data_ptr() for o in outs])
    table = not by_value(program, len(operands), len(jobs))
    if table:                           # a large epoch: a device table
        host_ptrs = None
        dev_table = torch.tensor(ptrs, dtype=torch.int64).pin_memory().to(
            first.device, non_blocking=True)
    else:
        host_ptrs, dev_table = (ctypes.c_ulonglong * len(ptrs))(*ptrs), None
    code = program.packed
    lib = _lib()
    stream = torch.cuda.current_stream(first.device).cuda_stream
    grid = ctypes.c_int(0)
    rc = lib.fused_bitwise_launch(
        host_ptrs, None if dev_table is None else dev_table.data_ptr(),
        code.ctypes.data, n_in, program.n_loads,
        int(code.shape[0]), program.result, program.shared_regs, tile, n,
        words, -1 if n_bits is None else int(n_bits), mul, shift,
        len(jobs), len(outs), stream, ctypes.byref(grid))
    build.check(lib, rc, "fused_bitwise launch")
    wrapper.launches += 1
    # persistent blocks walked more than one tile each: more (job, tile)
    # pairs than blocks
    wrapper.ring_launches += -(-n // tile_words(tile)) * len(jobs) > \
        grid.value
    wrapper.wide_launches += program.n_loads > WARP_LOADS
    if table:               # one query's pointers always go by value
        wrapper.table_launches += 1
    if len(jobs) < len(outs):           # only an epoch repeats a job
        wrapper.shared_outputs += len(outs) - len(jobs)
    return outs


def fused_bitwise(expression: E.Expr, names: Sequence[str],
                  arrays: Sequence[torch.Tensor], program: Program,
                  n_bits: Optional[int] = None,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Evaluate ``program`` (the lowering of ``expression`` over
    ``names``) over equal-shaped int32 tensors in ONE launch, masking
    bits past ``n_bits`` of each row when given. ``out`` may be one of
    the operands (an in-place update: each word is read before it is
    written, by the same thread)."""
    return _launch(fused_bitwise, expression, names, [arrays], program,
                   n_bits, [out])[0]


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
    epoch). Each result is a tensor of its own; queries of one job
    (``group_jobs``) share its evaluation, not their outputs."""
    return _launch(fused_bitwise_stacked, expression, names, operands,
                   program, n_bits, [None] * len(operands))


fused_bitwise_stacked.launches = 0
fused_bitwise_stacked.ring_launches = 0
fused_bitwise_stacked.wide_launches = 0
fused_bitwise_stacked.table_launches = 0
fused_bitwise_stacked.shared_outputs = 0
