"""The host-side logic of the port's kernels, on the CPU.

The ``csrc/*.cu`` kernels run only on the card, so what the wrappers
decide for them - the loads-first register program, its packed words, the
fused kernel's tile and ring, the tail mask's division, binary_matmul's tile,
split of K and grid, popcount_rows' route, head/body/tail cut and how a
row's blocks meet, and bitweaving_scan's common vector width and masked
store - is held here against the reference package
(``repro.kernels.ops``, Pallas in interpret mode) and against numpy
models of the kernels' arithmetic. Exact equality
throughout: integer bit arithmetic has no tolerance. The kernels
themselves are checked on the card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import expr as JE
from repro.kernels import ops as jops
from repro_torch.apps.bitweaving_db import scan_expr
from repro_torch.convert import from_numpy_u32, to_numpy_u32
from repro_torch.core import expr as E
from repro_torch.kernels import binary_matmul as kbmm
from repro_torch.kernels import bitweaving as kbv
from repro_torch.kernels import bitwise as kbw
from repro_torch.kernels import popcount as kpc
from test_torch_kernels import WIDE_COLUMNS, emulate_packed, wide_program

SMS = 132       # the H100 SXM's streaming multiprocessors, the plans' card


def words(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def to_ref(e: E.Expr) -> JE.Expr:
    """The same DAG built from the reference's Expr, node for node."""
    if e.op == "var":
        return JE.Expr.var(e.name)
    if e.op == "lit":
        return JE.Expr("lit", (), e.name)
    return JE.Expr(e.op, tuple(to_ref(a) for a in e.args))


def rand_expr(rng, names, depth=0):
    if depth > 3 or rng.integers(3) == 0:
        if rng.integers(8) == 0:
            return E.Expr("lit", (), ("zero", "one")[rng.integers(2)])
        return E.Expr.var(names[rng.integers(len(names))])
    op = ("and", "or", "xor", "not", "maj")[rng.integers(5)]
    if op == "not":
        return ~rand_expr(rng, names, depth + 1)
    if op == "maj":
        return E.maj(*(rand_expr(rng, names, depth + 1) for _ in range(3)))
    a, b = rand_expr(rng, names, depth + 1), rand_expr(rng, names, depth + 1)
    return {"and": a & b, "or": a | b, "xor": a ^ b}[op]


# -- the fused-bitwise interpreter ---------------------------------------------


def decode(word: int):
    """One packed instruction -> (op, dst, s0, s1, s2)."""
    return (word & 7, (word >> 3) & 63, (word >> 9) & 63, (word >> 15) & 63,
            (word >> 21) & 63)


def run_kernel(program: kbw.Program, arrays, n_bits=None, blocks=7,
               offsets=None):
    """numpy model of fused_bitwise_kernel on flat (rows, words) operands:
    ``blocks`` persistent blocks walk the tiles (block b takes tiles b,
    b + blocks, ...); each tile's operands arrive as the 16-byte-aligned
    span that encloses them (operand k ``offsets[k]`` bytes past a 16-byte
    boundary, 4 k mod 16 by default) and are read at their shift; a tile's
    (word w, thread t) is flat word tile * T + w * CT + t; the packed
    program runs with its marks (``emulate_packed``); the tail mask uses
    the multiply-high column."""
    shape = arrays[0].shape
    n, row_words = arrays[0].size, shape[-1]
    tile = kbw.tile_for(program)
    w_per, warps = kbw.TILES[tile]
    ct, words_ = warps * 32, kbw.tile_words(tile)
    assert words_ == w_per * ct
    assert kbw.shared_bytes(program, tile, 2) <= kbw.MAX_SMEM
    offsets = offsets or [4 * k % 16 for k in range(len(arrays))]
    # each operand's bytes at its offset past a 16-byte boundary, with
    # room for the enclosing granules on both sides
    memory = []
    for a, off in zip(arrays, offsets):
        buf = np.zeros(16 + 4 * n + 32, np.uint8)
        buf[16 + off:16 + off + 4 * n] = a.reshape(-1).view(np.uint8)
        memory.append((buf, 16 + off))
    tiles = -(-n // words_)
    out = np.zeros(n, np.uint32)
    seen = np.zeros(n, int)
    loads = [(int(wd) >> 9) & 63 for wd in program.packed[:program.n_loads]]
    for b in range(blocks):
        for item in range(b, tiles, blocks):
            i0, i1 = item * words_, min(item * words_ + words_, n)
            slots = []
            for k in loads:
                buf, base = memory[k]
                lo, hi = (base + 4 * i0) & ~15, (base + 4 * i1 + 15) & ~15
                assert 0 <= lo and hi <= buf.size and (hi - lo) % 16 == 0
                assert hi - lo <= 4 * words_ + 16
                shift = base + 4 * i0 - lo
                assert shift == base % 16          # one shift per operand
                slot = np.zeros(4 * words_ + 16, np.uint8)
                slot[:hi - lo] = buf[lo:hi]
                slots.append(slot[shift:shift + 4 * words_].view(np.uint32))
            t, w = np.meshgrid(np.arange(ct), np.arange(w_per),
                               indexing="ij")
            j = (w * ct + t).reshape(-1)
            by_operand = [None] * len(arrays)
            for k, slot in zip(loads, slots):
                by_operand[k] = slot[j]
            v = emulate_packed(program, [x if x is not None else
                                         np.zeros(j.size, np.uint32)
                                         for x in by_operand])
            idx = i0 + j
            keep = idx < n
            out[idx[keep]] = v[keep]
            seen[idx[keep]] += 1
    assert (seen == 1).all()                    # each word once
    if n_bits is not None and n_bits < 32 * row_words:
        mul, shift = kbw.divmod_magic(row_words)
        u = np.arange(n, dtype=np.uint64)
        quo = (((u * mul) >> 32) + u) >> shift
        col = (u - quo * row_words).astype(np.int64)
        full, rem = n_bits // 32, n_bits % 32
        mask = np.where(col < full, 0xFFFFFFFF,
                        np.where(col == full, (1 << rem) - 1, 0))
        out = out & mask.astype(np.uint32)
    return out.reshape(shape)


@pytest.mark.parametrize("seed", range(4))
def test_loads_first_program_matches_reference(seed):
    """The lowered program, run as the kernel runs it, equals eval_expr
    and the reference's fused kernel; every load comes first, each into a
    register of its own, and the packed words encode the same loads."""
    rng = np.random.default_rng(300 + seed)
    names = ("a", "b", "c", "d")
    shape = (3, 17)
    env = {nm: words(rng, shape) for nm in names}
    for _ in range(6):
        expr = rand_expr(rng, names)
        prog = kbw.lower(expr, names)
        decoded = [decode(word) for word in prog.packed.tolist()]
        assert len(set(prog.loads)) == prog.n_loads
        assert [d[:3] for d in decoded[:prog.n_loads]] == \
            [(kbw.OP_LOAD, k, s) for k, s in enumerate(prog.loads)]
        assert all(d[0] != kbw.OP_LOAD for d in decoded[prog.n_loads:])
        got = run_kernel(prog, [env[nm] for nm in names])
        np.testing.assert_array_equal(got, E.eval_expr(expr, env))
        want = np.asarray(jops.bitwise_eval(to_ref(expr), env))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,n_bits", [
    ((187538,), 6_001_215), ((3, 40), 37), ((257, 8), 255), ((1, 7), 200),
    ((2, 3, 40), 1279)])
def test_kernel_tail_mask_matches_plain(shape, n_bits):
    """The 8-plane TPC-H scan at the table's tail mask, and other ragged
    rows: the kernel's column from the multiply-high division masks as
    the plain version does."""
    rng = np.random.default_rng(n_bits)
    names = tuple(f"x{i}" for i in range(8))
    expr = scan_expr(8, 37, 200, prefix="x")
    prog = kbw.lower(expr, names)
    arrays = [words(rng, shape) for _ in names]
    got = run_kernel(prog, arrays, n_bits)
    want = kbw.fused_bitwise_plain(expr, names,
                                   [from_numpy_u32(a, device="cpu")
                                    for a in arrays],
                                   n_bits)
    np.testing.assert_array_equal(got, to_numpy_u32(want))


@pytest.mark.parametrize("n", sorted(WIDE_COLUMNS))
def test_wide_program_through_the_kernel_model(n):
    """Programs of more loads than the producer warp has lanes, as the
    kernel runs them: each load's slot of the ring stage at its own
    shift (loads 32 and up too), masked rows; equal to the reference.
    The tile is 4 words on 4 warps, one stage at most two blocks an SM."""
    rng = np.random.default_rng(500 + n)
    expr, names = wide_program(n, "plan")
    prog = kbw.lower(expr, names)
    assert prog.n_loads == n > kbw.WARP_LOADS
    assert kbw.tile_for(prog) == 0
    assert 2 * (kbw.shared_bytes(prog, 0, 1) + 1024) <= kbw.SM_SHARED
    shape, n_bits = (3, 700), 700 * 32 - 45
    env = {nm: words(rng, shape) for nm in names}
    arrays = [env[nm] for nm in names]
    offsets = [4 * (k * 7 % 4) for k in range(n)]
    got = run_kernel(prog, arrays, offsets=offsets)
    np.testing.assert_array_equal(
        got, np.asarray(jops.bitwise_eval(to_ref(expr), env)))
    masked = run_kernel(prog, arrays, n_bits, offsets=offsets)
    want = kbw.fused_bitwise_plain(
        expr, names, [from_numpy_u32(a, device="cpu") for a in arrays],
        n_bits)
    np.testing.assert_array_equal(masked, to_numpy_u32(want))


def test_divmod_magic_divides_every_index():
    rng = np.random.default_rng(0)
    divisors = [1, 2, 3, 7, 32, 187538, 524288, 2**31 - 1] + \
        [int(d) for d in rng.integers(1, 2**31, 40)]
    for d in divisors:
        mul, shift = kbw.divmod_magic(d)
        assert 0 < mul < 2**32 and 0 <= shift <= 31
        i = np.concatenate([rng.integers(0, 2**31, 2000),
                            [0, 2**31 - 1, d - 1, d, d + 1,
                             (2**31 - 1) // d * d, (2**31 - 1) // d * d - 1]])
        i = i[(i >= 0) & (i < 2**31)].astype(np.uint64)
        quo = (((i * mul) >> 32) + i) >> shift
        np.testing.assert_array_equal(quo, i // d, err_msg=f"d={d}")
    assert kbw.divmod_magic(2**31) == (0, 0)    # the kernel divides by %


def test_register_buckets_and_their_limits():
    """The kernel's tile for a program, and the shared memory of its ring:
    every program within the limits (32 loads, 512 instructions, 64
    registers) fits two ring stages of a tile in an H100 block."""
    x, y = E.Expr.var("x"), E.Expr.var("y")
    small = kbw.lower(x & y, ("x", "y"))
    assert kbw.tile_for(small) == 1 and kbw.tile_words(1) == 512
    assert small.shared_regs == 2              # the result: no register
    # 64 + 2 (1 + 1) 16 B of programs -> 128; 2 stages x 2 slots x 2064 B
    assert kbw.shared_bytes(small, 1, 2) == 128 + 2 * 2 * 2064
    assert kbw.shared_bytes(small, 1, 3) == 256 + 3 * 2 * 2064
    # 8 words a thread where six one-stage blocks fit an SM (12 loads and
    # 14 registers: 12 slots and 2 registers of 2 KB), else 4 words
    one = scan_expr(12, 1000, 2000, prefix="d")
    prog = kbw.lower(one, tuple(sorted(f"d{i}" for i in range(12))))
    assert prog.n_loads == 12
    assert 6 * (kbw.shared_bytes(prog, 1, 1) + 1024) <= kbw.SM_SHARED
    assert kbw.tile_for(prog) == 1
    two = scan_expr(8, 37, 200, prefix="p") & scan_expr(7, 5, 90, prefix="s")
    names = tuple(sorted({nd.name for nd in E.topo_order(two)
                          if nd.op == "var"}))
    prog = kbw.lower(two, names)
    assert prog.n_loads == 15 and prog.shared_regs <= 24
    assert kbw.tile_for(prog) == (
        1 if 6 * (kbw.shared_bytes(prog, 1, 1) + 1024) <= kbw.SM_SHARED
        else 0)
    # the largest program the limits allow: 4 words a thread, one stage
    packed = np.full(kbw.MAX_INSTR, kbw.OP_AND, np.uint32)
    packed[:kbw.MAX_OPERANDS] = kbw.OP_LOAD | \
        np.arange(kbw.MAX_OPERANDS, dtype=np.uint32) * (1 << 3 | 1 << 9)
    widest = kbw.Program(packed, n_operands=kbw.MAX_OPERANDS,
                         loads=tuple(range(kbw.MAX_OPERANDS)),
                         shared_regs=kbw.MAX_REGS, smem_bytes_per_word=0)
    assert kbw.tile_for(widest) == 0
    assert kbw.shared_bytes(widest, 0, 1) <= kbw.MAX_SMEM
    for tile in range(len(kbw.TILES)):
        w, warps = kbw.TILES[tile]
        assert kbw.tile_words(tile) == w * warps * 32
        assert kbw.tile_words(tile) * 4 % 16 == 0   # one shift an operand


def test_program_of_a_single_operand_or_literal():
    x = E.Expr.var("x")
    prog = kbw.lower(x, ("x",))
    assert prog.n_loads == 1 and len(prog.packed) == 1
    a = words(np.random.default_rng(1), (2, 9))
    np.testing.assert_array_equal(run_kernel(prog, [a]), a)
    one = kbw.lower(E.Expr("lit", (), "one"), ("x",))
    assert one.n_loads == 0
    np.testing.assert_array_equal(run_kernel(one, [a], 40),
                                  E.eval_expr(E.ONE, {"x": a})
                                  & np.array([0xFFFFFFFF, 0xFF] + [0] * 7,
                                             np.uint32))


# -- binary_matmul --------------------------------------------------------------


def test_plan_picks_tiles_splits_and_grid():
    P = kbmm.Plan
    # qwen2.5-3b's MLP width: 128x256 wgmma tiles fill the card, no split
    assert kbmm.plan(2048, 11008, 64, SMS) == P(0, 16, 43, 1, 8)
    # the reference benchmark's 256x256x4096: 16 tiles of 64x64, K split
    assert kbmm.plan(256, 256, 128, SMS) == P(1, 4, 4, 4, 4)
    # the example's inference: N = 8 takes the 128x8 tile
    assert kbmm.plan(2048, 8, 8, SMS) == P(2, 16, 1, 1, 1)
    assert kbmm.plan(1, 1, 0, SMS) == P(2, 1, 1, 1, 1)
    # one past and one short of each tile edge
    assert kbmm.plan(129, 9, 9, SMS)[:3] == (1, 3, 1)
    assert kbmm.plan(127, 8, 7, SMS)[:3] == (2, 1, 1)
    # the wgmma tiles from one a streaming multiprocessor up
    assert kbmm.plan(1536, 2816, 2, SMS) == P(0, 12, 11, 1, 1)
    assert kbmm.plan(1535, 2815, 2, SMS) == P(0, 12, 11, 1, 1)
    assert kbmm.plan(1408, 2816, 2, SMS)[:3] == (1, 22, 44)
    for m, n, kw in [(3, 5, 1250), (65, 67, 513), (40, 70, 32), (1, 9, 17),
                     (8, 128, 128), (2048, 11008, 64), (300, 300, 100000)]:
        p = kbmm.plan(m, n, kw, SMS)
        tm, tn = kbmm.TILES[p.config]
        assert (p.tiles_m, p.tiles_n) == (-(-m // tm), -(-n // tn))
        chunks = max(1, -(-kw // kbmm.KC))
        # every split walks at least one chunk, and together all of them
        assert (p.splits - 1) * p.chunks_per_split < chunks
        assert p.splits * p.chunks_per_split >= chunks
        assert 1 <= p.splits <= 65535             # grid z
        assert p.splits == 1 or p.chunks_per_split >= kbmm.MIN_SPLIT_CHUNKS
        assert p.tiles_m * p.tiles_n * p.splits <= max(
            kbmm.FILL_WAVES * SMS, p.tiles_m * p.tiles_n)


def test_plan_raises_past_the_grid():
    assert kbmm.MAX_N == 2**31 - 1
    with pytest.raises(ValueError, match="N <="):
        kbmm.plan(1, kbmm.MAX_N + 1, 1, SMS)
    with pytest.raises(ValueError, match="tiles"):
        kbmm.plan(2**40, 2**20, 1, SMS)
    with pytest.raises(ValueError):
        kbmm.plan(0, 5, 1, SMS)


def expand(w: np.ndarray, lane: int, half: int) -> np.ndarray:
    """The kernel's expansion: bits 8j + lane + 4 half (j = 0..3) of each
    word -> int8 +1 (set) or -1, as four bytes of one register."""
    m = (w.astype(np.uint32) >> np.uint32(lane + 4 * half)) & np.uint32(
        0x01010101)
    e = (np.uint32(0xFFFFFFFF) - np.uint32(0xFE) * m).astype(np.uint32)
    return e.view(np.uint8).reshape(*w.shape, 4).view(np.int8)


def run_bmm(a: np.ndarray, b: np.ndarray, k_bits: int) -> np.ndarray:
    """numpy model of binary_matmul_kernel's arithmetic: the plan's splits
    of K in chunks of KC words (zero-filled past Kw), +-1 int8 expansion
    by quad lane, int32 products, the epilogue's correction, and the
    atomics' sum over splits."""
    m, kw = a.shape
    n = b.shape[0]
    p = kbmm.plan(m, n, kw, SMS)
    walked = p.splits * p.chunks_per_split * kbmm.KC
    ap = np.zeros((m, walked), np.uint32)
    bp = np.zeros((n, walked), np.uint32)
    ap[:, :kw], bp[:, :kw] = a, b
    chunks = max(1, -(-kw // kbmm.KC)) if kw else 0
    out = np.zeros((m, n), np.int64)
    for s in range(p.splits):
        c0 = s * p.chunks_per_split
        c1 = min(c0 + p.chunks_per_split, chunks)
        n_chunks = max(0, c1 - c0)
        cols = slice(c0 * kbmm.KC, (c0 + n_chunks) * kbmm.KC)
        acc = np.zeros((m, n), np.int64)
        for lane in range(4):
            for half in range(2):
                ea = expand(ap[:, cols], lane, half).reshape(m, -1)
                eb = expand(bp[:, cols], lane, half).reshape(n, -1)
                acc += ea.astype(np.int64) @ eb.astype(np.int64).T
        out += acc - 32 * kbmm.KC * n_chunks + (k_bits if s == 0 else 0)
    assert np.abs(out).max(initial=0) < 2**31
    return out.astype(np.int32)


def test_expansion_covers_every_bit_once():
    """The eight (lane, half) registers of a word hold its 32 bits, one
    byte each: a word of one set bit expands to a single +1."""
    for bit in range(32):
        w = np.array([1 << bit], np.uint32)
        got = np.stack([expand(w, lane, half)[0]
                        for lane in range(4) for half in range(2)])
        assert (got == 1).sum() == 1 and (got == -1).sum() == 31


@pytest.mark.parametrize("m,n,k", [
    (5, 9, 37), (40, 70, 1000), (3, 5, 40000), (65, 67, 16416 - 5),
    (129, 8, 257), (127, 129, 33 * 8 * 32 - 31), (2, 3, 0)])
def test_kernel_arithmetic_matches_reference(m, n, k):
    """Pad bits (k_bits % 32 != 0) and zero-filled words past Kw expand to
    -1 in both operands; the per-split correction makes the sum exact."""
    rng = np.random.default_rng(k + 7)
    kw = -(-k // 32)
    a, b = words(rng, (m, kw)), words(rng, (n, kw))
    if k % 32:
        a[:, -1] &= (1 << (k % 32)) - 1
        b[:, -1] &= (1 << (k % 32)) - 1
    got = run_bmm(a, b, k)
    want = kbmm.binary_matmul_plain(from_numpy_u32(a, device="cpu"),
                                    from_numpy_u32(b, device="cpu"), k)
    np.testing.assert_array_equal(got, want.numpy())
    if kw:
        ref = np.asarray(jops.binary_matmul(jnp.asarray(a), jnp.asarray(b), k))
        np.testing.assert_array_equal(got, ref)


# -- popcount_rows ------------------------------------------------------------

BASE = 1 << 20          # a 16-byte-aligned stand-in address for row 0


def run_popcount(x: np.ndarray, ptr: int) -> np.ndarray:
    """numpy model of csrc/popcount.cu at ``kpc.plan(rows, words, SMS)``
    with row 0 at address ``ptr``:
    which words each thread loads (every word of every row exactly once,
    asserted), the block sums, the 64-bit ticket words that carry them
    (tickets above bit 40, the running sum below), and one store a row by
    the block that draws the last ticket."""
    rows, row_words = x.shape
    p = kpc.plan(rows, row_words, SMS)
    flat = x.reshape(-1).astype(np.int64)
    pc = np.array([bin(int(w)).count("1") for w in range(256)], np.int64)
    bits = sum(pc[(flat >> (8 * k)) & 255] for k in range(4))
    seen = np.zeros(flat.size, np.int64)
    out = np.full(rows, -1, np.int64)
    stores = np.zeros(rows, np.int64)
    if p.route == kpc.ROUTE_SHORT:
        assert row_words <= p.group * kpc.SHORT_LOADS and p.group <= 32
        t = np.arange(p.blocks * kpc.THREADS)
        row, j = t // p.group, t % p.group
        acc = np.zeros(t.size, np.int64)
        for u in range(kpc.SHORT_LOADS):
            i = j + u * p.group
            ok = (row < rows) & (i < row_words)
            idx = row[ok] * row_words + i[ok]
            np.add.at(seen, idx, 1)
            acc[ok] += bits[idx]
        sums = acc.reshape(-1, p.group).sum(1)     # the group's shuffles
        first = np.arange(0, t.size, p.group)
        keep = row[first] < rows
        out[row[first][keep]] = sums[keep]
        np.add.at(stores, row[first][keep], 1)
    else:
        assert p.blocks == rows * p.splits and p.splits < 2**24
        tid = np.arange(kpc.THREADS)
        for r in range(rows):
            head, nv, tail = kpc.row_parts(row_words, ptr + 4 * r * row_words)
            assert (ptr + 4 * (r * row_words + head)) % 16 == 0 or nv == 0
            base = r * row_words
            ticket = 0
            for s in range(p.splits):
                lo, hi = s * p.per, min(s * p.per + p.per, nv)
                part = 0
                for start in range(lo, max(lo, hi), kpc.THREADS * kpc.UNROLL):
                    for u in range(kpc.UNROLL):
                        i = start + tid + u * kpc.THREADS
                        i = i[i < hi]
                        idx = (base + head + 4 * i[:, None]
                               + np.arange(4)).reshape(-1)
                        np.add.at(seen, idx, 1)
                        part += bits[idx].sum()
                if s == 0:
                    idx = base + np.arange(head)
                    np.add.at(seen, idx, 1)
                    part += bits[idx].sum()
                if s == p.splits - 1:
                    idx = base + head + 4 * nv + np.arange(tail)
                    np.add.at(seen, idx, 1)
                    part += bits[idx].sum()
                if p.splits == 1:
                    out[r] = part
                    stores[r] += 1
                    continue
                old, ticket = ticket, ticket + (1 << 40 | int(part))
                if old >> 40 == p.splits - 1:      # the last ticket
                    out[r] = (old & ((1 << 40) - 1)) + part
                    stores[r] += 1
                    ticket = 0
            assert ticket == 0                      # left for the next launch
    assert (seen == 1).all(), "a word was counted twice or never"
    assert (stores == 1).all(), "a row was stored twice or never"
    return out.astype(np.int32)


POPCOUNT_SHAPES = [(r, w) for r in (1, 3) for w in range(1, 10)] + [
    (1, 187538), (2, 187538), (1, 524288), (3, 524288), (70000, 3),
    (257, 8), (6, 40), (1, 256), (1, 257), (5, 1000), (600, 300),
    (1, 40000)]


@pytest.mark.parametrize("offset", [0, 4, 8, 12])
@pytest.mark.parametrize("shape", POPCOUNT_SHAPES)
def test_popcount_partition_counts_every_word_once(shape, offset):
    """Head, body and tail together take every word of every row once, at
    every 4-byte offset mod 16 and for any row length; the counts equal
    the reference's popcount (Pallas, interpret mode)."""
    rng = np.random.default_rng(shape[1] + offset)
    x = words(rng, shape)
    np.testing.assert_array_equal(run_popcount(x, BASE + offset),
                                  np.asarray(jops.popcount(x)))


def test_popcount_plan_routes_and_grids():
    P, S, L = kpc.Plan, kpc.ROUTE_SHORT, kpc.ROUTE_LONG
    # the served 2^24-bit row: 132 blocks, one pass of <= 4 vectors each,
    # no head and no tail words
    assert kpc.plan(1, 524288, SMS) == P(L, 1, 132, 993, 132)
    assert kpc.row_parts(524288, BASE) == (0, 131072, 0)
    # count_between's TPC-H row, 4 bytes off: 3 head words, 3 tail words
    assert kpc.plan(1, 187538, SMS) == P(L, 1, 132, 356, 132)
    assert kpc.row_parts(187538, BASE + 4) == (3, 46883, 3)
    assert kpc.plan(1, 1000, SMS).splits == 1
    # short rows: a group of threads a row, each with at most 8 words
    assert kpc.plan(70000, 3, SMS) == P(S, 1, 1, 0, 274)
    assert kpc.row_parts(3, BASE) == (0, 0, 3)
    assert kpc.plan(257, 8, SMS) == P(S, 1, 1, 0, 2)
    assert kpc.plan(6, 40, SMS).group == 8
    assert kpc.plan(1, kpc.SHORT_WORDS, SMS).group == 32
    assert kpc.plan(1, kpc.SHORT_WORDS + 1, SMS).route == L
    # many long rows: a block a row, no tickets
    assert kpc.plan(600, 300, SMS)[2:5] == (1, 75, 600)
    # a card of fewer SMs (an H100 PCIe has 114) gets a grid of its own
    assert kpc.plan(1, 1 << 22, SMS)[2] == 4 * SMS
    assert kpc.plan(1, 1 << 22, 114)[2] == 4 * 114
    for sms in (SMS, 114):
        for rows, n in [(1, 257), (2, 524288), (7, 187538), (600, 300),
                        (1, 40000), (1, 1 << 26)]:
            p = kpc.plan(rows, n, sms)
            assert p.splits * p.per >= n // 4 > (p.splits - 1) * p.per
            assert p.blocks == rows * p.splits
            assert p.per <= kpc.THREADS * kpc.UNROLL or \
                rows * p.splits >= kpc.FILL_WAVES * sms
            assert rows * p.splits >= min(sms, -(-n // 4 // kpc.THREADS))


def test_popcount_plan_raises():
    with pytest.raises(ValueError, match="aligned"):
        kpc.row_parts(8, BASE + 2)
    with pytest.raises(ValueError):
        kpc.plan(0, 8, SMS)


# -- bitweaving_scan ----------------------------------------------------------


def test_bitweaving_plan_picks_the_common_width():
    """The widest of 16, 8 and 4 bytes dividing both the planes' address
    and 4 * words, for every (words mod 4, offset) pair."""
    want = {0: {0: 16, 4: 4, 8: 8, 12: 4}, 1: {0: 4, 4: 4, 8: 4, 12: 4},
            2: {0: 8, 4: 4, 8: 8, 12: 4}, 3: {0: 4, 4: 4, 8: 4, 12: 4}}
    for rem, by_offset in want.items():
        for offset, width in by_offset.items():
            n = 40 + rem
            p = kbv.plan(8, n, BASE + offset)
            assert p.width == width, (rem, offset)
            assert p.blocks == -(-(4 * n // width) // kbv.THREADS)
    assert kbv.plan(8, 187538, BASE) == kbv.Plan(8, 367)   # TPC-H SF1
    assert kbv.plan(8, 524288, BASE) == kbv.Plan(16, 512)  # 2^24 rows
    assert kbv.plan(8, 187538, BASE + 4).width == 4        # a row view
    with pytest.raises(ValueError):
        kbv.plan(33, 8, BASE)
    with pytest.raises(ValueError, match="aligned"):
        kbv.plan(8, 8, BASE + 2)


def run_scan(planes: np.ndarray, c1: int, c2: int, ptr: int,
             n_bits=None) -> np.ndarray:
    """numpy model of bitweaving_scan_kernel at ``kbv.plan``: every plane's
    vector at a thread's position, the branch-free recurrence on the
    constants' bit masks, and the tail mask in the store."""
    b, n = planes.shape
    p = kbv.plan(b, n, ptr)
    lanes = p.width // 4
    i = np.arange(p.blocks * kbv.THREADS)
    w = (i[:, None] * lanes + np.arange(lanes)).reshape(-1)
    w = w[w < n]
    assert np.array_equal(w, np.arange(n))      # each word once, in order
    ones = np.uint32(0xFFFFFFFF)
    gt1 = np.zeros(n, np.uint32)
    lt2 = np.zeros(n, np.uint32)
    eq1, eq2 = np.full(n, ones), np.full(n, ones)
    for k in range(b):
        sh = b - 1 - k
        m1 = np.uint32((0 - ((c1 >> sh) & 1)) & 0xFFFFFFFF)
        m2 = np.uint32((0 - ((c2 >> sh) & 1)) & 0xFFFFFFFF)
        v = planes[k]
        gt1 |= eq1 & v & ~m1
        eq1 &= ~(v ^ m1)
        lt2 |= eq2 & ~v & m2
        eq2 &= ~(v ^ m2)
    full, partial = kbv.tail_mask(n_bits, n)
    keep = np.where(w < full, ones, np.where(w == full, partial, 0)).astype(
        np.uint32)
    return (gt1 | eq1) & (lt2 | eq2) & keep


@pytest.mark.parametrize("offset", [0, 4, 8])
def test_masked_scan_store_matches_reference(offset):
    """The kernel's store at every n_bits % 32 equals the reference's scan
    ANDed with the packed n-row mask of its count_between."""
    from repro.core.bitvector import pack_bits as jpack
    rng = np.random.default_rng(offset)
    b, n = 8, 42
    planes = words(rng, (b, n))
    for c1, c2 in ((37, 200), (0, 255), (255, 0), (5, 5)):
        scan = np.asarray(jops.bitweaving_scan(planes, c1, c2))
        np.testing.assert_array_equal(run_scan(planes, c1, c2, BASE + offset),
                                      scan)
        for rem in range(32):
            n_bits = 32 * 37 + rem
            mask = np.zeros(n * 32, bool)
            mask[:n_bits] = True
            want = scan & np.asarray(jpack(jnp.asarray(mask)))[:n]
            got = run_scan(planes, c1, c2, BASE + offset, n_bits)
            np.testing.assert_array_equal(got, want, err_msg=f"rem {rem}")
            plain = kbv.bitweaving_scan_plain(
                from_numpy_u32(planes, device="cpu"), c1, c2, n_bits)
            np.testing.assert_array_equal(to_numpy_u32(plain), want)


@pytest.mark.parametrize("b", [1, 12, 32])
def test_scan_model_every_width_matches_reference(b):
    rng = np.random.default_rng(b)
    top = (1 << b) - 1
    for n, offset in ((40, 0), (42, 8), (43, 4)):
        planes = words(rng, (b, n))
        for c1, c2 in ((0, top), (top // 3, 2 * top // 3), (top, top)):
            np.testing.assert_array_equal(
                run_scan(planes, c1, c2, BASE + offset, 32 * n - 3),
                np.asarray(jops.bitweaving_scan(planes, c1, c2))
                & np.array([0xFFFFFFFF] * (n - 1) + [0x1FFFFFFF], np.uint32))


@pytest.mark.parametrize("n_rows", [6_001_215, 1000, 191, 64, 33])
def test_count_between_matches_reference_at_tpch_rows(n_rows):
    """count_between through the port's CPU path (the kernels' plain
    versions, the mask passed as n_bits) equals the reference's at TPC-H
    SF1's 6,001,215 rows and at row counts on and off a word edge."""
    from repro.apps import bitweaving_db as jbw
    from repro_torch.apps.bitweaving_db import BitWeavingColumn
    rng = np.random.default_rng(n_rows)
    values = rng.integers(0, 256, n_rows).astype(np.uint32)
    jcol = jbw.BitWeavingColumn.from_values(values, 8)
    pcol = BitWeavingColumn.from_values(values, 8, device="cpu")
    np.testing.assert_array_equal(to_numpy_u32(pcol.planes),
                                  np.asarray(jcol.planes))
    for c1, c2 in ((37, 200), (0, 255), (200, 37)):
        want = jcol.count_between(c1, c2)
        assert pcol.count_between(c1, c2) == want
        assert pcol.count_between(c1, c2, use_kernel=False) == want
        assert want == pcol.oracle_count(values, c1, c2)
