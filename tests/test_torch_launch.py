"""The host-side logic of the port's two tensor-shaped kernels, on the CPU.

``csrc/bitwise.cu`` and ``csrc/binary_matmul.cu`` run only on the card,
so what the wrappers decide for them - the loads-first register program,
its packed words, the register-file bucket, the tail mask's division, and
binary_matmul's tile, split of K and grid - is held here against the
reference package (``repro.kernels.ops``, Pallas in interpret mode) and
against numpy models of the kernels' arithmetic. Exact equality
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
from repro_torch.kernels import bitwise as kbw


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


def run_kernel(program: kbw.Program, arrays, n_bits=None):
    """numpy model of fused_bitwise_kernel on flat (rows, words) operands:
    the tile walk (tile, word w, thread t) -> flat index, the loads-first
    prologue, the register file, the last instruction kept in registers,
    and the tail mask's multiply-high column."""
    shape = arrays[0].shape
    n, row_words = arrays[0].size, shape[-1]
    flat = [a.reshape(-1) for a in arrays]
    w_per, smem = kbw.launch_shape(program.n_regs)
    assert smem == program.n_regs * w_per * kbw.THREADS * 4
    per_tile = w_per * kbw.THREADS
    tiles = -(-n // per_tile)
    t, w, tile = np.meshgrid(np.arange(kbw.THREADS), np.arange(w_per),
                             np.arange(tiles), indexing="ij")
    idx = (tile * per_tile + w * kbw.THREADS + t).reshape(-1)
    idx = idx[idx < n]
    assert np.array_equal(np.sort(idx), np.arange(n))   # each word once
    prog = [decode(int(x)) for x in program.packed]
    regs = {}
    for op, dst, s0, _, _ in prog[:program.n_loads]:
        assert op == kbw.OP_LOAD
        regs[dst] = flat[s0][idx]
    v = None
    for op, dst, s0, s1, s2 in prog[program.n_loads:]:
        assert op != kbw.OP_LOAD
        if op == kbw.OP_ZERO:
            v = np.zeros(idx.size, np.uint32)
        elif op == kbw.OP_ONE:
            v = np.full(idx.size, 0xFFFFFFFF, np.uint32)
        elif op == kbw.OP_NOT:
            v = ~regs[s0]
        elif op == kbw.OP_AND:
            v = regs[s0] & regs[s1]
        elif op == kbw.OP_OR:
            v = regs[s0] | regs[s1]
        elif op == kbw.OP_XOR:
            v = regs[s0] ^ regs[s1]
        else:
            a, b, c = regs[s0], regs[s1], regs[s2]
            v = (a & b) | (b & c) | (c & a)
        regs[dst] = v
    v = regs[program.result]
    if n_bits is not None and n_bits < 32 * row_words:
        mul, shift = kbw.divmod_magic(row_words)
        u = idx.astype(np.uint64)
        quo = (((u * mul) >> 32) + u) >> shift
        col = (u - quo * row_words).astype(np.int64)
        full, rem = n_bits // 32, n_bits % 32
        mask = np.where(col < full, 0xFFFFFFFF,
                        np.where(col == full, (1 << rem) - 1, 0))
        v = v & mask.astype(np.uint32)
    out = np.empty(n, np.uint32)
    out[idx] = v
    return out.reshape(shape)


@pytest.mark.parametrize("seed", range(4))
def test_loads_first_program_matches_reference(seed):
    """The lowered program, run as the kernel runs it, equals eval_expr
    and the reference's fused kernel; every load comes first, each into a
    register of its own, and the packed words encode the code rows."""
    rng = np.random.default_rng(300 + seed)
    names = ("a", "b", "c", "d")
    shape = (3, 17)
    env = {nm: words(rng, shape) for nm in names}
    for _ in range(6):
        expr = rand_expr(rng, names)
        prog = kbw.lower(expr, names)
        ops_col = prog.code[:, 0] & 0xFFFF
        assert (ops_col[:prog.n_loads] == kbw.OP_LOAD).all()
        assert (ops_col[prog.n_loads:] != kbw.OP_LOAD).all()
        assert list(prog.code[:prog.n_loads, 1]) == list(range(prog.n_loads))
        assert len(set(prog.loads)) == prog.n_loads
        for row, word in zip(prog.code.tolist(), prog.packed.tolist()):
            op, dst, s0, s1, s2 = decode(word)
            assert (op | s2 << 16, dst, s0, s1) == tuple(row)
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
                                   [from_numpy_u32(a) for a in arrays],
                                   n_bits)
    np.testing.assert_array_equal(got, to_numpy_u32(want))


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
    assert kbw.launch_shape(1) == (8, 8 * 1024)
    assert kbw.launch_shape(8) == (8, 8 * 8 * 1024)
    assert kbw.launch_shape(9) == (4, 9 * 4 * 1024)
    assert kbw.launch_shape(24) == (4, 24 * 4 * 1024)
    assert kbw.launch_shape(25) == (2, 25 * 2 * 1024)
    assert kbw.launch_shape(kbw.MAX_REGS) == (2, kbw.MAX_REGS * 2 * 1024)
    for n_regs in range(1, kbw.MAX_REGS + 1):   # within an H100 block's
        assert kbw.launch_shape(n_regs)[1] <= 232_448   # shared memory
    for bad in (0, kbw.MAX_REGS + 1):
        with pytest.raises(ValueError, match="registers"):
            kbw.launch_shape(bad)
    x, y = E.Expr.var("x"), E.Expr.var("y")
    assert kbw.launch_shape(kbw.lower(x & y, ("x", "y")).n_regs)[0] == 8
    two = scan_expr(8, 37, 200, prefix="p") & scan_expr(7, 5, 90, prefix="s")
    names = tuple(sorted({nd.name for nd in E.topo_order(two)
                          if nd.op == "var"}))
    prog = kbw.lower(two, names)
    assert prog.n_loads == 15 and prog.n_regs <= 24
    assert kbw.launch_shape(prog.n_regs)[0] == 4


def test_program_of_a_single_operand_or_literal():
    x = E.Expr.var("x")
    prog = kbw.lower(x, ("x",))
    assert prog.n_loads == 1 and prog.code.shape[0] == 1
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
    assert kbmm.plan(2048, 11008, 64) == P(0, 16, 43, 1, 8)
    # the reference benchmark's 256x256x4096: 16 tiles of 64x64, K split
    assert kbmm.plan(256, 256, 128) == P(1, 4, 4, 4, 4)
    # the example's inference: N = 8 takes the 128x8 tile
    assert kbmm.plan(2048, 8, 8) == P(2, 16, 1, 1, 1)
    assert kbmm.plan(1, 1, 0) == P(2, 1, 1, 1, 1)
    # one past and one short of each tile edge
    assert kbmm.plan(129, 9, 9)[:3] == (1, 3, 1)
    assert kbmm.plan(127, 8, 7)[:3] == (2, 1, 1)
    # the wgmma tiles from one a streaming multiprocessor up
    assert kbmm.plan(1536, 2816, 2) == P(0, 12, 11, 1, 1)
    assert kbmm.plan(1535, 2815, 2) == P(0, 12, 11, 1, 1)
    assert kbmm.plan(1408, 2816, 2)[:3] == (1, 22, 44)
    for m, n, kw in [(3, 5, 1250), (65, 67, 513), (40, 70, 32), (1, 9, 17),
                     (8, 128, 128), (2048, 11008, 64), (300, 300, 100000)]:
        p = kbmm.plan(m, n, kw)
        tm, tn = kbmm.TILES[p.config]
        assert (p.tiles_m, p.tiles_n) == (-(-m // tm), -(-n // tn))
        chunks = max(1, -(-kw // kbmm.KC))
        # every split walks at least one chunk, and together all of them
        assert (p.splits - 1) * p.chunks_per_split < chunks
        assert p.splits * p.chunks_per_split >= chunks
        assert 1 <= p.splits <= 65535             # grid z
        assert p.splits == 1 or p.chunks_per_split >= kbmm.MIN_SPLIT_CHUNKS
        assert p.tiles_m * p.tiles_n * p.splits <= max(
            kbmm.FILL_BLOCKS, p.tiles_m * p.tiles_n)


def test_plan_raises_past_the_grid():
    assert kbmm.MAX_N == 2**31 - 1
    with pytest.raises(ValueError, match="N <="):
        kbmm.plan(1, kbmm.MAX_N + 1, 1)
    with pytest.raises(ValueError, match="tiles"):
        kbmm.plan(2**40, 2**20, 1)
    with pytest.raises(ValueError):
        kbmm.plan(0, 5, 1)


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
    p = kbmm.plan(m, n, kw)
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
    want = kbmm.binary_matmul_plain(from_numpy_u32(a), from_numpy_u32(b), k)
    np.testing.assert_array_equal(got, want.numpy())
    if kw:
        ref = np.asarray(jops.binary_matmul(jnp.asarray(a), jnp.asarray(b), k))
        np.testing.assert_array_equal(got, ref)
