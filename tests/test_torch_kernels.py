"""The port's kernel wrappers against the reference's, bit for bit.

The same numpy inputs (from ``default_rng``) go through the JAX package's
``kernels.ops`` (Pallas in interpret mode on the CPU) and the port's
``repro_torch.kernels.ops`` (the kernels' plain versions on the CPU).
Exact equality throughout: integer bit arithmetic has no tolerance.

The register program that ``csrc/bitwise.cu`` interprets cannot run here,
so numpy emulators run it instead and are held against ``eval_expr``: one
of the plain register program (``code``), one of the kernel's form
(``packed``) that honours its forwarding, write-back and negation marks.
The kernels themselves are checked on the card by
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro.core import expr as JE
from repro.kernels import ops as jops
from repro_torch.apps.bitweaving_db import scan_expr
from repro_torch.convert import from_numpy_u32, to_numpy_u32
from repro_torch.core import expr as E
from repro_torch.kernels import bitweaving as kbv
from repro_torch.kernels import bitwise as kbw
from repro_torch.kernels import ops, popcount as kpc

SHAPES = [(1, 7), (129,), (2, 3, 40), (257, 8)]
X, Y, Z = E.Expr.var("x"), E.Expr.var("y"), E.Expr.var("z")
EXPRS = {
    "maj": E.maj(X, ~Y, Z),
    "not": ~(X & Z) ^ Y,
    # raw constructor keeps the literals in the DAG (no folding)
    "lit": E.Expr("or", (E.Expr("and", (X, E.ONE)),
                         E.Expr("xor", (E.Expr("not", (Y,)), E.ZERO)))),
    "mixed": E.maj(X ^ Y, ~Z, X | Z) & ~(Y & Z),
}


def to_ref(e: E.Expr) -> JE.Expr:
    """The same DAG built from the reference's Expr (raw constructors, so
    the structure is kept node for node)."""
    if e.op == "var":
        return JE.Expr.var(e.name)
    if e.op == "lit":
        return JE.Expr("lit", (), e.name)
    return JE.Expr(e.op, tuple(to_ref(a) for a in e.args))


def words(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def env_for(rng, shape, names=("x", "y", "z")):
    return {nm: words(rng, shape) for nm in names}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("ename", sorted(EXPRS))
def test_bitwise_eval_matches_reference(ename, shape):
    rng = np.random.default_rng(10 * sorted(EXPRS).index(ename)
                                + SHAPES.index(shape))
    expr = EXPRS[ename]
    env = env_for(rng, shape)
    want = np.asarray(jops.bitwise_eval(to_ref(expr), env))
    got = ops.bitwise_eval(expr, {k: from_numpy_u32(v, device="cpu")
                                  for k, v in env.items()})
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(to_numpy_u32(got), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_bitwise_eval_stacked_matches_reference(shape):
    rng = np.random.default_rng(7)
    expr = EXPRS["mixed"]
    envs = [env_for(rng, shape) for _ in range(3)]
    want = jops.bitwise_eval_stacked(to_ref(expr), ("x", "y", "z"), envs)
    got = ops.bitwise_eval_stacked(
        expr, ("x", "y", "z"),
        [{k: from_numpy_u32(v, device="cpu") for k, v in env.items()}
         for env in envs])
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_numpy_u32(g), np.asarray(w))


def test_fused_dispatch_probe_counts_wrapper_calls():
    rng = np.random.default_rng(1)
    env = {k: from_numpy_u32(v, device="cpu")
           for k, v in env_for(rng, (2, 40)).items()}
    ops.fused_dispatch_reset()
    ops.bitwise_eval(EXPRS["maj"], env)
    ops.bitwise_eval_stacked(EXPRS["maj"], ("x", "y", "z"), [env, env])
    assert ops.fused_dispatch_count() == 2
    ops.fused_dispatch_reset()
    assert ops.fused_dispatch_count() == 0


@pytest.mark.parametrize("shape", SHAPES + [(3, 128)])
def test_popcount_matches_reference(shape):
    rng = np.random.default_rng(11)
    x = words(rng, shape)
    want = np.asarray(jops.popcount(x))
    got = ops.popcount(from_numpy_u32(x, device="cpu"))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("b", [1, 4, 12, 32])
def test_bitweaving_scan_matches_reference(b):
    rng = np.random.default_rng(b)
    top = (1 << b) - 1
    n_words = {1: 7, 4: 40, 12: 7, 32: 40}[b]
    planes = words(rng, (b, n_words))
    tp = from_numpy_u32(planes, device="cpu")
    for c1, c2 in ((0, top), (0, 0), (top, top), (top // 3, 2 * top // 3)):
        want = np.asarray(jops.bitweaving_scan(planes, c1, c2))
        got = ops.bitweaving_scan(tp, c1, c2)
        assert tuple(got.shape) == (n_words,)
        np.testing.assert_array_equal(to_numpy_u32(got), want,
                                      err_msg=f"[{c1},{c2}]")
    # the plain version alone covers the rest of the edge constants
    for c1, c2 in ((0, top // 2), (top // 2, top), (top, 0)):
        vals = np.zeros(n_words * 32, np.int64)
        for i in range(b):
            vals |= np.unpackbits(planes[i].view(np.uint8),
                                  bitorder="little").astype(np.int64) \
                << (b - 1 - i)
        want = ((vals >= c1) & (vals <= c2)).astype(np.uint8)
        got = np.unpackbits(to_numpy_u32(ops.bitweaving_scan(tp, c1, c2))
                            .view(np.uint8), bitorder="little")
        np.testing.assert_array_equal(got, want, err_msg=f"[{c1},{c2}]")


# -- the register program of csrc/bitwise.cu ----------------------------------


def emulate(program: kbw.Program, arrays):
    """numpy model of fused_bitwise_kernel's instruction loop."""
    regs = [None] * program.n_regs
    for head, dst, s0, s1 in program.code.tolist():
        op, s2 = head & 0xFFFF, head >> 16
        if op == kbw.OP_LOAD:
            regs[dst] = arrays[s0]
        elif op == kbw.OP_ZERO:
            regs[dst] = np.zeros_like(arrays[0])
        elif op == kbw.OP_ONE:
            regs[dst] = ~np.zeros_like(arrays[0])
        elif op == kbw.OP_NOT:
            regs[dst] = ~regs[s0]
        elif op == kbw.OP_AND:
            regs[dst] = regs[s0] & regs[s1]
        elif op == kbw.OP_OR:
            regs[dst] = regs[s0] | regs[s1]
        elif op == kbw.OP_XOR:
            regs[dst] = regs[s0] ^ regs[s1]
        elif op == kbw.OP_MAJ:
            a, b, c = regs[s0], regs[s1], regs[s2]
            regs[dst] = (a & b) | (b & c) | (c & a)
        else:
            raise AssertionError(op)
    return regs[program.result]


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


@pytest.mark.parametrize("seed", range(6))
def test_lowered_program_matches_eval_expr(seed):
    rng = np.random.default_rng(100 + seed)
    names = ("a", "b", "c", "d")
    env = {nm: words(rng, (3, 17)) for nm in names}
    for _ in range(8):
        expr = rand_expr(rng, names)
        prog = kbw.lower(expr, names)
        got = emulate(prog, [env[nm] for nm in names])
        np.testing.assert_array_equal(got, E.eval_expr(expr, env))
        assert prog.n_regs <= kbw.MAX_REGS


def test_lowered_tpch_predicate_fits_the_kernel():
    """A two-column predicate over the widest TPC-H columns (8 + 7
    planes) - the largest program the serving path builds."""
    rng = np.random.default_rng(5)
    expr = scan_expr(8, 37, 200, prefix="extprice_b") & \
        scan_expr(7, 5, 90, prefix="suppkey_b")
    names = tuple([f"extprice_b{i}" for i in range(8)]
                  + [f"suppkey_b{i}" for i in range(7)])
    env = {nm: words(rng, (64,)) for nm in names}
    prog = kbw.lower(expr, tuple(sorted(names)))
    assert len(set(prog.loads)) == 15
    assert prog.code.shape[0] <= kbw.MAX_INSTR
    assert prog.n_regs <= kbw.MAX_REGS
    got = emulate(prog, [env[nm] for nm in sorted(names)])
    np.testing.assert_array_equal(got, E.eval_expr(expr, env))


def test_lowering_reuses_registers_and_masks_in_plain_version():
    expr = ((X & Y) | Z) ^ X
    prog = kbw.lower(expr, ("x", "y", "z"))
    assert prog.code.shape[0] == 6 and prog.n_regs == 3
    rng = np.random.default_rng(3)
    arrays = [from_numpy_u32(words(rng, (2, 5)), device="cpu")
              for _ in range(3)]
    out = kbw.fused_bitwise(expr, ("x", "y", "z"), arrays, prog, n_bits=70)
    want = E.eval_expr(expr, dict(zip("xyz", arrays)))
    np.testing.assert_array_equal(out[:, :2].numpy(), want[:, :2].numpy())
    np.testing.assert_array_equal(out[:, 2].numpy(),
                                  (want[:, 2] & 0x3F).numpy())
    assert not out[:, 3:].any()


def test_operand_limit_raises():
    names = tuple(f"v{i}" for i in range(kbw.MAX_OPERANDS + 1))
    expr = E.Expr.var(names[0])
    for nm in names[1:]:
        expr = expr & E.Expr.var(nm)
    with pytest.raises(ValueError, match="operands"):
        kbw.lower(expr, names)
    env ={nm: from_numpy_u32(np.zeros(4, np.uint32), device="cpu")
          for nm in names}
    with pytest.raises(ValueError, match="operands"):
        ops.bitwise_eval(expr, env)


# bit widths of the four columns of a predicate_plan over n planes: 38 is
# the Star Schema's Q4.2/Q4.3 (order date, brand, two cities)
WIDE_COLUMNS = {33: (12, 8, 7, 6), 38: (12, 10, 8, 8), 48: (12, 12, 12, 12)}


def wide_program(n: int, kind: str):
    """``(expression, names)`` of ``n`` operands, every one loaded: an
    AND chain, or a four-column conjunction of BitWeaving ranges."""
    if kind == "chain":
        names = tuple(f"v{i:02d}" for i in range(n))
        expr = E.Expr.var(names[0])
        for nm in names[1:]:
            expr = expr & E.Expr.var(nm)
        return expr, names
    expr, names = None, []
    for k, bits in enumerate(WIDE_COLUMNS[n]):
        term = scan_expr(bits, 5 + k, (1 << bits) - 7 - k, prefix=f"c{k}_b")
        names += [f"c{k}_b{i}" for i in range(bits)]
        expr = term if expr is None else expr & term
    return expr, tuple(sorted(names))


@pytest.mark.parametrize("kind", ["chain", "plan"])
@pytest.mark.parametrize("n", sorted(WIDE_COLUMNS))
def test_wide_program_matches_reference(n, kind):
    """Programs past the producer warp's 32 loads, up to the cap: one
    dispatch an evaluation, bit for bit with the reference, and the
    kernel's register program and packed form equal to ``eval_expr``."""
    rng = np.random.default_rng(n + (kind == "plan"))
    expr, names = wide_program(n, kind)
    env = {nm: words(rng, (2, 19)) for nm in names}
    prog = kbw.lower(expr, names)
    assert prog.n_operands == prog.n_loads == n > kbw.WARP_LOADS
    arrays = [env[nm] for nm in names]
    want = E.eval_expr(expr, env)
    np.testing.assert_array_equal(emulate(prog, arrays), want)
    np.testing.assert_array_equal(emulate_packed(prog, arrays), want)
    ops.fused_dispatch_reset()
    jops.fused_dispatch_reset()
    got = ops.bitwise_eval(expr, {k: from_numpy_u32(v, device="cpu")
                                  for k, v in env.items()})
    ref = jops.bitwise_eval(to_ref(expr), env)
    np.testing.assert_array_equal(to_numpy_u32(got), np.asarray(ref))
    np.testing.assert_array_equal(to_numpy_u32(got), want)
    assert ops.fused_dispatch_count() == jops.fused_dispatch_count() == 1


def test_instruction_limit_raises():
    expr = X
    for _ in range(kbw.MAX_INSTR // 2 + 1):
        expr = ~(expr ^ Y)
    with pytest.raises(ValueError, match="instructions"):
        kbw.lower(expr, ("x", "y"))


def test_register_limit_raises():
    """Values kept live across the whole program: every pairwise xor is
    consumed early by an and-chain and again late by an or-chain."""
    leaves = [E.Expr.var(f"v{i}") for i in range(12)]
    mids = [leaves[i] ^ leaves[j] for i in range(12) for j in range(i + 1, 12)]
    chain1, chain2 = mids[0], mids[-1]
    for m in mids[1:]:
        chain1 = chain1 & m
    for m in reversed(mids[:-1]):
        chain2 = chain2 | m
    with pytest.raises(ValueError, match="live values"):
        kbw.lower(chain1 ^ chain2, tuple(f"v{i}" for i in range(12)))


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on the card never reaches a
    plain version: the wrappers raise instead of computing elsewhere."""
    x = torch.empty((2, 8), dtype=torch.int32, device="meta")
    prog = kbw.lower(X & Y, ("x", "y"))
    with pytest.raises(ValueError, match="device"):
        kbw.fused_bitwise(X & Y, ("x", "y"), [x, x], prog)
    with pytest.raises(ValueError, match="device"):
        kpc.popcount_rows(x)
    with pytest.raises(ValueError, match="device"):
        kbv.bitweaving_scan(x, 0, 3)


# -- the kernel's packed form: forwarding and write-back marks -----------------


def emulate_packed(program: kbw.Program, arrays):
    """numpy model of the kernel's evaluation of ``packed``: load k fills
    register k, the running result stays in ``v``; a source marked
    forwarded reads ``v``, any other source reads the register file, which
    holds the loads and the results marked kept (a result not kept leaves
    the file as it was, so reading it instead of forwarding it reads a
    stale value); source 1 marked negated is read negated."""
    n_loads = program.n_loads
    file = {}
    for k, word in enumerate(program.packed[:n_loads].tolist()):
        assert word & 7 == kbw.OP_LOAD and (word >> 3) & 63 == k
        assert word >> kbw.MARK_FWD == 0
        file[k] = arrays[(word >> 9) & 63]
    v, word = None, 0
    for word in program.packed[n_loads:].tolist():
        op, dst = word & 7, (word >> 3) & 63
        regs = ((word >> 9) & 63, (word >> 15) & 63, (word >> 21) & 63)
        arity = {kbw.OP_ZERO: 0, kbw.OP_ONE: 0, kbw.OP_NOT: 1,
                 kbw.OP_MAJ: 3}.get(op, 2)
        vals = []
        for j, r in enumerate(regs[:arity]):
            if word >> (kbw.MARK_FWD + j) & 1:
                assert v is not None, "forwarded with nothing before it"
                vals.append(v)
            else:
                assert r in file, f"read of r{r}, never written"
                vals.append(file[r])
        for j in range(arity, 3):
            assert not word >> (kbw.MARK_FWD + j) & 1
        if word & kbw.MARK_NEG:
            assert op in (kbw.OP_AND, kbw.OP_OR, kbw.OP_XOR)
            assert not word >> (kbw.MARK_FWD + 1) & 1    # a load
            vals[1] = ~vals[1]
        if op == kbw.OP_ZERO:
            v = np.zeros_like(arrays[0])
        elif op == kbw.OP_ONE:
            v = ~np.zeros_like(arrays[0])
        elif op == kbw.OP_NOT:
            v = ~vals[0]
        elif op == kbw.OP_AND:
            v = vals[0] & vals[1]
        elif op == kbw.OP_OR:
            v = vals[0] | vals[1]
        elif op == kbw.OP_XOR:
            v = vals[0] ^ vals[1]
        else:
            a, b, c = vals
            v = (a & b) | (b & c) | (c & a)
        if word & kbw.MARK_KEEP:
            file[dst] = v
    if v is None:                         # the result is a loaded operand
        return file[program.result]
    assert not word & kbw.MARK_KEEP       # the root, last, stays in v
    return v


@pytest.mark.parametrize("seed", range(6))
def test_packed_program_with_marks_matches_eval_expr(seed):
    rng = np.random.default_rng(700 + seed)
    names = ("a", "b", "c", "d")
    env = {nm: words(rng, (3, 17)) for nm in names}
    for _ in range(8):
        expr = rand_expr(rng, names)
        prog = kbw.lower(expr, names)
        got = emulate_packed(prog, [env[nm] for nm in names])
        np.testing.assert_array_equal(got, E.eval_expr(expr, env))
        # the same loads first; NOTs of loads folded away, nothing added
        n = prog.n_loads
        loads = prog.code[:n].astype(np.int64)
        np.testing.assert_array_equal(prog.packed[:n],
                                      loads[:, 1] << 3 | loads[:, 2] << 9)
        assert prog.n_loads <= len(prog.packed) <= len(prog.code)
        assert prog.n_loads <= prog.shared_regs <= kbw.MAX_REGS


TPCH_BITS = {"l_shipdate": 12, "l_discount": 4, "l_quantity": 6}


def _days(y, m, d):
    """Days since 1992-01-01, as the TPC-H planes store l_shipdate."""
    import datetime
    return (datetime.date(y, m, d) - datetime.date(1992, 1, 1)).days


def tpch_query(family, *args):
    """A served TPC-H query's predicate (Q1, Q6 or Q14 with the spec's
    substitution parameters) as the serving path lowers it: scan_expr per
    column, ANDed, over every plane of its columns in sorted order."""
    if family == "q1":
        (delta,) = args
        spec = [("l_shipdate", 0, _days(1998, 12, 1) - delta)]
    elif family == "q6":
        year, d, q = args
        spec = [("l_shipdate", _days(year, 1, 1), _days(year + 1, 1, 1) - 1),
                ("l_discount", d - 1, d + 1), ("l_quantity", 0, q - 1)]
    else:
        year, month = args
        nxt = (year + month // 12, month % 12 + 1)
        spec = [("l_shipdate", _days(year, month, 1),
                 _days(*nxt, 1) - 1)]
    expr, names = None, []
    for col, lo, hi in spec:
        bits = TPCH_BITS[col]
        term = scan_expr(bits, lo, hi, prefix=f"{col}_b")
        names += [f"{col}_b{i}" for i in range(bits)]
        expr = term if expr is None else expr & term
    return expr, tuple(sorted(names))


@pytest.mark.parametrize("family,args,group", [
    ("q1", (60,), None), ("q1", (91,), None), ("q1", (120,), None),
    ("q14", (1993, 1), None), ("q14", (1995, 7), None),
    ("q14", (1997, 12), None),
    ("q6", (1996, 7, 25), "short"), ("q6", (1994, 2, 24), "short"),
    ("q6", (1993, 7, 24), "short"), ("q6", (1995, 5, 24), "long"),
    ("q6", (1995, 6, 24), "long"), ("q6", (1995, 9, 24), "long")])
def test_packed_tpch_predicates_match_eval_expr(family, args, group):
    """The served mix's Q1, Q14 and Q6 predicates, Q6 from both program
    lengths (at most 128 instructions, and more), through the packed
    form's forwarding and write-back marks."""
    expr, names = tpch_query(family, *args)
    prog = kbw.lower(expr, names)
    n_instr = prog.code.shape[0]
    if group is not None:
        assert (n_instr <= 128) == (group == "short")
    rng = np.random.default_rng(sum(args))
    env = {nm: words(rng, (2, 33)) for nm in names}
    got = emulate_packed(prog, [env[nm] for nm in names])
    np.testing.assert_array_equal(got, E.eval_expr(expr, env))
    np.testing.assert_array_equal(got, emulate(prog, [env[nm]
                                                      for nm in names]))
    # forwarding takes at least a third off the interpreter's bytes
    arity = {kbw.OP_LOAD: 0, kbw.OP_ZERO: 0, kbw.OP_ONE: 0, kbw.OP_NOT: 1,
             kbw.OP_MAJ: 3}
    srcs = sum(arity.get(int(row[0]) & 0xFFFF, 2) for row in prog.code)
    unmarked = 4 * (prog.n_loads + srcs + n_instr - prog.n_loads - 1)
    assert prog.smem_bytes_per_word <= unmarked * 2 // 3


def test_smem_bytes_per_word_hand_counted():
    """((x & y) | z) ^ x: 3 loads, the and reads 2 sources, the or and the
    xor each forward the previous result and read one more, nothing is
    kept: 4 * (3 + 2 + 1 + 1) = 28 bytes a word. (x & y) ^ ((x & y) | z):
    the and's result is read again two instructions on, so it is kept:
    4 * (3 + 2 + 1 + 1 + 1) = 32."""
    prog = kbw.lower(((X & Y) | Z) ^ X, ("x", "y", "z"))
    fwd = [(w >> kbw.MARK_FWD) & 7 for w in prog.packed.tolist()]
    keep = [bool(w & kbw.MARK_KEEP) for w in prog.packed.tolist()]
    assert fwd == [0, 0, 0, 0, 1, 1] and not any(keep)
    assert prog.smem_bytes_per_word == 28
    a = X & Y
    prog = kbw.lower(a ^ (a | Z), ("x", "y", "z"))
    fwd = [(w >> kbw.MARK_FWD) & 7 for w in prog.packed.tolist()]
    keep = [bool(w & kbw.MARK_KEEP) for w in prog.packed.tolist()]
    assert fwd == [0, 0, 0, 0, 1, 2]        # or: s0 is the and; xor: s1
    assert keep == [False, False, False, True, False, False]
    assert prog.smem_bytes_per_word == 32
    assert kbw.lower(X, ("x",)).smem_bytes_per_word == 8   # load, result
    # (x & ~y) | (z & ~y): ~y folded into both ands (read negated); the
    # first and is read two instructions on, so kept:
    # 4 * (3 + 2 + 1 + 2 + 1) = 36 (40 with the not: 4 * (3 + 1 + 1 + 1
    # + 1 + 2 + 1))
    prog = kbw.lower((X & ~Y) | (Z & ~Y), ("x", "y", "z"))
    assert prog.code.shape[0] == 7 and len(prog.packed) == 6
    neg = [bool(w & kbw.MARK_NEG) for w in prog.packed.tolist()]
    keep = [bool(w & kbw.MARK_KEEP) for w in prog.packed.tolist()]
    assert neg == [False] * 3 + [True, True, False]
    assert keep == [False] * 3 + [True, False, False]
    assert prog.smem_bytes_per_word == 36
