"""The port's kernel wrappers against the reference's, bit for bit.

The same numpy inputs (from ``default_rng``) go through the JAX package's
``kernels.ops`` (Pallas in interpret mode on the CPU) and the port's
``repro_torch.kernels.ops`` (the kernels' plain versions on the CPU).
Exact equality throughout: integer bit arithmetic has no tolerance.

The register program that ``csrc/bitwise.cu`` interprets cannot run here,
so a numpy emulator of the kernel's instruction loop runs it instead and
is held against ``eval_expr``. The kernels themselves are checked on the
card by ``tests/test_torch_cuda.py``.
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
