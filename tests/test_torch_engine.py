"""The port's BulkBitwiseEngine against the reference's, bit for bit.

"torch" is held against the reference's "jnp" and "cuda" (its kernels'
plain versions on the CPU) against "pallas" (interpret mode): the same
numpy bits go into both, and the packed words, popcounts and
``last_stats.bytes_touched`` must be equal.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import BitVector as JBitVector
from repro.core import BulkBitwiseEngine as JEngine
from repro.core import expr as JE
from repro_torch.convert import bitvector_from_numpy, to_numpy_u32
from repro_torch.core import BitVector, BulkBitwiseEngine
from repro_torch.core import expr as E

PAIRS = [("jnp", "torch"), ("pallas", "cuda")]


def to_ref(e):
    if e.op == "var":
        return JE.Expr.var(e.name)
    if e.op == "lit":
        return JE.Expr("lit", (), e.name)
    return JE.Expr(e.op, tuple(to_ref(a) for a in e.args))


def vectors(rng, n_bits, rows=()):
    bits = rng.integers(0, 2, (3,) + rows + (n_bits,)).astype(bool)
    return ([JBitVector.from_bits(b) for b in bits],
            [BitVector.from_bits(b, device="cpu") for b in bits])


def same_bv(port: BitVector, ref: JBitVector):
    assert port.n_bits == ref.n_bits
    np.testing.assert_array_equal(to_numpy_u32(port.data),
                                  np.asarray(ref.data))


@pytest.mark.parametrize("n_bits", [1, 37, 300, 4096])
def test_bitvector_packing_matches_reference(n_bits):
    rng = np.random.default_rng(n_bits)
    bits = rng.integers(0, 2, (2, n_bits)).astype(bool)
    ref = JBitVector.from_bits(bits)
    port = BitVector.from_bits(bits, device="cpu")
    same_bv(port, ref)
    carried = bitvector_from_numpy(np.asarray(ref.data), ref.n_bits,
                                   device="cpu")
    assert carried.data.dtype == port.data.dtype
    same_bv(carried, ref)
    same_bv(~port, ~ref)
    same_bv(port.andnot(port), ref.andnot(ref))
    same_bv(BitVector.ones(n_bits, (3,), device="cpu"),
            JBitVector.ones(n_bits, (3,)))
    same_bv(BitVector.zeros(n_bits, device="cpu"), JBitVector.zeros(n_bits))
    np.testing.assert_array_equal(port.bits().numpy(), bits)
    np.testing.assert_array_equal(port.popcount().numpy(),
                                  np.asarray(ref.popcount()))


@pytest.mark.parametrize("ref_backend,backend", PAIRS)
def test_eval_and_binops_match_reference(ref_backend, backend):
    rng = np.random.default_rng(3)
    jeng = JEngine(ref_backend)
    eng = BulkBitwiseEngine(backend, device="cpu")
    X, Y, Z = E.Expr.var("x"), E.Expr.var("y"), E.Expr.var("z")
    exprs = [E.maj(X, ~Y, Z), ~(X ^ Y) | Z,
             E.Expr("or", (E.Expr("and", (X, E.ONE)), E.Expr("xor",
                                                           (Z, E.ZERO))))]
    for n_bits, rows in ((37, ()), (300, (2,))):
        jv, pv = vectors(rng, n_bits, rows)
        jenv, penv = dict(zip("xyz", jv)), dict(zip("xyz", pv))
        for expr in exprs:
            same_bv(eng.eval(expr, penv), jeng.eval(to_ref(expr), jenv))
            assert eng.last_stats.bytes_touched == \
                jeng.last_stats.bytes_touched
        for op in ("and_", "or_", "xor", "nand", "nor", "xnor",
                   "masked_set", "masked_clear"):
            same_bv(getattr(eng, op)(pv[0], pv[1]),
                    getattr(jeng, op)(jv[0], jv[1]))
            assert eng.last_stats.bytes_touched == \
                jeng.last_stats.bytes_touched
        same_bv(eng.not_(pv[2]), jeng.not_(jv[2]))
        same_bv(eng.maj(*pv), jeng.maj(*jv))
        got, want = eng.popcount(pv[0]), jeng.popcount(jv[0])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert eng.last_stats.bytes_touched == jeng.last_stats.bytes_touched
    assert eng.metrics.counter("engine_evals").total() == \
        jeng.metrics.counter("engine_evals").total()


@pytest.mark.parametrize("n_bits", [37, 100, 333])
@pytest.mark.parametrize("ref_backend,backend", PAIRS)
def test_shift_matches_reference(ref_backend, backend, n_bits):
    rng = np.random.default_rng(n_bits)
    jv, pv = vectors(rng, n_bits, (2,))
    jeng = JEngine(ref_backend)
    eng = BulkBitwiseEngine(backend, device="cpu")
    for amount in (0, 1, 5, 31, 32, 33, 64, 100, -1, -5, -31, -32, -33,
                   -64, -100, n_bits, -n_bits):
        got, want = eng.shift(pv[0], amount), jeng.shift(jv[0], amount)
        same_bv(got, want)
        assert eng.last_stats.bytes_touched == jeng.last_stats.bytes_touched
        # bit i of the result is bit i - amount of the input
        src = pv[0].bits().numpy()
        exp = np.zeros_like(src)
        k = abs(amount)
        if 0 <= amount < n_bits:
            exp[:, k:] = src[:, :n_bits - k]
        elif -n_bits < amount < 0:
            exp[:, :n_bits - k] = src[:, k:]
        np.testing.assert_array_equal(got.bits().numpy(), exp)


def test_unported_backend_raises():
    """The engine runs "ambit_sim" (the DRAM model), and so does the PIM
    runtime on it now (the name is kept from when it raised); "jnp" is
    no backend of the port."""
    from repro.pim import AmbitRuntime as JRuntime
    from repro_torch.pim import AmbitRuntime
    jv, pv = vectors(np.random.default_rng(0), 70)
    eng, jeng = BulkBitwiseEngine("ambit_sim", device="cpu"), \
        JEngine("ambit_sim")
    same_bv(eng.and_(pv[0], pv[1]), jeng.and_(jv[0], jv[1]))
    assert eng.last_stats.aap_count > 0 and eng.last_stats.ns > 0
    assert dataclasses.astuple(eng.last_stats) == \
        dataclasses.astuple(jeng.last_stats)
    rt = AmbitRuntime(backend="ambit_sim", device="cpu", banks=2,
                      subarrays=2, words=2)
    jrt = JRuntime(backend="ambit_sim", banks=2, subarrays=2, words=2)
    same_bv(rt.get(rt.and_(rt.put(pv[0]), rt.put(pv[1]))),
            jrt.get(jrt.and_(jrt.put(jv[0]), jrt.put(jv[1]))))
    assert dataclasses.astuple(rt.session_stats) == \
        dataclasses.astuple(jrt.session_stats)
    with pytest.raises(ValueError):
        BulkBitwiseEngine("jnp", device="cpu")
    with pytest.raises(ValueError):
        AmbitRuntime(backend="jnp", device="cpu")
