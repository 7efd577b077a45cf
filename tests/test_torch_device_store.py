"""The port's DeviceStore / DevicePlanner / AsyncScheduler / AmbitRuntime
against the reference's, bit for bit and ledger for ledger.

One scenario - put/get/free/pin, dirty results, LRU spill under a
capacity budget, fault-ins, popcounts, a submit/drain batch with ticket
dependencies and an ``out=`` rebind - runs on the reference's
``AmbitRuntime(backend="jnp"/"pallas")`` and on the port's
``AmbitRuntime(backend="torch"/"cuda", device="cpu")`` from the same numpy
bits. Results, handle states, byte counters and the whole
``metrics_snapshot()`` must be equal.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.apps import bitweaving_db as jbw
from repro.core import BitVector as JBitVector
from repro.core import expr as JE
from repro.kernels import ops as jops
from repro.pim import AmbitRuntime as JRuntime
from repro_torch.apps import bitweaving_db as bw
from repro_torch.core import AmbitError, BitVector
from repro_torch.core import expr as E
from repro_torch.kernels import ops as kops
from repro_torch.pim import AmbitRuntime, DeviceStore
from test_torch_kernels import WIDE_COLUMNS

PAIRS = [("jnp", "torch"), ("pallas", "cuda")]


class CpuBitVector:
    """The port's ``BitVector`` packed on the CPU, where this file's
    runtimes keep their data."""

    @staticmethod
    def from_bits(bits):
        return BitVector.from_bits(bits, device="cpu")


def runtimes(ref_backend, backend, **kw):
    return (JRuntime(backend=ref_backend, **kw),
            AmbitRuntime(backend=backend, device="cpu", **kw))


def bits_of(rt, h):
    return np.asarray(rt.get(h).bits())


def scenario(rt, BV, Ex, bits):
    """The same session on either package; returns what it observed."""
    X, Y, Z = Ex.Expr.var("x"), Ex.Expr.var("y"), Ex.Expr.var("z")
    seen = []
    a, b, c = (rt.put(BV.from_bits(v), name=f"v{i}")
               for i, v in enumerate(bits[:3]))
    rt.pin(b)
    out = rt.eval(Ex.maj(X, ~Y, Z), {"x": a, "y": b, "z": c})
    seen.append(("dirty", out.dirty, rt.last_stats.bytes_touched))
    seen.append(("pop", rt.popcount(out), rt.last_stats.bytes_touched))
    rt.get(a)
    d = rt.put(BV.from_bits(bits[3]))           # spills the LRU victim
    seen.append(("spilled", [h.spilled for h in (a, b, c, out, d)]))
    seen.append(("evicted", rt.store.evicted_clean, rt.store.evicted_dirty))
    x2 = rt.eval(X ^ Y, {"x": c, "y": d})        # may fault c back in
    seen.append(("x2", bits_of(rt, x2).tolist(), rt.last_stats.bytes_touched))
    seen.append(("out", bits_of(rt, out).tolist()))
    rt.free(x2)
    t1 = rt.submit(X & Y, {"x": a, "y": d})
    t2 = rt.submit(X & Y, {"x": c, "y": d})
    t3 = rt.submit(X | Y, {"x": t1, "y": out}, out=out)
    rt.drain()
    seen.append(("epochs", [t.epoch for t in (t1, t2, t3)],
                 [t.deferred for t in (t1, t2, t3)],
                 len(rt.last_drain.epochs), rt.last_drain.stats.bytes_touched))
    seen.append(("t3 is out", t3.result is out))
    for t in (t1, t2, t3):
        seen.append(("res", bits_of(rt, t.result).tolist(),
                     t.stats.bytes_touched))
    rt.unpin(b)
    rt.free(a)
    with pytest.raises(Exception, match="freed"):
        rt.get(a)
    seen.append(("bytes", rt.store.bytes_to_device,
                 rt.store.bytes_from_device, rt.store.host_reads,
                 rt.store.host_writes, rt.store.resident_bytes,
                 rt.session_stats.bytes_touched))
    seen.append(("metrics", rt.metrics_snapshot()))
    return seen


@pytest.mark.parametrize("capacity_rows", [None, 4])
@pytest.mark.parametrize("ref_backend,backend", PAIRS)
def test_session_matches_reference(ref_backend, backend, capacity_rows):
    rng = np.random.default_rng(23)
    bits = rng.integers(0, 2, (4, 1000)).astype(bool)
    nb = JBitVector.from_bits(bits[0]).nbytes
    cap = None if capacity_rows is None else capacity_rows * nb
    jrt, rt = runtimes(ref_backend, backend, capacity_bytes=cap)
    want = scenario(jrt, JBitVector, JE, bits)
    got = scenario(rt, CpuBitVector, E, bits)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w, g[0]


@pytest.mark.parametrize("ref_backend,backend", PAIRS)
def test_held_operand_spills_last_and_faults_back(ref_backend, backend):
    """Pinned handles are never victims; a queued operand spills only as a
    last resort and faults back in at drain, charged to its ticket."""
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, (3, 1024)).astype(bool)
    nb = BitVector.from_bits(bits[0], device="cpu").nbytes
    results = []
    for rt, BV, Ex in zip(runtimes(ref_backend, backend,
                                   capacity_bytes=2 * nb),
                          (JBitVector, CpuBitVector), (JE, E)):
        a = rt.put(BV.from_bits(bits[0]), pin=True)
        b = rt.put(BV.from_bits(bits[1]))
        t = rt.submit(~Ex.Expr.var("x"), {"x": b})
        with pytest.raises(Exception, match="queued"):
            rt.free(b)
        rt.put(BV.from_bits(bits[2]))
        assert b.spilled and not a.spilled
        rt.drain()
        results.append((t.stats.bytes_touched, bits_of(rt, t.result).tolist(),
                        rt.metrics_snapshot()))
    assert results[0] == results[1]
    assert results[1][1] == (~bits[1]).tolist()
    rt = AmbitRuntime(backend=backend, device="cpu", capacity_bytes=nb)
    rt.put(BitVector.from_bits(bits[0], device="cpu"), pin=True)
    with pytest.raises(AmbitError, match="pinned or in use"):
        rt.put(BitVector.from_bits(bits[1], device="cpu"))


def test_one_dispatch_per_epoch_like_reference():
    rng = np.random.default_rng(9)
    bits = rng.integers(0, 2, (4, 2, 300)).astype(bool)
    counts = []
    for rt, BV, Ex, probe in zip(runtimes("pallas", "cuda"),
                                 (JBitVector, CpuBitVector), (JE, E),
                                 (jops, kops)):
        X, Y = Ex.Expr.var("x"), Ex.Expr.var("y")
        envs = [{"x": rt.put(BV.from_bits(bits[q, 0])),
                 "y": rt.put(BV.from_bits(bits[q, 1]))} for q in range(4)]
        probe.fused_dispatch_reset()
        tickets = [rt.submit(X & Y, env) for env in envs]
        odd = rt.submit(X | Y, envs[0])
        rt.drain()
        counts.append((probe.fused_dispatch_count(),
                       rt.planner.kernel_launches,
                       len(rt.last_drain.epochs),
                       [t.epoch for t in tickets], odd.epoch))
        for t, b in zip(tickets, bits):
            assert np.array_equal(bits_of(rt, t.result), b[0] & b[1])
    assert counts[0] == counts[1] == (2, 2, 2, [0, 0, 0, 0], 1)


def wide_session(rt, BV, Ex, table_of, n, kind, bits):
    """On either package: a program of ``n`` operands evaluated once
    (``DevicePlanner.execute``), then three tickets sharing it drained as
    one epoch (``execute_epoch``); returns what it observed."""
    if kind == "chain":
        names = [f"v{i:02d}" for i in range(n)]
        handles = [rt.put(BV.from_bits(b)) for b in bits[:n]]
        expr = Ex.Expr.var(names[0])
        for nm in names[1:]:
            expr = expr & Ex.Expr.var(nm)
        envs = [dict(zip(names, handles[k:] + handles[:k]))
                for k in range(3)]
    else:
        cols = tuple((f"c{k}", b) for k, b in enumerate(WIDE_COLUMNS[n]))
        table = table_of(n_rows=1000, seed=n, columns=cols)
        specs = [(c, 3 + k, (1 << b) - 5 - k)
                 for k, (c, b) in enumerate(cols)]
        expr, env = (bw if BV is CpuBitVector else jbw).predicate_plan(
            table, specs, rt)
        envs = [env] * 3                    # a query repeated in a drain
    probe = kops if BV is CpuBitVector else jops
    probe.fused_dispatch_reset()
    seen = []
    one = rt.eval(expr, envs[0])
    seen.append(("eval", bits_of(rt, one).tolist(), rt.popcount(one),
                 probe.fused_dispatch_count()))
    tickets = [rt.submit(expr, env) for env in envs]
    rt.drain()
    seen.append(("drain", len(rt.last_drain.epochs),
                 [t.epoch for t in tickets], probe.fused_dispatch_count(),
                 rt.planner.kernel_launches))
    seen += [("res", bits_of(rt, t.result).tolist()) for t in tickets]
    seen.append(("metrics", rt.metrics_snapshot()))
    return seen


@pytest.mark.parametrize("kind", ["chain", "plan"])
@pytest.mark.parametrize("n", sorted(WIDE_COLUMNS))
def test_wide_programs_execute_and_stack_like_reference(n, kind):
    """Programs of 33-48 operands through the planner's single and
    stacked launches: bits, counts and every ledger token equal to the
    reference's, one fused dispatch an evaluation."""
    rng = np.random.default_rng(40 + n)
    bits = rng.integers(0, 2, (n, 1000)).astype(bool)
    jrt, rt = runtimes("pallas", "cuda")
    want = wide_session(jrt, JBitVector, JE, jbw.TpchTable.synthesize, n,
                        kind, bits)
    got = wide_session(rt, CpuBitVector, E, functools.partial(
        bw.TpchTable.synthesize, device="cpu"), n, kind, bits)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w, g[0]
    assert got[0][3] == 1 and got[1][1:4] == (1, [0, 0, 0], 2)


def test_out_rebind_writes_in_place_only_into_private_buffers():
    rng = np.random.default_rng(21)
    bits = rng.integers(0, 2, (2, 300)).astype(bool)
    X, Y = E.Expr.var("x"), E.Expr.var("y")
    rt = AmbitRuntime(backend="cuda", device="cpu")
    bv_a = BitVector.from_bits(bits[0], device="cpu")
    caller_copy = bv_a.data.clone()
    a = rt.put(bv_a)
    w = rt.put(BitVector.from_bits(bits[1], device="cpu"))
    assert not a._private
    assert rt.eval(X & Y, {"x": a, "y": w}, out=a) is a
    assert rt.planner.last_report.donated == 0
    assert torch.equal(bv_a.data, caller_copy)      # caller's buffer intact
    assert a._private and a.dirty
    ptr = a._dev.data_ptr()
    rt.eval(X ^ Y, {"x": a, "y": w}, out=a)
    assert rt.planner.last_report.donated == 1
    assert a._dev.data_ptr() == ptr                  # written in place
    assert rt.last_stats.bytes_touched == 0
    np.testing.assert_array_equal(bits_of(rt, a),
                                  (bits[0] & bits[1]) ^ bits[1])
    # a read-back host copy never aliases a buffer written in place later
    host = rt.get(a).data
    snapshot = host.clone()
    rt.eval(X | Y, {"x": a, "y": w}, out=a)
    assert a._dev.data_ptr() == ptr
    assert torch.equal(host, snapshot)
    np.testing.assert_array_equal(bits_of(rt, a), bits[1])


def test_spill_leaves_host_copies_that_share_nothing():
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, (2, 1024)).astype(bool)
    rt = AmbitRuntime(backend="cuda", device="cpu")
    a = rt.put(BitVector.from_bits(bits[0], device="cpu"))
    b = rt.put(BitVector.from_bits(bits[1], device="cpu"))
    out = rt.and_(a, b)
    dev_ptr = out._dev.data_ptr()
    rt.store.spill(out)                              # dirty: read back
    assert out._dev is None and out.spilled
    assert out._host.data.device.type == "cpu"
    assert out._host.data.data_ptr() != dev_ptr
    np.testing.assert_array_equal(bits_of(rt, out), bits[0] & bits[1])
    assert rt.popcount(out) == int((bits[0] & bits[1]).sum())


def test_store_rejects_sim_backend_and_foreign_handles():
    """``DeviceStore`` keeps the reference's refusal of the DRAM model
    (that path is ``PimStore``), which ``AmbitRuntime(backend=
    "ambit_sim")`` now builds."""
    with pytest.raises(ValueError, match="PimStore"):
        DeviceStore(backend="ambit_sim", device="cpu")
    from repro_torch.pim import PimStore
    sim = AmbitRuntime(backend="ambit_sim", device="cpu", banks=2,
                       subarrays=2, words=2)
    assert isinstance(sim.store, PimStore)
    rt1 = AmbitRuntime(backend="torch", device="cpu")
    rt2 = AmbitRuntime(backend="torch", device="cpu")
    a = rt1.put(BitVector.from_bits(np.ones(64, bool), device="cpu"))
    with pytest.raises(AmbitError, match="another store"):
        rt2.get(a)
    with pytest.raises(AmbitError, match="another store"):
        sim.get(a)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_optimizer_drain_is_not_ported(backend):
    """The drain-time optimizer runs on the accelerator backends: an
    optimized drain's results equal the unoptimized drain's, and its
    OptReport equals the reference's on the twin backend (the name is
    kept from when ``drain(optimize=True)`` raised here)."""
    ref_backend = {"torch": "jnp", "cuda": "pallas"}[backend]
    rng = np.random.default_rng(8)
    bits = rng.integers(0, 2, (3, 300)).astype(bool)
    X, Y, Z = E.Expr.var("x"), E.Expr.var("y"), E.Expr.var("z")
    JX, JY, JZ = JE.Expr.var("x"), JE.Expr.var("y"), JE.Expr.var("z")
    out = {}
    for optimize in (False, True):
        rt = AmbitRuntime(backend=backend, device="cpu")
        jrt = JRuntime(backend=ref_backend)
        vs = [rt.put(BitVector.from_bits(b, device="cpu")) for b in bits]
        jvs = [jrt.put(JBitVector.from_bits(b)) for b in bits]
        env = dict(zip("xyz", vs))
        jenv = dict(zip("xyz", jvs))
        ts = [rt.submit(e, dict(env)) for e in
              ((X & Y) | Z, (Y & X) ^ Z, ~(X & Y))]
        jts = [jrt.submit(e, dict(jenv)) for e in
               ((JX & JY) | JZ, (JY & JX) ^ JZ, ~(JX & JY))]
        assert rt.drain(optimize=optimize) == ts
        jrt.drain(optimize=optimize)
        out[optimize] = [bits_of(rt, t.result) for t in ts]
        for t, jt in zip(ts, jts):
            np.testing.assert_array_equal(bits_of(rt, t.result),
                                          np.asarray(jrt.get(
                                              jt.result).bits()))
        if optimize:
            rep = rt.last_drain.opt
            assert rep.cse_materialized == 1 and rep.cse_hits == 2
            assert dataclasses.astuple(rep) == \
                dataclasses.astuple(jrt.last_drain.opt)
    for a, b in zip(out[False], out[True]):
        np.testing.assert_array_equal(a, b)
