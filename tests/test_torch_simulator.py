"""The port's DRAM model and ``ambit_sim`` engine against the reference's.

The same numpy-seeded inputs go through ``repro`` and ``repro_torch`` (on
the CPU) and every result must be equal, with no tolerance unless stated:

* compiled AAP programs (macro lists, output row, scratch rows, stats);
* the simulator's whole row state after the reference's differential
  programs (``tests/test_batched_sim.py``), boot content included, and
  ``AmbitError`` raised on the same streams with the same message;
* the device's bbop ISA, PSM staging, aliasing fallback and allocator;
* every engine op of ``tests/test_backend_matrix.py`` on ``ambit_sim``:
  bits and every ``last_stats`` field, batched and with
  ``batch_rows=False``, and the compile cache's hits and misses;
* ``tra_failure_rate`` at Table 3's variations (exact) and
  ``tra_worst_case_margin`` (rtol 1e-12);
* ``timing_checker.main``'s output and the oracle's timed streams;
* the fixed DRAM ledger that ``chip_smoke.py`` holds its card run to.

Row state is compared through ``numpy .view(np.uint64)``.
"""

import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import test_batched_sim as jbs      # the reference's differential programs
from repro.core import AmbitDevice as JDevice
from repro.core import AmbitError as JAmbitError
from repro.core import AmbitSubarray as JSubarray
from repro.core import BitVector as JBitVector
from repro.core import BulkBitwiseEngine as JEngine
from repro.core import TABLE3_PAPER
from repro.core import analog as janalog
from repro.core import commands as jcmd
from repro.core import compile_cache_clear as j_cache_clear
from repro.core import compile_cache_info as j_cache_info
from repro.core import compile_expr as j_compile
from repro.core import expr as JE
from repro.core import timing_checker as jtc
from repro.obs import Tracer as JTracer
from repro_torch.convert import to_numpy_u32
from repro_torch.core import (AmbitDevice, AmbitError, AmbitSubarray,
                              BitVector, BulkBitwiseEngine, DRAMGeometry,
                              compile_cache_clear, compile_cache_info,
                              compile_expr)
from repro_torch.core import analog
from repro_torch.core import commands as cmd
from repro_torch.core import expr as E
from repro_torch.core import timing_checker as tc
from repro_torch.core.simulator import as_words
from repro_torch.obs import Tracer

GEOM = DRAMGeometry(rows_per_subarray=32)   # 14 data rows: full-state diff
WORDS, N_ROWS = jbs.WORDS, jbs.N_ROWS
CPU = "cpu"


# -- carrying values between the packages -------------------------------------


def port_addr(a):
    return cmd.RowAddr(a.group, a.index)


def port_macro(m):
    if isinstance(m, jcmd.AAP):
        return cmd.AAP(port_addr(m.src), port_addr(m.dst))
    return cmd.AP(port_addr(m.addr))


def port_expr(e):
    if e.op == "var":
        return E.Expr.var(e.name)
    if e.op == "lit":
        return E.Expr("lit", (), e.name)
    return E.Expr(e.op, tuple(port_expr(a) for a in e.args))


def u64(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint64)


def stats_tuple(st):
    return dataclasses.astuple(st)


def same_state(sub: AmbitSubarray, jsub: JSubarray):
    """Every cell of both subarrays (D rows materialise lazily from the
    same per-row seeds), the sense amps and the ledger."""
    for d in range(sub.geom.data_rows):
        np.testing.assert_array_equal(u64(sub._d_row(d)), jsub._d_row(d))
    for wl in ("T0", "T1", "T2", "T3"):
        np.testing.assert_array_equal(u64(sub.t_rows[wl]), jsub.t_rows[wl])
    for name in ("DCC0", "DCC1"):
        np.testing.assert_array_equal(u64(sub.dcc[name]), jsub.dcc[name])
    for c, jc in zip(sub.c_rows, jsub.c_rows):
        np.testing.assert_array_equal(u64(c), jc)
    assert sub.amp.active == jsub.amp.active
    assert sub.amp.open_wordlines == jsub.amp.open_wordlines
    if jsub.amp.rowbuf is not None:
        np.testing.assert_array_equal(u64(sub.amp.rowbuf), jsub.amp.rowbuf)
    assert stats_tuple(sub.stats) == stats_tuple(jsub.stats)


def run_both(prog, sub, jsub):
    """Run ``prog`` on both; the same AmbitError (or none) on each."""
    errs = []
    for s, p in ((jsub, prog), (sub, [port_macro(m) for m in prog])):
        try:
            s.run(p)
            errs.append(None)
        except (AmbitError, JAmbitError) as exc:
            errs.append(str(exc))
    assert errs[0] == errs[1], prog
    return errs[0]


def inject(sub, d_vals, t_vals, dcc_vals):
    """Give either package's subarray the same cell state."""
    def cell(val):
        if isinstance(sub, JSubarray):
            return val.copy()
        return as_words(val, sub.device).clone()
    for d, val in enumerate(d_vals):
        sub.write_row(d, val)
    for wl, val in t_vals.items():
        sub.t_rows[wl] = cell(val)
    for name, val in dcc_vals.items():
        sub.dcc[name] = cell(val)


# -- compiler -----------------------------------------------------------------


def _compile_cases():
    X, Y, Z = (JE.Expr.var(n) for n in "xyz")
    cases = [X & Y, X | Y, X ^ Y, ~X, ~(X & Y), ~(X | Y), ~(X ^ Y),
             (X & Y) & Z, JE.maj(X, Y, Z), ~JE.maj(X, Y, Z),
             (X & Y) | ((X & Y) ^ Z), ~((X | Y) & (Y ^ Z)),
             ((X & Y) | (~Z & X)) ^ (Y | ~X), (X & JE.ONE) | (Y & JE.ZERO),
             ~~X & Y]
    cases += [jtc._rand_expr(np.random.default_rng(3000 + i))
              for i in range(12)]
    return cases


COMPILE_CASES = _compile_cases()


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("i", range(len(COMPILE_CASES)))
def test_compiled_programs_match_reference(i, optimize):
    jexpr = COMPILE_CASES[i]
    names = ["a", "b", "c", "d", "x", "y", "z"]
    var_rows = {n: k for k, n in enumerate(names)}
    for data_rows in (1006, GEOM.data_rows):
        want = j_compile(jexpr, var_rows, len(names), data_rows, optimize)
        got = compile_expr(port_expr(jexpr), var_rows, len(names), data_rows,
                           optimize)
        assert [repr(m) for m in got.program] == \
            [repr(m) for m in want.program]
        assert repr(got.out_row) == repr(want.out_row)
        assert got.scratch_rows == want.scratch_rows
        assert stats_tuple(got.stats) == stats_tuple(want.stats)


# -- the subarray -------------------------------------------------------------


@pytest.mark.parametrize("state", ["boot", "injected"])
@pytest.mark.parametrize("seed", range(60))
def test_random_programs_match_reference(seed, state):
    """The reference's random AAP/AP programs on a batch-5 subarray: the
    same error or the same full final state. ``boot`` keeps the random
    power-up content of both packages; ``injected`` gives the cells the
    reference harness's state, so 2-cell activations often agree."""
    prog = jbs._rand_program(seed)
    sub = AmbitSubarray(GEOM, words=WORDS, n_rows=N_ROWS, seed=seed,
                        device=CPU)
    jsub = JSubarray(GEOM, words=WORDS, n_rows=N_ROWS, seed=seed)
    if state == "injected":
        vals = jbs._make_state(np.random.default_rng(seed))
        inject(sub, *vals)
        inject(jsub, *vals)
    run_both(prog, sub, jsub)
    same_state(sub, jsub)


@pytest.mark.parametrize("n_rows", [1, N_ROWS])
@pytest.mark.parametrize("op", sorted(jcmd.OP_TEMPLATES))
def test_op_templates_match_reference(op, n_rows):
    rng = np.random.default_rng(11)
    n_srcs = jcmd.OP_ARITY[op] - 1
    sub = AmbitSubarray(GEOM, words=WORDS, n_rows=n_rows, seed=7,
                        device=CPU)
    jsub = JSubarray(GEOM, words=WORDS, n_rows=n_rows, seed=7)
    for i in range(n_srcs):
        val = rng.integers(0, 2**64, (n_rows, WORDS), dtype=np.uint64)
        sub.write_row(i, val)
        jsub.write_row(i, val)
    dst = GEOM.data_rows - 2
    sub.bbop(op, dst, *range(n_srcs))
    jsub.bbop(op, dst, *range(n_srcs))
    same_state(sub, jsub)
    got = sub.read_row(dst)
    assert tuple(got.shape) == jsub.read_row(dst).shape


def test_raw_command_streams_match_reference():
    """ACTIVATE/PRECHARGE executed one by one (test_simulator.py's
    single-activate restore, DCC capture and the B10 2-cell activation)."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**64, WORDS, dtype=np.uint64)
    sub, jsub = AmbitSubarray(words=WORDS, device=CPU), JSubarray(words=WORDS)
    for s in (sub, jsub):
        s.write_row(0, a)
    streams = [[jcmd.Activate(jcmd.D(0)), jcmd.Precharge()],
               [jcmd.Activate(jcmd.B(5)), jcmd.Precharge()],
               [jcmd.Activate(jcmd.B(12)), jcmd.Precharge()],
               [jcmd.Activate(jcmd.B(10))]]
    for stream in streams:
        port = [cmd.Activate(port_addr(c.addr)) if isinstance(
            c, jcmd.Activate) else cmd.Precharge() for c in stream]
        errs = []
        for s, p in ((jsub, stream), (sub, port)):
            try:
                s.execute(p)
                errs.append(None)
            except (AmbitError, JAmbitError) as exc:
                errs.append(str(exc))
        assert errs[0] == errs[1]
        same_state(sub, jsub)
    np.testing.assert_array_equal(u64(sub.read_row(0)), a)


def test_undefined_cases_raise_like_reference():
    """The two named undefined behaviours, triggered by one word of one
    batch row (test_batched_sim.py's poisoned rows)."""
    zeros = np.zeros((N_ROWS, WORDS), np.uint64)
    full = np.full((N_ROWS, WORDS), np.uint64(2**64 - 1), np.uint64)
    d_vals = [zeros.copy() for _ in range(GEOM.data_rows)]
    d_vals[0][2, 1] = np.uint64(1)
    t_vals = {wl: full.copy() for wl in ("T0", "T1", "T2", "T3")}
    t_vals["T3"][4, 0] = np.uint64(0)
    dcc_vals = {n: full.copy() for n in ("DCC0", "DCC1")}
    for prog, msg in (([jcmd.AAP(jcmd.D(0), jcmd.C(0))], "read-only"),
                      ([jcmd.AP(jcmd.B(10))], "disagreeing")):
        sub = AmbitSubarray(GEOM, words=WORDS, n_rows=N_ROWS, device=CPU)
        jsub = JSubarray(GEOM, words=WORDS, n_rows=N_ROWS)
        inject(sub, d_vals, t_vals, dcc_vals)
        inject(jsub, d_vals, t_vals, dcc_vals)
        assert msg in run_both(prog, sub, jsub)
        same_state(sub, jsub)


def test_row_access_edges_match_reference():
    sub = AmbitSubarray(GEOM, words=WORDS, n_rows=3, device=CPU)
    jsub = JSubarray(GEOM, words=WORDS, n_rows=3)
    row = np.arange(WORDS, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    for s in (sub, jsub):
        s.write_row(1, row)                 # (words,) broadcasts
    np.testing.assert_array_equal(u64(sub.read_row(1)), jsub.read_row(1))
    for bad in (np.zeros(WORDS + 1, np.uint64),
                np.zeros((2, WORDS), np.uint64)):
        with pytest.raises(ValueError, match="row data must be"):
            sub.write_row(0, bad)
        with pytest.raises(ValueError, match="row data must be"):
            jsub.write_row(0, bad)
    for s in (sub, jsub):
        with pytest.raises(IndexError, match="outside the D-group"):
            s.read_row(GEOM.data_rows)
    with pytest.raises(ValueError):
        AmbitSubarray(GEOM, words=WORDS, n_rows=0, device=CPU)


# -- the device: bbop ISA, staging, allocator ---------------------------------


def _device_pair(**kw):
    return (AmbitDevice(GEOM, banks=2, subarrays=2, words=WORDS, device=CPU,
                        **kw),
            JDevice(GEOM, banks=2, subarrays=2, words=WORDS, **kw))


def _alloc_write(dev, rng, n):
    slots = dev.alloc_rows(n)
    data = rng.integers(0, 2**64, (n, dev.words), dtype=np.uint64)
    dev.write(slots, data)
    return slots


def _same_device(dev, jdev, slots):
    np.testing.assert_array_equal(u64(dev.read(slots)), jdev.read(slots))
    assert stats_tuple(dev.total_stats()) == stats_tuple(jdev.total_stats())
    for b, (bank, jbank) in enumerate(zip(dev.banks, jdev.banks)):
        assert stats_tuple(bank.stats) == stats_tuple(jbank.stats), b
        for sub, jsub in zip(bank.subarrays, jbank.subarrays):
            same_state(sub, jsub)


@pytest.mark.parametrize("batch_groups", [True, False])
@pytest.mark.parametrize("n", [1, 4, 13])
@pytest.mark.parametrize("op", ["and", "xor", "nand", "maj3", "not"])
def test_device_bbop_matches_reference(op, n, batch_groups):
    dev, jdev = _device_pair(batch_groups=batch_groups)
    n_srcs = jcmd.OP_ARITY[op] - 1
    srcs, dsts = [], []
    for d in (dev, jdev):
        rng = np.random.default_rng(42)
        srcs.append([_alloc_write(d, rng, n) for _ in range(n_srcs)])
        dsts.append(d.alloc_rows(n))
    assert srcs[0] == srcs[1] and dsts[0] == dsts[1]
    dev.bbop(op, dsts[0], *srcs[0])
    jdev.bbop(op, dsts[1], *srcs[1])
    _same_device(dev, jdev, dsts[0])


@pytest.mark.parametrize("batch_groups", [True, False])
def test_device_psm_staging_matches_reference(batch_groups):
    dev, jdev = _device_pair(batch_groups=batch_groups)
    slots = []
    for d in (dev, jdev):
        rng = np.random.default_rng(3)
        a, b = _alloc_write(d, rng, 6), _alloc_write(d, rng, 6)
        slots.append((a, b, d.alloc_rows(6)))
        d.bbop("xor", slots[-1][2], a[1:] + a[:1], b[2:] + b[:2])
    assert slots[0] == slots[1]
    _same_device(dev, jdev, slots[0][2])
    dev.banks[1].psm_copy(0, 0, 1, 3)
    jdev.banks[1].psm_copy(0, 0, 1, 3)
    dev.migrate_row((0, 0, 0), (1, 1, 5))
    jdev.migrate_row((0, 0, 0), (1, 1, 5))
    _same_device(dev, jdev, [(1, 1, 3), (1, 1, 5)])


@pytest.mark.parametrize("batch_groups", [True, False])
def test_device_aliasing_hazard_matches_reference(batch_groups):
    dev = AmbitDevice(GEOM, banks=1, subarrays=1, words=WORDS,
                      batch_groups=batch_groups, device=CPU)
    jdev = JDevice(GEOM, banks=1, subarrays=1, words=WORDS,
                   batch_groups=batch_groups)
    for d in (dev, jdev):
        a = _alloc_write(d, np.random.default_rng(8), 3)
        dst = d.alloc_rows(3)
        d.bbop("not", dst, [a[0], dst[0], dst[1]])
    _same_device(dev, jdev, dst)


def test_allocator_slots_match_reference():
    """Striped and co-located placement, near= affinity, frees and
    reuse, and the staging rows that skip live slots."""
    dev, jdev = _device_pair()
    traces = []
    for d in (dev, jdev):
        first = d.alloc_rows(7)
        trace = [first, d.alloc_rows(3, policy="colocated")]
        d.free_rows(first[1:4])
        trace += [d.alloc_rows(5, near=first[:2]), d.alloc_rows(4),
                  d.allocator.report(), d._staging_rows(0, 0, 3)]
        traces.append(trace)
    assert traces[0] == traces[1]
    alloc = dev.allocator
    with pytest.raises(AmbitError):
        alloc.alloc(alloc.free_slots + 1)


# -- the engine on ambit_sim --------------------------------------------------


OPS = ("and", "or", "xor", "nand", "nor", "xnor", "maj", "masked_set",
       "masked_clear")


def _vectors(seed, n_bits, rows=(), k=3):
    bits = np.random.default_rng(seed).integers(
        0, 2, (k,) + rows + (n_bits,)).astype(bool)
    return ([JBitVector.from_bits(b) for b in bits],
            [BitVector.from_bits(b, device="cpu") for b in bits])


def _apply(eng, op, a, b, c):
    if op == "maj":
        return eng.maj(a, b, c)
    if op in ("masked_set", "masked_clear", "xor", "nand", "nor", "xnor"):
        return getattr(eng, op)(a, b)
    return getattr(eng, op + "_")(a, b)


def same_eval(got, want, eng, jeng):
    assert got.n_bits == want.n_bits
    np.testing.assert_array_equal(to_numpy_u32(got.data),
                                  np.asarray(want.data))
    assert stats_tuple(eng.last_stats) == stats_tuple(jeng.last_stats)


@pytest.mark.parametrize("batch_rows", [True, False])
@pytest.mark.parametrize("n_bits", (1, 31, 33, 95, 257))
@pytest.mark.parametrize("op", OPS)
def test_engine_ops_match_reference(op, n_bits, batch_rows):
    jv, pv = _vectors(n_bits, n_bits)
    eng = BulkBitwiseEngine("ambit_sim", device=CPU, batch_rows=batch_rows)
    jeng = JEngine("ambit_sim", batch_rows=batch_rows)
    same_eval(_apply(eng, op, *pv), _apply(jeng, op, *jv), eng, jeng)


@pytest.mark.parametrize("batch_rows", [True, False])
@pytest.mark.parametrize("op", ("xor", "maj", "nand", "not"))
def test_engine_batched_rows_match_reference(op, batch_rows):
    """(rows, n_bits) operands: the simulator's batch dimension."""
    jv, pv = _vectors(97, 97, rows=(6,))
    eng = BulkBitwiseEngine("ambit_sim", device=CPU, batch_rows=batch_rows,
                            tracer=Tracer())
    jeng = JEngine("ambit_sim", batch_rows=batch_rows, tracer=JTracer())
    if op == "not":
        same_eval(eng.not_(pv[0]), jeng.not_(jv[0]), eng, jeng)
    else:
        same_eval(_apply(eng, op, *pv), _apply(jeng, op, *jv), eng, jeng)
    assert eng.metrics.counter("engine_aap_macros").total() == \
        jeng.metrics.counter("engine_aap_macros").total()
    assert eng.metrics.counter("engine_ns").total() == \
        jeng.metrics.counter("engine_ns").total()
    assert [dataclasses.astuple(e) for e in eng.tracer.spans("engine")] == \
        [dataclasses.astuple(e) for e in jeng.tracer.spans("engine")] != []


@pytest.mark.parametrize("amount", [0, 3, -3, 32, -32, 95, -100])
def test_engine_popcount_and_shift_match_reference(amount):
    jv, pv = _vectors(5, 95, k=1)
    eng, jeng = BulkBitwiseEngine("ambit_sim", device=CPU), \
        JEngine("ambit_sim")
    same_eval(eng.shift(pv[0], amount), jeng.shift(jv[0], amount), eng,
              jeng)
    assert int(eng.popcount(pv[0])) == int(jeng.popcount(jv[0]))
    assert stats_tuple(eng.last_stats) == stats_tuple(jeng.last_stats)


def test_engine_zero_rows_and_geometry_match_reference():
    env = {k: BitVector.from_bits(np.zeros((0, 64), bool), device="cpu")
           for k in "xy"}
    jenv = {k: JBitVector.from_bits(np.zeros((0, 64), bool)) for k in "xy"}
    X, Y = E.Expr.var("x"), E.Expr.var("y")
    for batch_rows in (True, False):
        eng = BulkBitwiseEngine("ambit_sim", device=CPU,
                                batch_rows=batch_rows)
        jeng = JEngine("ambit_sim", batch_rows=batch_rows)
        same_eval(eng.eval(X & Y, env),
                  jeng.eval(JE.Expr.var("x") & JE.Expr.var("y"), jenv),
                  eng, jeng)
    # a small D-group and the naive compiler: the program spills to
    # scratch rows at the top of 14 data rows
    jv, pv = _vectors(9, 200, rows=(3,))
    eng = BulkBitwiseEngine("ambit_sim", device=CPU, geometry=GEOM,
                            optimize=False)
    jeng = JEngine("ambit_sim", geometry=GEOM, optimize=False)
    jexpr = COMPILE_CASES[12]
    same_eval(eng.eval(port_expr(jexpr), dict(zip("xyz", pv))),
              jeng.eval(jexpr, dict(zip("xyz", jv))), eng, jeng)


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["and", "xor", "xnor", "maj_xor_or"])
def test_chip_smoke_ledger_is_the_reference_at_full_width(name):
    """``chip_smoke.py`` holds the card's ledger over 256 rows of 65,536
    bits to fixed values: they must be the reference's and the port's."""
    X, Y, Z = (JE.Expr.var(n) for n in "xyz")
    jexpr = {"and": X & Y, "xor": X ^ Y, "xnor": ~(X ^ Y),
             "maj_xor_or": JE.maj(X, Y, Z) ^ (X | ~Z)}[name]
    jv, pv = _vectors(5, 65536, rows=(256,))
    eng = BulkBitwiseEngine("ambit_sim", device=CPU)
    jeng = JEngine("ambit_sim")
    same_eval(eng.eval(port_expr(jexpr), dict(zip("xyz", pv))),
              jeng.eval(jexpr, dict(zip("xyz", jv))), eng, jeng)
    st = jeng.last_stats
    assert _chip_smoke().FIG20B_LEDGER[name] == (
        st.aap_count, st.ns, st.energy_nj, st.bytes_touched)


def test_compile_cache_matches_reference():
    X, Y, Z = (JE.Expr.var(n) for n in "xyz")
    jexpr = (X & Y) ^ ~Z
    compile_cache_clear()
    j_cache_clear()
    calls = [(True, 2), (True, 1), (False, 2), (True, 2), (True, 3)]
    for optimize, rows in calls:
        jv, pv = _vectors(rows, 64, rows=(rows,))
        BulkBitwiseEngine("ambit_sim", device=CPU, optimize=optimize).eval(
            port_expr(jexpr), dict(zip("xyz", pv)))
        JEngine("ambit_sim", optimize=optimize).eval(
            jexpr, dict(zip("xyz", jv)))
        got, want = compile_cache_info(), j_cache_info()
        assert (got.hits, got.misses, got.currsize) == \
            (want.hits, want.misses, want.currsize)
    assert compile_cache_info().misses == 2


# -- the analog model ---------------------------------------------------------


@pytest.mark.parametrize("variation", sorted(TABLE3_PAPER))
def test_tra_failure_rate_matches_reference(variation):
    for seed in (0, 5):
        got = analog.tra_failure_rate(variation, n_trials=20_000, seed=seed,
                                      device=CPU)
        assert got == janalog.tra_failure_rate(variation, n_trials=20_000,
                                               seed=seed)


def test_worst_case_margin_and_equation1_match_reference():
    got = analog.tra_worst_case_margin()
    want = janalog.tra_worst_case_margin()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    params = analog.AnalogParams(v_off_scale=0.3, q_restore_scale=0.5)
    jparams = janalog.AnalogParams(v_off_scale=0.3, q_restore_scale=0.5)
    np.testing.assert_allclose(
        analog.tra_worst_case_margin(params, resolution=1e-6),
        janalog.tra_worst_case_margin(jparams, resolution=1e-6), rtol=1e-12)
    rng = np.random.default_rng(1)
    charges = rng.uniform(0, 1, (50, 3))
    cc = rng.uniform(20, 24, (50, 3))
    cb = rng.uniform(70, 90, 50)
    got = analog.bitline_deviation(*(torch.from_numpy(a)
                                     for a in (charges, cc, cb)))
    np.testing.assert_allclose(got.numpy(),
                               janalog.bitline_deviation(charges, cc, cb),
                               rtol=1e-12)
    bits = rng.integers(0, 2, (50, 3))
    np.testing.assert_array_equal(
        analog.ideal_majority(torch.from_numpy(bits)).numpy(),
        janalog.ideal_majority(bits))


# -- the timing oracle --------------------------------------------------------


@pytest.mark.parametrize("argv", [[], ["--n-random", "3", "--psm-lines", "7"]])
def test_timing_checker_main_matches_reference(argv, capsys):
    assert tc.main(argv) == jtc.main(argv) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and out[0] == out[1]
    assert "0 violations" in out[0]


def test_timing_checker_streams_match_reference():
    progs, jprogs = tc.canonical_programs(6), jtc.canonical_programs(6)
    assert [(n, [repr(m) for m in p]) for n, p in progs] == \
        [(n, [repr(m) for m in p]) for n, p in jprogs]
    for (_, p), (_, jp) in zip(progs, jprogs):
        for aware in (True, False):
            ev = tc.schedule_program(p, start_ns=7790.0, refresh_aware=aware)
            jev = jtc.schedule_program(jp, start_ns=7790.0,
                                       refresh_aware=aware)
            assert [(e.t_ns, e.kind, e.bank, e.macro_id, repr(e.addr))
                    for e in ev] == \
                [(e.t_ns, e.kind, e.bank, e.macro_id, repr(e.addr))
                 for e in jev]
            # drop every precharge: the checker names the same faults
            got = tc.TimingChecker().check([e for e in ev if e.kind != "PRE"])
            want = jtc.TimingChecker().check(
                [e for e in jev if e.kind != "PRE"])
            assert [dataclasses.astuple(v) for v in got] == \
                [dataclasses.astuple(v) for v in want]
    psm = tc.schedule_psm_copy(128)
    jpsm = jtc.schedule_psm_copy(128)
    assert [(e.t_ns, e.kind) for e in psm] == [(e.t_ns, e.kind) for e in jpsm]
    with pytest.raises(tc.TimingViolationError):
        tc.TimingChecker().verify_program(progs[-1][1], start_ns=7790.0,
                                          refresh_aware=False)
