"""The port's PIM runtime on the DRAM model (``AmbitRuntime(backend=
"ambit_sim", device="cpu")``: PimStore and QueryPlanner on one device)
against the reference's, exactly.

Each case runs one test of the reference's own suites twice - on the
reference and on the port, from the same numpy seeds - through
``torch_pim_dual.dual``, which requires the two runs to leave equal
fingerprints: result rows and placements, every ``OpStats``,
``PlanReport``, ``ClusterReport``, ``ChannelLedger`` and ``DrainReport``
field, every ticket, the metrics snapshot. The test's own assertions run
in both. The reference suites' property tests take fixed seeds here.
``test_torch_pim_cluster.py`` does the same for PimCluster and
``test_torch_scheduler.py`` for the scheduler, the frontend and the apps
on the DRAM model.

Also here: the spilled-operand check on all three backends, the
runtime's device rules, and the DRAM ledgers ``chip_smoke.py`` pins for
its resident-chain and sharded-scan phases.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import test_pim_runtime as jrt
from repro.core import BitVector as JBitVector
from repro.core import Expr as JExpr
from repro.pim import AmbitRuntime as JRuntime
from repro_torch.core import AmbitError, BitVector, Expr
from repro_torch.pim import (AmbitRuntime, ClusterBitVector, DeviceStore,
                             PimStore, ResidentBitVector)
from repro_torch.pim.store import chunk_rows, unchunk_rows
from torch_pim_dual import case_id, dual, ledger


# -- tests/test_pim_runtime.py ------------------------------------------------

RUNTIME_CASES = [
    ("test_striped_matches_seed_bump_cursor_order",),
    ("test_colocated_fills_subarray_first",),
    ("test_freed_slots_are_reused_lowest_first",),
    ("test_double_free_and_foreign_free_raise",),
    ("test_failed_alloc_rolls_back",),
    ("test_scratch_reservation_shrinks_capacity",),
    ("test_near_affinity_prefers_neighbor_subarray",),
    ("test_occupancy_tracking",),
    ("test_put_get_roundtrip", 1), ("test_put_get_roundtrip", 128),
    ("test_put_get_roundtrip", 129), ("test_put_get_roundtrip", 700),
    ("test_put_get_roundtrip_batched_rows",),
    ("test_get_clean_is_free_dirty_costs",),
    ("test_free_releases_rows_and_blocks_use",),
    ("test_colocate_migrates_spanning_operands",),
    ("test_put_near_aligns_chunks",),
    ("test_planner_rejects_misaligned_operands",),
    ("test_runtime_rejects_host_operands",),
    ("test_planner_reports_bank_parallel_time",),
    ("test_runtime_session_accounting",),
    ("test_opstats_merge_accumulates_all_fields",),
    ("test_full_device_spills_lru_clean_for_free",),
    ("test_get_refreshes_lru_recency",),
    ("test_dirty_eviction_charges_readback",),
    ("test_pinned_is_never_evicted",),
    ("test_planner_protects_in_use_operands",),
    ("test_spilled_operand_faults_back_in_on_eval",),
    ("test_session_ledger_deterministic", ledger),
    ("test_device_alloc_rows_shim_free_and_reuse",),
] + [("check_allocator_invariants", s) for s in range(3)] + [
    ("check_planner_matches_engine", s, p)
    for s in range(6) for p in ("striped", "colocated")]


@pytest.mark.parametrize("case", RUNTIME_CASES,
                         ids=case_id)
def test_pim_runtime_suite(case):
    dual(jrt, *case)


# -- the spilled-operand check (LruSpillBase._check_live) ---------------------


@pytest.mark.parametrize("backend", ["ambit_sim", "torch", "cuda"])
def test_planner_rejects_spilled_operand(backend):
    """A spilled operand handed straight to the planner raises the
    reference's AmbitError on every backend; after ``ensure_resident``
    the same call runs."""
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (2, 300)).astype(bool)
    rt = AmbitRuntime(backend=backend, device="cpu", banks=2, subarrays=2,
                      words=2)
    a, b = (rt.put(BitVector.from_bits(x, device="cpu")) for x in bits)
    rt.store.spill(a)
    X, Y = Expr.var("x"), Expr.var("y")
    with pytest.raises(AmbitError, match="device-side use of spilled"):
        rt.planner.execute(X & Y, {"x": a, "y": b})
    jrt_ = JRuntime(backend={"torch": "jnp", "cuda": "pallas"}.get(
        backend, backend), banks=2, subarrays=2, words=2)
    ja, jb = (jrt_.put(JBitVector.from_bits(x)) for x in bits)
    jrt_.store.spill(ja)
    with pytest.raises(Exception, match="device-side use of spilled"):
        jrt_.planner.execute(JExpr.var("x") & JExpr.var("y"),
                             {"x": ja, "y": jb})
    rt.store.ensure_resident(a)
    out = rt.planner.execute(X & Y, {"x": a, "y": b})
    np.testing.assert_array_equal(rt.get(out).bits().numpy(),
                                  bits[0] & bits[1])


def test_store_hooks_are_abstract():
    from repro_torch.pim.store import LruSpillBase
    base = LruSpillBase()
    for hook, args in (("_read_back", (None,)), ("_release_rows", (None,)),
                       ("_owner_of", (None,))):
        with pytest.raises(NotImplementedError):
            getattr(base, hook)(*args)


# -- the runtime's device and handle types ------------------------------------


def test_runtime_device_rules():
    """``backend`` defaults to the DRAM model as in the reference; its
    rows live on ``device`` (the card unless named). ``rt.device`` is the
    ``AmbitDevice`` on ``ambit_sim`` and the torch device on the
    accelerator backends; ``rt.tensor_device`` is the torch device on
    all three."""
    rt = AmbitRuntime(banks=2, subarrays=1, words=2, device="cpu")
    assert rt.backend == "ambit_sim" and isinstance(rt.store, PimStore)
    assert rt.device.device.type == "cpu" and rt.device.words == 2
    assert rt.tensor_device.type == "cpu"
    sub = rt.device.banks[0].subarrays[0]
    assert sub.t_rows["T0"].device.type == "cpu"
    a = rt.put(BitVector.from_bits(np.ones(200, bool), device="cpu"))
    assert isinstance(a, ResidentBitVector)
    cl = AmbitRuntime(banks=1, subarrays=1, words=2, devices=3,
                      device="cpu")
    assert isinstance(cl.put(BitVector.from_bits(
        np.ones(400, bool), device="cpu")), ClusterBitVector)
    assert all(d.device.type == "cpu" for d in cl.cluster.devices)
    acc = AmbitRuntime(backend="torch", device="cpu")
    assert isinstance(acc.store, DeviceStore)
    assert acc.device.type == "cpu" and acc.tensor_device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            AmbitRuntime()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            AmbitRuntime(devices=2)
    with pytest.raises(ValueError):
        AmbitRuntime(backend="jnp", device="cpu")
    with pytest.raises(ValueError, match="devices>1"):
        AmbitRuntime(backend="cuda", devices=2, device="cpu")


@pytest.mark.parametrize("n_bits,rows", [(1, ()), (129, ()), (700, (3,)),
                                         (4096, (2,))])
def test_chunk_rows_round_trip_matches_the_reference(n_bits, rows):
    from repro.pim.store import chunk_rows as jchunk
    from repro.pim.store import unchunk_rows as junchunk
    bits = np.random.default_rng(n_bits).integers(
        0, 2, rows + (n_bits,)).astype(bool)
    jbv, bv = JBitVector.from_bits(bits), BitVector.from_bits(
        bits, device="cpu")
    want = jchunk(jbv, 4)
    got = chunk_rows(bv, 4, torch.device("cpu"))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    back = unchunk_rows(got, n_bits, rows, bv.data.shape[-1], 4)
    jback = junchunk(want, n_bits, rows, jbv.data.shape[-1], 4)
    np.testing.assert_array_equal(back.data.numpy().view(np.uint32),
                                  np.asarray(jback.data))


# -- the DRAM ledgers chip_smoke.py pins --------------------------------------


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _apis(cs):
    import repro.core as jcore
    import repro.pim as jpim
    import repro.pim.faults as jfaults
    import repro.serve as jserve
    import repro_torch.core as core
    import repro_torch.pim as pim
    import repro_torch.pim.faults as faults
    import repro_torch.serve as serve
    return (cs.PimApi(jcore, jpim, jfaults, jserve, device=None),
            cs.PimApi(core, pim, faults, serve, device="cpu"))


def test_resident_chain_ledger_is_the_reference_at_full_width():
    """The reference's session ``OpStats`` of the 128-row resident chain
    is the constant ``chip_smoke.py`` holds the card to; the port on the
    CPU gives the reference's session and metrics on 16 rows (the CPU
    run is kept short)."""
    cs = _chip_smoke()
    ref, port = _apis(cs)
    want = cs.resident_chain_session(ref)
    assert (want["mismatches"], want["host_reads"]) == (0, 1)
    assert want["session"] == cs.PIM_CHAIN_LEDGER
    assert cs.resident_chain_session(port, rows=16) == \
        cs.resident_chain_session(ref, rows=16)


def test_sharded_scan_ledger_is_the_reference():
    cs = _chip_smoke()
    ref, port = _apis(cs)
    want = cs.sharded_scan_session(ref)
    assert (want["mismatches"], want["aligned_bytes"]) == (0, 0)
    assert want["moved"] == cs.PIM_SHARDED_LEDGER
    assert cs.sharded_scan_session(port) == want
