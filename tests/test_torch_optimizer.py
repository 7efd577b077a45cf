"""The port's drain-time query optimizer (``pim/optimizer.py``: canonical
forms, cross-ticket CSE, the result cache) against the reference's,
exactly, on the DRAM model and on the accelerator backends.

Each case runs one test of ``tests/test_optimizer.py`` on both packages
through ``torch_pim_dual.dual`` (see ``test_torch_pim.py``): every
``OptReport``, drain report, ticket (its rewritten expression included)
and metrics snapshot must be equal. The accelerator cases map the
reference's ``"jnp"``/``"pallas"`` to the port's ``"torch"``/``"cuda"``
(whose kernels' plain versions run on the CPU).

The reference's optimizer fails on the draw ``seed=59277, devices=1``
(it resolves a var of a nested shared subtree from a ticket env it has
already pruned); the port keeps each ticket's env as it was at scan time,
and ``test_port_passes_the_draw_the_reference_fails`` holds it to the
numpy oracle and the unoptimized drain there.

``tests/test_optimizer.py``'s three ``AmbitDevice.bbop`` staging cases
are device-level; ``tests/test_torch_simulator.py`` holds the port's
staging against the reference.
"""

import importlib.util
import pathlib

import numpy as np
import pytest

import test_optimizer as jopt
from repro.core import Expr as JExpr
from repro.pim import optimizer as jo
from repro_torch.core import Expr
from repro_torch.pim import optimizer as po
from torch_pim_dual import _port_exprs, case_id, dual, ledger, run

OPT_CASES = [
    ("test_n_ops_counts_device_ops",),
    ("test_canonicalize_hash_cons_identity",),
    ("test_canonicalize_sort_is_structural_not_hash",),
    ("test_cse_fires_and_shares_one_materialization",),
    ("test_degenerate_fold_ticket_withdraws",),
    ("test_cache_serves_repeat_read_only_query",),
    ("test_cache_misses_on_write_between_equal_reads",),
    ("test_cache_invalidated_by_rebind_into_operand",),
    ("test_cache_invalidated_by_spill_fault_in",),
    ("test_cache_entry_released_by_free",),
    ("test_cache_capacity_lru_eviction",),
    ("test_dependency_cycle_rejected",),
    ("test_scratch_handles_do_not_leak",),
    ("test_failed_drain_reaps_scratch",),
    ("test_opt_counters_reconcile_with_ledger_deltas",),
    ("test_optimizer_session_deterministic", ledger),
    ("test_optimizer_emits_trace_events",),
] + [("check_canonical_properties", s) for s in range(4)] + [
    ("check_optimized_matches_unoptimized", s, d)
    for s in range(4) for d in (1, 4)] + [
    ("check_optimized_matches_unoptimized", s, 1, b)
    for s in range(3) for b in ("jnp", "pallas")]


@pytest.mark.parametrize("case", OPT_CASES, ids=case_id)
def test_optimizer_suite(case):
    dual(jopt, *case)


@pytest.mark.parametrize("seed", range(40))
def test_canonical_forms_match_the_reference(seed):
    """``canonicalize``, ``struct_key`` and ``n_ops`` of the suite's
    random expressions equal the reference's, node for node."""
    rng = np.random.default_rng(seed)
    e = jopt.rand_expr(rng)
    pe = _port_exprs(e, {})
    assert repr(pe) == repr(e)
    assert repr(po.canonicalize(pe)) == repr(jo.canonicalize(e))
    assert po.struct_key(po.canonicalize(pe)) == \
        jo.struct_key(jo.canonicalize(e))
    assert po.n_ops(pe) == jo.n_ops(e)
    assert isinstance(pe, Expr) and isinstance(e, JExpr)


def test_port_passes_the_draw_the_reference_fails():
    """``check_optimized_matches_unoptimized(59277, 1)`` of the reference
    suite, run on the port only: every optimized result equals the numpy
    oracle and the unoptimized drain (the check's own assertions), and a
    nested shared subtree really was materialized from a var its first
    consumer's rewrite dropped."""
    with pytest.raises(ValueError, match="invalid literal"):
        run(jopt, "check_optimized_matches_unoptimized", "ref", 59277, 1)
    fp = run(jopt, "check_optimized_matches_unoptimized", "port", 59277, 1)
    optimized = [o[1] for o in fp if o[0] == "runtime"][0]
    assert optimized["opt"][0][1] > 0          # cse_materialized
    assert all(t[1] == "done" for t in dict(fp)["tickets"])


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("backend", ["ambit_sim", "cuda"])
def test_optimizer_session_is_the_reference(backend):
    """``kern_pim_optimizer``'s mix, which ``chip_smoke.py`` runs on the
    card: the reference's rewrites and AAP counts are the pinned
    constants, and the port's session (on the DRAM model, and on
    ``"cuda"`` against the reference's ``"jnp"``: the rewrites do not
    depend on the accelerator backend, and ``"pallas"`` runs interpreted
    here) equals the reference's."""
    import repro.core as jcore
    import repro.pim as jpim
    import repro.pim.faults as jfaults
    import repro.serve as jserve
    import repro_torch.core as core
    import repro_torch.pim as pim
    import repro_torch.pim.faults as faults
    import repro_torch.serve as serve
    cs = _chip_smoke()
    ref = cs.PimApi(jcore, jpim, jfaults, jserve, device=None)
    port = cs.PimApi(core, pim, faults, serve, device="cpu")
    want = cs.optimizer_session(
        ref, backend={"cuda": "jnp"}.get(backend, backend))
    got = cs.optimizer_session(port, backend=backend)
    assert got == want
    assert want["mismatches"] == 0 and want["counters_reconcile"]
    pinned = cs.PIM_OPT_LEDGER
    assert (want["cse_hits"], want["cse_mat"], want["cache_hits"]) == \
        pinned[:3]
    if backend == "ambit_sim":
        assert (want["aap_unopt"], want["aap_opt"], want["aap_cached"]) == \
            pinned[3:]
    else:
        assert max(want["epochs"]) > 1      # stacked epochs on "cuda"
