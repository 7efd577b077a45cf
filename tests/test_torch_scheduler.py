"""The port's AsyncScheduler, QueryFrontend and apps on the DRAM model
(``AmbitRuntime(backend="ambit_sim", device="cpu")``) against the
reference's, exactly: the cases of ``tests/test_scheduler.py``, the
``ambit_sim`` cases of ``test_serve.py``, ``test_apps.py``,
``test_backend_matrix.py`` and ``test_timing_checker.py``, run on both
packages through ``torch_pim_dual.dual`` (see ``test_torch_pim.py``).
"""

import pytest

import test_apps as japps
import test_backend_matrix as jbm
import test_scheduler as jsched
import test_serve as jserve
import test_timing_checker as jtc
from torch_pim_dual import Lazy, case_id, dual, ledger


# -- tests/test_scheduler.py --------------------------------------------------

SCHEDULER_CASES = [
    ("test_single_bank_contention_equals_serial",),
    ("test_disjoint_banks_share_one_epoch",),
    ("test_cluster_disjoint_devices_share_one_epoch",),
    ("test_same_destination_never_shares_epoch",),
    ("test_reader_of_out_handle_orders_before_writer",),
    ("test_ticket_dependency_orders_epochs",),
    ("test_epoch_formation_deterministic", ledger),
    ("test_per_bank_report_is_conservation_exact",),
    ("test_queued_operands_are_not_evicted",),
    ("test_queued_operand_cannot_be_freed_or_spilled",),
    ("test_spilled_operand_fault_in_charged_to_its_ticket",),
    ("test_failed_submit_releases_partial_holds",),
    ("test_failed_epoch_formation_releases_holds",),
    ("test_cancel_releases_holds",),
    ("test_optimized_drain_cse_must_fire",),
    ("test_optimized_drain_write_read_interleave_bit_exact",),
] + [("check_async_matches_serial", s, d)
     for s in range(3) for d in (1, 3)] + [
    ("check_optimized_drain_matches_serial", s, d)
    for s in range(3) for d in (1, 2)]


@pytest.mark.parametrize("case", SCHEDULER_CASES,
                         ids=case_id)
def test_scheduler_suite(case):
    dual(jsched, *case)


# -- the ambit_sim cases of tests/test_serve.py -------------------------------

SERVE_CASES = [
    ("test_frontend_matches_serial", "ambit_sim"),
    ("test_window_fills_then_drains",),
    ("test_deadline_drains_partial_window",),
    ("test_clock_never_runs_backwards",),
    ("test_quota_blocks_admission_not_the_queue",),
    ("test_quota_releases_on_completion",),
    ("test_store_pin_budget_enforced",),
    ("test_pin_budget_refunds_on_unpin_and_free",),
    ("test_tenant_pin_quota", "ambit_sim"),
    ("test_tenant_pin_all_or_nothing_on_store_budget",),
    ("test_ambit_popcount_unchanged",),
    ("test_closed_loop_completes_and_orders_per_tenant",),
    ("test_report_on_zero_completions_is_nan_free",),
    ("test_report_on_single_completion",),
    ("test_frontend_metrics_reconcile_with_report",),
] + [("check_frontend_matches_serial", s, "ambit_sim") for s in range(3)]


@pytest.mark.parametrize("case", SERVE_CASES,
                         ids=case_id)
def test_serve_suite_ambit_sim(case):
    dual(jserve, *case)


# -- ambit_sim cases of test_apps, test_backend_matrix, test_timing_checker ---

OTHER_CASES = [
    (japps, "test_bitmap_index_query", Lazy("BulkBitwiseEngine",
                                            "ambit_sim")),
    (japps, "test_bitmap_weekly_query_batches_one_drain"),
    (japps, "test_bitsets_match_numpy", Lazy("BulkBitwiseEngine",
                                             "ambit_sim")),
    (japps, "test_masked_init", Lazy("BulkBitwiseEngine", "ambit_sim")),
    (jbm, "test_resident_chain_matches_all_backends"),
    (jtc, "test_refresh_ledger_reconciles_across_all_surfaces"),
    (jtc, "test_cluster_refresh_metrics_reconcile_per_device_bank"),
    (jtc, "test_drain_refresh_stretches_wall_not_ledger"),
    (jtc, "test_drain_refresh_noop_when_work_fits_before_first_window"),
    (jtc, "test_drain_refresh_is_deterministic"),
]


@pytest.mark.parametrize("case", OTHER_CASES,
                         ids=case_id)
def test_other_suites_ambit_sim(case):
    dual(*case)
