"""The port's PimCluster (``AmbitRuntime(backend="ambit_sim",
devices=N, device="cpu")``) against the reference's, exactly: every case
of ``tests/test_pim_cluster.py`` run on both packages through
``torch_pim_dual.dual`` (see ``test_torch_pim.py``), the property tests
at fixed seeds.
"""

import pytest

import test_pim_cluster as jcl
from torch_pim_dual import case_id, dual, ledger


# -- tests/test_pim_cluster.py ------------------------------------------------

CLUSTER_CASES = [
    ("test_channel_model_per_hop_costs",),
    ("test_round_robin_stripes_chunks_across_devices",),
    ("test_packed_fills_devices_in_order",),
    ("test_affinity_follows_neighbor_chunks",),
    ("test_affinity_without_neighbor_picks_least_loaded",),
    ("test_colocate_picks_cheapest_direction",),
    ("test_spanning_eval_measures_transfers_and_stays_correct",),
    ("test_sharded_6op_chain_matches_single_device",),
    ("test_cluster_put_spills_lru_clean_for_free",),
    ("test_cluster_dirty_spill_charges_readback",),
    ("test_sharded_eval_spills_on_full_device",),
    ("test_partial_spill_keeps_other_devices_hot",),
    ("test_partial_spill_dirty_chunks_stash_and_merge",),
    ("test_partial_spill_handle_rejected_by_planner_until_fault_in",),
    ("test_cluster_pinned_never_evicted",),
    ("test_sharded_time_is_max_over_devices",),
    ("test_apps_run_sharded_bit_identical",),
    ("test_cluster_ledger_deterministic", ledger),
] + [("check_cluster_lifecycle", s) for s in range(5)] + [
    ("check_sharded_matches_single", s, p, d)
    for s in range(3) for p in ("round_robin", "packed", "affinity")
    for d in (2, 4)]


@pytest.mark.parametrize("case", CLUSTER_CASES,
                         ids=case_id)
def test_pim_cluster_suite(case):
    dual(jcl, *case)
