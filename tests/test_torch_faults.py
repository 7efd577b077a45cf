"""The port's reliability layer (FaultInjector, ReliabilityManager: stuck
rows, weak cells, transient flips, device loss, retry and quarantine,
TMR scrubs, the frontend's host fallback) against the reference's,
exactly.

Each case runs one test of ``tests/test_faults.py`` on both packages
through ``torch_pim_dual.dual`` (see ``test_torch_pim.py``): the fault
ledger string of every injector must be byte-equal, and so must every
result row, ``OpStats``, drain report and metrics snapshot. Draws are
numpy generators on the host keyed structurally in both packages; the
port applies them to int64 rows on the rows' device.

Also here: the ``faults_*`` sessions ``chip_smoke.py`` runs on the card,
held against the reference and against the ledgers the script pins, and
the fault ledger's independence of ``PYTHONHASHSEED``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_faults as jf
from repro_torch.pim.faults import FaultInjector
from torch_pim_dual import case_id, dual, ledger

FAULT_CASES = [
    ("test_tmr_encode_replicas_are_independent",),
    ("test_fault_ledger_is_seed_deterministic", ledger),
    ("test_injector_sampling_ignores_hash_seed",),
    ("test_weak_rate_tracks_analog_calibration",),
    ("test_stuck_rows_retry_to_bit_exact_results",),
    ("test_quarantine_does_not_leak_rows",),
    ("test_retries_exhausted_surface_a_fault_error",),
    ("test_protected_queries_bit_exact_under_silent_faults", 1),
    ("test_protected_queries_bit_exact_under_silent_faults", 4),
    ("test_scrub_is_billed_work",),
    ("test_device_loss_protected_recovery_from_host_shadow",),
    ("test_device_loss_dirty_plane_rebuilt_from_siblings",),
    ("test_result_planes_survive_any_single_device_loss",),
    ("test_scheduled_device_failure_mid_drain",),
    ("test_single_device_loss_is_fatal_for_dirty_unprotected",),
    ("test_frontend_host_fallback_after_device_loss",),
    ("test_frontend_surfaces_errors_instead_of_crashing",),
    ("test_frontend_deadline_rejects_stale_backlog",),
    ("test_frontend_marks_late_completions_timed_out",),
    ("test_frontend_optimized_drain_attributes_cache_hits",),
    ("test_retry_and_scrub_costs_reconcile_with_ledger",),
]


@pytest.mark.parametrize("case", FAULT_CASES, ids=case_id)
def test_faults_suite(case):
    dual(jf, *case)


def test_chaos_env_hook(monkeypatch):
    """``PIM_CHAOS_RATE``/``PIM_CHAOS_SEED`` build the same stuck-row
    injector in both packages."""
    dual(jf, "test_chaos_env_hook_builds_injector", monkeypatch)


def test_fault_masks_are_int64_rows_on_the_rows_device():
    """A weak-cell mask XORs into the written row as an int64 tensor on
    the row's device; the ledger counts its bits from the host mask."""
    from repro.pim.faults import FaultConfig as JConfig
    from repro.pim.faults import FaultInjector as JInjector
    from repro_torch.pim.faults import FaultConfig
    cfg = dict(seed=4, weak_bit_rate=0.02, transient_rate=0.5)
    inj, jinj = FaultInjector(FaultConfig(**cfg), device="cpu"), \
        JInjector(JConfig(**cfg))
    rng = np.random.default_rng(1)
    for k in range(6):
        row = rng.integers(0, 2**64, 8, dtype=np.uint64)
        slot = (k % 2, 0, k)
        got = inj.on_compute_write(0, slot, torch.from_numpy(
            row.view(np.int64).copy()))
        want = jinj.on_compute_write(0, slot, row)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    assert inj.ledger() == jinj.ledger() and "weak_cell" in inj.ledger()


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_api():
    import repro.core as core
    import repro.pim as pim
    import repro.pim.faults as faults
    import repro.serve as serve
    return _chip_smoke().PimApi(core, pim, faults, serve, device=None)


def _port_api():
    import repro_torch.core as core
    import repro_torch.pim as pim
    import repro_torch.pim.faults as faults
    import repro_torch.serve as serve
    return _chip_smoke().PimApi(core, pim, faults, serve, device="cpu")


def test_tmr_overhead_session_is_the_reference():
    cs = _chip_smoke()
    want = cs.tmr_overhead_session(_reference_api())
    got = cs.tmr_overhead_session(_port_api())
    assert got == want
    assert (want["storage_x"], want["aap_plain"], want["aap_tmr"],
            want["mismatches"]) == (3, 240, 1200, 0)
    assert want["ledger"] == cs.FAULTS_TMR_LEDGER


def test_fallback_session_is_the_reference():
    cs = _chip_smoke()
    want = cs.fallback_session(_reference_api())
    got = cs.fallback_session(_port_api())
    assert (got["fallbacks"], got["mismatches"], got["ledger"]) == \
        (want["fallbacks"], want["mismatches"], want["ledger"]) == \
        (2, 0, "device_lost dev=0 offline")


@pytest.mark.parametrize("rate", [0.001, 0.01])
def test_faulty_serve_session_is_the_reference(rate):
    """The ``faults_serve`` mix at its benchmark size: every answer equal
    to numpy, and the port's fault ledger, recovery counters and
    simulated-clock percentiles equal to the reference's and to the
    strings ``chip_smoke.py`` pins."""
    cs = _chip_smoke()
    want = cs.faulty_serve_session(_reference_api(), rate)
    got = cs.faulty_serve_session(_port_api(), rate)
    assert got == want
    assert want["mismatches"] == 0 and want["errors"] == 0
    assert want["ledger"] == cs.FAULTS_SERVE_LEDGER[rate]


def test_fault_ledger_ignores_hash_seed():
    """The port's faulty serving session prints the same fault ledger
    under PYTHONHASHSEED=0 and =1 (structural RNG keys, no hash())."""
    root = os.path.join(os.path.dirname(__file__), "..")
    src = os.path.join(root, "src")
    smoke = os.path.join(root, "chip_smoke.py")
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('cs', {smoke!r})\n"
        "cs = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(cs)\n"
        "import repro_torch.core as c, repro_torch.pim as p\n"
        "import repro_torch.pim.faults as f, repro_torch.serve as s\n"
        "api = cs.PimApi(c, p, f, s, device='cpu')\n"
        "out = cs.faulty_serve_session(api, 0.05, n_queries=256)\n"
        "print(out['ledger'])\n")
    outs = []
    for seed in ("0", "1"):
        env = dict(os.environ, PYTHONPATH=src, PYTHONHASHSEED=seed)
        env.pop("PIM_CHAOS_RATE", None)
        res = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=300,
                             check=True)
        outs.append(res.stdout)
    assert outs[0] == outs[1] and "stuck_row" in outs[0]


def test_host_fallback_runs_the_cuda_engine_on_the_rows_device():
    """After a device loss the frontend re-runs the query on
    ``BulkBitwiseEngine("cuda")`` on the session's device (the kernel's
    plain version on the CPU) and counts the fallback."""
    import repro_torch.core as core
    import repro_torch.pim as pim
    import repro_torch.pim.faults as faults
    import repro_torch.serve as serve
    api = _chip_smoke().PimApi(core, pim, faults, serve, device="cpu")
    out = _chip_smoke().fallback_session(api)
    assert out["fallbacks"] == 2 and out["mismatches"] == 0
    assert out["engine"] == ("cuda", "cpu")
    rt = pim.AmbitRuntime(banks=2, subarrays=2, words=2, device="cpu")
    assert serve.QueryFrontend(rt)._host_engine is None     # built lazily
