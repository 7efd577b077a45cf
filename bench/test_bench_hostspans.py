"""``hostspans.run`` rehearsed on the CPU at a tiny size: the cell's run
with the program's host spans on is correct, reads one sync a query
answered and every layer's own time, and leaves the harness as it was;
``hostspans.main`` is ``run.py``'s, its checks included."""

import json
import os
import sys

import pytest
import torch

import repro_torch.pim as pim

from bench import harness, hostspans
from bench.test_bench_cells import CELLS, SEED, tiny

PER_QUERY = ("frontend.self_ms_per_query", "scheduler.self_ms_per_query",
             "device_store.launch_ms_per_query", "runtime.sync_ms_per_query")


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_host_spans_run_counts_one_sync_a_query(name, trace):
    def harness_as_it_is():
        return (harness.System, harness.ClosedLoop, harness.OpenLoop,
                harness.devtrace.summarize, harness.run_cell,
                pim.AmbitRuntime)
    before = harness_as_it_is()
    cell = tiny(name)
    r = hostspans.run(cell, SEED + 7, 1.0, trace, "cpu")
    assert harness_as_it_is() == before
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {m["name"] for m in (
        cell.per_layer if trace else cell.end_to_end)
        if m["source"] != "device_trace"}
    host = r["host"]
    spans = host["spans"]
    assert host["answered"] > 0
    assert host["runtime.syncs_per_query"] == 1.0
    assert host["sync_sites"] == {"popcount": host["answered"]}
    assert spans["scheduler.drain"]["count"] == \
        spans["frontend.drain"]["count"] > 0
    assert spans["device_store.launch"]["count"] >= \
        spans["scheduler.drain"]["count"]
    for key in PER_QUERY:
        assert host[key] > 0.0, key
    assert host["scheduler.self_ms_per_query"] * 1e-3 * host["answered"] == \
        pytest.approx(spans["scheduler.drain"]["self_s"])
    assert "idle_split" not in r            # no card, no device trace


def test_per_query_reads_self_and_total_times():
    summary = {"frontend.submit": {"count": 4, "total_s": 0.010,
                                   "self_s": 0.004},
               "frontend.drain": {"count": 1, "total_s": 0.006,
                                  "self_s": 0.001},
               "scheduler.drain": {"count": 1, "total_s": 0.005,
                                   "self_s": 0.002},
               "device_store.launch": {"count": 2, "total_s": 0.003,
                                       "self_s": 0.003},
               "device_store.sync": {"count": 5, "total_s": 0.008,
                                     "self_s": 0.008}}
    got = hostspans.per_query(summary, 4)
    assert got == pytest.approx({
        "frontend.self_ms_per_query": 1.25,
        "scheduler.self_ms_per_query": 0.5,
        "device_store.launch_ms_per_query": 0.75,
        "runtime.sync_ms_per_query": 2.0, "runtime.syncs_per_query": 1.25})
    assert hostspans.per_query(summary, 0) == {}


@pytest.mark.parametrize("case, rc", [("ok", 0), ("too few cards", 2),
                                      ("jax loaded", 3)])
def test_main_is_run_pys_with_run_in_run_cells_place(monkeypatch, capsys,
                                                     case, rc):
    # run.py's import and main set the process's paths, caches and threads
    monkeypatch.setattr(os, "environ", dict(os.environ))
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count",
                        lambda: 0 if case == "too few cards" else 1)
    monkeypatch.setattr(harness, "forbidden_modules",
                        lambda: ["jax"] if case == "jax loaded" else [])
    calls = []

    def run(cell, seed, seconds, trace, device="cuda", t_start=None,
            run_cell=None):
        calls.append((cell.name, seed, seconds, trace, device, run_cell))
        return {"correct": True, "checks": {}}
    monkeypatch.setattr(hostspans, "run", run)
    run_cell = harness.run_cell
    assert hostspans.main(["--workload", CELLS[0], "--seed", "3000000019",
                           "--seconds", "2", "--trace", "1"]) == rc
    assert harness.run_cell is run_cell
    out = capsys.readouterr().out.strip()
    if rc == 2:
        assert calls == [] and out == ""
        return
    assert calls == [(CELLS[0], 3000000019, 2.0, True, "cuda", run_cell)]
    assert (json.loads(out) if rc == 0 else out) == \
        ({"correct": True, "checks": {}} if rc == 0 else "")
