"""The per-layer metrics read from the program's own host spans: a traced
rehearsal of each cell on the CPU reads every one of them, one sync a
query answered; an untraced run records no host span; each reader on a
hand-made window."""

import json
from pathlib import Path

import pytest

from bench import harness, idlesplit
from bench.test_bench_cells import REHEARSED, SEED, WINDOW_S, tiny

ROOT = Path(__file__).resolve().parents[1]
PER_LAYER = json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]
# every metric read from the program's spans, whichever cells list it
FROM_SPANS = [m for m in PER_LAYER if m["source"] == "program_span"]


def _systems(monkeypatch):
    """The ``System`` each run of the harness builds, kept for a look at
    its tracer after the run."""
    made = []

    class System(harness.System):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)
    monkeypatch.setattr(harness, "System", System)
    return made


@pytest.mark.parametrize("name", REHEARSED)
def test_traced_rehearsal_reads_the_programs_host_spans(monkeypatch, name):
    cell = tiny(name)
    cell.per_layer = FROM_SPANS
    made = _systems(monkeypatch)
    r = harness.run_cell(cell, SEED + 5, WINDOW_S, True, "cpu")
    assert r["correct"], r["checks"]
    got = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(got) == {m["name"] for m in FROM_SPANS}
    assert got["runtime.syncs_per_query"] == 1.0
    for k, v in got.items():
        assert v > 0, k
    tracer = made[0].tracer
    assert not tracer.host_enabled
    events = tracer.host_events
    answers = sum(e.name == harness.ANSWER for e in events)
    assert answers > 0
    assert [e.args["site"] for e in events if e.name == idlesplit.SYNC] == \
        ["popcount"] * answers


@pytest.mark.parametrize("name", REHEARSED)
def test_untraced_run_records_no_host_span(monkeypatch, name):
    made = _systems(monkeypatch)
    r = harness.run_cell(tiny(name), SEED + 6, 1.0, False, "cpu")
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0
    assert made[0].tracer.host_events == []
    assert made[0].tracer.host_summary() == {}


def _view(host, idle_split=None):
    return harness.RunView(
        loop="closed", seconds=2.0, setup_s=1.0, latencies_ms=[1.0] * 4,
        answered=4, counters={}, trace=None, roofline_bytes=0,
        hbm_bytes_per_s=3.35e12, host=host, idle_split=idle_split)


# a window of 4 answers: frontend self 0.004 + 0.001 s, scheduler self
# 0.002 s, launches 0.003 s, 5 syncs of 0.008 s in all
HOST = {"frontend.submit": {"count": 4, "total_s": 0.010, "self_s": 0.004},
        "frontend.drain": {"count": 1, "total_s": 0.006, "self_s": 0.001},
        "scheduler.drain": {"count": 1, "total_s": 0.005, "self_s": 0.002},
        "device_store.launch": {"count": 2, "total_s": 0.003,
                                "self_s": 0.003},
        "runtime.popcount": {"count": 4, "total_s": 0.009, "self_s": 0.001},
        "device_store.sync": {"count": 5, "total_s": 0.008,
                              "self_s": 0.008}}
SPLIT = {"window_s": 2.0, "idle_s": {}, "kernels": [], "clock_err_us": 1.0,
         "idle_in_sync": 12.5, "idle_in_program": 3.25}


@pytest.mark.parametrize("name, want", [
    ("frontend.self_ms_per_query", 1.25),
    ("scheduler.self_ms_per_query", 0.5),
    ("device_store.launch_ms_per_query", 0.75),
    ("runtime.sync_ms_per_query", 2.0),
    ("runtime.syncs_per_query", 1.25),
    ("device.idle_in_sync_share", 12.5),
    ("device.idle_in_program_share", 3.25)])
def test_readers_of_the_programs_spans_on_a_hand_made_window(name, want):
    read = harness.reader(name)
    assert read(_view(HOST, SPLIT)) == pytest.approx(want)
    # a window whose spans saw nothing, or no card's trace: not read
    assert read(_view({})) is None
