"""Each cell's path through ``repro_torch`` rehearsed on the CPU at a
tiny size: sound runs are correct, and the control and each fault the
cells can have make ``correct`` false."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench import harness

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
# each deployment kind's rehearsal size; the Star Schema's: rows enough
# that its queries match from one to hundreds of rows, and a window drain
# stacks repeated queries as at full size
TINY = {"bitmap": {"n_users": 4133}, "bitweaving": {"n_rows": 10_007},
        "ssb": {"n_rows": 20_011}}
SEED = 2**31 + 4242
# long enough that a loaded CPU answers queries inside the window
WINDOW_S = 2.0


# deployments and mixes kept for later cells (PERF.md, open questions):
# rehearsed too, reporting what a cell of their loop reports
KEPT = {"bitmap16m-weekly-closed": ("bitmap-16m", "weekly-closed"),
        "bitmap-16m.weekly-open": ("bitmap-16m", "weekly-open")}
# every cell, and the kept closed mix
REHEARSED = CELLS + [k for k, (_, mix) in KEPT.items() if "closed" in mix]


def tiny(name):
    if name in KEPT:
        cell = harness.mix_cell(*KEPT[name])
        twin = next(harness.load_cell(c) for c in CELLS
                    if harness.load_cell(c).mix.loop == cell.mix.loop)
        cell.end_to_end, cell.per_layer = twin.end_to_end, twin.per_layer
    else:
        cell = harness.load_cell(name)
    cell.config.update(TINY[cell.config["kind"]])
    if cell.mix.loop == "open":
        cell.mix.load["rate_qps"] = 300
    return cell


@pytest.mark.parametrize("name", CELLS + list(KEPT))
def test_cell_rehearsal_is_correct(name):
    cell = tiny(name)
    r = harness.run_cell(cell, SEED, WINDOW_S, False, "cpu")
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(r)[-1] == "checks"
    assert r["checks"]["wrong_answers"] == {"value": 0, "limit": 0}


@pytest.mark.parametrize("name", REHEARSED)
def test_traced_rehearsal_reads_the_host_side_metrics(name):
    cell = tiny(name)
    r = harness.run_cell(cell, SEED + 1, WINDOW_S, True, "cpu")
    assert r["correct"], r["checks"]
    host_side = {m["name"] for m in cell.per_layer
                 if m["source"] != "device_trace"}
    assert set(r["metrics"]) == host_side       # no card, no device trace
    for v in r["metrics"].values():
        assert v["value"] > 0


@pytest.mark.parametrize("name", CELLS + list(KEPT))
def test_control_is_not_correct(name):
    r = harness.run_cell(tiny(name), SEED + 2, 0.3, False, "cpu",
                         control=True)
    assert not r["correct"]
    assert r["checks"]["wrong_answers"]["value"] > 0


def _unchanged(monkeypatch):
    """Each query's result is its first operand unchanged: a drain
    computes nothing."""
    from repro_torch.pim.scheduler import AsyncScheduler

    drain = AsyncScheduler.drain

    def broken(self, *a, **k):
        tickets = drain(self, *a, **k)
        for t in tickets:
            t.result._dev.copy_(t.env[min(t.env)]._dev)
        return tickets
    monkeypatch.setattr(AsyncScheduler, "drain", broken)


def _half_batch(monkeypatch):
    """A drain computes the first half of its queries; the rest take the
    first query's result."""
    from repro_torch.pim.scheduler import AsyncScheduler

    drain = AsyncScheduler.drain

    def broken(self, *a, **k):
        tickets = drain(self, *a, **k)
        for t in tickets[(len(tickets) + 1) // 2:]:
            t.result._dev.copy_(tickets[0].result._dev)
        return tickets
    monkeypatch.setattr(AsyncScheduler, "drain", broken)


def _altered_answer(monkeypatch):
    """Every seventh count is one off where it is read."""
    from repro_torch.pim.device_store import DeviceStore

    popcount, calls = DeviceStore.popcount, [0]

    def broken(self, rbv):
        calls[0] += 1
        return popcount(self, rbv) + (calls[0] % 7 == 0)
    monkeypatch.setattr(DeviceStore, "popcount", broken)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered_answer],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("name", [c for c in REHEARSED if "closed" in c])
def test_fault_in_the_timed_path_is_not_correct(monkeypatch, fault, name):
    cell = tiny(name)
    fault(monkeypatch)
    r = harness.run_cell(cell, SEED + 3, 0.3, False, "cpu")
    assert not r["correct"], r["checks"]


def test_sweep_finds_a_knee_on_a_tiny_mix():
    from bench import sweep

    cell = tiny("bitmap-16m.weekly-open")
    lines = list(sweep.sweep(cell, SEED, [50, 100], 0.3, "cpu"))
    assert [ln["rate_qps"] for ln in lines[:-1]] == [50, 100]
    assert all(len(ln["backlog_at_quarters"]) == 4 for ln in lines[:-1])
    assert lines[-1]["knee_qps"] in (None, 50, 100)


def test_a_run_loads_no_jax_and_no_reference_package():
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "from bench import harness\n"
        "cell = harness.load_cell('tpch300-q1q6q14-closed')\n"
        "cell.config['n_rows'] = 3000\n"
        "r = harness.run_cell(cell, 5, 0.2, True, 'cpu')\n"
        "print(json.dumps([harness.forbidden_modules(), r['correct'],\n"
        "                  'repro_torch' in sys.modules]))\n")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], True,
                                                               True]


def test_forbidden_modules_compares_whole_top_level_names():
    assert harness.forbidden_modules(["repro_torch.pim", "numpy",
                                      "benchmarks_x", "jaxtyping"]) == []
    assert harness.forbidden_modules(["repro.core", "jax.numpy",
                                      "repro_torch", "flax"]) == \
        ["flax", "jax", "repro"]


def test_run_refuses_without_a_card_or_without_the_program(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal where no card is")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_refuses_in_a_directory_of_the_benchmark_alone(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
         "1", "--seconds", "1", "--trace", "0"], capture_output=True,
        text=True, timeout=240, cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card_is_correct(card, name):
    r = harness.run_cell(harness.load_cell(name), SEED, 2.0, False, card)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
