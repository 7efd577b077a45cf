"""BENCHMARK.json against the rules a benchmark file keeps, the roofline's byte
count on a toy drain, and a cell, mix and metric added by files alone."""

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from bench import harness

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert DOC["command"] == ["python3", "bench/run.py"]
    assert DOC["paths"] == ["bench"]
    rs = DOC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(DOC)) <= 64 * 1024


def test_configs_and_cells():
    names = [c["name"] for c in DOC["configs"]]
    assert len(set(names)) == len(names)
    used = {w["config"] for w in DOC["workloads"]}
    for c in DOC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("bench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and c["name"] in used
        assert all(NAME.match(k) for k in c["reduced"])
        assert (BENCH / "deploy" / f"{cfg['kind']}.py").exists()
        assert (BENCH / "reference" / f"{cfg['kind']}.py").exists()
    pairs = set()
    for w in DOC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))


def test_metrics_have_readers_and_every_cell_reports_enough():
    e2e = {m["name"]: m for m in DOC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert harness.reader_path(m["name"]).exists()
    for m in DOC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in DOC["workloads"]:
        cell = harness.load_cell(w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")


def test_roofline_bytes_count_each_plane_once_a_call():
    cfg = {"kind": "bitweaving", "n_rows": 64, "columns": [
        {"name": "s", "bits": 12}, {"name": "d", "bits": 4},
        {"name": "q", "bits": 6}]}
    meter = harness.Meter(cfg, True)
    q1 = (("range", "s", 0, 2400),)
    q6 = (("range", "s", 365, 729), ("range", "d", 1, 3),
          ("range", "q", 0, 23))
    meter.add([q1, q6, q1])                 # one call: 22 planes once
    assert meter.bytes == 22 * 8 + 3 * 4
    meter.add([q1])                         # a later call reads again
    assert meter.bytes == 22 * 8 + 3 * 4 + 12 * 8 + 4
    bitmap = harness.Meter({"kind": "bitmap", "n_users": 320}, True)
    bitmap.add([(("bitmap", "week1"), ("bitmap", "week2")),
                (("bitmap", "week2"), ("bitmap", "male"))])
    assert bitmap.bytes == 3 * 40 + 2 * 4


def _view(**kw):
    base = dict(loop="closed", seconds=2.0, setup_s=1.0,
                latencies_ms=[1.0, 2.0, 3.0, 4.0], answered=4,
                counters={"serve_batched_queries": 32, "serve_drains": 2,
                          "fused_queries": 32, "fused_dispatches": 8},
                trace=None, roofline_bytes=0, hbm_bytes_per_s=3.35e12)
    base.update(kw)
    return harness.RunView(**base)


def test_metric_readers_on_a_hand_made_run():
    read = lambda n, v: harness.reader(n)(v)    # noqa: E731
    v = _view()
    assert read("qps", v) == 2.0
    assert read("p50_ms", v) == 2.0 and read("p99_ms", v) == 4.0
    assert read("scheduler.queries_per_launch", v) == 4.0
    assert read("frontend.queries_per_drain.open", v) == 16.0
    assert read("kernels_roofline", v) is None      # nothing traced
    assert read("device.idle_share", v) is None
    # an untraced window: no host span, so no host time a query
    assert read("frontend.self_ms_per_query", v) is None
    assert read("frontend.self_ms_per_query.open", v) is None
    assert read("qps", _view(loop="open")) is None
    t = {"kernel_s": 0.5, "busy_s": 0.6, "window_s": 2.0}
    v = _view(trace=t, roofline_bytes=int(3.35e11))
    assert read("kernels_roofline", v) == pytest.approx(20.0)
    assert read("device.idle_share", v) == pytest.approx(70.0)


def test_a_suffixed_metric_falls_back_to_the_shorter_names_reader():
    metrics = BENCH / "metrics"
    assert harness.reader_path("scheduler.self_ms_per_query.open") == \
        metrics / "scheduler.self_ms_per_query.py"
    assert harness.reader_path("frontend.queries_per_drain.open") == \
        metrics / "frontend.queries_per_drain.open.py"
    assert harness.reader_path("p99_ms.open") == metrics / "p99_ms.py"
    with pytest.raises(FileNotFoundError):
        harness.reader_path("nothing.here")


def _digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest() for p in sorted(root.rglob("*"))
        if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_mix_and_metric_are_added_by_files_alone(tmp_path):
    """A later change adds a mix file, a metric reader and entries in
    BENCHMARK.json, and edits no file the benchmark has."""
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "bench")
    mix = json.loads((BENCH / "traffic" / "weekly-closed.json").read_text())
    mix["load"]["clients"] = 8
    (tmp_path / "bench" / "traffic" / "weekly-closed-8.json").write_text(
        json.dumps(mix))
    (tmp_path / "bench" / "metrics" / "frontend.drains_per_query.py"
     ).write_text('"""Window drains per query."""\n\n\ndef read(run):\n'
                  '    return run.counters["serve_drains"] / run.answered\n')
    doc = json.loads(json.dumps(DOC))
    doc["configs"].append({"name": "bitmap-16m", "source":
                           "https://arxiv.org/abs/1905.09822",
                           "file": "bench/configs/bitmap-16m.json",
                           "reduced": [], "why": "Ambit Section 8.1"})
    doc["workloads"].append({"name": "bitmap16m-weekly-closed8",
                             "config": "bitmap-16m",
                             "traffic": "weekly-closed-8", "chips": 1,
                             "why": "8 clients: windows never fill"})
    doc["end_to_end"][0]["workloads"].append("bitmap16m-weekly-closed8")
    doc["per_layer"].append({"name": "frontend.drains_per_query",
                             "unit": "drains", "better": "lower",
                             "source": "program_counter",
                             "layer": "serving frontend (serve/frontend.py)",
                             "moves": "qps",
                             "workloads": ["bitmap16m-weekly-closed8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    cell = harness.load_cell("bitmap16m-weekly-closed8", root=tmp_path)
    cell.config["n_users"] = 4096
    r = harness.run_cell(cell, 11, 0.3, True, "cpu")
    assert r["correct"] and r["metrics"]["frontend.drains_per_query"][
        "value"] > 0
    after = _digest(tmp_path / "bench")
    assert {k: v for k, v in after.items() if k in before} == before


def test_idle_gaps_go_to_the_innermost_open_span():
    """A traced run's ``idle_gaps`` name each idle instant by the innermost
    span open at it, the drain where it runs inside a frontend call, the
    benchmark's loop (``bench``) where none is open."""
    from bench import devtrace, idlesplit

    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "pid": 1, "tid": 1}
    program = [(0, 100, "frontend.submit", None),
               (10, 40, "scheduler.drain", None)]
    events = [ev("user_annotation", devtrace.WINDOW, 0, 150),
              ev("kernel", "k", 20, 10), ev("kernel", "k", 45, 5)]
    s = devtrace.summarize(events, 0.0, 150.0)
    gaps = harness.breakdown(s, idlesplit.split(events, 0.0, 150.0,
                                                program))["idle_gaps"]
    # the submit: [0, 10), [40, 45) and [50, 100); the drain: [10, 20)
    # and [30, 40); after the submit closed: [100, 150)
    assert [g[0] for g in gaps] == ["frontend.submit", "bench",
                                    "scheduler.drain"]
    assert dict(gaps) == pytest.approx({"frontend.submit": 65e-6,
                                        "bench": 50e-6,
                                        "scheduler.drain": 20e-6})
    assert s["busy_s"] == pytest.approx(15e-6)
