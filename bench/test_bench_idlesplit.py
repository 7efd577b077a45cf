"""``idlesplit`` on hand-made trace events and program spans: idle time
by the innermost span, the program's before the benchmark's, weighted by
overlap; kernel time by the launch that issued it; and the program's
spans put on a profiler's clock by anchors."""

import json

import pytest
import torch

from bench import devtrace, hostspans, idlesplit
from repro_torch.obs import Tracer


def ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def window(t1=100.0):
    return ev("user_annotation", devtrace.WINDOW, 0.0, t1)


def annotated(program):
    """The program's spans as annotations, the way ``devtrace`` reads
    them."""
    return [ev("user_annotation", n, a, b - a) for a, b, n, _ in program]


def test_a_gap_across_a_syncs_end_is_split_by_overlap():
    program = [(10, 60, "runtime.popcount", None),
               (20, 50, "device_store.sync", None),
               (60, 90, "frontend.submit", None)]
    events = [window(), ev("kernel", "k", 0, 30), ev("kernel", "k", 90, 10)]
    got = idlesplit.split(events, 0.0, 100.0, program)
    # idle [30, 90): the sync's last 20, popcount's 10 after it, submit's 30
    assert got["idle_s"] == pytest.approx({"device_store.sync": 20e-6,
                                           "runtime.popcount": 10e-6,
                                           "frontend.submit": 30e-6})
    assert got["window_s"] == pytest.approx(100e-6)
    # devtrace gives the whole gap to the span open at its start
    assert dict(devtrace.summarize(events + annotated(program), 0.0,
                                   100.0)["idle_gaps"]) == \
        pytest.approx({"device_store.sync": 60e-6})
    assert idlesplit.shares(got) == pytest.approx({"idle_in_sync": 20.0,
                                                   "idle_in_program": 40.0})


def test_an_outer_span_with_many_closed_children_is_still_named():
    program = [(5, 95, "frontend.flush", None),
               *((10 + 10 * k, 15 + 10 * k, f"c{k}", None)
                 for k in range(6))]
    events = [window(), ev("kernel", "k", 0, 72)]
    got = idlesplit.split(events, 0.0, 100.0, program)
    # idle [72, 100): in the flush, after its sixth child closed
    assert got["idle_s"] == pytest.approx({"frontend.flush": 23e-6,
                                           "bench": 5e-6})
    # devtrace looks back NEST spans for an open one, and finds none
    assert dict(devtrace.summarize(events + annotated(program), 0.0,
                                   100.0)["idle_gaps"]) == \
        pytest.approx({"bench": 28e-6})


def test_idle_time_sums_to_the_windows_idle_and_ignores_other_threads():
    events = [window(), ev("user_annotation", "scheduler.drain", 0, 40),
              ev("user_annotation", "other", 0, 100, tid=2),
              ev("user_annotation", idlesplit.ANCHOR, 60, 1),
              ev("kernel", "k", 10, 20), ev("gpu_memcpy", "m", 25, 10),
              ev("gpu_memset", "s", 95, 20)]
    got = idlesplit.split(events, 0.0, 100.0)
    assert sum(got["idle_s"].values()) == pytest.approx(
        100e-6 - devtrace.summarize(events, 0.0, 100.0)["busy_s"])
    assert got["idle_s"] == pytest.approx({"bench:scheduler.drain": 15e-6,
                                           "bench": 55e-6})
    assert idlesplit.shares(got) == {"idle_in_sync": 0.0,
                                     "idle_in_program": 0.0}


def test_the_programs_spans_come_before_the_benchmarks():
    program = [(5, 55, "runtime.popcount", None),
               (10, 50, "device_store.sync", None)]
    events = [window(), ev("user_annotation", "runtime.popcount", 0, 60),
              ev("user_annotation", "app.plan", 70, 10)]
    got = idlesplit.split(events, 0.0, 100.0, program)
    assert got["idle_s"] == pytest.approx({
        "bench:runtime.popcount": 10e-6, "runtime.popcount": 10e-6,
        "device_store.sync": 40e-6, "bench:app.plan": 10e-6,
        "bench": 30e-6})
    assert idlesplit.shares(got) == pytest.approx({"idle_in_sync": 40.0,
                                                   "idle_in_program": 10.0})


def test_kernel_time_goes_to_the_launch_that_issued_it():
    program = [(0, 60, "scheduler.drain", None),
               (5, 15, "device_store.launch", 12),
               (20, 30, "device_store.launch", 22),
               (70, 90, "runtime.popcount", None)]
    events = [window(200.0),
              ev("user_annotation", "app.plan", 100, 20),
              ev("cuda_runtime", "cudaLaunchKernel", 7, 2, correlation=1),
              ev("cuda_runtime", "cudaLaunchKernel", 22, 2, correlation=2),
              ev("cuda_runtime", "cudaLaunchKernelExC", 75, 2,
                 correlation=3),
              ev("cuda_runtime", "cudaLaunchKernel", 110, 2, correlation=4),
              ev("kernel", "fused<4>", 10, 30, correlation=1),
              ev("kernel", "fused<2>", 40, 50, correlation=2),
              ev("kernel", "popcount", 90, 5, correlation=3),
              ev("kernel", "fill", 120, 4, correlation=4),
              ev("kernel", "stray", 150, 5, correlation=9)]
    got = idlesplit.split(events, 0.0, 200.0, program)
    assert got["kernels"] == [
        ["device_store.launch", 22, "fused<2>", pytest.approx(50e-6), 1],
        ["device_store.launch", 12, "fused<4>", pytest.approx(30e-6), 1],
        ["runtime.popcount", None, "popcount", pytest.approx(5e-6), 1],
        ["bench", None, "stray", pytest.approx(5e-6), 1],
        ["bench:app.plan", None, "fill", pytest.approx(4e-6), 1]]


def test_innermost_pieces_cover_the_window_in_order():
    spans = [(0.0, 50.0, "a"), (10.0, 20.0, "b"), (10.0, 15.0, "c"),
             (45.0, 60.0, "d"), (80.0, 200.0, "e")]
    pieces = idlesplit.innermost(spans, 5.0, 100.0)
    assert pieces[0][0] == 5.0 and pieces[-1][1] == 100.0
    assert all(p[1] == q[0] for p, q in zip(pieces, pieces[1:]))
    assert [(a, b, spans[k][2] if k >= 0 else None)
            for a, b, k in pieces] == [
        (5.0, 10.0, "a"), (10.0, 15.0, "c"), (15.0, 20.0, "b"),
        (20.0, 45.0, "a"), (45.0, 60.0, "d"),
        (60.0, 80.0, None), (80.0, 100.0, "e")]


def test_host_to_trace_takes_out_the_clocks_offset_and_rate():
    def trace_us(ns):                   # a trace clock 20 ppm fast
        return 5e5 + ns * 1e-3 * (1 + 2e-5)
    brackets, events = [], []
    for start in (1_000_000, 9_001_000_000):    # two ends, 9 s apart
        group = []
        for k in range(4):      # the annotation opens 1-4 µs after `before`
            before = start + 50_000 * k
            opened = before + 1_000 * (k + 1)
            group.append((before, opened + 2_000))
            events.append(ev("user_annotation", idlesplit.ANCHOR,
                             trace_us(opened), 1.0))
        brackets.append(group)
    to_us, err = idlesplit.host_to_trace(events, brackets)
    # every bracket holds the offset: the tightest pair leaves [-2, +1] µs
    assert err == pytest.approx(1.5, abs=1e-2)
    for ns in (1_000_000, 4_000_000_000, 9_001_000_000):
        assert abs(to_us(ns) - trace_us(ns)) <= err + 1e-6
    with pytest.raises(ValueError):
        idlesplit.host_to_trace(events[1:], brackets)


def test_host_spans_land_around_their_ops_on_the_profilers_clock(tmp_path):
    tr = Tracer(enabled=False, host_enabled=True)
    x = torch.ones(64, 64)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        brackets = [hostspans.anchor()]
        for k in range(30):
            with tr.host_span("outer", query=k):
                x = torch.add(x, 1)
                with tr.host_span("inner"):
                    x = torch.mm(x, x) * 1e-3
        brackets.append(hostspans.anchor())
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    to_us, err = idlesplit.host_to_trace(events, brackets)
    assert 0.0 <= err < 100.0

    def ops(name):
        return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                      for e in events if e.get("ph") == "X"
                      and e.get("name") == name)

    def spans(name):
        return sorted((to_us(e.ts_ns), to_us(e.ts_ns + e.dur_ns))
                      for e in tr.host_events if e.name == name)
    for span_name, op in (("outer", "aten::add"), ("inner", "aten::mm")):
        got, want = spans(span_name), ops(op)
        assert len(got) == len(want) == 30
        for (a, b), (oa, ob) in zip(got, want):
            assert a - err - 1.0 <= oa and ob <= b + err + 1.0
    for (a, b), (ia, ib) in zip(spans("outer"), spans("inner")):
        assert a <= ia and ib <= b
