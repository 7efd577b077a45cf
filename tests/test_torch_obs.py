"""The port's host-clock spans (``Tracer.host_span``), on the CPU.

Spans nest by parent id and carry the query's id; ``host_summary``'s self
time is a span's duration less its children's; with host spans off a site
reads no clock, opens no ``record_function`` and records nothing; on, it
opens none either, with or without a profiler, so a profiler's trace holds
no annotation of the program's spans; and a served TPC-H mix on the
``torch`` and ``cuda`` backends (the
kernels' plain versions here) records one ``device_store.sync`` a count
read, one ``scheduler.drain`` a window drain and one
``device_store.launch`` a fused launch, with answers and metrics equal
with host spans on and off. On ``cuda`` a launch span also names the
kernel program's instructions and whether its pointers went by value or
in a device table (a Star Schema Q4.2-shaped plan of 38 operands, single
and as a 16-query epoch), with the metrics equal to the reference's.
"""

import json
from collections import Counter

import pytest
import torch

from repro_torch.apps import bitweaving_db as bw
from repro_torch.obs import NULL_TRACER, Tracer, chrome_trace
from repro_torch.obs import tracer as tracer_mod
from repro_torch.pim import AmbitRuntime
from repro_torch.serve import QueryFrontend


def _by_id(tracer):
    return {e.span_id: e for e in tracer.host_events}


def test_host_spans_nest_with_parent_and_query_ids():
    tr = Tracer(enabled=False, host_enabled=True)
    with tr.host_span("outer", query=7, reason="fill") as span:
        with tr.host_span("inner"):
            pass
        with tr.host_span("inner", site="popcount"):
            with tr.host_span("leaf"):
                pass
        span.note(epochs=2)
    assert [e.name for e in tr.host_events] == ["inner", "leaf", "inner",
                                                "outer"]
    spans = _by_id(tr)
    outer = tr.host_events[-1]
    assert outer.args == {"parent": None, "query": 7, "reason": "fill",
                          "epochs": 2}
    assert {e.track for e in tr.host_events} == {tracer_mod.HOST_TRACK}
    assert all(e.kind == "X" and e.cat == "host" for e in tr.host_events)
    for e in tr.host_events:
        parent = e.args["parent"]
        if parent is None:
            continue
        p = spans[parent]
        assert p.ts_ns <= e.ts_ns
        assert e.ts_ns + e.dur_ns <= p.ts_ns + p.dur_ns
    leaf = tr.host_events[1]
    assert spans[leaf.args["parent"]].args["site"] == "popcount"
    assert spans[spans[leaf.args["parent"]].args["parent"]] is outer
    assert len(tr) == 0                 # no simulated event
    tr.clear()
    assert tr.host_events == []


def test_host_summary_self_time_is_duration_less_children():
    tr = Tracer(enabled=False, host_enabled=True)
    for _ in range(3):
        with tr.host_span("a"):
            with tr.host_span("b"):
                with tr.host_span("c"):
                    pass
            with tr.host_span("c"):
                pass
    summary = tr.host_summary()
    assert {k: v["count"] for k, v in summary.items()} == \
        {"a": 3, "b": 3, "c": 6}
    total = {n: sum(e.dur_ns for e in tr.host_events if e.name == n)
             for n in "abc"}
    c_in_b = sum(e.dur_ns for e in tr.host_events if e.name == "c"
                 and _by_id(tr)[e.args["parent"]].name == "b")
    c_in_a = total["c"] - c_in_b
    want_self = {"a": total["a"] - total["b"] - c_in_a,
                 "b": total["b"] - c_in_b, "c": total["c"]}
    for n in "abc":
        assert summary[n]["total_s"] == pytest.approx(total[n] * 1e-9)
        assert summary[n]["self_s"] == pytest.approx(want_self[n] * 1e-9)
        assert summary[n]["self_s"] >= 0.0


@pytest.mark.parametrize("profiled", [False, True])
def test_host_spans_open_no_record_function(monkeypatch, tmp_path,
                                            profiled):
    def record_function(*args, **kwargs):
        raise AssertionError("record_function opened by a host span")
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        record_function)
    tr = Tracer(enabled=False, host_enabled=True)
    if not profiled:
        with tr.host_span("a"):
            with tr.host_span("b"):
                pass
        assert [e.name for e in tr.host_events] == ["b", "a"]
        return
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _serve(tr)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    names = {e.name for e in tr.host_events}
    assert {"frontend.submit", "device_store.sync"} <= names
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert not [e for e in events if e.get("cat") == "user_annotation"
                and e.get("name") in names]


class _Raises:
    def __getattr__(self, name):
        raise AssertionError(f"time.{name} read with host spans off")


def _no_clock_no_profiler(monkeypatch):
    monkeypatch.setattr(tracer_mod, "time", _Raises())

    def record_function(*args, **kwargs):
        raise AssertionError("record_function opened with host spans off")
    monkeypatch.setattr(torch.profiler, "record_function", record_function)


@pytest.mark.parametrize("enabled", [False, True])
def test_host_spans_off_touch_no_clock_and_record_nothing(monkeypatch,
                                                          enabled):
    _no_clock_no_profiler(monkeypatch)
    tr = Tracer(enabled=enabled)
    assert not tr.host_enabled and not NULL_TRACER.host_enabled
    with tr.host_span("a", query=1, site="x") as span:
        span.note(epochs=1)
    assert tr.host_span("b") is tr.host_span("c")   # one shared context
    got = _serve(Tracer(enabled=enabled))
    assert got[0] and tr.host_events == []


def _serve(tracer, backend="torch"):
    """A Zipf TPC-H mix through a frontend: every count read and freed
    as the benchmark's loop does. Returns (answers, runtime metrics,
    frontend metrics, runtime)."""
    rt = AmbitRuntime(backend=backend, device="cpu", tracer=tracer)
    table = bw.TpchTable.synthesize(n_rows=3001, seed=3, device="cpu")
    fe = QueryFrontend(rt, window_ns=20_000.0, max_batch=8)
    answers = {}

    def collect():
        for q in fe.take_completed():
            answers[q.seq] = rt.popcount(q.result)
            rt.free(q.result)

    for k, (tenant, specs) in enumerate(
            bw.zipf_tenant_queries(table, 16, 40, seed=3)):
        expr, env = bw.predicate_plan(table, specs, rt)
        fe.submit(f"t{tenant}", expr, env, arrival_ns=1_000.0 * k)
        collect()
    fe.flush()
    collect()
    return answers, rt.metrics_snapshot(), fe.metrics_snapshot(), rt


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_served_mix_counts_one_span_per_sync_drain_and_launch(backend):
    tr = Tracer(enabled=False, host_enabled=True)
    answers, _, _, rt = _serve(tr, backend)
    summary = tr.host_summary()
    count = {k: v["count"] for k, v in summary.items()}
    m = rt.metrics
    assert len(answers) == 40
    assert count["runtime.popcount"] == count["device_store.sync"] == 40
    assert count["runtime.free"] == 40
    assert count["scheduler.drain"] == m.counter("serve_drains").total() \
        == count["frontend.drain"] > 0
    assert count["device_store.launch"] == \
        m.counter("fused_dispatches").total() > 0
    assert count["frontend.submit"] == 40
    assert {e.args["site"] for e in tr.host_events
            if e.name == "device_store.sync"} == {"popcount"}
    spans = _by_id(tr)
    parent = {e.span_id: spans[e.args["parent"]].name
              if e.args["parent"] is not None else None
              for e in tr.host_events}
    by_name = Counter((e.name, parent[e.span_id]) for e in tr.host_events)
    assert {p for (n, p) in by_name if n == "device_store.sync"} == \
        {"runtime.popcount"}
    assert {p for (n, p) in by_name if n == "device_store.launch"} == \
        {"scheduler.drain"}
    assert {p for (n, p) in by_name if n == "scheduler.drain"} == \
        {"frontend.drain"}
    assert {p for (n, p) in by_name if n == "frontend.drain"} <= \
        {"frontend.submit", "frontend.flush"}
    assert [e.args["query"] for e in tr.host_events
            if e.name == "frontend.submit"] == list(range(40))
    drained = [s for e in tr.host_events if e.name == "frontend.drain"
               for s in e.args["queries"]]
    assert sorted(drained) == list(range(40))
    assert sum(e.args["queries"] for e in tr.host_events
               if e.name == "device_store.launch") == \
        m.counter("fused_queries").total()
    for e in tr.host_events:
        if e.name == "scheduler.drain":
            assert e.args["epochs"] >= 1
    for name, s in summary.items():
        assert 0.0 <= s["self_s"] <= s["total_s"], name


@pytest.mark.parametrize("enabled", [False, True])
def test_answers_and_metrics_equal_with_host_spans_on_and_off(enabled):
    off = _serve(Tracer(enabled=enabled))
    on = _serve(Tracer(enabled=enabled, host_enabled=True))
    assert on[0] == off[0]
    assert on[1] == off[1] and on[2] == off[2]
    assert on[3].tracer.host_events and not off[3].tracer.host_events
    if enabled:     # the simulated events are the same, event for event
        want = chrome_trace(off[3].tracer)["traceEvents"]
        assert want and _without_host(chrome_trace(on[3].tracer)) == want


def _without_host(doc):
    pid = next(e["pid"] for e in doc["traceEvents"] if e["ph"] == "M"
               and e["args"]["name"] == "repro:host")
    return [e for e in doc["traceEvents"] if e["pid"] != pid]


def test_chrome_trace_puts_host_spans_on_their_own_process():
    tr = Tracer(enabled=True, host_enabled=True)
    tr.span(("scheduler",), "epoch", "sched", 0.0, 10.0)
    tr.instant(("store", "io"), "upload", "store")
    with tr.host_span("frontend.submit", query=0):
        with tr.host_span("scheduler.drain", queries=1):
            pass
    doc = chrome_trace(tr)
    meta = [e for e in doc["traceEvents"] if e["ph"] == "M"
            and e["name"] == "process_name"]
    assert [e["args"]["name"] for e in meta] == \
        ["repro:scheduler", "repro:store", "repro:host"]
    host = [e for e in doc["traceEvents"] if e.get("cat") == "host"]
    assert [e["name"] for e in host] == ["scheduler.drain",
                                         "frontend.submit"]
    assert {e["pid"] for e in host} == {3}
    assert host[0]["args"]["parent"] == host[1]["id"]
    assert host[1]["args"]["query"] == 0
    assert host[0]["dur"] == host[0]["args"]["dur_ns"] / 1000.0
    tr.host_events.clear()
    assert chrome_trace(tr) == chrome_trace(_simulated_only())


def _simulated_only():
    tr = Tracer(enabled=True)
    tr.span(("scheduler",), "epoch", "sched", 0.0, 10.0)
    tr.instant(("store", "io"), "upload", "store")
    return tr


# the four columns of the Star Schema's Q4.2: 38 planes
SSB_Q42 = (("c_city", 8), ("s_city", 8), ("lo_orderdate", 12),
           ("p_brand1", 10))
SSB_Q42_SPECS = [("c_city", 50, 99), ("s_city", 50, 99),
                 ("lo_orderdate", 1827, 2556), ("p_brand1", 0, 399)]


def _wide_session(rt, apps, table):
    """One Q4.2-shaped plan evaluated once, then 16 tickets of it in one
    drain (one stacked epoch). Returns (counts, metrics snapshot, the
    plan's expression and operand names)."""
    expr, env = apps.predicate_plan(table, SSB_Q42_SPECS, rt)
    one = rt.eval(expr, env)
    counts = [rt.popcount(one)]
    tickets = [rt.submit(expr, env) for _ in range(16)]
    rt.drain()
    counts += [rt.popcount(t.result) for t in tickets]
    return counts, rt.metrics_snapshot(), expr, tuple(sorted(env))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_wide_launch_spans_name_the_program_and_its_pointer_route(backend):
    from repro.apps import bitweaving_db as jbw
    from repro.pim import AmbitRuntime as JRuntime
    from repro_torch.kernels import bitwise as kbw
    from repro_torch.kernels import ops as kops

    want = _wide_session(
        JRuntime(backend={"torch": "jnp", "cuda": "pallas"}[backend]), jbw,
        jbw.TpchTable.synthesize(n_rows=2000, seed=5, columns=SSB_Q42))
    table = bw.TpchTable.synthesize(n_rows=2000, seed=5, columns=SSB_Q42,
                                    device="cpu")
    tr = Tracer(enabled=False, host_enabled=True)
    got = _wide_session(AmbitRuntime(backend=backend, device="cpu",
                                     tracer=tr), bw, table)
    off = _wide_session(AmbitRuntime(backend=backend, device="cpu"), bw,
                        table)
    assert got[:2] == want[:2] == off[:2]
    assert len(set(got[0])) == 1 and got[0][0] > 0
    launches = [e.args for e in tr.host_events
                if e.name == "device_store.launch"]
    assert [(a["queries"], a["operands"]) for a in launches] == \
        [(1, 38), (16, 38)]
    if backend == "torch":              # no kernel program
        assert not any("instructions" in a or "pointers" in a or
                       "evaluations" in a for a in launches)
        return
    prog = kops._lowered(got[2], got[3])
    assert prog.n_loads == 38 > kbw.WARP_LOADS
    # on the CPU the plain version evaluates each query of the epoch, so
    # its pointers are reckoned for 16 jobs (one job on the card)
    assert [(a["instructions"], a["evaluations"], a["pointers"])
            for a in launches] == \
        [(prog.packed.shape[0], 1, "value"),
         (prog.packed.shape[0], 16, "table")]
    assert 16 * 39 > kbw.PARAM_PTRS >= 39 + 16
