"""The port's serving slice as a whole against the reference.

The closed-loop bitmap benchmark of ``benchmarks/serve_closed_loop.py``
runs on the reference's "pallas" backend and on the port's "cuda" backend
(the kernels' plain versions on the CPU; the port's run is
``test_torch_cuda.port_serve_bitmaps``): every token of the row must be
equal. The committed ``serve_bitmap_pallas`` row of ``BENCH_serving.json``
is reproduced by the port alone. A small TPC-H predicate mix through the
frontend and the weekly-active query are held against the reference
result for result.
"""

import json
import os

import numpy as np
import pytest

from benchmarks.serve_closed_loop import _serve_bitmaps
from repro.apps import bitweaving_db as jbw
from repro.apps.bitmap_index import BitmapIndex as JBitmapIndex
from repro.pim import AmbitRuntime as JRuntime
from repro.serve import QueryFrontend as JFrontend
from repro_torch.apps import bitweaving_db as pbw
from repro_torch.apps.bitmap_index import BitmapIndex
from repro_torch.convert import column_from_numpy, table_from_numpy
from repro_torch.pim import AmbitRuntime
from repro_torch.serve import QueryFrontend, roofline_epoch_cost
from test_torch_cuda import port_serve_bitmaps

BENCH = os.path.join(os.path.dirname(__file__), "..", "BENCH_serving.json")


def test_closed_loop_bitmap_tokens_match_reference():
    kw = dict(n_tenants=64, n_queries=192, n_users=4096, n_items=12,
              max_batch=16, window_ns=50_000.0)
    name, _, want = _serve_bitmaps("pallas", **kw)
    assert name == "serve_bitmap_pallas"
    got = port_serve_bitmaps(**kw)
    assert got == want
    assert "mismatches=0" in got and "pack_eff_pct=100" in got


def test_chrome_trace_matches_reference(tmp_path):
    """The traced serving run renders the same Perfetto JSON as the
    reference's, event for event; only the backend's name differs."""
    from repro_torch.obs import Tracer, chrome_trace
    kw = dict(n_tenants=32, n_queries=96, n_users=2048, n_items=8,
              max_batch=8, window_ns=50_000.0)
    _serve_bitmaps("pallas", trace_dir=str(tmp_path), **kw)
    with open(tmp_path / "serve_bitmap_pallas.json") as fh:
        want = json.load(fh)
    for ev in want["traceEvents"]:
        if ev["args"].get("backend") == "pallas":
            ev["args"]["backend"] = "cuda"
    tracer = Tracer()
    port_serve_bitmaps(tracer=tracer, **kw)
    got = json.loads(json.dumps(chrome_trace(tracer)))
    assert len(got["traceEvents"]) > 100
    assert got == want


def test_port_reproduces_committed_serving_row():
    with open(BENCH) as fh:
        rows = {r["name"]: r for r in json.load(fh)["rows"]}
    want = rows["serve_bitmap_pallas"]["derived"]
    got = port_serve_bitmaps(n_tenants=1024, n_queries=1100, n_users=4096,
                             n_items=12, max_batch=16, window_ns=50_000.0)
    assert got == want
    for token in ("queries=1100", "drains=69", "epochs=69", "p50_ns=70552",
                  "p99_ns=129015", "mismatches=0"):
        assert token in got.split()


def test_roofline_epoch_cost_keeps_reference_constants():
    from repro.serve import roofline_epoch_cost as jcost
    import inspect
    assert inspect.signature(roofline_epoch_cost).parameters.keys() == \
        inspect.signature(jcost).parameters.keys()
    for nm in ("launch_ns", "bytes_per_ns"):
        assert inspect.signature(roofline_epoch_cost).parameters[nm].default \
            == inspect.signature(jcost).parameters[nm].default


def _frontend_mix(rt, fe_cls, bw, table, mix):
    fe = fe_cls(rt, window_ns=20_000.0, max_batch=8)
    recs = []
    for k, (tenant, specs) in enumerate(mix):
        expr, env = bw.predicate_plan(table, specs, rt)
        recs.append(fe.submit(f"t{tenant}", expr, env,
                              arrival_ns=1_000.0 * k))
    fe.flush()
    rep = fe.report()
    results = [np.asarray(rt.get(q.result).data).view(np.uint32)
               for q in recs]
    return results, (rep.completed, rep.drains, rep.epochs, rep.p50_ns,
                     rep.p99_ns, rep.qps, rep.stats.bytes_touched)


def test_tpch_predicate_mix_matches_reference():
    jtable = jbw.TpchTable.synthesize(n_rows=3001, seed=3)
    ptable = pbw.TpchTable.synthesize(n_rows=3001, seed=3, device="cpu")
    for name, col in ptable.columns.items():
        np.testing.assert_array_equal(
            col.planes.numpy().view(np.uint32),
            np.asarray(jtable.columns[name].planes))
        np.testing.assert_array_equal(ptable.values[name],
                                      jtable.values[name])
    mix = jbw.zipf_tenant_queries(jtable, 16, 40, seed=3)
    assert mix == pbw.zipf_tenant_queries(ptable, 16, 40, seed=3)
    want, want_rep = _frontend_mix(JRuntime(backend="jnp"), JFrontend, jbw,
                                   jtable, mix)
    got, got_rep = _frontend_mix(AmbitRuntime(backend="cuda", device="cpu"),
                                 QueryFrontend, pbw, ptable, mix)
    assert got_rep == want_rep
    for (_, specs), g, w in zip(mix, got, want):
        np.testing.assert_array_equal(g, w)
        n = ptable.n_rows
        sel = np.unpackbits(g.view(np.uint8), bitorder="little")
        np.testing.assert_array_equal(sel[:n].astype(bool),
                                      ptable.oracle(specs))
        assert not sel[n:].any()


@pytest.mark.parametrize("use_kernel", [True, False])
def test_count_between_matches_reference(use_kernel):
    rng = np.random.default_rng(8)
    values = rng.integers(0, 2**10, 1000).astype(np.uint32)
    jcol = jbw.BitWeavingColumn.from_values(values, 10)
    pcol = column_from_numpy(np.asarray(jcol.planes), 1000, 10,
                             device="cpu")
    ptab = table_from_numpy({"v": values}, columns=(("v", 10),),
                            device="cpu")
    for c1, c2 in ((0, 1023), (100, 100), (256, 700), (1023, 0), (5, 900)):
        want = jcol.count_between(c1, c2, use_kernel)
        assert pcol.count_between(c1, c2, use_kernel) == want
        assert ptab.columns["v"].count_between(c1, c2, use_kernel) == want
        assert want == pcol.oracle_count(values, c1, c2)


def test_weekly_active_query_matches_reference():
    rng = np.random.default_rng(31)
    n_users = 1200
    weeks = [f"w{i}" for i in range(4)]
    jrt = JRuntime(backend="pallas")
    rt = AmbitRuntime(backend="cuda", device="cpu")
    jidx = JBitmapIndex(n_users, runtime=jrt)
    idx = BitmapIndex(n_users, runtime=rt)
    for w in weeks + ["male"]:
        members = rng.choice(n_users, n_users // 3, replace=False)
        jidx.add(w, members)
        idx.add(w, members)
    ju, jpw, jst = jidx.weekly_active_query(weeks, "male")
    u, pw, st = idx.weekly_active_query(weeks, "male")
    assert (u, pw, st.bytes_touched) == (ju, jpw, jst.bytes_touched)
    assert rt.scheduler.drains == jrt.scheduler.drains == 1
    assert rt.last_drain.n_queries == len(weeks) + 1
    assert idx.query_and_all(weeks[:2])[0] == jidx.query_and_all(weeks[:2])[0]
    assert rt.metrics_snapshot() == jrt.metrics_snapshot()
