"""The Star Schema deployment (``configs/ssb-sf300-flat.json``): its
reference against a count row by row, its control, its mix against the
spec's queries, its plans against the fused kernel's limits, and its cell
rehearsed on the CPU. Also: every TPC-H predicate of the benchmark lowers
to the program it lowered to before the kernel took programs past 32
operands."""

import datetime
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import datagen, harness, traffic
from bench.reference import ssb as ref_ssb

BENCH = Path(__file__).resolve().parent
CELL = "ssb300-flights-closed"
SEED = 2**31 + 3232


def _config(n_rows):
    cfg = json.loads((BENCH / "configs" / "ssb-sf300-flat.json").read_text())
    cfg["n_rows"] = n_rows
    return cfg


def _mix():
    return traffic.Mix.read(BENCH / "traffic" / "ssb-flights-closed.json")


def _day(y, m, d):
    return (datetime.date(y, m, d) - datetime.date(1992, 1, 1)).days


def _year(y0, y1=None):
    return _day(y0, 1, 1), _day((y1 or y0) + 1, 1, 1) - 1


def _brand(mfgr, category, brand):
    return ((mfgr - 1) * 5 + (category - 1)) * 40 + brand - 1


# regions by regionkey, 50 codes each; a nation's rank in its region, 10
REGION = {"AMERICA": 1, "ASIA": 2, "EUROPE": 3}
US = 50 + 4 * 10        # ARGENTINA, BRAZIL, CANADA, PERU, UNITED STATES


def _region(name):
    return 50 * REGION[name], 50 * REGION[name] + 49


# SSB's queries (spec rev 3), each term (column, lo, hi) on its code
QUERIES = {
    "q1.1": [("lo_orderdate", *_year(1993)), ("lo_discount", 1, 3),
             ("lo_quantity", 0, 24)],
    "q1.2": [("lo_orderdate", _day(1994, 1, 1), _day(1994, 1, 31)),
             ("lo_discount", 4, 6), ("lo_quantity", 26, 35)],
    "q1.3": [("lo_orderdate", _day(1994, 2, 7), _day(1994, 2, 13)),
             ("lo_discount", 5, 7), ("lo_quantity", 26, 35)],
    "q2.1": [("p_brand1", _brand(1, 2, 1), _brand(1, 2, 40)),
             ("s_city", *_region("AMERICA"))],
    "q2.2": [("p_brand1", _brand(2, 2, 21), _brand(2, 2, 28)),
             ("s_city", *_region("ASIA"))],
    "q2.3": [("p_brand1", _brand(2, 2, 39), _brand(2, 2, 39)),
             ("s_city", *_region("EUROPE"))],
    "q3.1": [("c_city", *_region("ASIA")), ("s_city", *_region("ASIA")),
             ("lo_orderdate", 0, _year(1997)[1])],
    "q3.2": [("c_city", US, US + 9), ("s_city", US, US + 9),
             ("lo_orderdate", 0, _year(1997)[1])],
    "q4.1": [("c_city", *_region("AMERICA")), ("s_city", *_region("AMERICA")),
             ("p_brand1", _brand(1, 1, 1), _brand(2, 5, 40))],
    "q4.2": [("c_city", *_region("AMERICA")), ("s_city", *_region("AMERICA")),
             ("lo_orderdate", *_year(1997, 1998)),
             ("p_brand1", _brand(1, 1, 1), _brand(2, 5, 40))],
    "q4.3": [("c_city", *_region("AMERICA")), ("s_city", US, US + 9),
             ("lo_orderdate", *_year(1997, 1998)),
             ("p_brand1", _brand(1, 4, 1), _brand(1, 4, 40))],
}
# operands of each query's plan: every plane of each column it ranges over
PLANES = {"q1": 22, "q2": 18, "q3": 28, "q4.1": 26, "q4.2": 38, "q4.3": 38}


def _spec(terms):
    return tuple(("range", c, lo, hi) for c, lo, hi in terms)


def test_mix_is_the_spec_queries_in_equal_shares():
    mix = _mix()
    assert mix.load == {"loop": "closed", "clients": 64}
    assert {f.name: f.share for f in mix.families} == \
        {name: 1 for name in QUERIES}
    for f in mix.families:
        assert f.specs() == [_spec(QUERIES[f.name])]
    assert mix.specs() == sorted(_spec(t) for t in QUERIES.values())
    block = mix.first(SEED, traffic.BLOCK)
    counts = {s: block.count(s) for s in set(block)}
    assert len(counts) == 11 and max(counts.values()) - \
        min(counts.values()) <= 1
    assert (US, _brand(1, 2, 1), _brand(2, 2, 39)) == (90, 40, 278)


def test_every_code_fits_its_column():
    cfg = _config(1000)
    bits = {c["name"]: c["bits"] for c in cfg["columns"]}
    for c in cfg["columns"]:
        (lo, hi), = c["uniform_sum"]
        assert 0 <= lo <= hi < 1 << c["bits"]
    for terms in QUERIES.values():
        for col, lo, hi in terms:
            assert 0 <= lo <= hi < 1 << bits[col]
    assert sum(bits.values()) == 48


def test_reference_equals_a_row_by_row_count():
    cfg = _config(4099)
    specs = [_spec(t) for t in QUERIES.values()]
    names = [c["name"] for c in cfg["columns"]]
    rows = np.concatenate([
        np.stack([values[n].numpy() for n in names], axis=1)
        for _, _, values in datagen.column_chunks(cfg, SEED, "cpu")])
    assert rows.shape == (4099, 6)
    col = {n: k for k, n in enumerate(names)}
    want = {s: sum(all(lo <= row[col[c]] <= hi for _, c, lo, hi in s)
                   for row in rows.tolist()) for s in specs}
    assert ref_ssb.Reference(cfg, SEED, "cpu").counts(specs) == want
    assert sum(v > 0 for v in want.values()) >= 8    # Q4.3 matches 1e-4


def test_control_reads_every_answer_wrong():
    cfg = _config(1_000_003)
    specs = [_spec(t) for t in QUERIES.values()]
    want = ref_ssb.Reference(cfg, SEED, "cpu").counts(specs)
    ctl = ref_ssb.Reference(cfg, SEED, "cpu", control=True).counts(specs)
    assert min(want.values()) > 50
    assert all(ctl[s] != want[s] for s in specs)


def test_operand_bytes_are_every_plane_of_each_ranged_column():
    cfg = _config(64)
    got = ref_ssb.operand_bytes(cfg, _spec(QUERIES["q4.3"]))
    assert len(got) == 38 and set(got.values()) == {8}


def _plans():
    """Each query's plan on the port over a tiny deployment (the cell's
    ``plan``), with the lowering the fused launch takes."""
    from bench.deploy.ssb import Deployment
    from repro_torch.kernels import ops
    from repro_torch.pim import AmbitRuntime

    deploy = Deployment(_config(2000), SEED,
                        AmbitRuntime(backend="cuda", device="cpu"))
    for name, terms in QUERIES.items():
        expr, env = deploy.plan(_spec(terms))
        yield name, ops._lowered(expr, tuple(sorted(env)))


def test_plans_fit_the_fused_kernel_and_only_q4_2_q4_3_go_wide():
    from repro_torch.kernels import bitwise as kbw

    for name, prog in _plans():
        want = PLANES.get(name) or PLANES[name[:2]]
        assert prog.n_operands == prog.n_loads == want, name
        assert (prog.n_loads > kbw.WARP_LOADS) == (want == 38), name
        assert prog.n_regs <= kbw.MAX_REGS and prog.n_loads <= \
            kbw.MAX_OPERANDS
        assert kbw.shared_bytes(prog, kbw.tile_for(prog), 1) <= kbw.MAX_SMEM


# sha256 of every TPC-H predicate's lowering (register program, kernel
# form, registers, loads, shared memory, tile) as the kernel of 32
# operands lowered them: raising the cap moves none of them
TPCH_LOWERING = \
    "978a692aee51908cac9f6c96c868f402c53e9430509a96ccc4454d447ff4f88a"


def test_tpch_predicates_lower_as_before_the_wide_route():
    from repro_torch.apps.bitweaving_db import scan_expr
    from repro_torch.kernels import bitwise as kbw

    cfg = json.loads((BENCH / "configs" / "tpch-sf300.json").read_text())
    bits = {c["name"]: int(c["bits"]) for c in cfg["columns"]}
    h = hashlib.sha256()
    specs = traffic.Mix.read(BENCH / "traffic" / "q1q6q14-closed.json"
                             ).specs()
    assert len(specs) == 201
    for spec in specs:
        expr, names = None, []
        for _, col, lo, hi in spec:
            term = scan_expr(bits[col], lo, hi, prefix=f"{col}_b")
            names += [f"{col}_b{i}" for i in range(bits[col])]
            expr = term if expr is None else expr & term
        p = kbw.lower(expr, tuple(sorted(names)))
        assert p.n_loads <= kbw.WARP_LOADS
        h.update(p.code.tobytes())
        h.update(p.packed.tobytes())
        h.update(repr((p.n_regs, p.result, p.n_operands, p.loads,
                       p.shared_regs, p.smem_bytes_per_word,
                       kbw.tile_for(p))).encode())
    assert h.hexdigest() == TPCH_LOWERING


def _tiny_cell(n_rows=20_011):
    cell = harness.load_cell(CELL)
    cell.config["n_rows"] = n_rows
    return cell


def test_cell_reports_its_metrics_and_stacks_repeated_queries():
    cell = _tiny_cell()
    assert {m["name"] for m in cell.end_to_end} == {"qps", "p99_ms",
                                                    "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "kernels_roofline.ssb", "scheduler.queries_per_launch.ssb"}
    r = harness.run_cell(cell, SEED, 2.0, True, "cpu")
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 16
    # no card: the device trace's share is not read
    assert set(r["metrics"]) == {"scheduler.queries_per_launch.ssb"}
    stacked = r["metrics"]["scheduler.queries_per_launch.ssb"]["value"]
    assert 1.2 < stacked <= 16


def test_cell_on_the_card_reports_both_per_layer_metrics():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels' share is read from "
                    "the card's trace")
    from repro_torch.kernels import bitwise as kbw

    wide = (kbw.fused_bitwise.wide_launches,
            kbw.fused_bitwise_stacked.wide_launches)
    r = harness.run_cell(_tiny_cell(50_000_017), SEED, 3.0, True, "cuda")
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"kernels_roofline.ssb",
                                 "scheduler.queries_per_launch.ssb"}
    assert 0 < r["metrics"]["kernels_roofline.ssb"]["value"] < 100
    # Q4.2 and Q4.3 launched alone and stacked
    assert kbw.fused_bitwise.wide_launches > wide[0]
    assert kbw.fused_bitwise_stacked.wide_launches > wide[1]
