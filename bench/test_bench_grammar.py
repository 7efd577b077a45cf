"""The traffic grammar's OR, IN-list and NOT: each mix of the cells draws
and plans exactly what it did before these forms existed (digests taken
with the generator and deployments that had only conjunctions), and each
new form counts through the port as the plain reference and a row-by-row
oracle count it, with the control reading every such answer wrong."""

import datetime
import functools
import hashlib
import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import datagen, harness, traffic
from bench.reference import bitmap as ref_bitmap
from bench.reference import bitweaving as ref_bw

BENCH = Path(__file__).resolve().parent
SEEDS = (2**31 + 977, 3600000011)
SEED = 2**31 + 3737

# sha256 (first 20 hex digits) of repr(Mix.specs()), repr(Mix.first(seed,
# 2000)) and, for an open mix, the int64 bytes of Mix.arrivals(seed, 3.0),
# as the generator of conjunctions alone drew them
GOLDEN_DRAWS = {
    "q1q6q14-closed": {"specs": "f030960fcbb9b29b5946",
                       SEEDS[0]: "6d0f95895b0b15fcf1ec",
                       SEEDS[1]: "890da21a7e19b7d57619"},
    "q1q6q14-open": {"specs": "f030960fcbb9b29b5946",
                     SEEDS[0]: "6d0f95895b0b15fcf1ec",
                     SEEDS[1]: "890da21a7e19b7d57619",
                     ("arrivals", SEEDS[0]): "7f4401c6433485e1518e",
                     ("arrivals", SEEDS[1]): "6ee25bb50bc4a38a282d"},
    "ssb-flights-closed": {"specs": "822f6704a7e75cffaa00",
                           SEEDS[0]: "0e8989cbb4d75d482f8a",
                           SEEDS[1]: "9098e11dbbe0c1217567"},
    "weekly-closed": {"specs": "115ae5bf0dcdff3436c2",
                      SEEDS[0]: "1291f35025d67b3dae5d",
                      SEEDS[1]: "acc561faeb6c2b8e41a0"},
    "weekly-open": {"specs": "115ae5bf0dcdff3436c2",
                    SEEDS[0]: "1291f35025d67b3dae5d",
                    SEEDS[1]: "acc561faeb6c2b8e41a0",
                    ("arrivals", SEEDS[0]): "95c4bd0585fc0791ffa7",
                    ("arrivals", SEEDS[1]): "1b92d3beb1d3f6067bf8"},
}
# the same digest of every spec of a mix with its plan on the port: the
# plan's expression in topological order (op, name, argument positions)
# and its env's names in order, as the deployments of conjunctions alone
# planned them
GOLDEN_PLANS = {
    "q1q6q14-closed": ("tpch-sf300", "b6459c642c8ea2c7e9fe"),
    "q1q6q14-open": ("tpch-sf300", "b6459c642c8ea2c7e9fe"),
    "ssb-flights-closed": ("ssb-sf300-flat", "276dde98bf4e3cd0e369"),
    "weekly-closed": ("bitmap-16m", "86961fcad99e31a8ffc6"),
    "weekly-open": ("bitmap-16m", "86961fcad99e31a8ffc6"),
}


def _digest(obj) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:20]


def _mix(name):
    return traffic.Mix.read(BENCH / "traffic" / f"{name}.json")


def _config(name, **sizes):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg.update(sizes)
    return cfg


def _runtime(backend="cuda"):
    from repro_torch.pim import AmbitRuntime

    return AmbitRuntime(backend=backend, device="cpu")


def _deployment(cfg, seed, runtime):
    kind = importlib.import_module(f"bench.deploy.{cfg['kind']}")
    return kind.Deployment(cfg, seed, runtime)


@pytest.mark.parametrize("name", sorted(GOLDEN_DRAWS))
def test_each_mix_enumerates_the_specs_it_did(name):
    assert _digest(_mix(name).specs()) == GOLDEN_DRAWS[name]["specs"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(GOLDEN_DRAWS))
def test_each_mix_draws_the_queries_it_did(name, seed):
    assert _digest(_mix(name).first(seed, 2000)) == GOLDEN_DRAWS[name][seed]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", [n for n in sorted(GOLDEN_DRAWS)
                                  if "open" in n])
def test_each_open_mix_draws_the_arrivals_and_tenants_it_did(name, seed):
    times, tenants = _mix(name).arrivals(seed, 3.0)
    got = hashlib.sha256(times.astype(np.int64).tobytes()
                         + tenants.astype(np.int64).tobytes()).hexdigest()
    assert got[:20] == GOLDEN_DRAWS[name][("arrivals", seed)]


@pytest.mark.parametrize("name", sorted(GOLDEN_PLANS))
def test_each_spec_of_the_mixes_plans_the_program_it_did(name):
    from repro_torch.core.expr import topo_order

    config, want = GOLDEN_PLANS[name]
    size = "n_users" if config.startswith("bitmap") else "n_rows"
    deploy = _deployment(_config(config, **{size: 2003}), 7, _runtime())
    rows = []
    for spec in _mix(name).specs():
        expr, env = deploy.plan(spec)
        order = topo_order(expr)
        at = {id(n): k for k, n in enumerate(order)}
        rows.append((spec, [(n.op, n.name, tuple(at[id(a)] for a in n.args))
                            for n in order], list(env)))
    assert _digest(rows) == want


# -- the grammar -----------------------------------------------------------


def _resolve(*terms, **params):
    return traffic.Family({"name": "f", "share": 1, "terms": list(terms)},
                          None).resolve(params)


def _r(column, lo, hi):
    return ("range", column, lo, hi)


def test_each_form_resolves_to_its_spec():
    assert _resolve({"column": "c", "lo": "x", "hi": "x + 2"}, x=3) == \
        (_r("c", 3, 5),)
    assert _resolve({"bitmaps": "w{j}", "j": [1, 2]}, {"bitmaps": "m"}) == \
        (("bitmap", "w1"), ("bitmap", "w2"), ("bitmap", "m"))
    assert _resolve({"bitmaps": "w{j}", "j": [1, "1 + k"], "join": "any"},
                    k=2) == \
        (("any", ((("bitmap", "w1"),), (("bitmap", "w2"),),
                  (("bitmap", "w3"),))),)
    assert _resolve({"column": "c", "in": [[1, 1], ["x", "x * 2"]]}, x=4) \
        == (("any", ((_r("c", 1, 1),), (_r("c", 4, 8),))),)
    assert _resolve({"any": [[{"column": "a", "lo": 0, "hi": 1},
                              {"not": {"column": "b", "lo": 2, "hi": 3}}],
                             [{"bitmaps": "w{j}", "j": [0, 1]}]]}) == \
        (("any", ((_r("a", 0, 1), ("not", _r("b", 2, 3))),
                  (("bitmap", "w0"), ("bitmap", "w1")))),)
    assert _resolve({"not": {"column": "c", "in": [[0, 1], [5, 6]]}}) == \
        (("not", ("any", ((_r("c", 0, 1),), (_r("c", 5, 6),)))),)
    # a term of several elements is negated as one branch
    assert _resolve({"not": {"bitmaps": "w{j}", "j": [0, 1]}}) == \
        (("not", ("any", ((("bitmap", "w0"), ("bitmap", "w1")),))),)


def test_specs_of_every_form_sort_and_hash_in_one_mix():
    terms = [[{"column": "c", "lo": 0, "hi": 1}],
             [{"column": "c", "in": [[0, 1], [3, 4]]}],
             [{"not": {"column": "c", "lo": 0, "hi": 1}}],
             [{"any": [[{"bitmaps": "m"}], [{"column": "c", "lo": 2,
                                             "hi": 2}]]}],
             [{"bitmaps": "w{j}", "j": [0, 3], "join": "any"},
              {"column": "c", "lo": 0, "hi": 1}]]
    mix = traffic.Mix({"load": {"loop": "closed", "clients": 4},
                       "families": [{"name": f"f{k}", "share": 1, "terms": t}
                                    for k, t in enumerate(terms)]})
    specs = mix.specs()
    assert len(specs) == len(set(specs)) == 5
    assert set(mix.first(SEED, 100)) == set(specs)


@pytest.mark.parametrize("term", [
    {"column": "c", "lo": 1},
    {"column": "c", "lo": 1, "hi": 2, "in": [[1, 2]]},
    {"column": "c", "in": []},
    {"column": "c", "in": [[1, 2, 3]]},
    {"any": []},
    {"any": [[]]},
    {"any": {"column": "c", "lo": 1, "hi": 2}},
    {"not": {"bitmaps": "w{j}", "j": [3, 2]}},
    {"bitmaps": "w{j}", "j": [0, 2], "join": "all of them"},
    {"bitmaps": "w{j}", "j": [2, 1], "join": "any"},
    {"bitmaps": "m", "join": "any"},
    {"bitmap": "m"},
    {"or": [[{"bitmaps": "m"}]]},
    ["bitmaps", "m"],
], ids=str)
def test_a_malformed_term_raises_naming_the_term(term):
    with pytest.raises(ValueError) as err:
        _resolve({"any": [[{"bitmaps": "m"}], [term]]})
    assert repr(term) in str(err.value)


def test_a_deployment_refuses_the_other_kinds_leaf():
    ssb = _deployment(_config("ssb-sf300-flat", n_rows=64), 1, _runtime())
    with pytest.raises(ValueError, match="'bitmap', 'm'"):
        ssb.plan((("not", ("bitmap", "m")),))
    bitmap = _deployment(_config("bitmap-16m", n_users=64), 1, _runtime())
    with pytest.raises(ValueError, match="'range', 'c', 0, 1"):
        bitmap.plan((("any", ((_r("c", 0, 1),),)),))


def test_operand_bytes_count_each_nested_leaf_once():
    cfg = {"n_rows": 100, "columns": [{"name": "a", "bits": 3},
                                      {"name": "b", "bits": 2}]}
    spec = _resolve({"column": "a", "in": [[0, 1], [4, 5]]},
                    {"not": {"any": [[{"column": "b", "lo": 1, "hi": 1}],
                                     [{"column": "a", "lo": 7, "hi": 7}]]}})
    got = ref_bw.operand_bytes(cfg, spec)
    assert len(got) == 5 and set(got.values()) == {4 * 4}
    spec = _resolve({"bitmaps": "w{j}", "j": [0, 2], "join": "any"},
                    {"not": {"bitmaps": "w{j}", "j": [1, 3]}})
    assert ref_bitmap.operand_bytes({"n_users": 64}, spec) == \
        {("bitmap", f"w{j}"): 8 for j in range(4)}
    assert list(traffic.leaves(spec)) == [
        ("bitmap", "w0"), ("bitmap", "w1"), ("bitmap", "w2"),
        ("bitmap", "w1"), ("bitmap", "w2"), ("bitmap", "w3")]


# -- each form served through the port -------------------------------------

# per deployment kind: its config, a size that is no multiple of 32, and
# each new form nested once, as the terms of one query
FORMS = {
    "bitweaving": ("tpch-sf300", {"n_rows": 10_007}, {
        "in": [{"column": "l_quantity", "in": [[1, 5], [40, 50]]},
               {"column": "l_discount", "lo": 2, "hi": 4}],
        # discount 0 (and 4): the rows past n_rows read 0 on every plane
        "not": [{"not": {"column": "l_discount", "lo": 1, "hi": 10}}],
        "not_in": [{"not": {"column": "l_discount",
                            "in": [[1, 3], [5, 10]]}}],
        "any_not": [{"any": [
            [{"column": "l_quantity", "lo": 0, "hi": 10},
             {"not": {"column": "l_discount", "lo": 0, "hi": 2}}],
            [{"column": "l_shipdate", "lo": 0, "hi": 300}]]}],
        "q19_shape": [{"any": [
            [{"column": "l_quantity", "lo": 1, "hi": 11},
             {"column": "l_discount", "lo": 0, "hi": 5},
             {"column": "l_shipdate", "lo": 0, "hi": 1000}],
            [{"column": "l_quantity", "lo": 10, "hi": 20},
             {"column": "l_discount", "lo": 3, "hi": 9}],
            [{"column": "l_quantity", "lo": 20, "hi": 30},
             {"not": {"column": "l_shipdate", "lo": 500, "hi": 2000}}]]}],
    }),
    "ssb": ("ssb-sf300-flat", {"n_rows": 20_011}, {
        "q3_3_shape": [{"column": "c_city", "in": [[190, 199], [0, 9]]},
                       {"column": "s_city", "in": [[190, 199], [60, 69]]},
                       {"column": "lo_orderdate", "lo": 0, "hi": 2190}],
        "not": [{"not": {"column": "lo_discount", "lo": 1, "hi": 10}}],
        "not_in": [{"not": {"column": "c_city", "in": [[0, 49],
                                                       [100, 249]]}},
                   {"column": "lo_quantity", "lo": 1, "hi": 25}],
        "any_not": [{"any": [
            [{"column": "s_city", "lo": 0, "hi": 99},
             {"not": {"column": "p_brand1", "lo": 0, "hi": 499}}],
            [{"column": "lo_discount", "lo": 0, "hi": 1}]]}],
    }),
    "bitmap": ("bitmap-16m", {"n_users": 4133}, {
        "join_any": [{"bitmaps": "week{j}", "j": [3, 6], "join": "any"},
                     {"bitmaps": "male"}],
        # users past n_users are 0 in every bitmap: a NOT must not count them
        "not": [{"not": {"bitmaps": "male"}}],
        "not_join_any": [{"not": {"bitmaps": "week{j}", "j": [48, 51],
                                  "join": "any"}}],
        "not_all": [{"not": {"bitmaps": "week{j}", "j": [50, 51]}},
                    {"bitmaps": "week49"}],
        "any_not": [{"any": [[{"bitmaps": "week50"},
                              {"not": {"bitmaps": "week51"}}],
                             [{"bitmaps": "male"}, {"bitmaps": "week0"}]]}],
    }),
}


def _specs(kind):
    return {name: _resolve(*terms) for name, terms in FORMS[kind][2].items()}


def _select(spec, leaf, n):
    """Rows (or users) a spec selects, evaluated element by element."""
    out = np.ones(n, bool)
    for e in spec:
        if e[0] == "any":
            sel = np.zeros(n, bool)
            for branch in e[1]:
                sel |= _select(branch, leaf, n)
        elif e[0] == "not":
            sel = ~_select((e[1],), leaf, n)
        else:
            sel = leaf(e)
        out &= sel
    return out


@functools.lru_cache(maxsize=None)
def _oracle(kind, n=None):
    """Each form's count, row by row over the drawn values (or user by
    user over the drawn bits), on ``n`` rows or users (the kind's test
    size when None)."""
    config, sizes, _ = FORMS[kind]
    key = next(iter(sizes))
    cfg = _config(config, **{key: n or sizes[key]})
    n = cfg[key]
    if kind == "bitmap":
        words = datagen.bitmap_words(cfg, SEED, "cpu").numpy()
        bits = np.unpackbits(words.view(np.uint8), axis=1,
                             bitorder="little")[:, :n].astype(bool)
        row = {nm: i for i, nm in enumerate(datagen.bitmap_names(cfg))}

        def leaf(e):
            return bits[row[e[1]]]
    else:
        values = {}
        for _, _, chunk in datagen.column_chunks(cfg, SEED, "cpu"):
            for c, v in chunk.items():
                values.setdefault(c, []).append(v.numpy())
        values = {c: np.concatenate(v) for c, v in values.items()}

        def leaf(e):
            return (values[e[1]] >= e[2]) & (values[e[1]] <= e[3])
    return cfg, {name: int(_select(s, leaf, n).sum())
                 for name, s in _specs(kind).items()}


@pytest.mark.parametrize("kind", sorted(FORMS))
def test_reference_counts_each_form_as_row_by_row(kind):
    cfg, want = _oracle(kind)
    specs = _specs(kind)
    ref = importlib.import_module(f"bench.reference.{cfg['kind']}")
    got = ref.Reference(cfg, SEED, "cpu").counts(specs.values())
    assert {name: got[s] for name, s in specs.items()} == want
    assert all(0 < c for c in want.values())


@pytest.mark.parametrize("backend", ["torch", "cuda", "card"])
@pytest.mark.parametrize("kind", sorted(FORMS))
def test_each_form_counts_through_the_port_as_the_reference(kind, backend):
    """Served through ``AmbitRuntime``: one drain a query, and one epoch of
    every form stacked. ``"torch"`` and ``"cuda"`` run on the CPU (``"cuda"``
    there runs its CPU branch) against the row-by-row oracle; ``"card"`` is
    ``"cuda"`` on the card, through the fused kernel and ``popcount_rows`` at
    the same sizes, against the reference drawn there."""
    from repro_torch.pim import AmbitRuntime

    cfg, want = _oracle(kind)
    specs = _specs(kind)
    device = "cpu"
    if backend == "card":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device: the fused kernel and "
                        "popcount_rows run on the card")
        backend = device = "cuda"
        ref = importlib.import_module(f"bench.reference.{cfg['kind']}")
        counts = ref.Reference(cfg, SEED, device).counts(specs.values())
        want = {name: counts[s] for name, s in specs.items()}
    rt = AmbitRuntime(backend=backend, device=device)
    deploy = _deployment(cfg, SEED, rt)
    got = {}
    for name, spec in specs.items():
        t = rt.submit(*deploy.plan(spec))
        rt.drain()
        got[name] = rt.popcount(t.result)
        rt.free(t.result)
    assert got == want
    tickets = {name: rt.submit(*deploy.plan(s)) for name, s in specs.items()}
    rt.drain()
    got = {name: rt.popcount(t.result) for name, t in tickets.items()}
    assert got == want


@pytest.mark.parametrize("kind", sorted(FORMS))
def test_control_reads_every_form_wrong(kind):
    config, sizes, _ = FORMS[kind]
    cfg = _config(config, **{next(iter(sizes)): 1_000_003})
    specs = list(_specs(kind).values())
    ref = importlib.import_module(f"bench.reference.{cfg['kind']}")
    want = ref.Reference(cfg, SEED, "cpu").counts(specs)
    ctl = ref.Reference(cfg, SEED, "cpu", control=True).counts(specs)
    assert min(want.values()) > 1000
    assert all(ctl[s] != want[s] for s in specs)


def test_an_or_of_49_bitmaps_passes_the_fused_kernels_operand_limit():
    """The OR of a range's bitmaps under equality encoding: 48 fit one
    fused launch; 49 raise the kernel's operand error on ``"cuda"``, while
    ``"torch"`` and the reference count them."""
    cfg = _config("bitmap-16m", n_users=4133)
    ref = ref_bitmap.Reference(cfg, SEED, "cpu")
    for backend in ("cuda", "torch"):
        rt = _runtime(backend)
        deploy = _deployment(cfg, SEED, rt)
        for last in (47, 48):
            spec = _resolve({"bitmaps": "week{j}", "j": [0, last],
                             "join": "any"})
            t = rt.submit(*deploy.plan(spec))
            if backend == "cuda" and last == 48:
                with pytest.raises(ValueError,
                                   match="at most 48 operands, got 49"):
                    rt.drain()
                continue
            rt.drain()
            assert rt.popcount(t.result) == ref.count(spec)
            rt.free(t.result)


# -- the rehearsal mix: SSB's 13 published queries --------------------------


def _all_queries_cell(n_rows=20_011):
    cell = harness.mix_cell("ssb-sf300-flat", "ssb-all-closed")
    cell.config["n_rows"] = n_rows
    cell.end_to_end = harness.load_cell("ssb300-flights-closed").end_to_end
    return cell


def test_all_queries_mix_is_the_flights_mix_with_q3_3_and_q3_4():
    flights, every = _mix("ssb-flights-closed"), _mix("ssb-all-closed")
    assert every.load == flights.load
    kept = {f.name: f.specs() for f in flights.families}
    added = {f.name: f.specs() for f in every.families
             if f.name not in kept}
    assert {f.name: f.specs() for f in every.families
            if f.name in kept} == kept
    uk = ("any", ((_r("c_city", 191, 191),), (_r("c_city", 195, 195),)))
    uk_s = ("any", ((_r("s_city", 191, 191),), (_r("s_city", 195, 195),)))
    day = {d: (d - datetime.date(1992, 1, 1)).days
           for d in (datetime.date(1997, 12, 1), datetime.date(1998, 1, 1))}
    dec, jan = sorted(day.values())
    assert added == {
        "q3.3": [(uk, uk_s, _r("lo_orderdate", 0, jan - 1))],
        "q3.4": [(uk, uk_s, _r("lo_orderdate", dec, jan - 1))]}
    assert all(f.share == 1 for f in every.families)


def test_all_queries_rehearsal_is_correct_and_its_control_is_not():
    cell = _all_queries_cell()
    r = harness.run_cell(cell, SEED, 2.0, False, "cpu")
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 13
    assert set(r["metrics"]) == {"qps", "p99_ms", "setup_s"}
    r = harness.run_cell(cell, SEED + 1, 0.3, False, "cpu", control=True)
    assert not r["correct"] and r["checks"]["wrong_answers"]["value"] > 0
