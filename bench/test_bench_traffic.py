"""The traffic generator: deterministic for a seed, balanced across
seeds, and the TPC-H substitutions the spec's."""

import datetime
import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from bench import traffic

TRAFFIC = Path(__file__).resolve().parent / "traffic"
MIXES = sorted(p.stem for p in TRAFFIC.glob("*.json"))
SEED = 2**31 + 977


def _mix(name):
    return traffic.Mix.read(TRAFFIC / f"{name}.json")


def _day(y, m, d):
    return (datetime.date(y, m, d) - datetime.date(1992, 1, 1)).days


@pytest.mark.parametrize("name", MIXES)
def test_mix_is_deterministic_for_a_seed(name):
    mix = _mix(name)
    assert mix.first(SEED, 2000) == mix.first(SEED, 2000)
    assert mix.first(SEED, 2000) != mix.first(SEED + 1, 2000)
    if mix.loop == "open":
        t1, n1 = mix.arrivals(SEED, 3.0)
        t2, n2 = mix.arrivals(SEED, 3.0)
        assert np.array_equal(t1, t2) and np.array_equal(n1, n2)


@pytest.mark.parametrize("name", MIXES)
def test_every_drawn_query_is_one_the_warm_up_enumerates(name):
    mix = _mix(name)
    specs = set(mix.specs())
    assert set(mix.first(SEED, 3000)) <= specs


@pytest.mark.parametrize("name", [m for m in MIXES if "open" in m])
def test_open_arrivals_are_the_same_multiset_for_every_seed(name):
    mix = _mix(name)
    (t1, n1), (t2, n2) = mix.arrivals(1, 2.0), mix.arrivals(2, 2.0)
    rate = float(mix.load["rate_qps"])
    assert len(t1) == len(t2) == round(rate * 2.0)
    assert Counter(n1.tolist()) == Counter(n2.tolist())
    # the first arrival comes half a gap in
    g1 = np.concatenate([[2 * t1[0]], np.diff(t1)])
    g2 = np.concatenate([[2 * t2[0]], np.diff(t2)])
    assert np.all(g1 >= 0) and t1[-1] <= 2.0e9
    assert np.allclose(np.sort(g1), np.sort(g2), atol=2)    # ns
    assert not np.array_equal(t1, t2)


def test_family_shares_are_exact_in_each_block():
    mix = _mix("q1q6q14-closed")
    first = mix.first(SEED, traffic.BLOCK)
    by_shape = Counter(len(s) for s in first)     # Q6 has three terms
    assert by_shape[3] == traffic.BLOCK // 3


def test_tpch_substitution_ranges_are_the_specs():
    """Q1 (2.4.1.3): DELTA 60-120 days before 1998-12-01; Q6 (2.4.6.3):
    DATE Jan 1 of 1993-1997 for a year, DISCOUNT 0.02-0.09 +- 0.01,
    QUANTITY 24-25 (l_quantity < Q); Q14 (2.4.14.3): the first of a month
    of 1993-1997, for a month."""
    specs = _mix("q1q6q14-closed").specs()
    q1 = sorted(s for s in specs if len(s) == 1 and s[0][2] == 0)
    q6 = sorted(s for s in specs if len(s) == 3)
    q14 = sorted(s for s in specs if len(s) == 1 and s[0][2] > 0)
    assert [s[0][3] for s in q1] == [_day(1998, 12, 1) - d
                                     for d in range(120, 59, -1)]
    assert all(s[0][1] == "l_shipdate" for s in q1 + q14)
    want6 = {(("range", "l_shipdate", _day(y, 1, 1), _day(y + 1, 1, 1) - 1),
              ("range", "l_discount", d - 1, d + 1),
              ("range", "l_quantity", 0, q - 1))
             for y in range(1993, 1998) for d in range(2, 10)
             for q in (24, 25)}
    assert set(q6) == want6
    want14 = set()
    for y in range(1993, 1998):
        for m in range(1, 13):
            nxt = datetime.date(y + m // 12, m % 12 + 1, 1)
            want14.add((("range", "l_shipdate", _day(y, m, 1),
                         _day(nxt.year, nxt.month, 1) - 1),))
    assert set(q14) == want14
    assert len(specs) == 61 + 80 + 60 == 201


def test_shipdate_never_passes_its_twelve_bits():
    cfg = json.loads((TRAFFIC.parent / "configs" /
                      "tpch-sf300.json").read_text())
    ship = next(c for c in cfg["columns"] if c["name"] == "l_shipdate")
    top = sum(hi for _, hi in ship["uniform_sum"])
    assert top == _day(1998, 12, 1) == 2526 < 1 << ship["bits"]
    assert ship["uniform_sum"][0][1] == _day(1998, 12, 31) - 151


def test_weekly_windows_end_at_a_recent_week():
    """Ambit's two queries (Section 8.1): users active in every one of
    the latest w weeks, and male users active in every one of them, for
    w = 2-4."""
    latest = [f"week{j}" for j in range(48, 52)]
    want = {tuple(("bitmap", n) for n in latest[4 - w:]) + extra
            for w in (2, 3, 4) for extra in ((), (("bitmap", "male"),))}
    for name in ("weekly-closed", "weekly-open"):
        assert set(_mix(name).specs()) == want


def test_balanced_holds_expected_counts_in_shuffled_order():
    rng = np.random.default_rng(0)
    w = traffic.zipf_weights(5, 1.1)
    a = traffic.balanced(np.arange(5), w, rng, 1000)
    b = traffic.balanced(np.arange(5), w, rng, 1000)
    assert Counter(a.tolist()) == Counter(b.tolist())
    assert not np.array_equal(a, b)
    counts = np.bincount(a, minlength=5)
    assert np.all(np.abs(counts - w * 1000) < 1)


@pytest.mark.parametrize("text", ["__import__('os')", "a.b", "[1]",
                                  "x ** 2", "days(1, 2)", "1.5"])
def test_expressions_are_integer_arithmetic_only(text):
    with pytest.raises((ValueError, KeyError, SyntaxError)):
        traffic.evaluate(text, {"x": 3}, datetime.date(1992, 1, 1))


def test_expression_arithmetic():
    base = datetime.date(1992, 1, 1)
    assert traffic.evaluate("days(1993, 1, 1) - 1", {}, base) == 365
    assert traffic.evaluate("51 - r - w + 1", {"r": 2, "w": 3}, base) == 47
    assert traffic.evaluate("m % 12 + 1", {"m": 12}, base) == 1
