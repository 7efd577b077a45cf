"""The plain reference against hand-counted toys, its control, and its
independence from the port."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import datagen
from bench.reference import bitmap as ref_bitmap
from bench.reference import bitweaving as ref_bw

BENCH = Path(__file__).resolve().parent


def test_popcount_counts_every_bit_of_int32_words():
    words = torch.tensor([0, -1, 0b1011, -(1 << 31), 0x7FFFFFFF],
                         dtype=torch.int32)
    assert ref_bitmap.popcount(words) == 0 + 32 + 3 + 1 + 31


def test_bitmap_reference_ands_the_named_bitmaps():
    cfg = {"n_users": 64, "density": 0.5,
           "bitmaps": [{"name": "week{i}", "count": 2}, {"name": "male"}]}
    ref = ref_bitmap.Reference(cfg, 1, "cpu")
    ref.words = torch.tensor([[0b1011, -1], [0b0110, 0x0F], [0b0111, 0xF0]],
                             dtype=torch.int32)
    assert ref.count((("bitmap", "week0"), ("bitmap", "week1"))) == 1 + 4
    assert ref.count((("bitmap", "week1"), ("bitmap", "male"))) == 2 + 0
    assert ref.count((("bitmap", "week0"),)) == 3 + 32


def test_bitmap_draw_has_density_one_half_and_a_clean_tail():
    cfg = {"n_users": 100_003, "density": 0.5,
           "bitmaps": [{"name": "week{i}", "count": 3}]}
    words = datagen.bitmap_words(cfg, 7, "cpu")
    assert words.shape == (3, datagen.words_for(100_003))
    assert int(words[:, -1].max()) < 1 << (100_003 % 32)
    share = ref_bitmap.popcount(words) / (3 * 100_003)
    assert abs(share - 0.5) < 0.01
    assert torch.equal(words, datagen.bitmap_words(cfg, 7, "cpu"))


TOY = {"n_rows": 7, "columns": [
    {"name": "a", "bits": 2, "uniform_sum": [[0, 3]]},
    {"name": "b", "bits": 1, "uniform_sum": [[0, 1]]}]}
TOY_A = [0, 1, 2, 3, 3, 2, 1]
TOY_B = [0, 1, 1, 0, 1, 1, 0]


@pytest.fixture
def toy_columns(monkeypatch):
    def chunks(cfg, seed, device):
        yield 0, 7, {"a": torch.tensor(TOY_A), "b": torch.tensor(TOY_B)}
    monkeypatch.setattr(datagen, "column_chunks", chunks)


def test_bitweaving_reference_counts_conjunctions_by_hand(toy_columns):
    ref = ref_bw.Reference(TOY, 0, "cpu")
    # a in [1, 3] and b = 1: rows 1, 2, 4, 5
    assert ref.count((("range", "a", 1, 3), ("range", "b", 1, 1))) == 4
    assert ref.count((("range", "a", 3, 3),)) == 2
    assert ref.count((("range", "a", 0, 9),)) == 7       # clipped range
    assert ref.count((("range", "a", 2, 1),)) == 0       # empty range
    assert ref.count((("range", "a", 0, 2), ("range", "a", 2, 3))) == 2


def test_control_is_an_approximate_count(toy_columns):
    exact = ref_bw.Reference(TOY, 0, "cpu")
    control = ref_bw.Reference(TOY, 0, "cpu", control=True)
    spec = (("range", "a", 1, 3), ("range", "b", 1, 1))
    # even rows 0, 2, 4, 6 hold two of the four matches: 2 * 2, by chance
    assert (exact.count(spec), control.count(spec)) == (4, 2 * 2)
    spec = (("range", "a", 0, 0),)           # row 0 alone, counted twice
    assert (exact.count(spec), control.count(spec)) == (1, 2)


def test_bitweaving_reference_matches_numpy_on_drawn_values():
    cfg = {"n_rows": 5000, "columns": [
        {"name": "s", "bits": 12, "uniform_sum": [[0, 2405], [1, 121]]},
        {"name": "q", "bits": 6, "uniform_sum": [[1, 50]]}]}
    ref = ref_bw.Reference(cfg, 3, "cpu")
    (_, _, vals), = list(datagen.column_chunks(cfg, 3, "cpu"))
    s, q = vals["s"].numpy(), vals["q"].numpy()
    assert s.min() >= 1 and s.max() <= 2526 and q.min() >= 1
    spec = (("range", "s", 365, 729), ("range", "q", 0, 23))
    want = int(((s >= 365) & (s <= 729) & (q <= 23)).sum())
    assert ref.count(spec) == want > 0


def test_operand_bytes_count_planes_and_bitmaps():
    cfg = {"n_rows": 100, "columns": [{"name": "a", "bits": 3},
                                      {"name": "b", "bits": 2}]}
    got = ref_bw.operand_bytes(cfg, (("range", "a", 0, 1),
                                     ("range", "b", 1, 1)))
    assert len(got) == 5 and set(got.values()) == {4 * 4}
    cfg = {"n_users": 64}
    assert ref_bitmap.operand_bytes(cfg, (("bitmap", "x"), ("bitmap", "y"))) \
        == {("bitmap", "x"): 8, ("bitmap", "y"): 8}


@pytest.mark.parametrize("path", sorted(
    [BENCH / "datagen.py", BENCH / "stats.py", BENCH / "traffic.py"]
    + list((BENCH / "reference").glob("*.py"))), ids=lambda p: p.name)
def test_yardstick_imports_nothing_of_the_port_or_jax(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert not names & {"repro", "repro_torch", "jax", "jaxlib", "flax"}


def test_datagen_is_deterministic_and_seed_dependent():
    cfg = {"n_rows": 1000, "columns": [
        {"name": "d", "bits": 4, "uniform_sum": [[0, 10]]}]}
    a = next(datagen.column_chunks(cfg, 2**31 + 5, "cpu"))[2]["d"]
    b = next(datagen.column_chunks(cfg, 2**31 + 5, "cpu"))[2]["d"]
    c = next(datagen.column_chunks(cfg, 2**31 + 6, "cpu"))[2]["d"]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) <= 10
    assert np.unique(a.numpy()).size == 11
