"""The port on the card: every kernel against its plain version, the
serving slice on backend "cuda" against the committed reference tokens,
and the binary-LM example through the XNOR-popcount kernel.

Imports nothing of JAX or of the JAX package, so it runs on a GPU machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Without a CUDA device every test skips. ``port_serve_bitmaps`` (the
benchmark's closed-loop bitmap row, on the port) is shared with
``tests/test_torch_serve.py``, which holds it against the reference on
the CPU.
"""

import json
import os

import numpy as np
import pytest
import torch

from benchmarks.serve_closed_loop import _obs_tokens, _zipf_pairs
from repro_torch.apps import binary_lm
from repro_torch.apps.bitweaving_db import scan_expr
from repro_torch.core import BitVector, Expr
from repro_torch.core import expr as E
from repro_torch.kernels import binary_matmul as kbmm
from repro_torch.kernels import build
from repro_torch.kernels import bitweaving as kbv
from repro_torch.kernels import bitwise as kbw
from repro_torch.kernels import popcount as kpc
from repro_torch.pim import AmbitRuntime
from repro_torch.serve import QueryFrontend, run_closed_loop

BENCH = os.path.join(os.path.dirname(__file__), "..", "BENCH_serving.json")
SHAPES = [(1, 7), (129,), (2, 3, 40), (257, 8), (1, 524288), (187538,)]
X, Y, Z = E.Expr.var("x"), E.Expr.var("y"), E.Expr.var("z")
EXPRS = {
    "maj": E.maj(X, ~Y, Z),
    "not": ~(X & Z) ^ Y,
    "lit": E.Expr("or", (E.Expr("and", (X, E.ONE)),
                         E.Expr("xor", (E.Expr("not", (Y,)), E.ZERO)))),
}


def port_serve_bitmaps(n_tenants, n_queries, n_users, n_items, max_batch,
                       window_ns, device="cpu", tracer=None):
    """``_serve_bitmaps`` of benchmarks/serve_closed_loop.py on the port's
    "cuda" backend: the same numpy draws and the same derived tokens."""
    rng = np.random.default_rng(0)
    rt = AmbitRuntime(backend="cuda", device=device, tracer=tracer)
    raw = {f"m{i}": rng.integers(0, 2, n_users).astype(np.uint8)
           for i in range(n_items)}
    hs = {k: rt.put(BitVector.from_bits(v, device=device), name=k)
          for k, v in raw.items()}
    expr = Expr.var("x") & Expr.var("y")
    tenants = [f"t{i}" for i in range(n_tenants)]
    pair_of = dict(zip(tenants, _zipf_pairs(rng, n_items, n_tenants)))
    expected = {}

    def next_query(tenant, k):
        i, j = pair_of[tenant]
        a, b = f"m{i}", f"m{j}"
        expected[tenant] = int((raw[a] & raw[b]).sum())
        return expr, {"x": hs[a], "y": hs[b]}

    mism = 0

    def check(q):
        nonlocal mism
        if rt.popcount(q.result) != expected[q.tenant]:
            mism += 1
        rt.free(q.result)

    fe = QueryFrontend(rt, window_ns=window_ns, max_batch=max_batch)
    done = run_closed_loop(fe, tenants, next_query, n_queries,
                           on_complete=check)
    rep = fe.report()
    return (f"tenants={n_tenants} queries={done} drains={rep.drains} "
            f"fill={rep.fill_drains} deadline={rep.deadline_drains} "
            f"flush={rep.flush_drains} epochs={rep.epochs} "
            f"p50_ns={int(rep.p50_ns)} p99_ns={int(rep.p99_ns)} "
            f"qps={rep.qps:.1f} mismatches={mism} "
            + _obs_tokens(rt, rep, max_batch))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def words(rng, shape, device):
    w = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(w.view(np.int32)).to(device)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("ename", sorted(EXPRS))
def test_fused_bitwise_matches_plain_on_card(cuda, ename, shape):
    rng = np.random.default_rng(17)
    expr, names = EXPRS[ename], ("x", "y", "z")
    prog = kbw.lower(expr, names)
    arrays = [words(rng, shape, cuda) for _ in names]
    for n_bits in (None, 37, shape[-1] * 32 - 1):
        launches = kbw.fused_bitwise.launches
        got = kbw.fused_bitwise(expr, names, arrays, prog, n_bits=n_bits)
        assert kbw.fused_bitwise.launches == launches + 1
        assert torch.equal(got, kbw.fused_bitwise_plain(expr, names, arrays,
                                                        n_bits))
    unaligned = [words(rng, (int(np.prod(shape)) + 1,), cuda)[1:]
                 .reshape(shape) for _ in names]
    assert torch.equal(kbw.fused_bitwise(expr, names, unaligned, prog),
                       kbw.fused_bitwise_plain(expr, names, unaligned))
    want = kbw.fused_bitwise_plain(expr, names, arrays, 40)
    got = kbw.fused_bitwise(expr, names, arrays, prog, n_bits=40,
                            out=arrays[1])
    assert got is arrays[1] and torch.equal(got, want)
    operands = [[words(rng, shape, cuda) for _ in names] for _ in range(5)]
    outs = kbw.fused_bitwise_stacked(expr, names, operands, prog, n_bits=50)
    wants = kbw.fused_bitwise_stacked_plain(expr, names, operands, 50)
    assert all(torch.equal(g, w) for g, w in zip(outs, wants))


def test_stacked_epoch_larger_than_the_parameter_table(cuda):
    """An epoch of more pointers than travel by value takes the device
    table: still one launch, still exact."""
    rng = np.random.default_rng(3)
    names = tuple(f"v{i}" for i in range(8))
    expr = E.Expr.var(names[0])
    for nm in names[1:]:
        expr = expr ^ E.Expr.var(nm)
    prog = kbw.lower(expr, names)
    q = kbw.PARAM_PTRS // (len(names) + 1) + 3
    operands = [[words(rng, (2, 9), cuda) for _ in names] for _ in range(q)]
    launches = kbw.fused_bitwise_stacked.launches
    outs = kbw.fused_bitwise_stacked(expr, names, operands, prog)
    assert kbw.fused_bitwise_stacked.launches == launches + 1
    wants = kbw.fused_bitwise_stacked_plain(expr, names, operands)
    assert all(torch.equal(g, w) for g, w in zip(outs, wants))


@pytest.mark.parametrize("shape", [(1, 7), (1, 129), (6, 40), (257, 8),
                                   (1, 524288), (70000, 3)])
def test_popcount_rows_matches_plain_on_card(cuda, shape):
    x = words(np.random.default_rng(5), shape, cuda)
    assert torch.equal(kpc.popcount_rows(x), kpc.popcount_rows_plain(x))


def offset_view(rng, shape, offset, device):
    """Words of ``shape`` starting ``offset`` bytes past a 16-byte
    boundary: a view into a larger allocation."""
    n = int(np.prod(shape))
    view = words(rng, (n + 4,), device)[offset // 4:offset // 4 + n]
    assert view.data_ptr() % 16 == offset
    return view.reshape(shape)


def one_popcount(x):
    """popcount_rows: exactly one launch, exact, and every ticket word back
    at 0 afterwards."""
    launches = kpc.popcount_rows.launches
    got = kpc.popcount_rows(x)
    assert kpc.popcount_rows.launches == launches + 1
    assert torch.equal(got, kpc.popcount_rows_plain(x))
    assert not any(t.any() for t in kpc._TICKETS.values())


@pytest.mark.parametrize("offset", [4, 8, 12])
@pytest.mark.parametrize("shape", [(1, 524288), (1, 187538), (3, 1000),
                                   (2, 7), (5, 259)])
def test_popcount_rows_off_a_16_byte_boundary_on_card(cuda, shape, offset):
    """Views 4, 8 and 12 bytes off: the head and tail words are peeled and
    the body still takes 16-byte loads."""
    x = offset_view(np.random.default_rng(offset), shape, offset, cuda)
    one_popcount(x)


@pytest.mark.parametrize("shape", [(1, 524288), (2, 524289), (1, 1 << 22),
                                   (3, 40000), (200, 5000)])
def test_popcount_rows_split_rows_on_card(cuda, shape):
    """Rows over several blocks, meeting by ticket: at the served length,
    past it, over several passes a block and several rows a launch."""
    x = words(np.random.default_rng(shape[1]), shape, cuda)
    assert kpc.plan(*shape, build.sm_count(x.device)).splits > 1
    one_popcount(x)
    one_popcount(x[:, 1:].contiguous())
    one_popcount(x)                 # the ticket words were left at 0


@pytest.mark.parametrize("shape", [(70000, 3), (257, 8), (6, 40), (1, 256),
                                   (33, 255), (1000, 1)])
def test_popcount_rows_short_rows_on_card(cuda, shape):
    x = words(np.random.default_rng(shape[0]), shape, cuda)
    assert kpc.plan(*shape, build.sm_count(x.device)).route == \
        kpc.ROUTE_SHORT
    one_popcount(x)
    one_popcount(offset_view(np.random.default_rng(1), shape, 4, cuda))


def test_popcount_rows_empty_on_card(cuda):
    launches = kpc.popcount_rows.launches
    x = torch.empty((3, 0), dtype=torch.int32, device=cuda)
    assert torch.equal(kpc.popcount_rows(x),
                       torch.zeros(3, dtype=torch.int32, device=cuda))
    assert kpc.popcount_rows.launches == launches


@pytest.mark.parametrize("b", [1, 4, 12, 32])
def test_bitweaving_scan_matches_plain_on_card(cuda, b):
    rng = np.random.default_rng(b)
    top = (1 << b) - 1
    for n_words in (7, 187538, 524288):
        planes = words(rng, (b, n_words), cuda)
        for c1, c2 in ((0, top), (0, 0), (top, top), (top // 3, top // 2)):
            assert torch.equal(kbv.bitweaving_scan(planes, c1, c2),
                               kbv.bitweaving_scan_plain(planes, c1, c2))


def one_scan(planes, c1, c2, n_bits=None):
    launches = kbv.bitweaving_scan.launches
    got = kbv.bitweaving_scan(planes, c1, c2, n_bits)
    assert kbv.bitweaving_scan.launches == launches + 1
    assert torch.equal(got, kbv.bitweaving_scan_plain(planes, c1, c2,
                                                      n_bits))


@pytest.mark.parametrize("words_", [187538, 524288, 41])
def test_bitweaving_scan_tail_mask_every_remainder_on_card(cuda, words_):
    planes = words(np.random.default_rng(words_), (8, words_), cuda)
    for rem in range(32):
        one_scan(planes, 37, 200, 32 * (words_ - 2) + rem)
    for n_bits in (0, 6_001_215, 32 * words_, 32 * words_ + 5, None):
        one_scan(planes, 37, 200, n_bits)


@pytest.mark.parametrize("offset", [4, 8, 12])
@pytest.mark.parametrize("b,words_", [(8, 187538), (8, 524288), (32, 42),
                                      (3, 41)])
def test_bitweaving_scan_planes_off_a_16_byte_boundary_on_card(
        cuda, b, words_, offset):
    rng = np.random.default_rng(b + offset)
    planes = offset_view(rng, (b, words_), offset, cuda)
    top = (1 << b) - 1
    for c1, c2 in ((0, top), (top // 3, 2 * top // 3), (top, top)):
        one_scan(planes, c1, c2)
        one_scan(planes, c1, c2, 32 * words_ - 9)


def test_count_between_at_tpch_rows_on_card(cuda):
    """The served count: the scan masked in its store, one row's popcount
    read without a sum, equal to numpy."""
    from repro_torch.apps.bitweaving_db import BitWeavingColumn
    rng = np.random.default_rng(6)
    for n_rows in (6_001_215, 6_001_184, 1000):
        values = rng.integers(0, 256, n_rows).astype(np.uint32)
        col = BitWeavingColumn.from_values(values, 8, device=cuda)
        for c1, c2 in ((37, 200), (0, 255), (5, 5)):
            scans = kbv.bitweaving_scan.launches
            pcs = kpc.popcount_rows.launches
            assert col.count_between(c1, c2) == col.oracle_count(values, c1,
                                                                 c2)
            assert kbv.bitweaving_scan.launches == scans + 1
            assert kpc.popcount_rows.launches == pcs + 1


@pytest.mark.parametrize("m,n,k", [
    (1, 1, 32), (5, 9, 64), (16, 16, 128), (40, 70, 1000), (8, 128, 4096),
    (3, 5, 40000), (65, 67, 16416), (2048, 8, 256), (256, 256, 4096)])
def test_binary_matmul_matches_plain_on_card(cuda, m, n, k):
    rng = np.random.default_rng(k)
    kw = (k + 31) // 32
    a, b = words(rng, (m, kw), cuda), words(rng, (n, kw), cuda)
    if k % 32:                      # pad bits beyond k are zero
        keep = (1 << (k % 32)) - 1
        a[:, -1] &= keep
        b[:, -1] &= keep
    launches = kbmm.binary_matmul.launches
    got = kbmm.binary_matmul(a, b, k)
    assert kbmm.binary_matmul.launches == launches + 1
    torch.cuda.synchronize()
    assert torch.equal(got, kbmm.binary_matmul_plain(a, b, k))


# M, N and Kw one short of, on and one past each of binary_matmul's tiles
# (128x256 wgmma from 132 tiles up, 64x64, 128x8 for N <= 8; K in chunks
# of 8 words), k_bits off a multiple of 32, and split K on each tile
@pytest.mark.parametrize("m,n,k", [
    (1536, 2816, 256), (1535, 2815, 224), (1537, 2817, 289),
    (1536, 2816, 4100), (63, 65, 288), (64, 64, 256), (65, 63, 225),
    (127, 129, 4101), (300, 200, 100000), (127, 8, 31), (129, 7, 257),
    (2048, 8, 256), (300, 1, 40000)])
def test_binary_matmul_tile_edges_on_card(cuda, m, n, k):
    rng = np.random.default_rng(m * 7 + n + k)
    kw = (k + 31) // 32
    a, b = words(rng, (m, kw), cuda), words(rng, (n, kw), cuda)
    if k % 32:
        keep = (1 << (k % 32)) - 1
        a[:, -1] &= keep
        b[:, -1] &= keep
    got = kbmm.binary_matmul(a, b, k)
    torch.cuda.synchronize()
    assert torch.equal(got, kbmm.binary_matmul_plain(a, b, k))


def test_binary_matmul_plans_cover_every_tile_and_split():
    """The shapes above reach every tile of the kernel, split and not, on
    the H100 SXM's 132 SMs."""
    seen = {(p.config, p.splits > 1) for p in (
        kbmm.plan(m, n, (k + 31) // 32, 132) for m, n, k in (
            (1536, 2816, 256), (1536, 2816, 4100), (64, 64, 256),
            (127, 129, 4101), (2048, 8, 256), (300, 1, 40000)))}
    assert seen == {(c, s) for c in range(3) for s in (False, True)}


def regs64_expr():
    """Pairwise xors of 12 operands, consumed by an and-chain in one order
    and an or-chain in the other: 64 live registers."""
    leaves = [E.Expr.var(f"v{i}") for i in range(12)]
    mids = [leaves[i] ^ leaves[j] for i in range(12)
            for j in range(i + 1, 12)][:61]
    chain1, chain2 = mids[0], mids[-1]
    for m in mids[1:]:
        chain1 = chain1 & m
    for m in reversed(mids[:-1]):
        chain2 = chain2 | m
    return chain1 ^ chain2, tuple(f"v{i}" for i in range(12))


@pytest.mark.parametrize("ename", ["maj", "lit", "scan", "regs64"])
def test_fused_bitwise_tpch_layout_on_card(cuda, ename):
    """As TPC-H serving launches it: operands are row views of one
    (planes, 187538) tensor (odd rows 4 bytes off a 16-byte boundary), the
    result masked to the table's 6,001,215 rows."""
    if ename == "scan":
        expr = scan_expr(8, 37, 200, prefix="x")
        names = tuple(f"x{i}" for i in range(8))
    elif ename == "regs64":
        expr, names = regs64_expr()
    else:
        expr, names = EXPRS[ename], ("x", "y", "z")
    prog = kbw.lower(expr, names)
    if ename == "regs64":
        assert prog.n_regs == kbw.MAX_REGS
    rng = np.random.default_rng(len(names))
    views = list(words(rng, (len(names), 187538), cuda).unbind(0))
    for n_bits in (6_001_215, 6_001_215 - 31, None):
        got = kbw.fused_bitwise(expr, names, views, prog, n_bits=n_bits)
        assert torch.equal(got, kbw.fused_bitwise_plain(expr, names, views,
                                                        n_bits))


def test_tpch_epoch_past_the_parameter_table_on_card(cuda):
    """An epoch of 8-plane scans on row views, masked to the TPC-H rows,
    with more pointers than travel by value: one launch, exact."""
    expr = scan_expr(8, 37, 200, prefix="x")
    names = tuple(f"x{i}" for i in range(8))
    prog = kbw.lower(expr, names)
    rng = np.random.default_rng(45)
    q = kbw.PARAM_PTRS // (len(names) + 1) + 3
    operands = [list(words(rng, (8, 187538), cuda).unbind(0))
                for _ in range(q)]
    launches = kbw.fused_bitwise_stacked.launches
    outs = kbw.fused_bitwise_stacked(expr, names, operands, prog,
                                     n_bits=6_001_215)
    assert kbw.fused_bitwise_stacked.launches == launches + 1
    wants = kbw.fused_bitwise_stacked_plain(expr, names, operands, 6_001_215)
    assert all(torch.equal(g, w) for g, w in zip(outs, wants))


def test_binary_matmul_raises_on_what_it_does_not_take(cuda):
    a = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    b = torch.zeros((6, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        kbmm.binary_matmul(a.to(torch.int64), b, 256)
    with pytest.raises(ValueError):
        kbmm.binary_matmul(a[:, ::2], b[:, ::2], 128)
    with pytest.raises(ValueError):
        kbmm.binary_matmul(a, b.cpu(), 256)


def test_binary_lm_example_on_card(cuda):
    launches = kbmm.binary_matmul.launches
    assert binary_lm.main(cuda) > 0.5
    assert kbmm.binary_matmul.launches > launches


def test_serving_row_reproduced_on_card(cuda):
    """The committed serve_bitmap_pallas row, on the card's kernels."""
    with open(BENCH) as fh:
        rows = {r["name"]: r for r in json.load(fh)["rows"]}
    launches = kbw.fused_bitwise_stacked.launches
    got = port_serve_bitmaps(n_tenants=1024, n_queries=1100, n_users=4096,
                             n_items=12, max_batch=16, window_ns=50_000.0,
                             device=cuda)
    assert got == rows["serve_bitmap_pallas"]["derived"]
    assert kbw.fused_bitwise_stacked.launches > launches


def test_runtime_backends_agree_on_card(cuda):
    rng = np.random.default_rng(9)
    bits = rng.integers(0, 2, (3, 5000)).astype(bool)
    seen = []
    for backend in ("cuda", "torch"):
        rt = AmbitRuntime(backend=backend, device=cuda)
        a, b, c = (rt.put(BitVector.from_bits(v, device=cuda)) for v in bits)
        out = rt.eval(E.maj(X, ~Y, Z), {"x": a, "y": b, "z": c})
        out = rt.eval(X ^ Y, {"x": out, "y": a}, out=out)
        t = [rt.submit(X & Y, {"x": a, "y": v}) for v in (b, c)]
        rt.drain()
        seen.append((rt.popcount(out), rt.get(out).data.tolist(),
                     [rt.get(x.result).data.tolist() for x in t],
                     rt.metrics_snapshot()))
    assert seen[0] == seen[1]


def test_dram_model_on_card_equals_cpu(cuda):
    """The DRAM model's row state lives on the card: one random AAP/AP
    program over a batch-64 subarray, boot content included, and one
    ambit_sim eval leave the same bits and ledger as on the CPU."""
    import dataclasses
    from repro_torch.core import AmbitError, AmbitSubarray, BulkBitwiseEngine
    from repro_torch.core import commands as cmd
    from repro_torch.core.geometry import DRAMGeometry

    geom = DRAMGeometry(rows_per_subarray=32)
    rng = np.random.default_rng(21)
    srcs = [cmd.D(i) for i in range(geom.data_rows)] + [cmd.C(0), cmd.C(1)]
    dsts = [cmd.B(i) for i in range(16)] + srcs[:geom.data_rows]
    prog = [cmd.AP(cmd.B(12)) if rng.integers(5) == 0 else
            cmd.AAP(srcs[rng.integers(len(srcs))],
                    dsts[rng.integers(len(dsts))]) for _ in range(40)]
    seen = []
    for dev in ("cpu", cuda):
        sub = AmbitSubarray(geom, words=256, n_rows=64, seed=3, device=dev)
        errors = 0
        for m in prog:      # an undefined macro raises alike on both
            try:
                sub.run([m])
            except AmbitError:
                errors += 1
                sub._precharge()
        cells = [sub._d_row(d) for d in range(geom.data_rows)]
        cells += list(sub.t_rows.values()) + list(sub.dcc.values())
        seen.append((errors, dataclasses.astuple(sub.stats),
                     [c.cpu().tolist() for c in cells]))
    assert seen[0] == seen[1]
    bits = rng.integers(0, 2, (3, 16, 4000)).astype(bool)
    out = []
    for dev in ("cpu", cuda):
        eng = BulkBitwiseEngine("ambit_sim", device=dev)
        env = {k: BitVector.from_bits(b, device=dev)
               for k, b in zip("xyz", bits)}
        got = eng.eval(E.maj(X, Y, Z) ^ (X | ~Z), env)
        out.append((got.data.cpu().tolist(),
                    dataclasses.astuple(eng.last_stats)))
    assert out[0] == out[1]


def test_ambit_scan_stats_on_card_counts_through_the_kernels(cuda):
    """``ambit_scan_stats`` on a column on the card launches the scan and
    the popcount once each and gives the CPU's count and DRAM time."""
    from repro_torch.apps.bitweaving_db import (BitWeavingColumn,
                                                ambit_scan_stats)
    from repro_torch.core import BulkBitwiseEngine
    values = np.random.default_rng(8).integers(0, 256, 100_003)
    out = []
    for dev in ("cpu", cuda):
        col = BitWeavingColumn.from_values(values, 8, device=dev)
        eng = BulkBitwiseEngine("ambit_sim", device=dev)
        before = (kbv.bitweaving_scan.launches, kpc.popcount_rows.launches)
        out.append(ambit_scan_stats(col, 37, 200, eng))
        after = (kbv.bitweaving_scan.launches, kpc.popcount_rows.launches)
        assert [a - b for a, b in zip(after, before)] == (
            [1, 1] if dev == cuda else [0, 0])
    assert out[0] == out[1]
    assert out[1][0] == int(((values >= 37) & (values <= 200)).sum())
