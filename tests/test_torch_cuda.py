"""The port on the card: every kernel against its plain version, the
serving slice on backend "cuda" against the committed reference tokens,
the binary-LM example through the XNOR-popcount kernel, the DRAM
model and the PIM runtime on it with their rows on the card against the
CPU, and the LM path: the document filter through the scan kernel, the
reduced configs of every family on the card against the CPU, the MoE
bookkeeping through the popcount kernel, training: a reduced train
step against the CPU, the in-place update's memory, a checkpoint
restored onto the card, and the multi-device layer on a (1,1) mesh over
a one-rank NCCL group: the sharded train step and the MoE forward
against the mesh-free ones bit for bit, ``compressed_psum``,
``pipeline`` and a restore onto the mesh (collectives across more than
one rank are held on the CPU by tests/test_torch_distributed.py).

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


def _offset_words(rng, shape, offset, device):
    """Random words of ``shape`` starting ``offset`` bytes past a 16-byte
    boundary (a view into a larger allocation)."""
    n = int(np.prod(shape))
    base = words(rng, (n + 4,), device)
    assert base.data_ptr() % 16 == 0
    return base[offset // 4:offset // 4 + n].view(shape)


def test_fused_bitwise_ring_over_a_long_row_on_card(cuda):
    """A row long enough that every persistent block walks several tiles,
    its last tile ragged; operands 0, 4, 8 and 12 bytes past a 16-byte
    boundary, each its own; masked rows; then in place into an operand."""
    rng = np.random.default_rng(31)
    expr = scan_expr(8, 37, 200, prefix="x")
    names = tuple(f"x{i}" for i in range(8))
    prog = kbw.lower(expr, names)
    shape = (4, (1 << 22) + 37)          # 64 MB an operand, 16,385 tiles
    arrays = [_offset_words(rng, shape, 4 * k % 16, cuda)
              for k in range(8)]
    out = _offset_words(rng, shape, 4, cuda)
    for n_bits in (None, shape[-1] * 32 - 7):
        rings = kbw.fused_bitwise.ring_launches
        got = kbw.fused_bitwise(expr, names, arrays, prog, n_bits=n_bits,
                                out=out)
        assert kbw.fused_bitwise.ring_launches == rings + 1
        assert got is out and torch.equal(
            got, kbw.fused_bitwise_plain(expr, names, arrays, n_bits))
    want = kbw.fused_bitwise_plain(expr, names, arrays, 1000)
    got = kbw.fused_bitwise(expr, names, arrays, prog, n_bits=1000,
                            out=arrays[3])
    assert got is arrays[3] and torch.equal(got, want)


def test_fused_bitwise_stacked_ring_on_card(cuda):
    """An epoch whose (query, tile) pairs outnumber the resident blocks:
    16 queries of 512 tiles, operands at 4-byte offsets."""
    rng = np.random.default_rng(32)
    names = ("x", "y", "z")
    expr = EXPRS["maj"]
    prog = kbw.lower(expr, names)
    operands = [[_offset_words(rng, (1, 524288), (4 * (q + k)) % 16, cuda)
                 for k in range(3)] for q in range(16)]
    rings = kbw.fused_bitwise_stacked.ring_launches
    outs = kbw.fused_bitwise_stacked(expr, names, operands, prog,
                                     n_bits=524288 * 32 - 9)
    assert kbw.fused_bitwise_stacked.ring_launches == rings + 1
    wants = kbw.fused_bitwise_stacked_plain(expr, names, operands,
                                            524288 * 32 - 9)
    assert all(torch.equal(g, w) for g, w in zip(outs, wants))


# column widths of a four-column conjunction of n planes (38: the Star
# Schema's Q4.2/Q4.3: two cities, order date, brand)
WIDE_COLUMNS = {33: (12, 8, 7, 6), 38: (8, 8, 12, 10), 48: (12, 12, 12, 12)}


@pytest.mark.parametrize("n", sorted(WIDE_COLUMNS))
def test_wide_program_alone_and_as_a_stacked_epoch_on_card(cuda, n):
    """Programs of more loads than the producer warp has lanes: alone over
    row views of (bits, words) columns (the deployment's planes, 0-12
    bytes off 16), masked, and as a 16-query epoch whose pointers
    outnumber the by-value table; each one launch on the wide route,
    exact."""
    rng = np.random.default_rng(n)
    expr, names, columns = None, [], []
    for k, bits in enumerate(WIDE_COLUMNS[n]):
        expr_k = scan_expr(bits, 3 + k, (1 << bits) - 9 + k,
                           prefix=f"c{k}_b")
        expr = expr_k if expr is None else expr & expr_k
        names += [f"c{k}_b{i}" for i in range(bits)]
        columns.append(words(rng, (bits, 187_539), cuda))
    planes = dict(zip(names, [p for c in columns for p in c.unbind(0)]))
    names = tuple(sorted(names))
    prog = kbw.lower(expr, names)
    assert prog.n_loads == n > kbw.WARP_LOADS
    n_bits = 187_539 * 32 - 13
    arrays = [planes[nm] for nm in names]
    before = (kbw.fused_bitwise.launches, kbw.fused_bitwise.wide_launches)
    got = kbw.fused_bitwise(expr, names, arrays, prog, n_bits=n_bits)
    assert (kbw.fused_bitwise.launches, kbw.fused_bitwise.wide_launches) \
        == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, kbw.fused_bitwise_plain(expr, names, arrays,
                                                    n_bits))
    # the epoch: query q reads its own planes at its own offsets, every
    # fourth query the deployment's (a repeated dashboard query)
    operands = [arrays if q % 4 == 0 else
                [_offset_words(rng, (187_539,), 4 * (q + k) % 16, cuda)
                 for k in range(n)] for q in range(16)]
    assert not kbw.by_value(prog, len(operands))
    st = kbw.fused_bitwise_stacked
    before = (st.launches, st.wide_launches, st.table_launches)
    outs = kbw.fused_bitwise_stacked(expr, names, operands, prog,
                                     n_bits=n_bits)
    assert (st.launches, st.wide_launches, st.table_launches) == \
        tuple(b + 1 for b in before)
    wants = kbw.fused_bitwise_stacked_plain(expr, names, operands, n_bits)
    assert all(torch.equal(g, w) for g, w in zip(outs, wants))
    assert torch.equal(outs[0], got) and torch.equal(outs[4], got)


def test_fused_bitwise_tail_mask_every_remainder_on_card(cuda):
    """n_bits at every remainder mod 32 of rows that end mid-tile and on
    row views off a 16-byte boundary."""
    rng = np.random.default_rng(33)
    expr, names = EXPRS["not"], ("x", "y", "z")
    prog = kbw.lower(expr, names)
    planes = list(words(rng, (3, 5 * 1031), cuda).view(3, 5, 1031)
                  .unbind(0))
    views = list(words(rng, (3, 6, 999), cuda).unbind(0))[1:] + \
        [_offset_words(rng, (6, 999), 12, cuda)]
    for arrays in (planes, views):
        row = arrays[0].shape[-1] * 32
        for r in range(32):
            got = kbw.fused_bitwise(expr, names, arrays, prog,
                                    n_bits=row - 32 - r)
            assert torch.equal(got, kbw.fused_bitwise_plain(
                expr, names, arrays, row - 32 - r)), r


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


# -- the PIM runtime on the DRAM model, row state on the card -----------------


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pim_session(device, devices):
    """put / eval / drain / get / popcount / spill / fault-in on the DRAM
    model, one device or a cluster; returns what it observed."""
    import dataclasses
    rng = np.random.default_rng(12)
    bits = rng.integers(0, 2, (3, 6000)).astype(bool)
    rt = AmbitRuntime(banks=2, subarrays=2, words=8, devices=devices,
                      seed=4, device=device)
    hs = [rt.put(BitVector.from_bits(b, device=device), name=f"v{i}")
          for i, b in enumerate(bits)]
    out = rt.eval(E.maj(X, ~Y, Z) ^ (X | Y), dict(zip("xyz", hs)))
    seen = [rt.get(out).data.cpu().tolist(), rt.popcount(out)]
    ts = [rt.submit(e, dict(zip("xyz", hs)))
          for e in (X & Y, (X & Y) | Z, ~(X & Y) ^ Z)]
    rt.drain(optimize=True)
    seen += [rt.get(t.result).data.cpu().tolist() for t in ts]
    rt.store.spill(hs[0])
    again = rt.xor(hs[0], hs[1])
    seen += [rt.get(again).data.cpu().tolist(),
             dataclasses.astuple(rt.session_stats),
             dataclasses.astuple(rt.last_drain),
             rt.metrics_snapshot()]
    assert rt.device.device.type == torch.device(device).type
    return seen


@pytest.mark.parametrize("devices", [1, 3])
def test_pim_runtime_on_card_equals_cpu(cuda, devices):
    """The PIM runtime with its rows on the card leaves the CPU run's
    bits, ledgers and metrics, bit for bit."""
    assert _pim_session(cuda, devices) == _pim_session("cpu", devices)


def test_tmr_scrub_on_card_equals_cpu(cuda):
    """Protected queries under transient flips and weak cells: the
    parity checks and scrubs vote on the card and give the CPU's bits,
    ledger string and scrub counters."""
    from repro_torch.pim.faults import FaultConfig, FaultInjector
    out = []
    for dev in ("cpu", cuda):
        rng = np.random.default_rng(4)
        raw = [rng.integers(0, 2, 2048).astype(bool) for _ in range(4)]
        inj = FaultInjector(FaultConfig(seed=7, transient_rate=0.05,
                                        weak_bit_rate=1e-3), device=dev)
        rt = AmbitRuntime(banks=4, subarrays=2, words=2, devices=2,
                          fault_injector=inj, device=dev)
        hp = [rt.put(BitVector.from_bits(v, device=dev), protect=True)
              for v in raw]
        got = []
        for k in range(6):
            i, j = k % 4, (k + 1) % 4
            r = rt.eval(X ^ Y, {"x": hp[i], "y": hp[j]})
            b = rt.get(r).bits().cpu().numpy()
            assert np.array_equal(b, raw[i] ^ raw[j])
            got.append(b.tolist())
            rt.free(r)
        counters = rt.metrics_snapshot()["counters"]
        assert counters.get("scrub_corrections", 0) > 0
        out.append((got, inj.ledger(), counters))
    assert out[0] == out[1]


def _port_api(device):
    import repro_torch.core as core
    import repro_torch.pim as pim
    import repro_torch.pim.faults as faults
    import repro_torch.serve as serve
    return _chip_smoke().PimApi(core, pim, faults, serve, device=device)


def test_optimized_drain_on_cuda_launches_the_stacked_kernel(cuda):
    """``drain(optimize=True)`` on backend "cuda": the TPC-H optimizer mix
    equals its CPU run, and its scratch tickets and rewritten programs
    launch ``fused_bitwise`` and ``fused_bitwise_stacked``."""
    cs = _chip_smoke()
    want = cs.optimizer_session(_port_api("cpu"), backend="cuda")
    before = (kbw.fused_bitwise.launches, kbw.fused_bitwise_stacked.launches)
    got = cs.optimizer_session(_port_api("cuda"), backend="cuda")
    after = (kbw.fused_bitwise.launches, kbw.fused_bitwise_stacked.launches)
    assert got == want and got["mismatches"] == 0
    assert after[0] > before[0] and after[1] > before[1]


def test_host_fallback_launches_fused_bitwise(cuda):
    """After a device loss the frontend serves both queries from host
    copies through ``BulkBitwiseEngine("cuda")`` on the card."""
    cs = _chip_smoke()
    before = kbw.fused_bitwise.launches
    out = cs.fallback_session(_port_api("cuda"))
    assert (out["fallbacks"], out["mismatches"]) == (2, 0)
    assert out["engine"] == ("cuda", "cuda")
    assert kbw.fused_bitwise.launches - before == 2


@pytest.mark.parametrize("n", [33, 5003, 1 << 20, (1 << 20) + 17])
def test_filter_documents_on_card_launches_the_scan_twice(cuda, n):
    """The LM data path's document filter: two ``bitweaving_scan``
    launches on the card, the mask equal to the plain scan's and to
    numpy's, at document counts that are not a multiple of 32 too."""
    from repro_torch.data import pipeline
    meta = pipeline.synth_corpus_meta(n, seed=n)
    before = kbv.bitweaving_scan.launches
    got = pipeline.filter_documents(meta, 64, 250, 256, device=cuda)
    assert kbv.bitweaving_scan.launches - before == 2
    plain = pipeline.filter_documents(meta, 64, 250, 256, use_kernel=False,
                                      device=cuda)
    q, ln = meta.quality, meta.length
    want = (q >= 64) & (q <= 250) & (ln >= 256)
    assert got.shape == (n,) and np.array_equal(got, want)
    assert np.array_equal(plain, want)


def test_reduced_qwen_on_card_matches_cpu(cuda):
    """A reduced qwen2.5-3b on the card against the CPU port on the same
    weights: prefill, four teacher-forced decode steps, and the card's
    decode against its own forward."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("qwen2.5-3b").reduced()
    model = build_model(cfg)
    cpu = model.init(0, device="cpu")
    card = _tree_to(cpu, cuda)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 20))
                            .astype(np.int32))

    def run(params, dev):
        t = toks.to(dev)
        out = [model.forward(params, {"tokens": t})[0][:, 16:]]
        logits, caches = model.prefill(params, {"tokens": t[:, :16]},
                                       skv=20)
        out.append(logits)
        for i in range(4):
            logits, caches = model.decode_step(
                params, caches, {"tokens": t[:, 16 + i:17 + i],
                                 "pos": torch.full((2,), 16 + i,
                                                   dtype=torch.int32,
                                                   device=dev)})
            out.append(logits)
        return [o.float().cpu() for o in out]

    want, got = run(cpu, "cpu"), run(card, cuda)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert float((g - w).abs().max() / w.abs().max()) <= 5e-2
    for i in range(4):
        fwd = got[0][:, i]
        assert float((got[2 + i] - fwd).abs().max() / fwd.abs().max()) < 1e-1


def _chip_smoke():
    """``chip_smoke.py`` as a module (its batch builders)."""
    import importlib.util
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _prefill_and_decode(model, params, toks, extra, dev, prompt=16,
                        steps=4):
    """Forward logits past the prompt, prefill logits (over the batch's
    first ``prompt`` positions: ``chip_smoke.prompt_part``) and ``steps``
    teacher-forced decode logits, on the CPU as float32."""
    t = toks.to(dev)
    ex = dict({k: v.to(dev) for k, v in extra.items()}, tokens=t)
    out = [model.forward(params, ex)[0][:, prompt:]]
    logits, caches = model.prefill(
        params, _chip_smoke().prompt_part(ex, prompt), skv=prompt + steps)
    out.append(logits)
    for i in range(steps):
        logits, caches = model.decode_step(
            params, caches, {"tokens": t[:, prompt + i:prompt + i + 1],
                             "pos": torch.full((t.shape[0],), prompt + i,
                                               dtype=torch.int32,
                                               device=dev)})
        out.append(logits)
    return [o.float().cpu() for o in out]


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "qwen3-moe-235b-a22b", "mamba2-780m",
                                  "whisper-small"])
def test_reduced_family_on_card_matches_cpu(cuda, arch):
    """The reduced MoE, SSM and encoder-decoder configs on the card
    against the CPU port on the same weights: forward, prefill and four
    teacher-forced decode steps within 5e-2 max-rel."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    cpu = model.init(0, device="cpu")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 20))
                            .astype(np.int32))
    extra = {}
    if cfg.enc_dec:
        extra["frames"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_frames, cfg.d_model)).astype(np.float32))
    want = _prefill_and_decode(model, cpu, toks, extra, "cpu")
    got = _prefill_and_decode(model, _tree_to(cpu, cuda), toks, extra,
                              cuda)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert float((g - w).abs().max() / w.abs().max()) <= 5e-2


def test_reduced_vlm_image_grid_on_card_matches_cpu(cuda):
    """The reduced qwen2-vl on ``chip_smoke.py``'s VLM batch
    (``lm_batch``: image embeddings on a grid of M-RoPE positions whose
    three streams differ) on the card against the CPU port on the same
    weights: forward, prefill and four decode steps within 5e-2, and the
    card's decode within 1e-1 of its forward."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("qwen2-vl-7b").reduced()
    model = build_model(cfg)
    cpu = model.init(0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _chip_smoke().lm_batch(
        cfg, 2, 20, prompt=16, seed=1).items()}
    assert len({tuple(r) for r in batch["mrope_positions"][:, 0, :8]
                .tolist()}) == 3
    toks = batch.pop("tokens")
    want = _prefill_and_decode(model, cpu, toks, batch, "cpu")
    got = _prefill_and_decode(model, _tree_to(cpu, cuda), toks, batch, cuda)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert float((g - w).abs().max() / w.abs().max()) <= 5e-2
    for i in range(4):
        fwd = got[0][:, i]
        assert float((got[2 + i] - fwd).abs().max() / fwd.abs().max()) < 1e-1


def test_reduced_gemma3_on_card_matches_cpu_layer_by_layer(cuda):
    """gemma3's reduced stack is chaotic at its init (see
    tests/test_torch_models.py): each of its twelve layers (window 32, a
    global layer every 6) runs on the card from the CPU's input to that
    layer over 40 tokens, in forward, prefill (with its k and v caches)
    and four decode steps past the window on the CPU's caches, and
    agrees with the CPU within 5e-2."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tt
    cfg = get_config("gemma3-1b").reduced()
    cpu = build_model(cfg).init(0, device="cpu")
    card = _tree_to(cpu, cuda)
    s, steps = 40, 4
    skv = s + steps
    assert cfg.sliding_window < s
    toks = torch.from_numpy(_chip_smoke().lm_batch(
        cfg, 2, skv, prompt=s, seed=1)["tokens"])
    scalars = tt._layer_scalars(cfg, skv)
    cl = tt._WHOLE_CACHE._replace(skv=skv)

    def rel(g, w):
        return float((g.float().cpu() - w.float()).abs().max()
                     / w.float().abs().max())

    def layer(params, i, x, dev, phase, kc=None, vc=None, pos=None):
        """Layer i on ``dev`` from ``x``: its output and (prefill, decode)
        its k and v caches."""
        lp = tt._layer(params["layers"], i)
        window, theta = scalars[i]
        x = x.to(dev)
        if phase == "decode":
            pos = pos.to(dev)
            y, kc, vc = tt._decode_attn(lp, cfg, x, kc.to(dev), vc.to(dev),
                                        pos, pos[:, None], theta, window,
                                        cl, None)
            return tt._ffn_layer(lp, cfg, tt._residual(x, y)), kc, vc
        n = x.shape[1]
        positions = torch.arange(n, device=dev)[None].expand(2, n)
        if phase == "forward":
            return tt._train_layer(lp, cfg, x, positions, theta, window,
                                   1024)[:1]
        x, k, v = tt._attn_block(lp, cfg, x, positions, theta, window, 1024)
        k, v = tt._kv_cache(lp["attn"], cfg, k, v, n, skv, tt._WHOLE_CACHE,
                            None)
        return tt._ffn_layer(lp, cfg, x), k, v

    caches = None
    for phase, n in (("forward", skv), ("prefill", s)):
        x = tt._embed_in(cpu, cfg, {"tokens": toks[:, :n]})
        new = []
        for i in range(cfg.n_layers):
            want = layer(cpu, i, x, "cpu", phase)
            got = layer(card, i, x, cuda, phase)
            for g, w in zip(got, want):
                assert rel(g, w) <= 5e-2, (phase, i)
            new.append(want[1:])
            x = want[0]
        caches = new if phase == "prefill" else caches
    for step in range(steps):
        pos = torch.full((2,), s + step, dtype=torch.int32)
        x = tt._scale_embed(cfg, tt.embed(cpu, toks[:, s + step:s + step + 1]))
        new = []
        for i, (kc, vc) in enumerate(caches):
            want = layer(cpu, i, x, "cpu", "decode", kc, vc, pos)
            got = layer(card, i, x, cuda, "decode", kc, vc, pos)
            for g, w in zip(got, want):
                assert rel(g, w) <= 5e-2, (step, i)
            new.append(want[1:])
            x = want[0]
        caches = new


def test_reduced_zamba2_on_card_matches_cpu_group_by_group(cuda):
    """zamba2's reduced stack is chaotic at its init (see
    tests/test_torch_models.py): each group of six SSM layers and the
    shared block after it runs on the card from the CPU's input to that
    group, in forward, prefill (with its caches) and a decode step, and
    agrees with the CPU within 5e-2."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tt
    cfg = get_config("zamba2-2.7b").reduced()
    cpu = build_model(cfg).init(0, device="cpu")
    card = _tree_to(cpu, cuda)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16))
                            .astype(np.int32))
    per = cfg.shared_attn_every

    def rel(g, w):
        return float((g.float().cpu() - w.float()).abs().max()
                     / w.float().abs().max())

    def group(params, x, g, dev, **kw):
        """Group g on device ``dev`` from ``x``: (x, ssm caches, k, v)."""
        x = x.to(dev)
        caches = []
        for i in range(g * per, (g + 1) * per):
            layer_kw = dict(kw)
            if "caches" in kw:
                layer_kw = {"cache": _tree_to(tt._layer(kw["caches"], i),
                                              dev)}
            out = tt._ssm_layer(tt._layer(params["layers"], i), cfg, x,
                                **layer_kw)
            x, c = out if isinstance(out, tuple) else (out, None)
            caches.append(c)
        n = x.shape[1]
        if "caches" in kw:
            pos = torch.full((2,), 16, dtype=torch.int32, device=dev)
            kv = tuple(a[g].to(dev) for a in (kw["kv"]["k"], kw["kv"]["v"]))
            x, (k, v) = tt._shared_block(params["shared"], cfg, x,
                                         pos[:, None], 1024, kv_cache=kv,
                                         pos=pos)
        else:
            pos = torch.arange(n, device=dev)[None].expand(2, n)
            x, (k, v) = tt._shared_block(params["shared"], cfg, x, pos, 1024)
        return x, caches, k, v

    x = tt._embed_in(cpu, cfg, {"tokens": toks})
    for kw in ({}, {"return_cache": True}):
        xc = x
        for g in range(cfg.n_layers // per):
            want = group(cpu, xc, g, "cpu", **kw)
            got = group(card, xc, g, cuda, **kw)
            assert rel(got[0], want[0]) <= 5e-2
            assert rel(got[2], want[2]) <= 5e-2
            for gc, wc in zip(got[1], want[1]):
                for key in (wc or {}):
                    assert rel(gc[key], wc[key]) <= 5e-2, key
            xc = want[0]
    _, caches = build_model(cfg).prefill(cpu, {"tokens": toks}, skv=20)
    xd = tt.embed(cpu, torch.from_numpy(rng.integers(0, cfg.vocab, (2, 1))
                                        .astype(np.int32)))
    for g in range(cfg.n_layers // per):
        kw = {"caches": caches["ssm"], "kv": caches["shared"]}
        want = group(cpu, xd, g, "cpu", **kw)
        got = group(card, xd, g, cuda, **kw)
        assert rel(got[0], want[0]) <= 5e-2
        xd = want[0]


def test_expert_bitmask_stats_on_card_launches_popcount_once(cuda):
    """The MoE bookkeeping on the card: ``engine=BulkBitwiseEngine("cuda")``
    is one ``popcount_rows`` launch, its loads equal the ``"torch"``
    engine's and a bincount, its masks the same words."""
    from repro_torch.core import BulkBitwiseEngine
    from repro_torch.models import moe
    rng = np.random.default_rng(2)
    idx = torch.from_numpy(np.stack([rng.choice(40, 8, replace=False)
                                     for _ in range(1024)])).to(cuda)
    before = kpc.popcount_rows.launches
    masks, loads = moe.expert_bitmask_stats(
        idx, 40, engine=BulkBitwiseEngine("cuda", device=cuda))
    assert kpc.popcount_rows.launches - before == 1
    plain, plain_loads = moe.expert_bitmask_stats(idx, 40)
    assert kpc.popcount_rows.launches - before == 1
    assert loads.tolist() == plain_loads.tolist() == np.bincount(
        idx.cpu().numpy().reshape(-1), minlength=40).tolist()
    assert torch.equal(masks.data, plain.data)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def test_reduced_train_step_on_card_matches_cpu(cuda):
    """One reduced qwen2.5-3b train step on the card against the CPU port
    on the same state and batch: finite, the same shapes, the loss within
    5e-3 and every gradient leaf within 5e-2 norm-relative (the bounds of
    ``chip_smoke.py`` phase 10(a)), then the same update."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_leaves
    from repro_torch.optim.optimizer import OptimizerConfig, global_norm
    from repro_torch.train import step as train_step
    cfg = get_config("qwen2.5-3b").reduced()
    model = build_model(cfg)
    cpu = train_step.init_state(model, 0, device="cpu")
    card = _tree_to(cpu, cuda)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (2, 33)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "labels": torch.from_numpy(toks[:, 1:].copy())}
    loss_fn = train_step.make_loss_fn(model)
    (want, _), want_g = train_step.value_and_grad(loss_fn, cpu["params"],
                                                  batch)
    (got, _), got_g = train_step.value_and_grad(loss_fn, card["params"],
                                                _tree_to(batch, cuda))
    assert abs(float(got) - float(want)) <= 5e-3 * abs(float(want))
    for g, w in zip(tree_leaves(got_g), tree_leaves(want_g)):
        assert g.shape == w.shape and g.device.type == "cuda"
        assert torch.isfinite(g).all()
        assert float((g.cpu() - w).norm() / w.norm()) <= 5e-2
    assert abs(float(global_norm(got_g)) / float(global_norm(want_g)) - 1) \
        <= 5e-2
    step = train_step.make_train_step(model, OptimizerConfig(total_steps=10))
    new_card, m = step(card, _tree_to(batch, cuda))
    new_cpu, _ = step(cpu, batch)
    assert np.isfinite(float(m["loss"]))
    for g, w in zip(tree_leaves(new_card), tree_leaves(new_cpu)):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.isfinite(g).all()


def test_update_in_place_keeps_one_state_on_card(cuda):
    """``optim.update`` writes the new parameters and moments into the
    state's own tensors: the peak memory rises by less than one more
    copy of (params, m, v), which a functional update would allocate."""
    from repro_torch.models.param import tree_leaves
    from repro_torch.optim import optimizer as opt
    gen = torch.Generator(cuda).manual_seed(0)
    params = {f"w{i}": torch.randn(1 << 22, generator=gen, device=cuda)
              for i in range(16)}
    grads = {k: torch.randn(v.shape, generator=gen, device=cuda)
             for k, v in params.items()}
    state = opt.init(params)
    ids = [id(t) for t in tree_leaves({"p": params, "o": state})]
    one_state = 3 * sum(p.numel() * 4 for p in params.values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    new_p, new_o, _ = opt.update(opt.OptimizerConfig(), grads, state, params)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - before
    assert [id(t) for t in tree_leaves({"p": new_p, "o": new_o})] == ids
    assert rise < one_state, (rise, one_state)
    assert int(new_o["step"]) == 1


def test_checkpoint_restore_lands_on_card(cuda, tmp_path):
    """A checkpoint saved from the card restores onto the card by default,
    bit for bit, and onto the CPU when asked."""
    from repro_torch.checkpoint import Checkpointer
    tree = {"w": torch.randn(5, 3, device=cuda),
            "h": torch.randn(4, device=cuda).to(torch.bfloat16),
            "opt": {"step": torch.tensor(7, dtype=torch.int32, device=cuda)}}
    ck = Checkpointer(str(tmp_path))
    ck.save(7, tree)
    ck.wait()
    step, got = ck.restore()
    assert step == 7
    assert got["w"].device.type == "cuda" and torch.equal(got["w"], tree["w"])
    assert got["h"].dtype == torch.bfloat16 and torch.equal(got["h"],
                                                            tree["h"])
    assert torch.equal(got["opt"]["step"], tree["opt"]["step"])
    assert ck.restore(device="cpu")[1]["w"].device.type == "cpu"


def test_one_rank_nccl_mesh_train_step_on_card(cuda):
    """A reduced qwen2.5-3b ``make_train_step(mesh=)`` on a (1,1) mesh
    over a one-rank NCCL group, from ``init_state(mesh=)``, equals the
    mesh-free step on the card bit for bit (``chip_smoke.py`` phase
    11(a) at full width)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_leaves
    from repro_torch.optim.optimizer import OptimizerConfig
    from repro_torch.train import step as train_step
    from torch_dist_ranks import one_rank_mesh, whole
    cfg = get_config("qwen2.5-3b").reduced()
    model = build_model(cfg)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 33))
                            .astype(np.int32)).to(cuda)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    opt_cfg = OptimizerConfig(total_steps=10)
    want, wm = train_step.make_train_step(model, opt_cfg)(
        train_step.init_state(model, 0, device=cuda), batch)
    with one_rank_mesh("cuda") as mesh:
        assert mesh.device_type == "cuda"
        got, gm = train_step.make_train_step(model, opt_cfg, mesh=mesh)(
            train_step.init_state(model, 0, device=cuda, mesh=mesh), batch)
        got = [whole(t) for t in tree_leaves(got)]
    for k in wm:
        assert torch.equal(gm[k], wm[k]), k
    for a, b in zip(got, tree_leaves(want)):
        assert a.device.type == "cuda" and torch.equal(a, b)


def test_one_rank_nccl_mesh_moe_forward_on_card(cuda):
    """Reduced granite-moe ``Model.forward(mesh=)`` on sharded parameters
    equals the mesh-free forward on the card bit for bit (the logits come
    back as a DTensor)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.param import ShardingRules
    from repro_torch.models.sharding_ctx import distribute, mesh_shape_dict
    from torch_dist_ranks import one_rank_mesh, whole
    cfg = get_config("granite-moe-3b-a800m").reduced()
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, 24)).astype(np.int32)).to(cuda)
    want, want_aux = model.forward(params, {"tokens": toks})
    with one_rank_mesh("cuda") as mesh:
        got, got_aux = model.forward(distribute(params, mesh, model.param_specs(
            ShardingRules(), mesh_shape_dict(mesh))), {"tokens": toks},
            mesh=mesh)
        got = whole(got)
    assert torch.equal(got, want) and torch.equal(got_aux, want_aux)


def test_one_rank_nccl_mesh_pieces_on_card(cuda, tmp_path):
    """``compressed_psum`` over the one-rank group is ``q*s/1`` bit for
    bit; ``pipeline`` with one stage is the stage on each microbatch
    (1e-5) with a finite nonzero gradient; a checkpoint saved without a
    mesh restores onto the mesh as DTensors bit for bit."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.models.param import PartitionSpec as P
    from repro_torch.runtime.pipeline import pipeline
    from repro_torch.train.compression import compressed_psum
    from torch_dist_ranks import one_rank_mesh
    gen = torch.Generator(cuda).manual_seed(0)
    q = torch.randint(-127, 128, (333,), generator=gen, device=cuda,
                      dtype=torch.int8)
    s = torch.rand((), generator=gen, device=cuda)
    w = torch.randn((1, 16, 16), generator=gen, device=cuda) \
        .requires_grad_()
    x = torch.randn((5, 3, 16), generator=gen, device=cuda)
    tree = {"w": torch.randn((8, 4), generator=gen, device=cuda),
            "step": torch.tensor(2, dtype=torch.int32, device=cuda)}
    ck = Checkpointer(str(tmp_path))
    ck.save(2, tree, blocking=True)
    with one_rank_mesh("cuda") as mesh:
        got = compressed_psum({"g": q}, {"g": s}, "model", 1, mesh=mesh)
        assert torch.equal(got["g"], q.to(torch.float32) * s / 1)
        out = pipeline(lambda p, h: torch.tanh(h @ p["w"]), {"w": w}, x,
                       mesh, axis="data")
        want = torch.stack([torch.tanh(x[m] @ w[0]) for m in range(5)])
        torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
        (gw,) = torch.autograd.grad((out ** 2).sum(), [w])
        assert torch.isfinite(gw).all() and float(gw.abs().sum()) > 0
        step, back = ck.restore(mesh=mesh, spec_tree={"w": P("data", None)})
        assert step == 2 and hasattr(back["w"], "placements")
        assert torch.equal(back["w"].full_tensor(), tree["w"])
        assert torch.equal(back["step"], tree["step"])
