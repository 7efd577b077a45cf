"""The port on the card: every kernel against its plain version, and the
serving slice on backend "cuda" against the committed reference tokens.

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
from repro_torch.core import BitVector, Expr
from repro_torch.core import expr as E
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
    hs = {k: rt.put(BitVector.from_bits(v), name=k) for k, v in raw.items()}
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


@pytest.mark.parametrize("b", [1, 4, 12, 32])
def test_bitweaving_scan_matches_plain_on_card(cuda, b):
    rng = np.random.default_rng(b)
    top = (1 << b) - 1
    for n_words in (7, 187538, 524288):
        planes = words(rng, (b, n_words), cuda)
        for c1, c2 in ((0, top), (0, 0), (top, top), (top // 3, top // 2)):
            assert torch.equal(kbv.bitweaving_scan(planes, c1, c2),
                               kbv.bitweaving_scan_plain(planes, c1, c2))


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
