#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order (any failed check raises and the script exits non-zero
without printing the result line):

1. environment: the card's name and power limit, and the build of every
   CUDA kernel from ``src/repro_torch/kernels/csrc``;
2. every kernel against its plain PyTorch version on the card, at the
   main path's shapes and at ragged ones, exactly; then each kernel's
   time per launch (CUDA events, median, L2 flushed before each launch)
   beside its plain version's, a one-call PyTorch yardstick where one
   exists, and the least time the card could take;
3. the serving main path at full width on backend "cuda": a 2^24-user
   bitmap index served to 1024 Zipfian tenants through QueryFrontend,
   the weekly-active query, and the TPC-H lineitem table at scale factor
   1 (6,001,215 rows) served the same way, every answer checked against
   numpy; kernel launch counts are read for this phase alone;
4. one ``{"kernels": [...]}`` JSON line, then the result line.

Imports nothing of the JAX package and needs no network.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
# The data sheet's float32 rate outside the tensor cores. It publishes no
# int32 rate; the card's integer logic issues no faster than its float32
# pipe, so time at this rate is a floor for the kernels' integer ops.
FP32_OPS_PER_S = 67e12
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str):
    raise RuntimeError(msg)


# -- phase 1 ------------------------------------------------------------------


def environment(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    log(card)                   # as nvidia-smi prints it
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"build: {len(logs)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in sorted(logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")
    return card


# -- phase 2 ------------------------------------------------------------------


class Timer:
    """Per-launch times, median over ``reps``, the L2 cache flushed
    before each launch (the serving path's operands are 2 MB each, so a
    warm L2 would hold them).

    ``device``: CUDA events around each launch while it waits behind a
    sleep kernel that outlasts its enqueue, so the events bracket device
    work only.
    ``launch``: the same events around one launch issued to an idle
    stream, so the host's launch path (Python, ctypes, allocation) counts
    too - what one serving step pays."""

    def __init__(self, torch, reps: int = 30):
        self.torch = torch
        self.reps = reps
        self.flush_buf = torch.empty(64 << 20, dtype=torch.int8,
                                     device="cuda")

    def _events(self):
        t = self.torch
        return (t.cuda.Event(enable_timing=True),
                t.cuda.Event(enable_timing=True))

    def __call__(self, fn):
        torch = self.torch
        fn()                                    # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()                                    # host cost of one launch
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        # one launch at a time behind a sleep (in SM clock cycles, at most
        # 1.98 GHz on an H100) four times the host's enqueue time; a
        # sample whose enqueue outlasted its sleep is dropped
        sleep_s = 4 * host_s + 2e-3
        device = []
        for _ in range(self.reps):
            self.flush_buf.zero_()
            a, b = self._events()
            t0 = time.perf_counter()
            torch.cuda._sleep(int(sleep_s * 1.98e9))
            a.record()
            fn()
            b.record()
            enqueue_s = time.perf_counter() - t0
            b.synchronize()
            if enqueue_s < sleep_s:
                device.append(a.elapsed_time(b))
        if len(device) < self.reps // 2:
            fail(f"timer: only {len(device)} of {self.reps} launches were "
                 "enqueued inside their sleep")
        device = statistics.median(device)
        launch = []
        for _ in range(self.reps):
            self.flush_buf.zero_()
            torch.cuda.synchronize()
            a, b = self._events()
            a.record()
            fn()
            b.record()
            b.synchronize()
            launch.append(a.elapsed_time(b))
        return device, statistics.median(launch)


def _rand_words(torch, rng, shape, device="cuda"):
    w = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64)
    return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(device)


def _same(torch, got, want, what, kernel, stats):
    """Hold ``got`` (the kernel's) against ``want`` (the plain version's)
    exactly; record the check and the largest absolute difference of the
    values as stored (int32 words or counts) under ``kernel``."""
    if got.shape != want.shape:
        fail(f"{what}: kernel shape {tuple(got.shape)} != plain "
             f"{tuple(want.shape)}")
    err = (got.long() - want.long()).abs().max().item() if got.numel() else 0
    entry = stats.setdefault(kernel, {"checks": 0, "max_abs_err": 0})
    entry["checks"] += 1
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    if err:
        diff = (got != want).sum().item()
        fail(f"{what}: kernel != plain version in {diff} words")


def check_kernels(torch):
    """Every kernel against its plain version on the card, exactly.
    Returns kernel name -> {"checks", "max_abs_err"} (0 when all agree)."""
    from repro_torch.apps.bitweaving_db import scan_expr
    from repro_torch.core import expr as E
    from repro_torch.core.engine import BulkBitwiseEngine
    from repro_torch.core.bitvector import BitVector
    from repro_torch.kernels import bitweaving as kbv
    from repro_torch.kernels import bitwise as kbw
    from repro_torch.kernels import popcount as kpc

    rng = np.random.default_rng(SEED)
    X, Y, Z = E.Expr.var("x"), E.Expr.var("y"), E.Expr.var("z")
    exprs = {
        "and": X & Y,
        "maj": E.maj(X, ~Y, Z),
        "not": ~(X ^ Z),
        # raw constructor: keep the literals in the DAG (no folding)
        "lit": E.Expr("or", (E.Expr("and", (X, E.ONE)),
                             E.Expr("xor", (Y, E.ZERO)))),
        "scan": scan_expr(8, 37, 200, prefix="x"),
    }
    shapes = [(1, 524288), (1, 7), (129,), (2, 3, 40), (257, 8), (187538,)]
    stats: dict = {}
    fb, fbs = "fused_bitwise", "fused_bitwise_stacked"
    for ename, expr in exprs.items():
        names = tuple(sorted({n.name for n in E.topo_order(expr)
                              if n.op == "var"}))
        prog = kbw.lower(expr, names)
        for shape in shapes:
            arrays = [_rand_words(torch, rng, shape) for _ in names]
            for n_bits in (None, shape[-1] * 32 - 5):
                got = kbw.fused_bitwise(expr, names, arrays, prog,
                                        n_bits=n_bits)
                want = kbw.fused_bitwise_plain(expr, names, arrays, n_bits)
                _same(torch, got, want, f"fused_bitwise {ename} {shape}",
                      fb, stats)
            # unaligned operands take the scalar path
            base = [_rand_words(torch, rng, (int(np.prod(shape)) + 1,))
                    for _ in names]
            views = [b[1:].reshape(shape) for b in base]
            got = kbw.fused_bitwise(expr, names, views, prog)
            want = kbw.fused_bitwise_plain(expr, names, views)
            _same(torch, got, want, f"fused_bitwise {ename} {shape} unaligned",
                  fb, stats)
            # in place into the first operand (out= rebind)
            want = kbw.fused_bitwise_plain(expr, names, arrays, 100)
            got = kbw.fused_bitwise(expr, names, arrays, prog, n_bits=100,
                                    out=arrays[0])
            _same(torch, got, want, f"fused_bitwise {ename} {shape} in place",
                  fb, stats)
        # q=50 of the 8-plane scan passes 450 pointers: the device table
        for q, shape in ((16, (1, 524288)), (3, (2, 3, 40)), (5, (129,)),
                         (50, (129,))):
            operands = [[_rand_words(torch, rng, shape) for _ in names]
                        for _ in range(q)]
            got = kbw.fused_bitwise_stacked(expr, names, operands, prog,
                                            n_bits=shape[-1] * 32 - 3)
            want = kbw.fused_bitwise_stacked_plain(expr, names, operands,
                                                   shape[-1] * 32 - 3)
            for k, (g, w) in enumerate(zip(got, want)):
                _same(torch, g, w, f"fused_bitwise_stacked {ename} q{k}",
                      fbs, stats)
    for shape in ((1, 524288), (1, 7), (1, 129), (6, 40), (257, 8),
                  (70000, 3)):
        x = _rand_words(torch, rng, shape)
        _same(torch, kpc.popcount_rows(x), kpc.popcount_rows_plain(x),
              f"popcount_rows {shape}", "popcount_rows", stats)
    for b in (1, 4, 8, 12, 32):
        for words in (187538, 524288, 7):
            planes = _rand_words(torch, rng, (b, words))
            top = (1 << b) - 1
            for c1, c2 in ((0, top), (0, 0), (top, top), (1, top - 1),
                           (top // 3, 2 * top // 3)):
                _same(torch, kbv.bitweaving_scan(planes, c1, c2),
                      kbv.bitweaving_scan_plain(planes, c1, c2),
                      f"bitweaving_scan b={b} words={words} [{c1},{c2}]",
                      "bitweaving_scan", stats)
    # the engine's entry points on the card: kernels == plain backend
    eng_k = BulkBitwiseEngine("cuda")
    eng_p = BulkBitwiseEngine("torch")
    bits = rng.integers(0, 2, (3, 1000)).astype(bool)
    a, b, c = (BitVector.from_bits(v, device="cuda") for v in bits)
    for op in ("and_", "or_", "xor", "nand", "nor", "xnor"):
        _same(torch, getattr(eng_k, op)(a, b).data,
              getattr(eng_p, op)(a, b).data, f"engine {op}", fb, stats)
    _same(torch, eng_k.maj(a, b, c).data, eng_p.maj(a, b, c).data,
          "engine maj", fb, stats)
    _same(torch, eng_k.popcount(a), eng_p.popcount(a), "engine popcount",
          "popcount_rows", stats)
    if int(eng_k.popcount(a)) != int(bits[0].sum()):
        fail("engine popcount disagrees with numpy")
    log(f"kernels vs plain on the card, all exact: {json.dumps(stats)}")
    return stats


def time_kernels(torch, timer):
    """Each kernel at the main path's shapes. Returns name -> numbers."""
    from repro_torch.apps.bitweaving_db import scan_expr
    from repro_torch.core import expr as E
    from repro_torch.kernels import bitweaving as kbv
    from repro_torch.kernels import bitwise as kbw
    from repro_torch.kernels import popcount as kpc

    rng = np.random.default_rng(SEED + 1)
    X, Y = E.Expr.var("x"), E.Expr.var("y")
    out = {}

    def bound(nbytes, ops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_OPS_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")

    def row(name, shape, kernel, plain, library, nbytes, ops):
        b_ms, b_by = bound(nbytes, ops)
        k_dev, k_launch = timer(kernel)
        p_dev, _ = timer(plain)
        lib = None if library is None else timer(library)[0]
        r = {"ms": k_dev, "launch_ms": k_launch, "plain_ms": p_dev,
             "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by,
             "shape": shape}
        log(f"time {name} {shape}: kernel {k_dev:.6f} ms on the device "
            f"({k_launch:.6f} ms with the host's launch path), plain "
            f"{p_dev:.6f} ms, library {lib}, bound {b_ms:.6f} ms ({b_by})")
        return r

    # fused_bitwise: the bitmap query x & y on one 2^24-bit row
    shape = (1, 524288)
    x, y = (_rand_words(torch, rng, shape) for _ in range(2))
    prog = kbw.lower(X & Y, ("x", "y"))
    n = x.numel()
    out["fused_bitwise"] = row(
        "fused_bitwise", "x&y (1,524288)",
        lambda: kbw.fused_bitwise(X & Y, ("x", "y"), [x, y], prog),
        lambda: kbw.fused_bitwise_plain(X & Y, ("x", "y"), [x, y]),
        lambda: torch.bitwise_and(x, y), 3 * 4 * n, n)
    # the same query on operands 4 bytes past a 16-byte boundary: the
    # scalar path, against the 16-byte path above
    xo, yo = (_rand_words(torch, rng, (n + 1,))[1:].reshape(shape)
              for _ in range(2))
    out["x&y scalar"] = row(
        "fused_bitwise", "x&y (1,524288) 4-byte offset, scalar path",
        lambda: kbw.fused_bitwise(X & Y, ("x", "y"), [xo, yo], prog),
        lambda: kbw.fused_bitwise_plain(X & Y, ("x", "y"), [xo, yo]),
        lambda: torch.bitwise_and(xo, yo), 3 * 4 * n, n)
    # the heavier program of the TPC-H path: an 8-plane range predicate,
    # first over planes that are row views of one (8, 187538) tensor -
    # the layout serving uses (TpchTable's planes, put() shares them):
    # a row is 750,152 bytes, so odd rows are not 16-byte aligned and the
    # launch takes the kernel's scalar path - then over eight separate
    # allocations, which take the 16-byte path
    names = tuple(f"x{i}" for i in range(8))
    sexpr = scan_expr(8, 37, 200, prefix="x")
    sprog = kbw.lower(sexpr, names)
    served = _rand_words(torch, rng, (8, 187538))
    for layout, planes in (
            ("row views, scalar path (served)", list(served.unbind(0))),
            ("separate, 16-byte path",
             [_rand_words(torch, rng, (187538,)) for _ in names])):
        out[f"scan {layout}"] = row(
            "fused_bitwise", f"scan_expr(8) (187538,) {layout}",
            lambda p=planes: kbw.fused_bitwise(sexpr, names, p, sprog),
            lambda p=planes: kbw.fused_bitwise_plain(sexpr, names, p), None,
            (len(sprog.loads) + 1) * 4 * 187538,
            (sprog.code.shape[0] - len(sprog.loads)) * 187538)
    # fused_bitwise_stacked: one epoch of 16 bitmap queries
    q = 16
    operands = [[_rand_words(torch, rng, shape) for _ in range(2)]
                for _ in range(q)]
    sx = torch.stack([o[0] for o in operands])
    sy = torch.stack([o[1] for o in operands])
    out["fused_bitwise_stacked"] = row(
        "fused_bitwise_stacked", "16 x x&y (1,524288)",
        lambda: kbw.fused_bitwise_stacked(X & Y, ("x", "y"), operands, prog),
        lambda: kbw.fused_bitwise_stacked_plain(X & Y, ("x", "y"),
                                                operands),
        lambda: torch.bitwise_and(sx, sy), q * 3 * 4 * n, q * n)
    # the same epoch with its pointer table in device memory (the path of
    # epochs past PARAM_PTRS pointers) against the table passed by value,
    # alternated so drift between rounds shows as spread
    by_value, table = [], []
    stacked = (lambda: kbw.fused_bitwise_stacked(X & Y, ("x", "y"),
                                                 operands, prog))
    for _ in range(3):
        by_value.append(timer(stacked))
        kept, kbw.PARAM_PTRS = kbw.PARAM_PTRS, 0
        try:
            table.append(timer(stacked))
        finally:
            kbw.PARAM_PTRS = kept
    out["ptr table"] = {"by_value": by_value, "device_table": table}
    log(f"time fused_bitwise_stacked 16 x x&y pointer table, 3 alternated "
        f"rounds of (device ms, host-path ms): by value {by_value}, "
        f"device table {table}")
    # popcount_rows: the resident popcount of one 2^24-bit bitmap
    out["popcount_rows"] = row(
        "popcount_rows", "(1,524288)", lambda: kpc.popcount_rows(x),
        lambda: kpc.popcount_rows_plain(x), None, 4 * n + 4, 2 * n)
    # bitweaving_scan: count_between on the 8-bit TPC-H column
    bplanes = _rand_words(torch, rng, (8, 187538))
    out["bitweaving_scan"] = row(
        "bitweaving_scan", "(8,187538)",
        lambda: kbv.bitweaving_scan(bplanes, 37, 200),
        lambda: kbv.bitweaving_scan_plain(bplanes, 37, 200), None,
        9 * 4 * 187538, 8 * 6 * 187538)
    return out


# -- phase 3 ------------------------------------------------------------------


def _zipf_pairs(rng, n_items, n_tenants, s=1.1):
    """Each tenant's catalog pair, Zipfian over pairs (the same draw as
    the reference's closed-loop serving benchmark)."""
    pairs = [(i, j) for i in range(n_items) for j in range(i + 1, n_items)]
    w = 1.0 / np.arange(1, len(pairs) + 1, dtype=np.float64) ** s
    idx = rng.choice(len(pairs), size=n_tenants, p=w / w.sum())
    return [pairs[i] for i in idx]


def _packed_u32(bits: np.ndarray) -> np.ndarray:
    """bool (n,) -> little-endian-within-word uint32 words (n/32 up)."""
    pad = (-len(bits)) % 32
    b = np.packbits(np.pad(bits, (0, pad)), bitorder="little")
    return b.view("<u4")


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def serve_bitmaps(torch, device, n_users, n_items, n_tenants, n_queries,
                  max_batch=16, window_ns=50_000.0, full_checks=8):
    """The bitmap-index serving row at full width: every completion's
    popcount against numpy, the first ``full_checks`` bit for bit."""
    from repro_torch.core import BitVector, Expr
    from repro_torch.pim import AmbitRuntime
    from repro_torch.serve import QueryFrontend, run_closed_loop

    rng = np.random.default_rng(SEED)
    rt = AmbitRuntime(backend="cuda", device=device)
    raw = {f"m{i}": rng.integers(0, 2, n_users).astype(np.uint8)
           for i in range(n_items)}
    hs = {k: rt.put(BitVector.from_bits(v.astype(bool), device=device),
                    name=k) for k, v in raw.items()}
    expr = Expr.var("x") & Expr.var("y")
    tenants = [f"t{i}" for i in range(n_tenants)]
    pair_of = dict(zip(tenants, _zipf_pairs(rng, n_items, n_tenants)))
    counts, packed = {}, {}

    def expected(pair):
        if pair not in counts:
            a, b = raw[f"m{pair[0]}"], raw[f"m{pair[1]}"]
            both = (a & b).astype(bool)
            counts[pair] = int(both.sum())
            packed[pair] = _packed_u32(both)
        return counts[pair]

    def next_query(tenant, k):
        i, j = pair_of[tenant]
        return expr, {"x": hs[f"m{i}"], "y": hs[f"m{j}"]}

    state = {"mism": 0, "checked": 0, "full": 0}

    def check(q):
        pair = pair_of[q.tenant]
        if rt.popcount(q.result) != expected(pair):
            state["mism"] += 1
        if state["full"] < full_checks:
            words = rt.get(q.result).data.numpy().view(np.uint32)
            want = packed[pair]
            if not (np.array_equal(words[:len(want)], want)
                    and not words[len(want):].any()):
                state["mism"] += 1
            state["full"] += 1
        state["checked"] += 1
        rt.free(q.result)

    fe = QueryFrontend(rt, window_ns=window_ns, max_batch=max_batch)
    _sync(torch, device)
    t0 = time.perf_counter()
    done = run_closed_loop(fe, tenants, next_query, n_queries,
                           on_complete=check)
    _sync(torch, device)
    wall = time.perf_counter() - t0
    rep = fe.report()
    if state["mism"] or done != n_queries or state["checked"] != done:
        fail(f"bitmap serving: mismatches={state['mism']} done={done}")
    log(f"serve_bitmap users={n_users} tenants={n_tenants} queries={done} "
        f"drains={rep.drains} fill={rep.fill_drains} "
        f"deadline={rep.deadline_drains} flush={rep.flush_drains} "
        f"epochs={rep.epochs} mismatches=0 model_p50_ns={int(rep.p50_ns)} "
        f"model_p99_ns={int(rep.p99_ns)} (reference epoch-cost model, not "
        f"the card) wall_s={wall:.3f} wall_qps={done / wall:.1f} "
        f"(measured on the card, popcount check per query included)")
    return rt, raw, hs, {"wall_qps": done / wall, "drains": rep.drains,
                         "epochs": rep.epochs}


def weekly_active(torch, device, n_users):
    from repro_torch.apps.bitmap_index import BitmapIndex
    from repro_torch.pim import AmbitRuntime

    rng = np.random.default_rng(SEED + 2)
    rt = AmbitRuntime(backend="cuda", device=device)
    idx = BitmapIndex(n_users, runtime=rt)
    weeks = [f"w{i}" for i in range(4)]
    members = {}
    for nm in weeks + ["male"]:
        members[nm] = rng.choice(n_users, n_users // 2, replace=False)
        idx.add(nm, members[nm])
    masks = {}
    for nm, m in members.items():
        b = np.zeros(n_users, bool)
        b[m] = True
        masks[nm] = b
    want_u = int(np.logical_and.reduce([masks[w] for w in weeks]).sum())
    want_pw = [int((masks[w] & masks["male"]).sum()) for w in weeks]
    got_u, got_pw, _ = idx.weekly_active_query(weeks, "male")
    if (got_u, got_pw) != (want_u, want_pw):
        fail(f"weekly_active_query {got_u},{got_pw} != {want_u},{want_pw}")
    log(f"weekly_active users={n_users} weeks=4 unique={got_u} "
        f"per_week={got_pw} drains={rt.scheduler.drains} mismatches=0")


def serve_tpch(torch, device, n_rows, n_tenants, n_queries, max_batch=16,
               window_ns=50_000.0):
    """TPC-H lineitem at n_rows: count_between on every column, then the
    Zipfian predicate mix through the frontend, every result bit for bit
    against ``TpchTable.oracle``."""
    from repro_torch.apps.bitweaving_db import (TpchTable, predicate_plan,
                                                zipf_tenant_queries)
    from repro_torch.pim import AmbitRuntime
    from repro_torch.serve import QueryFrontend, run_closed_loop

    t0 = time.perf_counter()
    table = TpchTable.synthesize(n_rows=n_rows, seed=SEED, device=device)
    _sync(torch, device)
    n_planes = sum(c.bits for c in table.columns.values())
    words = next(iter(table.columns.values())).planes.shape[1]
    log(f"tpch rows={n_rows} columns={len(table.columns)} planes={n_planes} "
        f"words_per_plane={words} plane_bytes={n_planes * words * 4} "
        f"synthesize_s={time.perf_counter() - t0:.2f}")
    for name, col in table.columns.items():
        top = (1 << col.bits) - 1
        for c1, c2 in ((0, top), (1, top // 2), (top // 3, top)):
            want = col.oracle_count(table.values[name], c1, c2)
            if col.count_between(c1, c2) != want:
                fail(f"count_between {name} [{c1},{c2}] != {want}")
    log("tpch count_between: every column, 3 ranges each, mismatches=0")

    rt = AmbitRuntime(backend="cuda", device=device)
    # the Zipfian mix in its own order; closed-loop tenant slots issue it
    # (run_closed_loop numbers queries in issue order: QueryRecord.seq)
    mix = zipf_tenant_queries(table, n_tenants, n_queries, seed=SEED)
    tenant_names = [f"t{i}" for i in range(n_tenants)]
    packed = {}
    state = {"mism": 0, "issued": 0}

    def next_query(tenant, k):
        specs = mix[state["issued"]][1]
        state["issued"] += 1
        return predicate_plan(table, specs, rt)

    def check(q):
        specs = mix[q.seq][1]
        if specs not in packed:
            packed[specs] = _packed_u32(table.oracle(specs))
        words_got = rt.get(q.result).data.numpy().view(np.uint32)
        if not np.array_equal(words_got, packed[specs]):
            state["mism"] += 1
        rt.free(q.result)

    fe = QueryFrontend(rt, window_ns=window_ns, max_batch=max_batch)
    _sync(torch, device)
    t0 = time.perf_counter()
    done = run_closed_loop(fe, tenant_names, next_query, n_queries,
                           on_complete=check)
    _sync(torch, device)
    wall = time.perf_counter() - t0
    rep = fe.report()
    if state["mism"] or done != n_queries:
        fail(f"tpch serving: mismatches={state['mism']} done={done}")
    log(f"serve_tpch rows={n_rows} tenants={n_tenants} queries={done} "
        f"templates={len(packed)} drains={rep.drains} epochs={rep.epochs} "
        f"mismatches=0 model_p50_ns={int(rep.p50_ns)} "
        f"model_p99_ns={int(rep.p99_ns)} (reference epoch-cost model, not "
        f"the card) wall_s={wall:.3f} wall_qps={done / wall:.1f} "
        f"(measured on the card, bit-for-bit read-back check included)")
    return {"wall_qps": done / wall, "drains": rep.drains,
            "epochs": rep.epochs}


KERNELS = (
    # name, module attribute, source, TPU kernel it replaces
    ("fused_bitwise", "bitwise", "src/repro_torch/kernels/csrc/bitwise.cu",
     "src/repro/kernels/bitwise.py:45"),
    ("fused_bitwise_stacked", "bitwise",
     "src/repro_torch/kernels/csrc/bitwise.cu",
     "src/repro/kernels/bitwise.py:69"),
    ("popcount_rows", "popcount", "src/repro_torch/kernels/csrc/popcount.cu",
     "src/repro/kernels/popcount.py:39"),
    ("bitweaving_scan", "bitweaving",
     "src/repro_torch/kernels/csrc/bitweaving.cu",
     "src/repro/kernels/bitweaving.py:55"),
)


def _wrappers():
    from repro_torch.kernels import bitweaving, bitwise, popcount
    mods = {"bitwise": bitwise, "popcount": popcount,
            "bitweaving": bitweaving}
    return {name: getattr(mods[mod], name) for name, mod, _, _ in KERNELS}


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run from a checkout")
    sys.path.insert(0, src)
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    t_start = time.perf_counter()

    log("== phase 1: environment")
    card = environment(torch)

    log("== phase 2: kernels against their plain versions")
    checks = check_kernels(torch)
    timer = Timer(torch)
    times = time_kernels(torch, timer)
    del timer
    torch.cuda.empty_cache()

    log("== phase 3: serving at full width on backend 'cuda'")
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    bitmap = serve_bitmaps(torch, "cuda", n_users=1 << 24, n_items=12,
                           n_tenants=1024, n_queries=2048)[3]
    weekly_active(torch, "cuda", n_users=1 << 24)
    tpch = serve_tpch(torch, "cuda", n_rows=6_001_215, n_tenants=1024,
                      n_queries=2048)
    log(f"serving wall qps on {card}: bitmap {bitmap['wall_qps']:.1f}, "
        f"tpch {tpch['wall_qps']:.1f} (mismatches=0 in both)")
    launches = {name: fn.launches for name, fn in wrappers.items()}
    log(f"launches on the serving path: {launches}")
    idle = [n for n, c in launches.items() if c <= 0]
    if idle:
        fail(f"kernels never launched on the serving path: {idle}")

    kernels = []
    for name, _, source, replaces in KERNELS:
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "checks": checks[name]["checks"],
            "max_abs_err": checks[name]["max_abs_err"], "ms": t["ms"],
            "launch_ms": t["launch_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": t["shape"]})
    log(f"total_s={time.perf_counter() - t_start:.1f} card: {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:            # report and exit non-zero
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)
