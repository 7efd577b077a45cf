#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order (any failed check raises and the script exits non-zero
without printing the result line):

1. environment: the card's name and power limit, and the build of every
   CUDA kernel from ``src/repro_torch/kernels/csrc`` (ptxas must report
   no stack frame and no spill for the popcount and scan kernels,
   ``binary_matmul``'s SASS must hold tensor-core products, and the
   scan's SASS order of loads and compares is reported);
2. every kernel against its plain PyTorch version on the card, at the
   main path's shapes and at ragged ones (views off a 16-byte boundary,
   short and split rows, tail masks), exactly; then each kernel's time
   per launch (CUDA events, median, L2 flushed before each launch)
   beside its plain version's, a one-call PyTorch yardstick where one
   exists (for the popcount and the scan, which have none, a call that
   moves the same bytes), and the least time the card could take;
3. the serving main path at full width on backend "cuda": a 2^24-user
   bitmap index served to 1024 Zipfian tenants through QueryFrontend,
   the weekly-active query, and the TPC-H lineitem table at scale factor
   1 (6,001,215 rows) served the same way, every answer checked against
   numpy; kernel launch counts are read for this phase alone;
4. the binary-LM path at the example's own width
   (``repro_torch.apps.binary_lm.main``: 150 STE steps of a 256-to-8
   BitLinear, then packed XNOR-popcount inference over 2048 examples),
   accuracy above 0.5; launch counts are read for this phase alone;
5. ``torch.profiler`` over one popcount, one served popcount and one
   ``count_between``: the CUDA kernels each ran, by name (a popcount
   must be its one kernel, with no fill and no sum; a kernel the tracer
   dropped is reported, not failed, since the launch counts show it);
6. the DRAM model (backend "ambit_sim") with its row state on the card:
   the four Figure-20 expressions of ``fig20b_batched`` over 256 rows of
   65,536 bits, whose bits must equal the "cuda" backend's and whose
   DRAM ledger must equal the same engine's on the CPU (and, with
   ``batch_rows=False`` on 8 rows, the batched ledger scaled to 8 rows),
   the weekly-active query over 2^24 users against numpy, a TMR scrub of
   a 2^24-bit vector and the timing oracle; wall ms on the card and on
   the CPU are printed, and the kernel launch counts of this phase
   (none expected) are printed, not required;
7. one ``{"profile": {...}}`` JSON line with phase 5's traces, one
   ``{"kernels": [...]}`` JSON line, then the result line.

Each path must launch its own kernels: the four serving kernels on
phase 3, ``binary_matmul`` on phase 4.

Imports nothing of the JAX package and needs no network.
"""

from __future__ import annotations

import json
import os
import re
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
# The data sheet's dense int8 tensor-core rate: the fastest the card runs
# a product of +-1 values, so the floor for binary_matmul's 2*M*N*K ops.
INT8_TC_OPS_PER_S = 1979e12
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
        entries = ptxas_summary(text)
        for line in ptxas_lines(entries):
            log(f"  ptxas[{name}] {line}")
        # the two kernels that keep every load in registers: no stack
        # frame, no spill in any instantiation
        if name in ("popcount", "bitweaving"):
            bad = [e for e in entries if e[2] or e[3] or e[4]]
            if bad or not entries:
                fail(f"ptxas[{name}]: stack frame or spills in {bad}")
    tensor_core_check(build)
    scan_load_order(build)
    return card


def ptxas_summary(text: str):
    """One (name, registers, stack frame B, spill stores B, spill loads B,
    static shared B) an entry point of ``nvcc -Xptxas -v`` output."""
    out, name, props = [], None, (0, 0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            mangled = m.group(1)
            k = re.search(r"\d+((?:fused_bitwise|binary_matmul|popcount|"
                          r"bitweaving)[a-z_]*)(I.*?E+(?=v))?", mangled)
            name = mangled if not k else k.group(1) + (
                "<" + ",".join(re.findall(r"L[ib](\d+)E", k.group(2))) + ">"
                if k.group(2) else "")
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            props = tuple(int(g) for g in m.groups())
            continue
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", m.group(2))
            out.append((name, int(m.group(1)), *props,
                        int(smem.group(1)) if smem else 0))
            name = None
    return out


def ptxas_lines(entries):
    """A line an entry point; a kernel of more than 8 instantiations (the
    scan's 96) as one line of ranges."""
    by_kernel = {}
    for e in entries:
        by_kernel.setdefault(e[0].split("<")[0], []).append(e)
    lines = []
    for kernel, group in by_kernel.items():
        if len(group) <= 8:
            lines += [f"{n}: {r} registers, stack frame {st} B, spills "
                      f"{ss}/{sl} B, static shared {sm} B"
                      for n, r, st, ss, sl, sm in group]
            continue
        regs = [e[1] for e in group]
        worst = max(group, key=lambda e: e[1])
        lines.append(
            f"{kernel}: {len(group)} instantiations, {min(regs)}-{max(regs)} "
            f"registers (most: {worst[0]}), stack frame at most "
            f"{max(e[2] for e in group)} B, spills at most "
            f"{max(e[3] for e in group)}/{max(e[4] for e in group)} B")
    return lines


def sass_of(build, name):
    """``cuobjdump -sass`` of the built ``csrc/<name>.cu``, or None (with
    a log line) where the toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        log(f"  sass[{name}]: cuobjdump not found, not checked")
        return None
    return subprocess.run([tool, "-sass", str(build._target(name))],
                          capture_output=True, text=True, timeout=120).stdout


def tensor_core_check(build):
    """binary_matmul's SASS must hold tensor-core products (wgmma is
    GMMA in SASS, mma.sync IMMA) and no popcount loop."""
    sass = sass_of(build, "binary_matmul")
    if sass is None:
        return
    gmma, imma = sass.count("GMMA."), sass.count("IMMA.")
    log(f"  sass[binary_matmul]: {gmma} GMMA (wgmma), {imma} IMMA (mma.sync), "
        f"{sass.count('POPC')} POPC instructions")
    if not gmma or not imma:
        fail("binary_matmul's SASS lacks its tensor-core products")


def sass_functions(sass: str):
    """``cuobjdump -sass`` text -> {mangled name: [instruction, ...]}."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m and name:
            out[name].append(m.group(1))
    return out


def loads_before_use(code):
    """(global loads issued before the first instruction that reads a
    loaded register, global loads in all) of one function's SASS."""
    loaded, before, total, used = set(), 0, 0, False
    for ins in code:
        ins = re.sub(r"^@!?U?P\w+\s+", "", ins)      # the predicate
        op, _, rest = ins.partition(" ")
        regs = [re.findall(r"\bR(\d+)\b", a) for a in rest.split(",")]
        if op.split(".")[0] == "LDG":
            total += 1
            before += not used
            n = 4 if ".128" in op else 2 if ".64" in op else 1
            loaded.update(int(regs[0][0]) + i for i in range(n))
            continue
        srcs = regs if op.startswith(("ST", "RED", "ATOM")) else regs[1:]
        if any(int(r) in loaded for a in srcs for r in a):
            used = True
    return before, total


def scan_load_order(build):
    """Report bitweaving_scan's SASS: how many of each instantiation's
    plane loads are issued before the recurrence first reads a loaded
    word. The source issues every plane's load first; in most
    instantiations of 8 planes or more, the served ones among them, ptxas
    (sm_90a) starts the recurrence after the first few loads whatever the
    source order (volatile asm loads and fences did not change it), and
    staging the planes through shared memory with cp.async, which issues
    every load first, was slower on the card. So this is a report, not a
    gate."""
    sass = sass_of(build, "bitweaving")
    if sass is None:
        return
    order = {}
    for name, code in sass_functions(sass).items():
        m = re.match(r"_Z22bitweaving_scan_kernelILi(\d+)ELi(\d+)EE", name)
        if m:
            order[int(m.group(1)), int(m.group(2))] = loads_before_use(code)
    first = sum(1 for b, t in order.values() if t and b == t)
    served = {f"<{b},{n}>": order.get((b, n)) for b, n in ((8, 2), (8, 4))}
    least = min((b for b, t in order.values() if t), default=None)
    log(f"  sass[bitweaving]: (plane loads before the first compare, plane "
        f"loads) {served} (the served 8-plane scans); every load first in "
        f"{first} of {len(order)} instantiations, at least {least} first "
        f"in all")


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

    def __call__(self, fn, reps=None):
        torch = self.torch
        reps = self.reps if reps is None else reps
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
        for _ in range(reps):
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
        if len(device) < reps // 2:
            fail(f"timer: only {len(device)} of {reps} launches were "
                 "enqueued inside their sleep")
        device = statistics.median(device)
        launch = []
        for _ in range(reps):
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


# binary_matmul (M, N, K bits): the CPU suite's shapes (ragged K blocks
# and edges among them), then the timed ones: the example's inference,
# the reference benchmark's 256x256x4096 (benchmarks/kernels_micro.py),
# and a BitLinear at qwen2.5-3b's MLP width (d_model 2048 -> d_ff 11008)
# over 2048 tokens, the one that loads the card.
BMM_CHECK_SHAPES = [(1, 1, 32), (5, 9, 64), (16, 16, 128), (40, 70, 1000),
                    (8, 128, 4096), (3, 5, 40000), (65, 67, 16416)]
BMM_TIME_SHAPES = [(2048, 8, 256), (256, 256, 4096), (2048, 11008, 2048)]
# the kernel's own edges (``binary_matmul.plan``): M, N and Kw (chunks of 8
# words) one short of, on and one past the 128x256 wgmma tile (from 132
# tiles up), the 64x64 and the 128x8 tiles; k_bits off a multiple of 32;
# split K on each of the three tiles
BMM_EDGE_SHAPES = [(1536, 2816, 256), (1535, 2815, 224), (1537, 2817, 289),
                   (1664, 2816, 8191), (1536, 2816, 4100),
                   (63, 65, 288), (64, 64, 256), (65, 63, 225),
                   (127, 129, 4101), (300, 200, 100000),
                   (127, 8, 31), (129, 7, 257), (128, 8, 256), (300, 1, 40000)]


def _packed_pm1(torch, rng, rows, k_bits):
    """Random +-1 rows packed as bits: (rows, ceil(k/32)) int32 words on
    the card, pad bits beyond k_bits zero."""
    w = _rand_words(torch, rng, (rows, (k_bits + 31) // 32))
    if k_bits % 32:
        w[:, -1] &= (1 << (k_bits % 32)) - 1
    return w


def regs64_expr():
    """Pairwise xors of 12 operands, consumed by an and-chain in one order
    and an or-chain in the other: its lowering holds 64 live registers."""
    from repro_torch.core import expr as E
    leaves = [E.Expr.var(f"v{i}") for i in range(12)]
    mids = [leaves[i] ^ leaves[j] for i in range(12)
            for j in range(i + 1, 12)][:61]
    chain1, chain2 = mids[0], mids[-1]
    for m in mids[1:]:
        chain1 = chain1 & m
    for m in reversed(mids[:-1]):
        chain2 = chain2 | m
    return chain1 ^ chain2


def check_tpch_layout(torch, rng, exprs, stats):
    """The fused kernel as TPC-H serving launches it: operands are row
    views of one (planes, 187538) tensor (odd rows 4 bytes off a 16-byte
    boundary) and results are masked to the table's 6,001,215 rows; every
    program above, one epoch past the by-value pointer table."""
    from repro_torch.core import expr as E
    from repro_torch.kernels import bitwise as kbw
    rows = 6_001_215
    for ename, expr in exprs.items():
        names = tuple(sorted({n.name for n in E.topo_order(expr)
                              if n.op == "var"}))
        prog = kbw.lower(expr, names)
        views = list(_rand_words(torch, rng, (len(names), 187538)).unbind(0))
        for n_bits in (rows, rows - 31, None):
            _same(torch, kbw.fused_bitwise(expr, names, views, prog,
                                           n_bits=n_bits),
                  kbw.fused_bitwise_plain(expr, names, views, n_bits),
                  f"fused_bitwise {ename} TPC-H rows {n_bits}",
                  "fused_bitwise", stats)
    names = tuple(f"x{i}" for i in range(8))
    prog = kbw.lower(exprs["scan"], names)
    q = kbw.PARAM_PTRS // (len(names) + 1) + 3
    operands = [list(_rand_words(torch, rng, (8, 187538)).unbind(0))
                for _ in range(q)]
    got = kbw.fused_bitwise_stacked(exprs["scan"], names, operands, prog,
                                    n_bits=rows)
    want = kbw.fused_bitwise_stacked_plain(exprs["scan"], names, operands,
                                           rows)
    for k, (g, w) in enumerate(zip(got, want)):
        _same(torch, g, w, f"fused_bitwise_stacked TPC-H epoch q{k}",
              "fused_bitwise_stacked", stats)


def _offset_view(torch, rng, shape, offset):
    """Random words of ``shape`` whose first word lies ``offset`` bytes
    past a 16-byte boundary (a view into a larger allocation)."""
    n = int(np.prod(shape))
    base = _rand_words(torch, rng, (n + 4,))
    view = base[offset // 4:offset // 4 + n].reshape(shape)
    assert view.data_ptr() % 16 == offset
    return view


def check_popcount(torch, rng, stats):
    """popcount_rows at the served and ragged shapes, short rows, rows
    of several splits and passes, views 0, 4, 8 and 12 bytes off a
    16-byte boundary; one launch a call, ticket words back at 0."""
    from repro_torch.kernels import build
    from repro_torch.kernels import popcount as kpc
    shapes = [(1, 524288), (1, 7), (1, 129), (6, 40), (257, 8), (70000, 3),
              (1, 187538), (3, 1000), (2, 524289), (5, 40000), (600, 300),
              (200, 5000), (1, 257), (1, 1 << 22)]
    for shape in shapes:
        for offset in (0, 4, 8, 12):
            x = _offset_view(torch, rng, shape, offset)
            launches = kpc.popcount_rows.launches
            got = kpc.popcount_rows(x)
            if kpc.popcount_rows.launches != launches + 1:
                fail("popcount_rows: not one launch a call")
            _same(torch, got, kpc.popcount_rows_plain(x),
                  f"popcount_rows {shape} +{offset} B "
                  f"{kpc.plan(*shape, build.sm_count(x.device))}",
                  "popcount_rows", stats)
    if any(t.any() for t in kpc._TICKETS.values()):
        fail("popcount_rows left a ticket word standing")


def check_bitweaving(torch, rng, stats):
    """bitweaving_scan at every plane count's edge, the served shapes,
    planes 4, 8 and 12 bytes off a 16-byte boundary, and the tail mask at
    every remainder mod 32 and at the TPC-H table's 6,001,215 rows."""
    from repro_torch.kernels import bitweaving as kbv
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
    for b, words in ((8, 187538), (8, 524288), (32, 42), (3, 41)):
        for offset in (4, 8, 12):
            planes = _offset_view(torch, rng, (b, words), offset)
            for n_bits in (None, 32 * words - 7, 6_001_215):
                launches = kbv.bitweaving_scan.launches
                got = kbv.bitweaving_scan(planes, 37, 200, n_bits)
                if kbv.bitweaving_scan.launches != launches + 1:
                    fail("bitweaving_scan: not one launch a call")
                _same(torch, got,
                      kbv.bitweaving_scan_plain(planes, 37, 200, n_bits),
                      f"bitweaving_scan ({b},{words}) +{offset} B n_bits="
                      f"{n_bits} {kbv.plan(b, words, planes.data_ptr())}",
                      "bitweaving_scan", stats)
    planes = _rand_words(torch, rng, (8, 187538))
    for rem in range(32):
        n_bits = 32 * 187537 - 32 * rem + rem
        _same(torch, kbv.bitweaving_scan(planes, 37, 200, n_bits),
              kbv.bitweaving_scan_plain(planes, 37, 200, n_bits),
              f"bitweaving_scan (8,187538) n_bits={n_bits}",
              "bitweaving_scan", stats)


def check_kernels(torch):
    """Every kernel against its plain version on the card, exactly.
    Returns kernel name -> {"checks", "max_abs_err"} (0 when all agree)."""
    from repro_torch.apps.bitweaving_db import scan_expr
    from repro_torch.core import expr as E
    from repro_torch.core.engine import BulkBitwiseEngine
    from repro_torch.core.bitvector import BitVector
    from repro_torch.kernels import binary_matmul as kbmm
    from repro_torch.kernels import bitwise as kbw
    from repro_torch.kernels import build

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
        # 64 live registers, the most a program may hold
        "regs64": regs64_expr(),
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
    check_tpch_layout(torch, rng, exprs, stats)
    check_popcount(torch, rng, stats)
    check_bitweaving(torch, rng, stats)
    plans = set()
    for m, n, k in BMM_CHECK_SHAPES + BMM_TIME_SHAPES + BMM_EDGE_SHAPES:
        a, b = _packed_pm1(torch, rng, m, k), _packed_pm1(torch, rng, n, k)
        p = kbmm.plan(m, n, a.shape[1], build.sm_count(a.device))
        plans.add((p.config, p.splits > 1))
        _same(torch, kbmm.binary_matmul(a, b, k),
              kbmm.binary_matmul_plain(a, b, k),
              f"binary_matmul {m}x{n}x{k} {p}", "binary_matmul", stats)
        del a, b
    if plans != {(c, s) for c in range(3) for s in (False, True)}:
        fail(f"binary_matmul checks missed a tile or split: {sorted(plans)}")
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
    from repro_torch.kernels import bitwise as kbw

    rng = np.random.default_rng(SEED + 1)
    X, Y = E.Expr.var("x"), E.Expr.var("y")
    out = {}

    def bound(nbytes, ops, rate):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / rate * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")

    def row(name, shape, kernel, plain, library, nbytes, ops,
            rate=FP32_OPS_PER_S, plain_reps=None):
        b_ms, b_by = bound(nbytes, ops, rate)
        k_dev, k_launch = timer(kernel)
        p_dev, _ = timer(plain, plain_reps)
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
    # the same query on operands 4 bytes past a 16-byte boundary
    xo, yo = (_rand_words(torch, rng, (n + 1,))[1:].reshape(shape)
              for _ in range(2))
    more = [row(
        "fused_bitwise", "x&y (1,524288) 4-byte offset",
        lambda: kbw.fused_bitwise(X & Y, ("x", "y"), [xo, yo], prog),
        lambda: kbw.fused_bitwise_plain(X & Y, ("x", "y"), [xo, yo]),
        lambda: torch.bitwise_and(xo, yo), 3 * 4 * n, n)]
    # the heavier program of the TPC-H path: an 8-plane range predicate,
    # over planes that are row views of one (8, 187538) tensor - the layout
    # serving uses (TpchTable's planes, put() shares them; odd rows are 4
    # bytes off a 16-byte boundary) - unmasked and with the table's
    # 6,001,215-row tail mask, as serving launches it; then over eight
    # separate allocations
    names = tuple(f"x{i}" for i in range(8))
    sexpr = scan_expr(8, 37, 200, prefix="x")
    sprog = kbw.lower(sexpr, names)
    served = _rand_words(torch, rng, (8, 187538))
    for layout, planes, n_bits in (
            ("row views (served layout)", list(served.unbind(0)), None),
            ("row views, TPC-H tail mask (served launch)",
             list(served.unbind(0)), 6_001_215),
            ("separate planes",
             [_rand_words(torch, rng, (187538,)) for _ in names], None)):
        more.append(row(
            "fused_bitwise", f"scan_expr(8) (187538,) {layout}",
            lambda p=planes, b=n_bits: kbw.fused_bitwise(sexpr, names, p,
                                                         sprog, n_bits=b),
            lambda p=planes, b=n_bits: kbw.fused_bitwise_plain(sexpr, names,
                                                               p, b),
            None, (len(sprog.loads) + 1) * 4 * 187538,
            (sprog.code.shape[0] - len(sprog.loads)) * 187538))
    out["fused_bitwise"]["more"] = more
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
    # the small parameter block (at most SMALL_PTRS pointers and
    # SMALL_INSTR instructions, 896 bytes) against the 5,120-byte one that
    # any launch fits, alternated: single x & y, then the epoch
    small, large = [], []
    for fn in (lambda: kbw.fused_bitwise(X & Y, ("x", "y"), [x, y], prog),
               stacked):
        small.append([])
        large.append([])
        for _ in range(3):
            small[-1].append(timer(fn))
            kept, kbw.SMALL_PARAMS = kbw.SMALL_PARAMS, False
            try:
                large[-1].append(timer(fn))
            finally:
                kbw.SMALL_PARAMS = kept
    out["param block"] = {"small": small, "large": large}
    log(f"time fused_bitwise parameter block, x&y then 16 x x&y, 3 rounds "
        f"each of (device ms, host-path ms): small {small}, large {large}")
    out.update(time_popcount_and_scan(torch, rng, timer, row, x))
    out["binary_matmul"] = time_binary_matmul(torch, rng, row)
    return out


def time_popcount_and_scan(torch, rng, timer, row, x):
    """popcount_rows on the served 2^24-bit row and bitweaving_scan on the
    8-bit TPC-H column, each beside a one-call yardstick that moves the
    same bytes but computes another function (``torch.sum`` of the row's
    words, ``torch.amax`` over the planes: torch has no popcount and no
    BitWeaving predicate, so ``library_ms`` stays null), and an empty
    kernel, the least a launch measures."""
    from repro_torch.kernels import bitweaving as kbv
    from repro_torch.kernels import popcount as kpc
    out = {}
    n = x.numel()
    # the timer's floor: a kernel that does nothing
    empty = timer(lambda: torch.cuda._sleep(0))[0]
    log(f"time an empty kernel (torch.cuda._sleep(0)): {empty:.6f} ms on "
        f"the device, the least any launch measures here")
    r = row("popcount_rows", "(1,524288)", lambda: kpc.popcount_rows(x),
            lambda: kpc.popcount_rows_plain(x), None, 4 * n + 4, 2 * n)
    r["yardstick_ms"] = timer(
        lambda: torch.sum(x, dim=1, dtype=torch.int32))[0]
    r["empty_kernel_ms"] = empty
    v = _offset_view(torch, rng, (1, 187538), 4)
    r["more"] = [row(
        "popcount_rows", "(1,187538) 4-byte offset (count_between's row)",
        lambda: kpc.popcount_rows(v), lambda: kpc.popcount_rows_plain(v),
        None, 4 * 187538 + 4, 2 * 187538)]
    log(f"time popcount_rows (1,524288) yardstick torch.sum(dim=1, int32) "
        f"{r['yardstick_ms']:.6f} ms")
    out["popcount_rows"] = r
    bplanes = _rand_words(torch, rng, (8, 187538))
    r = row("bitweaving_scan", "(8,187538)",
            lambda: kbv.bitweaving_scan(bplanes, 37, 200),
            lambda: kbv.bitweaving_scan_plain(bplanes, 37, 200), None,
            9 * 4 * 187538, 8 * 6 * 187538)
    r["yardstick_ms"] = timer(lambda: torch.amax(bplanes, dim=0))[0]
    r["empty_kernel_ms"] = empty
    r["more"] = [row(
        "bitweaving_scan", "(8,187538) TPC-H tail mask (count_between)",
        lambda: kbv.bitweaving_scan(bplanes, 37, 200, 6_001_215),
        lambda: kbv.bitweaving_scan_plain(bplanes, 37, 200, 6_001_215),
        None, 9 * 4 * 187538, 8 * 6 * 187538)]
    wide = _rand_words(torch, rng, (8, 524288))
    r["more"].append(row(
        "bitweaving_scan", "(8,524288)",
        lambda: kbv.bitweaving_scan(wide, 37, 200),
        lambda: kbv.bitweaving_scan_plain(wide, 37, 200), None,
        9 * 4 * 524288, 8 * 6 * 524288))
    log(f"time bitweaving_scan (8,187538) yardstick torch.amax(dim=0) "
        f"{r['yardstick_ms']:.6f} ms")
    out["bitweaving_scan"] = r
    return out


def time_binary_matmul(torch, rng, row):
    """binary_matmul at BMM_TIME_SHAPES. The yardstick is one bf16
    ``torch.mm`` of the same +-1 values, unpacked beforehand, summed and
    returned in float32 (exact: K < 2^24); its result is held against
    the kernel's. TF32 is off for float32 products while timing
    (``torch.backends.cuda.matmul.allow_tf32 = False``); the yardstick is
    bf16 and does not read it. Returns the example's shape's row with
    the others under ``more``."""
    from repro_torch.core.bitvector import unpack_bits
    from repro_torch.kernels import binary_matmul as kbmm

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for m, n, k in BMM_TIME_SHAPES:
        a, b = _packed_pm1(torch, rng, m, k), _packed_pm1(torch, rng, n, k)
        apm = (unpack_bits(a, k).to(torch.bfloat16) * 2 - 1).contiguous()
        bpm_t = (unpack_bits(b, k).to(torch.bfloat16) * 2 - 1).T
        got = kbmm.binary_matmul(a, b, k)
        lib_out = torch.mm(apm, bpm_t, out_dtype=torch.float32)
        if not torch.equal(lib_out.to(torch.int32), got):
            fail(f"binary_matmul {m}x{n}x{k}: the bf16 yardstick disagrees "
                 "with the kernel")
        kw = a.shape[1]
        rows.append(row(
            "binary_matmul", f"{m}x{n}x{k}",
            lambda a=a, b=b, k=k: kbmm.binary_matmul(a, b, k),
            lambda a=a, b=b, k=k: kbmm.binary_matmul_plain(a, b, k),
            lambda x=apm, y=bpm_t: torch.mm(x, y, out_dtype=torch.float32),
            4 * (m * kw + n * kw + m * n), 2 * m * n * k,
            rate=INT8_TC_OPS_PER_S, plain_reps=6 if m * n * k > 1e9 else None))
        del apm, bpm_t, lib_out
    first = dict(rows[0])
    first["more"] = rows[1:]
    return first


def profile_phase(torch):
    """``torch.profiler`` over one ``popcount_rows`` call, one served
    ``DeviceStore.popcount`` (through ``AmbitRuntime.popcount``) and one
    ``count_between``, each after a warm-up: the CUDA kernels each ran,
    by name. Each call must launch through the wrappers exactly the
    kernels it wants (the launch counts), and its trace must hold no
    other kernel: the first two the popcount kernel alone (no fill, no
    sum), ``count_between`` the scan and the popcount. A trace that holds
    fewer (the tracer dropped a record) is taken again, at most twice,
    and then reported as incomplete, not failed: the launch counts have
    already shown what ran. Returns what -> {"kernels", "traces",
    "complete"}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.apps.bitweaving_db import BitWeavingColumn
    from repro_torch.core import BitVector
    from repro_torch.kernels import bitweaving as kbv
    from repro_torch.kernels import popcount as kpc
    from repro_torch.pim import AmbitRuntime

    rng = np.random.default_rng(SEED + 3)
    x = _rand_words(torch, rng, (1, 524288))
    rt = AmbitRuntime(backend="cuda", device="cuda")
    h = rt.put(BitVector.from_bits(
        rng.integers(0, 2, 1 << 24).astype(bool), device="cuda"))
    col = BitWeavingColumn.from_values(
        rng.integers(0, 256, 6_001_215).astype(np.uint32), 8, device="cuda")
    pc = ("popcount_long_kernel", "popcount_short_kernel")
    scan = ("bitweaving_scan_kernel",)
    calls = (("popcount_rows (1,524288)", lambda: kpc.popcount_rows(x),
              [pc]),
             ("served DeviceStore.popcount (2^24 bits)",
              lambda: rt.popcount(h), [pc]),
             ("count_between (TPC-H SF1, 8-bit column)",
              lambda: col.count_between(37, 200), [scan, pc]))
    wrappers = {pc: kpc.popcount_rows, scan: kbv.bitweaving_scan}

    def launched(fn, what, want):
        """Call ``fn`` once; fail unless it launched ``want``."""
        before = {k: w.launches for k, w in wrappers.items()}
        fn()
        torch.cuda.synchronize()
        got = {k: w.launches - before[k] for k, w in wrappers.items()}
        if got != {k: want.count(k) for k in wrappers}:
            fail(f"profile {what}: launched {got}, want one of each of "
                 f"{want}")

    def kernels(fn, what, want):
        """The CUDA kernels of one call to ``fn``, traced in the second of
        two profiler steps (the first warms the tracer up)."""
        got = []

        def ready(prof):
            got.extend(e.name for e in prof.events()    # kernels and
                       if e.device_type == DeviceType.CUDA    # memsets
                       and not e.name.startswith(("Memcpy", "ProfilerStep")))

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=torch.profiler.schedule(
                         wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=ready) as prof:
            for _ in range(2):
                launched(fn, what, want)
                prof.step()
        return got

    seen = {}
    for what, fn, want in calls:
        launched(fn, what, want)
        for traces in range(1, 4):
            names = kernels(fn, what, want)
            stray = [n for n in names
                     if not any(k in n for ks in want for k in ks)]
            if stray or len(names) > len(want):
                fail(f"profile {what}: ran {names}, want one kernel of "
                     f"each of {want} in order")
            if len(names) == len(want):
                break
        complete = len(names) == len(want)
        if complete and not all(any(k in n for k in ks)
                                for n, ks in zip(names, want)):
            fail(f"profile {what}: ran {names}, want one kernel of each of "
                 f"{want} in order")
        seen[what] = {"kernels": names, "traces": traces,
                      "complete": complete}
        gap = "" if complete else ", incomplete: the tracer dropped a kernel"
        log(f"profile {what}: CUDA kernels {names} ({traces} trace(s){gap})")
    return seen


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
    ("binary_matmul", "binary_matmul",
     "src/repro_torch/kernels/csrc/binary_matmul.cu",
     "src/repro/kernels/binary_matmul.py:59"),
)
# the path whose run each kernel's launches are read from
PATH_OF = {"fused_bitwise": "serving", "fused_bitwise_stacked": "serving",
           "popcount_rows": "serving", "bitweaving_scan": "serving",
           "binary_matmul": "binary_lm"}


def _wrappers():
    from repro_torch.kernels import (binary_matmul, bitweaving, bitwise,
                                     popcount)
    mods = {"bitwise": bitwise, "popcount": popcount,
            "bitweaving": bitweaving, "binary_matmul": binary_matmul}
    return {name: getattr(mods[mod], name) for name, mod, _, _ in KERNELS}


def _path_launches(wrappers, path, drive):
    """Zero every count, run ``drive``, read the counts; fail if a kernel
    of ``path`` never launched."""
    for fn in wrappers.values():
        fn.launches = 0
    result = drive()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    log(f"launches on the {path} path: {launches}")
    idle = [n for n, c in launches.items() if PATH_OF[n] == path and c <= 0]
    if idle:
        fail(f"kernels never launched on the {path} path: {idle}")
    return result, launches


def binary_lm_phase(torch, card):
    """The example at its own width on the card, timed end to end."""
    from repro_torch.apps import binary_lm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc = binary_lm.main("cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not acc > 0.5:
        fail(f"binary_lm accuracy {acc} <= 0.5")
    log(f"binary_lm d=256 classes=8 examples=2048 steps=150 accuracy={acc} "
        f"wall_s={wall:.3f} on {card} (measured on the card, first call "
        f"of the example included)")
    return {"accuracy": acc, "wall_s": wall}


def _wall_ms(torch, fn, device, reps=3):
    """``fn()``'s result and the median wall ms of ``reps`` calls, each
    ended by a synchronise when it ran on the card."""
    times, out = [], None
    for _ in range(reps):
        _sync(torch, device)
        t0 = time.perf_counter()
        out = fn()
        _sync(torch, device)
        times.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(times)


def _cuda_events(torch, fn) -> dict:
    """The CUDA kernels and memory copies/sets of one call to ``fn``,
    counted by ``torch.profiler`` in the second of two steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    counts = {}

    def ready(prof):
        for e in prof.events():
            if (e.device_type == DeviceType.CUDA
                    and not e.name.startswith("ProfilerStep")):
                kind = ("copies" if e.name.startswith(("Memcpy", "Memset"))
                        else "kernels")
                counts[kind] = counts.get(kind, 0) + 1

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=torch.profiler.schedule(
                     wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=ready) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return counts


# The DRAM ledger (aap_count, ns, energy_nj, bytes_touched) of each
# fig20b_batched expression over 256 rows of 65,536 bits on the default
# geometry and timing: the reference package's values at this shape,
# which tests/test_torch_simulator.py holds against the reference and
# against the port on the CPU. The ledger depends on the program and the
# shape, not on the bits.
FIG20B_LEDGER = {
    "and": (1024, 50176.0, 6633.1648, 8388608),
    "xor": (1280, 88320.0, 10987.1616, 8388608),
    "xnor": (1536, 108800.0, 12559.0016, 8388608),
    "maj_xor_or": (3584, 209152.0, 25825.331199999993, 8388608),
}


def dram_model_phase(torch, card, wrappers):
    """The DRAM model (``ambit_sim``) with its row state on the card, at
    full width: the Figure-20 expressions over 256 rows of 65,536 bits
    (one full 8 KB row in each of the default geometry's 8 x 32
    subarrays), the weekly-active query over 2^24 users, a TMR scrub of a
    2^24-bit vector and the timing oracle. The bits must equal the "cuda"
    backend's, exactly, and the DRAM ledger on the card and on the CPU
    ``FIG20B_LEDGER``, the reference's at this shape. The reference has no
    kernel on this path, so the phase launches none of the hand-written
    kernels: their counts are printed, not required."""
    from repro_torch.apps.bitmap_index import BitmapIndex
    from repro_torch.core import (AmbitSubarray, BitVector,
                                  BulkBitwiseEngine, Expr, maj)
    from repro_torch.core import timing_checker
    from repro_torch.core.ecc import TMRCodec

    rng = np.random.default_rng(SEED + 6)
    X, Y, Z = Expr.var("x"), Expr.var("y"), Expr.var("z")
    exprs = {"and": X & Y, "xor": X ^ Y, "xnor": ~(X ^ Y),
             "maj_xor_or": maj(X, Y, Z) ^ (X | ~Z)}   # fig20b_batched's
    rows, n_bits = 256, 65536
    bits = rng.integers(0, 2, (3, rows, n_bits)).astype(bool)
    env = {dev: {k: BitVector.from_bits(b, device=dev)
                 for k, b in zip("xyz", bits)} for dev in ("cuda", "cpu")}
    # the "cuda" backend's bits, launched before the counted run
    kernel_bits = {name: BulkBitwiseEngine("cuda", device="cuda").eval(
        e, env["cuda"]).data for name, e in exprs.items()}
    torch.cuda.synchronize()

    for fn in wrappers.values():
        fn.launches = 0
    sim = {dev: BulkBitwiseEngine("ambit_sim", device=dev)
           for dev in ("cuda", "cpu")}
    per_row = BulkBitwiseEngine("ambit_sim", device="cuda", batch_rows=False)
    env8 = {k: BitVector(v.data[:8], n_bits) for k, v in env["cuda"].items()}
    report = {}
    for name, e in exprs.items():
        out, card_ms = _wall_ms(
            torch, lambda: sim["cuda"].eval(e, env["cuda"]), "cuda")
        st = sim["cuda"].last_stats
        out_cpu, cpu_ms = _wall_ms(
            torch, lambda: sim["cpu"].eval(e, env["cpu"]), "cpu")
        st_cpu = sim["cpu"].last_stats
        if not torch.equal(out.data, kernel_bits[name]):
            fail(f"ambit_sim {name} on the card != the 'cuda' backend")
        if not torch.equal(out_cpu.data, kernel_bits[name].cpu()):
            fail(f"ambit_sim {name} on the CPU != the 'cuda' backend")
        for where, got in (("card", st), ("CPU", st_cpu)):
            ledger = (got.aap_count, got.ns, got.energy_nj,
                      got.bytes_touched)
            if ledger != FIG20B_LEDGER[name]:
                fail(f"ambit_sim {name} ledger on the {where} {ledger} != "
                     f"the reference's {FIG20B_LEDGER[name]}")
        out8 = per_row.eval(e, env8)
        st8 = per_row.last_stats
        if not torch.equal(out8.data, out.data[:8]):
            fail(f"ambit_sim {name} batch_rows=False bits differ")
        # the per-row loop sums the same costs in another order: the
        # counts exactly, the float ns/energy to rel 1e-12
        if (st8.aap_count * rows != st.aap_count * 8
                or not np.isclose(st8.ns * rows, st.ns * 8, rtol=1e-12,
                                  atol=0)
                or not np.isclose(st8.energy_nj * rows, st.energy_nj * 8,
                                  rtol=1e-12, atol=0)):
            fail(f"ambit_sim {name} batch_rows=False ledger {st8} is not "
                 f"the batched {st} scaled to 8 rows")
        report[name] = {"card_ms": card_ms, "cpu_ms": cpu_ms,
                        "aap_count": st.aap_count, "ns": st.ns,
                        "energy_nj": st.energy_nj}
        log(f"ambit_sim {name} rows={rows} bits_per_row={n_bits} "
            f"aaps={st.aap_count} dram_ns={st.ns} energy_nj={st.energy_nj} "
            f"(DRAM model) wall_ms card={card_ms:.3f} cpu={cpu_ms:.3f} "
            f"(median of 3, measured on {card} and its host)")

    # what one eval runs on the card: CUDA kernels and copies, by
    # torch.profiler over the second of two steps (the first warms the
    # tracer up; a tracer that drops a record gives a lower count)
    report["cuda_events"] = {
        name: _cuda_events(torch, lambda: sim["cuda"].eval(e, env["cuda"]))
        for name, e in exprs.items()}
    log(f"ambit_sim cuda events an eval (torch.profiler): "
        f"{json.dumps(report['cuda_events'])}")

    # the share of an eval spent building its subarray: six 2 MiB rows
    # of boot content drawn with numpy on the host, moved to the device
    boot = {dev: _wall_ms(torch, lambda: AmbitSubarray(
        words=n_bits // 64, n_rows=rows, device=dev), dev)[1]
        for dev in ("cuda", "cpu")}
    report["boot_ms"] = boot
    log(f"ambit_sim subarray boot rows={rows} words={n_bits // 64} wall_ms "
        f"card={boot['cuda']:.3f} cpu={boot['cpu']:.3f} (median of 3)")

    n_users = 1 << 24
    idx = BitmapIndex(n_users, BulkBitwiseEngine("ambit_sim", device="cuda"))
    weeks = [f"w{i}" for i in range(4)]
    masks = {}
    for nm in weeks + ["male"]:
        members = rng.choice(n_users, n_users // 2, replace=False)
        masks[nm] = np.zeros(n_users, bool)
        masks[nm][members] = True
        idx.add(nm, members)
    (got_u, got_pw, st), weekly_ms = _wall_ms(
        torch, lambda: idx.weekly_active_query(weeks, "male"), "cuda",
        reps=1)
    want_u = int(np.logical_and.reduce([masks[w] for w in weeks]).sum())
    want_pw = [int((masks[w] & masks["male"]).sum()) for w in weeks]
    if (got_u, got_pw) != (want_u, want_pw) or not (
            st.ns > 0 and st.energy_nj > 0):
        fail(f"ambit_sim weekly_active {got_u},{got_pw},{st} != "
             f"{want_u},{want_pw}")
    log(f"ambit_sim weekly_active users={n_users} unique={got_u} "
        f"per_week={got_pw} dram_ns={st.ns} energy_nj={st.energy_nj} "
        f"mismatches=0 wall_ms={weekly_ms:.3f} on {card}")

    codec = TMRCodec(BulkBitwiseEngine("ambit_sim", device="cuda"))
    vec = BitVector.from_bits(bits[0].reshape(-1), device="cuda")
    replicas = codec.encode(vec)
    k = 4096
    flip = rng.choice(n_users, k, replace=False)
    bad = bits[0].reshape(-1).copy()
    bad[flip] ^= True
    replicas[1] = BitVector.from_bits(bad, device="cuda")
    if not torch.equal(codec.decode(replicas).data, vec.data):
        fail("TMR decode did not restore the vector")
    clean, corrected = codec.scrub(replicas)
    if corrected != k or not all(torch.equal(r.data, vec.data)
                                 for r in clean):
        fail(f"TMR scrub corrected {corrected} bits, flipped {k}")
    log(f"ambit_sim tmr bits={n_users} flipped={k} corrected={corrected}")

    if timing_checker.main([]) != 0:
        fail("timing oracle: violations")
    launches = {name: fn.launches for name, fn in wrappers.items()}
    log(f"launches on the dram_model path (none expected: the reference "
        f"runs no kernel here): {launches}")
    return report


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

    def serve():
        bitmap = serve_bitmaps(torch, "cuda", n_users=1 << 24, n_items=12,
                               n_tenants=1024, n_queries=2048)[3]
        weekly_active(torch, "cuda", n_users=1 << 24)
        tpch = serve_tpch(torch, "cuda", n_rows=6_001_215, n_tenants=1024,
                          n_queries=2048)
        log(f"serving wall qps on {card}: bitmap {bitmap['wall_qps']:.1f}, "
            f"tpch {tpch['wall_qps']:.1f} (mismatches=0 in both)")

    launches = {"serving": _path_launches(wrappers, "serving", serve)[1]}
    torch.cuda.empty_cache()

    log("== phase 4: the binary-LM path on the card")
    launches["binary_lm"] = _path_launches(
        wrappers, "binary_lm", lambda: binary_lm_phase(torch, card))[1]

    log("== phase 5: what the popcount and scan paths run on the card "
        "(torch.profiler)")
    profiled = profile_phase(torch)
    torch.cuda.empty_cache()

    log("== phase 6: the DRAM model on the card (backend 'ambit_sim')")
    t_phase = time.perf_counter()
    dram = dram_model_phase(torch, card, wrappers)
    log(f"dram_model phase_s={time.perf_counter() - t_phase:.1f} "
        f"wall_ms={json.dumps(dram)} card: {card}")

    kernels = []
    for name, _, source, replaces in KERNELS:
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "path": PATH_OF[name],
            "launches": launches[PATH_OF[name]][name],
            "checks": checks[name]["checks"],
            "max_abs_err": checks[name]["max_abs_err"], "ms": t["ms"],
            "launch_ms": t["launch_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": t["shape"],
            **{k: t[k] for k in ("yardstick_ms", "empty_kernel_ms",
                                 "more") if k in t}})
    log(f"total_s={time.perf_counter() - t_start:.1f} card: {card}")
    print(json.dumps({"profile": profiled}), flush=True)
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
