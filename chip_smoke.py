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
   moves the same bytes), and the least time the card could take; the
   fused kernel also on TPC-H planes at SF 300 (a Q1, a Q14, two Q6 and a
   22-load AND chain, each with its shared-memory bytes a word, every
   launch walking its persistent blocks' tiles);
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
7. the PIM runtime on the DRAM model (``AmbitRuntime(backend=
   "ambit_sim", device="cuda")``) with its row state on the card: (a) the
   resident chain of ``kern_pim_resident_chain`` (6 ANDs over 128 rows of
   65,536 bits; one host read, the session ledger equal to the
   reference's), (b) ``kern_pim_sharded_scan`` on 4 devices (the measured
   inter-device rows, bytes and channel ns equal to the reference's), (c)
   ``kern_pim_optimizer``'s mix drained with ``optimize=True`` (the
   rewrites and AAP counts equal to the reference's), then on backend
   "cuda", where the optimized drains must launch ``fused_bitwise`` and
   ``fused_bitwise_stacked``, (d) ``faults_tmr_overhead`` and
   ``faults_serve_r001``/``r010`` (every answer equal to numpy, the fault
   ledgers equal to the reference's) and a host fallback after a device
   loss, which must launch ``fused_bitwise``, (e) the phase-3 bitmap mix
   at full width (2^24 users, 12 bitmaps, the default geometry) as
   closed-loop queries for about 20 s, every count against numpy, with
   the wall ms a query, the DRAM model's p50/p99 and one query's CUDA
   kernels and copies;
8. the LM path (``repro_torch.data``, ``models``, ``serve.engine``):
   (a) ``filter_documents`` over 2^24 documents (the quality column's 8
   planes and the length column's 12, 524,288 words each) on the card,
   the mask equal to numpy's and to the plain scan's, with exactly two
   ``bitweaving_scan`` launches for the call, and ``FilteredSyntheticLM``'s
   ``doc_ids``; (b) qwen2.5-3b at its full widths with its depth cut to 2
   layers, the card's prefill and three teacher-forced decode logits
   within 5e-2 (max-rel) of the CPU port's on the same weights, and its
   decode within 1e-1 of its forward; (c) qwen2.5-3b at full width and
   depth (36 layers, 3.40 B float32 parameters) behind ``ServeEngine``
   (4 slots, ``max_seq`` 256), 8 requests of 16 new tokens, greedy and
   at temperature 0.7, under the termination contract, with the prefill
   ms a batch, the decode ms a step, tokens/s and peak memory printed;
   its launch counts are read for this phase alone, on a line of their
   own;
9. the LM stack's other families (``models/moe.py``, ``models/ssm.py``,
   the hybrid, encoder-decoder, sliding-window and VLM stacks): (a) at
   full width with the depth cut (granite-moe-3b-a800m 2 layers,
   mamba2-780m 2 layers over a 300-token prompt, three SSD chunks of
   128, zamba2-2.7b 6 layers, one group and its shared block,
   whisper-small 2+2 layers at 1500 frames, gemma3-1b 6 layers, five
   local and one global, over a 1100-token prompt past its 1024-token
   window, qwen2-vl-7b 2 layers over 256 image embeddings on a 16 x 16
   grid of M-RoPE positions and 8 text tokens (``lm_batch``),
   internlm2-20b and deepseek-67b 2 layers), the card's prefill and
   three decode logits within 5e-2 of the CPU port's on the same weights
   (MoE: on the rows whose routing agrees; the tokens routed elsewhere
   at layer 0 are printed), end to end and with every attention core fed
   the CPU's inputs and outputs (the forward too; each core's output,
   and each of its inputs the card computed, held on its own; the
   attention of ``HARD_ATTENTION``'s archs flips keys on an ulp at this
   init, so their end-to-end numbers are printed), and the card's
   decode within 1e-1 of its forward (MoE: at a capacity that drops
   nothing, the configured capacity's drops and numbers printed;
   ``HARD_ATTENTION``: with each prefill and decode core fed the
   forward's rows and its inputs held against the forward's, the
   unforced numbers printed);
   (b) granite-moe, mamba2, zamba2, gemma3-1b (8 prompts of 1030-1100
   tokens, ``max_seq`` 1280) and qwen2-vl-7b (text prompts) at full
   width and depth behind ``ServeEngine`` as phase 8(c) serves
   qwen2.5-3b, whisper-small through
   ``Model.prefill`` with 4 x 1500 frames and 16 greedy steps, and
   qwen3-moe-235b-a22b at full width with one layer (decode within 1e-1
   of its forward), each with prefill and decode ms, tokens/s, peak
   memory and one profiled decode step; (c) granite's routing over a
   4 x 256-token batch at each of its 32 layers through
   ``expert_bitmask_stats`` on ``BulkBitwiseEngine("cuda")``: one
   ``popcount_rows`` launch a call, loads equal to ``numpy.bincount``,
   masks equal to the plain version's;
10. training (``repro_torch.optim``, ``train``, ``checkpoint``,
   ``runtime``, ``launch.train``): (a) one train step
   (``remat="save_attn"``) at full width with the depth cut, batch 2
   unless ``TRAIN_PARITY`` says,
   on the card against the CPU port on the same weights: qwen2.5-3b 2
   layers over 128 tokens, granite-moe-3b-a800m 2 layers at a capacity
   that drops nothing, mamba2-780m 2 layers over 300 tokens (three SSD
   chunks): the loss within 5e-3 relative, grad_norm and each gradient
   leaf within 5e-2 (norm-relative), unforced and with every attention
   core fed the CPU's inputs and outputs (``_Attention``: the gradient
   passes straight through), the archs of ``TRAIN_FORCED`` held by the
   latter; ``optim.update`` fed the CPU's gradients within 1e-5 of the
   CPU's update; ``make_train_step`` itself on the card moving every
   leaf; also zamba2-2.7b 6 layers, whisper-small 2+2 layers at 1500
   frames, gemma3-1b 6 layers over 1040 tokens and qwen2-vl-7b 2 layers
   over its image inputs (both batch 1), every one of these held with
   the cores fed; zamba2's shared ln1 and qwen2-vl's k bias by their
   difference over the global gradient norm, with a float64 step of
   the same weights and batch on the CPU, which the card's own leaf must
   be no farther from than twice the CPU's (``TRAIN_ILL_CONDITIONED``);
   (b) qwen2.5-3b at full width and depth (36
   layers, 3.40 B float32 parameters) trained by ``make_train_step``
   (``launch/train``'s optimizer, batch 8 x 128) for 20 steps on
   ``FilteredSyntheticLM``'s batches (two ``bitweaving_scan`` launches):
   every loss and parameter finite; step ms, tokens/s, peak memory and
   one profiled step (kernels, device ms, idle share); its loss curve
   and grad norms printed (at the reference's init the 36-layer
   gradient norm passes float32's range and the loss does not fall);
   (c) ``launch.train.main --reduced --device cuda`` for 30 steps, then
   ``--resume`` to 40: the first run's loss falls (the mean of its last
   5 steps below its first 5's), the resumed run starts at step 30, each
   run's final checkpoint equals its live state bit for bit, two
   ``bitweaving_scan`` launches a run; the phase's launch counts are
   read for this phase alone;
11. the multi-device layer (``launch.mesh``, ``models.sharding_ctx``,
   the mesh paths of ``models``, ``train``, ``checkpoint`` and
   ``launch.train``, ``runtime.pipeline``) on a (1,1) mesh over a
   one-rank NCCL group the phase starts (one card: every collective
   across more than one rank is held on the CPU, on 8 gloo ranks, by
   ``tests/test_torch_distributed.py``): (a) qwen2.5-3b at full width, 2
   layers, batch 2 x 128, one ``make_train_step(mesh=)`` step from
   ``init_state(mesh=)`` against the mesh-free step, and granite-moe at
   full width, 2 layers, ``Model.forward(mesh=)`` on sharded parameters
   against the mesh-free forward, both bit for bit (one rank adds no
   arithmetic) and calling no collective (each printed); mamba2-780m (2
   layers over 300 tokens), zamba2-2.7b (6 layers: one group and its
   shared block) and whisper-small (2+2 layers at 1500 frames) at full
   width, each through ``forward``, ``prefill`` and 3 ``decode_step``
   on the mesh, and mamba2 through one ``make_train_step(mesh=)`` step,
   bit for bit against the mesh-free calls with no collective (their
   layers split over "model" as the decoders' do); and the memory
   that ``init_state(mesh=)``, a sharded
   ``save`` and ``restore(mesh=, spec_tree=)`` hold above the state,
   each at most two whole leaves (a leaf is drawn, gathered or read
   whole one at a time), the restore bit for bit; (b) qwen2.5-3b as
   configured, 3 steps of the sharded trainer on phase 10(b)'s batches
   (two ``bitweaving_scan`` launches), its step ms, tokens/s, peak
   memory and one profiled step beside 10(b)'s, then one more step
   under ``FlopCounterMode`` (for 12(b)); (c) ``launch.train --reduced
   --device cuda`` inside the phase's group, 30 steps then ``--resume`` to 40 through
   ``restore(mesh=, spec_tree=)``, two scan launches a run, each final
   checkpoint equal to the live (DTensor) state; (d) ``compressed_psum``
   over the group equal to ``q*s/1``, ``pipeline`` with one stage against
   the sequential application (1e-5) with a finite nonzero gradient, a
   checkpoint saved without a mesh restored onto the mesh bit for bit;
   the phase's launch counts are read for this phase alone;
12. the dry-run (``launch.dryrun``) on the card machine, each run in a
   process of its own over a fake process group, its fake tensors on
   the card: (a) qwen2.5-3b ``train_4k``, qwen3-moe-235b-a22b
   ``decode_32k`` (2-D expert parallelism) and zamba2-2.7b ``train_4k``
   on (16,16), mamba2-780m ``long_500k`` (batch 1) on (2,16,16),
   through the CLI: each prints its
   OK line, every figure is finite, FLOPs, traffic and collective bytes
   a rank are positive, the argument bytes equal the spec trees' shards
   exactly, and each cell's trace time, roofline terms, dominant term and
   peak against the card's memory are printed, its FLOPs, collective
   bytes and peak a rank beside those of the design before its layers
   split over "model" (``DRYRUN_BEFORE``); the 2-D EP cell's experts
   lie one a rank and do not move, so its collective bytes a rank must
   stay below one layer's expert stack (``3 * e_pad * d_model *
   d_ff_expert * 2`` B from the config); (b) phase 11(b)'s step
   traced on a (1,1) fake mesh: its FLOPs equal ``FlopCounterMode`` over
   11(b)'s extra step, its peak above the arguments within 5% of that
   step's peak above the bytes live before it, its kernel-launching ops
   and roofline bound printed beside the profiled step's kernels and
   device ms. It launches no hand-written kernel;
13. the entry points a user runs (``repro_torch.examples``,
   ``launch.serve``): (a) ``quickstart`` and ``bitmap_analytics`` on the
   card, then on the CPU, every printed count, AAP count, byte count, ns
   and nJ figure equal between the two runs; quickstart's ``cuda`` XOR
   one ``fused_bitwise`` launch, bitmap_analytics' resident ``cuda``
   query two fused launches (the planner's count) beside its engine's
   and runtime's ``popcount_rows`` launches; (b) ``train_lm --preset
   100m`` for 60 steps, its loss falling, two ``bitweaving_scan``
   launches a run, then ``--resume`` to 70 from the step-60 checkpoint,
   which equals the first run's live state bit for bit; (c)
   ``launch.serve --arch whisper-small --no-reduced --device cuda``, 4
   greedy requests with their frames, whose tokens equal
   ``Model.prefill`` and ``decode_step`` driven by hand on the same
   weights and frames (serve wall time and peak memory, decode ms a step
   by hand); (d) mamba2-780m and zamba2-2.7b at phase 9's widths and
   depths behind ``ServeEngine`` with prompts of one and two tokens, each
   step within 1e-1 of the forward over the prompt and the tokens
   generated so far (zamba2, in ``HARD_ATTENTION``, with its cores fed
   the forward's rows, unforced printed); the phase's launch counts are
   read for this phase alone;
14. one ``{"profile": {...}}`` JSON line with phase 5's traces, one
   ``{"kernels": [...]}`` JSON line, then the result line.

Each path must launch its own kernels: the four serving kernels on
phase 3, ``binary_matmul`` on phase 4, ``bitweaving_scan`` on phases 8,
10 and 11 too, ``popcount_rows`` on phase 9 too, and all four but
``binary_matmul`` on phase 13. A kernel required on several
paths (``PATH_OF``) reports its launches on each (``launches_by_path``)
and their sum (``launches``).

The fused kernel alone, its checks and timings of phase 2 (the kernel
table's shapes and the served TPC-H programs at SF 300) and nothing else:

    python3 chip_smoke.py --fused [--src DIR]

``--src`` imports ``repro_torch`` from ``DIR`` (say, another version's
``src`` unpacked beside this one) to time two versions in one call.

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
            if k and k.group(2) and "WideParams" in k.group(2):
                name += " (WideParams)"       # the wide route's block
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


def fused_exprs():
    """The programs the fused kernel is checked on: each opcode, literals,
    the 8-plane scan, a program of 64 live registers and, where the tree's
    kernel takes them, one of 48 loads (the wide route)."""
    from repro_torch.apps.bitweaving_db import scan_expr
    from repro_torch.core import expr as E
    from repro_torch.kernels import bitwise as kbw
    X, Y, Z = E.Expr.var("x"), E.Expr.var("y"), E.Expr.var("z")
    wide = {}
    if kbw.MAX_OPERANDS >= 48:
        wide["wide48"] = (scan_expr(12, 3, 4000, prefix="a")
                          & scan_expr(12, 100, 101, prefix="b")
                          & scan_expr(12, 0, 2047, prefix="c")
                          & ~scan_expr(12, 7, 3000, prefix="d"))
    return wide | {
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


def check_fused(torch, rng, exprs, stats):
    """fused_bitwise and fused_bitwise_stacked against their plain versions
    on the card, exactly: every program at short, split and long rows,
    masked, 4 bytes off a 16-byte boundary, in place, stacked (past the
    by-value pointer table too), and in the TPC-H layout."""
    from repro_torch.core import expr as E
    from repro_torch.kernels import bitwise as kbw
    shapes = [(1, 524288), (1, 7), (129,), (2, 3, 40), (257, 8), (187538,)]
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


def check_kernels(torch):
    """Every kernel against its plain version on the card, exactly.
    Returns kernel name -> {"checks", "max_abs_err"} (0 when all agree)."""
    from repro_torch.core.engine import BulkBitwiseEngine
    from repro_torch.core.bitvector import BitVector
    from repro_torch.kernels import binary_matmul as kbmm
    from repro_torch.kernels import build

    rng = np.random.default_rng(SEED)
    stats: dict = {}
    exprs = fused_exprs()
    check_fused(torch, rng, exprs, stats)
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
    fb = "fused_bitwise"
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


def row_timer(timer):
    """``row(name, shape, kernel, plain, library, nbytes, ops)``: one timed
    row of the kernel table (device and host-path ms of the kernel, its
    plain version's, the library call's, and the bound)."""

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

    return row


def time_kernels(torch, timer):
    """Each kernel at the main path's shapes. Returns name -> numbers."""
    rng = np.random.default_rng(SEED + 1)
    row = row_timer(timer)
    out, x = time_fused(torch, rng, timer, row)
    out.update(time_popcount_and_scan(torch, rng, timer, row, x))
    out["binary_matmul"] = time_binary_matmul(torch, rng, row)
    return out


def time_fused(torch, rng, timer, row):
    """The fused kernels at the bitmap and SF 1 shapes of the kernel table,
    then at SF 300 (``time_sf300``). Returns (name -> numbers, the bitmap
    row x, which the popcount rows reuse)."""
    from repro_torch.apps.bitweaving_db import scan_expr
    from repro_torch.core import expr as E
    from repro_torch.kernels import bitwise as kbw

    X, Y = E.Expr.var("x"), E.Expr.var("y")
    out = {}
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
            (len(sprog.packed) - sprog.n_loads) * 187538))
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
    out["fused_bitwise"]["sf300"] = time_sf300(torch, timer)
    out["fused_bitwise"]["ssb300"] = time_ssb300(torch, timer)
    return out, x


# TPC-H at SF 300 as the benchmark's `tpch-sf300` holds it: 1,800,364,500
# lineitem rows, a plane of 56,261,391 words (225,045,564 bytes) a bit,
# each column one (bits, words) tensor whose rows (the planes) start 0, 4,
# 8 or 12 bytes past a 16-byte boundary.
SF300_ROWS = 1_800_364_500
SF300_WORDS = -(-SF300_ROWS // 32)
SF300_COLUMNS = (("l_shipdate", 12), ("l_discount", 4), ("l_quantity", 6))


def _tpch_days(y, m, d):
    import datetime
    return (datetime.date(y, m, d) - datetime.date(1992, 1, 1)).days


def _range_plan(columns, label, spec):
    """(label, expression, names) of a conjunction of ``(column, lo, hi)``
    ranges over the BitWeaving planes of ``columns`` ((name, bits) pairs),
    as ``predicate_plan`` builds it."""
    from repro_torch.apps.bitweaving_db import scan_expr
    bits = dict(columns)
    expr, names = None, []
    for col, lo, hi in spec:
        term = scan_expr(bits[col], lo, hi, prefix=f"{col}_b")
        names += [f"{col}_b{i}" for i in range(bits[col])]
        expr = term if expr is None else expr & term
    return label, expr, tuple(sorted(names))


def sf300_programs():
    """(label, expression, names) of the served mix's programs, timed at
    SF 300: a Q1 (delta 90), a Q14 (1995-07), two Q6 (1996, discount
    0.07, quantity 25: 100 instructions; 1995, 0.05, 24: 116) and the
    control: the same 22 loads as Q6 and a chain of 21 ANDs."""
    from repro_torch.core import expr as E

    def plan(label, spec):
        return _range_plan(SF300_COLUMNS, label, spec)

    def q6(year, d, q):
        return [("l_shipdate", _tpch_days(year, 1, 1),
                 _tpch_days(year + 1, 1, 1) - 1),
                ("l_discount", d - 1, d + 1), ("l_quantity", 0, q - 1)]

    out = [plan("Q1 (12 loads)",
                [("l_shipdate", 0, _tpch_days(1998, 12, 1) - 90)]),
           plan("Q14 (12 loads)", [("l_shipdate", _tpch_days(1995, 7, 1),
                                    _tpch_days(1995, 8, 1) - 1)]),
           plan("Q6 1996 (22 loads)", q6(1996, 7, 25)),
           plan("Q6 1995 (22 loads)", q6(1995, 5, 24))]
    names = out[2][2]
    chain = E.Expr.var(names[0])
    for nm in names[1:]:
        chain = chain & E.Expr.var(nm)
    out.append(("AND chain (22 loads)", chain, names))
    return out


def time_sf300(torch, timer):
    """The fused kernel on SF 300 planes, launched as serving launches it
    (row views, masked to the table's rows): device ms beside the HBM bound
    (every loaded plane read once, the result written once, at 3.35 TB/s)
    and the program's shared-memory bytes a word; each result checked
    against the plain version once."""
    from repro_torch.kernels import bitwise as kbw
    gen = torch.Generator(device="cuda").manual_seed(SEED + 300)
    planes = {}
    for col, bits in SF300_COLUMNS:
        t = torch.randint(-2 ** 31, 2 ** 31, (bits, SF300_WORDS),
                          dtype=torch.int32, device="cuda", generator=gen)
        planes.update({f"{col}_b{i}": v for i, v in enumerate(t.unbind(0))})
    rows = []
    launches = kbw.fused_bitwise.launches
    rings = getattr(kbw.fused_bitwise, "ring_launches", None)
    for label, expr, names in sf300_programs():
        prog = kbw.lower(expr, names)
        arrays = [planes[nm] for nm in names]
        got = kbw.fused_bitwise(expr, names, arrays, prog,
                                n_bits=SF300_ROWS)
        want = kbw.fused_bitwise_plain(expr, names, arrays, SF300_ROWS)
        if not torch.equal(got, want):
            fail(f"fused_bitwise {label} at SF 300: kernel != plain in "
                 f"{(got != want).sum().item()} words")
        del got, want
        ms, launch_ms = timer(lambda: kbw.fused_bitwise(
            expr, names, arrays, prog, n_bits=SF300_ROWS))
        nbytes = (prog.n_loads + 1) * 4 * SF300_WORDS
        r = {"program": label, "instructions": len(prog.packed),
             "loads": prog.n_loads, "registers": prog.shared_regs,
             "smem_bytes_per_word": prog.smem_bytes_per_word,
             "ms": ms, "launch_ms": launch_ms,
             "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
             "hbm_tb_s": nbytes / ms / 1e9,
             "hbm_share": nbytes / HBM_BYTES_PER_S * 1e3 / ms}
        log(f"time fused_bitwise SF 300 {label}: {r['instructions']} "
            f"instructions, {r['registers']} registers, "
            f"{r['smem_bytes_per_word']} shared-memory B/word: kernel "
            f"{ms:.6f} ms on the device ({launch_ms:.6f} ms with the host's "
            f"launch path), bound {r['bound_ms']:.6f} ms (bytes), "
            f"{r['hbm_tb_s']:.3f} TB/s, {100 * r['hbm_share']:.1f}% of HBM")
        rows.append(r)
    launches = kbw.fused_bitwise.launches - launches
    if rings is not None:           # every SF 300 launch walks a ring
        rings = kbw.fused_bitwise.ring_launches - rings
        if rings != launches:
            fail(f"fused_bitwise at SF 300: {rings} of {launches} launches "
                 "walked more than one tile a block")
    log(f"fused_bitwise SF 300: {launches} launches, {rings} walked more "
        "than one tile a block")
    del planes
    torch.cuda.empty_cache()
    return rows


# The Star Schema Benchmark at SF 300 as the benchmark's `ssb-sf300-flat`
# holds it: 1,800,000,000 lineorder rows, a plane of 56,250,000 words
# (225,000,000 bytes) a bit; Q4.2 and Q4.3 range over these four columns.
SSB300_ROWS = 1_800_000_000
SSB300_WORDS = -(-SSB300_ROWS // 32)
SSB300_COLUMNS = (("c_city", 8), ("s_city", 8), ("lo_orderdate", 12),
                  ("p_brand1", 10))


def ssb300_programs():
    """(label, expression, names) of SSB Q4.2 and Q4.3 as the cell plans
    them: conjunctions over all 38 planes of the four columns."""
    years = (_tpch_days(1997, 1, 1), _tpch_days(1999, 1, 1) - 1)
    return [_range_plan(SSB300_COLUMNS, "SSB Q4.2 (38 loads)",
                        [("c_city", 50, 99), ("s_city", 50, 99),
                         ("lo_orderdate", *years), ("p_brand1", 0, 399)]),
            _range_plan(SSB300_COLUMNS, "SSB Q4.3 (38 loads)",
                        [("c_city", 50, 99), ("s_city", 90, 99),
                         ("lo_orderdate", *years), ("p_brand1", 120, 159)])]


def time_ssb300(torch, timer, q=16):
    """SSB Q4.2 and Q4.3 on SF 300 planes, each one launch on the wide
    route: alone, then as an epoch of ``q`` repeats of the query (one
    stacked launch, as a drain of repeated dashboard queries launches it:
    one job, its pointers by value, on a tree that evaluates a repeated
    job once; else ``q`` evaluations, their pointers in a device table);
    and Q4.2 as a control epoch of ``q`` distinct operand rows (the planes
    rotated among the names: ``q`` jobs, the table on either tree). Device
    ms beside the HBM bound (alone: every plane read once and the result
    written; the repeats: the same planes once and ``q`` results; the
    control: each row's planes and its result), each result checked
    against the plain version. Skipped (an empty list) on a tree whose
    kernel takes fewer operands."""
    from repro_torch.kernels import bitwise as kbw
    if kbw.MAX_OPERANDS < 38:
        log(f"SSB SF 300: skipped, this tree's fused_bitwise takes at most "
            f"{kbw.MAX_OPERANDS} operands")
        return []
    gen = torch.Generator(device="cuda").manual_seed(SEED + 301)
    planes = {}
    for col, bits in SSB300_COLUMNS:
        t = torch.randint(-2 ** 31, 2 ** 31, (bits, SSB300_WORDS),
                          dtype=torch.int32, device="cuda", generator=gen)
        planes.update({f"{col}_b{i}": v for i, v in enumerate(t.unbind(0))})
    rows = []
    plane_bytes = 4 * SSB300_WORDS
    for label, expr, names in ssb300_programs():
        prog = kbw.lower(expr, names)
        if prog.n_loads <= kbw.WARP_LOADS:
            fail(f"{label}: {prog.n_loads} loads, not the wide route")
        arrays = [planes[nm] for nm in names]
        want = kbw.fused_bitwise_plain(expr, names, arrays, SSB300_ROWS)
        wide, table = (kbw.fused_bitwise.wide_launches,
                       kbw.fused_bitwise_stacked.table_launches)
        shared = getattr(kbw.fused_bitwise_stacked, "shared_outputs", None)
        got = kbw.fused_bitwise(expr, names, arrays, prog,
                                n_bits=SSB300_ROWS)
        if not torch.equal(got, want):
            fail(f"fused_bitwise {label} at SF 300: kernel != plain in "
                 f"{(got != want).sum().item()} words")
        del got
        outs = kbw.fused_bitwise_stacked(expr, names, [arrays] * q, prog,
                                         n_bits=SSB300_ROWS)
        bad = [k for k, o in enumerate(outs) if not torch.equal(o, want)]
        if bad:
            fail(f"fused_bitwise_stacked {label} x {q} at SF 300: queries "
                 f"{bad} differ from the plain version")
        del outs, want
        route = (kbw.fused_bitwise.wide_launches - wide,
                 kbw.fused_bitwise_stacked.table_launches - table)
        if shared is None and route != (1, 1):
            fail(f"{label}: the launches did not take the wide route and "
                 "the device table")
        if shared is not None and (route, kbw.fused_bitwise_stacked.
                                   shared_outputs - shared) != ((1, 0), q - 1):
            fail(f"{label}: the launches did not take the wide route, the "
                 f"epoch not one job by value with {q - 1} shared outputs")
        timed = [("alone", lambda: kbw.fused_bitwise(
                      expr, names, arrays, prog, n_bits=SSB300_ROWS),
                  (prog.n_loads + 1) * plane_bytes),
                 (f"{q}-query epoch", lambda: kbw.fused_bitwise_stacked(
                     expr, names, [arrays] * q, prog, n_bits=SSB300_ROWS),
                  (prog.n_loads + q) * plane_bytes)]
        if not rows:                    # Q4.2: the control epoch
            rotated = [arrays[k:] + arrays[:k] for k in range(q)]
            outs = kbw.fused_bitwise_stacked(expr, names, rotated, prog,
                                             n_bits=SSB300_ROWS)
            for k, (o, a) in enumerate(zip(outs, rotated)):
                if not torch.equal(o, kbw.fused_bitwise_plain(
                        expr, names, a, SSB300_ROWS)):
                    fail(f"fused_bitwise_stacked {label} control epoch: "
                         f"query {k} differs from the plain version")
            del outs
            timed.append((f"{q}-query epoch of distinct rows (control)",
                          lambda: kbw.fused_bitwise_stacked(
                              expr, names, rotated, prog,
                              n_bits=SSB300_ROWS),
                          q * (prog.n_loads + 1) * plane_bytes))
        for what, fn, nbytes in timed:
            ms, launch_ms = timer(fn)
            r = {"program": f"{label} {what}",
                 "instructions": int(prog.packed.shape[0]),
                 "loads": prog.n_loads, "registers": prog.shared_regs,
                 "smem_bytes_per_word": prog.smem_bytes_per_word,
                 "ms": ms, "launch_ms": launch_ms,
                 "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                 "hbm_share": nbytes / HBM_BYTES_PER_S * 1e3 / ms}
            log(f"time fused_bitwise SSB SF 300 {label} {what}: "
                f"{r['instructions']} kernel instructions, "
                f"{r['registers']} registers, {r['smem_bytes_per_word']} "
                f"shared-memory B/word: kernel {ms:.6f} ms on the device "
                f"({launch_ms:.6f} ms with the host's launch path), bound "
                f"{r['bound_ms']:.6f} ms (bytes), "
                f"{100 * r['hbm_share']:.1f}% of it")
            rows.append(r)
    del planes
    torch.cuda.empty_cache()
    return rows


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
        "bitweaving_scan", "(8,524288) (the LM filter's quality column)",
        lambda: kbv.bitweaving_scan(wide, 64, 250),
        lambda: kbv.bitweaving_scan_plain(wide, 64, 250), None,
        9 * 4 * 524288, 8 * 6 * 524288))
    lengths = _rand_words(torch, rng, (12, 524288))
    r["more"].append(row(
        "bitweaving_scan", "(12,524288) (the LM filter's length column)",
        lambda: kbv.bitweaving_scan(lengths, 256, 4095),
        lambda: kbv.bitweaving_scan_plain(lengths, 256, 4095), None,
        13 * 4 * 524288, 12 * 6 * 524288))
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
# the paths each kernel must launch on; its launches are read from each
# path's own run
PATH_OF = {"fused_bitwise": ("serving", "entry_points"),
           "fused_bitwise_stacked": ("serving", "entry_points"),
           "popcount_rows": ("serving", "lm_families", "entry_points"),
           "bitweaving_scan": ("serving", "lm", "train", "mesh",
                               "entry_points"),
           "binary_matmul": ("binary_lm",)}


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
    idle = [n for n, c in launches.items() if path in PATH_OF[n] and c <= 0]
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
    counted by ``torch.profiler`` in the second of two steps, and their
    summed device ms."""
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
                counts["device_ms"] = counts.get("device_ms", 0.0) + \
                    e.time_range.elapsed_us() / 1e3

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


# The reference package's session OpStats (ns, energy_nj, aap_count,
# bytes_touched, channel_ns, channel_bytes, refresh_stolen_ns) of
# ``kern_pim_resident_chain`` (benchmarks/kernels_micro.py): 6 resident
# ANDs over 128 rows of 65,536 bits on banks=8, subarrays=4, seed=1.
# tests/test_torch_pim.py holds it against the reference.
PIM_CHAIN_LEDGER = (18816.0, 19899.4944, 3072, 8388608, 0.0, 0,
                    7071.785234899329)
# ``kern_pim_sharded_scan``'s measured inter-device rows, bytes and
# channel ns on devices=4 after its mis-placed operand (the reference's).
PIM_SHARDED_LEDGER = (48, 393216, 53952.0)
# ``kern_pim_optimizer``'s (cse_hits, cse_materialized, cache_hits of the
# second optimized round, and the AAPs of the unoptimized, optimized and
# cached drains): the reference's.
PIM_OPT_LEDGER = (51, 152, 24, 3072, 685, 0)
# ``faults_tmr_overhead``'s upload bytes, session OpStats and (empty)
# fault ledger, plain and TMR-protected: the reference's, as
# ``tmr_overhead_session`` prints them.
FAULTS_TMR_LEDGER = (
    "plain upload=256 OpStats(ns=4310.0, energy_nj=2060.0927999999994, "
    "aap_count=240, bytes_touched=1024, channel_ns=0.0, channel_bytes=0, "
    "refresh_stolen_ns=809.9328859060402) faults=[]; tmr upload=768 "
    "OpStats(ns=22230.0, energy_nj=10300.463999999996, aap_count=1200, "
    "bytes_touched=1536, channel_ns=0.0, channel_bytes=0, "
    "refresh_stolen_ns=4177.449664429531) faults=[]")
# ``faults_serve_r001``/``r010``'s fault ledgers (injected stuck rows and
# the quarantines that answered them): the reference's.
FAULTS_SERVE_LEDGER = {
    0.001: ("stuck_row dev=0 slot=(1, 1, 45) op=compute; "
            "quarantine dev=0 slot=(1, 1, 45)"),
    0.01: ("stuck_row dev=0 slot=(3, 0, 26) op=compute; "
           "quarantine dev=0 slot=(3, 0, 26); "
           "stuck_row dev=0 slot=(0, 0, 29) op=compute; "
           "quarantine dev=0 slot=(0, 0, 29); "
           "stuck_row dev=0 slot=(1, 1, 45) op=compute; "
           "quarantine dev=0 slot=(1, 1, 45)"),
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

# -- phase 7 ------------------------------------------------------------------
#
# The PIM runtime on the DRAM model (``AmbitRuntime(backend="ambit_sim")``)
# with its row state on the card. Each session below is written against a
# package's entry points through ``PimApi``, so tests/test_torch_pim.py and
# tests/test_torch_faults.py run the same sessions on the reference package
# and on the port on the CPU, and hold them to the constants pinned here.

class PimApi:
    """The PIM runtime entry points of one package on one device
    (``device=None`` leaves the package's default: the reference's)."""

    def __init__(self, core, pim, faults, serve, device):
        import importlib
        self.core, self.pim, self.faults, self.serve = core, pim, faults, \
            serve
        self.Expr = core.Expr
        self.kw = {} if device is None else {"device": device}
        top = core.__name__.split(".")[0]
        self.bitweaving = importlib.import_module(
            top + ".apps.bitweaving_db")
        self.bitmap_index = importlib.import_module(
            top + ".apps.bitmap_index")

    def runtime(self, **kw):
        return self.pim.AmbitRuntime(**kw, **self.kw)

    def bv(self, bits):
        return self.core.BitVector.from_bits(bits, **self.kw)

    def injector(self, **cfg):
        return self.faults.FaultInjector(self.faults.FaultConfig(**cfg),
                                         **self.kw)

    @staticmethod
    def bits(bv):
        b = bv.bits()
        return b.cpu().numpy() if hasattr(b, "cpu") else np.asarray(b)

    @staticmethod
    def words(data):
        d = data.cpu().numpy() if hasattr(data, "cpu") else np.asarray(data)
        return d.view(np.uint32)


def _astuple(st):
    import dataclasses
    return dataclasses.astuple(st)


def _resident_and_chain(api, rt, bits):
    """put every vector ``near=`` the first, AND them in a chain freeing
    the intermediates in-DRAM, read back only the result."""
    rs = []
    for b in bits:
        rs.append(rt.put(api.bv(b), near=rs[0].slots if rs else None))
    acc = rs[0]
    for r in rs[1:]:
        prev = acc
        acc = rt.and_(acc, r)
        if prev is not rs[0]:
            rt.free(prev)
    return acc, rt.get(acc)


def resident_chain_session(api, rows=128, n_ops=6, n_bits=65536):
    """``kern_pim_resident_chain`` (benchmarks/kernels_micro.py): 6
    resident ANDs over ``rows`` rows of 65,536 bits on banks=8,
    subarrays=4, seed=1."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (n_ops + 1, rows, n_bits)).astype(bool)
    rt = api.runtime(banks=8, subarrays=4, seed=1)
    _, got = _resident_and_chain(api, rt, bits)
    want = np.bitwise_and.reduce(bits, axis=0)
    return {"mismatches": int((api.bits(got) != want).any()),
            "host_reads": rt.host_reads,
            "session": _astuple(rt.session_stats),
            "metrics": rt.metrics_snapshot()}


def sharded_scan_session(api, rows=64, n_ops=6, n_bits=65536):
    """``kern_pim_sharded_scan``: the same chain over 4 devices with
    round-robin chunks (no transfers), then an AND with an operand
    packed onto device 0, whose chunks the cluster moves."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (n_ops + 1, rows, n_bits)).astype(bool)
    rt = api.runtime(banks=4, subarrays=2, devices=4, seed=1)
    acc, _ = _resident_and_chain(api, rt, bits)
    aligned_bytes = rt.store.ledger.inter_device_bytes
    mask = rt.store.put(api.bv(bits[0]), placement=api.pim.PACKED)
    out = rt.get(rt.and_(acc, mask))
    want = np.bitwise_and.reduce(bits, axis=0)
    led = rt.store.ledger
    return {"mismatches": int((api.bits(out) != want).any()),
            "aligned_bytes": aligned_bytes,
            "moved": (led.inter_device_rows, led.inter_device_bytes,
                      led.inter_device_ns),
            "ledger": _astuple(led), "session": _astuple(rt.session_stats),
            "metrics": rt.metrics_snapshot()}


def optimizer_session(api, backend="ambit_sim", n_tenants=6, n_queries=24):
    """``kern_pim_optimizer``: the Zipfian TPC-H predicate mix drained
    unoptimized, optimized (cross-ticket CSE) and optimized again (every
    query from the result cache), every result against the table's
    oracle. ``backend="cuda"`` runs the same mix on the accelerator
    store, through the fused kernels."""
    bw = api.bitweaving

    def build():
        if backend == "ambit_sim":
            geom = api.core.DRAMGeometry(rows_per_subarray=64)
            rt = api.runtime(geometry=geom, banks=4, devices=1,
                             subarrays=4, words=4, seed=1)
        else:
            rt = api.runtime(backend=backend)
        table = bw.TpchTable.synthesize(n_rows=4 * 64, seed=2, **api.kw)
        return rt, table

    def round_(rt, table, queries, optimize):
        ts = [rt.submit(*bw.predicate_plan(table, specs, rt))
              for _, specs in queries]
        rt.drain(optimize=optimize)
        bad = 0
        for (_, specs), t in zip(queries, ts):
            got = api.bits(rt.get(t.result)).ravel()[:table.n_rows]
            bad += int(not np.array_equal(got.astype(bool),
                                          table.oracle(specs)))
        return bad, rt.last_drain

    rt_u, table = build()
    queries = bw.zipf_tenant_queries(table, n_tenants=n_tenants,
                                     n_queries=n_queries, seed=3)
    bad_u, du = round_(rt_u, table, queries, False)
    rt_o, table_o = build()
    bad_o, do = round_(rt_o, table_o, queries, True)
    bad_c, dc = round_(rt_o, table_o, queries, True)
    m = rt_o.store.metrics
    return {"mismatches": bad_u + bad_o + bad_c,
            "aap_unopt": du.stats.aap_count, "aap_opt": do.stats.aap_count,
            "aap_cached": dc.stats.aap_count,
            "ns_unopt": du.stats.ns, "ns_opt": do.stats.ns,
            "opt": _astuple(do.opt), "cached": _astuple(dc.opt),
            "cse_hits": do.opt.cse_hits, "cse_mat": do.opt.cse_materialized,
            "cache_hits": dc.opt.cache_hits,
            "counters_reconcile": (
                m.counter("opt_cse_hits").total() == do.opt.cse_hits
                and m.counter("opt_cache_hits").total()
                == dc.opt.cache_hits),
            "epochs": [len(e.tickets) for e in do.epochs]}


def _counter(rt, name):
    c = rt.metrics.snapshot()["counters"]
    return int(sum(v for k, v in c.items()
                   if k == name or k.startswith(name + "{")))


def tmr_overhead_session(api, words=2):
    """``faults_tmr_overhead`` (benchmarks/faults.py): the same 12 XORs
    plain and over TMR-protected operands under an idle injector."""
    X, Y = api.Expr.var("x"), api.Expr.var("y")
    rng = np.random.default_rng(0)
    raw = [rng.integers(0, 2, 512).astype(bool) for _ in range(4)]
    mism, stats, lines = 0, {}, []
    for tag, protect in (("plain", False), ("tmr", True)):
        inj = api.injector(seed=0)
        rt = api.runtime(fault_injector=inj, banks=4, subarrays=2,
                         words=words)
        up0 = rt.store.bytes_to_device
        hs = [rt.put(api.bv(v), protect=protect) for v in raw]
        upload = rt.store.bytes_to_device - up0
        for k in range(12):
            i, j = k % 4, (k + 1) % 4
            r = rt.eval(X ^ Y, {"x": hs[i], "y": hs[j]})
            mism += int(not np.array_equal(api.bits(rt.get(r)),
                                           raw[i] ^ raw[j]))
            rt.free(r)
        st = rt.session_stats
        stats[tag] = (upload, st.aap_count, st.ns)
        lines.append(f"{tag} upload={upload} {st!r} "
                     f"faults=[{inj.ledger()}]")
    (up_p, aap_p, _), (up_t, aap_t, _) = stats["plain"], stats["tmr"]
    return {"storage_x": up_t // up_p, "aap_plain": aap_p,
            "aap_tmr": aap_t, "mismatches": mism, "ledger": "; ".join(lines)}


def faulty_serve_session(api, rate, n_queries=1024, n_tenants=512,
                         n_users=2048, n_items=12, max_batch=16,
                         window_ns=5_000.0, words=2):
    """``faults_serve_r001``/``r010`` (benchmarks/faults.py): the
    closed-loop Zipfian bitmap mix under a fixed stuck-row rate, every
    count against numpy."""
    rng = np.random.default_rng(0)
    inj = api.injector(seed=23, stuck_row_rate=rate)
    rt = api.runtime(fault_injector=inj, banks=4, subarrays=2, words=words)
    rt.reliability.max_retries = 8
    raw = {f"m{i}": rng.integers(0, 2, n_users).astype(bool)
           for i in range(n_items)}
    hs = {k: rt.put(api.bv(v), name=k) for k, v in raw.items()}
    expr = api.Expr.var("x") & api.Expr.var("y")
    tenants = [f"t{i}" for i in range(n_tenants)]
    pair_of = dict(zip(tenants, _zipf_pairs(rng, n_items, n_tenants)))
    expected, state = {}, {"mism": 0, "max_ns": 0.0}

    def next_query(tenant, k):
        i, j = pair_of[tenant]
        a, b = f"m{i}", f"m{j}"
        expected[tenant] = int((raw[a] & raw[b]).sum())
        return expr, {"x": hs[a], "y": hs[b]}

    def check(q):
        if not q.ok or rt.popcount(q.result) != expected[q.tenant]:
            state["mism"] += 1
        state["max_ns"] = max(state["max_ns"], q.latency_ns)
        rt.free(q.result)

    fe = api.serve.QueryFrontend(rt, window_ns=window_ns,
                                 max_batch=max_batch)
    done = api.serve.run_closed_loop(fe, tenants, next_query, n_queries,
                                     on_complete=check)
    rep = fe.report()
    return {"queries": done, "errors": rep.errors,
            "mismatches": state["mism"],
            "faults": _counter(rt, "fault_injected"),
            "retries": _counter(rt, "ticket_retries"),
            "quarantined": _counter(rt, "quarantined_rows"),
            "p50_ns": rep.p50_ns, "p99_ns": rep.p99_ns,
            "max_ns": state["max_ns"], "qps": rep.qps,
            "session": _astuple(rt.session_stats),
            "ledger": inj.ledger()}


def fallback_session(api):
    """A device loss under the serving frontend (the shape of
    tests/test_faults.py's host-fallback case): both queries are served
    again by the frontend's fallback engine from the operands' host
    copies, equal to numpy."""
    X, Y = api.Expr.var("x"), api.Expr.var("y")
    rng = np.random.default_rng(10)
    raw = [rng.integers(0, 2, 512).astype(bool) for _ in range(4)]
    inj = api.injector(seed=5)
    rt = api.runtime(fault_injector=inj, banks=4, subarrays=2, words=2)
    hs = [rt.put(api.bv(v)) for v in raw]
    fe = api.serve.QueryFrontend(rt, window_ns=1e9, max_batch=2)
    inj.fail_device(0)
    fe.submit("a", X ^ Y, {"x": hs[0], "y": hs[1]})
    fe.submit("b", X & Y, {"x": hs[2], "y": hs[3]})
    done = fe.take_completed()
    want = [raw[0] ^ raw[1], raw[2] & raw[3]]
    mism = sum(int(not (q.ok and q.fallback and np.array_equal(
        api.bits(q.result), w))) for q, w in zip(done, want))
    eng = fe._host_engine
    return {"fallbacks": fe.report().fallbacks, "mismatches": mism,
            "engine": (eng.backend,
                       str(getattr(getattr(eng, "device", None), "type",
                                   ""))),
            "ledger": inj.ledger()}


def _port_api(device):
    import repro_torch.core as core
    import repro_torch.pim as pim
    import repro_torch.pim.faults as faults
    import repro_torch.serve as serve
    return PimApi(core, pim, faults, serve, device=device)


def _launch_counts(wrappers):
    return {name: fn.launches for name, fn in wrappers.items()}


def _zero(wrappers):
    for fn in wrappers.values():
        fn.launches = 0


def pim_serving_full_width(torch, card, api, seconds=20.0, min_queries=16,
                           n_users=1 << 24, n_items=12, n_tenants=64):
    """The bitmap mix of phase 3 on the DRAM model at the default geometry
    (8 banks x 32 subarrays of 8 KB rows): 12 bitmaps of 2^24 users
    resident, Zipfian tenants issuing closed-loop ``x & y`` queries, as
    many as fit in about ``seconds`` (at least ``min_queries``), every
    count against numpy. One query's CUDA kernels and copies are listed
    by torch.profiler; the simulated-clock percentiles are the DRAM
    model's."""
    rng = np.random.default_rng(SEED + 7)
    t0 = time.perf_counter()
    rt = api.runtime()
    raw = {f"m{i}": rng.integers(0, 2, n_users).astype(bool)
           for i in range(n_items)}
    hs = {k: rt.put(api.bv(v), name=k) for k, v in raw.items()}
    _sync(torch, "cuda")
    load_s = time.perf_counter() - t0
    expr = api.Expr.var("x") & api.Expr.var("y")
    tenants = [f"t{i}" for i in range(n_tenants)]
    pair_of = dict(zip(tenants, _zipf_pairs(rng, n_items, n_tenants)))
    counts = {}

    def expected(pair):
        if pair not in counts:
            counts[pair] = int((raw[f"m{pair[0]}"]
                                & raw[f"m{pair[1]}"]).sum())
        return counts[pair]

    env0 = {"x": hs["m0"], "y": hs["m1"]}

    def one_query():
        r = rt.eval(expr, env0)
        n = rt.popcount(r)
        rt.free(r)
        return n

    got, warm_ms = _wall_ms(torch, one_query, "cuda", reps=3)
    if got != expected((0, 1)):
        fail(f"pim full width: m0 & m1 counted {got} != "
             f"{expected((0, 1))}")
    events = _cuda_events(torch, one_query)
    n_queries = max(min_queries, min(4096, int(seconds * 1e3 / warm_ms)))

    state = {"mism": 0, "checked": 0}

    def next_query(tenant, k):
        i, j = pair_of[tenant]
        return expr, {"x": hs[f"m{i}"], "y": hs[f"m{j}"]}

    def check(q):
        if not q.ok or rt.popcount(q.result) != expected(pair_of[q.tenant]):
            state["mism"] += 1
        state["checked"] += 1
        rt.free(q.result)

    fe = api.serve.QueryFrontend(rt, window_ns=50_000.0, max_batch=16)
    _sync(torch, "cuda")
    t0 = time.perf_counter()
    done = api.serve.run_closed_loop(fe, tenants, next_query, n_queries,
                                     on_complete=check)
    _sync(torch, "cuda")
    wall = time.perf_counter() - t0
    rep = fe.report()
    if state["mism"] or done != n_queries or state["checked"] != done:
        fail(f"pim full width: mismatches={state['mism']} done={done}")
    out = {"users": n_users, "bitmaps": n_items, "queries": done,
           "wall_ms_per_query": wall * 1e3 / done,
           "lone_query_ms": warm_ms, "load_s": load_s,
           "model_p50_ns": rep.p50_ns, "model_p99_ns": rep.p99_ns,
           "drains": rep.drains, "epochs": rep.epochs,
           "cuda_events_per_query": events}
    log(f"pim_full_width users={n_users} bitmaps={n_items} "
        f"tenants={n_tenants} queries={done} mismatches=0 "
        f"wall_ms_per_query={wall * 1e3 / done:.3f} (popcount read-back "
        f"and check included; a lone query {warm_ms:.3f} ms, median of 3) "
        f"model_p50_ns={rep.p50_ns} model_p99_ns={rep.p99_ns} (DRAM model "
        f"clock, not the card) drains={rep.drains} epochs={rep.epochs} "
        f"load_s={load_s:.2f} cuda events a query (torch.profiler): "
        f"{json.dumps(events)} on {card}")
    return out


def pim_runtime_phase(torch, card, wrappers):
    """The PIM runtime on the DRAM model with its row state on the card:
    (a) the resident chain, (b) the sharded scan, (c) the optimizer mix
    (and the same mix on backend "cuda", through the fused kernels), (d)
    the reliability sessions and a host fallback after a device loss,
    (e) the bitmap mix at full width. Every answer is checked against
    numpy and every ledger against the reference's constants."""
    api = _port_api("cuda")
    report = {}

    def timed(name, fn):
        _sync(torch, "cuda")
        t0 = time.perf_counter()
        out = fn()
        _sync(torch, "cuda")
        report[name + "_wall_s"] = time.perf_counter() - t0
        return out

    chain = timed("chain", lambda: resident_chain_session(api))
    if chain["mismatches"] or chain["host_reads"] != 1 or \
            chain["session"] != PIM_CHAIN_LEDGER:
        fail(f"pim resident chain: {chain['mismatches']} mismatches, "
             f"host_reads={chain['host_reads']}, session "
             f"{chain['session']} != {PIM_CHAIN_LEDGER}")
    log(f"pim resident_chain ops=6 rows=128 bits_per_row=65536 "
        f"host_reads=1 session={chain['session']} (= the reference's) "
        f"mismatches=0 wall_s={report['chain_wall_s']:.3f} on {card}")

    shard = timed("sharded", lambda: sharded_scan_session(api))
    if shard["mismatches"] or shard["aligned_bytes"] != 0 or \
            shard["moved"] != PIM_SHARDED_LEDGER:
        fail(f"pim sharded scan: {shard['mismatches']} mismatches, "
             f"aligned bytes {shard['aligned_bytes']}, moved "
             f"{shard['moved']} != {PIM_SHARDED_LEDGER}")
    log(f"pim sharded_scan devices=4 rows=64 inter_dev_rows,bytes,"
        f"channel_ns={shard['moved']} (measured; = the reference's) "
        f"mismatches=0 wall_s={report['sharded_wall_s']:.3f} on {card}")

    opt = timed("optimizer", lambda: optimizer_session(api))
    got = (opt["cse_hits"], opt["cse_mat"], opt["cache_hits"],
           opt["aap_unopt"], opt["aap_opt"], opt["aap_cached"])
    if opt["mismatches"] or got != PIM_OPT_LEDGER or \
            not opt["counters_reconcile"]:
        fail(f"pim optimizer: {opt['mismatches']} mismatches, "
             f"(cse_hits, cse_mat, cache_hits, aaps) {got} != "
             f"{PIM_OPT_LEDGER}")
    _zero(wrappers)
    acc = timed("optimizer_cuda",
                lambda: optimizer_session(api, backend="cuda"))
    opt_launches = _launch_counts(wrappers)
    if acc["mismatches"] or (acc["cse_hits"], acc["cse_mat"],
                             acc["cache_hits"]) != PIM_OPT_LEDGER[:3]:
        fail(f"pim optimizer on 'cuda': {acc['mismatches']} mismatches, "
             f"rewrites {acc['cse_hits'], acc['cse_mat'], acc['cache_hits']}")
    idle = [k for k in ("fused_bitwise", "fused_bitwise_stacked")
            if opt_launches[k] <= 0]
    if idle:
        fail(f"optimized drains on 'cuda' never launched {idle}: "
             f"{opt_launches}")
    report["optimizer_cuda_launches"] = opt_launches
    log(f"pim optimizer queries=24 cse_hits={opt['cse_hits']} "
        f"cse_mat={opt['cse_mat']} cache_hits={opt['cache_hits']} "
        f"aaps={opt['aap_unopt']}->{opt['aap_opt']}->{opt['aap_cached']} "
        f"(= the reference's) mismatches=0; the same mix on 'cuda' "
        f"mismatches=0, epoch sizes {acc['epochs']}, launches "
        f"{opt_launches} on {card}")

    tmr = timed("tmr", lambda: tmr_overhead_session(api))
    if tmr["mismatches"] or tmr["ledger"] != FAULTS_TMR_LEDGER:
        fail(f"faults_tmr_overhead: {tmr['mismatches']} mismatches, "
             f"ledger {tmr['ledger']!r} != the reference's")
    log(f"pim faults_tmr_overhead storage_x={tmr['storage_x']} "
        f"aap_plain={tmr['aap_plain']} aap_tmr={tmr['aap_tmr']} "
        f"mismatches=0 ledger = the reference's "
        f"wall_s={report['tmr_wall_s']:.3f} on {card}")
    for rate in (0.001, 0.01):
        tag = f"r{int(round(rate * 1000)):03d}"
        srv = timed(f"serve_{tag}", lambda: faulty_serve_session(api, rate))
        if srv["mismatches"] or srv["errors"] or \
                srv["ledger"] != FAULTS_SERVE_LEDGER[rate]:
            fail(f"faults_serve_{tag}: {srv['mismatches']} mismatches, "
                 f"{srv['errors']} errors, ledger {srv['ledger']!r} != "
                 f"{FAULTS_SERVE_LEDGER[rate]!r}")
        log(f"pim faults_serve_{tag} queries={srv['queries']} errors=0 "
            f"mismatches=0 faults={srv['faults']} retries={srv['retries']} "
            f"quarantined={srv['quarantined']} p50_ns={srv['p50_ns']} "
            f"p99_ns={srv['p99_ns']} (DRAM model clock) ledger "
            f"{srv['ledger']!r} (= the reference's) "
            f"wall_s={report[f'serve_{tag}_wall_s']:.3f} on {card}")
    _zero(wrappers)
    fb = timed("fallback", lambda: fallback_session(api))
    fb_launches = _launch_counts(wrappers)
    if fb["mismatches"] or fb["fallbacks"] != 2 or \
            fb["engine"] != ("cuda", "cuda") or \
            fb_launches["fused_bitwise"] <= 0:
        fail(f"host fallback: {fb} launches {fb_launches}")
    report["fallback_launches"] = fb_launches
    log(f"pim host_fallback after device loss: fallbacks=2 mismatches=0 "
        f"engine={fb['engine']} launches {fb_launches}")

    report["full_width"] = timed(
        "full_width", lambda: pim_serving_full_width(torch, card, api))
    return report


# -- phase 8 ------------------------------------------------------------------

LM_ARCH = "qwen2.5-3b"
LM_BOUND = 5e-2     # card against the CPU port (tests/test_torch_models.py)
LM_SELF_BOUND = 1e-1    # decode against forward (tests/test_models.py)


def lm_filter(torch, card, scan, n=1 << 24):
    """(a) The data pipeline's document filter over 2^24 documents on the
    card: two launches of the scan kernel, the mask equal to numpy's and
    to the plain scan's; then ``FilteredSyntheticLM``'s ``doc_ids``."""
    from repro_torch.data import pipeline
    meta = pipeline.synth_corpus_meta(n, seed=0)
    q, ln = meta.quality, meta.length
    want = (q >= 64) & (q <= 250) & (ln >= 256)
    torch.cuda.synchronize()
    before = scan.launches
    t0 = time.perf_counter()
    got = pipeline.filter_documents(meta, 64, 250, 256, device="cuda")
    first_ms = (time.perf_counter() - t0) * 1e3
    if scan.launches - before != 2:
        fail(f"filter_documents launched bitweaving_scan "
             f"{scan.launches - before} times, not 2")
    plain = pipeline.filter_documents(meta, 64, 250, 256, use_kernel=False,
                                      device="cuda")
    for name, mask in (("kernel", got), ("plain", plain)):
        if mask.shape != (n,) or not np.array_equal(mask, want):
            fail(f"filter_documents ({name}) disagrees with numpy on "
                 f"{int(np.sum(mask != want))} of {n} documents")
    _, warm_ms = _wall_ms(torch, lambda: pipeline.filter_documents(
        meta, 64, 250, 256, device="cuda"), "cuda")
    _, plain_ms = _wall_ms(torch, lambda: pipeline.filter_documents(
        meta, 64, 250, 256, use_kernel=False, device="cuda"), "cuda")
    stream = pipeline.FilteredSyntheticLM(
        pipeline.DataConfig(vocab=151936, seq_len=8, global_batch=4),
        n_docs=n, device="cuda")
    ids = np.nonzero(want)[0]
    if not np.array_equal(stream.doc_ids, ids):
        fail("FilteredSyntheticLM doc_ids disagree with numpy")
    batch = stream.batch_at(0)
    if not np.isin(batch["doc_ids"], ids).all():
        fail("FilteredSyntheticLM drew a document the filter rejects")
    out = {"docs": n, "selected": int(ids.size), "first_ms": first_ms,
           "wall_ms": warm_ms, "plain_wall_ms": plain_ms}
    log(f"filter_documents {n} docs (quality 8 planes, length 12 planes "
        f"of {-(-n // 32)} words): selected {ids.size}, mask == numpy == plain "
        f"scan, 2 launches; wall ms first {first_ms:.3f}, warm "
        f"{warm_ms:.3f} (plain scan {plain_ms:.3f}), host-to-host, on "
        f"{card} (measured on the card)")
    return out


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _max_rel(got, want) -> float:
    """max |got - want| / max |want|, 0 where both are 0."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max() / want.abs().max()
                 .clamp_min(1e-30))


def lm_batch(cfg, batch, seq, prompt=None, labels=False, seed=SEED):
    """One LM batch as numpy arrays drawn from ``seed``: ``tokens``
    (batch, seq) (with ``labels``, one more token drawn and ``labels`` the
    next token of each), then the family's own inputs. Whisper:
    ``frames`` (batch, n_frames, d_model). The VLM: ``vision_embeds``
    (batch, vision_tokens, d_model) written at ``vision_positions``
    0..vision_tokens-1, and ``mrope_positions`` (3, batch, seq) of the
    image's grid (t = 0, h = its row, w = its column) with the text from
    the grid's largest position + 1 on all three streams. With
    ``prompt`` the tokens from ``prompt`` on are those the decode steps
    feed: their positions are their index on all three streams, as
    ``decode_step`` derives them from ``pos``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (batch, seq + labels)).astype(np.int32)
    out = {"tokens": np.ascontiguousarray(toks[:, :seq])}
    if labels:
        out["labels"] = np.ascontiguousarray(toks[:, 1:])
    if cfg.enc_dec:
        out["frames"] = rng.standard_normal(
            (batch, cfg.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        n = cfg.vision_tokens
        if seq <= n:
            raise ValueError(f"{seq} tokens leave no text after {n} image "
                             "tokens")
        rows = int(np.sqrt(n))     # the most nearly square grid
        while n % rows:
            rows -= 1
        cols = n // rows
        idx = np.arange(n)
        pos = np.empty((3, seq), np.int32)
        pos[:, :n] = (np.zeros(n), idx // cols, idx % cols)
        pos[:, n:] = max(rows, cols) + np.arange(seq - n)
        if prompt is not None:
            pos[:, prompt:] = np.arange(prompt, seq)
        out.update(
            vision_embeds=rng.standard_normal(
                (batch, n, cfg.d_model)).astype(np.float32),
            vision_positions=np.tile(idx.astype(np.int32), (batch, 1)),
            mrope_positions=np.broadcast_to(pos[:, None],
                                            (3, batch, seq)).copy())
    return out


def prompt_part(batch, prompt):
    """``batch`` as the prefill takes it: the tokens and the M-RoPE
    positions cut to the first ``prompt``, the rest whole."""
    return {k: v[..., :prompt] if k in ("tokens", "mrope_positions") else v
            for k, v in batch.items()}


def lm_parity(torch, card, n_layers=2, prompt=8, steps=3):
    """(b) qwen2.5-3b at its full widths, depth cut to ``n_layers``: the
    card's prefill and teacher-forced decode logits against the CPU
    port's on the same weights (from one CPU generator) and tokens, and
    the card's decode against its own forward."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=n_layers)
    model = build_model(cfg)
    t0 = time.perf_counter()
    cpu = model.init(SEED, device="cpu")
    card_params = _tree_to(cpu, "cuda")
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, prompt + steps))
                            .astype(np.int32))

    def run(params, dev):
        t = toks.to(dev)
        fwd = model.forward(params, {"tokens": t})[0]
        logits, caches = model.prefill(params, {"tokens": t[:, :prompt]},
                                       skv=prompt + steps)
        outs = [logits]
        for i in range(steps):
            pos = torch.full((2,), prompt + i, dtype=torch.int32, device=dev)
            logits, caches = model.decode_step(
                params, caches, {"tokens": t[:, prompt + i:prompt + i + 1],
                                 "pos": pos})
            outs.append(logits)
        return fwd, outs

    t0 = time.perf_counter()
    cpu_fwd, cpu_outs = run(cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fwd, outs = run(card_params, "cuda")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    vs_cpu = [_max_rel(o, w) for o, w in zip(outs, cpu_outs)]
    # prefill's logits are forward's at position prompt-1, decode step i's
    # at prompt+i
    vs_fwd = [_max_rel(o, fwd[:, prompt - 1 + i])
              for i, o in enumerate(outs)]
    cpu_vs_fwd = [_max_rel(o, cpu_fwd[:, prompt - 1 + i])
                  for i, o in enumerate(cpu_outs)]
    # reported, not gated: over all 2 x 11 positions the forward meets
    # the reference init's hard attention (scores of std ~360 at full
    # width), where one key that wins by less than a bf16 ulp flips
    fwd_vs_cpu = _max_rel(fwd, cpu_fwd)
    if not all(bool(torch.isfinite(o).all()) for o in outs + [fwd]):
        fail("lm parity: non-finite logits on the card")
    if max(vs_cpu) > LM_BOUND:
        fail(f"lm parity: card vs CPU max-rel {vs_cpu} > {LM_BOUND}")
    if max(vs_fwd) >= LM_SELF_BOUND:
        fail(f"lm parity: decode vs forward max-rel {vs_fwd} >= "
             f"{LM_SELF_BOUND}")
    out = {"n_layers": n_layers, "params": model.n_params(),
           "card_vs_cpu": vs_cpu, "decode_vs_forward": vs_fwd,
           "cpu_decode_vs_forward": cpu_vs_fwd,
           "forward_card_vs_cpu": fwd_vs_cpu,
           "init_s": init_s, "cpu_s": cpu_s, "card_s": card_s,
           "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
           "bf16_reduced_reduction":
               torch.backends.cuda.matmul
               .allow_bf16_reduced_precision_reduction}
    log(f"lm parity {LM_ARCH} full width, {n_layers} layers "
        f"({model.n_params()} params): card vs CPU max-rel (prefill, "
        f"{steps} decodes) {vs_cpu} <= {LM_BOUND}; card (prefill, decodes) "
        f"vs its forward {vs_fwd} < {LM_SELF_BOUND} (CPU: {cpu_vs_fwd}); "
        f"forward card vs CPU {fwd_vs_cpu} (reported); CPU run "
        f"{cpu_s:.1f} s, card run {card_s:.3f} s on {card}")
    return out


class _TimedModel:
    """The model as ``ServeEngine`` calls it, each call timed on the host
    clock up to a synchronise and its logits checked finite."""

    def __init__(self, torch, model):
        self.torch, self.model = torch, model
        self.ms = {"prefill": [], "decode": []}

    def _timed(self, kind, fn, *args, **kw):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = fn(*args, **kw)
        finite = bool(self.torch.isfinite(logits).all())   # synchronises
        self.ms[kind].append((time.perf_counter() - t0) * 1e3)
        if not finite:
            fail(f"lm serve: non-finite {kind} logits")
        return logits, caches

    def prefill(self, params, batch, skv=None):
        return self._timed("prefill", self.model.prefill, params, batch,
                           skv=skv)

    def decode_step(self, params, caches, batch):
        return self._timed("decode", self.model.decode_step, params, caches,
                           batch)


def lm_decode_profile(torch, model, params, vocab, slots=4, plen=8,
                      skv=256, extra=None):
    """One full-depth decode step after three warm-up steps: the host's
    ms to enqueue it, its wall ms to a synchronise, and (torch.profiler)
    the CUDA kernels and copies it runs, their summed device ms and the
    card's idle share of the wall. ``extra`` joins the prefill's batch
    (whisper's frames)."""
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, vocab, (slots, plen))
                            .astype(np.int32)).to("cuda")
    logits, caches = model.prefill(params, dict(extra or {}, tokens=toks),
                                   skv=skv)
    state = {"caches": caches, "tok": logits.argmax(-1).to(torch.int32),
             "pos": torch.full((slots,), plen, dtype=torch.int32,
                               device="cuda")}

    def step():
        logits, state["caches"] = model.decode_step(
            params, state["caches"],
            {"tokens": state["tok"][:, None], "pos": state["pos"]})
        state["tok"] = logits.argmax(-1).to(torch.int32)
        state["pos"] = state["pos"] + 1

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    out = {"enqueue_ms": (t1 - t0) * 1e3, "wall_ms": wall,
           **_cuda_events(torch, step)}
    out["idle_share"] = 1 - out.get("device_ms", 0.0) / wall
    return out


def lm_serve(torch, card, arch=LM_ARCH, n_requests=8, max_new=16,
             max_seq=256, slots=4, prompt_len=(2, 12)):
    """(c) ``arch`` as configured (qwen2.5-3b: 36 layers, float32
    parameters) behind ``ServeEngine``: 8 requests with prompts of
    ``prompt_len`` tokens (a half-open range; by default
    ``launch/serve.py``'s 2-11), greedy and then at temperature 0.7,
    under the termination contract; then one profiled decode step after
    a prompt of the range's least length (at least 8)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServeEngine
    cfg = get_config(arch)
    model = build_model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(SEED, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, rng.integers(*prompt_len))
               .astype(np.int32) for _ in range(n_requests)]
    out = {"params": model.n_params(), "prompt_len": prompt_len,
           "active_params": model.n_active_params(), "init_s": init_s}
    for temperature in (0.0, 0.7):
        timed = _TimedModel(torch, model)
        eng = ServeEngine(timed, params, max_seq=max_seq, batch_slots=slots,
                          temperature=temperature, seed=SEED)
        reqs = [Request(prompt=p, max_new_tokens=max_new) for p in prompts]
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tokens = sum(len(r.out) for r in reqs)
        batches = -(-n_requests // slots)
        want_steps = batches * (max_new - 1)
        sampled = eng.metrics.counter("serve_tokens_sampled").total()
        if eng.decode_steps != want_steps or sampled != tokens or \
                tokens != n_requests * max_new:
            fail(f"lm serve T={temperature}: decode_steps "
                 f"{eng.decode_steps} (want {want_steps}), sampled "
                 f"{sampled}, tokens {tokens}")
        if not all(r.done and all(0 <= t < cfg.vocab for t in r.out)
                   for r in reqs):
            fail(f"lm serve T={temperature}: a request not done or a "
                 "token outside the vocabulary")
        row = {"wall_s": wall, "tokens": tokens,
               "decode_steps": eng.decode_steps,
               "tokens_per_s": tokens / wall,
               "prefill_ms": timed.ms["prefill"],
               "decode_ms_median": statistics.median(timed.ms["decode"]),
               "decode_ms_min": min(timed.ms["decode"]),
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "first_out": reqs[0].out}
        out[f"T={temperature}"] = row
        log(f"lm serve {arch} {cfg.n_layers} layers "
            f"({model.n_params()} float32 params), {n_requests} requests "
            f"of {min(map(len, prompts))}-{max(map(len, prompts))} prompt "
            f"tokens, {slots} slots, max_seq {max_seq}, T={temperature}: "
            f"{tokens} tokens in {wall:.3f} s = {tokens / wall:.1f} tokens/s; "
            f"prefill ms a batch {[round(m, 3) for m in row['prefill_ms']]}"
            f", decode ms a step median {row['decode_ms_median']:.3f} (min "
            f"{row['decode_ms_min']:.3f}, {eng.decode_steps} steps); max "
            f"memory allocated {row['max_memory_allocated']} B on {card} "
            f"(measured on the card)")
    plen = max(8, prompt_len[0])
    prof = lm_decode_profile(torch, model, params, cfg.vocab, plen=plen,
                             skv=max_seq)
    out["decode_profile"] = prof
    log(f"lm decode step profile {arch} ({slots} slots, {cfg.n_layers} "
        f"layers, after {plen} prompt tokens): host enqueue "
        f"{prof['enqueue_ms']:.3f} ms, wall {prof['wall_ms']:.3f} ms, "
        f"{prof.get('kernels', 0)} CUDA kernels and {prof.get('copies', 0)} "
        f"copies summing {prof.get('device_ms', 0.0):.3f} device ms, idle "
        f"share {prof['idle_share']:.3f} on {card} (measured on the card, "
        f"torch.profiler)")
    return out


def lm_phase(torch, card, wrappers):
    """Phase 8: (a) the document filter, (b) parity at full width, (c)
    serving at full width and depth."""
    report = {"filter": lm_filter(torch, card, wrappers["bitweaving_scan"])}
    torch.cuda.empty_cache()
    report["parity"] = lm_parity(torch, card)
    torch.cuda.empty_cache()
    report["serve"] = lm_serve(torch, card)
    torch.cuda.empty_cache()
    return report


# -- phase 9 ------------------------------------------------------------------

# arch: (depth for the card-vs-CPU parity run, prompt tokens). gemma3:
# five local layers and one global, over a prompt past its 1024-token
# window; qwen2-vl: 256 image embeddings on a 16 x 16 grid, then 8 text
# tokens (``lm_batch``)
FAMILY_PARITY = {"granite-moe-3b-a800m": (2, 8), "mamba2-780m": (2, 300),
                 "zamba2-2.7b": (6, 8), "whisper-small": (2, 8),
                 "gemma3-1b": (6, 1100), "qwen2-vl-7b": (2, 264),
                 "internlm2-20b": (2, 8), "deepseek-67b": (2, 8)}
# arch: ``lm_serve``'s arguments beyond the defaults. gemma3: prompts past
# its window, so that every decode step's local layers read only the
# last 1024 keys; qwen2-vl: text prompts (the engine takes only tokens)
FAMILY_SERVE = {"granite-moe-3b-a800m": {}, "mamba2-780m": {},
                "zamba2-2.7b": {},
                "gemma3-1b": dict(max_seq=1280, prompt_len=(1030, 1101)),
                "qwen2-vl-7b": {}}
MOE_WIDE = "qwen3-moe-235b-a22b"


class _Routing:
    """Wraps ``models.moe._moe_local`` while active: each call also
    records the routed expert ids (T, k) and which tokens lost an
    assignment to an expert's capacity, on the host."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.calls = moe, []

    def __enter__(self):
        import torch
        moe, local = self.moe, self.moe._moe_local

        def wrapped(x2d, router, *weights, **kw):
            idx = moe.route(x2d, router, kw["moe"], kw["e_pad"])[2]
            onehot = torch.nn.functional.one_hot(idx.reshape(-1),
                                                 kw["e_pad"])
            rank = (onehot.cumsum(0) * onehot).sum(1) - 1
            dropped = (rank >= kw["capacity"]).reshape(idx.shape).any(1)
            self.calls.append((idx.cpu(), dropped.cpu()))
            return local(x2d, router, *weights, **kw)

        self._local = local
        moe._moe_local = wrapped
        return self

    def __exit__(self, *exc):
        self.moe._moe_local = self._local
        return False


def _no_drop(cfg):
    """``cfg`` with each expert's capacity at least the batch's tokens
    (capacity_factor = n_experts / top_k): nothing is dropped, so the
    forward and the decode route every assignment alike."""
    import dataclasses
    moe = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.n_experts / moe.top_k))


def _same_sets(a, b):
    """(T,) bool: tokens whose top-k expert sets agree."""
    return (a.sort(-1).values == b.sort(-1).values).all(-1)


def _lm_run(torch, model, params, inputs, prompt, steps, dev,
            attention=None):
    """The forward over all of ``inputs`` (host tensors: the tokens and
    the family's own, ``lm_batch``), the prefill over the first
    ``prompt`` (``prompt_part``), then ``steps`` teacher-forced decode
    steps: (forward logits, [prefill logits, decode logits...], routing
    calls), inside ``attention`` (a ``_Cores``) when given, each stage
    marked on it."""
    import contextlib
    ex = {k: v.to(dev) for k, v in inputs.items()}
    t = ex["tokens"]
    b = t.shape[0]
    stage = attention.stage if attention else (lambda *a: None)
    with _Routing() as routing, attention or contextlib.nullcontext():
        stage("forward")
        fwd = model.forward(params, ex)[0]
        stage("prefill")
        logits, caches = model.prefill(params, prompt_part(ex, prompt),
                                       skv=prompt + steps)
        outs = [logits]
        for i in range(steps):
            stage("decode", prompt + i)
            pos = torch.full((b,), prompt + i, dtype=torch.int32,
                             device=dev)
            logits, caches = model.decode_step(
                params, caches,
                {"tokens": t[:, prompt + i:prompt + i + 1], "pos": pos})
            outs.append(logits)
    if not all(bool(torch.isfinite(o).all()) for o in outs + [fwd]):
        fail(f"{model.cfg.name}: non-finite logits on {dev}")
    return fwd, outs, routing.calls


def _vs_forward(outs, fwd, prompt):
    """Each output's max-rel against the forward's logits at its
    position (prefill: prompt-1, decode step i: prompt+i)."""
    return [_max_rel(o, fwd[:, prompt - 1 + j]) for j, o in enumerate(outs)]


def _drops(calls):
    return int(sum(int(d.sum()) for _, d in calls))


def _to(x, device):
    """Tensors (detached), and tuples of them, on ``device``."""
    if isinstance(x, tuple):
        return tuple(_to(v, device) for v in x)
    return x.detach().to(device) if hasattr(x, "to") else x


def _through(x, value):
    """``value``, with ``x``'s gradient where ``x`` has one: the backward
    passes straight through to ``x`` (``x - x`` adds an exact 0)."""
    if not getattr(x, "requires_grad", False):
        return value
    return value + (x - x.detach())


class _Cores:
    """Wraps ``models.attention``'s ``flash_attention`` and
    ``decode_attention`` while active; a subclass's ``_call`` says what
    a call returns. ``rels``: each core's output against the one it is
    held to; ``arg_rels``: each tensor argument the run computed (q, k,
    v, the caches) against the one it is held to (an integer argument
    must be equal: 0.0, else inf). ``_lm_run`` marks its stages."""

    NAMES = ("flash_attention", "decode_attention")

    def __init__(self):
        from repro_torch.models import attention
        self.attn, self.rels, self.arg_rels = attention, [], []
        self.at, self.k = ("forward", None), 0

    def stage(self, name, row=None):
        self.at, self.k = (name, row), 0

    def _hold(self, pairs):
        import torch
        for got, want in pairs:
            if got.is_floating_point():
                self.arg_rels.append(_max_rel(got, want))
            else:
                same = torch.equal(got.cpu(), want.cpu())
                self.arg_rels.append(0.0 if same else float("inf"))

    def _wrap(self, name, fn):
        def wrapped(*args, **kw):
            return self._call(name, fn, args, kw)
        return wrapped

    def __enter__(self):
        self._orig = {n: getattr(self.attn, n) for n in self.NAMES}
        for name, fn in self._orig.items():
            setattr(self.attn, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self.attn, name, fn)
        return False


class _Attention(_Cores):
    """Recording (``feed`` None): keeps each call's inputs and output on
    the host. Forcing (``feed``, a recorded run's calls): holds each
    call's own inputs against the recorded call's, computes its output
    from the recorded inputs and holds it against the recorded output,
    and returns the recorded output, so that everything after each
    attention core reads the same values on both devices, and each
    core's inputs (projections, rope, ``_cross_qkv``, ``update_cache``,
    the decode caches) are compared on comparable values.

    In a train step both substitutions pass the gradient straight
    through (to the call's own inputs, from its output), so each core's
    backward runs at the recorded inputs; a checkpointed layer's
    recompute in the backward runs to its end (no early stop, which
    would leave a core call without its output), so the calls of two
    steps pair one to one."""

    def __init__(self, feed=None):
        super().__init__()
        self.feed, self.calls = feed, []

    def __enter__(self):
        from torch.utils.checkpoint import set_checkpoint_early_stop
        self._whole = set_checkpoint_early_stop(False)
        self._whole.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        return self._whole.__exit__(*exc)

    def _call(self, name, fn, args, kw):
        if self.feed is None:
            out = fn(*args, **kw)
            self.calls.append((name, _to(args, "cpu"), kw, _to(out, "cpu")))
            return out
        rec_name, rec_args, rec_kw, rec_out = self.feed[len(self.rels)]
        if (rec_name, rec_kw) != (name, kw):
            fail(f"attention call {len(self.rels)}: {name} {kw}, recorded "
                 f"{rec_name} {rec_kw}")
        dev = args[0].device
        self._hold(zip(args, rec_args))
        own = fn(*(_through(a, r) for a, r in zip(args, _to(rec_args, dev))),
                 **rec_kw)
        self.rels.append(_max_rel(own, rec_out))
        return _through(own, rec_out.to(dev))


class _FromForward(_Cores):
    """The decode against the forward with the cores made alike: the
    forward's cores run and are kept; each prefill core (the k-th of the
    prefill, over its first rows) and each decode core (the k-th of a
    step, at the step's row of the forward's k-th decoder core, those
    whose output spans all ``seq`` tokens) holds its inputs against the
    forward's at those rows (a cache over its valid rows), keeps its own
    output's max-rel against the forward's rows in ``rels`` (where a hard
    maximum flips) and returns the forward's rows."""

    def __init__(self, seq):
        super().__init__()
        self.seq, self.fwd = seq, []

    def _call(self, name, fn, args, kw):
        own = fn(*args, **kw)
        stage, row = self.at
        if stage == "forward":
            self.fwd.append((args, own))
            return own
        if stage == "prefill":
            f_args, f_out = self.fwd[self.k]
            self._hold((a, f[:, :a.shape[1]]) for a, f in zip(args, f_args))
            want = f_out[:, :args[0].shape[1]]
        else:
            f_args, f_out = [c for c in self.fwd
                             if c[1].shape[1] == self.seq][self.k]
            q, kc, vc, pos = args[:4]
            valid = int(pos.max()) + 1
            if int(pos.min()) + 1 != valid:
                fail(f"decode core at row {row}: positions differ {pos}")
            self._hold([(q, f_args[0][:, row:row + 1]),
                        (kc[:, :valid], f_args[1][:, :valid]),
                        (vc[:, :valid], f_args[2][:, :valid])])
            want = f_out[:, row:row + 1]
        self.k += 1
        self.rels.append(_max_rel(own, want))
        return want


# zamba2's shared attention and whisper's self- and cross-attention (over
# 1500 frames) are near hard maxima at the reference's init: an ulp of a
# cuBLAS sum flips a key and moves whole rows (on an H100, end to end
# 0.15-0.20 and 0.47-0.76 card vs CPU, the decode up to 0.17 and 0.25
# from its forward; PERF.md). So are gemma3's six layers over 1100
# tokens, qwen2-vl's two over its 256 image rows and internlm2's two: on
# an H100 their forwards read 0.61, 0.24 and 0.071 card vs CPU end to
# end (gemma3's prefill and decodes 0.39-0.48, qwen2-vl's prefill 0.086,
# internlm2's third decode 0.078), where with the cores fed the CPU's
# every output reads at most 6.1e-3, 6.2e-3 and 3.4e-3, each core's
# inputs the card computed 6.6e-3, 6.2e-3 and 5.4e-3, and each core's
# output from the CPU's inputs 1.9e-3, 0.0 and 0.0 (PERF.md): the rows
# move where a key flips, not where the card computes a core or its
# inputs (M-RoPE and the image rows' write among them) otherwise. Their
# bounds hold with the cores made alike: card vs CPU with each core fed
# the CPU's inputs and outputs (``_Attention``), every core input the
# card computes held against the CPU's; the decode vs the forward with
# each prefill and decode core fed the forward's rows (``_FromForward``),
# every core input held against the forward's. End to end, and the
# decode against the forward, are printed.
HARD_ATTENTION = ("zamba2-2.7b", "whisper-small", "gemma3-1b", "qwen2-vl-7b",
                  "internlm2-20b")


def family_parity(torch, card, arch, n_layers, prompt, steps=3, batch=2):
    """(a) ``arch`` at its full widths, depth cut to ``n_layers``: the
    card's prefill and teacher-forced decode logits against the CPU
    port's on the same weights, tokens and (whisper) frames, end to end
    and with every attention core fed the CPU's inputs and outputs
    (``_Attention``: the forward, the prefill and the decodes, each
    core's inputs and output held on their own), and the card's decode
    against its own forward. MoE: the rows whose routing differs between
    card and CPU (at any layer of the forward, or of the prefill and the
    decode steps so far) are printed and left out of the 5e-2 bound; the
    decode-vs-forward bound holds on the same weights with no capacity
    drop (``_no_drop``), the configured capacity's numbers and dropped
    assignments printed. ``HARD_ATTENTION``: the decode-vs-forward bound
    holds with the cores fed the forward's rows (``_FromForward``); end
    to end, and the decode against the forward unforced, are printed."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=n_layers,
                              n_enc_layers=2 if cfg.enc_dec else 0)
    model = build_model(cfg)
    cpu = model.init(SEED, device="cpu")
    card_params = _tree_to(cpu, "cuda")
    inputs = {k: torch.from_numpy(v) for k, v in
              lm_batch(cfg, batch, prompt + steps, prompt=prompt).items()}
    recorded = _Attention()
    t0 = time.perf_counter()
    cpu_fwd, cpu_outs, cpu_calls = _lm_run(torch, model, cpu, inputs,
                                           prompt, steps, "cpu", recorded)
    cpu_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fwd, outs, calls = _lm_run(torch, model, card_params, inputs, prompt,
                               steps, "cuda")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    forcing = _Attention(feed=recorded.calls)
    forced_fwd, forced_outs, forced_calls = _lm_run(
        torch, model, card_params, inputs, prompt, steps, "cuda", forcing)
    if len(forcing.rels) != len(recorded.calls):
        fail(f"{arch}: {len(forcing.rels)} attention calls on the card, "
             f"{len(recorded.calls)} on the CPU")
    out = {"n_layers": n_layers, "prompt": prompt,
           "params": model.n_params(), "cpu_s": cpu_s, "card_s": card_s,
           "attention_cores": len(forcing.rels),
           "attention_cores_worst": max(forcing.rels, default=0.0),
           "attention_inputs": len(forcing.arg_rels),
           "attention_inputs_worst": max(forcing.arg_rels, default=0.0)}
    agree = [torch.ones(batch, dtype=torch.bool)] * len(outs)
    fwd_agree = forced_fwd_agree = torch.ones(batch, dtype=torch.bool)
    vs_fwd = _vs_forward(outs, fwd, prompt)
    if cfg.moe is not None:
        def rows(run_calls):
            """(rows whose forward routes alike, [the prefill's, then
            each decode step's, cumulatively])"""
            same = [_same_sets(a, b).reshape(batch, -1).all(1)
                    for (a, _), (b, _) in zip(run_calls, cpu_calls)]
            ok = [torch.stack(same[n_layers:2 * n_layers]).all(0)]
            for i in range(steps):
                lo = (2 + i) * n_layers
                ok.append(ok[-1] & torch.stack(same[lo:lo + n_layers])
                          .all(0))
            return torch.stack(same[:n_layers]).all(0), ok

        fwd_agree, agree = rows(calls)
        forced_fwd_agree, forced_agree = rows(forced_calls)
        nd_fwd, nd_outs, nd_calls = _lm_run(
            torch, build_model(_no_drop(cfg)), card_params, inputs, prompt,
            steps, "cuda")
        if _drops(nd_calls):
            fail(f"{arch}: the no-drop capacity dropped an assignment")
        out.update({
            "flipped_tokens_layer0": {
                "forward": int((~_same_sets(calls[0][0], cpu_calls[0][0]))
                               .sum()),
                "prefill": int((~_same_sets(
                    calls[n_layers][0], cpu_calls[n_layers][0])).sum())},
            "dropped_assignments": {
                "forward": _drops(calls[:n_layers]),
                "prefill": _drops(calls[n_layers:2 * n_layers]),
                "decode": _drops(calls[2 * n_layers:])},
            "routing_agrees_rows": [a.tolist() for a in agree],
            "decode_vs_forward_configured_capacity": vs_fwd})
        vs_fwd = _vs_forward(nd_outs, nd_fwd, prompt)
    else:
        forced_agree = agree

    def held(got, mask):
        return [_max_rel(o[a], w[a]) for o, w, a in zip(got, cpu_outs, mask)
                if a.any()]

    vs_cpu, forced = held(outs, agree), held(forced_outs, forced_agree)
    if not vs_cpu or not forced or not forced_fwd_agree.any():
        fail(f"{arch} parity: routing differs in every row {agree}")
    forced_fwd_rel = _max_rel(forced_fwd[forced_fwd_agree],
                              cpu_fwd[forced_fwd_agree])
    rest = [_max_rel(o, w) for o, w, a in zip(outs, cpu_outs, agree)
            if not a.all()]
    hard = arch in HARD_ATTENTION
    if max(forced + [forced_fwd_rel, out["attention_cores_worst"],
                     out["attention_inputs_worst"]]) > LM_BOUND:
        fail(f"{arch} parity: card vs CPU with the CPU's attention cores "
             f"{forced}, forward {forced_fwd_rel} (cores: worst "
             f"{out['attention_cores_worst']}, their inputs the card "
             f"computed: worst {out['attention_inputs_worst']}) > "
             f"{LM_BOUND}")
    if not hard and max(vs_cpu) > LM_BOUND:
        fail(f"{arch} parity: card vs CPU max-rel {vs_cpu} > {LM_BOUND}")
    cpu_vs_fwd = _vs_forward(cpu_outs, cpu_fwd, prompt)
    out.update({"card_vs_cpu": vs_cpu, "card_vs_cpu_rerouted_rows": rest,
                "card_vs_cpu_attention_forced": forced,
                "forward_card_vs_cpu_attention_forced": forced_fwd_rel,
                "cpu_decode_vs_forward": cpu_vs_fwd,
                "forward_card_vs_cpu": _max_rel(fwd[fwd_agree],
                                                cpu_fwd[fwd_agree])})
    if hard:
        from_fwd = _FromForward(prompt + steps)
        ff_fwd, ff_outs, _ = _lm_run(torch, model, card_params, inputs,
                                     prompt, steps, "cuda", from_fwd)
        out.update({"decode_vs_forward_unforced": vs_fwd,
                    "forward_fed_cores": len(from_fwd.rels),
                    "forward_fed_cores_own_worst": max(from_fwd.rels),
                    "forward_fed_inputs": len(from_fwd.arg_rels),
                    "forward_fed_inputs_worst": max(from_fwd.arg_rels)})
        vs_fwd = _vs_forward(ff_outs, ff_fwd, prompt)
        if out["forward_fed_inputs_worst"] > LM_BOUND:
            fail(f"{arch} parity: the prefill's and decodes' core inputs "
                 f"against the forward's, worst "
                 f"{out['forward_fed_inputs_worst']} > {LM_BOUND}")
    out["decode_vs_forward"] = vs_fwd
    if max(vs_fwd) >= LM_SELF_BOUND:
        fail(f"{arch} parity: decode vs forward max-rel {vs_fwd} >= "
             f"{LM_SELF_BOUND}")
    moe_line = ""
    if cfg.moe is not None:
        moe_line = (
            f"layer-0 tokens routed elsewhere on the card "
            f"{out['flipped_tokens_layer0']}, rows with the same routing "
            f"{out['routing_agrees_rows']} (others, not held: {rest}); "
            f"decode vs forward at the configured capacity "
            f"{out['decode_vs_forward_configured_capacity']} with dropped "
            f"assignments {out['dropped_assignments']} (reported); ")
    if hard:
        self_line = (
            f"card vs its forward with {out['forward_fed_cores']} prefill "
            f"and decode cores fed the forward's rows {vs_fwd} < "
            f"{LM_SELF_BOUND}, their {out['forward_fed_inputs']} inputs "
            f"against the forward's worst {out['forward_fed_inputs_worst']}"
            f" <= {LM_BOUND}, their own outputs against the forward's rows "
            f"worst {out['forward_fed_cores_own_worst']} (reported); "
            f"unforced {out['decode_vs_forward_unforced']} (reported; its "
            f"CPU run: {cpu_vs_fwd}); end to end card vs CPU {vs_cpu} "
            f"(reported); ")
    else:
        self_line = (
            f"end to end {vs_cpu} <= {LM_BOUND}; card vs its forward "
            f"{vs_fwd} < {LM_SELF_BOUND}"
            + (" (no-drop capacity)" if cfg.moe is not None else "")
            + "; ")
    log(f"family parity {arch} full width, {n_layers} layers "
        f"({model.n_params()} params), prompt {prompt}: card vs CPU "
        f"max-rel (prefill, {steps} decodes) with the CPU's attention "
        f"cores {forced}, forward {forced_fwd_rel} <= {LM_BOUND}, its "
        f"{len(forcing.rels)} attention cores from the CPU's inputs worst "
        f"{out['attention_cores_worst']} <= {LM_BOUND}, their "
        f"{len(forcing.arg_rels)} inputs the card computed against the "
        f"CPU's worst {out['attention_inputs_worst']} <= {LM_BOUND}; "
        f"{self_line}{moe_line}forward card vs CPU "
        f"{out['forward_card_vs_cpu']} (reported); CPU run {cpu_s:.1f} s, "
        f"card run {card_s:.3f} s on {card}")
    return out


def whisper_serve(torch, card, batch=4, max_new=16, skv=256):
    """(b) whisper-small as configured (12 encoder and 12 decoder layers)
    through ``Model.prefill`` with 4 x 1500 frames and the first four of
    ``launch/serve.py``'s prompts (left-padded as the engine pads them),
    then greedy decode steps, each timed to a synchronise; then one
    profiled decode step."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("whisper-small")
    model = build_model(cfg)
    params = model.init(SEED, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, rng.integers(2, 12))
               .astype(np.int32) for _ in range(batch)]
    plen = max(len(p) for p in prompts)
    toks = np.zeros((batch, plen), np.int32)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    frames = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (batch, cfg.n_frames, cfg.d_model)).astype(np.float32)).to("cuda")
    timed = _TimedModel(torch, model)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = timed.prefill(params, {
        "tokens": torch.from_numpy(toks).to("cuda"), "frames": frames},
        skv=skv)
    tok = logits.argmax(-1).to(torch.int32)
    pos = torch.full((batch,), plen, dtype=torch.int32, device="cuda")
    out_toks = [tok]
    for _ in range(max_new):
        logits, caches = timed.decode_step(
            params, caches, {"tokens": tok[:, None], "pos": pos})
        tok = logits.argmax(-1).to(torch.int32)
        pos = pos + 1
        out_toks.append(tok)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gen = torch.stack(out_toks, 1).cpu()
    if not bool(((gen >= 0) & (gen < cfg.vocab)).all()):
        fail("whisper serve: a token outside the vocabulary")
    tokens = batch * (max_new + 1)
    row = {"params": model.n_params(), "wall_s": wall, "tokens": tokens,
           "tokens_per_s": tokens / wall, "prefill_ms": timed.ms["prefill"],
           "decode_ms_median": statistics.median(timed.ms["decode"]),
           "decode_ms_min": min(timed.ms["decode"]),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "first_out": gen[0].tolist()}
    log(f"whisper serve whisper-small {cfg.n_enc_layers}+{cfg.n_layers} "
        f"layers ({model.n_params()} float32 params), {batch} x "
        f"{cfg.n_frames} frames, prompt {plen}, greedy: {tokens} tokens in "
        f"{wall:.3f} s = {tokens / wall:.1f} tokens/s; prefill ms "
        f"{[round(m, 3) for m in row['prefill_ms']]}, decode ms a step "
        f"median {row['decode_ms_median']:.3f} (min "
        f"{row['decode_ms_min']:.3f}, {max_new} steps); max memory "
        f"allocated {row['max_memory_allocated']} B on {card} (measured "
        f"on the card)")
    prof = lm_decode_profile(torch, model, params, cfg.vocab, slots=batch,
                             skv=skv, extra={"frames": frames})
    row["decode_profile"] = prof
    log(f"lm decode step profile whisper-small ({batch} slots): host "
        f"enqueue {prof['enqueue_ms']:.3f} ms, wall {prof['wall_ms']:.3f} "
        f"ms, {prof.get('kernels', 0)} CUDA kernels and "
        f"{prof.get('copies', 0)} copies summing "
        f"{prof.get('device_ms', 0.0):.3f} device ms, idle share "
        f"{prof['idle_share']:.3f} on {card} (measured on the card, "
        f"torch.profiler)")
    return row


def moe_wide(torch, card, prompt=8, steps=3, batch=2):
    """(b) qwen3-moe-235b-a22b at its full widths, depth cut to 1 layer
    (its 94 need more than one card), card only: the 128-expert dispatch
    at its real width; prefill and decode against its forward within
    1e-1 with no capacity drop (``_no_drop``), the configured capacity's
    numbers printed."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config(MOE_WIDE), n_layers=1)
    model = build_model(cfg)
    params = model.init(SEED, device="cuda")
    inputs = {k: torch.from_numpy(v) for k, v in
              lm_batch(cfg, batch, prompt + steps).items()}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fwd, outs, calls = _lm_run(torch, model, params, inputs, prompt, steps,
                               "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    nd_fwd, nd_outs, nd_calls = _lm_run(torch, build_model(_no_drop(cfg)),
                                        params, inputs, prompt, steps,
                                        "cuda")
    held = _vs_forward(nd_outs, nd_fwd, prompt)
    if _drops(nd_calls) or max(held) >= LM_SELF_BOUND:
        fail(f"{MOE_WIDE} 1 layer: decode vs forward {held}, "
             f"{_drops(nd_calls)} dropped at the no-drop capacity")
    out = {"params": model.n_params(),
           "active_params": model.n_active_params(),
           "decode_vs_forward": held,
           "decode_vs_forward_configured_capacity": _vs_forward(
               outs, fwd, prompt),
           "dropped_assignments": {"forward": _drops(calls[:1]),
                                   "prefill": _drops(calls[1:2]),
                                   "decode": _drops(calls[2:])},
           "wall_s": wall,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    log(f"moe wide {MOE_WIDE} 1 layer ({model.n_params()} float32 params, "
        f"{model.n_active_params()} active, 128 experts top-8): decode vs "
        f"forward {held} < {LM_SELF_BOUND} (no-drop capacity); at the "
        f"configured capacity {out['decode_vs_forward_configured_capacity']}"
        f" with dropped assignments {out['dropped_assignments']} "
        f"(reported); forward+prefill+{steps} decodes {wall:.3f} s, max "
        f"memory allocated {out['max_memory_allocated']} B on {card} "
        "(measured on the card)")
    return out


def moe_bookkeeping(torch, card, popcount, batch=4, seq=256):
    """(c) granite-moe-3b-a800m's routing bookkeeping on the card: for
    each of its 32 layers, the top-8 of the router (seeded random
    weights) over the embedded tokens of a 4 x 256 batch, then
    ``expert_bitmask_stats(idx, 40, engine=BulkBitwiseEngine("cuda"))``:
    one ``popcount_rows`` launch a call, the loads equal to
    ``numpy.bincount``, the masks equal to the plain version's."""
    from repro_torch.configs import get_config
    from repro_torch.core import BulkBitwiseEngine
    from repro_torch.models import build_model, moe
    from repro_torch.models.layers import embed
    from repro_torch.models.param import init_tree
    cfg = get_config("granite-moe-3b-a800m")
    defs = build_model(cfg).param_defs()
    gen = torch.Generator("cuda").manual_seed(SEED)
    p = init_tree({"embed": defs["embed"],
                   "router": defs["layers"]["moe"]["router"]}, gen)
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, seq))
                            .astype(np.int32)).to("cuda")
    x2d = embed(p, toks).reshape(batch * seq, cfg.d_model)
    eng = BulkBitwiseEngine("cuda", device="cuda")
    e_pad = moe.padded_experts(cfg.moe)
    launches, ms = 0, []
    for layer in range(cfg.n_layers):
        idx = moe.route(x2d, p["router"][layer], cfg.moe, e_pad)[2]
        before = popcount.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        masks, loads = moe.expert_bitmask_stats(idx, cfg.moe.n_experts,
                                                engine=eng)
        loads = loads.cpu()
        ms.append((time.perf_counter() - t0) * 1e3)
        if popcount.launches - before != 1:
            fail(f"expert_bitmask_stats layer {layer}: "
                 f"{popcount.launches - before} popcount_rows launches")
        launches += 1
        want = np.bincount(idx.cpu().numpy().reshape(-1),
                           minlength=cfg.moe.n_experts)
        if loads.tolist() != want.tolist():
            fail(f"expert_bitmask_stats layer {layer}: loads "
                 f"{loads.tolist()} != bincount {want.tolist()}")
        plain, plain_loads = moe.expert_bitmask_stats(idx,
                                                      cfg.moe.n_experts)
        if not torch.equal(masks.data, plain.data) or \
                plain_loads.tolist() != want.tolist():
            fail(f"expert_bitmask_stats layer {layer}: masks differ from "
                 "the plain version's")
    out = {"calls": cfg.n_layers, "launches": launches,
           "tokens": batch * seq, "wall_ms_median": statistics.median(ms)}
    log(f"moe bookkeeping granite-moe-3b-a800m: {cfg.n_layers} layers x "
        f"{batch * seq} tokens top-{cfg.moe.top_k} of {cfg.moe.n_experts} "
        f"experts, expert_bitmask_stats on "
        f"'cuda': {launches} popcount_rows launches (one a call), loads == "
        f"bincount, masks == plain; wall ms a call median "
        f"{out['wall_ms_median']:.3f} (host to host) on {card} (measured on "
        "the card)")
    return out


def families_phase(torch, card, wrappers):
    """Phase 9: (a) parity at full width for the MoE, SSM, hybrid and
    encoder-decoder families, (b) serving at full width and depth, the
    wide MoE at one layer, (c) the MoE bookkeeping through
    ``popcount_rows``."""
    report = {}
    for arch, (depth, prompt) in FAMILY_PARITY.items():
        report[f"parity {arch}"] = family_parity(torch, card, arch, depth,
                                                 prompt)
        torch.cuda.empty_cache()
    for arch, kw in FAMILY_SERVE.items():
        report[f"serve {arch}"] = lm_serve(torch, card, arch=arch, **kw)
        torch.cuda.empty_cache()
    report["serve whisper-small"] = whisper_serve(torch, card)
    torch.cuda.empty_cache()
    report[f"wide {MOE_WIDE}"] = moe_wide(torch, card)
    torch.cuda.empty_cache()
    before = wrappers["popcount_rows"].launches
    report["bookkeeping"] = moe_bookkeeping(torch, card,
                                            wrappers["popcount_rows"])
    calls = report["bookkeeping"]["calls"]
    if before or wrappers["popcount_rows"].launches != calls:
        fail(f"phase 9 launched popcount_rows {before} times before the "
             f"bookkeeping and {wrappers['popcount_rows'].launches - before}"
             f" in it, not 0 and {calls}")
    torch.cuda.empty_cache()
    return report


# -- phase 10 -----------------------------------------------------------------

# arch: (depth, tokens a sequence, batch) of the card-vs-CPU train step;
# mamba2 runs over three SSD chunks of 128, the MoE at a capacity that
# drops nothing (``_no_drop``), gemma3 past its 1024-token window (five
# local layers and one global), qwen2-vl with its image inputs
# (``lm_batch``); the last two at batch 1, to keep the CPU's step short
TRAIN_PARITY = {"qwen2.5-3b": (2, 128, 2), "granite-moe-3b-a800m": (2, 128, 2),
                "mamba2-780m": (2, 300, 2), "zamba2-2.7b": (6, 128, 2),
                "whisper-small": (2, 128, 2), "gemma3-1b": (6, 1040, 1),
                "qwen2-vl-7b": (2, 264, 1)}
TRAIN_LOSS_BOUND = 5e-3     # relative
TRAIN_GRAD_BOUND = 5e-2     # grad_norm relative; each leaf norm-relative
TRAIN_UPDATE_BOUND = 1e-5   # optim.update on the CPU's gradients, max-rel
# archs of TRAIN_PARITY held with every attention core fed the CPU's
# inputs and outputs (``_Attention``); the unforced numbers are printed.
# Their attention flips keys on a cuBLAS ulp at this init, and the step's
# gradients follow the flipped rows: on an H100 qwen2.5-3b's unforced
# leaves read 0.55-1.14 from the CPU's (grad_norm 0.34), granite's
# 0.19-0.25, whisper's 1.41 (loss 2.2e-2), where fed the CPU's cores
# they read at most 7.6e-3, 9.4e-3 and 1.3e-2 (PERF.md).
TRAIN_FORCED = ("qwen2.5-3b", "granite-moe-3b-a800m", "zamba2-2.7b",
                "whisper-small", "gemma3-1b", "qwen2-vl-7b")
# arch: a gradient leaf that is a near-cancelling sum, held by its
# card-vs-CPU difference over the CPU's global gradient norm (under
# TRAIN_GRAD_BOUND), not over its own norm. zamba2's shared ln1 (norm
# 8.3e-3 in a global norm of 237.7) and qwen2-vl's k bias (7.6e-3 in
# 79.9; a bias every key shares moves no softmax but where rope turns
# it) are far from a float64 step of the same weights and batch on the
# CPU (``_float64_grads``) in the CPU's own float32/bf16 step: 0.58 and
# 1.53 of their norms, on an H100 the card's own step 0.28 and 1.32
# (PERF.md). The float64 step runs on every call, and the card's own
# (unforced) leaf must stay within TRAIN_F64_RATIO times the CPU's
# distance from it; with the cores fed the CPU's (the gated run) the
# card mixes the CPU's attention outputs with its own backward, so that
# leaf is printed beside them.
TRAIN_ILL_CONDITIONED = {"zamba2-2.7b": "shared/ln1",
                         "qwen2-vl-7b": "layers/attn/bk"}
TRAIN_F64_RATIO = 2.0
TRAIN_OPT = dict(lr=1e-3, warmup_steps=20, total_steps=20)  # launch/train's
TRAIN_FULL = dict(arch=LM_ARCH, steps=20, batch=8, seq=128)  # its defaults


def _norm_rel(got, want) -> float:
    """|got - want| / |want| (Frobenius norms), on the host in float64."""
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).norm() / want.norm().clamp_min(1e-300))


def _named_leaves(tree, path=()):
    """(path, leaf) in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def _grad_numbers(loss, grads, want_loss, want_grads, gnorm, want_gnorm,
                  apart=None):
    """The loss, grad_norm and each gradient leaf against the CPU's; the
    leaf ``apart`` is left out of the worst leaf and given as its
    difference over the CPU's global gradient norm (``apart_vs_global``)
    and over its own norm (``apart_rel``)."""
    leaves = {p: _norm_rel(g, w) for (p, g), (_, w) in
              zip(_named_leaves(grads), _named_leaves(want_grads))}
    out = {}
    if apart is not None:
        out["apart_rel"] = leaves.pop(apart)
        out["apart_vs_global"] = out["apart_rel"] * float(
            _leaf(want_grads, apart).double().norm()) / want_gnorm
    worst = max(leaves, key=leaves.get)
    return dict(out, loss=float(loss),
                loss_rel=abs(float(loss) - want_loss) / abs(want_loss),
                grad_norm=gnorm,
                grad_norm_rel=abs(gnorm - want_gnorm) / want_gnorm,
                leaf_worst=leaves[worst], leaf_worst_at=worst)


def _leaf(tree, path):
    """The leaf of ``tree`` at ``path`` ("a/b")."""
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _float64_mode(torch):
    """A ``TorchFunctionMode`` under which every floating dtype a torch
    call names (a ``dtype=`` argument, ``Tensor.to``'s dtype) is
    float64: the port's bf16 compute dtype and its f32 statistics and
    rounding points, for the calls made while it is active, and no
    default of the port changes. ``narrow`` names each call that still
    returned a floating tensor of another dtype."""
    from torch.overrides import TorchFunctionMode
    low = (torch.float32, torch.bfloat16, torch.float16)

    def wide(a):
        return torch.float64 if isinstance(a, torch.dtype) and a in low \
            else a

    class Float64(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.narrow = set()

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = {k: wide(v) for k, v in (kwargs or {}).items()}
            out = func(*map(wide, args), **kwargs)
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor) and t.is_floating_point() \
                        and t.dtype != torch.float64:
                    self.narrow.add(getattr(func, "__name__", str(func)))
            return out

    return Float64()


def _float64_grads(torch, model, params, host):
    """The loss and the gradient tree of one step on ``params`` and
    ``host`` on the CPU with every computation in float64
    (``_float64_mode``, the parameters widened; no remat, which changes
    no value)."""
    from repro_torch.models.param import map_tree
    from repro_torch.train import step as train_step
    wide = map_tree(lambda t: t.detach().double(), params)
    loss_fn = train_step.make_loss_fn(model, remat=False)
    with _float64_mode(torch) as mode:
        (loss, _), grads = train_step.value_and_grad(loss_fn, wide, host)
    if mode.narrow:
        fail(f"the float64 step computed narrower floats in "
             f"{sorted(mode.narrow)}")
    return float(loss), grads


def _from_float64(got, want, gnorm):
    """``got``'s distance from the float64 leaf ``want``: (over the
    float64 global gradient norm ``gnorm``, over ``want``'s own norm)."""
    diff = float((got.detach().double().cpu() - want).norm())
    return diff / gnorm, diff / float(want.norm())


def _train_batch(torch, cfg, batch, seq):
    """``lm_batch`` with labels (the next token), as host tensors."""
    return {k: torch.from_numpy(v) for k, v in
            lm_batch(cfg, batch, seq, labels=True).items()}


def train_parity(torch, card, arch, n_layers, seq, batch=2):
    """(a) One train step (``remat="save_attn"``) of ``arch`` at its full
    widths, depth cut to ``n_layers``, on the card against the CPU port
    on the same weights and batch: the loss, grad_norm and each gradient
    leaf, unforced and (with attention) with every core fed the CPU's
    inputs and outputs (``_Attention``); ``optim.update`` fed the CPU's
    gradients against the CPU's update; then ``make_train_step`` itself
    on the card, which must give the same loss and move every leaf.
    ``TRAIN_ILL_CONDITIONED``: the named leaf is held by its difference
    over the global gradient norm, and the card's leaf and the CPU's
    against a float64 step on the CPU (``_float64_grads``)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_leaves
    from repro_torch.optim import optimizer as opt
    from repro_torch.train import step as train_step
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=n_layers,
                              n_enc_layers=2 if cfg.enc_dec else 0)
    if cfg.moe is not None:
        cfg = _no_drop(cfg)
    model = build_model(cfg)
    cpu = model.init(SEED, device="cpu")
    host = _train_batch(torch, cfg, batch, seq)
    loss_fn = train_step.make_loss_fn(model, remat="save_attn")
    recorded = _Attention()
    t0 = time.perf_counter()
    with recorded:
        (cpu_loss, _), cpu_grads = train_step.value_and_grad(loss_fn, cpu,
                                                             host)
    cpu_s = time.perf_counter() - t0
    cpu_loss, cpu_gnorm = float(cpu_loss), float(opt.global_norm(cpu_grads))
    apart = TRAIN_ILL_CONDITIONED.get(arch)
    if apart is not None:
        t0 = time.perf_counter()
        loss64, grads64 = _float64_grads(torch, model, cpu, host)
        gnorm64 = float(torch.sqrt(sum(
            (g * g).sum() for g in tree_leaves(grads64))))
        want64 = _leaf(grads64, apart)
        del grads64
        f64 = {"loss": loss64, "grad_norm": gnorm64,
               "leaf_norm": float(want64.norm()),
               "cpu": _from_float64(_leaf(cpu_grads, apart), want64,
                                    gnorm64),
               "s": time.perf_counter() - t0}
    params = _tree_to(cpu, "cuda")
    data = _tree_to(host, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (loss, _), grads = train_step.value_and_grad(loss_fn, params, data)
    gnorm = float(opt.global_norm(grads))
    card_s = time.perf_counter() - t0
    unforced = _grad_numbers(loss, grads, cpu_loss, cpu_grads, gnorm,
                             cpu_gnorm, apart)
    if apart is not None:
        f64["card_unforced"] = _from_float64(_leaf(grads, apart), want64,
                                             gnorm64)
    del grads
    out = {"n_layers": n_layers, "seq": seq, "params": model.n_params(),
           "cpu_loss": cpu_loss, "cpu_grad_norm": cpu_gnorm,
           "unforced": unforced, "cpu_s": cpu_s, "card_s": card_s}
    if recorded.calls:
        forcing = _Attention(feed=recorded.calls)
        with forcing:
            (f_loss, _), f_grads = train_step.value_and_grad(loss_fn, params,
                                                             data)
        if len(forcing.rels) != len(recorded.calls):
            fail(f"{arch}: {len(forcing.rels)} attention calls in the "
                 f"card's step, {len(recorded.calls)} in the CPU's")
        out["forced"] = dict(
            _grad_numbers(f_loss, f_grads, cpu_loss, cpu_grads,
                          float(opt.global_norm(f_grads)), cpu_gnorm, apart),
            cores=len(forcing.rels), cores_worst=max(forcing.rels),
            core_inputs_worst=max(forcing.arg_rels))
        if apart is not None:
            f64["card"] = _from_float64(_leaf(f_grads, apart), want64,
                                        gnorm64)
        del f_grads
    forced = arch in TRAIN_FORCED
    gated = out["forced"] if forced else unforced
    extra = [gated["cores_worst"], gated["core_inputs_worst"]] \
        if forced else []
    if apart is not None:
        out["float64"] = f64
        extra.append(gated["apart_vs_global"])
        card64 = f64["card_unforced"][0]
        if card64 > TRAIN_F64_RATIO * f64["cpu"][0]:
            fail(f"{arch} train parity: the card's {apart} gradient is "
                 f"{card64} (of the global norm) from the float64 step's, "
                 f"over {TRAIN_F64_RATIO} x the CPU's {f64['cpu'][0]}")
    if gated["loss_rel"] > TRAIN_LOSS_BOUND or max(
            [gated["grad_norm_rel"], gated["leaf_worst"]] + extra) \
            > TRAIN_GRAD_BOUND:
        fail(f"{arch} train parity: {gated} against the CPU over loss "
             f"{TRAIN_LOSS_BOUND}, grad_norm and leaves {TRAIN_GRAD_BOUND}"
             + (" (attention cores fed the CPU's)" if forced else ""))

    # the card's update fed the CPU's gradients, against the CPU's
    opt_cfg = opt.OptimizerConfig(**TRAIN_OPT)
    step_params = _tree_to(cpu, "cuda")
    cpu_state, card_state = opt.init(cpu), opt.init(params)
    opt.update(opt_cfg, cpu_grads, cpu_state, cpu)
    opt.update(opt_cfg, _tree_to(cpu_grads, "cuda"), card_state, params)
    pairs = [(params, cpu), (card_state["m"], cpu_state["m"]),
             (card_state["v"], cpu_state["v"])]
    out["update_worst"] = max(_max_rel(g, w) for got, want in pairs
                              for g, w in zip(tree_leaves(got),
                                              tree_leaves(want)))
    if out["update_worst"] > TRAIN_UPDATE_BOUND:
        fail(f"{arch}: optim.update on the card, fed the CPU's gradients, "
             f"{out['update_worst']} from the CPU's > {TRAIN_UPDATE_BOUND}")
    del params, card_state, cpu_grads

    # the entry point: make_train_step on the card
    before = [p.clone() for p in tree_leaves(step_params)]
    state = {"params": step_params, "opt": opt.init(step_params)}
    state, m = train_step.make_train_step(model, opt_cfg)(state, data)
    step_loss = float(m["loss"])
    if not abs(step_loss - float(loss)) <= 1e-6 * abs(float(loss)):
        fail(f"{arch}: make_train_step's loss {step_loss} is not "
             f"value_and_grad's {float(loss)}")
    moved = [not torch.equal(a, b) and bool(torch.isfinite(a).all())
             for a, b in zip(tree_leaves(state["params"]), before)]
    if not all(moved):
        fail(f"{arch}: the step left {moved.count(False)} parameter leaves "
             "unchanged or non-finite")
    out["step_grad_norm"] = float(m["grad_norm"])
    forced_line = ""
    if "forced" in out:
        f = out["forced"]
        forced_line = (
            f"; with its {f['cores']} attention cores fed the CPU's: loss "
            f"{f['loss_rel']:.3e}, grad_norm {f['grad_norm_rel']:.3e}, "
            f"worst leaf {f['leaf_worst']:.3e} ({f['leaf_worst_at']}), "
            f"cores worst {f['cores_worst']:.3e}, their inputs worst "
            f"{f['core_inputs_worst']:.3e}")
    apart_line = ""
    if apart is not None:
        g = gated
        apart_line = (
            f"; {apart} apart: its card-vs-CPU difference over the global "
            f"norm {g['apart_vs_global']:.3e} (bound {TRAIN_GRAD_BOUND}), "
            f"over its own {g['apart_rel']:.3e} (reported); against a "
            f"float64 step on the CPU (loss {f64['loss']:.6f}, global norm "
            f"{f64['grad_norm']:.4f}, {apart} norm {f64['leaf_norm']:.4e}, "
            f"{f64['s']:.1f} s) over the global norm and over its own: "
            f"card {f64['card_unforced'][0]:.3e}, "
            f"{f64['card_unforced'][1]:.3e}; CPU {f64['cpu'][0]:.3e}, "
            f"{f64['cpu'][1]:.3e} (card within {TRAIN_F64_RATIO} x the "
            f"CPU's); card with the cores fed "
            + (f"{f64['card'][0]:.3e}, {f64['card'][1]:.3e} (reported)"
               if "card" in f64 else "(none)"))
    u = unforced
    log(f"train parity {arch} full width, {n_layers} layers "
        f"({model.n_params()} params), batch {batch} x {seq}, "
        f"remat save_attn (held)"
        f"{' gated with the cores fed the CPU' if forced else ''}"
        f": card vs CPU loss {u['loss']:.6f} vs {cpu_loss:.6f} (rel "
        f"{u['loss_rel']:.3e}, bound {TRAIN_LOSS_BOUND}), grad_norm rel "
        f"{u['grad_norm_rel']:.3e}, worst leaf {u['leaf_worst']:.3e} "
        f"({u['leaf_worst_at']}) (bound {TRAIN_GRAD_BOUND}){forced_line}"
        f"{apart_line}; "
        f"update fed the CPU's grads worst {out['update_worst']:.3e} (bound "
        f"{TRAIN_UPDATE_BOUND}); make_train_step's loss within 1e-6 of it, "
        f"every leaf moved; CPU step {cpu_s:.1f} s, card {card_s:.3f} s on {card}")
    return out


def train_full(torch, card, scan, arch, steps, batch, seq, mesh=None,
               counted=False):
    """(b) ``arch`` as configured (qwen2.5-3b: 36 layers, 3.40 B float32
    parameters) trained by ``make_train_step`` for ``steps`` steps on
    ``FilteredSyntheticLM``'s batches (its filter: two scan launches):
    every loss and every parameter finite; step ms, tokens/s, peak memory
    and one profiled step. With ``mesh`` (phase 11(b)) the state is
    placed on it (``init_state(mesh=)``: DTensors) and the step is the
    sharded one. Whether the mean loss of the last 5 steps fell
    below the first 5's is printed with each step's grad_norm, not
    required: at the reference's init the 36-layer stack's gradient norm
    reaches 1e17 and past float32's range (the norm reads inf and the
    clip scales the step to nothing), as the reference's own grows with
    depth (``tests/test_torch_train.py``), and the loss stays within its
    batch-to-batch spread (PERF.md). ``launch.train``'s reduced run
    (phase 10(c)) holds that criterion. With ``counted`` (11(b), for
    phase 12(b)) one more, untimed step runs under ``FlopCounterMode``
    with the peak memory reset before it: its FLOPs and the most it
    held above what was live before it are returned."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, FilteredSyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim.optimizer import OptimizerConfig
    from repro_torch.train.step import init_state, make_train_step
    cfg = get_config(arch)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = init_state(model, SEED, device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    before = scan.launches
    data = FilteredSyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                          global_batch=batch), device="cuda")
    if scan.launches - before != 2:
        fail(f"FilteredSyntheticLM launched bitweaving_scan "
             f"{scan.launches - before} times, not 2")
    step = make_train_step(model, OptimizerConfig(**TRAIN_OPT), mesh=mesh,
                           remat="save_attn", microbatches=1)

    def batch_at(s):
        b = data.batch_at(s)
        return {k: torch.from_numpy(b[k]).to("cuda")
                for k in ("tokens", "labels")}

    losses, gnorms, ms = [], [], []
    for s in range(steps):
        b = batch_at(s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        gnorms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)):
        fail(f"train {arch}: non-finite losses {losses}")
    bad = [k for k, p in _named_leaves(state["params"])
           if not bool(torch.isfinite(_local(p)).all())]
    if bad:
        fail(f"train {arch}: non-finite parameters after {steps} steps in "
             f"{bad}")
    n = min(5, steps)
    first, last = float(np.mean(losses[:n])), float(np.mean(losses[-n:]))
    warm = ms[1:]
    median = statistics.median(warm)
    prof = _cuda_events(torch, lambda: step(state, batch_at(steps)))
    extra = _counted_step(torch, step, state, batch_at(steps)) \
        if counted else None
    out = {"arch": arch, "n_layers": cfg.n_layers, "mesh": mesh is not None,
           "params": model.n_params(), "batch": batch, "seq": seq,
           "steps": steps, "init_s": init_s, "losses": losses,
           "first5_mean": first, "last5_mean": last, "loss_fell":
               last < first, "grad_norms": gnorms,
           "grad_norm_inf_steps": sum(not np.isfinite(g) for g in gnorms),
           "step_ms": ms,
           "step_ms_median": median, "step_ms_min": min(warm),
           "step_ms_max": max(warm),
           "tokens_per_s": batch * seq / (median / 1e3),
           "max_memory_allocated": peak,
           "state_bytes": 4 * 4 * model.n_params(),
           "profile": prof, "counted": extra,
           "idle_share": 1 - prof.get("device_ms", 0.0) / median}
    log(f"train {arch}{' sharded on the (1,1) mesh' if mesh else ''} "
        f"{cfg.n_layers} layers ({model.n_params()} float32 "
        f"params; params, grads, m, v {out['state_bytes']} B), batch "
        f"{batch} x seq {seq}, remat save_attn, {steps} steps on "
        f"FilteredSyntheticLM: every loss and parameter finite; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, first {n} mean {first:.4f}, "
        f"last {n} mean {last:.4f} ({'fell' if last < first else 'did not fall'}"
        f", reported); grad_norm {min(gnorms):.3e} to {max(gnorms):.3e} "
        f"({out['grad_norm_inf_steps']} steps inf, reported); step ms "
        f"median {median:.3f} min {min(warm):.3f} max {max(warm):.3f} "
        f"(first {ms[0]:.3f}), {out['tokens_per_s']:.1f} tokens/s; max "
        f"memory allocated {peak} B; one profiled step: "
        f"{prof.get('kernels', 0)} CUDA kernels and {prof.get('copies', 0)}"
        f" copies summing {prof.get('device_ms', 0.0):.3f} device ms, idle "
        f"share {out['idle_share']:.3f} of the median step on {card} "
        f"(measured on the card)")
    return out


def _counted_step(torch, step, state, batch) -> dict:
    """One step under ``FlopCounterMode``: its FLOPs, the bytes live
    before it and the most it allocated above them (the peak statistics
    reset just before it)."""
    from torch.utils.flop_counter import FlopCounterMode
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as flops:
        step(state, batch)
    torch.cuda.synchronize()
    return {"flops": flops.get_total_flops(), "live_before": before,
            "peak_above": torch.cuda.max_memory_allocated() - before}


def train_entry(torch, card, scan, steps=30, more=10):
    """(c) ``launch.train.main --reduced --device cuda`` for ``steps``
    steps into a temporary checkpoint directory, then ``--resume`` to
    ``steps + more``: each run launches the scan twice, the resumed run
    starts at ``steps``, each run's final checkpoint equals its live
    state bit for bit, and the first run's loss falls (the mean of its
    last 5 steps below its first 5's: the criterion of
    ``test_train_infra.py::test_loss_decreases``)."""
    import tempfile
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch import train as launch_train
    from repro_torch.models.param import tree_leaves
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp)
        for name, argv, want_start in (
                ("run", ["--steps", str(steps)], 0),
                ("resume", ["--steps", str(steps + more), "--resume"],
                 steps)):
            before = scan.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start, state, hist = launch_train.main(
                ["--reduced", "--device", "cuda", "--ckpt-dir", tmp] + argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = scan.launches - before
            end = int(argv[1])
            ran = [h["step"] for h in hist if "loss" in h]
            if start != want_start or ran != list(range(want_start, end)):
                fail(f"launch.train {name}: started at {start}, ran {ran}")
            if launches != 2:
                fail(f"launch.train {name} launched bitweaving_scan "
                     f"{launches} times, not 2")
            saved = ck.restore(end, device="cuda")[1]
            same = [a.dtype == b.dtype and torch.equal(a, b)
                    for a, b in zip(tree_leaves(saved), tree_leaves(state))]
            if len(same) != len(tree_leaves(state)) or not all(same):
                fail(f"launch.train {name}: the step-{end} checkpoint "
                     f"differs from the live state in {same.count(False)} "
                     "leaves")
            losses = [h["loss"] for h in hist if "loss" in h]
            if not all(np.isfinite(losses)):
                fail(f"launch.train {name}: non-finite losses {losses}")
            fell = float(np.mean(losses[-5:])) < float(np.mean(losses[:5]))
            if name == "run" and not fell:
                fail(f"launch.train: the mean loss of the last 5 steps is "
                     f"not below the first 5's: {losses}")
            out[name] = {"start": start, "end": end, "wall_s": wall,
                         "scan_launches": launches,
                         "first_loss": losses[0], "last_loss": losses[-1],
                         "first5_mean": float(np.mean(losses[:5])),
                         "last5_mean": float(np.mean(losses[-5:])),
                         "checkpoints": ck.steps()}
            log(f"launch.train {name} --reduced --device cuda: steps "
                f"{start}->{end}, loss {losses[0]:.4f} -> {losses[-1]:.4f} "
                f"(mean of the first 5 {out[name]['first5_mean']:.4f}, of "
                f"the last 5 {out[name]['last5_mean']:.4f}"
                + (", held" if name == "run" else "") + f"), {launches} "
                f"bitweaving_scan launches, checkpoints "
                f"{ck.steps()}, step-{end} checkpoint == live state (bit "
                f"for bit), wall {wall:.3f} s on {card}")
    return out


def train_phase(torch, card, wrappers):
    """Phase 10: (a) the train step at full width against the CPU port,
    (b) the trainer at full width and depth, (c) ``launch.train`` and its
    resume."""
    scan = wrappers["bitweaving_scan"]
    report = {}
    for arch, (depth, seq, batch) in TRAIN_PARITY.items():
        report[f"parity {arch}"] = train_parity(torch, card, arch, depth, seq,
                                                batch)
        torch.cuda.empty_cache()
    report["full"] = train_full(torch, card, scan, **TRAIN_FULL)
    torch.cuda.empty_cache()
    report["entry"] = train_entry(torch, card, scan)
    torch.cuda.empty_cache()
    return report


# -- phase 11 -----------------------------------------------------------------

MESH_STEPS = 3      # 11(b): the sharded trainer at full size
MESH_FAMILY = "granite-moe-3b-a800m"


def _local(t):
    """A DTensor's shard on this rank (the whole tensor on one rank)."""
    return t.to_local() if hasattr(t, "to_local") else t


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


class _Collectives:
    """Counts the collectives the mesh paths call (``all_reduce``, the
    gathers and reduce-scatters of ``sharding_ctx``) while it is
    entered."""

    def __init__(self):
        import torch.distributed as dist
        from repro_torch.models import sharding_ctx
        self.calls = {}
        self._sites = [(dist, "all_reduce"), (sharding_ctx, "_gather_into"),
                       (sharding_ctx, "_scatter_into")]
        self._saved = []

    def __enter__(self):
        for mod, name in self._sites:
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))
            setattr(mod, name, self._counted(name, fn))
        return self

    def _counted(self, name, fn):
        def call(*args, **kw):
            self.calls[name] = self.calls.get(name, 0) + 1
            return fn(*args, **kw)
        return call

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        return False


def mesh_parity(torch, card, mesh, n_layers=2, batch=2, seq=128):
    """(a) qwen2.5-3b at full width, ``n_layers`` layers: one step of
    ``make_train_step(mesh=)`` from ``init_state(mesh=)`` against the
    mesh-free step from ``init_state``, on the same batch; then
    granite-moe at full width (40 experts padded to 48, top-8),
    ``Model.forward(mesh=)`` on sharded parameters against the mesh-free
    forward. On one rank the mesh path adds no arithmetic (its gathers
    and reductions copy or keep values), so both are held bit for bit:
    the initial state, the loss and every metric, every updated
    parameter and moment, the logits and the aux loss; and the mesh step
    and forward call no collective (``_Collectives``): over a (1,1) mesh
    every ``"model"`` and batch axis has one rank. The device
    memory that ``init_state(mesh=)``, ``save`` of the sharded
    parameters and ``restore(mesh=, spec_tree=)`` of them hold above
    the state (their transients) is read from the allocator's peak and
    held to two whole leaves of the largest, and the restore to the
    saved parameters bit for bit."""
    import dataclasses
    import tempfile
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.param import ShardingRules, tree_leaves
    from repro_torch.models.sharding_ctx import distribute, mesh_shape_dict
    from repro_torch.optim.optimizer import OptimizerConfig
    from repro_torch.train import step as train_step
    out = {}
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=n_layers)
    model = build_model(cfg)
    data = _tree_to(_train_batch(torch, cfg, batch, seq), "cuda")
    opt_cfg = OptimizerConfig(**TRAIN_OPT)
    free = train_step.init_state(model, SEED, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    placed = train_step.init_state(model, SEED, device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    transient = {"init": torch.cuda.max_memory_allocated()
                 - torch.cuda.memory_allocated()}
    if not all(hasattr(p, "placements")
               for p in tree_leaves(placed["params"])):
        fail("init_state(mesh=) left plain tensors")
    if not all(torch.equal(a, _local(b)) for a, b in
               zip(tree_leaves(free), tree_leaves(placed))):
        fail("init_state(mesh=) drew other parameters than init_state")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new_free, m_free = train_step.make_train_step(
        model, opt_cfg, remat="save_attn")(free, data)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with _Collectives() as coll:
        new_mesh, m_mesh = train_step.make_train_step(
            model, opt_cfg, mesh=mesh, remat="save_attn")(placed, data)
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    if coll.calls:
        fail(f"the (1,1) mesh step called collectives: {coll.calls}")
    differ = [k for (k, a), (_, b) in zip(_named_leaves(new_free),
                                          _named_leaves(new_mesh))
              if not torch.equal(a, _local(b))]
    metrics = {k: (float(m_free[k]), float(m_mesh[k])) for k in m_free}
    worst = max((_max_rel(_local(b), a) for (_, a), (_, b) in zip(
        _named_leaves(new_free), _named_leaves(new_mesh))), default=0.0)
    if differ or any(not torch.equal(m_free[k], m_mesh[k]) for k in m_free):
        fail(f"the (1,1) mesh step differs from the mesh-free step: "
             f"metrics {metrics}, {len(differ)} leaves differ (first "
             f"{differ[:4]}, worst max-rel {worst:.3e})")
    out[LM_ARCH] = {"n_layers": n_layers, "batch": batch, "seq": seq,
                    "loss": metrics["loss"][0],
                    "grad_norm": metrics["grad_norm"][0],
                    "leaves": len(tree_leaves(new_free)),
                    "step_s_free": t1 - t0, "step_s_mesh": t2 - t1,
                    "collectives": coll.calls}
    log(f"mesh parity {LM_ARCH} full width, {n_layers} layers, batch "
        f"{batch} x {seq}, remat save_attn: the (1,1) mesh step equals the "
        f"mesh-free step bit for bit (loss {metrics['loss'][0]:.6f}, "
        f"grad_norm {metrics['grad_norm'][0]:.6f}, "
        f"{len(tree_leaves(new_free))} leaves of params, m and v, every "
        f"metric) and calls collectives {coll.calls} (none); first steps "
        f"{t1 - t0:.3f} s mesh-free, {t2 - t1:.3f} s on the mesh, on {card}")
    del free, placed, new_free

    # the sharded save and the restore onto the mesh, a leaf at a time
    specs = {"params": model.param_specs(ShardingRules(),
                                         mesh_shape_dict(mesh))}
    largest = max(_local(p).numel() * _local(p).element_size()
                  for p in tree_leaves(new_mesh["params"]))
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ck.save(1, {"params": new_mesh["params"]}, blocking=True)
        torch.cuda.synchronize()
        transient["save"] = torch.cuda.max_memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        _, back = ck.restore(mesh=mesh, spec_tree=specs)
        torch.cuda.synchronize()
        transient["restore"] = (torch.cuda.max_memory_allocated()
                                - torch.cuda.memory_allocated())
    if not all(hasattr(b, "placements") and torch.equal(_local(b), _local(a))
               for a, b in zip(tree_leaves(new_mesh["params"]),
                               tree_leaves(back["params"]))):
        fail("the sharded parameters restored onto the (1,1) mesh differ "
             "from those saved")
    over = {k: v for k, v in transient.items() if v > 2 * largest}
    if over:
        fail(f"init_state(mesh=), save or restore held more than two whole "
             f"leaves ({2 * largest} B) above the state: {over}")
    out["transient_bytes"] = dict(transient, largest_leaf=largest)
    log(f"mesh memory {LM_ARCH} full width, {n_layers} layers, on one "
        f"rank: above the state, init_state(mesh=) held {transient['init']}"
        f" B at its peak, a sharded save of the parameters "
        f"{transient['save']} B, restore(mesh=, spec_tree=) "
        f"{transient['restore']} B (the largest leaf whole: {largest} B; "
        f"bound twice that); the restore equals the saved parameters bit "
        f"for bit, on {card}")
    del new_mesh, back
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(get_config(MESH_FAMILY), n_layers=n_layers)
    model = build_model(cfg)
    params = model.init(SEED, device="cuda")
    toks = _tree_to(_train_batch(torch, cfg, batch, seq), "cuda")["tokens"]
    with torch.no_grad():
        want, want_aux = model.forward(params, {"tokens": toks})
        sharded = distribute(params, mesh, model.param_specs(
            ShardingRules(), mesh_shape_dict(mesh)))
        with _Collectives() as coll:
            got, got_aux = model.forward(sharded, {"tokens": toks},
                                         mesh=mesh)
            torch.cuda.synchronize()
        got = _whole(got)       # the logits come back as a DTensor
    if coll.calls:
        fail(f"{MESH_FAMILY} forward on the (1,1) mesh called collectives: "
             f"{coll.calls}")
    if not (torch.equal(got, want) and torch.equal(got_aux, want_aux)):
        fail(f"{MESH_FAMILY} forward on the (1,1) mesh differs from the "
             f"mesh-free forward: logits max-rel {_max_rel(got, want):.3e}, "
             f"aux {float(got_aux)} vs {float(want_aux)}")
    out[MESH_FAMILY] = {"n_layers": n_layers, "batch": batch, "seq": seq,
                        "aux": float(want_aux), "collectives": coll.calls}
    log(f"mesh parity {MESH_FAMILY} full width ({cfg.moe.n_experts} experts "
        f"padded to 48, top-{cfg.moe.top_k}), {n_layers} layers, batch "
        f"{batch} x {seq}: Model.forward(mesh=) on sharded parameters "
        f"equals the mesh-free forward bit for bit (logits and aux "
        f"{float(want_aux):.6f}) and calls collectives {coll.calls} (none) "
        f"on {card}")
    return out


# 11(a): the SSM, hybrid and encoder-decoder families on the mesh (depth
# and prompt tokens as FAMILY_PARITY: mamba2 2 layers over 300 tokens,
# zamba2 one group and its shared block, whisper 2+2 layers at 1500
# frames); mamba2 also takes one sharded train step
MESH_FAMILIES = ("mamba2-780m", "zamba2-2.7b", "whisper-small")
MESH_FAMILY_TRAIN = "mamba2-780m"


def mesh_families(torch, card, mesh, batch=2, steps=3):
    """(a) each of ``MESH_FAMILIES`` at full width, its depth cut as
    ``FAMILY_PARITY``: ``Model.forward(mesh=)``, ``prefill(mesh=)`` and
    ``steps`` ``decode_step(mesh=)`` on sharded parameters against the
    mesh-free calls on the same weights, tokens and (whisper) frames, and
    ``MESH_FAMILY_TRAIN``'s ``make_train_step(mesh=)`` step from
    ``init_state(mesh=)`` against the mesh-free step. On one rank the
    mesh paths add no arithmetic: the logits, the aux loss, every cache
    leaf, the metrics and every updated leaf are held bit for bit, and
    the mesh calls call no collective (``_Collectives``)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.param import ShardingRules, tree_leaves
    from repro_torch.models.sharding_ctx import distribute, mesh_shape_dict
    from repro_torch.optim.optimizer import OptimizerConfig
    from repro_torch.train import step as train_step
    out = {}
    for arch in MESH_FAMILIES:
        n_layers, prompt = FAMILY_PARITY[arch]
        cfg = get_config(arch)
        cfg = dataclasses.replace(cfg, n_layers=n_layers,
                                  n_enc_layers=2 if cfg.enc_dec else 0)
        model = build_model(cfg)
        params = model.init(SEED, device="cuda")
        sharded = distribute(params, mesh, model.param_specs(
            ShardingRules(), mesh_shape_dict(mesh)))
        extra = {k: torch.from_numpy(v).cuda() for k, v in
                 lm_batch(cfg, batch, prompt + steps).items()}
        toks = extra.pop("tokens")
        runs, calls = [], {}
        t0 = time.perf_counter()
        with torch.no_grad():
            for p, m in ((params, None), (sharded, mesh)):
                with _Collectives() as coll:
                    logits, aux = model.forward(p, dict(extra, tokens=toks),
                                                mesh=m)
                    got = [_local(logits), aux]
                    lg, caches = model.prefill(
                        p, dict(extra, tokens=toks[:, :prompt]),
                        skv=prompt + steps, mesh=m)
                    got.append(_local(lg))
                    for i in range(steps):
                        nxt = {"tokens": toks[:, prompt + i:prompt + i + 1],
                               "pos": torch.full((batch,), prompt + i,
                                                 dtype=torch.int32,
                                                 device="cuda")}
                        lg, caches = model.decode_step(p, caches, nxt, mesh=m)
                        got.append(_local(lg))
                    torch.cuda.synchronize()
                placed = m is None or all(hasattr(c, "placements")
                                          for c in tree_leaves(caches))
                runs.append(got + [_local(c) for c in tree_leaves(caches)])
                calls = coll.calls
        wall = time.perf_counter() - t0
        differ = [i for i, (a, b) in enumerate(zip(*runs))
                  if not torch.equal(a, b)]
        if differ or len(runs[0]) != len(runs[1]) or not placed:
            fail(f"{arch} on the (1,1) mesh differs from the mesh-free "
                 f"calls: outputs {differ} (of {len(runs[0])}; logits, aux, "
                 f"prefill, {steps} decodes, then each cache leaf), caches "
                 f"as DTensors {placed}")
        if calls:
            fail(f"{arch} on the (1,1) mesh called collectives: {calls}")
        out[arch] = {"n_layers": n_layers, "prompt": prompt,
                     "outputs": len(runs[0]), "wall_s": wall,
                     "collectives": calls}
        enc = (f" + {cfg.n_enc_layers} encoder layers at {cfg.n_frames} "
               f"frames" if cfg.enc_dec else "")
        line = (f"mesh parity {arch} full width, {n_layers} layers{enc}, "
                f"batch {batch} x {prompt}: forward, prefill and {steps} "
                f"decode steps on the (1,1) mesh equal the mesh-free calls "
                f"bit for bit ({len(runs[0])} tensors: logits, aux, every "
                f"cache leaf, the caches DTensors) and call collectives "
                f"{calls} (none)")
        del runs, params, sharded
        if arch == MESH_FAMILY_TRAIN:
            data = _tree_to(_train_batch(torch, cfg, batch, prompt), "cuda")
            opt_cfg = OptimizerConfig(**TRAIN_OPT)
            free = train_step.init_state(model, SEED, device="cuda")
            placed_state = train_step.init_state(model, SEED, device="cuda",
                                                 mesh=mesh)
            new_free, m_free = train_step.make_train_step(
                model, opt_cfg, remat="save_attn")(free, data)
            with _Collectives() as coll:
                new_mesh, m_mesh = train_step.make_train_step(
                    model, opt_cfg, mesh=mesh, remat="save_attn")(
                        placed_state, data)
                torch.cuda.synchronize()
            differ = [k for (k, a), (_, b) in zip(_named_leaves(new_free),
                                                  _named_leaves(new_mesh))
                      if not torch.equal(a, _local(b))]
            if differ or any(not torch.equal(m_free[k], m_mesh[k])
                             for k in m_free):
                fail(f"{arch}: the (1,1) mesh step differs from the "
                     f"mesh-free step: {len(differ)} leaves (first "
                     f"{differ[:4]}), loss {float(m_free['loss'])} vs "
                     f"{float(m_mesh['loss'])}")
            if coll.calls:
                fail(f"{arch}: the (1,1) mesh step called collectives: "
                     f"{coll.calls}")
            out[arch].update(loss=float(m_free["loss"]),
                             grad_norm=float(m_free["grad_norm"]),
                             step_collectives=coll.calls)
            line += (f"; one make_train_step(mesh=) step (remat save_attn) "
                     f"equals the mesh-free step bit for bit (loss "
                     f"{float(m_free['loss']):.6f}, grad_norm "
                     f"{float(m_free['grad_norm']):.6f}, "
                     f"{len(tree_leaves(new_free))} leaves) and calls "
                     f"collectives {coll.calls} (none)")
            del free, placed_state, new_free, new_mesh
        log(f"{line}; wall {wall:.3f} s on {card}")
        torch.cuda.empty_cache()
    return out


def mesh_entry(torch, card, scan, mesh, steps=30, more=10):
    """(c) ``launch.train.main --reduced --device cuda`` inside the
    phase's process group: its (1,1) mesh, the state as DTensors, for
    ``steps`` steps, then ``--resume`` to ``steps + more`` through
    ``restore(mesh=, spec_tree=)``; two scan launches a run; each run's
    final checkpoint equal to its live state bit for bit."""
    import contextlib
    import io
    import tempfile
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch import train as launch_train
    from repro_torch.models.param import tree_leaves
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp)
        for name, argv, want_start in (
                ("run", ["--steps", str(steps)], 0),
                ("resume", ["--steps", str(steps + more), "--resume"],
                 steps)):
            before = scan.launches
            printed = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                start, state, hist = launch_train.main(
                    ["--reduced", "--device", "cuda", "--ckpt-dir", tmp]
                    + argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            lines = printed.getvalue().splitlines()
            launches = scan.launches - before
            end = int(argv[1])
            ran = [h["step"] for h in hist if "loss" in h]
            if start != want_start or ran != list(range(want_start, end)):
                fail(f"launch.train on the mesh {name}: started at {start}, "
                     f"ran {ran}")
            if not lines or not lines[0].endswith("mesh=(1,1) devices=1"):
                fail(f"launch.train on the mesh {name} printed {lines[:2]}")
            if name == "resume" and "elastic reshard" not in lines[1]:
                fail(f"launch.train --resume did not restore onto the mesh: "
                     f"{lines[1]}")
            if launches != 2:
                fail(f"launch.train on the mesh {name} launched "
                     f"bitweaving_scan {launches} times, not 2")
            leaves = tree_leaves(state)
            if not all(hasattr(p, "placements")
                       for p in tree_leaves(state["params"])):
                fail(f"launch.train on the mesh {name}: plain parameters")
            saved = ck.restore(end, device="cuda")[1]
            same = [torch.equal(a, _whole(b))
                    for a, b in zip(tree_leaves(saved), leaves)]
            if len(same) != len(leaves) or not all(same):
                fail(f"launch.train on the mesh {name}: the step-{end} "
                     f"checkpoint differs from the live state")
            losses = [h["loss"] for h in hist if "loss" in h]
            if not all(np.isfinite(losses)):
                fail(f"launch.train on the mesh {name}: losses {losses}")
            out[name] = {"start": start, "end": end, "wall_s": wall,
                         "scan_launches": launches,
                         "first_loss": losses[0], "last_loss": losses[-1]}
            log(f"launch.train on the (1,1) mesh {name}: steps {start}->"
                f"{end}, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
                f"{launches} bitweaving_scan launches, state DTensors, "
                f"step-{end} checkpoint == live state (bit for bit); "
                f"{lines[1] if name == 'resume' else lines[0]}; wall "
                f"{wall:.3f} s on {card}")
    return out


def mesh_pieces(torch, card, mesh):
    """(d) ``compressed_psum`` over the one-rank group equals ``q*s/1``
    bit for bit; ``pipeline`` with one stage equals the stage applied to
    each microbatch, with a finite, nonzero gradient; a checkpoint saved
    without a mesh restores onto the (1,1) mesh bit for bit."""
    import tempfile
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.models.param import PartitionSpec as P
    from repro_torch.runtime.pipeline import pipeline
    from repro_torch.train.compression import compressed_psum
    gen = torch.Generator("cuda").manual_seed(SEED)
    q = torch.randint(-127, 128, (4096,), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.rand((), generator=gen, device="cuda") / 127
    got = compressed_psum({"g": q}, {"g": s}, "data", 1, mesh=mesh)["g"]
    if not torch.equal(got, q.to(torch.float32) * s / 1):
        fail("compressed_psum over one rank is not q*s/1")

    w = (torch.randn((1, 256, 256), generator=gen, device="cuda") * 0.05
         ).requires_grad_()
    b = (torch.randn((1, 256), generator=gen, device="cuda") * 0.1
         ).requires_grad_()
    x = torch.randn((6, 4, 256), generator=gen, device="cuda")

    def stage(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    out = pipeline(stage, {"w": w, "b": b}, x, mesh, axis="data")
    want = torch.stack([stage({"w": w[0], "b": b[0]}, x[m])
                        for m in range(x.shape[0])])
    gw, gb = torch.autograd.grad((out ** 2).sum(), [w, b])
    pipe_err = _max_rel(out, want)
    if not (torch.allclose(out, want, atol=1e-5, rtol=1e-5)
            and bool(torch.isfinite(gw).all()) and float(gw.abs().sum()) > 0
            and bool(torch.isfinite(gb).all())):
        fail(f"pipeline with one stage: max-rel {pipe_err:.3e} from the "
             f"sequential application, gradient finite "
             f"{bool(torch.isfinite(gw).all())}, |gw| {float(gw.abs().sum())}")

    tree = {"params": {"w": torch.randn((48, 16), generator=gen,
                                        device="cuda"),
                       "h": torch.randn((8,), generator=gen,
                                        device="cuda").to(torch.bfloat16)},
            "step": torch.tensor(5, dtype=torch.int32, device="cuda")}
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp)
        ck.save(5, tree, blocking=True)
        step, back = ck.restore(mesh=mesh, spec_tree={
            "params": {"w": P("data", "model"), "h": P(None)}})
    placed = all(hasattr(v, "placements") for v in back["params"].values())
    same = (step == 5 and torch.equal(back["step"], tree["step"]) and all(
        torch.equal(_whole(back["params"][k]), tree["params"][k])
        for k in tree["params"]))
    if not (placed and same):
        fail(f"a checkpoint saved without a mesh restored onto the (1,1) "
             f"mesh: placed {placed}, equal {same}")
    log(f"mesh pieces on {card}: compressed_psum over the one-rank NCCL "
        f"group == q*s/1 bit for bit; pipeline with one stage over 6 "
        f"microbatches max-rel {pipe_err:.3e} from the sequential "
        f"application (bound 1e-5), gradient finite and nonzero; a "
        f"checkpoint saved without a mesh restored onto the (1,1) mesh as "
        f"DTensors bit for bit")
    return {"pipeline_max_rel": pipe_err}


def mesh_phase(torch, card, wrappers, unsharded):
    """Phase 11: the multi-device layer on one card, over a one-rank NCCL
    group this phase starts (a ``file://`` store in a temporary
    directory) and a (1,1) mesh on it: (a) parity, (b) the sharded
    trainer at full size beside phase 10(b)'s (``unsharded``), (c)
    ``launch.train`` and its resume, (d) ``compressed_psum``,
    ``pipeline`` and a restore onto the mesh."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh, mesh_shape_dict
    scan = wrappers["bitweaving_scan"]
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            mesh = make_host_mesh(1, 1)
            log(f"mesh {mesh_shape_dict(mesh)} on {mesh.device_type}, "
                f"backend {dist.get_backend()}, world size "
                f"{dist.get_world_size()}")
            report["parity"] = mesh_parity(torch, card, mesh)
            torch.cuda.empty_cache()
            report["families"] = mesh_families(torch, card, mesh)
            full = train_full(torch, card, scan, mesh=mesh, counted=True,
                              **dict(TRAIN_FULL, steps=MESH_STEPS))
            report["full"] = full
            torch.cuda.empty_cache()
            keys = ("step_ms_median", "step_ms_min", "tokens_per_s",
                    "max_memory_allocated", "idle_share")
            report["full_vs_unsharded"] = {
                k: (full[k], unsharded[k]) for k in keys}
            log(f"11(b) against 10(b) on this run: step ms median "
                f"{full['step_ms_median']:.3f} vs "
                f"{unsharded['step_ms_median']:.3f} (min "
                f"{full['step_ms_min']:.3f} vs {unsharded['step_ms_min']:.3f}),"
                f" tokens/s {full['tokens_per_s']:.1f} vs "
                f"{unsharded['tokens_per_s']:.1f}, peak "
                f"{full['max_memory_allocated']} B vs "
                f"{unsharded['max_memory_allocated']} B, idle share "
                f"{full['idle_share']:.3f} vs {unsharded['idle_share']:.3f}, "
                f"profiled step kernels {full['profile'].get('kernels', 0)} "
                f"vs {unsharded['profile'].get('kernels', 0)} on {card}")
            report["entry"] = mesh_entry(torch, card, scan, mesh)
            torch.cuda.empty_cache()
            report["pieces"] = mesh_pieces(torch, card, mesh)
        finally:
            dist.destroy_process_group()
    return report


# -- phase 12 -----------------------------------------------------------------

# 12(a): production cells through the dry-run's CLI (arch, shape, multi-pod)
DRYRUN_CELLS = (("qwen2.5-3b", "train_4k", False),
                ("qwen3-moe-235b-a22b", "decode_32k", False),
                ("mamba2-780m", "long_500k", True),
                ("zamba2-2.7b", "train_4k", False))
# the same cells' figures a rank (FLOPs, collective bytes, peak bytes) as
# the dry-run printed them on an H100 80GB HBM3 at 700.00 W before the
# mesh paths split each cell's layers over "model" (every rank gathered
# those layers' weights whole and computed its rows whole; PERF.md),
# printed beside this run's
DRYRUN_BEFORE = {
    ("qwen2.5-3b", "train_4k", False): (1.7873e15, 7.2030e11, 3207549863960),
    ("qwen3-moe-235b-a22b", "decode_32k", False): (9.8537e11, 1.0957e12,
                                                   162657794112),
    ("mamba2-780m", "long_500k", True): (1.5973e9, 1.5341e9, 666952760),
    ("zamba2-2.7b", "train_4k", False): (1.5385e15, 4.0478e10,
                                         1131691022624)}
# 12(a): the 2-D EP cell, whose experts stay on their ranks
DRYRUN_EP2D = ("qwen3-moe-235b-a22b", "decode_32k", False)
# 12(b): phase 11(b)'s step, traced as one rank of a (1,1) fake mesh
DRYRUN_CARD = """
import json, sys
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
arch, batch, seq = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
with dryrun.fake_process_group(1):
    r = dryrun.analyse_cell(get_config(arch), ShapeConfig(
        "train_card", seq, batch, "train"), make_host_mesh(1, 1))
print(json.dumps(r))
"""
DRYRUN_PEAK_BOUND = 0.05    # 12(b): the traced peak against the card's


def _shard_bytes(defs, specs, ms, dtype=None) -> int:
    """This rank's bytes of every leaf of a ParamDef tree under its spec
    tree: each dimension divided by the mesh axes its spec names."""
    from repro_torch.models.param import tree_leaves
    total = 0
    for d, spec in zip(tree_leaves(defs), tree_leaves(specs)):
        n = 1
        for size in d.shape:
            n *= size
        total += n // _split(spec, ms) * (dtype or d.dtype).itemsize
    return total


def _cell_argument_bytes(torch, arch, shape_name, multi_pod) -> int:
    """A production cell's argument bytes on one rank from its spec trees
    alone, as the reference builds the cell: parameters (bf16 to serve),
    AdamW's moments and its int32 step to train, caches to decode (the
    experts padded to data*model for 2-D expert parallelism), and the
    batch."""
    import dataclasses
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import PRODUCTION_MESHES
    from repro_torch.models import build_model
    cfg, shape = get_config(arch), SHAPES[shape_name]
    ms = dict(zip(*reversed(PRODUCTION_MESHES[multi_pod])))
    ep2d = shape.kind == "decode" and cfg.moe is not None and \
        cfg.moe.n_experts >= 64
    if ep2d:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, pad_to=ms["data"] * ms["model"]))
    model = build_model(cfg)
    rules = dryrun.sharding_rules_for(shape_name, shape.global_batch, ms,
                                      ep2d=ep2d)
    defs, specs = model.param_defs(), model.param_specs(rules, ms)
    batch = dryrun.input_specs(arch, shape_name)
    total = sum(v.numel() * v.element_size() // _split(spec, ms)
                for v, spec in ((batch[k], s) for k, s in dryrun.batch_spec(
                    batch, rules, ms).items()))
    if shape.kind == "train":
        return total + 3 * _shard_bytes(defs, specs, ms) + 4
    total += _shard_bytes(defs, specs, ms, torch.bfloat16)
    if shape.kind == "decode":
        b, s = shape.global_batch, shape.seq_len
        total += _shard_bytes(model.cache_defs(b, s),
                              model.cache_specs(b, s, rules, ms), ms)
    return total


def _expert_stack_bytes(arch, multi_pod) -> int:
    """One layer's bf16 ``w1``, ``w3`` and ``w2`` with the experts padded
    to data x model, as the 2-D EP cell pads them: ``3 * e_pad * d_model
    * d_ff_expert * 2`` bytes, from the config."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import PRODUCTION_MESHES
    from repro_torch.models.moe import padded_experts
    cfg = get_config(arch)
    ms = dict(zip(*reversed(PRODUCTION_MESHES[multi_pod])))
    e_pad = padded_experts(dataclasses.replace(
        cfg.moe, pad_to=ms["data"] * ms["model"]))
    return 3 * e_pad * cfg.d_model * cfg.moe.d_ff_expert * 2


def _split(spec, ms) -> int:
    """The number of shards a spec cuts a tensor into on mesh ``ms``."""
    n = 1
    for part in spec:
        for axis in (() if part is None else (part,) if isinstance(part, str)
                     else part):
            n *= ms[axis]
    return n


def _finite_figures(r) -> list:
    """Every FLOP, byte and collective-byte figure of a dry-run result."""
    figs = [r[k] for k in ("hlo_flops", "hlo_bytes", "flops_per_chip",
                           "bytes_per_chip", "collective_bytes",
                           "model_flops")]
    figs += list(r["collective_kinds"].values())
    figs += list(r["memory_analysis"].values()) + list(r["roofline"].values())
    return figs


def dryrun_phase(torch, card, meshed):
    """Phase 12: the dry-run on the card machine, each run in a process
    of its own (its fake process group cannot share this process with a
    real one), all started together: (a) the ``DRYRUN_CELLS`` through
    ``python -m repro_torch.launch.dryrun`` at its default device (the
    card): each prints its OK line, every figure is finite, the FLOPs,
    traffic and collective bytes are positive (a 256- or 512-rank mesh
    gathers its weights), and the argument bytes equal the spec trees'
    shard bytes exactly; (b) ``analyse_cell`` on phase 11(b)'s step (the
    configured qwen2.5-3b, batch x seq as ``TRAIN_FULL``, ``remat=
    "save_attn"``, a (1,1) mesh over a one-rank fake group) held against
    what 11(b)'s extra step measured in this run: FLOPs equal, the peak
    above the live bytes within ``DRYRUN_PEAK_BOUND``; its kernel-launching
    op count beside the profiled step's kernels and its roofline bound
    beside the step's device ms, printed."""
    import tempfile
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(here, "src"))
    total = torch.cuda.get_device_properties(0).total_memory
    report = {}
    with tempfile.TemporaryDirectory() as out:
        procs = {}
        for arch, shape_name, multi in DRYRUN_CELLS:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape_name, "--out", out]
            procs[(arch, shape_name, multi)] = subprocess.Popen(
                cmd + (["--multi-pod"] if multi else []), env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        full = TRAIN_FULL
        procs["card"] = subprocess.Popen(
            [sys.executable, "-c", DRYRUN_CARD, full["arch"],
             str(full["batch"]), str(full["seq"])], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        done = {}
        try:
            for key, proc in procs.items():
                stdout, stderr = proc.communicate(timeout=600)
                if proc.returncode != 0:
                    fail(f"dry-run {key} exited {proc.returncode}: "
                         f"{stdout[-1500:]} {stderr[-3000:]}")
                done[key] = stdout
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for arch, shape_name, multi in DRYRUN_CELLS:
            stdout = done[(arch, shape_name, multi)]
            if not stdout.startswith(f"OK  {arch}"):
                fail(f"dry-run {arch} {shape_name}: no OK line: "
                     f"{stdout[-1500:]}")
            mesh = "multi_pod_2x16x16" if multi else "single_pod_16x16"
            with open(os.path.join(out, f"{arch}__{shape_name}__{mesh}"
                                        f".json")) as fh:
                r = json.load(fh)
            figs = _finite_figures(r)
            if not all(np.isfinite(figs)):
                fail(f"dry-run {arch} {shape_name}: a figure is not "
                     f"finite: {r}")
            moved = [r[k] for k in ("flops_per_chip", "bytes_per_chip",
                                    "collective_bytes")]
            if not all(v > 0 for v in moved):
                fail(f"dry-run {arch} {shape_name} on {mesh}: flops, bytes "
                     f"and collective bytes a rank {moved} must be positive")
            want = _cell_argument_bytes(torch, arch, shape_name, multi)
            got = r["memory_analysis"]["argument_size_bytes"]
            if got != want:
                fail(f"dry-run {arch} {shape_name}: argument bytes {got} "
                     f"!= {want} from the spec trees")
            peak = r["memory_analysis"]["peak_bytes"]
            report[f"{arch}|{shape_name}|{mesh}"] = {
                k: r[k] for k in ("trace_s", "flops_per_chip",
                                  "bytes_per_chip", "collective_bytes",
                                  "collective_kinds", "collective_counts",
                                  "kernel_ops", "memory_analysis",
                                  "roofline", "dominant",
                                  "roofline_fraction",
                                  "useful_flops_ratio")}
            log(f"12(a) {arch} {shape_name} on {mesh} ({r['n_chips']} fake "
                f"ranks, fake tensors on {r['device']}): trace "
                f"{r['trace_s']:.1f} s; a rank: {r['flops_per_chip']:.4e} "
                f"FLOPs, {r['bytes_per_chip']:.4e} B eager traffic, "
                f"{r['collective_bytes']:.4e} B collectives "
                f"{r['collective_counts']}; terms compute "
                f"{r['roofline']['compute_s']:.4e} s, memory "
                f"{r['roofline']['memory_s']:.4e} s, collective "
                f"{r['roofline']['collective_s']:.4e} s, dominant "
                f"{r['dominant']}, roofline fraction "
                f"{r['roofline_fraction']:.4e}; argument bytes {got} = the "
                f"spec trees' shards; peak {peak} B = "
                f"{peak / total:.3f} of the card's {total} B "
                f"({'fits' if peak <= total else 'does not fit'}) on {card}")
            flops0, coll0, peak0 = DRYRUN_BEFORE[(arch, shape_name, multi)]
            log(f"12(a) {arch} {shape_name} on {mesh} against the gather "
                f"design (DRYRUN_BEFORE): FLOPs a rank {r['flops_per_chip']:.4e} vs "
                f"{flops0:.4e} ({r['flops_per_chip'] / flops0:.4f}x), "
                f"collective bytes {r['collective_bytes']:.4e} vs "
                f"{coll0:.4e} ({r['collective_bytes'] / coll0:.4f}x), peak "
                f"{peak} B vs {peak0} B ({peak / peak0:.4f}x), useful "
                f"FLOPs ratio {r['useful_flops_ratio']:.4f}")
            if (arch, shape_name, multi) == DRYRUN_EP2D:
                stack = _expert_stack_bytes(arch, multi)
                log(f"12(a) {arch} {shape_name} on {mesh}: collective bytes "
                    f"a rank {r['collective_bytes']:.4e} "
                    f"{r['collective_kinds']} against one layer's expert "
                    f"stack {stack:.4e} B "
                    f"({r['collective_bytes'] / stack:.4f}x; "
                    f"DRYRUN_BEFORE {coll0:.4e} B), dominant "
                    f"{r['dominant']}")
                if r["collective_bytes"] >= stack:
                    fail(f"dry-run {arch} {shape_name}: "
                         f"{r['collective_bytes']} B of collectives a rank "
                         f"reach one layer's expert stack ({stack} B): the "
                         f"experts moved")
    card_run = json.loads(done["card"].strip().splitlines()[-1])
    counted = meshed["full"]["counted"]
    prof = meshed["full"]["profile"]
    traced = card_run["memory_analysis"]
    traced_peak = traced["peak_bytes"] - traced["argument_size_bytes"]
    gap = counted["peak_above"] - traced_peak
    bound_ms = max(card_run["roofline"].values()) * 1e3
    report["card"] = {
        "flops": card_run["flops_per_chip"], "real_flops": counted["flops"],
        "traced_peak_above_args": traced_peak,
        "real_peak_above_live": counted["peak_above"], "gap_bytes": gap,
        "argument_size_bytes": traced["argument_size_bytes"],
        "real_live_before": counted["live_before"],
        "kernel_ops": card_run["kernel_ops"],
        "profiled_kernels": prof.get("kernels", 0),
        "roofline": card_run["roofline"], "bound_ms": bound_ms,
        "device_ms": prof.get("device_ms", 0.0),
        "step_ms_median": meshed["full"]["step_ms_median"],
        "trace_s": card_run["trace_s"]}
    log(f"12(b) {full['arch']} batch {full['batch']} x seq {full['seq']} "
        f"on a (1,1) fake mesh against 11(b)'s extra step on {card}: "
        f"FLOPs {card_run['flops_per_chip']:.0f} traced vs "
        f"{counted['flops']} counted; peak above the arguments "
        f"{traced_peak} B traced vs {counted['peak_above']} B above the "
        f"live {counted['live_before']} B on the card (gap {gap} B, "
        f"{gap / counted['peak_above']:+.4f}); traced arguments "
        f"{traced['argument_size_bytes']} B; kernel-launching ops "
        f"{card_run['kernel_ops']} traced vs {prof.get('kernels', 0)} CUDA "
        f"kernels profiled; roofline bound {bound_ms:.3f} ms "
        f"({card_run['dominant']}) vs {prof.get('device_ms', 0.0):.3f} "
        f"device ms profiled, {meshed['full']['step_ms_median']:.3f} ms "
        f"median step; trace {card_run['trace_s']:.1f} s")
    if card_run["flops_per_chip"] != counted["flops"]:
        fail(f"12(b): traced FLOPs {card_run['flops_per_chip']} != the "
             f"card step's {counted['flops']}")
    if abs(gap) > DRYRUN_PEAK_BOUND * counted["peak_above"]:
        fail(f"12(b): the card step's peak above its live bytes "
             f"{counted['peak_above']} B is {gap} B from the traced "
             f"{traced_peak} B, past {DRYRUN_PEAK_BOUND:.0%}")
    return report


# -- phase 13 -----------------------------------------------------------------

ENTRY_TRAIN_STEPS = (60, 10)     # 13(b): train_lm --preset 100m, then resumed
ENTRY_WHISPER = dict(requests=4, max_new=16, max_seq=256)    # 13(c)
SHORT_PROMPTS = (1, 2)           # 13(d): prompt lengths, at FAMILY_PARITY's
SHORT_PROMPT_ARCHS = ("mamba2-780m", "zamba2-2.7b")    # depths


def _printed(fn, argv):
    """``fn(argv)``'s result and the lines it printed."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(argv)
    return result, buf.getvalue().splitlines()


def _launched(wrappers, before):
    return {n: fn.launches - before[n] for n, fn in wrappers.items()}


def examples_on_card(torch, card, wrappers):
    """(a) ``repro_torch.examples.quickstart`` and ``bitmap_analytics`` on
    the card, then on the CPU: every printed line (counts, AAPs, bytes,
    ns, nJ) and every returned figure equal; quickstart's ``cuda`` XOR is
    one ``fused_bitwise`` launch, bitmap_analytics' resident ``cuda``
    query two fused launches (the planner's count, as printed) and its
    ``cuda`` engine and resident runtime launch the fused kernels and
    ``popcount_rows``."""
    from repro_torch.examples import bitmap_analytics, quickstart
    out, figs = {}, {}
    for name, mod in (("quickstart", quickstart),
                      ("bitmap_analytics", bitmap_analytics)):
        before = _launch_counts(wrappers)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card_fig, card_lines = _printed(mod.main, ["--device", "cuda"])
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launched = _launched(wrappers, before)
        t0 = time.perf_counter()
        cpu_fig, cpu_lines = _printed(mod.main, ["--device", "cpu"])
        cpu_s = time.perf_counter() - t0
        if card_lines != cpu_lines or card_fig != cpu_fig:
            diff = [(a, b) for a, b in zip(card_lines, cpu_lines) if a != b]
            fail(f"examples.{name}: the card's lines differ from the CPU's "
                 f"{diff or (card_fig, cpu_fig)}")
        figs[name] = card_fig
        out[name] = {"card_s": card_s, "cpu_s": cpu_s, "launches": launched,
                     "lines": len(card_lines)}
        log(f"examples.{name} on the card: {len(card_lines)} lines, every "
            f"one and every figure equal to the CPU run's; launches "
            f"{launched}; wall {card_s:.3f} s on {card} (CPU "
            f"{cpu_s:.3f} s)")
    got = out["quickstart"]["launches"]
    if got["fused_bitwise"] != 1 or any(
            v for k, v in got.items() if k != "fused_bitwise"):
        fail(f"examples.quickstart launched {got}, not one fused_bitwise")
    planner = figs["bitmap_analytics"]["device_ledger"][3]
    got = out["bitmap_analytics"]["launches"]
    if planner != 2 or not (got["fused_bitwise"] and
                            got["fused_bitwise_stacked"] and
                            got["popcount_rows"]):
        fail(f"examples.bitmap_analytics: the resident query made "
             f"{planner} fused launches (not 2); launches {got}")
    out["bitmap_analytics"]["resident_fused_launches"] = planner
    return out


def train_lm_on_card(torch, card, scan, steps=ENTRY_TRAIN_STEPS[0],
                     more=ENTRY_TRAIN_STEPS[1]):
    """(b) ``repro_torch.examples.train_lm --preset 100m`` for ``steps``
    steps into a temporary checkpoint directory, then ``--resume`` to
    ``steps + more``: the data line equal to the CPU filter's count, two
    ``bitweaving_scan`` launches a run (the filter), the first run's loss
    falling (its last 5 steps' mean below its first 5's), the resumed run
    starting at ``steps`` from the checkpoint the first run saved last,
    which equals its live state bit for bit (as does the resumed run's)."""
    import tempfile
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data.pipeline import DataConfig, FilteredSyntheticLM
    from repro_torch.examples import train_lm
    from repro_torch.models.param import tree_leaves
    cpu_docs = int(FilteredSyntheticLM(DataConfig(10, 4, 2), n_docs=4096,
                                       device="cpu").mask.sum())
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp)
        for name, argv, want_start in (
                ("run", ["--steps", str(steps)], 0),
                ("resume", ["--steps", str(steps + more), "--resume"],
                 steps)):
            before = scan.launches
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fig, lines = _printed(train_lm.main, [
                "--preset", "100m", "--device", "cuda", "--ckpt-dir",
                tmp] + argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            launches = scan.launches - before
            end = int(argv[1])
            ran = [h["step"] for h in fig["history"] if "loss" in h]
            if fig["start"] != want_start or ran != list(range(want_start,
                                                               end)):
                fail(f"train_lm {name}: started at {fig['start']}, ran {ran}")
            want_data = (f"data: {cpu_docs}/4096 docs pass the BitWeaving "
                         "quality filter")
            if lines[1] != want_data or launches != 2:
                fail(f"train_lm {name}: {lines[1]!r} (the CPU filter: "
                     f"{cpu_docs}), {launches} bitweaving_scan launches, "
                     "not 2")
            if name == "resume" and lines[2] != f"resumed from step {steps}":
                fail(f"train_lm resume: {lines[2]!r}")
            saved = ck.restore(end, device="cuda")[1]
            live = tree_leaves(fig["state"])
            same = [a.dtype == b.dtype and torch.equal(a, b)
                    for a, b in zip(tree_leaves(saved), live)]
            if len(same) != len(live) or not all(same):
                fail(f"train_lm {name}: the step-{end} checkpoint differs "
                     f"from the live state in {same.count(False)} leaves")
            losses = fig["losses"]
            if not all(np.isfinite(losses)):
                fail(f"train_lm {name}: non-finite losses {losses}")
            first5, last5 = (float(np.mean(losses[:5])),
                             float(np.mean(losses[-5:])))
            if name == "run" and not last5 < first5:
                fail(f"train_lm: the mean loss of the last 5 steps is not "
                     f"below the first 5's: {losses}")
            step_ms = [h["dt"] * 1e3 for h in fig["history"] if "loss" in h]
            norms = [h["grad_norm"] for h in fig["history"] if "loss" in h]
            out[name] = {"start": fig["start"], "end": end, "wall_s": wall,
                         "loss_every_10": losses[::10],
                         "grad_norm_first_last": (norms[0], norms[-1]),
                         "scan_launches": launches, "first_loss": losses[0],
                         "last_loss": losses[-1], "first5_mean": first5,
                         "last5_mean": last5,
                         "step_ms_median": statistics.median(step_ms),
                         "tokens_per_s": fig["tokens_per_s"],
                         "max_memory_allocated": peak,
                         "checkpoints": ck.steps()}
            log(f"examples.train_lm --preset 100m ({lines[0]}) {name}: steps "
                f"{fig['start']}->{end}, loss {losses[0]:.4f} -> "
                f"{losses[-1]:.4f} (mean of the first 5 {first5:.4f}, of the "
                f"last 5 {last5:.4f}" + (", held" if name == "run" else "")
                + f"; every 10th {[round(v, 4) for v in losses[::10]]}, "
                f"grad_norm {norms[0]:.4g} -> {norms[-1]:.4g}), {launches} "
                "bitweaving_scan launches, step ms median "
                f"{out[name]['step_ms_median']:.3f}, "
                f"{fig['tokens_per_s']:.1f} tokens/s, max memory allocated "
                f"{peak} B, checkpoints {ck.steps()}, step-{end} checkpoint "
                f"== live state (bit for bit), wall {wall:.3f} s on {card} "
                "(measured on the card)")
            del fig, saved, live
            torch.cuda.empty_cache()
    return out


def serve_by_hand(torch, model, params, reqs, max_seq, dev, timed=None):
    """The greedy tokens of ``reqs`` (one batch) from ``Model.prefill``
    and ``decode_step`` driven by hand as ``ServeEngine`` drives them:
    prompts left-padded, frames stacked along the slot axis."""
    call = timed or model
    plen = max(len(r.prompt) for r in reqs)
    toks = np.zeros((len(reqs), plen), np.int32)
    for i, r in enumerate(reqs):
        toks[i, plen - len(r.prompt):] = r.prompt
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    if model.cfg.enc_dec:
        batch["frames"] = torch.from_numpy(
            np.stack([r.frames for r in reqs])).to(dev)
    logits, caches = call.prefill(params, batch, skv=max_seq)
    tok = logits.argmax(-1).to(torch.int32)
    pos = torch.full((len(reqs),), plen, dtype=torch.int32, device=dev)
    out = [tok]
    for _ in range(max(r.max_new_tokens for r in reqs) - 1):
        logits, caches = call.decode_step(
            params, caches, {"tokens": tok[:, None], "pos": pos})
        tok = logits.argmax(-1).to(torch.int32)
        pos = pos + 1
        out.append(tok)
    return torch.stack(out, 1).cpu().tolist()


def whisper_entry(torch, card, requests=ENTRY_WHISPER["requests"],
                  max_new=ENTRY_WHISPER["max_new"],
                  max_seq=ENTRY_WHISPER["max_seq"]):
    """(c) ``launch.serve --arch whisper-small --no-reduced --device cuda``
    (greedy, ``requests`` requests in one batch): its tokens equal those
    of ``Model.prefill`` and ``decode_step`` driven by hand on the same
    weights (seed 0) and frames; the serve's wall time and peak memory,
    the hand-driven decode ms a step."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import build_model
    argv = ["--arch", "whisper-small", "--no-reduced", "--device", "cuda",
            "--requests", str(requests), "--slots", str(requests),
            "--max-new", str(max_new), "--max-seq", str(max_seq),
            "--temperature", "0"]
    cfg = launch_serve.config_of(launch_serve.parse_args(argv))
    if cfg != get_config("whisper-small"):
        fail(f"launch.serve --no-reduced chose {cfg}")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs, lines = _printed(launch_serve.main, argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    timed = _TimedModel(torch, model)
    hand = serve_by_hand(torch, model, params,
                         launch_serve.make_requests(cfg, requests, max_new),
                         max_seq, "cuda", timed)
    served = [r.out for r in reqs]
    if served != hand:
        fail(f"launch.serve whisper-small: tokens {served} != by hand {hand}")
    tokens = sum(len(o) for o in served)
    out = {"wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
           "max_memory_allocated": peak, "params": model.n_params(),
           "prefill_ms": timed.ms["prefill"],
           "decode_ms_median": statistics.median(timed.ms["decode"]),
           "decode_ms_min": min(timed.ms["decode"]), "last_line": lines[-1]}
    log(f"launch.serve --arch whisper-small --no-reduced: {cfg.n_layers}+"
        f"{cfg.n_enc_layers} layers ({model.n_params()} float32 params), "
        f"{requests} requests x {cfg.n_frames} frames, greedy: {tokens} "
        f"tokens == Model.prefill/decode_step by hand; serve wall "
        f"{wall:.3f} s = {tokens / wall:.1f} tokens/s (weights drawn "
        f"included), max memory allocated {peak} B; by hand prefill ms "
        f"{[round(m, 3) for m in timed.ms['prefill']]}, decode ms a step "
        f"median {out['decode_ms_median']:.3f} (min "
        f"{out['decode_ms_min']:.3f}) on {card} (measured on the card); "
        f"its line: {lines[-1]}")
    return out


class _Logged:
    """The model as ``ServeEngine`` calls it, each call's logits kept."""

    def __init__(self, model):
        self.model, self.cfg, self.logits = model, model.cfg, []

    def prefill(self, params, batch, skv=None):
        logits, caches = self.model.prefill(params, batch, skv=skv)
        self.logits.append(logits)
        return logits, caches

    def decode_step(self, params, caches, batch):
        logits, caches = self.model.decode_step(params, caches, batch)
        self.logits.append(logits)
        return logits, caches


def short_prompt_serve(torch, model, params, plen, dev, hard=False,
                       slots=2, max_new=4, max_seq=16):
    """(d) ``slots`` greedy requests of ``plen`` tokens (drawn from
    ``SEED``) behind ``ServeEngine``: the prefill's and each decode
    step's logits against the forward over the prompt and the tokens
    generated so far (max-rel, ``decode_vs_forward``). ``hard``: the
    same tokens through ``_lm_run`` with the prefill and decode cores fed
    the forward's rows (``_FromForward``, as phase 9 holds
    ``HARD_ATTENTION``), under ``held``; else ``held`` is the engine's."""
    from repro_torch.serve import Request, ServeEngine
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, model.cfg.vocab, (slots, plen)).astype(
        np.int32)
    logged = _Logged(model)
    eng = ServeEngine(logged, params, max_seq=max_seq, batch_slots=slots)
    reqs = [Request(prompt=p, max_new_tokens=max_new) for p in prompts]
    eng.generate(reqs)
    if eng.decode_steps != max_new - 1 or \
            any(len(r.out) != max_new for r in reqs):
        fail(f"{model.cfg.name} prompts of {plen}: {eng.decode_steps} "
             f"decode steps, outputs {[r.out for r in reqs]}")
    seq = np.concatenate([prompts, np.array([r.out[:-1] for r in reqs],
                                            np.int32)], 1)
    inputs = {"tokens": torch.from_numpy(seq)}
    fwd = model.forward(params, {"tokens": inputs["tokens"].to(dev)})[0]
    out = {"decode_vs_forward": _vs_forward(logged.logits, fwd, plen)}
    out["held"] = out["decode_vs_forward"]
    if hard:
        from_fwd = _FromForward(seq.shape[1])
        ff_fwd, ff_outs, _ = _lm_run(torch, model, params, inputs, plen,
                                     max_new - 1, dev, from_fwd)
        out["forced"] = out["held"] = _vs_forward(ff_outs, ff_fwd, plen)
        out["forced_inputs_worst"] = max(from_fwd.arg_rels)
    return out


def short_prompts(torch, card, arch):
    """(d) ``arch`` at full width, depth cut as phase 9 cuts it, served
    prompts of ``SHORT_PROMPTS`` tokens: each step within
    ``LM_SELF_BOUND`` of the forward (``HARD_ATTENTION``: with the cores
    fed the forward's rows, the core inputs within ``LM_BOUND`` of the
    forward's; unforced printed)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    n_layers = FAMILY_PARITY[arch][0]
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    model = build_model(cfg)
    params = model.init(SEED, device="cuda")
    hard = arch in HARD_ATTENTION
    out = {}
    for plen in SHORT_PROMPTS:
        t0 = time.perf_counter()
        got = short_prompt_serve(torch, model, params, plen, "cuda", hard)
        wall = time.perf_counter() - t0
        if max(got["held"]) >= LM_SELF_BOUND or \
                got.get("forced_inputs_worst", 0.0) > LM_BOUND:
            fail(f"{arch} prompts of {plen}: decode vs forward {got} "
                 f"(bounds {LM_SELF_BOUND}, core inputs {LM_BOUND})")
        out[plen] = dict(got, wall_s=wall)
        how = (f"with the cores fed the forward's rows {got['forced']} < "
               f"{LM_SELF_BOUND} (core inputs worst "
               f"{got['forced_inputs_worst']} <= {LM_BOUND}), unforced "
               f"{got['decode_vs_forward']} (reported)" if hard else
               f"{got['decode_vs_forward']} < {LM_SELF_BOUND}")
        log(f"short prompts {arch} full width, {n_layers} layers, 2 "
            f"requests of {plen} tokens behind ServeEngine, 3 decode steps: "
            f"prefill and decodes vs the forward {how}; wall {wall:.3f} s "
            f"on {card}")
    return out


def entry_points_phase(torch, card, wrappers):
    """Phase 13: (a) the examples on the card and the CPU, (b) train_lm at
    its 100m preset and its resume, (c) whisper-small through
    ``launch.serve --no-reduced``, (d) one- and two-token prompts served
    on mamba2 and zamba2."""
    report = {"examples": examples_on_card(torch, card, wrappers)}
    torch.cuda.empty_cache()
    report["train_lm"] = train_lm_on_card(torch, card,
                                          wrappers["bitweaving_scan"])
    torch.cuda.empty_cache()
    report["whisper"] = whisper_entry(torch, card)
    torch.cuda.empty_cache()
    for arch in SHORT_PROMPT_ARCHS:
        report[f"short {arch}"] = short_prompts(torch, card, arch)
        torch.cuda.empty_cache()
    return report


def fused_main(torch, src) -> int:
    """``--fused``: build the fused kernel, check it against its plain
    version and time it (phase 2's fused part)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    log(f"{card}; repro_torch from {src}")
    from repro_torch.kernels import build
    for line in ptxas_lines(ptxas_summary(
            build.build_all(("bitwise",)).get("bitwise", ""))):
        log(f"  ptxas[bitwise] {line}")
    stats: dict = {}
    check_fused(torch, np.random.default_rng(SEED), fused_exprs(), stats)
    log(f"fused kernels vs plain on the card, all exact: "
        f"{json.dumps(stats)}")
    timer = Timer(torch)
    times, _ = time_fused(torch, np.random.default_rng(SEED + 1), timer,
                          row_timer(timer))
    print(json.dumps({"fused": times, "checks": stats, "src": src,
                      "card": card}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    args = sys.argv[1:]
    src = os.path.abspath(args[args.index("--src") + 1]) \
        if "--src" in args else os.path.join(here, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"no repro_torch in {src}: run from a checkout")
    sys.path.insert(0, src)
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if "--fused" in args:
        return fused_main(torch, src)
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
    torch.cuda.empty_cache()

    log("== phase 7: the PIM runtime on the card (backend 'ambit_sim')")
    t_phase = time.perf_counter()
    pim = pim_runtime_phase(torch, card, wrappers)
    log(f"pim_runtime phase_s={time.perf_counter() - t_phase:.1f} "
        f"report={json.dumps(pim)} card: {card}")
    torch.cuda.empty_cache()

    log("== phase 8: the LM path on the card (document filter, "
        "qwen2.5-3b)")
    t_phase = time.perf_counter()
    lm, launches["lm"] = _path_launches(
        wrappers, "lm", lambda: lm_phase(torch, card, wrappers))
    log(f"lm phase_s={time.perf_counter() - t_phase:.1f} "
        f"report={json.dumps(lm)} card: {card}")
    torch.cuda.empty_cache()

    log("== phase 9: the LM stack's other families on the card (MoE, "
        "Mamba2, Zamba2, Whisper, gemma3, qwen2-vl, internlm2, deepseek)")
    t_phase = time.perf_counter()
    families, launches["lm_families"] = _path_launches(
        wrappers, "lm_families", lambda: families_phase(torch, card,
                                                        wrappers))
    log(f"lm_families phase_s={time.perf_counter() - t_phase:.1f} "
        f"report={json.dumps(families)} card: {card}")
    torch.cuda.empty_cache()

    log("== phase 10: training on the card (train step, qwen2.5-3b "
        "trainer, launch.train)")
    t_phase = time.perf_counter()
    training, launches["train"] = _path_launches(
        wrappers, "train", lambda: train_phase(torch, card, wrappers))
    log(f"train phase_s={time.perf_counter() - t_phase:.1f} "
        f"report={json.dumps(training)} card: {card}")
    torch.cuda.empty_cache()

    log("== phase 11: the multi-device layer on the card ((1,1) mesh over "
        "a one-rank NCCL group)")
    t_phase = time.perf_counter()
    meshed, launches["mesh"] = _path_launches(
        wrappers, "mesh", lambda: mesh_phase(torch, card, wrappers,
                                             training["full"]))
    log(f"mesh phase_s={time.perf_counter() - t_phase:.1f} "
        f"report={json.dumps(meshed)} card: {card}")

    torch.cuda.empty_cache()

    log("== phase 12: the dry-run on the card machine (fake process "
        "groups, fake tensors on the card)")
    t_phase = time.perf_counter()
    dry = dryrun_phase(torch, card, meshed)
    log(f"dryrun phase_s={time.perf_counter() - t_phase:.1f} "
        f"report={json.dumps(dry)} card: {card}")
    torch.cuda.empty_cache()

    log("== phase 13: the entry points on the card (examples, launch.serve "
        "--no-reduced whisper-small, one- and two-token SSM prompts)")
    t_phase = time.perf_counter()
    entry, launches["entry_points"] = _path_launches(
        wrappers, "entry_points", lambda: entry_points_phase(torch, card,
                                                             wrappers))
    log(f"entry_points phase_s={time.perf_counter() - t_phase:.1f} "
        f"report={json.dumps(entry)} card: {card}")

    kernels = []
    for name, _, source, replaces in KERNELS:
        t = times[name]
        by_path = {path: launches[path][name] for path in PATH_OF[name]}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "path": "+".join(PATH_OF[name]),
            "launches": sum(by_path.values()), "launches_by_path": by_path,
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
