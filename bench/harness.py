"""Drive one cell of the benchmark through the port's serving stack.

A cell is a deployment (``configs/<config>.json``, built by
``deploy/<kind>.py``) under a traffic mix (``traffic/<mix>.json``). The
timed path is the port's own:

    QueryFrontend (serve/frontend.py: admission, batching window)
      -> AmbitRuntime(backend="cuda") (pim/runtime.py)
      -> AsyncScheduler epochs (pim/scheduler.py)
      -> DeviceStore / DevicePlanner (pim/device_store.py)
      -> fused_bitwise, fused_bitwise_stacked, popcount_rows (kernels/)

and each answer is a count read through ``AmbitRuntime.popcount``, after
which the result is freed. Set-up draws the data on the device from the
seed and warms every query the mix can draw. The window then runs for
``seconds``; afterwards the program's state is freed, the plain
reference (``reference/<kind>.py``) draws the data again and counts
every answered query, and ``correct`` holds when every answer is exact
and none is missing.

The run is one process of one busy thread (``run.py`` sets one intra-op
thread): the host's cores are shared. Objects made in set-up are frozen
out of the collector (``gc.freeze``) before the window opens, as a
long-running service would; the window's own garbage is collected as
usual.

Metrics are read by ``metrics/<name>.py`` (``read(run) -> value or
None``), for the metrics ``BENCHMARK.json`` gives the cell; a metric
whose name adds a suffix to another's (``<name>.open``) and has no file
of its own is read by the shorter name's reader. A traced run
(``--trace 1``) reads the per-layer metrics over a window of at most
``TRACE_SECONDS``, under ``torch.profiler``, with the program's own host
spans on (``repro_torch.obs.Tracer.host_span``): each layer's host time
is read from inside the program, and the card's idle time is split by
the span open at each idle instant (``idlesplit``). An untraced run
records no host span.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from collections import deque
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import devtrace, idlesplit, stats, traffic

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level modules no run may load (compared whole: repro_torch is fine)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks", "tools")
LATE_WAIT_S = 60.0      # how long past the window a due answer is awaited
ANSWER_BYTES = 4        # one count crosses back a query
APP_PLAN = "app.plan"   # the one call of the loop the program has no span for
ANSWER = "runtime.popcount"     # the program's span of one answer's count
# a traced run's window: long enough for every per-layer ratio, short
# enough that reading the trace stays well inside the run's time limit
TRACE_SECONDS = 10.0
# the program's counters the per-layer metrics read, as window deltas
COUNTERS = ("serve_batched_queries", "serve_drains", "fused_queries",
            "fused_dispatches")


def now_ns() -> int:
    return time.perf_counter_ns()


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# -- the cell ------------------------------------------------------------------


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: traffic.Mix
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path = ROOT


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, its config, mix
    and the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(cells: {', '.join(cells)})")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / conf["file"]).read_text())
    mix = traffic.Mix.read(root / "bench" / "traffic"
                           / f"{cell['traffic']}.json")
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (workload in m["workloads"] if "workloads" in m
               else m["moves"] in reported)]
    return Cell(workload, config, mix, int(cell["chips"]), e2e, per, root)


def mix_cell(config: str, mix: str, root: Path = ROOT) -> Cell:
    """A cell of no workload: ``configs/<config>.json`` under
    ``traffic/<mix>.json``, reporting nothing (for a sweep, or a
    rehearsal, of a deployment and mix that no cell offers yet)."""
    bench = root / "bench"
    return Cell(f"{config}.{mix}",
                json.loads((bench / "configs" / f"{config}.json")
                           .read_text()),
                traffic.Mix.read(bench / "traffic" / f"{mix}.json"), 1, [],
                [], root)


def reader_path(name: str, root: Path = ROOT) -> Path:
    """``bench/metrics/<name>.py``, or the file of the longest prefix of
    ``name`` ending before a dot that has one."""
    parts = name.split(".")
    for k in range(len(parts), 0, -1):
        path = root / "bench" / "metrics" / (".".join(parts[:k]) + ".py")
        if path.exists():
            return path
    raise FileNotFoundError(f"no reader for metric {name!r} in "
                            f"{root / 'bench' / 'metrics'}")


def reader(name: str, root: Path = ROOT) -> Callable:
    """``read`` of the metric's file (``reader_path``)."""
    path = reader_path(name, root)
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# -- the system under test -----------------------------------------------------


def _wall_clock_cost(erep, tickets) -> float:
    """Epoch cost when the frontend runs on the wall clock: the clock
    already holds each drain's real time, so no modelled time is added."""
    return 0.0


class System:
    """The port: one ``AmbitRuntime(backend="cuda")`` holding the
    deployment's data, and frontends over it at the config's settings.
    The runtime's ``tracer`` records no simulated span; its host spans
    are off until a traced run turns them on for the window."""

    def __init__(self, cfg: dict, seed: int, device):
        from repro_torch.obs import Tracer
        from repro_torch.pim import AmbitRuntime

        self.cfg = cfg
        self.tracer = Tracer(enabled=False)
        self.rt = AmbitRuntime(backend="cuda", device=device,
                               tracer=self.tracer)
        kind = importlib.import_module(f"bench.deploy.{cfg['kind']}")
        self.deploy = kind.Deployment(cfg, seed, self.rt)

    def frontend(self, wall_clock: bool):
        """A ``QueryFrontend`` at the config's settings. On the wall clock
        the loop feeds it ns since the window opened (arrivals and ticks),
        so its window deadline is real time."""
        from repro_torch.serve import QueryFrontend, TenantQuota

        f = self.cfg["frontend"]
        kw = {"epoch_cost": _wall_clock_cost} if wall_clock else {}
        return QueryFrontend(
            self.rt, window_ns=float(f["window_ns"]),
            max_batch=int(f["max_batch"]),
            default_quota=TenantQuota(max_inflight=int(f["max_inflight"]),
                                      deadline_ns=f["deadline_ns"]),
            optimize=bool(f["optimize"]), **kw)

    def counters(self) -> Dict[str, float]:
        m = self.rt.metrics
        return {c: m.counter(c).total() for c in COUNTERS}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def warm(system: System, mix: traffic.Mix, seed: int) -> int:
    """Run every spec the mix can draw once, one stacked epoch, and a
    burst through a frontend, so the window lowers and loads nothing."""
    rt, deploy = system.rt, system.deploy
    specs = mix.specs()
    for spec in specs:
        t = rt.submit(*deploy.plan(spec))
        rt.drain()
        rt.popcount(t.result)
        rt.free(t.result)
    batch = int(system.cfg["frontend"]["max_batch"])
    first = mix.first(seed, 4 * batch)
    tickets = [rt.submit(*deploy.plan(first[0])) for _ in range(batch)]
    rt.drain()
    for t in tickets:
        rt.popcount(t.result)
        rt.free(t.result)
    fe = system.frontend(wall_clock=mix.loop == "open")
    for k, spec in enumerate(first):
        fe.submit(f"warm{k % 64}", *deploy.plan(spec))
    fe.flush()
    for q in fe.take_completed():
        rt.popcount(q.result)
        rt.free(q.result)
    _sync(rt.tensor_device)
    return len(specs)


# -- the roofline's bytes ------------------------------------------------------


class Meter:
    """The least bytes the window's queries need: for each call into the
    frontend, the union of the operands that the queries it completed
    read, each counted once, plus a count's bytes a query. Counted from
    the queries (``reference.<kind>.operand_bytes``), never from the
    kernels that ran."""

    def __init__(self, cfg: dict, on: bool):
        self.on = on
        self.cfg = cfg
        self.ref = importlib.import_module(f"bench.reference.{cfg['kind']}")
        self.bytes = 0

    def add(self, specs: List[tuple]) -> None:
        if not self.on or not specs:
            return
        union: Dict[tuple, int] = {}
        for s in specs:
            union.update(self.ref.operand_bytes(self.cfg, s))
        self.bytes += sum(union.values()) + ANSWER_BYTES * len(specs)


# -- the loops -----------------------------------------------------------------


class Records:
    """One row a query, indexed by the frontend's sequence number, in flat
    lists of ints: a window of 100,000 queries leaves the collector
    nothing more to walk. -1 marks an answer or count not there."""

    def __init__(self):
        self.ids: Dict[tuple, int] = {}
        self.specs: List[tuple] = []        # spec id -> spec
        self.spec: List[int] = []           # seq -> spec id
        self.tenant: List[str] = []
        self.due: List[int] = []
        self.answered: List[int] = []
        self.count: List[int] = []

    def add(self, seq: int, spec: tuple, tenant: str, due: int) -> None:
        if seq != len(self.spec):
            raise RuntimeError(f"frontend sequence {seq} out of order")
        sid = self.ids.get(spec)
        if sid is None:
            sid = self.ids[spec] = len(self.specs)
            self.specs.append(spec)
        self.spec.append(sid)
        self.tenant.append(tenant)
        self.due.append(due)
        self.answered.append(-1)
        self.count.append(-1)

    def __len__(self) -> int:
        return len(self.spec)

    def latencies_ms(self, until: Optional[int] = None) -> List[float]:
        """Due-to-count latency of every counted query answered by
        ``until`` (every one when None)."""
        return [(a - d) * 1e-6 for a, d, c in zip(self.answered, self.due,
                                                    self.count)
                if c >= 0 and (until is None or a <= until)]


class _Loop:
    """What the closed and open loops share: the frontend, the records by
    the frontend's sequence number, and the answer path. The program
    times its own calls (its host spans); in a traced run the benchmark
    annotates only what the program has no span for, the app's plan
    (``APP_PLAN``), so that the trace can name idle time under it."""

    def __init__(self, system: System, meter: Meter, wall_clock: bool,
                 traced: bool = False):
        self.system = system
        self.rt = system.rt
        self.fe = system.frontend(wall_clock)
        self.meter = meter
        self.plan_annotation = (
            functools.partial(torch.profiler.record_function, APP_PLAN)
            if traced else contextlib.nullcontext)
        self.recs = Records()
        self.pending: deque = deque()
        self.lateness_ns: List[int] = []

    def submit(self, tenant: str, spec: tuple, due: int,
               arrival_ns: Optional[float] = None) -> None:
        with self.plan_annotation():
            expr, env = self.system.deploy.plan(spec)
        if arrival_ns is None:
            q = self.fe.submit(tenant, expr, env)
        else:
            q = self.fe.submit(tenant, expr, env, arrival_ns)
        self.recs.add(q.seq, spec, tenant, due)
        self.collect()

    def collect(self) -> None:
        done = self.fe.take_completed()
        if done:
            recs = self.recs
            self.meter.add([recs.specs[recs.spec[d.seq]] for d in done])
            self.pending.extend(done)

    def answer(self, q) -> None:
        """Read a completed query's count (an error result has none)."""
        if q.error is None and q.result is not None:
            self.recs.count[q.seq] = self.rt.popcount(q.result)
            self.rt.free(q.result)
        self.recs.answered[q.seq] = now_ns()


class ClosedLoop(_Loop):
    """``clients`` tenants, each with one query outstanding: a client
    submits its next query as soon as its count is read. Queries come
    from one stream of the seed in submit order. The frontend keeps its
    own clock, so its window drains when ``max_batch`` are admitted."""

    def __init__(self, system, mix, seed, meter, traced=False):
        super().__init__(system, meter, wall_clock=False, traced=traced)
        self.stream = mix.queries(seed)
        self.clients = int(mix.load["clients"])

    def run(self, seconds: float) -> None:
        t0 = now_ns()
        self.t0, self.end = t0, t0 + int(seconds * 1e9)
        for c in range(self.clients):
            self.submit(f"t{c}", next(self.stream), now_ns())
        while now_ns() < self.end:
            if not self.pending:        # a window that cannot fill
                self.fe.flush()
                self.collect()
                if not self.pending:
                    break
                continue
            q = self.pending.popleft()
            self.answer(q)
            if now_ns() < self.end:
                self.submit(self.recs.tenant[q.seq], next(self.stream),
                            now_ns())

    def finish(self) -> None:
        """After the window: answer what is still in flight (checked for
        ``correct``, not timed)."""
        while self.pending:
            self.answer(self.pending.popleft())
        self.fe.flush()
        for q in self.fe.take_completed():
            self.answer(q)

    def latencies_ms(self) -> List[float]:
        """Of the queries answered inside the window."""
        return self.recs.latencies_ms(self.end)


class OpenLoop(_Loop):
    """Poisson arrivals at the mix's rate, each from a Zipf-drawn tenant;
    the frontend's clock is ns since the window opened. A query's latency
    runs from its due time to its count on the host, and every query due
    in the window is awaited (up to ``LATE_WAIT_S`` past it)."""

    def __init__(self, system, mix, seed, meter, seconds, rate_qps=None,
                 traced=False):
        super().__init__(system, meter, wall_clock=True, traced=traced)
        self.times, self.tenants = mix.arrivals(seed, seconds, rate_qps)
        self.specs = mix.first(seed, len(self.times))
        self.backlog_at: List[tuple] = []

    def _deadline(self) -> float:
        fe = self.fe
        if not fe.window:
            return float("inf")
        return min(q.admitted_ns for q in fe.window) + fe.window_ns

    def run(self, seconds: float, marks=()) -> None:
        n, times = len(self.times), self.times
        marks = deque(sorted(int(m * 1e9) for m in marks))
        i = answered = 0
        t0 = now_ns()
        self.t0, self.end = t0, t0 + int(seconds * 1e9)
        give_up = self.end + int(LATE_WAIT_S * 1e9)
        while True:
            t = now_ns() - t0
            while marks and t >= marks[0]:
                due = int(np.searchsorted(times, t, side="right"))
                self.backlog_at.append((marks.popleft(), due - answered))
            while i < n and times[i] <= t:
                tq = now_ns() - t0
                self.lateness_ns.append(tq - int(times[i]))
                self.submit(f"t{int(self.tenants[i])}", self.specs[i],
                            t0 + int(times[i]), float(tq))
                i += 1
            t = now_ns() - t0
            if t >= self._deadline() or (i == n and not self.fe.window
                                         and self.fe.backlog):
                self.fe.tick(float(t))
                self.collect()
            while self.pending:
                self.answer(self.pending.popleft())
                answered += 1
            if i == n and answered == n:
                break
            if now_ns() > give_up:
                break
            nxt = min(float(times[i]) if i < n else float("inf"),
                      self._deadline())
            if nxt == float("inf"):
                if i == n and not self.fe.window and not self.fe.backlog:
                    break       # nothing due, nothing held: all answered
                continue
            while now_ns() - t0 < nxt:
                pass
        for m in marks:         # the window's rest, after every answer
            due = int(np.searchsorted(times, m, side="right"))
            self.backlog_at.append((m, due - answered))

    def finish(self) -> None:
        pass

    def latencies_ms(self) -> List[float]:
        """Of every query due in the window, however late answered."""
        return self.recs.latencies_ms()


# -- one run -------------------------------------------------------------------


@dataclasses.dataclass
class RunView:
    """What the metric readers see of one run."""

    loop: str
    seconds: float
    setup_s: float
    latencies_ms: List[float]
    answered: int               # answered inside the window (closed) /
                                # of the queries due in it (open)
    counters: Dict[str, float]  # window deltas of the program's counters
    trace: Optional[dict]       # devtrace.summarize, traced runs on a card
    roofline_bytes: int
    hbm_bytes_per_s: float
    # the program's host spans over a traced window, by name
    # (``Tracer.host_summary``: count, total_s, self_s); empty untraced
    host: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    # ``idlesplit.program_split`` of the traced window (idle seconds by
    # the innermost open span, ``idle_in_sync``, ``idle_in_program``);
    # None without a card's trace
    idle_split: Optional[dict] = None

    def host_s(self, name: str, key: str = "total_s") -> float:
        """``key`` of the program's spans named ``name`` in the window."""
        return self.host.get(name, {}).get(key, 0.0)

    @property
    def syncs(self) -> int:
        """``device_store.sync`` spans in the window: the host's blocking
        reads of the card."""
        return int(self.host_s(idlesplit.SYNC, "count"))

    @property
    def host_answers(self) -> int:
        """Answers the program's spans saw: one ``runtime.popcount`` span
        an answer."""
        return int(self.host_s(ANSWER, "count"))

    def ms_per_answer(self, seconds: float) -> Optional[float]:
        """``seconds`` of host time as ms a query answered in the window
        (None where the window's spans saw no answer)."""
        n = self.host_answers
        return seconds * 1e3 / n if n else None


HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def forbidden_modules(modules=None) -> List[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``
    when None), each module's name before its first dot compared whole."""
    names = list(sys.modules) if modules is None else list(modules)
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def breakdown(summary: dict, split: dict) -> dict:
    """A traced run's ``breakdown``: the 10 device ops that took most time
    (``devtrace.summarize``), and the 10 names under which the card idled
    longest, each idle instant named by the innermost span open at it
    (``idlesplit.split``)."""
    return {"device_ops": summary["device_ops"],
            "idle_gaps": devtrace.top(split["idle_s"])}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None,
             control: bool = False, rate_qps: Optional[float] = None
             ) -> dict:
    """One run of ``cell``; returns the result line as a dict.
    ``control=True`` puts the reference's control in the program's place
    for the answers (a check of ``correct``, never a benchmark run)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    on_card = device.type == "cuda"
    mix = cell.mix
    if trace:
        seconds = min(float(seconds), TRACE_SECONDS)
    t = time.perf_counter()
    system = System(cell.config, seed, device)
    _sync(device)
    log(f"[bench] {cell.name}: data and runtime {time.perf_counter() - t:.3f}"
        f" s")
    t = time.perf_counter()
    n_specs = warm(system, mix, seed)
    log(f"[bench] warmed {n_specs} specs in {time.perf_counter() - t:.3f} s")
    meter = Meter(cell.config, trace and on_card)
    if mix.loop == "closed":
        loop = ClosedLoop(system, mix, seed, meter, traced=trace)
    else:
        loop = OpenLoop(system, mix, seed, meter, seconds, rate_qps,
                        traced=trace)
    before = system.counters()
    # what set-up made lives as long as the process: a full collection in
    # the window walks only what the window makes
    gc.collect()
    gc.freeze()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    prof = None
    if trace and on_card:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    brackets = []       # the anchors' host times at the window's two ends
    try:
        with torch.profiler.record_function(devtrace.WINDOW) if prof \
                else contextlib.nullcontext():
            if prof is not None:
                brackets.append(idlesplit.anchor())
            system.tracer.host_enabled = trace
            loop.run(seconds)
            system.tracer.host_enabled = False
            if prof is not None:
                brackets.append(idlesplit.anchor())
                _sync(device)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    meter.on = False
    counters = {k: v - before[k] for k, v in system.counters().items()}
    host = system.tracer.host_summary()
    loop.finish()
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    summary = split = None
    if prof is not None:
        t = time.perf_counter()
        events = devtrace.read_trace(prof)
        t0_us, t1_us = devtrace.window_bounds(events)
        summary = devtrace.summarize(events, t0_us, t1_us)
        split = idlesplit.program_split(events, t0_us, t1_us,
                                        system.tracer.host_events, brackets)
        log(f"[bench] read {len(events)} trace events in "
            f"{time.perf_counter() - t:.3f} s")
        del events
    lat = loop.latencies_ms()
    recs = loop.recs
    lateness = loop.lateness_ns
    # free the program's state before the reference runs
    del loop, system, prof
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = importlib.import_module(f"bench.reference.{cell.config['kind']}")
    want = ref.Reference(cell.config, seed, device).counts(recs.specs)
    want = [want[s] for s in recs.specs]
    got = recs.count
    if control:
        ctl = ref.Reference(cell.config, seed, device,
                            control=True).counts(recs.specs)
        ctl = [ctl[s] for s in recs.specs]
        got = [ctl[sid] if c >= 0 else c for sid, c in zip(recs.spec, got)]
    wrong = sum(1 for sid, c in zip(recs.spec, got)
                if c >= 0 and c != want[sid])
    unanswered = sum(1 for c in got if c < 0)
    log(f"[bench] reference: {len(recs.specs)} distinct queries counted in "
        f"{time.perf_counter() - t:.3f} s")

    view = RunView(
        loop=mix.loop, seconds=float(seconds), setup_s=setup_s,
        latencies_ms=lat, answered=len(lat), counters=counters,
        trace=summary, roofline_bytes=meter.bytes,
        hbm_bytes_per_s=HBM_BYTES_PER_S, host=host, idle_split=split)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"], cell.root)(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card
           else device.type,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
    if lateness:
        late_ms = [x * 1e-6 for x in lateness]
        log(f"[bench] generator late: p50 {stats.nearest_rank(late_ms, .5)}"
            f" ms, p99 {stats.nearest_rank(late_ms, .99)} ms, max "
            f"{max(late_ms)} ms over {len(late_ms)} arrivals")
    log(f"[bench] window: {len(lat)} answered in it, {len(recs)} "
        f"submitted, counters {json.dumps(counters)}")
    for name, s in sorted(host.items()):
        log(f"[bench] host span {name}: {s['count']} spans, total "
            f"{s['total_s']} s, self {s['self_s']} s")
    if summary is not None:
        log(f"[bench] trace: busy {summary['busy_s']} s of "
            f"{summary['window_s']} s, kernels {summary['kernel_s']} s, "
            f"roofline bytes {meter.bytes} at {HBM_BYTES_PER_S} B/s; card "
            f"and power limit: {power_limit()}")
        log(f"[bench] idle split: {sum(split['idle_s'].values())} s over "
            f"all names, window less busy "
            f"{summary['window_s'] - summary['busy_s']} s; clock map within "
            f"{split['clock_err_us']} us; idle in sync "
            f"{split['idle_in_sync']} %, in the program's other spans "
            f"{split['idle_in_program']} %; by name "
            f"{json.dumps(devtrace.top(split['idle_s'], None))}")
        log(f"[bench] kernel seconds by issuer (issuer, operands, kernel, "
            f"s, launches): {json.dumps(split['kernels'][:10])}")
    for k, v in metrics.items():
        log(f"[bench] metric {k} = {v['value']} {v['unit']}")
    checks = {"wrong_answers": {"value": wrong, "limit": 0},
              "unanswered": {"value": unanswered, "limit": 0}}
    result = {"correct": wrong == 0 and unanswered == 0,
              "attempted": len(recs), "failed": unanswered,
              "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = breakdown(summary, split)
    result["checks"] = checks
    return result


def print_checks(result: dict) -> None:
    """The numbers compared, each beside its limit: the last lines on
    standard error."""
    for name, c in result["checks"].items():
        log(f"check {name} = {c['value']} (limit {c['limit']})")
