#!/usr/bin/env python3
"""Run one cell as ``run.py`` does, with the program's host spans on.

    python3 bench/hostspans.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It is ``run.py``'s ``main``, its checks included, with ``run`` in
``harness.run_cell``'s place: the runtime is built with a
``repro_torch.obs.Tracer`` of its own, and its host spans
(``Tracer.host_span``) are on while the window's loop runs. The last
line of standard output is ``run.py``'s result line plus ``host``: the
window's ``Tracer.host_summary()``, the sync sites, and per answered
query (one ``runtime.popcount`` span an answer) the frontend's own and
the scheduler's own ms (self time), the ms in ``device_store.launch``
and in ``device_store.sync``, and the syncs. With ``--trace 1`` it adds
``idle_split``: ``idlesplit.split`` of the traced window, the program's
spans put on the trace's clock by anchors read at the loop's two ends
(idle seconds by the innermost open span, program's or benchmark's;
kernel seconds by the span that issued them, a launch's keyed by its
operand count), the map's uncertainty, and the idle shares under
``device_store.sync`` and under the program's other spans. Untraced,
its ``qps`` beside ``run.py``'s on the same seeds is what host spans
cost when on.

``run.py`` and the cells' metrics do not read any of this: the harness
builds its runtime without a tracer. This script puts its runtime,
loops and trace summary in the harness's place for one call and puts
the harness's back after it.
"""

import contextlib
import functools
import sys
import time
from collections import Counter
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "bench":
    sys.path[0] = str(ROOT)     # bench/'s own modules import as bench.<name>
from bench import idlesplit  # noqa: E402

SYNC = idlesplit.SYNC
ANCHORS = 16                    # anchor annotations at each end


def per_query(summary: dict, answered: int) -> dict:
    """ms a query answered, of each layer's own host time."""
    if not answered:
        return {}

    def ms(name, key="total_s"):
        return summary.get(name, {}).get(key, 0.0) * 1e3 / answered
    frontend = sum(v["self_s"] for k, v in summary.items()
                   if k.startswith("frontend."))
    return {"frontend.self_ms_per_query": frontend * 1e3 / answered,
            "scheduler.self_ms_per_query": ms("scheduler.drain", "self_s"),
            "device_store.launch_ms_per_query": ms("device_store.launch"),
            "runtime.sync_ms_per_query": ms(SYNC),
            "runtime.syncs_per_query":
                summary.get(SYNC, {}).get("count", 0) / answered}


def anchor():
    """``ANCHORS`` ``idlesplit.ANCHOR`` annotations, each with the host's
    clock read just before and just after it opened."""
    import torch

    out = []
    for _ in range(ANCHORS):
        before = time.perf_counter_ns()
        with torch.profiler.record_function(idlesplit.ANCHOR):
            out.append((before, time.perf_counter_ns()))
    return out


def run(cell, seed: int, seconds: float, trace: bool, device="cuda",
        t_start=None, run_cell=None) -> dict:
    """``run_cell`` (by default ``harness.run_cell``) with the program's
    host spans on in the window; returns its result with ``host`` (and
    ``idle_split``)."""
    import repro_torch.pim as pim
    from repro_torch.obs import Tracer

    from bench import harness

    run_cell = run_cell or harness.run_cell
    tracer = Tracer(enabled=False)
    brackets, split = [], {}

    class System(harness.System):
        def __init__(self, cfg, seed, device):
            with mock.patch.object(pim, "AmbitRuntime", functools.partial(
                    pim.AmbitRuntime, tracer=tracer)):
                super().__init__(cfg, seed, device)

    def spanned(loop):
        class Loop(loop):
            def run(self, *args, **kwargs):
                brackets.append(anchor())
                tracer.host_enabled = True
                try:
                    return super().run(*args, **kwargs)
                finally:
                    tracer.host_enabled = False
                    brackets.append(anchor())
        return Loop

    summarize = harness.devtrace.summarize

    def summarize_and_split(events, t0_us, t1_us):
        to_us, err = idlesplit.host_to_trace(events, brackets)
        program = [(to_us(e.ts_ns), to_us(e.ts_ns + e.dur_ns), e.name,
                    e.args.get("operands")) for e in tracer.host_events]
        split.update(idlesplit.split(events, t0_us, t1_us, program),
                     clock_err_us=err)
        return summarize(events, t0_us, t1_us)

    with contextlib.ExitStack() as patches:
        for name, value in (("System", System),
                            ("ClosedLoop", spanned(harness.ClosedLoop)),
                            ("OpenLoop", spanned(harness.OpenLoop))):
            patches.enter_context(mock.patch.object(harness, name, value))
        patches.enter_context(mock.patch.object(
            harness.devtrace, "summarize", summarize_and_split))
        result = run_cell(cell, seed, seconds, trace, device, t_start)
    summary = tracer.host_summary()
    answered = summary.get("runtime.popcount", {}).get("count", 0)
    result["host"] = {
        "answered": answered,
        "sync_sites": dict(Counter(e.args["site"] for e in tracer.host_events
                                   if e.name == SYNC)),
        **per_query(summary, answered), "spans": summary}
    if split:
        result["idle_split"] = {**idlesplit.shares(split), **split}
    return result


def main(argv=None) -> int:
    # run.py sets the paths, the caches and the set-up clock's start,
    # which the harness's imports come after
    from bench import run as run_py
    from bench import harness

    with mock.patch.object(harness, "run_cell", functools.partial(
            run, run_cell=harness.run_cell)):
        return run_py.main(argv)


if __name__ == "__main__":
    sys.exit(main())
