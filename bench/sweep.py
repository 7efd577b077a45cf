#!/usr/bin/env python3
"""Find the highest rate an open-loop cell's mix sustains, once, on the card.

    python3 bench/sweep.py --workload <open cell> --seed <n> [--rates a,b,...] [--seconds s]
    python3 bench/sweep.py --config <config> --traffic <open mix> --seed <n> ...

Builds the cell's deployment once and offers its mix at each rate (the
``sweep`` entry of the mix's file unless ``--rates`` is given) for
``seconds``, recording the backlog (queries due but not yet answered) at
each quarter of the window. A rate is sustained when the backlog at the
close is at most two windows of ``max_batch`` and no larger than at half
time plus two windows, and the p99 latency is within ``P99_LIMIT_MS``;
the knee is the highest rate at and below which every rate offered is
sustained. Prints one JSON line a rate, then the knee and 0.8 of it. The
cell itself offers its mix at the rate written in its traffic file; this
script only informs that number.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# 0.1 s: the limit within which a user feels the system answer at once
# (Nielsen, Usability Engineering, 1993, ch. 5; Card, Robertson and
# Mackinlay, CHI 1991). Past it a queue that an 8 s window shows barely
# growing already costs every user a noticeable wait.
P99_LIMIT_MS = 100.0
if sys.path and Path(sys.path[0]).resolve() == ROOT / "bench":
    sys.path.pop(0)
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--config", help="with --traffic: a mix no cell offers")
    ap.add_argument("--traffic")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", default=None)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from bench import harness

    cell = (harness.load_cell(args.workload) if args.workload
            else harness.mix_cell(args.config, args.traffic))
    mix = cell.mix
    if mix.loop != "open":
        raise SystemExit(f"{cell.name} is not an open-loop cell")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    rates = ([float(r) for r in args.rates.split(",")] if args.rates
             else [float(r) for r in mix.sweep["rates_qps"]])
    seconds = args.seconds or float(mix.sweep["seconds"])
    for line in sweep(cell, args.seed, rates, seconds, args.device):
        print(json.dumps(line), flush=True)
    return 0


def sweep(cell, seed, rates, seconds, device="cuda"):
    """Yield one dict a rate, then the knee's."""
    import torch

    from bench import harness, stats

    mix = cell.mix
    slack = 2 * int(cell.config["frontend"]["max_batch"])
    system = harness.System(cell.config, seed, torch.device(device))
    harness.warm(system, mix, seed)
    sustained, rates_done = [], []
    for rate in sorted(rates):
        loop = harness.OpenLoop(system, mix, seed,
                                harness.Meter(cell.config, False), seconds,
                                rate)
        loop.run(seconds, marks=[seconds * k / 4 for k in (1, 2, 3, 4)])
        lat = loop.latencies_ms()
        in_window = len(loop.recs.latencies_ms(loop.end))
        backlog = [b for _, b in loop.backlog_at]
        p99 = stats.nearest_rank(lat, 0.99)
        ok = (backlog[3] <= slack and backlog[3] <= backlog[1] + slack
              and p99 is not None and p99 <= P99_LIMIT_MS)
        if ok and len(sustained) == len(rates_done):
            sustained.append(rate)
        rates_done.append(rate)
        yield {"rate_qps": rate, "offered": len(loop.times),
               "answered_in_window": in_window,
               "answered_qps": in_window / seconds,
               "backlog_at_quarters": backlog, "sustained": ok,
               "p50_ms": stats.nearest_rank(lat, 0.5),
               "p99_ms": p99, "p99_limit_ms": P99_LIMIT_MS,
               "drains": loop.fe.report_counters.drains}
    knee = max(sustained) if sustained else None
    yield {"workload": cell.name, "knee_qps": knee,
           "cell_rate_qps": None if knee is None else 0.8 * knee,
           "seconds": seconds, "seed": seed}


if __name__ == "__main__":
    sys.exit(main())
