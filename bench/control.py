#!/usr/bin/env python3
"""Run a cell with the control in the program's place, to show that
``correct`` refuses it. Not a benchmark run.

    python3 bench/control.py --workload <cell> --seeds a,b,c [--seconds s]

Each seed serves the cell's traffic through the port as a run does, then
replaces every answer by the reference's control (``control=True``: the
count over every second word or row, doubled - an approximate count
where the configuration guarantees an exact one) and compares it with
the exact reference. Prints one JSON line a seed with its checks; every
line should read ``"correct": false``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "bench":
    sys.path.pop(0)
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from bench import harness

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run_cell(cell, seed, args.seconds, False, args.device,
                             control=True)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "correct": r["correct"],
                          "attempted": r["attempted"],
                          "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
