"""Batched serving: prefill + decode with KV caches and slot-based
continuous batching on a reduced model.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_decode \
          [--arch gemma3-1b] [--device cpu]
"""

import argparse

import numpy as np

from ..configs import get_config
from ..core.bitvector import resolve_device
from ..models import build_model
from ..serve import Request, ServeEngine


def main(argv=None, params=None) -> dict:
    """Serve the script's requests; ``params`` (on the named device)
    replaces the weights drawn from seed 0. Returns the requests and the
    engine's counters."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    model = build_model(cfg)
    if params is None:
        params = model.init(0, device=dev)
    eng = ServeEngine(model, params, max_seq=128, batch_slots=4,
                      temperature=0.8)

    rng = np.random.default_rng(1)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, rng.integers(2, 9))
                    .astype(np.int32), max_new_tokens=args.max_new)
            for _ in range(args.requests)]
    eng.generate(reqs)
    for i, r in enumerate(reqs):
        print(f"req{i}: prompt={r.prompt.tolist()} -> {r.out}")

    # Observability: the engine's MetricsRegistry counts the serving
    # loop's work - prefill batches, decode iterations actually executed
    # (the termination-contract number), tokens sampled, and completions
    # broken down by why each request finished.
    snap = eng.metrics.snapshot()
    counters = {k: int(v) for k, v in sorted(snap["counters"].items())}
    print("metrics:")
    for k, v in counters.items():
        print(f"  {k} = {v}")
    return {"requests": reqs, "counters": counters}


if __name__ == "__main__":
    main()
