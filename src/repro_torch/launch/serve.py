"""Serving entry point: --arch <id>, batched prefill+decode on one device.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
      --reduced --requests 8 --max-new 16 --device cuda

``--reduced`` (the default) serves the smoke-scale config and
``--no-reduced`` the published one. Whisper's requests carry frames
(its encoder's input embeddings) drawn from the prompts' generator after
the prompts. Runs on the card unless ``--device`` names another.
"""

import argparse
import time

import numpy as np
import torch

from ..configs import REGISTRY, get_config
from ..core.bitvector import resolve_device
from ..models import build_model
from ..serve import Request, ServeEngine


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b", choices=sorted(REGISTRY))
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the smoke-scale config (--no-reduced: the "
                    "published one)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the card)")
    return ap.parse_args(argv)


def config_of(args: argparse.Namespace):
    """The config ``args`` serve, built from nothing."""
    cfg = get_config(args.arch)
    return cfg.reduced() if args.reduced else cfg


def make_requests(cfg, n: int, max_new: int):
    """``n`` requests drawn from ``default_rng(0)``: the prompts, then for
    an encoder-decoder config each request's frames."""
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, rng.integers(2, 12))
                    .astype(np.int32), max_new_tokens=max_new)
            for _ in range(n)]
    if cfg.enc_dec:
        for r in reqs:
            r.frames = rng.standard_normal(
                (cfg.n_frames, cfg.d_model)).astype(np.float32)
    return reqs


def main(argv=None, params=None):
    """Serve ``--requests`` requests; returns them. ``params`` (on the
    named device) replaces the weights drawn from seed 0."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = config_of(args)
    model = build_model(cfg)
    if params is None:
        params = model.init(0, device=device)
    eng = ServeEngine(model, params, max_seq=args.max_seq,
                      batch_slots=args.slots,
                      temperature=args.temperature)
    reqs = make_requests(cfg, args.requests, args.max_new)
    t0 = time.time()
    eng.generate(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    n_tok = sum(len(r.out) for r in reqs)
    for i, r in enumerate(reqs):
        print(f"req{i}: {len(r.prompt)} prompt -> {len(r.out)} tokens")
    print(f"{n_tok} tokens in {dt:.1f}s ({n_tok/dt:.1f} tok/s, "
          f"{args.slots} slots, {device})")
    return reqs


if __name__ == "__main__":
    main()
