"""End-to-end training example: train a small LM for a few hundred steps
with the full production loop - BitWeaving-filtered data pipeline (its
filter launches the scan kernel twice on the card), AdamW,
checkpointing, fault-tolerant supervisor, straggler watchdog.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300
      PYTHONPATH=src python -m repro_torch.examples.train_lm \
          --preset 100m --steps 200
(the default preset is CPU-friendly ~2M params; --preset 100m builds a
~100M-param model; ``--device cpu`` trains on the CPU). The step is
``make_train_step`` called eagerly.
"""

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..checkpoint import Checkpointer
from ..configs import get_config
from ..core.bitvector import resolve_device
from ..data.pipeline import DataConfig, FilteredSyntheticLM
from ..models import build_model
from ..optim.optimizer import OptimizerConfig
from ..runtime import Supervisor
from ..train.step import init_state, make_train_step


def build_cfg(preset: str):
    base = get_config("qwen2.5-3b")
    if preset == "100m":
        return dataclasses.replace(
            base, n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
            d_head=64, d_ff=2048, vocab=32768)
    return dataclasses.replace(
        base, n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
        d_head=32, d_ff=512, vocab=2048)


def main(argv=None, state=None) -> dict:
    """Train; returns the start step, the losses, the history and the
    final state. ``state`` (on the named device) replaces the initial
    state drawn from seed 0 when the run does not resume."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--preset", default="small", choices=["small", "100m"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="artifacts/train_lm_ckpt")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = build_cfg(args.preset)
    model = build_model(cfg)
    print(f"model: {cfg.name}-{args.preset} "
          f"N={model.n_params()/1e6:.1f}M params")

    opt = OptimizerConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    step_fn = make_train_step(model, opt, remat=False)
    data = FilteredSyntheticLM(
        DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                   global_batch=args.batch, noise=0.02),
        n_docs=4096, device=dev)
    print(f"data: {data.mask.sum()}/{len(data.mask)} docs pass the "
          f"BitWeaving quality filter")

    def batch_at(s):
        b = data.batch_at(s)
        return {k: torch.from_numpy(b[k]).to(dev)
                for k in ("tokens", "labels")}

    ck = Checkpointer(args.ckpt_dir, keep_n=3)
    start = 0
    if args.resume and ck.latest_step() is not None:
        start, state = ck.restore(device=dev)
        print(f"resumed from step {start}")
    elif state is None:
        state = init_state(model, 0, device=dev)

    sup = Supervisor(ck, checkpoint_every=50, device=dev)
    t0 = time.time()
    state, hist = sup.run(state, batch_at, step_fn, start, args.steps)
    dt = time.time() - t0
    losses = [h["loss"] for h in hist if "loss" in h]
    toks = args.batch * args.seq * len(losses)
    print(f"steps {start}->{args.steps}: loss {losses[0]:.3f} -> "
          f"{np.mean(losses[-10:]):.3f}  ({toks/dt:.0f} tok/s)")
    slow = [h["step"] for h in hist if h.get("slow")]
    if slow:
        print(f"straggler watchdog flagged steps: {slow}")
    return {"start": start, "losses": losses, "history": hist,
            "state": state, "docs_passed": int(data.mask.sum()),
            "tokens_per_s": toks / dt}


if __name__ == "__main__":
    main()
