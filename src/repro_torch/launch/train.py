"""Training driver: --arch <id> on one device.

Composes the stack: model + AdamW + BitWeaving-filtered data (its filter
launches the scan kernel twice on the card) + async checkpointing +
fault-tolerant supervisor.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --reduced --steps 50 --device cuda

Runs on the card unless ``--device`` names another. Sharding over a
mesh (``--data-parallel`` above 1, ``--model-parallel`` above 1) is
ROADMAP queue 1, item 12.
"""

import argparse

import numpy as np
import torch

from ..checkpoint import Checkpointer
from ..configs import REGISTRY, get_config
from ..core.bitvector import resolve_device
from ..data.pipeline import DataConfig, FilteredSyntheticLM
from ..models import build_model
from ..optim.optimizer import OptimizerConfig
from ..runtime import Supervisor
from ..train.step import init_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b", choices=sorted(REGISTRY))
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--data-parallel", type=int, default=0,
                    help="0 = all devices on data axis")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="artifacts/launch_train_ckpt")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the card)")
    args = ap.parse_args(argv)
    if args.data_parallel not in (0, 1) or args.model_parallel != 1:
        raise NotImplementedError(
            "training over a mesh (--data-parallel or --model-parallel "
            "above 1) is not ported yet (ROADMAP queue 1, item 12)")

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    print(f"arch={cfg.name} N={model.n_params()/1e6:.1f}M params "
          f"mesh=(1,1) devices=1")

    opt = OptimizerConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    step_fn = make_train_step(model, opt, microbatches=args.microbatches)
    data = FilteredSyntheticLM(
        DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                   global_batch=args.batch), device=device)

    ck = Checkpointer(args.ckpt_dir, keep_n=3)
    start = 0
    if args.resume and ck.latest_step() is not None:
        start, state = ck.restore(device=device)
        print(f"resumed from step {start} onto {device}")
    else:
        state = init_state(model, 0, device=device)

    def batch_at(s):
        b = data.batch_at(s)
        return {k: torch.from_numpy(b[k]).to(device)
                for k in ("tokens", "labels")}

    sup = Supervisor(ck, checkpoint_every=25, device=device)
    state, hist = sup.run(state, batch_at, step_fn, start, args.steps)
    losses = [h["loss"] for h in hist if "loss" in h]
    print(f"steps {start}->{args.steps}: loss {losses[0]:.3f} -> "
          f"{np.mean(losses[-5:]):.3f}")
    return start, state, hist


if __name__ == "__main__":
    main()
