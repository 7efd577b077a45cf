"""Production training driver: --arch <id> on whatever mesh is available.

Composes the full stack: mesh + sharding rules + model + AdamW +
BitWeaving-filtered data (its filter launches the scan kernel twice on
the card) + async checkpointing + fault-tolerant supervisor. The state
is sharded over a ``(data, model)`` mesh by the same ``ShardingRules``
as the reference's; every rank takes its rows of the same global batch.

One process a rank, under a launcher:

  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 8 -m repro_torch.launch.train --arch qwen2.5-3b \\
      --reduced --steps 50 --data-parallel 2 --model-parallel 4 \\
      --device cpu

or alone (a one-rank group over a (1,1) mesh):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --reduced --steps 50 --device cuda

Runs on the card unless ``--device`` names another (NCCL on the card,
gloo on the CPU). ``main`` returns (start step, state, history); a run
that started its own process group ends it, and one of a single rank
returns its state whole, as plain tensors.
"""

import argparse

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..checkpoint import Checkpointer
from ..configs import REGISTRY, get_config
from ..core.bitvector import resolve_device
from ..data.pipeline import DataConfig, FilteredSyntheticLM
from ..models import build_model
from ..models.param import map_tree
from ..optim.optimizer import OptimizerConfig
from ..runtime import Supervisor
from ..train.step import init_state, make_train_step, state_specs
from .mesh import init_process_group, make_host_mesh


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

    device = resolve_device(args.device)
    started = init_process_group(device)
    try:
        start, state, hist = _train(args, device)
        if started and dist.get_world_size() == 1:
            state = map_tree(_whole, state)
        return start, state, hist
    finally:
        if started:
            dist.destroy_process_group()


def _whole(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def _train(args, device):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    n_dev = dist.get_world_size()
    dp = args.data_parallel or max(1, n_dev // args.model_parallel)
    mesh = make_host_mesh(data=dp, model=args.model_parallel,
                          device=device.type)
    lead = dist.get_rank() == 0
    if lead:
        print(f"arch={cfg.name} N={model.n_params()/1e6:.1f}M params "
              f"mesh=({dp},{args.model_parallel}) devices={n_dev}")

    opt = OptimizerConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    step_fn = make_train_step(model, opt, mesh=mesh,
                              microbatches=args.microbatches)
    data = FilteredSyntheticLM(
        DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                   global_batch=args.batch), device=device)

    specs = state_specs(model, mesh)
    ck = Checkpointer(args.ckpt_dir, keep_n=3)
    start = 0
    if args.resume and ck.latest_step() is not None:
        start, state = ck.restore(mesh=mesh, spec_tree=specs)
        if lead:
            print(f"resumed from step {start} (elastic reshard onto "
                  f"{n_dev} devices, {device.type})")
    else:
        state = init_state(model, 0, device=device, mesh=mesh)

    def batch_at(s):
        b = data.batch_at(s)
        return {k: torch.from_numpy(b[k]).to(device)
                for k in ("tokens", "labels")}

    sup = Supervisor(ck, checkpoint_every=25, device=device, mesh=mesh,
                     spec_tree=specs)
    state, hist = sup.run(state, batch_at, step_fn, start, args.steps)
    losses = [h["loss"] for h in hist if "loss" in h]
    if lead:
        print(f"steps {start}->{args.steps}: loss {losses[0]:.3f} -> "
              f"{np.mean(losses[-5:]):.3f}")
    return start, state, hist


if __name__ == "__main__":
    main()
