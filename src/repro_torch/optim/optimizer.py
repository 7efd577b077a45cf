"""AdamW with warmup+cosine schedule and global-norm clipping.

Hand-rolled, as the reference is. Optimizer state mirrors the parameter
tree. ``update`` works as ``torch.optim`` does: under ``torch.no_grad()``
it writes the new parameters, moments and step into the state's own
tensors and returns those trees. A functional update would hold a second
copy of the parameters and both moments (40.8 GB more for qwen2.5-3b's
3.40 B float32 parameters, which already take 54.4 GB with their
gradients and moments); the arithmetic is the reference's, op for op.

Sharded state (DTensor leaves, as ``train.step`` keeps them over a mesh)
is updated shard by shard in place: the update is elementwise, and
``global_norm`` is the norm of the whole tree, its squared sums
all-reduced over the mesh, so clipping scales every shard alike.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from ..models.param import map_tree, tree_leaves


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0


def schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor or a number), in float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * frac))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params) -> Dict[str, Any]:
    """Zero moments shaped as ``params`` and a 0-d int32 step, on the
    parameters' device."""
    device = _local(tree_leaves(params)[0]).device
    return {"m": map_tree(torch.zeros_like, params),
            "v": map_tree(torch.zeros_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank (sharing its storage), or x."""
    return x.to_local() if isinstance(x, DTensor) else x


def global_norm(tree) -> torch.Tensor:
    """The norm of every leaf of ``tree``. Over DTensor leaves each
    rank's squared sums are divided by the leaf's replica count (the
    ranks that hold its shard alike) and summed over the whole mesh, so
    every rank gets the norm of the whole tree."""
    leaves = tree_leaves(tree)
    sums = [torch.sum(torch.square(_local(l).to(torch.float32)))
            for l in leaves]
    sharded = [l for l in leaves if isinstance(l, DTensor)]
    if sharded:
        mesh = sharded[0].device_mesh
        shares = []
        for s, l in zip(sums, leaves):
            # a plain leaf is held alike by every rank
            copies = mesh.size() if not isinstance(l, DTensor) else 1
            for i, p in enumerate(getattr(l, "placements", ())):
                if isinstance(p, Replicate):
                    copies *= mesh.size(i)
            shares.append(s / copies if copies > 1 else s)
        stacked = torch.stack(shares)
        for i in range(mesh.ndim):
            if mesh.size(i) > 1:
                dist.all_reduce(stacked, group=mesh.get_group(i))
        sums = list(stacked.unbind())
    return torch.sqrt(sum(sums))


@torch.no_grad()
def update(cfg: OptimizerConfig, grads, opt_state, params
           ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, written in place into ``params`` and ``opt_state``
    (which are returned) and its metrics. A caller that needs the old
    state clones it first."""
    step = _local(opt_state["step"]) + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    for p, g, m, v in zip(*(map(_local, tree_leaves(t)) for t in (
            params, grads, opt_state["m"], opt_state["v"]))):
        # the reference's expressions, each elementwise op in its order;
        # in-place forms only where they compute the same bits
        g = g.to(torch.float32) * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        del g
        delta = m / bc1
        delta.div_((v / bc2).sqrt_().add_(cfg.eps))
        delta.add_(cfg.weight_decay * p.to(torch.float32))
        if p.dtype == torch.float32:
            p.sub_(lr * delta)
        else:
            p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
    _local(opt_state["step"]).copy_(step)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
