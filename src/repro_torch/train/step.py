"""Training step builder: loss, grads, microbatch accumulation, optimizer.

``make_train_step(model, opt_cfg, ...)`` returns a step function
``(state, batch) -> (state, metrics)``. Gradients come from
``torch.autograd.grad`` of the loss on the parameter tree's leaves (taken
as detached aliases that require grad, so no ``.grad`` is left behind);
``optim.update`` then writes the new parameters and moments into the
state's own tensors.

Over a mesh (``mesh=``, a ``DeviceMesh``) the state's leaves are
DTensors under ``spec_for``'s placements (``init_state(mesh=)``,
``Checkpointer.restore(mesh=, spec_tree=)``), so each rank holds its
share of the parameters and moments. Every rank takes the same global
batch (whole, or as DTensors split over the batch axes, whose labels the
loss gathers whole) and computes its rows of it
(``Model.forward(mesh=)``), every rank
holds the same loss, and each backpropagates the loss divided by the
mesh's size: the parameter gathers' backward sums the ranks' gradients,
so each shard receives its part of the gradient of the loss. AdamW then
updates the shards in place.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from ..core.bitvector import resolve_device
from ..models.model import Model
from ..models.param import (ShardingRules, PartitionSpec, init_leaf,
                            tree_leaves, tree_unflatten)
from ..models.sharding_ctx import (distribute_leaf, mesh_shape_dict,
                                   spec_map, whole)
from ..optim import optimizer as opt

AUX_LOSS_WEIGHT = 0.01
Z_LOSS_WEIGHT = 1e-4


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over masked tokens + z-loss (logit-norm regularizer)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = torch.take_along_dim(
        logits, labels[..., None].long(), dim=-1)[..., 0]
    ce = lse - label_logit
    zl = torch.square(lse)
    if mask is None:
        mask = torch.ones_like(ce)
    mask = mask.to(torch.float32)
    denom = torch.clamp(mask.sum(), min=1.0)
    return (ce * mask).sum() / denom, (zl * mask).sum() / denom


def make_loss_fn(model: Model, mesh=None, remat="save_attn"):
    def loss_fn(params, batch):
        logits, aux = model.forward(params, batch, mesh=mesh, remat=remat)
        ce, zl = cross_entropy(logits, whole(batch["labels"]),
                               whole(batch.get("loss_mask")))
        loss = ce + AUX_LOSS_WEIGHT * aux + Z_LOSS_WEIGHT * zl
        metrics = {"loss": loss, "ce": ce, "aux": aux, "ppl_log": ce}
        return loss, metrics

    return loss_fn


def init_state(model: Model, seed: int = 0, device=None, mesh=None
               ) -> Dict[str, Any]:
    """Parameters drawn from ``seed`` on ``device`` (the card unless
    named) and zero optimizer state. Over a mesh every rank draws the
    same parameters on the mesh's device and keeps its shards of them
    under ``model.param_specs`` of the default rules, one leaf at a time
    (a rank holds its shards and one whole leaf at most), and the
    moments are zero DTensors of the same placements."""
    if mesh is None:
        params = model.init(seed, device=device)
        return {"params": params, "opt": opt.init(params)}
    dev = resolve_device(device or mesh.device_type)
    gen = torch.Generator(dev).manual_seed(seed)
    specs = model.param_specs(ShardingRules(), mesh_shape_dict(mesh))
    params = spec_map(lambda d, spec: distribute_leaf(
        init_leaf(d, gen), mesh, spec), model.param_defs(), specs)
    return {"params": params, "opt": opt.init(params)}


def state_specs(model: Model, mesh):
    """The spec tree of a train state on ``mesh`` under the default rules
    (the reference's ``launch/train`` layout: moments as the parameters,
    ``step`` replicated)."""
    specs = model.param_specs(ShardingRules(), mesh_shape_dict(mesh))
    return {"params": specs,
            "opt": {"m": specs, "v": specs, "step": PartitionSpec()}}


def value_and_grad(loss_fn, params, batch, mesh=None):
    """``jax.value_and_grad(loss_fn, has_aux=True)``: ((loss, metrics),
    grads), the metrics detached. Over a mesh each rank backpropagates
    the loss divided by the mesh's size (the module docstring)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(params, leaves), batch)
        ranks = 1 if mesh is None else mesh.size()
        grads = torch.autograd.grad(loss / ranks if ranks > 1 else loss,
                                    leaves)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_unflatten(params, grads)


def make_train_step(model: Model, opt_cfg: opt.OptimizerConfig, mesh=None,
                    remat="save_attn", microbatches: int = 1):
    loss_fn = make_loss_fn(model, mesh=mesh, remat=remat)

    def train_step(state, batch):
        params = state["params"]
        if microbatches <= 1:
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch,
                                                    mesh)
        else:
            def split(x, i):
                mb = x.shape[0] // microbatches
                return x[i * mb:(i + 1) * mb]

            leaves = tree_leaves(params)
            g_acc = [torch.zeros(opt._local(p).shape, dtype=torch.float32,
                                 device=opt._local(p).device)
                     for p in leaves]
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=g_acc[0].device)
            for i in range(microbatches):
                mb = {k: split(v, i) for k, v in batch.items()}
                (loss, _m), g = value_and_grad(loss_fn, params, mb, mesh)
                for a, b in zip(g_acc, tree_leaves(g)):
                    a.add_(opt._local(b).to(torch.float32))
                loss_sum = loss_sum + loss
                del g
            grads = tree_unflatten(params, [
                _like(p, g / microbatches) for p, g in zip(leaves, g_acc)])
            loss = loss_sum / microbatches
            zero = torch.zeros((), dtype=torch.float32, device=loss.device)
            metrics = {"loss": loss, "ce": loss, "aux": zero,
                       "ppl_log": loss}
        new_params, new_opt, opt_metrics = opt.update(
            opt_cfg, grads, state["opt"], params)
        metrics.update(opt_metrics)
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def _like(p, local: torch.Tensor) -> torch.Tensor:
    """``local`` under ``p``'s placements when ``p`` is a DTensor."""
    if isinstance(p, DTensor):
        return DTensor.from_local(local, p.device_mesh, p.placements,
                                  run_check=False)
    return local
