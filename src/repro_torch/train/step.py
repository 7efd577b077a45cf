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
batch (whole, or as DTensors split over the batch axes) and computes its
share of it (``Model.forward(mesh=)``): the logits of its rows and of its
vocabulary block, as a DTensor. ``cross_entropy`` takes the loss on
them: the log-sum-exp over the vocabulary by a max and a ``psum`` over
``"model"``, the label's logit from the rank that holds it, the masked
sums and the mask count summed over the batch axes, with the labels and
the mask cut to the rank's rows. So every rank holds the same global
loss, and each backpropagates it divided by the mesh's size: the sum of
the ranks' losses is then the loss, and the collectives' adjoints (an
all-reduce for a ``psum``, a reduce-scatter for a gather, the sum of a
leaf's partial gradients over the ranks that hold it alike) carry its
gradient to each shard. AdamW then updates the shards in place.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Shard

from ..core.bitvector import resolve_device
from ..models.model import Model
from ..models.param import (ShardingRules, PartitionSpec, init_leaf,
                            tree_leaves, tree_unflatten)
from ..models.sharding_ctx import (axis_index, batch_axes, distribute_leaf,
                                   local_rows, mesh_shape_dict, pmax, psum,
                                   spec_map)
from ..optim import optimizer as opt

AUX_LOSS_WEIGHT = 0.01
Z_LOSS_WEIGHT = 1e-4


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over masked tokens + z-loss (logit-norm regularizer). A
    DTensor of logits (``Model.forward(mesh=)``) gives each rank's rows
    and vocabulary block: the module docstring's sharded loss, every rank
    holding the global means. The labels and the mask are the whole
    batch's (plain tensors, or DTensors split over the batch axes)."""
    if isinstance(logits, DTensor):
        return _sharded_cross_entropy(logits, labels, mask)
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = torch.take_along_dim(
        logits, labels[..., None].long(), dim=-1)[..., 0]
    return _means(lse - label_logit, torch.square(lse), mask)


def _means(ce, zl, mask, mesh=None, rows=()):
    """The masked means of ``ce`` and ``zl``; over ``mesh`` the sums and
    the count summed over the ``rows`` axes."""
    if mask is None:
        mask = torch.ones_like(ce)
    mask = mask.to(torch.float32)
    sums = [(ce * mask).sum(), (zl * mask).sum(), mask.sum()]
    if rows:
        sums = [psum(t, mesh, rows) for t in sums]
    denom = torch.clamp(sums[2], min=1.0)
    return sums[0] / denom, sums[1] / denom


def _sharded_cross_entropy(logits: DTensor, labels, mask):
    mesh = logits.device_mesh
    names = list(mesh.mesh_dim_names)
    last = logits.ndim - 1
    rows, vocab = [], []
    for i, p in enumerate(logits.placements):
        if p == Shard(0):
            rows.append(names[i])
        elif p == Shard(last):
            if mesh.size(i) > 1:
                vocab.append(names[i])
        elif not p.is_replicate():
            raise ValueError(f"logits under {logits.placements}: only the "
                             f"rows and the vocabulary may be split")
    if tuple(rows) != batch_axes(mesh):
        raise ValueError(f"logits' rows split over {tuple(rows)}, not the "
                         f"batch axes {batch_axes(mesh)}")
    local = logits.to_local().to(torch.float32)
    labels = local_rows(labels, mesh, 0)
    if mask is not None:
        mask = local_rows(mask, mesh, 0)
    if not vocab:
        lse = torch.logsumexp(local, dim=-1)
        label_logit = torch.take_along_dim(
            local, labels[..., None].long(), dim=-1)[..., 0]
    else:
        n = local.shape[-1]
        top = pmax(local.amax(-1), mesh, vocab)
        lse = top + torch.log(psum(torch.exp(local - top[..., None]).sum(-1),
                                   mesh, vocab))
        idx = labels.long() - axis_index(mesh, vocab) * n
        own = (idx >= 0) & (idx < n)
        got = torch.take_along_dim(local, idx.clamp(0, n - 1)[..., None],
                                   dim=-1)[..., 0]
        label_logit = psum(torch.where(own, got, 0.0), mesh, vocab)
    return _means(lse - label_logit, torch.square(lse), mask, mesh,
                  tuple(rows))


def make_loss_fn(model: Model, mesh=None, remat="save_attn"):
    def loss_fn(params, batch):
        logits, aux = model.forward(params, batch, mesh=mesh, remat=remat)
        ce, zl = cross_entropy(logits, batch["labels"],
                               batch.get("loss_mask"))
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
    the loss, which every rank holds alike, divided by the mesh's size
    (the module docstring)."""
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
