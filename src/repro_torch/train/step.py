"""Training step builder: loss, grads, microbatch accumulation, optimizer.

``make_train_step(model, opt_cfg, ...)`` returns a step function
``(state, batch) -> (state, metrics)``. Gradients come from
``torch.autograd.grad`` of the loss on the parameter tree's leaves (taken
as detached aliases that require grad, so no ``.grad`` is left behind);
``optim.update`` then writes the new parameters and moments into the
state's own tensors.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..models.model import Model
from ..models.param import tree_leaves, tree_unflatten
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
        ce, zl = cross_entropy(logits, batch["labels"],
                               batch.get("loss_mask"))
        loss = ce + AUX_LOSS_WEIGHT * aux + Z_LOSS_WEIGHT * zl
        metrics = {"loss": loss, "ce": ce, "aux": aux, "ppl_log": ce}
        return loss, metrics

    return loss_fn


def init_state(model: Model, seed: int = 0, device=None) -> Dict[str, Any]:
    """Parameters drawn from ``seed`` on ``device`` (the card unless
    named) and zero optimizer state."""
    params = model.init(seed, device=device)
    return {"params": params, "opt": opt.init(params)}


def value_and_grad(loss_fn, params, batch):
    """``jax.value_and_grad(loss_fn, has_aux=True)``: ((loss, metrics),
    grads), the metrics detached."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_unflatten(params, grads)


def make_train_step(model: Model, opt_cfg: opt.OptimizerConfig, mesh=None,
                    remat="save_attn", microbatches: int = 1):
    loss_fn = make_loss_fn(model, mesh=mesh, remat=remat)

    def train_step(state, batch):
        params = state["params"]
        if microbatches <= 1:
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
        else:
            def split(x, i):
                mb = x.shape[0] // microbatches
                return x[i * mb:(i + 1) * mb]

            g_acc = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)
                     for p in tree_leaves(params)]
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=g_acc[0].device)
            for i in range(microbatches):
                mb = {k: split(v, i) for k, v in batch.items()}
                (loss, _m), g = value_and_grad(loss_fn, params, mb)
                for a, b in zip(g_acc, tree_leaves(g)):
                    a.add_(b.to(torch.float32))
                loss_sum = loss_sum + loss
                del g
            grads = tree_unflatten(params, [g / microbatches for g in g_acc])
            loss = loss_sum / microbatches
            zero = torch.zeros((), dtype=torch.float32, device=loss.device)
            metrics = {"loss": loss, "ce": loss, "aux": zero,
                       "ppl_log": loss}
        new_params, new_opt, opt_metrics = opt.update(
            opt_cfg, grads, state["opt"], params)
        metrics.update(opt_metrics)
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step
