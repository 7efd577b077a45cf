"""Pipeline parallelism (GPipe-style) over a mesh axis, per rank.

On the multi-pod mesh the "pod" axis can host pipeline stages instead
of data parallelism - stage s holds layers [s*L/S, (s+1)*L/S);
microbatches stream through with the classic (n_micro + n_stages - 1)-
tick schedule; inter-stage activations move by one neighbour hop per
tick (a send to stage s+1 and a receive from s-1: neighbour traffic
only, the cross-pod link topology, where all-reduce bandwidth is
scarcest).

The stage function must be shape-preserving ((mb, ...) -> (mb, ...)),
which transformer blocks satisfy. Differentiable end to end: the hop's
backward sends the gradient to stage s-1, so it composes with autograd
for training. Every rank gets the same outputs; each rank backpropagates
its own copy of a loss taken from them, and the gradient enters the
pipeline on the last stage from that stage's own copy (the outputs are
one value, not a sum of the ranks' copies), so each stage's parameters
receive the gradient of the loss. Bubble fraction = (S-1)/(T+S-1); pick
n_micro >> n_stages.

The stacked stage parameters come in either of two forms. As the
reference shards them (``in_specs`` ``P(axis)``): DTensors placed
``Shard(0)`` over ``axis`` and ``Replicate`` over every other axis, so
that a rank holds its own stage's ``(1, ...)`` block alone; it reads
that block's ``[0]`` with no gather, and its gradient lands on the
block, a DTensor under the parameter's placements. Or as plain tensors
that every rank holds whole and alike, of which a rank slices its
stage; each rank's gradient is then nonzero on its stage's slice only.
The stage function is generic, as the reference's is: it receives its
stage's leaves and is not tied to the decoder stacks.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..models.param import map_tree, tree_leaves
from ..models.sharding_ctx import mesh_axis_size


class _FromLast(torch.autograd.Function):
    """The last stage's outputs on every rank of the stage group (a sum
    in which the other stages add zeros); the gradient passes straight
    back to each rank's own contribution. Every hop's output is an input
    too (its gradient here is zero): so every rank's backward runs every
    hop's, and each send of a gradient meets its receive."""

    @staticmethod
    def forward(ctx, out, group, *hops):
        ctx.hops = [(h.shape, h.dtype, h.device) for h in hops]
        out = out.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g, None) + tuple(torch.zeros(shape, dtype=dtype, device=dev)
                                 for shape, dtype, dev in ctx.hops)


class _Hop(torch.autograd.Function):
    """y on stage s goes to stage s+1; what stage s-1 sent comes back
    (zeros on stage 0). The backward moves the gradient the other way.
    ``anchor`` (a tensor that requires grad while training) makes every
    tick's hop differentiable, a bubble's zeros too."""

    @staticmethod
    def forward(ctx, y, anchor, group, s, n):
        ctx.group, ctx.s, ctx.n = group, s, n
        return _exchange(y.contiguous(), group, s, n, +1)

    @staticmethod
    def backward(ctx, g):
        return (_exchange(g.contiguous(), ctx.group, ctx.s, ctx.n, -1),
                None, None, None, None)


def _exchange(x: torch.Tensor, group, s: int, n: int, step: int):
    """Send x to stage s+step and receive the tensor stage s-step sends
    (zeros where there is no such stage)."""
    out = torch.zeros_like(x)
    ops = []
    if 0 <= s + step < n:
        ops.append(dist.P2POp(dist.isend, x,
                              dist.get_global_rank(group, s + step), group))
    if 0 <= s - step < n:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, s - step), group))
    for work in dist.batch_isend_irecv(ops) if ops else ():
        work.wait()
    return out


def pipeline(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
             stage_params: Any, x_micro: torch.Tensor, mesh,
             axis: str = "pod") -> torch.Tensor:
    """Run x_micro (n_micro, mb, ...) through n_stages = the size of
    ``axis`` pipeline stages. stage_params leaves are stacked
    (n_stages, ...): DTensors placed ``Shard(0)`` over ``axis`` (a rank
    reads its own block) or plain tensors held alike by every rank
    (a rank slices its stage); a leading dimension other than n_stages
    raises. Returns the (n_micro, mb, ...) outputs on every
    rank. Each rank runs its own stage: at tick t it takes microbatch
    t - s (stage 0 from x_micro, the others from the hop), and the last
    stage's outputs are shared over the stage group. Ticks in the bubble
    (no microbatch at this stage) compute nothing and send zeros."""
    n_stages = mesh_axis_size(mesh, axis)
    n_micro = x_micro.shape[0]
    s = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    last = n_stages - 1
    params_here = map_tree(lambda a: _stage_of(a, mesh, axis, n_stages, s),
                           stage_params)
    anchor = next((a for a in tree_leaves(params_here) + [x_micro]
                   if a.requires_grad), x_micro)

    cur = torch.zeros_like(x_micro[0])
    outputs, hops = [], []
    for t in range(n_micro + n_stages - 1):
        m = t - s                      # the microbatch at this stage now
        if 0 <= m < n_micro:
            y = stage_fn(params_here, x_micro[m] if s == 0 else cur)
            if s == last:
                outputs.append(y)
        else:
            y = torch.zeros_like(cur)
        if n_stages > 1:
            cur = _Hop.apply(y, anchor, group, s, n_stages)
            hops.append(cur)
    out = torch.stack(outputs) if s == last else torch.zeros_like(x_micro)
    return _FromLast.apply(out, group, *hops)


def _stage_of(a: torch.Tensor, mesh, axis: str, n_stages: int,
              s: int) -> torch.Tensor:
    """Stage ``s``'s parameters of a stacked leaf: a DTensor's own
    ``(1, ...)`` block's ``[0]`` (no collective), a plain tensor's
    ``[s]``."""
    if a.shape[0] != n_stages:
        raise ValueError(f"a stage parameter of shape {tuple(a.shape)} "
                         f"does not stack {n_stages} stages along its "
                         f"first dimension")
    if not isinstance(a, DTensor):
        return a[s]
    names = list(a.device_mesh.mesh_dim_names)
    want = [Shard(0) if n == axis else Replicate() for n in names]
    if a.device_mesh != mesh or list(a.placements) != want:
        raise ValueError(f"a stage parameter of shape {tuple(a.shape)} "
                         f"lies under {tuple(a.placements)} on "
                         f"{tuple(names)}: the pipeline takes Shard(0) "
                         f"over {axis!r} and Replicate elsewhere")
    return a.to_local()[0]


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    """Idle fraction of the GPipe schedule."""
    total = n_micro + n_stages - 1
    return (n_stages - 1) / total
