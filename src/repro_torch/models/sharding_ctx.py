"""Ambient activation-sharding hints, and the per-rank collectives of the
mesh paths.

``axis_rules(rules, mesh_shape)`` sets the logical->mesh mapping for the
code inside it; ``axis_size`` reads it (1 outside), and the attention
chooses its layouts by it, as the reference does. ``hint(x,
*logical_axes)`` redistributes a DTensor to the spec those axes give;
outside a context, and on a plain tensor, it returns ``x`` untouched. The
port's mesh forward computes on plain per-rank tensors, so there the
hints are no-ops, kept where the reference anchors its layouts.

The mesh paths are per-rank code with explicit collectives over the
groups of a ``DeviceMesh``'s axes (``psum``, ``all_gather``), each a
``torch.autograd.Function`` whose backward is the collective's adjoint:
the sum of a gradient over the ranks for an all-reduce, a reduce-scatter
for an all-gather. ``LocalShard`` is a rank's shard of a parameter with
its placements, and ``gathered`` makes the whole parameter of it: its
backward sums each rank's gradient into the shard, so a rank that used
the whole weight hands back only its shard's gradient, summed over every
rank that used it. ``shard_map`` runs a function on each rank's local
tensors.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from .param import (ParamDef, PartitionSpec, ShardingRules, map_tree,
                    placements, spec_for)

_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_axis_rules", default=None)

Axes = Union[str, Sequence[str]]


@contextlib.contextmanager
def axis_rules(rules: ShardingRules, mesh_shape: Dict[str, int]):
    token = _CTX.set((rules, dict(mesh_shape)))
    try:
        yield
    finally:
        _CTX.reset(token)


def axis_size(logical: str) -> int:
    """Product of mesh-axis sizes the logical axis maps to (1 if no ctx)."""
    ctx = _CTX.get()
    if ctx is None:
        return 1
    rules, mesh_shape = ctx
    size = 1
    for a in rules.lookup().get(logical, ()):
        size *= mesh_shape.get(a, 1)
    return size


def hint(x, *axes: Optional[str]):
    """Constrain activation x to the logical axes (None = replicated dim).
    Applies the same divisibility fallbacks as parameter sharding. A
    DTensor is redistributed onto those placements; a plain tensor, a
    rank's own rows, is returned as it is."""
    ctx = _CTX.get()
    if ctx is None:
        return x
    rules, mesh_shape = ctx
    if len(axes) != x.ndim:
        raise ValueError(f"hint axes {axes} vs shape {tuple(x.shape)}")
    if not isinstance(x, DTensor):
        return x
    spec = spec_for(ParamDef(tuple(x.shape), tuple(axes)), rules, mesh_shape)
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def hint_tree(tree, axes_fn):
    """Apply hints across a tree; axes_fn(leaf) -> logical axes."""
    return map_tree(lambda l: hint(l, *axes_fn(l)), tree)


# ---------------------------------------------------------------------------
# Mesh axes and per-rank collectives
# ---------------------------------------------------------------------------


def checked_mesh(mesh):
    """``mesh`` when it is None or a ``DeviceMesh``; else TypeError."""
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch DeviceMesh, not "
                        f"{type(mesh).__name__}")
    return mesh


def mesh_shape_dict(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def batch_axes(mesh) -> Tuple[str, ...]:
    """The mesh axes the batch splits over: those of the ambient rules'
    ``"batch"`` axis that the mesh has (``("pod", "data")`` outside a
    context, as the default rules map it). Rules that map the batch to
    no axis (the dry-run's batch-1 cells) leave every rank the whole
    batch."""
    ctx = _CTX.get()
    axes = ("pod", "data") if ctx is None else \
        ctx[0].lookup().get("batch", ())
    return tuple(a for a in axes if a in mesh.mesh_dim_names)


def _names(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def mesh_axis_size(mesh, axes: Axes) -> int:
    """The number of ranks along ``axes`` (their product)."""
    dims = list(mesh.mesh_dim_names)
    size = 1
    for a in _names(axes):
        size *= int(mesh.mesh.shape[dims.index(a)])
    return size


def axis_index(mesh, axes: Axes) -> int:
    """This rank's position along ``axes``, the first axis major."""
    idx = 0
    for a in _names(axes):
        idx = idx * mesh_axis_size(mesh, a) + mesh.get_local_rank(a)
    return idx


# the single-tensor collectives under their current names (older torch
# has only the ``*_tensor`` ones)
_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_scatter_into = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


class _AllReduce(torch.autograd.Function):
    """Sum over a group; the adjoint sums the gradient over it too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SumGrad(torch.autograd.Function):
    """Identity forward; the gradient summed over a group (a value each
    rank of the group holds alike and uses on its own)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    """Concatenate each rank's ``x`` along ``dim`` in group-rank order;
    the adjoint reduce-scatters the gradient. The ranks' blocks are
    gathered stacked, so only a dimension past the first costs one more
    copy."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = dist.get_world_size(group)
        x = x.contiguous()
        out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        _gather_into(out, x, group=group)
        if dim == 0:
            return out
        shape = list(x.shape)
        shape[dim] *= n
        return out.view((n,) + tuple(x.shape)).movedim(0, dim) \
            .reshape(shape)

    @staticmethod
    def backward(ctx, g):
        n, dim = dist.get_world_size(ctx.group), ctx.dim
        shape = list(g.shape)
        shape[dim] //= n
        if dim == 0:
            blocks = g.contiguous()
        else:
            blocks = g.reshape(shape[:dim] + [n] + shape[dim:]) \
                .movedim(dim, 0).reshape([n * shape[0]] + shape[1:])
        out = torch.empty(shape, dtype=g.dtype, device=g.device)
        _scatter_into(out, blocks, group=ctx.group)
        return out, None, None


def psum(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """Sum ``x`` over the ranks along ``axes`` (``lax.psum``); an axis of
    one rank leaves ``x`` as it is."""
    for a in _names(axes):
        if mesh_axis_size(mesh, a) > 1:
            x = _AllReduce.apply(x, mesh.get_group(a))
    return x


def pmean(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    return psum(x, mesh, axes) / mesh_axis_size(mesh, axes)


def all_gather(x: torch.Tensor, mesh, axes: Axes, dim: int = 0
               ) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` over ``axes``, the
    first axis major (``lax.all_gather(..., tiled=True)``); an axis of
    one rank leaves ``x`` as it is."""
    for a in reversed(_names(axes)):
        if mesh_axis_size(mesh, a) > 1:
            x = _AllGather.apply(x, mesh.get_group(a), dim)
    return x


class LocalShard:
    """A rank's shard of a parameter: its local tensor, the mesh and the
    placements it lies under. Indexing takes a slice of the leading
    (unsharded) dimension, as a layer of a stacked leaf."""

    __slots__ = ("local", "mesh", "placements")

    def __init__(self, local: torch.Tensor, mesh, placements_: List[Any]):
        self.local, self.mesh, self.placements = local, mesh, placements_

    @classmethod
    def of(cls, x, mesh) -> "LocalShard":
        """A DTensor's shard, or a plain tensor as held alike by every
        rank of ``mesh``."""
        if isinstance(x, DTensor):
            return cls(x.to_local(), x.device_mesh, list(x.placements))
        return cls(x, mesh, [Replicate()] * mesh.ndim)

    def _inner(self) -> List[Any]:
        if any(isinstance(p, Shard) and p.dim == 0 for p in self.placements):
            raise ValueError("a stacked leaf split over its leading "
                             "(layer) dimension cannot be taken a layer at "
                             "a time")
        return [Shard(p.dim - 1) if isinstance(p, Shard) else p
                for p in self.placements]

    def __getitem__(self, i: int) -> "LocalShard":
        return LocalShard(self.local[i], self.mesh, self._inner())

    def unbind(self) -> List["LocalShard"]:
        inner = self._inner()
        return [LocalShard(t, self.mesh, inner)
                for t in torch.unbind(self.local)]


def gather_param(local: torch.Tensor, mesh, placements_,
                 keep: Tuple[str, ...] = ()) -> torch.Tensor:
    """The whole parameter from each rank's shard: all-gathered along
    each mesh dimension that splits it (the last mesh dimension first, so
    a dimension split over several mesh axes comes back in mesh order).
    The backward sums every rank's gradient into its shard: a
    reduce-scatter over each splitting axis, an all-reduce over each
    axis that holds the shard alike. A mesh dimension of one rank, or
    one named in ``keep`` (its ranks use their own blocks, as expert
    parallelism does), is left as the shard has it."""
    x = local
    for i in reversed(range(mesh.ndim)):
        if mesh.size(i) == 1 or mesh.mesh_dim_names[i] in keep:
            continue
        group = mesh.get_group(i)
        p = placements_[i]
        if isinstance(p, Shard):
            x = _AllGather.apply(x, group, p.dim)
        else:
            x = _SumGrad.apply(x, group)
    return x


def gathered(x):
    """A ``LocalShard``'s whole parameter as a plain tensor
    (``gather_param``); a plain tensor as it is."""
    if isinstance(x, LocalShard):
        return gather_param(x.local, x.mesh, x.placements)
    return x


def gathered_tree(tree):
    return map_tree(gathered, tree)


def whole(x):
    """A DTensor gathered whole as a plain tensor (``gather_param`` over
    its splits); a plain tensor, or None, as it is."""
    if isinstance(x, DTensor):
        return gather_param(x.to_local(), x.device_mesh, list(x.placements))
    return x


def local_shards(tree, mesh):
    """Each leaf as ``LocalShard.of`` it on ``mesh``."""
    return map_tree(lambda x: LocalShard.of(x, mesh), tree)


def distribute(tree, mesh, specs):
    """Each leaf of ``tree`` (whole, and alike on every rank) as a
    DTensor holding this rank's shard under its spec's placements, on the
    mesh's device. A spec may stand for a whole subtree."""
    return spec_map(lambda x, spec: distribute_leaf(x, mesh, spec), tree,
                    specs)


def distribute_leaf(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """``x`` (whole, and alike on every rank) as a DTensor of this rank's
    shard, cut here with no collective. A shard that is a part of ``x``
    is copied out once, so that it does not keep ``x``'s storage alive;
    a shard that is all of ``x`` is ``x``."""
    x = x.to(mesh.device_type)
    local = _block(x, spec, mesh)
    if local.numel() < x.numel():
        local = local.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=x.shape,
                              stride=x.stride())


# ---------------------------------------------------------------------------
# shard_map
# ---------------------------------------------------------------------------


def _block(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of a tensor every rank holds alike."""
    for dim, part in enumerate(spec):
        if part is None:
            continue
        n = mesh_axis_size(mesh, part)
        size = x.shape[dim] // n
        x = x.narrow(dim, axis_index(mesh, part) * size, size)
    return x


def spec_map(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree``; a spec stands for the whole
    subtree under it."""
    if isinstance(specs, PartitionSpec):
        if isinstance(tree, dict):
            return {k: spec_map(fn, v, specs) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(spec_map(fn, t, specs) for t in tree)
        return fn(tree, specs)
    if isinstance(specs, dict):
        return {k: spec_map(fn, tree[k], specs[k]) for k in tree}
    return type(tree)(spec_map(fn, t, s) for t, s in zip(tree, specs))


def shard_map(fn, mesh, in_specs, out_specs, check: bool = False):
    """Run ``fn`` on each rank's local tensors: a DTensor argument is
    redistributed to its spec's placements and taken local, a plain one
    (held alike by every rank) is cut to this rank's block. Each output
    is wrapped as a DTensor under its spec. A spec may stand for a whole
    subtree (specs are ``PartitionSpec``s). ``check`` is accepted for
    the reference's signature."""
    del check

    def local(x, spec):
        if isinstance(x, DTensor):
            return x.redistribute(mesh, placements(spec, mesh)).to_local()
        return _block(x, spec, mesh)

    def wrap(y, spec):
        return DTensor.from_local(y, mesh, placements(spec, mesh),
                                  run_check=False)

    def run(*args):
        args = [spec_map(local, a, s) for a, s in zip(args, in_specs)]
        return spec_map(wrap, fn(*args), out_specs)

    return run
