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
its placements. A layer takes each leaf as ``tp_leaf`` gives it: gathered
over every axis it is not computed on (the FSDP split of ``embed`` over
``"data"``), and kept as this rank's block where ``"model"`` splits the
dimension the layer computes on (``heads``, ``kv_heads``, ``ffn``,
``vocab``: tensor parallelism). A product over such a block is
column-parallel (the output dimension split, no collective) or
row-parallel (the contracted dimension split, ``row_parallel``: one
``psum`` over ``"model"``). The backward of a gather sums each rank's
gradient into its shard, and a leaf every ``"model"`` rank holds alike
has its ranks' partial gradients summed (``gather_param``). ``gathered``
makes a whole parameter of a shard, for the leaves whose spec does not
split them over ``"model"`` (the norms). ``shard_map`` runs a function on
each rank's local tensors.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, \
    Union

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


def current_rules() -> ShardingRules:
    """The ambient rules, or the default ones outside a context."""
    ctx = _CTX.get()
    return ShardingRules() if ctx is None else ctx[0]


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


def rule_axes(logical: str, mesh) -> Tuple[str, ...]:
    """The axes of ``mesh`` that the ambient rules (the default ones
    outside a context) map ``logical`` to."""
    return tuple(a for a in current_rules().lookup().get(logical, ())
                 if a in mesh.mesh_dim_names)


def batch_axes(mesh) -> Tuple[str, ...]:
    """The mesh axes the batch splits over: those of the ambient rules'
    ``"batch"`` axis that the mesh has (``("pod", "data")`` outside a
    context, as the default rules map it). Rules that map the batch to
    no axis (the dry-run's batch-1 cells) leave every rank the whole
    batch."""
    return rule_axes("batch", mesh)


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


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _gather_into(out, x, group=group)
    if dim == 0:
        return out
    shape = list(x.shape)
    shape[dim] *= n
    return out.view((n,) + tuple(x.shape)).movedim(0, dim).reshape(shape)


class _AllGather(torch.autograd.Function):
    """Concatenate each rank's ``x`` along ``dim`` in group-rank order;
    the adjoint reduce-scatters the gradient. The ranks' blocks are
    gathered stacked, so only a dimension past the first costs one more
    copy."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

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


def pmax(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks along ``axes``
    (``lax.pmax``), as a constant: a softmax's shift, which its gradient
    does not depend on."""
    x = x.detach()
    for a in _names(axes):
        if mesh_axis_size(mesh, a) > 1:
            x = x.contiguous().clone()
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.get_group(a))
    return x


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


# ---------------------------------------------------------------------------
# Tensor parallelism over "model"
# ---------------------------------------------------------------------------

TP = "model"


def tp_size(mesh) -> int:
    """The number of ranks along ``"model"`` (1 without a mesh or one)."""
    if mesh is None or TP not in mesh.mesh_dim_names:
        return 1
    return mesh_axis_size(mesh, TP)


class TPLeaf(NamedTuple):
    """A leaf as a layer computes on it: ``t`` is this rank's block ``r``
    of ``n`` along the dimension the layer computes on (``n == 1``: the
    whole leaf), gathered over every other axis; ``mesh`` is None for a
    plain tensor."""
    t: torch.Tensor
    n: int
    r: int
    mesh: Any


def tp_blocks(x, dim: int) -> int:
    """How many blocks ``"model"`` splits dimension ``dim`` of ``x`` (a
    ``LocalShard`` or a plain tensor) into, read from its placements.
    Raises where ``"model"`` splits another dimension, or where another
    axis splits ``dim`` with it: a layout no layer computes on."""
    if not isinstance(x, LocalShard):
        return 1
    names = list(x.mesh.mesh_dim_names)
    n = 1
    for i, p in enumerate(x.placements):
        if not isinstance(p, Shard) or x.mesh.size(i) == 1:
            continue
        if names[i] == TP and p.dim != dim:
            raise ValueError(f"'model' splits dimension {p.dim} of a leaf "
                             f"computed on its dimension {dim}")
        if names[i] == TP:
            n = x.mesh.size(i)
    if n > 1 and any(isinstance(p, Shard) and p.dim == dim and
                     names[i] != TP and x.mesh.size(i) > 1
                     for i, p in enumerate(x.placements)):
        raise ValueError(f"dimension {dim} is split over 'model' and "
                         f"another axis: {x.placements}")
    return n


def tp_leaf(x, dim: int) -> TPLeaf:
    """``x`` (a ``LocalShard``, or a plain tensor every rank holds alike)
    for a layer that computes on its dimension ``dim``: gathered over
    every axis but a ``"model"`` split of ``dim``, which stays this
    rank's block (its gradient stays here). A leaf that ``"model"`` does
    not split is gathered whole, and the backward sums the ``"model"``
    ranks' partial gradients of it (``gather_param``)."""
    if not isinstance(x, LocalShard):
        return TPLeaf(x, 1, 0, None)
    n = tp_blocks(x, dim)
    if n == 1:
        return TPLeaf(gather_param(x.local, x.mesh, x.placements), 1, 0,
                      x.mesh)
    return TPLeaf(gather_param(x.local, x.mesh, x.placements, keep=(TP,)),
                  n, x.mesh.get_local_rank(TP), x.mesh)


class _MeanGrad(torch.autograd.Function):
    """Identity forward; the gradient averaged over a group, in f32: where
    a value every rank of the group holds alike enters each rank's own
    share of a layer (Megatron's "f"), whose gradients differ."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        dtype = g.dtype
        g = g.to(torch.float32).contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return (g / dist.get_world_size(ctx.group)).to(dtype), None


def tp_in(x: torch.Tensor, mesh, f32: bool = False) -> torch.Tensor:
    """``x``, held alike by the ``"model"`` ranks, as the input of their
    own shares of a computation: its gradient is the ranks' mean
    (``_MeanGrad``; over one rank, ``x`` as it is), so that every rank
    holds the same share of it. With ``f32`` x comes as an f32 tensor of
    its values, whose gradient the ranks sum in f32 before the cast back
    rounds it once, as the mesh-free computation rounds its own sum."""
    if tp_size(mesh) == 1:
        return x
    if f32:
        x = x.to(torch.float32)
    return _MeanGrad.apply(x, mesh.get_group(TP))


class _ColumnIn(torch.autograd.Function):
    """``x @ w`` of ``x``, held alike by the group's ranks, and this
    rank's columns ``w``: the mesh-free layer's product, column for
    column. The backward gives x the gradient the mesh-free product gives
    it, divided by the group's size: the ranks' f32 products of their
    columns summed over the group, then rounded once. So every rank holds
    the same gradient of x, whose sum over the ranks is the whole
    gradient (``_AddPsum`` relies on it)."""

    @staticmethod
    def forward(ctx, x, w, group):
        ctx.save_for_backward(x, w)
        ctx.group = group
        return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = g.to(torch.float32) @ w.to(torch.float32).T
        dist.all_reduce(dx, group=ctx.group)
        dx = (dx / dist.get_world_size(ctx.group)).to(x.dtype)
        dw = x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return dx, dw, None


def column_in(x: torch.Tensor, w: torch.Tensor, mesh) -> torch.Tensor:
    """``x @ w``: over a mesh with more than one ``"model"`` rank, this
    rank's columns of a product whose columns the ranks share out
    (``_ColumnIn``); else (``mesh`` None) the plain product."""
    if tp_size(mesh) == 1:
        return x @ w
    return _ColumnIn.apply(x, w, mesh.get_group(TP))


class _RowsIn(torch.autograd.Function):
    """This rank's block of rows (along ``dim``) of a tensor every rank of
    the group holds alike; the backward gathers every rank's rows'
    gradient and divides it by the group's size, so that every rank
    holds the same share of the whole gradient."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n = dist.get_world_size(group)
        rows = x.shape[dim] // n
        return x.narrow(dim, dist.get_rank(group) * rows, rows).clone()

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        return _gather(g, ctx.group, ctx.dim) / n, None, None


def rows_in(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """``_RowsIn`` over ``"model"``: this rank's block of x's rows."""
    return _RowsIn.apply(x, dim, mesh.get_group(TP))


class _KvShare(torch.autograd.Function):
    """Identity forward on this rank's run ``lo .. lo + n - 1`` of the kv
    heads (dimension -2) of a tensor of ``kv`` heads. The backward sums
    each kv head's gradient over the ranks whose query heads read it, in
    f32 and rounded once, as the mesh-free attention's
    ``repeat_interleave`` sums its query heads', and divides it by the
    number of ranks that hold the head, so that their shares sum to
    it."""

    @staticmethod
    def forward(ctx, t, lo, kv, holders, group):
        ctx.lo, ctx.kv, ctx.holders, ctx.group = lo, kv, holders, group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[-2]
        full = g.new_zeros(g.shape[:-2] + (ctx.kv, g.shape[-1]),
                           dtype=torch.float32)
        full.narrow(-2, ctx.lo, n).copy_(g)
        dist.all_reduce(full, group=ctx.group)
        per = torch.tensor(ctx.holders[ctx.lo:ctx.lo + n], dtype=g.dtype,
                           device=g.device)
        mine = full.narrow(-2, ctx.lo, n).to(g.dtype)
        return mine / per[:, None], None, None, None, None


def kv_share(t: torch.Tensor, lo: int, kv: int, holders, mesh
             ) -> torch.Tensor:
    """``_KvShare`` of ``t`` over ``"model"``; ``holders[h]`` is the number
    of ranks holding kv head ``h``."""
    return _KvShare.apply(t, lo, kv, list(holders), mesh.get_group(TP))


class _RowWeight(torch.autograd.Function):
    """``a * w`` with ``w`` cast to a's dtype and broadcast over a's
    leading dimensions: the mesh-free layer's product. The backward gives
    ``w`` the sum over this rank's rows of the bf16 products of the
    mesh-free backward, in f32 and unrounded: the ranks' sums (the
    adjoint of ``gather_param``) then add up to what the mesh-free
    backward sums over every row before it rounds once, where the sum of
    each rank's rounded partial sum may not (a sum near zero rounds to
    zero on one rank, and its update changes sign)."""

    @staticmethod
    def forward(ctx, a, w):
        wc = w.to(a.dtype)
        ctx.save_for_backward(a, wc)
        ctx.dtype = w.dtype
        return a * wc

    @staticmethod
    def backward(ctx, g):
        a, wc = ctx.saved_tensors
        gw = (g * a).to(torch.float32).reshape((-1,) + tuple(wc.shape)) \
            .sum(0)
        return g * wc, gw.to(ctx.dtype)


def row_weight(a: torch.Tensor, w: torch.Tensor, mesh=None) -> torch.Tensor:
    """``a * w`` (``w`` cast to a's dtype) for a weight ``w`` that every
    rank of ``mesh`` holds alike and whose gradient sums over the rows:
    over more than one rank ``_RowWeight``, else the plain product."""
    if mesh is None or mesh.size() == 1:
        return a * w.to(a.dtype)
    return _RowWeight.apply(a, w)


class _RepeatIn(torch.autograd.Function):
    """``t`` (.., groups, n), held alike by the group's ranks, with each
    group repeated ``rep`` times along dimension -2 for this rank's heads
    (``repeat_interleave``). The backward sums the heads' gradients of a
    group in f32, over this rank's heads and then over the ranks, and
    rounds the sum divided by the group's size once: the mesh-free
    repeat over every head sums its bf16 gradients in f32 and rounds
    once, and every rank holds the same share of it."""

    @staticmethod
    def forward(ctx, t, rep, group):
        ctx.rep, ctx.group = rep, group
        return t.repeat_interleave(rep, dim=-2)

    @staticmethod
    def backward(ctx, g):
        shape = g.shape[:-2] + (g.shape[-2] // ctx.rep, ctx.rep, g.shape[-1])
        total = g.to(torch.float32).reshape(shape).sum(-2)
        dist.all_reduce(total, group=ctx.group)
        return (total / dist.get_world_size(ctx.group)).to(g.dtype), None, \
            None


def repeat_in(t: torch.Tensor, rep: int, mesh) -> torch.Tensor:
    """``_RepeatIn`` of ``t`` over ``"model"``; over one rank (or without a
    mesh) ``t`` as it is, for the caller to repeat."""
    if tp_size(mesh) == 1:
        return t
    return _RepeatIn.apply(t, rep, mesh.get_group(TP))


class _AddPsum(torch.autograd.Function):
    """``res + psum(part)`` with the sum rounded to ``dtype`` first: a
    row-parallel product joining the residual stream. The stream's
    gradient is the same on every rank (each rank's own share of a layer
    takes the stream through ``column_in``, ``rows_in`` or ``tp_in``), so
    the all-reduce's adjoint, the sum of the ranks' gradients, is ``n``
    times this rank's: the backward moves nothing."""

    @staticmethod
    def forward(ctx, res, part, group, dtype):
        ctx.dtype, ctx.n = dtype, dist.get_world_size(group)
        y = part.contiguous().clone()
        dist.all_reduce(y, group=group)
        return res + y.to(dtype).to(res.dtype)

    @staticmethod
    def backward(ctx, g):
        # the sum's gradient as the mesh-free layer's bf16 product gets it
        return g, g.to(ctx.dtype).to(torch.float32) * ctx.n, None, None


def row_parallel(x: torch.Tensor, w: torch.Tensor, leaf: TPLeaf,
                 res: Optional[torch.Tensor] = None, res_dtype=None
                 ) -> torch.Tensor:
    """``x @ w`` in x's dtype (plus ``res``, the residual stream, when
    given: both cast to ``res_dtype`` and summed in it), where ``leaf``
    says how ``"model"`` splits the contracted dimension: whole, the
    plain product; split (x and w this rank's blocks), the f32 products
    of the bf16 blocks summed over ``"model"`` and rounded once (the
    mesh-free product rounds its own f32 sum once), joined to ``res`` by
    ``_AddPsum``."""
    w = w.to(x.dtype)
    if leaf.n == 1:
        y = x @ w
        return y if res is None else res.to(res_dtype) + y.to(res_dtype)
    part = x.to(torch.float32) @ w.to(torch.float32)
    if res is None:
        return psum(part, leaf.mesh, TP).to(x.dtype)
    return _AddPsum.apply(res.to(res_dtype), part, leaf.mesh.get_group(TP),
                          x.dtype)


def local_rows(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """This rank's rows of ``x`` along ``dim`` (the batch split over the
    batch axes, the first axis major), as a plain tensor. A plain ``x``
    is the whole batch, held alike by every rank. A DTensor is gathered
    whole along every split but the batch axes' split of ``dim``; where
    it does not split ``dim`` over exactly the batch axes, its rows are
    then cut as a plain tensor's are."""
    axes = batch_axes(mesh)
    if isinstance(x, DTensor):
        names, pl = list(mesh.mesh_dim_names), list(x.placements)
        split = tuple(a for a, p in zip(names, pl) if p == Shard(dim))
        if split == axes:
            return gather_param(x.to_local(), mesh, pl, keep=axes)
        x = gather_param(x.to_local(), mesh, pl)
    if not axes:
        return x
    n = mesh_axis_size(mesh, axes)
    if x.shape[dim] % n:
        raise ValueError(f"a batch of {x.shape[dim]} does not split over "
                         f"{n} ranks of {axes}")
    rows = x.shape[dim] // n
    return x.narrow(dim, axis_index(mesh, axes) * rows, rows)


def rows_dtensor(local: torch.Tensor, mesh, vocab_blocks: int = 1
                 ) -> DTensor:
    """``local`` (this rank's rows along dim 0, and its block of the last
    dimension when ``vocab_blocks`` > 1) as a DTensor: the rows split
    over the batch axes, the last dimension over ``"model"``."""
    axes = batch_axes(mesh)
    last = local.ndim - 1
    pl = [Shard(0) if a in axes else
          Shard(last) if a == TP and vocab_blocks > 1 else Replicate()
          for a in mesh.mesh_dim_names]
    shape = list(local.shape)
    shape[0] *= mesh_axis_size(mesh, axes) if axes else 1
    shape[last] *= vocab_blocks
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.insert(0, acc)
        acc *= n
    return tuple(stride)


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
