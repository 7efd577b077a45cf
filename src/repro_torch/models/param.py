"""Parameter definition trees: one source of truth for shapes, dtypes,
logical axes, and initializers.

A model's parameters are a nested dict of ParamDef. From it we derive:
  * init_tree()    -> materialized tensors (smoke tests / real serving)
  * count_params() -> the parameter count the roofline uses
  * spec_tree()    -> PartitionSpec tree via ShardingRules (logical->mesh),
                      with automatic divisibility fallback (e.g. 2 GQA KV
                      heads cannot shard over a 16-way model axis -> None)
  * placements()   -> a spec as DTensor placements on a ``DeviceMesh``

A ``PartitionSpec`` is plain data (a tuple of ``None``, a mesh axis name
or a tuple of names, one entry a dimension), so the port's specs compare
equal to the reference's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import Replicate, Shard


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis name per dim (or None)
    dtype: torch.dtype = torch.float32
    init: str = "normal"  # normal | zeros | ones | scaled
    scale: Optional[float] = None  # stddev override for "normal"/"scaled"

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


Tree = Dict[str, Any]  # nested dict of ParamDef / subtrees


def map_tree(fn: Callable[[Any], Any], tree: Tree) -> Tree:
    if not isinstance(tree, dict):
        return fn(tree)
    return {k: map_tree(fn, v) for k, v in tree.items()}


def tree_leaves(tree: Tree) -> list:
    """The leaves of a nested dict in ``jax.tree.leaves``'s order (keys
    sorted at every level)."""
    if not isinstance(tree, dict):
        return [tree]
    return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]


def tree_unflatten(like: Tree, leaves) -> Tree:
    """A tree shaped as ``like`` holding ``leaves`` (in ``tree_leaves``
    order)."""
    it = iter(leaves)

    def build(t):
        if not isinstance(t, dict):
            return next(it)
        made = {k: build(t[k]) for k in sorted(t)}
        return {k: made[k] for k in t}

    return build(like)


def count_params(tree: Tree) -> int:
    total = 0

    def add(d: ParamDef):
        nonlocal total
        total += int(np.prod(d.shape))

    map_tree(add, tree)
    return total


def init_tree(tree: Tree, generator: torch.Generator) -> Tree:
    """Materialize parameters on ``generator``'s device: zeros, ones, or
    a normal draw times ``scale`` (default 1/sqrt(fan_in)), drawn in
    float32 and cast to the def's dtype - the reference's distribution,
    not its values (``jax.random`` and torch draw differently)."""
    return map_tree(lambda d: init_leaf(d, generator), tree)


def init_leaf(d: ParamDef, generator: torch.Generator) -> torch.Tensor:
    """One leaf of ``init_tree``, drawn from ``generator`` in its turn."""
    device = generator.device
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    std = d.scale if d.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return x.mul_(std).to(d.dtype)


# ---------------------------------------------------------------------------
# Sharding rules: logical axis -> mesh axes
# ---------------------------------------------------------------------------


class PartitionSpec(tuple):
    """One entry a tensor dimension: None (whole), a mesh axis name, or a
    tuple of names (the dimension split over their product, the first
    name major)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical->physical mapping. Tuples are mesh axis names (joined)."""

    rules: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
        ("batch", ("pod", "data")),
        ("embed", ("data",)),        # FSDP shard of weight embed dims
        ("embed_pod", ("pod", "data")),  # multi-pod FSDP variant
        ("heads", ("model",)),
        ("kv_heads", ("model",)),
        ("ffn", ("model",)),
        ("vocab", ("model",)),
        ("expert", ("model",)),
        ("seq", ()),                  # sequence parallelism off by default
        ("attn_q_seq", ("model",)),   # q-seq sharding when heads don't
                                      # divide the TP axis
        ("kv_seq", ()),               # decode-cache sequence sharding
        ("layers", ()),
        ("conv_dim", ("model",)),
        ("ssm_heads", ("model",)),
    )

    def lookup(self) -> Dict[str, Tuple[str, ...]]:
        return dict(self.rules)

    def with_overrides(self, **kw) -> "ShardingRules":
        d = self.lookup()
        for k, v in kw.items():
            d[k] = tuple(v) if v else ()
        return ShardingRules(tuple(sorted(d.items())))


def _axes_size(mesh_shape: Dict[str, int], axes: Tuple[str, ...]) -> int:
    size = 1
    for a in axes:
        size *= mesh_shape.get(a, 1)
    return size


def spec_for(d: ParamDef, rules: ShardingRules,
             mesh_shape: Dict[str, int]) -> PartitionSpec:
    """PartitionSpec for one param: apply rules with divisibility checks and
    never reuse a mesh axis across dims."""
    table = rules.lookup()
    used: set = set()
    parts = []
    for dim, logical in zip(d.shape, d.axes):
        if logical is None:
            parts.append(None)
            continue
        axes = tuple(a for a in table.get(logical, ())
                     if a in mesh_shape and a not in used)
        if not axes or dim % _axes_size(mesh_shape, axes) != 0:
            # try prefixes (e.g. ("pod","data") -> ("pod",)) before giving up
            ok = ()
            for cut in range(len(axes) - 1, 0, -1):
                sub = axes[:cut]
                if dim % _axes_size(mesh_shape, sub) == 0:
                    ok = sub
                    break
            axes = ok
        if not axes:
            parts.append(None)
        else:
            used.update(axes)
            parts.append(axes if len(axes) > 1 else axes[0])
    return PartitionSpec(*parts)


def spec_tree(tree: Tree, rules: ShardingRules,
              mesh_shape: Dict[str, int]) -> Tree:
    return map_tree(lambda d: spec_for(d, rules, mesh_shape), tree)


def logical_batch_spec(axes: Tuple[Optional[str], ...], rules: ShardingRules,
                       mesh_shape: Dict[str, int],
                       shape: Optional[Tuple[int, ...]] = None
                       ) -> PartitionSpec:
    """Spec for activations/inputs given logical axes (+ divisibility)."""
    d = ParamDef(tuple(shape) if shape else tuple(1 for _ in axes), axes)
    if shape is None:
        # without shapes we cannot check divisibility; map directly
        table = rules.lookup()
        used: set = set()
        parts = []
        for logical in axes:
            ax = tuple(a for a in table.get(logical, ())
                       if a in mesh_shape and a not in used) if logical else ()
            used.update(ax)
            parts.append(ax if len(ax) > 1 else (ax[0] if ax else None))
        return PartitionSpec(*parts)
    return spec_for(d, rules, mesh_shape)


def placements(spec, mesh) -> List[Any]:
    """``spec`` as DTensor placements on ``mesh`` (one a mesh dimension):
    ``Shard(d)`` on each mesh axis that splits tensor dimension d,
    ``Replicate()`` on the others. A dimension split over several axes is
    ``Shard(d)`` on each of them; DTensor orders such shards by mesh
    dimension, so the spec must list them in the mesh's order (the
    default rules always do)."""
    names = list(mesh.mesh_dim_names)
    out: List[Any] = [Replicate() for _ in names]
    for dim, part in enumerate(spec):
        if part is None:
            continue
        axes = (part,) if isinstance(part, str) else tuple(part)
        where = [names.index(a) for a in axes]
        if where != sorted(where):
            raise ValueError(f"spec {tuple(spec)} splits dimension {dim} "
                             f"over {axes}, out of the mesh's order {names}")
        for i in where:
            out[i] = Shard(dim)
    return out
