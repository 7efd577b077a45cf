"""Parameter definition trees: one source of truth for shapes, dtypes,
logical axes, and initializers.

A model's parameters are a nested dict of ParamDef. From it we derive:
  * init_tree()    -> materialized tensors (smoke tests / real serving)
  * count_params() -> the parameter count the roofline uses

``axes`` names each dimension's logical axis, kept as data: the port runs
on one device, where every axis is whole. Mapping them onto a mesh
(``ShardingRules``, ``spec_tree``) is ROADMAP queue 1, item 12.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch


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
    device = generator.device

    def make(d: ParamDef):
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=d.dtype, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=d.dtype, device=device)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale if d.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
        x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return x.mul_(std).to(d.dtype)

    return map_tree(make, tree)
