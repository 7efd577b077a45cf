"""Public model API: build_model(cfg) -> Model with init / forward /
prefill / decode plus parameter-count accounting used by the roofline
(MODEL_FLOPS = 6*N*D, 2*N_active per decoded token).

``Model`` is an ``nn.Module`` that holds the parameter tree it was given
(``init`` or ``load``) under the reference's nested keys and stacked
shapes, so ``model.params`` carries across key for key. Its compute
methods take the tree explicitly, as the reference's do. They take
``mesh=`` (a ``DeviceMesh``) as the reference's do: each rank computes
its share of the batch as the reference's rules place it (its rows, and
over ``"model"`` its heads, FFN columns, vocabulary block and cache
block), and the logits come back as a DTensor (``transformer``'s
docstring).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..core.bitvector import resolve_device
from . import transformer
from .moe import padded_experts
from .param import (ShardingRules, Tree, count_params, init_tree, map_tree,
                    spec_tree)
from .sharding_ctx import checked_mesh


def _module_of(tree: Tree) -> nn.Module:
    m = nn.Module()
    for k, v in tree.items():
        if isinstance(v, dict):
            m.add_module(k, _module_of(v))
        else:
            m.register_parameter(k, nn.Parameter(v, requires_grad=False))
    return m


def _tree_of(m: nn.Module) -> Tree:
    out: Tree = {k: p for k, p in m.named_parameters(recurse=False)}
    out.update({k: _tree_of(c) for k, c in m.named_children()})
    return out


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        self.weights: Optional[nn.Module] = None

    # -- parameters -----------------------------------------------------------

    def param_defs(self) -> Tree:
        return transformer.model_defs(self.cfg)

    def init(self, seed: int = 0, device=None) -> Tree:
        """Draw the parameters from a generator seeded with ``seed`` on
        ``device`` (the card unless named), hold them and return them."""
        gen = torch.Generator(resolve_device(device)).manual_seed(seed)
        return self.load(init_tree(self.param_defs(), gen))

    def load(self, params: Tree) -> Tree:
        """Hold ``params`` (checked against ``param_defs``, key for key and
        shape for shape) and return them."""
        shapes = map_tree(lambda d: tuple(d.shape), self.param_defs())
        got = map_tree(lambda a: tuple(a.shape), params)
        if got != shapes:
            raise ValueError(f"{self.cfg.name}: parameter tree {got} does "
                             f"not match the model's {shapes}")
        self.weights = _module_of(params)
        return params

    @property
    def params(self) -> Tree:
        if self.weights is None:
            raise ValueError("no parameters: call init or load first")
        return _tree_of(self.weights)

    def param_specs(self, rules: ShardingRules, mesh_shape: Dict[str, int]
                    ) -> Tree:
        return spec_tree(self.param_defs(), rules, mesh_shape)

    def n_params(self) -> int:
        return count_params(self.param_defs())

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top_k of E experts)."""
        cfg = self.cfg
        if cfg.moe is None:
            return self.n_params()
        moe_defs = self.param_defs()["layers"]["moe"]
        moe_total = count_params(moe_defs) - count_params(
            {"router": moe_defs["router"]})
        active = moe_total * cfg.moe.top_k / padded_experts(cfg.moe)
        return int(self.n_params() - moe_total + active)

    # -- compute --------------------------------------------------------------

    def forward(self, params: Tree, batch, mesh=None, remat=False):
        """Train-mode logits and aux loss; ``remat`` is the reference's
        (False, True or ``"save_attn"``; ``transformer.forward``)."""
        return transformer.forward(params, self.cfg, batch, remat=remat,
                                   mesh=checked_mesh(mesh))

    def prefill(self, params: Tree, batch, skv: Optional[int] = None,
                mesh=None):
        return transformer.prefill(params, self.cfg, batch, skv=skv,
                                   mesh=checked_mesh(mesh))

    def decode_step(self, params: Tree, caches: Tree, batch, mesh=None):
        return transformer.decode_step(params, self.cfg, caches, batch,
                                       mesh=checked_mesh(mesh))

    def cache_defs(self, batch: int, skv: int) -> Tree:
        return transformer.cache_defs(self.cfg, batch, skv)

    def cache_specs(self, batch: int, skv: int, rules: ShardingRules,
                    mesh_shape: Dict[str, int]) -> Tree:
        return spec_tree(self.cache_defs(batch, skv), rules, mesh_shape)

    def init_cache(self, batch: int, skv: int, device=None) -> Tree:
        dev = resolve_device(device)
        return map_tree(lambda d: torch.zeros(d.shape, dtype=d.dtype,
                                              device=dev),
                        self.cache_defs(batch, skv))


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
