"""Mixture-of-Experts block with sort-based (FLOP-free) dispatch, on one
device.

Each token's top-k experts come from the router; the token->expert
assignments are sorted by expert, each expert gathers its first
``capacity`` assignments into an (E, capacity, d) buffer, the expert
FFNs run as three batched products, and the gated outputs are
scatter-added back to token order. Assignments past an expert's
capacity are dropped (their rows add nothing).

Expert-count padding: the config pads E to a multiple of ``pad_to``
(granite's 40 experts to 48); padded experts get router logits of
-1e30 and are never selected.

Ambit tie-in: ``expert_bitmask_stats`` packs the assignment sets into
one bitvector an expert and popcounts them with ``BulkBitwiseEngine``:
on the card with ``BulkBitwiseEngine("cuda")`` that is one launch of
the ``popcount_rows`` kernel.

Expert parallelism over a mesh (the reference's ``shard_map`` paths) is
ROADMAP queue 1, item 12: ``moe_block`` raises when handed a mesh.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..configs.base import ArchConfig, MoEConfig
from .attention import _f32_einsum
from .layers import _act, cast
from .param import ParamDef


def padded_experts(moe: MoEConfig, pad_to: Optional[int] = None) -> int:
    pad = pad_to if pad_to is not None else moe.pad_to
    return int(math.ceil(moe.n_experts / pad) * pad)


def moe_defs(cfg: ArchConfig, layers: int, dtype=torch.float32):
    d = cfg.d_model
    moe = cfg.moe
    e = padded_experts(moe)
    ffe = moe.d_ff_expert
    return {
        "router": ParamDef((layers, d, e), ("layers", "embed", None),
                           torch.float32),
        "w1": ParamDef((layers, e, d, ffe),
                       ("layers", "expert", "embed", None), dtype),
        "w3": ParamDef((layers, e, d, ffe),
                       ("layers", "expert", "embed", None), dtype),
        "w2": ParamDef((layers, e, ffe, d),
                       ("layers", "expert", None, "embed"), dtype),
    }


def _capacity(n_tokens: int, moe: MoEConfig) -> int:
    return max(int(math.ceil(n_tokens * moe.top_k / moe.n_experts
                             * moe.capacity_factor)), moe.top_k)


def top_k(logits: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, the lower
    index first among equal values. ``torch.topk`` promises no order
    among ties, so this takes the head of a stable descending sort."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(x2d: torch.Tensor, router: torch.Tensor, moe: MoEConfig,
          e_pad: int):
    """Router logits (T, e_pad) in f32, padded experts at -1e30, and each
    token's top-k gates (softmaxed) and expert ids (T, k)."""
    logits = _f32_einsum("td,de->te", x2d, cast(router, x2d.dtype))
    if e_pad > moe.n_experts:  # mask padding experts
        pad_mask = torch.arange(e_pad, device=x2d.device) >= moe.n_experts
        logits = torch.where(pad_mask[None, :], -1e30, logits)
    gates_k, idx = top_k(logits, moe.top_k)
    return logits, torch.softmax(gates_k, dim=-1), idx


def _moe_local(x2d: torch.Tensor, router: torch.Tensor, w1: torch.Tensor,
               w3: torch.Tensor, w2: torch.Tensor, *, moe: MoEConfig,
               e_pad: int, n_local: int, e_lo: int, act: str,
               capacity: int, aux: bool = True
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x2d (T, d) -> (out (T, d), aux_loss), over experts
    ``e_lo .. e_lo + n_local - 1``; the aux loss is None unless ``aux``
    (prefill and decode discard it)."""
    t, d = x2d.shape
    k = moe.top_k
    dev = x2d.device
    logits, gates_k, idx = route(x2d, router, moe, e_pad)

    # slot-major dispatch: index from the expert buffer side
    flat_e = idx.reshape(-1)                               # (T*k,)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    flat_g = gates_k.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    starts = torch.searchsorted(se, torch.arange(e_pad + 1, device=dev))
    counts = starts[1:] - starts[:-1]                      # (e_pad,)

    e_ids = e_lo + torch.arange(n_local, device=dev)       # local experts
    slot = torch.arange(capacity, device=dev)
    src = starts[e_ids][:, None] + slot[None, :]           # (n_local, C)
    valid = slot[None, :] < counts[e_ids][:, None]
    src = torch.clamp(src, 0, t * k - 1)
    tok = st[src]                                          # (n_local, C)
    buf = x2d[tok] * valid[..., None].to(x2d.dtype)

    h = torch.matmul(buf, cast(w1, buf.dtype))             # ecd,edf->ecf
    u = torch.matmul(buf, cast(w3, buf.dtype))
    y = torch.matmul(_act(act, h) * u, cast(w2, buf.dtype))  # ecf,efd->ecd

    gate = (sg[src] * valid).to(y.dtype)                   # (n_local, C)
    rows = (y * gate[..., None]).reshape(-1, d)
    # The reference scatter-adds the rows into token order one update at
    # a time, rounding each add to x's dtype: a token's rows are summed in
    # ascending expert order. ``index_add_`` sums in f32 on the CPU and in
    # any order on the card, so each kept row goes to its own (token, j)
    # slot (dropped and padding slots to a spare row) and the k slots of
    # a token are added in that order: the same bits, deterministic.
    dest = torch.where(valid, order[src], t * k).reshape(-1)
    slab = torch.zeros((t * k + 1, d), dtype=rows.dtype, device=dev)
    slab = slab.index_copy(0, dest, rows)[:t * k].reshape(t, k, d)
    slab = torch.take_along_dim(slab, torch.argsort(idx, dim=-1)[..., None],
                                dim=1)
    out = slab[:, 0]
    for j in range(1, k):
        out = out + slab[:, j]
    if not aux:
        return out, None

    # Switch-style load-balance aux loss (computed on real experts only).
    probs = torch.softmax(logits[:, :moe.n_experts], dim=-1)
    frac = counts[:moe.n_experts].to(torch.float32) / (t * k)
    return out, moe.n_experts * torch.sum(frac * probs.mean(0))


def moe_block(p, x: torch.Tensor, cfg: ArchConfig, mesh, act: str,
              aux: bool = True
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (B,S,d) -> (out (B,S,d), aux scalar, or None unless ``aux``):
    every expert on this device, the capacity sized for all B*S
    tokens."""
    if mesh is not None:
        raise NotImplementedError(
            "moe_block over a mesh (expert parallelism) is not ported yet "
            "(ROADMAP queue 1, item 12)")
    moe = cfg.moe
    e_pad = padded_experts(moe)
    b, s, d = x.shape
    out, aux = _moe_local(x.reshape(b * s, d), p["router"], p["w1"],
                          p["w3"], p["w2"], moe=moe, e_pad=e_pad,
                          n_local=e_pad, e_lo=0, act=act,
                          capacity=_capacity(b * s, moe), aux=aux)
    return out.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# Ambit-engine dispatch bookkeeping (bulk bitwise over packed masks)
# ---------------------------------------------------------------------------


def expert_bitmask_stats(idx: torch.Tensor, n_experts: int, engine=None):
    """idx (T, k) expert assignments -> per-expert packed bitmasks + loads.

    Builds one packed bitvector per expert (bit t = expert serves token t)
    and popcounts them with the BulkBitwiseEngine (default: the ``"torch"``
    backend on ``idx``'s device, the twin of the reference's ``"jnp"``)."""
    from ..core import BitVector, BulkBitwiseEngine
    eng = engine or BulkBitwiseEngine("torch", device=idx.device)
    t, k = idx.shape
    onehot = torch.zeros((n_experts, t), dtype=torch.bool, device=idx.device)
    onehot[idx.reshape(-1).long(),
           torch.arange(t, device=idx.device).repeat_interleave(k)] = True
    masks = BitVector.from_bits(onehot)
    loads = eng.popcount(masks)
    return masks, loads
