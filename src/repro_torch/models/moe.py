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

Over a mesh (the reference's ``shard_map`` paths, written per rank:
``x`` is the rank's rows of the batch, each weight a ``LocalShard`` that
the branch gathers as far as it needs):

* EP over ``"model"``: each rank runs the dispatch on its own rows for
  its ``E / n_model`` experts, the partial outputs are summed over
  ``"model"`` and the aux loss averaged over ``"model"``, then over the
  batch axes. Where the experts' spec splits them over ``"model"`` (the
  default rules), a rank's shard is its own experts' block, gathered
  only over the other axes;
* 2-D EP (the expert padding equals ``n_data * n_model`` and the whole
  batch has at most 4096 tokens): the tokens are all-gathered over the
  batch axes, each rank runs the one expert slot
  ``data_rank * n_model + model_rank`` on its first ``capacity``
  assignments, the outputs are summed over ``("data", "model")`` and each
  rank takes its rows back. Under the 2-D EP serving rules
  (``launch.dryrun.sharding_rules_for(..., ep2d=True)``) an expert
  weight is stationary: its expert dimension is split by ``Shard(0)``
  over ``"data"`` and then ``"model"``, it is replicated over any other
  axis and no other dimension is split, so the rank's ``(1, d, f)``
  block is that slot's expert, taken with no collective, and its
  gradient stays on the rank (summed over ``"pod"`` where that axis
  holds it alike). Any other layout (the default rules' experts over
  ``"model"`` with ``embed`` over ``"data"``, say) is gathered whole at
  use and the slot's expert taken from it, where the reference's
  partitioner reshards it to the ``shard_map``'s spec;
* a mesh with no ``"model"`` axis (or one of size 1) runs the
  single-device dispatch on the whole batch, all-gathered over the
  batch axes, and takes this rank's rows, as the reference's partitioner
  does with its one-shard math.

Every collective carries its gradient (``sharding_ctx``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard

from ..configs.base import ArchConfig, MoEConfig
from .attention import _f32_einsum
from .layers import _act, cast
from .param import ParamDef
from .sharding_ctx import (LocalShard, all_gather, axis_index, batch_axes,
                           checked_mesh, gather_param, gathered,
                           mesh_axis_size, pmean, psum)


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


def _moe_ep2d(x, router, w1, w3, w2, *, moe: MoEConfig, e_pad: int,
              act: str, capacity: int, mesh, b_axes: Tuple[str, ...],
              mine: int, aux: bool = True):
    """2-D expert-parallel path: the rank's rows x (bl, S, d) gathered
    over the batch axes; this rank runs its expert ``mine`` (``w1``,
    ``w3``, ``w2`` are that expert's (d, f), (d, f) and (f, d) weights)
    on its first ``capacity`` assignments (a stable sort puts them
    first); the partial outputs are summed over ``("data", "model")``
    and the rank's rows come back (batch-major order)."""
    bl, s, d = x.shape
    x_all = all_gather(x.reshape(bl * s, d), mesh, b_axes, 0)
    t = x_all.shape[0]
    k = moe.top_k
    dev = x.device
    logits, gates_k, idx = route(x_all, router, moe, e_pad)

    flat_e = idx.reshape(-1)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    flat_g = gates_k.reshape(-1)
    match = flat_e == mine
    order = torch.argsort((~match).to(torch.int8), stable=True)
    sel = order[:capacity]
    valid = match[sel]
    tok = flat_t[sel]
    buf = x_all[tok] * valid[:, None].to(x_all.dtype)      # (C, d)

    h = buf @ cast(w1, buf.dtype)
    u = buf @ cast(w3, buf.dtype)
    y = (_act(act, h) * u) @ cast(w2, buf.dtype)
    gate = (flat_g[sel] * valid).to(y.dtype)
    partial = torch.zeros((t, d), dtype=x_all.dtype, device=dev).index_add(
        0, tok, y * gate[:, None])
    out = psum(partial, mesh, ("data", "model"))
    rows = bl * s
    out_loc = out[axis_index(mesh, b_axes) * rows:][:rows]
    if not aux:
        return out_loc.reshape(bl, s, d), None

    probs = torch.softmax(logits[:, :moe.n_experts], dim=-1)
    counts = torch.zeros((e_pad,), dtype=torch.float32, device=dev) \
        .index_add(0, flat_e, torch.ones_like(flat_e, dtype=torch.float32))
    frac = counts[:moe.n_experts] / (t * k)
    return (out_loc.reshape(bl, s, d),
            moe.n_experts * torch.sum(frac * probs.mean(0)))


def _own_experts(w, mesh, e_lo: int, n_local: int) -> torch.Tensor:
    """Experts ``e_lo .. e_lo + n_local - 1`` of an expert-stacked
    weight, for EP over ``"model"``. A shard whose expert dimension is
    split over ``"model"`` alone is this rank's block already: it is
    gathered over the other axes only, and its gradient stays on this
    rank. Any other weight is gathered whole and sliced."""
    if isinstance(w, LocalShard):
        dims = list(mesh.mesh_dim_names)
        on_experts = [i for i, p in enumerate(w.placements)
                      if getattr(p, "dim", None) == 0]
        if on_experts == [dims.index("model")]:
            return gather_param(w.local, w.mesh, w.placements,
                                keep=("model",))
    return gathered(w)[e_lo:e_lo + n_local]


def _slot_expert(w, mine: int) -> torch.Tensor:
    """Expert ``mine`` of an expert-stacked weight, for the 2-D EP path.
    A ``LocalShard`` that lies as the 2-D EP serving rules place it (its
    expert dimension split by ``Shard(0)`` over ``"data"`` and then
    ``"model"``, in mesh order, and replicated over every other axis) is
    this rank's own ``(1, d, f)`` block: DTensor's nested ``Shard(0)``
    gives rank ``(d, m)`` chunk ``d * n_model + m``, which is ``mine``.
    It is taken with no collective, its gradient summed over the axes
    that hold it alike (``gather_param``). Any other weight is gathered
    whole and indexed."""
    if isinstance(w, LocalShard):
        names = list(w.mesh.mesh_dim_names)
        want = [Shard(0) if n in ("data", "model") else Replicate()
                for n in names]
        if names.index("data") < names.index("model") and \
                list(w.placements) == want:
            return gather_param(w.local, w.mesh, w.placements,
                                keep=("data", "model"))[0]
    return gathered(w)[mine]


def moe_block(p, x: torch.Tensor, cfg: ArchConfig, mesh, act: str,
              aux: bool = True
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (B,S,d) -> (out (B,S,d), aux scalar, or None unless ``aux``).
    Without a mesh every expert runs here, the capacity sized for all
    B*S tokens; over a mesh x is this rank's rows, ``p``'s leaves may be
    ``LocalShard``s, and the reference's branch for the mesh runs (the
    module docstring)."""
    moe = cfg.moe
    e_pad = padded_experts(moe)
    b, s, d = x.shape
    names = () if checked_mesh(mesh) is None else tuple(mesh.mesh_dim_names)
    b_axes = batch_axes(mesh) if names else ()
    n_batch = mesh_axis_size(mesh, b_axes) if b_axes else 1
    n_model = mesh_axis_size(mesh, "model") if "model" in names else 1
    router = gathered(p["router"])

    if n_model == 1:
        x2 = x.reshape(b * s, d)
        if b_axes:      # the reference's one-shard math on every row
            x2 = all_gather(x2, mesh, b_axes, 0)
        w1, w3, w2 = (gathered(p[n]) for n in ("w1", "w3", "w2"))
        out, aux = _moe_local(x2, router, w1, w3, w2, moe=moe, e_pad=e_pad,
                              n_local=e_pad, e_lo=0, act=act,
                              capacity=_capacity(x2.shape[0], moe), aux=aux)
        if b_axes:
            out = out[axis_index(mesh, b_axes) * b * s:][:b * s]
        return out.reshape(b, s, d), aux

    n_data = mesh_axis_size(mesh, "data") if "data" in names else 1
    if e_pad == n_data * n_model and b * n_batch * s <= 4096 and \
            "data" in names:
        mine = axis_index(mesh, ("data", "model"))
        w1, w3, w2 = (_slot_expert(p[n], mine) for n in ("w1", "w3", "w2"))
        return _moe_ep2d(x, router, w1, w3, w2, moe=moe, e_pad=e_pad,
                         act=act,
                         capacity=max(_capacity(b * n_batch * s, moe), 8),
                         mesh=mesh, b_axes=b_axes, mine=mine, aux=aux)

    # expert parallelism over "model": this rank's experts, its own rows
    if e_pad % n_model:
        raise ValueError(f"{e_pad} experts do not split over a {n_model}-way "
                         f"model axis (pad them: MoEConfig.pad_to)")
    n_local = e_pad // n_model
    e_lo = mesh.get_local_rank("model") * n_local
    w1, w3, w2 = (_own_experts(p[n], mesh, e_lo, n_local)
                  for n in ("w1", "w3", "w2"))
    out, aux = _moe_local(x.reshape(b * s, d), router, w1, w3, w2, moe=moe,
                          e_pad=e_pad, n_local=n_local, e_lo=e_lo, act=act,
                          capacity=_capacity(b * s, moe), aux=aux)
    out = psum(out, mesh, "model")
    if aux is not None:
        aux = pmean(aux, mesh, "model")
        if b_axes:
            aux = pmean(aux, mesh, b_axes)
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
