"""Attention: chunked flash attention (training/prefill) + cached decode.

Flash attention walks the KV blocks with an online softmax (running max /
normalizer / accumulator in f32), so the S x S score matrix is never
materialized. Masks (causal / sliding-window / full) are computed from
position arithmetic inside each block; ``window`` is a per-layer number
so heterogeneous stacks (gemma3's 5:1 local:global pattern) run one body.

Over a mesh the callers hand these functions a rank's share: its query
heads with the kv heads they read (``heads_for``), its block of query
rows (``q_offset``), or its block of a decode cache split over the
sequence (``decode_attention_block``, joined by ``decode_combine``).

Plain PyTorch, as the reference is plain ``jnp``. A bf16 x bf16 product
the reference accumulates in f32 (``preferred_element_type``) runs here
on f32 copies of its operands: products of bf16 values are exact in f32,
so only the order of the f32 sums differs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .layers import cast
from .param import ParamDef
from .sharding_ctx import axis_size, hint, pmax, psum

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
DEFAULT_BLOCK_KV = 1024


def attn_defs(d: int, n_heads: int, n_kv: int, d_head: int, layers: int,
              qkv_bias: bool = False, dtype=torch.float32):
    defs = {
        "wq": ParamDef((layers, d, n_heads, d_head),
                       ("layers", "embed", "heads", None), dtype),
        "wk": ParamDef((layers, d, n_kv, d_head),
                       ("layers", "embed", "kv_heads", None), dtype),
        "wv": ParamDef((layers, d, n_kv, d_head),
                       ("layers", "embed", "kv_heads", None), dtype),
        "wo": ParamDef((layers, n_heads, d_head, d),
                       ("layers", "heads", None, "embed"), dtype),
    }
    if qkv_bias:
        defs["bq"] = ParamDef((layers, n_heads, d_head),
                              ("layers", "heads", None), dtype, init="zeros")
        defs["bk"] = ParamDef((layers, n_kv, d_head),
                              ("layers", "kv_heads", None), dtype,
                              init="zeros")
        defs["bv"] = ParamDef((layers, n_kv, d_head),
                              ("layers", "kv_heads", None), dtype,
                              init="zeros")
    return defs


def _proj(x, w):
    """einsum("bsd,dhe->bshe") as one (B*S, d) x (d, h*e) product."""
    d, h, e = w.shape
    return (x @ cast(w, x.dtype).reshape(d, h * e)).reshape(
        x.shape[:-1] + (h, e))


def qkv_proj(p, x):
    """x (B,S,d) -> q (B,S,Hq,D), k,v (B,S,Hkv,D)."""
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q = q + cast(p["bq"], x.dtype)
        k = k + cast(p["bk"], x.dtype)
        v = v + cast(p["bv"], x.dtype)
    return q, k, v


def out_proj(p, o):
    """einsum("bshe,hed->bsd")."""
    h, e, d = p["wo"].shape
    return o.reshape(o.shape[:-2] + (h * e,)) @ cast(
        p["wo"], o.dtype).reshape(h * e, d)


def _f32_einsum(spec: str, *operands):
    """``einsum`` with ``preferred_element_type=float32``."""
    return torch.einsum(spec, *(o.to(torch.float32) for o in operands))


# ---------------------------------------------------------------------------
# Flash attention (training / prefill)
# ---------------------------------------------------------------------------


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0,
                    block_kv: int = DEFAULT_BLOCK_KV,
                    p_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Online-softmax attention over KV blocks.

    q: (B,Sq,Hq,D); k,v: (B,Skv,Hkv,D); Hq % Hkv == 0.
    window: attend only to kv in (q_pos - window, q_pos]; None = unbounded
    (plain causal/full). KV heads are repeated to Hq first, as in the
    reference. The probabilities are cast to ``p_dtype`` (v's dtype
    unless named) for the PV product.
    """
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if hkv != hq:
        k = torch.repeat_interleave(k, hq // hkv, dim=2)
        v = torch.repeat_interleave(v, hq // hkv, dim=2)
    scale = 1.0 / (d ** 0.5)

    # The reference's layout anchors: when the head count does not
    # divide the TP axis, the q sequence shards over "model" instead.
    heads_sharded = hq % axis_size("heads") == 0
    if heads_sharded:
        q_axes = ("batch", "seq", "heads", None)
        c_axes = ("batch", "heads", "seq")
    else:
        q_axes = ("batch", "attn_q_seq", None, None)
        c_axes = ("batch", None, "attn_q_seq")
    kv_heads = "heads" if heads_sharded else None
    q = hint(q, *q_axes)
    k = hint(k, "batch", "seq", kv_heads, None)
    v = hint(v, "batch", "seq", kv_heads, None)

    bk = min(block_kv, skv)
    pad = (-skv) % bk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    nb = (skv + pad) // bk
    dev = q.device
    q_pos = q_offset + torch.arange(sq, device=dev)
    m = hint(torch.full((b, hq, sq), NEG_INF, dtype=torch.float32,
                        device=dev), *c_axes)
    l = hint(torch.zeros((b, hq, sq), dtype=torch.float32, device=dev),
             *c_axes)
    acc = hint(torch.zeros((b, hq, sq, d), dtype=torch.float32, device=dev),
               *c_axes, None)
    for idx in range(nb):
        kblk = k[:, idx * bk:(idx + 1) * bk]
        vblk = v[:, idx * bk:(idx + 1) * bk]
        s = _f32_einsum("bqhd,bkhd->bhqk", q, kblk) * scale
        kv_pos = idx * bk + torch.arange(bk, device=dev)
        mask = (kv_pos[None, :] < skv).expand(sq, bk)  # padded tail
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        if window is not None:
            mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(mask[None, None, :, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = _f32_einsum("bhqk,bkhd->bhqd", p.to(p_dtype or vblk.dtype),
                         vblk)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.transpose(1, 2).to(q.dtype)


# ---------------------------------------------------------------------------
# Cached decode (one new token against a seq_len cache)
# ---------------------------------------------------------------------------


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor,
                     window: Optional[int] = None) -> torch.Tensor:
    """q (B,1,Hq,D); caches (B,Skv,Hkv,D); pos (B,) = index of the new token
    (entries kv_pos <= pos are valid). Single-pass softmax over the cache,
    GQA in grouped form (the cache is read once, not Hq/Hkv times)."""
    m, l, o = decode_attention_block(q, k_cache, v_cache, pos, window)
    return decode_output(o, l, q)


def decode_attention_block(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos: torch.Tensor,
                           window: Optional[int] = None, kv_offset: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """``decode_attention`` over a block of the cache whose first position
    is ``kv_offset``, unnormalized: its f32 max (B,Hkv,G,1), normalizer
    (B,Hkv,G) and PV sum (B,Hkv,G,D). The blocks of a cache split over its
    sequence join by a max and two sums (``decode_combine``)."""
    b, _, hq, d = q.shape
    skv, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    qg = q[:, 0].reshape(b, hkv, g, d)
    scale = 1.0 / (d ** 0.5)
    s = _f32_einsum("bhgd,bkhd->bhgk", qg, k_cache) * scale
    # scores follow the cache's seq sharding (the reference's anchor)
    if axis_size("kv_seq") > 1:
        s = hint(s, "batch", None, None, "kv_seq")
    else:
        s = hint(s, "batch", "kv_heads", None, "kv_seq")
    kv_pos = torch.arange(kv_offset, kv_offset + skv, device=q.device)
    mask = kv_pos[None, :] <= pos[:, None]  # (B,Skv)
    if window is not None:
        mask = mask & (kv_pos[None, :] > (pos[:, None] - window))
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    # flash_attention's accumulation order: the unnormalized exp cast to
    # the cache dtype, f32 PV, the f32 normalizer divided in last
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1)
    o = _f32_einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype), v_cache)
    return m, l, o


def decode_output(o: torch.Tensor, l: torch.Tensor, q: torch.Tensor
                  ) -> torch.Tensor:
    """The normalized output (B,1,Hq,D) of a PV sum and its normalizer."""
    b, _, hq, d = q.shape
    o = o / torch.clamp(l, min=1e-20)[..., None]
    return o.reshape(b, 1, hq, d).to(q.dtype)


def decode_combine(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                   mesh, axes) -> Tuple[torch.Tensor, torch.Tensor]:
    """The normalizer and PV sum of the whole sequence from each rank's
    block (``decode_attention_block``) over the ranks along ``axes``: the
    blocks' max, then the sums rescaled to it (the split-K softmax). A
    block with no valid position has the max ``NEG_INF`` and adds
    nothing."""
    top = pmax(m, mesh, axes)
    c = torch.exp(m - top)
    return psum(l * c[..., 0], mesh, axes), psum(o * c, mesh, axes)


def heads_for(k: torch.Tensor, kv_lo: int, q_lo: int, n_q: int,
              group: int) -> torch.Tensor:
    """The kv heads that query heads ``q_lo .. q_lo + n_q - 1`` read (head
    ``j`` reads kv head ``j // group``), from ``k`` (B,S,Hk,D) whose first
    head is kv head ``kv_lo``: the reference's repeat-then-shard. A
    contiguous run each query head's group finds in order is a view
    (the attention repeats it); else the heads are picked one a query
    head."""
    ids = [j // group - kv_lo for j in range(q_lo, q_lo + n_q)]
    if ids[0] < 0 or ids[-1] >= k.shape[2]:
        raise ValueError(f"query heads {q_lo}..{q_lo + n_q - 1} read kv "
                         f"heads this rank does not hold")
    n_kv = ids[-1] - ids[0] + 1
    if n_q % n_kv == 0 and ids == [ids[0] + i // (n_q // n_kv)
                                   for i in range(n_q)]:
        return k.narrow(2, ids[0], n_kv)
    return k.index_select(2, torch.tensor(ids, device=k.device))


def update_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Insert one token's K/V at per-sequence positions. caches
    (B,Skv,Hkv,D); k_new/v_new (B,1,Hkv,D); pos (B,). A masked
    elementwise write into new tensors, as the reference's."""
    skv = k_cache.shape[1]
    sel = (torch.arange(skv, device=pos.device)[None, :]
           == pos[:, None])[..., None, None]
    k_cache = torch.where(sel, k_new.to(k_cache.dtype), k_cache)
    v_cache = torch.where(sel, v_new.to(v_cache.dtype), v_cache)
    return k_cache, v_cache
