"""The dense-decoder stack: dense, gemma3 (window and rope-theta pattern)
and vlm (M-RoPE, vision-embedding scatter) families. The reference's
``lax.scan`` over stacked layers is a Python loop over the stacked
tensors' first axis; gemma3's per-layer windows and thetas are numbers
the loop hands each layer.

Public entry points (used by model.py):
  model_defs(cfg)                          parameter tree
  forward(params, cfg, batch, ...)         train-mode logits (B,S,V)
  prefill(params, cfg, batch, ...)         (last-token logits, caches)
  decode_step(params, cfg, caches, batch)  (logits, new caches)
  cache_defs(cfg, batch, skv)              decode-cache ParamDef tree

The moe, ssm, hybrid and encoder-decoder families raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from ..configs.base import ArchConfig
from . import attention as attn
from .layers import (COMPUTE_DTYPE, embed, embed_defs, mlp, mlp_defs, mrope,
                     rmsnorm, rmsnorm_def, rope, rounded, unembed)
from .param import ParamDef, map_tree

Tree = Dict[str, Any]


def check_ported(cfg: ArchConfig) -> None:
    """Raise for a family whose stack the port does not have yet."""
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: the moe family is not ported yet (ROADMAP queue 1, "
            "item 11b: models/moe.py)")
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet (ROADMAP "
            "queue 1, item 11c: models/ssm.py)")
    if cfg.enc_dec:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder family is not ported yet "
            "(ROADMAP queue 1, item 11d: whisper)")


# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------


def model_defs(cfg: ArchConfig) -> Tree:
    check_ported(cfg)
    d, layers = cfg.d_model, cfg.n_layers
    defs: Tree = embed_defs(cfg.vocab, d, cfg.tie_embeddings)
    defs["final_norm"] = rmsnorm_def(d)
    defs["layers"] = {
        "ln1": rmsnorm_def(d, layers),
        "ln2": rmsnorm_def(d, layers),
        "attn": attn.attn_defs(d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                               layers, cfg.qkv_bias),
        "mlp": mlp_defs(d, cfg.d_ff, layers),
    }
    return defs


def cache_defs(cfg: ArchConfig, batch: int, skv: int) -> Tree:
    """Decode-cache tree."""
    check_ported(cfg)
    shape = (cfg.n_layers, batch, skv, cfg.n_kv_heads, cfg.head_dim)
    kv = ("layers", "batch", "kv_seq", "kv_heads", None)
    return {"self": {
        "k": ParamDef(shape, kv, COMPUTE_DTYPE, init="zeros"),
        "v": ParamDef(shape, kv, COMPUTE_DTYPE, init="zeros"),
    }}


# ---------------------------------------------------------------------------
# Per-layer attention windows / rope thetas (gemma3 pattern)
# ---------------------------------------------------------------------------


def _is_global(cfg: ArchConfig) -> List[bool]:
    return [i % cfg.global_every == cfg.global_every - 1
            for i in range(cfg.n_layers)]


def layer_windows(cfg: ArchConfig, skv: int) -> Optional[List[int]]:
    """Per-layer window, or None when every layer is full-causal. Global
    layers get window = skv+1 (never binds)."""
    if not cfg.sliding_window or not cfg.global_every:
        return None
    return [skv + 1 if g else cfg.sliding_window for g in _is_global(cfg)]


def layer_thetas(cfg: ArchConfig) -> Optional[List[float]]:
    if cfg.global_rope_theta is None or not cfg.global_every:
        return None
    return [cfg.global_rope_theta if g else cfg.rope_theta
            for g in _is_global(cfg)]


def _layer_scalars(cfg: ArchConfig, skv: int):
    """(window or None, theta) of each layer."""
    windows = layer_windows(cfg, skv) or [None] * cfg.n_layers
    thetas = layer_thetas(cfg) or [cfg.rope_theta] * cfg.n_layers
    return list(zip(windows, thetas))


# ---------------------------------------------------------------------------
# Shared building blocks
# ---------------------------------------------------------------------------


def _apply_rope(cfg: ArchConfig, q, k, positions, theta):
    if cfg.rope_kind == "none":
        return q, k
    if cfg.rope_kind == "mrope":
        return (mrope(q, positions, cfg.rope_theta, cfg.mrope_sections),
                mrope(k, positions, cfg.rope_theta, cfg.mrope_sections))
    return rope(q, positions, theta), rope(k, positions, theta)


def _residual(x, y):
    """x + y for the ffn sublayer, in f32. The reference's compiled layer
    body (XLA on the CPU, which may keep excess precision) feeds this sum
    to the ln2 statistics unrounded and rounds it to bf16 only where it
    joins the mlp's output; rounding it first, as an eager bf16 add
    does, moves an eighth of a layer's outputs by an ulp."""
    return x.to(torch.float32) + y.to(torch.float32)


def _attn_block(lp, cfg, x, positions, theta, window, block_kv):
    """x + attention(x) as ``_residual``'s f32 sum; also returns the
    layer's rotated k and v."""
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    q, k, v = attn.qkv_proj(lp["attn"], h)
    q, k = _apply_rope(cfg, q, k, positions, theta)
    o = attn.flash_attention(q, k, v, causal=True, window=window,
                             block_kv=block_kv)
    return _residual(x, attn.out_proj(lp["attn"], o)), k, v


def _ffn_layer(lp, cfg, x):
    """x (the f32 sum of ``_residual``) + mlp(ln2(x)), in bf16."""
    h = rmsnorm(lp["ln2"], x, cfg.norm_eps, dtype=COMPUTE_DTYPE)
    return x.to(COMPUTE_DTYPE) + mlp(lp["mlp"], h, cfg.act)


def _layer(layers: Tree, i: int) -> Tree:
    """Layer i's slice of the stacked parameter (or cache) tree."""
    return map_tree(lambda a: a[i], layers)


def _scale_embed(cfg, x):
    if cfg.scale_embeddings:
        x = x * rounded(cfg.d_model ** 0.5, x.dtype)
    return x


def _embed_in(params, cfg, batch) -> torch.Tensor:
    x = _scale_embed(cfg, embed(params, batch["tokens"]))
    if cfg.family == "vlm" and "vision_embeds" in batch:
        bidx = torch.arange(x.shape[0], device=x.device)[:, None]
        x[bidx, batch["vision_positions"].long()] = \
            batch["vision_embeds"].to(x.dtype)
    return x


def _positions(cfg, batch, b, s, device):
    if cfg.rope_kind == "mrope":
        if "mrope_positions" in batch:
            return batch["mrope_positions"]
        base = torch.arange(s, device=device)[None].expand(b, s)
        return base[None].expand(3, b, s)
    if "positions" in batch:
        return batch["positions"]
    return torch.arange(s, device=device)[None].expand(b, s)


# ---------------------------------------------------------------------------
# Train-mode forward (full-sequence logits)
# ---------------------------------------------------------------------------


def forward(params, cfg: ArchConfig, batch,
            block_kv: int = attn.DEFAULT_BLOCK_KV):
    """Returns (logits (B,S,V), aux_loss scalar)."""
    check_ported(cfg)
    b, s = batch["tokens"].shape
    x = _embed_in(params, cfg, batch)
    positions = _positions(cfg, batch, b, s, x.device)
    for i, (window, theta) in enumerate(_layer_scalars(cfg, s)):
        lp = _layer(params["layers"], i)
        x, _, _ = _attn_block(lp, cfg, x, positions, theta, window, block_kv)
        x = _ffn_layer(lp, cfg, x)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return unembed(params, x), aux


# ---------------------------------------------------------------------------
# Prefill: forward pass that also emits decode caches
# ---------------------------------------------------------------------------


def prefill(params, cfg: ArchConfig, batch, skv: Optional[int] = None,
            block_kv: int = attn.DEFAULT_BLOCK_KV):
    """Returns (last-token logits (B,V), caches sized for skv)."""
    check_ported(cfg)
    b, s = batch["tokens"].shape
    skv = skv or s
    x = _embed_in(params, cfg, batch)
    positions = _positions(cfg, batch, b, s, x.device)
    ks, vs = [], []
    for i, (window, theta) in enumerate(_layer_scalars(cfg, skv)):
        lp = _layer(params["layers"], i)
        x, k, v = _attn_block(lp, cfg, x, positions, theta, window, block_kv)
        x = _ffn_layer(lp, cfg, x)
        ks.append(_pad_cache(k, skv))
        vs.append(_pad_cache(v, skv))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed(params, x[:, -1])
    return logits, {"self": {"k": torch.stack(ks), "v": torch.stack(vs)}}


def _pad_cache(k: torch.Tensor, skv: int) -> torch.Tensor:
    s = k.shape[1]
    if s != skv:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, skv - s))
    return k.to(COMPUTE_DTYPE)


# ---------------------------------------------------------------------------
# Decode: one token against seq_len caches
# ---------------------------------------------------------------------------


def decode_step(params, cfg: ArchConfig, caches, batch):
    """batch: tokens (B,1), pos (B,). Returns (logits (B,V), new caches)."""
    check_ported(cfg)
    tokens, pos = batch["tokens"], batch["pos"]
    b = tokens.shape[0]
    x = _scale_embed(cfg, embed(params, tokens))
    skv = caches["self"]["k"].shape[2]
    positions = pos[:, None]
    if cfg.rope_kind == "mrope":
        positions = pos[None, :, None].expand(3, b, 1)
    ks, vs = [], []
    for i, (window, theta) in enumerate(_layer_scalars(cfg, skv)):
        lp = _layer(params["layers"], i)
        h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
        q, k, v = attn.qkv_proj(lp["attn"], h)
        q, k = _apply_rope(cfg, q, k, positions, theta)
        kc, vc = attn.update_cache(caches["self"]["k"][i],
                                   caches["self"]["v"][i], k, v, pos)
        o = attn.decode_attention(q, kc, vc, pos, window=window)
        x = _ffn_layer(lp, cfg, _residual(x, attn.out_proj(lp["attn"], o)))
        ks.append(kc)
        vs.append(vc)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params, x[:, -1]), {
        "self": {"k": torch.stack(ks), "v": torch.stack(vs)}}
