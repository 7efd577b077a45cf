"""Family stacks: dense / MoE / VLM decoders, SSM (Mamba2), hybrid
(Zamba2), and encoder-decoder (Whisper). The reference's ``lax.scan``
over stacked layers is a Python loop over the stacked tensors' first
axis; gemma3's per-layer windows and thetas are numbers the loop hands
each layer, and zamba2's shared block runs after each group of
``shared_attn_every`` layers.

Public entry points (used by model.py):
  model_defs(cfg)                          parameter tree
  forward(params, cfg, batch, remat, ...)  train-mode logits (B,S,V)
  prefill(params, cfg, batch, ...)         (last-token logits, caches)
  decode_step(params, cfg, caches, batch)  (logits, new caches)
  cache_defs(cfg, batch, skv)              decode-cache ParamDef tree

The train-mode forward takes the reference's ``remat``: False, True
(each layer under ``torch.utils.checkpoint``: its activations are
recomputed in the backward) or ``"save_attn"`` (the decoder layer's
attention core and the rest of the layer are checkpointed apart, so the
attention output is kept across the boundary as the reference's
``checkpoint_name(o, "attn_out")`` policy keeps it; a layer with no
attention is recomputed whole, as under that policy).

Over a mesh (``mesh=``, a ``DeviceMesh``), each rank computes its rows
of the global batch (split over ``sharding_ctx.batch_axes``: ``("pod",
"data")``, the first axis major, unless the ambient rules map the batch
elsewhere) on plain tensors. A batch entry or a cache is the whole
batch's plain tensor, held alike by every rank, or a DTensor (as the
dry-run's in-shardings give them): a split over other axes is gathered
whole at each use. Each parameter leaf is a DTensor under its
``spec_for`` placements, or a plain tensor every rank holds alike; a
layer gathers the whole of each leaf it uses inside its own body (so
``remat`` recomputes the gathers and no gathered weight outlives its
layer), and the gather's backward hands each rank its shard's gradient,
summed over the ranks that used it. MoE layers run the reference's
expert-parallel branches (``moe.moe_block``). The logits come back whole
on every rank (all-gathered over the batch axes); caches come back as
DTensors split over the batch axes. Ranks along ``"model"`` compute the
same rows, so a loss taken from the logits is backpropagated divided by
the mesh's size (``train.step.value_and_grad``), which makes the sum of
the ranks' gradients the gradient of the loss.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import (COMPUTE_DTYPE, cast, embed, embed_defs, mlp, mlp_defs,
                     mrope, rmsnorm, rmsnorm_def, rope, rounded,
                     sinusoidal_positions, unembed)
from .param import ParamDef, map_tree
from .sharding_ctx import (LocalShard, all_gather, axis_index, batch_axes,
                           gather_param, gathered, gathered_tree, hint,
                           local_shards, mesh_axis_size)

Tree = Dict[str, Any]


# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------


def _decoder_layer_defs(cfg: ArchConfig, layers: int) -> Tree:
    d = cfg.d_model
    defs: Tree = {
        "ln1": rmsnorm_def(d, layers),
        "ln2": rmsnorm_def(d, layers),
        "attn": attn.attn_defs(d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                               layers, cfg.qkv_bias),
    }
    if cfg.moe is not None:
        defs["moe"] = moe_mod.moe_defs(cfg, layers)
    else:
        defs["mlp"] = mlp_defs(d, cfg.d_ff, layers)
    return defs


def model_defs(cfg: ArchConfig) -> Tree:
    d = cfg.d_model
    defs: Tree = embed_defs(cfg.vocab, d, cfg.tie_embeddings)
    defs["final_norm"] = rmsnorm_def(d)

    if cfg.family == "ssm":
        defs["layers"] = dict(ssm_mod.ssm_defs(cfg, cfg.n_layers))
        defs["layers"]["ln"] = rmsnorm_def(d, cfg.n_layers)
    elif cfg.family == "hybrid":
        defs["layers"] = dict(ssm_mod.ssm_defs(cfg, cfg.n_layers))
        defs["layers"]["ln"] = rmsnorm_def(d, cfg.n_layers)
        defs["shared"] = {
            "ln1": rmsnorm_def(d), "ln2": rmsnorm_def(d),
            "attn": attn.attn_defs(d, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim, 1, cfg.qkv_bias),
            "mlp": mlp_defs(d, cfg.d_ff, 1),
        }
    elif cfg.enc_dec:
        defs["enc_layers"] = {
            "ln1": rmsnorm_def(d, cfg.n_enc_layers),
            "ln2": rmsnorm_def(d, cfg.n_enc_layers),
            "attn": attn.attn_defs(d, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim, cfg.n_enc_layers),
            "mlp": mlp_defs(d, cfg.d_ff, cfg.n_enc_layers),
        }
        defs["enc_norm"] = rmsnorm_def(d)
        dec = _decoder_layer_defs(cfg, cfg.n_layers)
        dec["ln3"] = rmsnorm_def(d, cfg.n_layers)
        dec["cross"] = attn.attn_defs(d, cfg.n_heads, cfg.n_kv_heads,
                                      cfg.head_dim, cfg.n_layers)
        defs["layers"] = dec
    else:  # dense / moe / vlm decoders
        defs["layers"] = _decoder_layer_defs(cfg, cfg.n_layers)
    return defs


def cache_defs(cfg: ArchConfig, batch: int, skv: int) -> Tree:
    """Decode-cache tree."""
    kv = ("layers", "batch", "kv_seq", "kv_heads", None)

    def kv_pair(layers: int, length: int) -> Tree:
        shape = (layers, batch, length, cfg.n_kv_heads, cfg.head_dim)
        return {"k": ParamDef(shape, kv, COMPUTE_DTYPE, init="zeros"),
                "v": ParamDef(shape, kv, COMPUTE_DTYPE, init="zeros")}

    if cfg.family == "ssm":
        return {"ssm": ssm_mod.ssm_cache_defs(cfg, cfg.n_layers, batch)}
    if cfg.family == "hybrid":
        n_shared = cfg.n_layers // cfg.shared_attn_every
        return {
            "ssm": ssm_mod.ssm_cache_defs(cfg, cfg.n_layers, batch),
            "shared": kv_pair(n_shared, skv),
        }
    if cfg.enc_dec:
        return {
            "self": kv_pair(cfg.n_layers, skv),
            "cross": kv_pair(cfg.n_layers, cfg.n_frames),
        }
    return {"self": kv_pair(cfg.n_layers, skv)}


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


def _attn_core(lp, cfg, x, positions, theta, window, block_kv):
    """The attention output o (before ``out_proj``) and the layer's
    rotated k and v."""
    x = hint(x, "batch", "seq", None)
    h = rmsnorm(gathered(lp["ln1"]), x, cfg.norm_eps)
    q, k, v = attn.qkv_proj({n: gathered(w) for n, w in lp["attn"].items()
                             if n != "wo"}, h)
    q, k = _apply_rope(cfg, q, k, positions, theta)
    o = attn.flash_attention(q, k, v, causal=True, window=window,
                             block_kv=block_kv)
    return o, k, v


def _attn_block(lp, cfg, x, positions, theta, window, block_kv):
    """x + attention(x) as ``_residual``'s f32 sum; also returns the
    layer's rotated k and v."""
    o, k, v = _attn_core(lp, cfg, x, positions, theta, window, block_kv)
    return _residual(x, _out_proj(lp["attn"], o)), k, v


def _out_proj(pa, o):
    return attn.out_proj({"wo": gathered(pa["wo"])}, o)


def _ffn_layer(lp, cfg, x, auxes=None, mesh=None):
    """x (the f32 sum of ``_residual``) + mlp(ln2(x)) or moe(ln2(x)), in
    bf16. An MoE layer appends its aux loss to ``auxes`` when given (the
    forward sums them; prefill and decode compute none)."""
    x = hint(x, "batch", "seq", None)
    h = rmsnorm(gathered(lp["ln2"]), x, cfg.norm_eps, dtype=COMPUTE_DTYPE)
    if cfg.moe is None:
        y = mlp(gathered_tree(lp["mlp"]), h, cfg.act)
    else:
        y, aux = moe_mod.moe_block(lp["moe"], h, cfg, mesh, cfg.act,
                                   aux=auxes is not None)
        if auxes is not None:
            auxes.append(aux)
    return x.to(COMPUTE_DTYPE) + y


def _zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=device)


def _layer(layers: Tree, i: int) -> Tree:
    """Layer i's slice of the stacked parameter (or cache) tree."""
    return map_tree(lambda a: a[i], layers)


def _layers(layers: Tree, n: int) -> List[Tree]:
    """Every layer's slice of the stacked parameter tree, from one
    ``torch.unbind`` a leaf: the same views as ``_layer``'s, but under
    autograd each leaf's gradient is stacked once, where the backward of
    ``a[i]`` adds a zero-filled copy of the whole stacked leaf a layer."""
    parts = map_tree(_unbind, layers)
    return [map_tree(lambda t: t[i], parts) for i in range(n)]


def _unbind(a):
    return a.unbind() if isinstance(a, LocalShard) else torch.unbind(a)


def _top(params) -> Tree:
    """The unstacked leaves (embedding, norms) gathered whole; the
    stacked layer trees as they are."""
    return {k: v if k in _STACKED else gathered_tree(v)
            for k, v in params.items()}


_STACKED = ("layers", "enc_layers", "shared")
# batch entries whose batch dimension is not the first
_BATCH_DIM = {"mrope_positions": 1}


def _local_rows(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """This rank's rows of ``x`` along ``dim`` (the batch split over the
    batch axes, the first axis major), as a plain tensor. A plain ``x``
    is the whole batch, held alike by every rank. A DTensor is gathered
    whole along every split but the batch axes' split of ``dim`` (a
    decode cache split over its sequence is gathered whole at each use);
    where it does not split ``dim`` over exactly the batch axes, its
    rows are then cut as a plain tensor's are."""
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


def _on_mesh(params, batch, mesh):
    """Each leaf as a ``LocalShard``, and this rank's rows of the batch."""
    local = {k: _local_rows(v, mesh, _BATCH_DIM.get(k, 0))
             if isinstance(v, torch.Tensor) else v for k, v in batch.items()}
    return local_shards(params, mesh), local


def _whole_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's rows of ``x``, in batch order."""
    axes = batch_axes(mesh)
    return all_gather(x, mesh, axes, 0) if axes else x


def _cache_shards(caches, mesh):
    """Per-rank cache rows (batch at dim 1) as DTensors split over the
    batch axes."""
    axes = batch_axes(mesh)
    pl = [Shard(1) if a in axes else Replicate()
          for a in mesh.mesh_dim_names]
    return map_tree(lambda c: DTensor.from_local(c, mesh, pl,
                                                 run_check=False), caches)


def _local_caches(caches, mesh):
    """A rank's rows of the caches (batch at dim 1), DTensors or the
    whole batch's plain tensors (``_local_rows``)."""
    return map_tree(lambda c: _local_rows(c, mesh, 1), caches)


def _remat(fn, remat):
    """``fn`` under ``torch.utils.checkpoint`` when ``remat`` is set."""
    if not remat:
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False)


def _scale_embed(cfg, x):
    if cfg.scale_embeddings:
        x = x * rounded(cfg.d_model ** 0.5, x.dtype)
    return x


def _embed_in(params, cfg, batch) -> torch.Tensor:
    x = _scale_embed(cfg, hint(embed(params, batch["tokens"]),
                               "batch", "seq", None))
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


def forward(params, cfg: ArchConfig, batch, remat=False,
            block_kv: int = attn.DEFAULT_BLOCK_KV, mesh=None):
    """Returns (logits (B,S,V), aux_loss scalar); over a mesh the logits
    of the whole batch on every rank."""
    if mesh is None:
        return _forward(params, cfg, batch, remat, block_kv, None)
    params, batch = _on_mesh(params, batch, mesh)
    logits, aux = _forward(params, cfg, batch, remat, block_kv, mesh)
    return _whole_rows(logits, mesh), aux


def _forward(params, cfg, batch, remat, block_kv, mesh):
    if cfg.enc_dec:
        return _whisper_forward(params, cfg, batch, remat, block_kv)
    if cfg.family == "ssm":
        return _ssm_forward(params, cfg, batch, remat)
    if cfg.family == "hybrid":
        return _hybrid_forward(params, cfg, batch, remat, block_kv)

    b, s = batch["tokens"].shape
    top = _top(params)
    x = _embed_in(top, cfg, batch)
    positions = _positions(cfg, batch, b, s, x.device)
    layer = (_save_attn_layer if remat == "save_attn"
             else _remat(_train_layer, remat))
    auxes: List[torch.Tensor] = []
    for lp, (window, theta) in zip(_layers(params["layers"], cfg.n_layers),
                                   _layer_scalars(cfg, s)):
        x, aux = layer(lp, cfg, x, positions, theta, window, block_kv, mesh)
        if aux is not None:
            auxes.append(aux)
    x = rmsnorm(top["final_norm"], x, cfg.norm_eps)
    return _logits(top, x), sum(auxes, _zero(x.device))


def _logits(top, x):
    return hint(unembed(top, x), "batch", "seq", "vocab")


def _attn_out_ffn(lp, cfg, x, o, mesh=None):
    """The decoder layer after its attention core: (x + out_proj(o), then
    the ffn sublayer; the MoE aux loss or None)."""
    auxes: List[torch.Tensor] = []
    x = _ffn_layer(lp, cfg, _residual(x, _out_proj(lp["attn"], o)),
                   auxes, mesh)
    return x, (auxes[0] if auxes else None)


def _train_layer(lp, cfg, x, positions, theta, window, block_kv,
                 mesh=None):
    """One decoder layer of the forward: (x, the MoE aux loss or None)."""
    o = _attn_core(lp, cfg, x, positions, theta, window, block_kv)[0]
    return _attn_out_ffn(lp, cfg, x, o, mesh)


def _save_attn_layer(lp, cfg, x, positions, theta, window, block_kv,
                     mesh=None):
    """``_train_layer`` with its attention core and the rest checkpointed
    apart: the backward recomputes both, and keeps o between them."""
    o = checkpoint(_attn_core, lp, cfg, x, positions, theta, window,
                   block_kv, use_reentrant=False)[0]
    return checkpoint(_attn_out_ffn, lp, cfg, x, o, mesh,
                      use_reentrant=False)


def _ssm_layer(lp, cfg, x, **kw):
    """x + ssm_block(ln(x)); with ``cache`` or ``return_cache`` also the
    layer's new cache."""
    lp = gathered_tree(lp)
    h = rmsnorm(lp["ln"], x, cfg.norm_eps)
    lp_ssm = {k: v for k, v in lp.items() if k != "ln"}
    out = ssm_mod.ssm_block(lp_ssm, h, cfg, **kw)
    if isinstance(out, tuple):
        return x + out[0], out[1]
    return x + out


def _ssm_forward(params, cfg, batch, remat=False):
    top = _top(params)
    x = _embed_in(top, cfg, batch)
    layer = _remat(_ssm_layer, remat)
    for lp in _layers(params["layers"], cfg.n_layers):
        x = layer(lp, cfg, x)
    x = rmsnorm(top["final_norm"], x, cfg.norm_eps)
    return _logits(top, x), _zero(x.device)


def _shared_block(sp, cfg, x, positions, block_kv, kv_cache=None, pos=None):
    """Zamba2 weight-tied shared attention+MLP block. Params have a leading
    length-1 'layers' dim (sliced here). Returns (x, (k,v)) in forward and
    prefill, or (x, the updated caches) in decode when kv_cache is given.
    The reference runs it outside any ``lax.scan``, op by op, so its
    residual sums round to bf16 as eager adds do."""
    sl = gathered_tree(_layer(sp, 0))
    h = rmsnorm(sl["ln1"], x, cfg.norm_eps)
    q, k, v = attn.qkv_proj(sl["attn"], h)
    q, k = _apply_rope(cfg, q, k, positions, cfg.rope_theta)
    if kv_cache is None:
        o = attn.flash_attention(q, k, v, causal=True, block_kv=block_kv)
        new_kv = (k, v)
    else:
        kc, vc = attn.update_cache(*kv_cache, k, v, pos)
        o = attn.decode_attention(q, kc, vc, pos)
        new_kv = (kc, vc)
    x = x + attn.out_proj(sl["attn"], o)
    h2 = rmsnorm(sl["ln2"], x, cfg.norm_eps)
    x = x + mlp(sl["mlp"], h2, cfg.act)
    return x, new_kv


def _groups(cfg):
    """Zamba2's stack: ``n_layers / shared_attn_every`` groups of layer
    indices, each followed by the shared block."""
    per = cfg.shared_attn_every
    return [range(g * per, (g + 1) * per)
            for g in range(cfg.n_layers // per)]


def _hybrid_forward(params, cfg, batch, remat, block_kv):
    """The SSM layers under ``remat``; the shared block never, as in the
    reference (its remat wraps the inner scan only)."""
    b, s = batch["tokens"].shape
    top = _top(params)
    x = _embed_in(top, cfg, batch)
    positions = _positions(cfg, batch, b, s, x.device)
    layers = _layers(params["layers"], cfg.n_layers)
    layer = _remat(_ssm_layer, remat)
    for group in _groups(cfg):
        for i in group:
            x = layer(layers[i], cfg, x)
        x, _ = _shared_block(params["shared"], cfg, x, positions, block_kv)
    x = rmsnorm(top["final_norm"], x, cfg.norm_eps)
    return _logits(top, x), _zero(x.device)


def _encode(params, cfg, batch, block_kv, remat=False):
    """Whisper's encoder over the stub frontend's frame embeddings
    (B,F,d): the normalized encoder output."""
    frames = batch["frames"].to(COMPUTE_DTYPE)
    f = frames.shape[1]
    xe = frames + sinusoidal_positions(f, cfg.d_model, frames.device).to(
        frames.dtype)[None]
    layer = _remat(_enc_layer, remat)
    for lp in _layers(params["enc_layers"], cfg.n_enc_layers):
        xe = layer(lp, cfg, xe, block_kv)
    return rmsnorm(gathered(params["enc_norm"]), xe, cfg.norm_eps)


def _enc_layer(lp, cfg, xe, block_kv):
    lp = gathered_tree(lp)
    h = rmsnorm(lp["ln1"], xe, cfg.norm_eps)
    q, k, v = attn.qkv_proj(lp["attn"], h)
    o = attn.flash_attention(q, k, v, causal=False, block_kv=block_kv)
    return _ffn_layer(lp, cfg, _residual(xe, attn.out_proj(lp["attn"], o)))


def _whisper_layer(lp, cfg, x, enc_out, block_kv):
    """One decoder layer over the whole sequence: (x, k, v, cross k, cross
    v)."""
    lp = gathered_tree(lp)
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    q, k, v = attn.qkv_proj(lp["attn"], h)
    o = attn.flash_attention(q, k, v, causal=True, block_kv=block_kv)
    x = _residual(x, attn.out_proj(lp["attn"], o))
    hc = rmsnorm(lp["ln3"], x, cfg.norm_eps, dtype=COMPUTE_DTYPE)
    qc, kc, vc = _cross_qkv(lp["cross"], hc, enc_out)
    oc = attn.flash_attention(qc, kc, vc, causal=False, block_kv=block_kv)
    x = _ffn_layer(lp, cfg, _residual(x.to(COMPUTE_DTYPE),
                                      attn.out_proj(lp["cross"], oc)))
    return x, k, v, kc, vc


def _whisper_embed(params, cfg, tokens):
    s = tokens.shape[1]
    return embed(params, tokens) + sinusoidal_positions(
        s, cfg.d_model, tokens.device).to(COMPUTE_DTYPE)[None]


def _whisper_forward(params, cfg, batch, remat, block_kv):
    """Encoder and decoder layers under ``remat``, each recomputed whole
    (their bodies name no attention output)."""
    top = _top(params)
    enc_out = _encode(top, cfg, batch, block_kv, remat)
    x = _whisper_embed(top, cfg, batch["tokens"])
    layer = _remat(_whisper_layer, remat)
    for lp in _layers(params["layers"], cfg.n_layers):
        x = layer(lp, cfg, x, enc_out, block_kv)[0]
    x = rmsnorm(top["final_norm"], x, cfg.norm_eps)
    return _logits(top, x), _zero(x.device)


def _cross_qkv(p, x_dec, enc_out):
    q = attn._proj(x_dec, p["wq"])
    k = attn._proj(enc_out, p["wk"])
    v = attn._proj(enc_out, p["wv"])
    if "bq" in p:
        q = q + cast(p["bq"], x_dec.dtype)
        k = k + cast(p["bk"], enc_out.dtype)
        v = v + cast(p["bv"], enc_out.dtype)
    return q, k, v


# ---------------------------------------------------------------------------
# Prefill: forward pass that also emits decode caches
# ---------------------------------------------------------------------------


def prefill(params, cfg: ArchConfig, batch, skv: Optional[int] = None,
            block_kv: int = attn.DEFAULT_BLOCK_KV, mesh=None):
    """Returns (last-token logits (B,V), caches sized for skv); over a
    mesh the logits of the whole batch on every rank and each rank's
    cache rows as DTensors."""
    if mesh is None:
        return _prefill(params, cfg, batch, skv, block_kv, None)
    params, batch = _on_mesh(params, batch, mesh)
    logits, caches = _prefill(params, cfg, batch, skv, block_kv, mesh)
    return _whole_rows(logits, mesh), _cache_shards(caches, mesh)


def _prefill(params, cfg, batch, skv, block_kv, mesh):
    if cfg.enc_dec:
        return _whisper_prefill(params, cfg, batch, skv, block_kv)
    if cfg.family == "ssm":
        return _ssm_prefill(params, cfg, batch)
    if cfg.family == "hybrid":
        return _hybrid_prefill(params, cfg, batch, skv, block_kv)

    b, s = batch["tokens"].shape
    skv = skv or s
    top = _top(params)
    x = _embed_in(top, cfg, batch)
    positions = _positions(cfg, batch, b, s, x.device)
    ks, vs = [], []
    for i, (window, theta) in enumerate(_layer_scalars(cfg, skv)):
        lp = _layer(params["layers"], i)
        x, k, v = _attn_block(lp, cfg, x, positions, theta, window, block_kv)
        x = _ffn_layer(lp, cfg, x, mesh=mesh)
        ks.append(_pad_cache(k, skv))
        vs.append(_pad_cache(v, skv))
    x = rmsnorm(top["final_norm"], x, cfg.norm_eps)
    logits = hint(unembed(top, x[:, -1]), "batch", "vocab")
    return logits, {"self": {"k": torch.stack(ks), "v": torch.stack(vs)}}


def _pad_cache(k: torch.Tensor, skv: int) -> torch.Tensor:
    s = k.shape[1]
    if s != skv:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, skv - s))
    return k.to(COMPUTE_DTYPE)


def _stack_trees(trees: List[Tree]) -> Tree:
    """Stack a list of equal-keyed trees leaf by leaf along a new axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _ssm_prefill(params, cfg, batch):
    top = _top(params)
    x = _embed_in(top, cfg, batch)
    caches = []
    for i in range(cfg.n_layers):
        x, cache = _ssm_layer(_layer(params["layers"], i), cfg, x,
                              return_cache=True)
        caches.append(cache)
    x = rmsnorm(top["final_norm"], x, cfg.norm_eps)
    return _last_logits(top, x), {"ssm": _stack_trees(caches)}


def _last_logits(top, x):
    return hint(unembed(top, x[:, -1]), "batch", "vocab")


def _hybrid_prefill(params, cfg, batch, skv, block_kv):
    b, s = batch["tokens"].shape
    skv = skv or s
    top = _top(params)
    x = _embed_in(top, cfg, batch)
    positions = _positions(cfg, batch, b, s, x.device)
    ssm_caches, shared_k, shared_v = [], [], []
    for group in _groups(cfg):
        for i in group:
            x, cache = _ssm_layer(_layer(params["layers"], i), cfg, x,
                                  return_cache=True)
            ssm_caches.append(cache)
        x, (k, v) = _shared_block(params["shared"], cfg, x, positions,
                                  block_kv)
        shared_k.append(_pad_cache(k, skv))
        shared_v.append(_pad_cache(v, skv))
    x = rmsnorm(top["final_norm"], x, cfg.norm_eps)
    return _last_logits(top, x), {
        "ssm": _stack_trees(ssm_caches),
        "shared": {"k": torch.stack(shared_k), "v": torch.stack(shared_v)},
    }


def _whisper_prefill(params, cfg, batch, skv, block_kv):
    top = _top(params)
    enc_out = _encode(top, cfg, batch, block_kv)
    tokens = batch["tokens"]
    skv = skv or tokens.shape[1]
    x = _whisper_embed(top, cfg, tokens)
    ys = []
    for i in range(cfg.n_layers):
        x, k, v, kc, vc = _whisper_layer(_layer(params["layers"], i), cfg,
                                         x, enc_out, block_kv)
        ys.append((_pad_cache(k, skv), _pad_cache(v, skv),
                   kc.to(COMPUTE_DTYPE), vc.to(COMPUTE_DTYPE)))
    x = rmsnorm(top["final_norm"], x, cfg.norm_eps)
    sk, sv, ck, cv = (torch.stack(t) for t in zip(*ys))
    return _last_logits(top, x), {"self": {"k": sk, "v": sv},
                                       "cross": {"k": ck, "v": cv}}


# ---------------------------------------------------------------------------
# Decode: one token against seq_len caches
# ---------------------------------------------------------------------------


def decode_step(params, cfg: ArchConfig, caches, batch, mesh=None):
    """batch: tokens (B,1), pos (B,). Returns (logits (B,V), new caches);
    over a mesh the caches are each rank's rows (DTensors as ``prefill``
    gives them, or the whole batch's plain tensors), the logits the
    whole batch's on every rank and the new caches DTensors."""
    if mesh is None:
        return _decode_step(params, cfg, caches, batch, None)
    params, batch = _on_mesh(params, batch, mesh)
    logits, new = _decode_step(params, cfg, _local_caches(caches, mesh),
                               batch, mesh)
    return _whole_rows(logits, mesh), _cache_shards(new, mesh)


def _decode_step(params, cfg, caches, batch, mesh):
    if cfg.enc_dec:
        return _whisper_decode(params, cfg, caches, batch)
    if cfg.family == "ssm":
        return _ssm_decode(params, cfg, caches, batch)
    if cfg.family == "hybrid":
        return _hybrid_decode(params, cfg, caches, batch)

    tokens, pos = batch["tokens"], batch["pos"]
    b = tokens.shape[0]
    top = _top(params)
    x = _scale_embed(cfg, embed(top, tokens))
    skv = caches["self"]["k"].shape[2]
    positions = pos[:, None]
    if cfg.rope_kind == "mrope":
        positions = pos[None, :, None].expand(3, b, 1)
    ks, vs = [], []
    for i, (window, theta) in enumerate(_layer_scalars(cfg, skv)):
        lp = {k: v if k == "moe" else gathered_tree(v)   # moe_block's own
              for k, v in _layer(params["layers"], i).items()}
        h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
        q, k, v = attn.qkv_proj(lp["attn"], h)
        q, k = _apply_rope(cfg, q, k, positions, theta)
        kc = hint(caches["self"]["k"][i], "batch", "kv_seq", "kv_heads", None)
        vc = hint(caches["self"]["v"][i], "batch", "kv_seq", "kv_heads", None)
        kc, vc = attn.update_cache(kc, vc, k, v, pos)
        o = attn.decode_attention(q, kc, vc, pos, window=window)
        x = _ffn_layer(lp, cfg,
                       _residual(x, attn.out_proj(lp["attn"], o)),
                       mesh=mesh)
        ks.append(kc)
        vs.append(vc)
    x = rmsnorm(top["final_norm"], x, cfg.norm_eps)
    return _last_logits(top, x), {
        "self": {"k": torch.stack(ks), "v": torch.stack(vs)}}


def _ssm_decode(params, cfg, caches, batch):
    top = _top(params)
    x = embed(top, batch["tokens"])
    new = []
    for i in range(cfg.n_layers):
        x, cache = _ssm_layer(_layer(params["layers"], i), cfg, x,
                              cache=_layer(caches["ssm"], i))
        new.append(cache)
    x = rmsnorm(top["final_norm"], x, cfg.norm_eps)
    return _last_logits(top, x), {"ssm": _stack_trees(new)}


def _hybrid_decode(params, cfg, caches, batch):
    tokens, pos = batch["tokens"], batch["pos"]
    top = _top(params)
    x = embed(top, tokens)
    positions = pos[:, None]
    new_ssm, new_k, new_v = [], [], []
    for g, group in enumerate(_groups(cfg)):
        for i in group:
            x, cache = _ssm_layer(_layer(params["layers"], i), cfg, x,
                                  cache=_layer(caches["ssm"], i))
            new_ssm.append(cache)
        kv = (caches["shared"]["k"][g], caches["shared"]["v"][g])
        x, (kc, vc) = _shared_block(params["shared"], cfg, x, positions,
                                    attn.DEFAULT_BLOCK_KV, kv_cache=kv,
                                    pos=pos)
        new_k.append(kc)
        new_v.append(vc)
    x = rmsnorm(top["final_norm"], x, cfg.norm_eps)
    return _last_logits(top, x), {
        "ssm": _stack_trees(new_ssm),
        "shared": {"k": torch.stack(new_k), "v": torch.stack(new_v)},
    }


def _whisper_decode(params, cfg, caches, batch):
    tokens, pos = batch["tokens"], batch["pos"]
    b = tokens.shape[0]
    top = _top(params)
    x = embed(top, tokens)
    # sinusoidal position of the current step, gathered per sequence
    skv = caches["self"]["k"].shape[2]
    pos_table = sinusoidal_positions(skv, cfg.d_model, x.device).to(x.dtype)
    x = x + pos_table[pos.long()][:, None]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = gathered_tree(_layer(params["layers"], i))
        ck, cv = caches["cross"]["k"][i], caches["cross"]["v"][i]
        h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
        q, k, v = attn.qkv_proj(lp["attn"], h)
        kc, vc = attn.update_cache(caches["self"]["k"][i],
                                   caches["self"]["v"][i], k, v, pos)
        o = attn.decode_attention(q, kc, vc, pos)
        x = _residual(x, attn.out_proj(lp["attn"], o))
        hc = rmsnorm(lp["ln3"], x, cfg.norm_eps, dtype=COMPUTE_DTYPE)
        # the reference projects the cross query without ``bq`` here
        qc = attn._proj(hc, lp["cross"]["wq"])
        f = ck.shape[1]
        oc = attn.decode_attention(
            qc, ck, cv, torch.full((b,), f - 1, dtype=torch.int32,
                                   device=x.device))
        x = _ffn_layer(lp, cfg, _residual(x.to(COMPUTE_DTYPE),
                                          attn.out_proj(lp["cross"], oc)))
        ks.append(kc)
        vs.append(vc)
    x = rmsnorm(top["final_norm"], x, cfg.norm_eps)
    return _last_logits(top, x), {
        "self": {"k": torch.stack(ks), "v": torch.stack(vs)},
        "cross": caches["cross"]}
