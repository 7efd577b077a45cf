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

Over a mesh (``mesh=``, a ``DeviceMesh``), each rank computes its share
of the global batch as the reference's rules and hints place it under
GSPMD, on plain tensors:

* its rows of the batch (split over ``sharding_ctx.batch_axes``:
  ``("pod", "data")``, the first axis major, unless the ambient rules map
  the batch elsewhere). The residual stream is these rows, whole over
  ``"model"``, as the reference's ``hint(x, "batch", "seq", None)``;
* in every family's layers, tensor parallelism over ``"model"`` where a
  leaf's spec splits it there. Attention (the decoders', zamba2's shared
  block's, whisper's encoder, decoder and cross attention) runs on the
  rank's query heads (q column-parallel, k and v over ``kv_heads`` where
  that divides, else whole, the rank taking the kv heads its query heads
  read) and ``wo`` row-parallel with one ``psum``; where the heads do not
  divide the axis, the reference's ``attn_q_seq`` branch: the rank's
  block of query rows against whole k and v, its rows of the output
  gathered back over ``"model"`` (and, where the rows do not divide it
  either, as whisper's 1500 frames on 16 ranks, whole). The dense MLP is
  column-parallel over ``ffn`` into a row-parallel ``w2`` (one
  ``psum``); an MoE layer runs the reference's expert-parallel branches
  (``moe.moe_block``) on the replicated residual stream; a Mamba2 layer
  computes its block of ``ffn`` and ``ssm_heads`` (``ssm.ssm_block``;
  B and C whole);
* in every family, the vocabulary-parallel embedding lookup and the
  unembedding column-parallel over ``vocab`` (``layers.embed``,
  ``layers.unembed``): the logits come back as a DTensor, the rows split
  over the batch axes and the vocabulary over ``"model"`` (whole over it
  where the vocabulary does not divide it), as the reference's
  ``("batch", "seq", "vocab")`` hint places them. A caller that wants the
  whole logits takes ``sharding_ctx.whole`` of them;
* in decode, the rank's block of each cache as its spec places it:
  under the decode rules (``kv_seq`` on ``"model"``) each rank writes the
  new token only where its sequence block of a kv cache holds ``pos`` and
  attends over its block, the blocks joined by a max and two ``psum``s
  (``attention.decode_combine``); a kv cache split over its kv heads is
  read by the query heads of the rank's own; an SSM cache holds the
  rank's ``conv_x`` channels and ``state`` heads. The caches come back as
  DTensors under the same placements, never gathered whole; ``prefill``
  returns each rank's block under the cache spec of the ambient rules.

A batch entry is the whole batch's plain tensor, held alike by every
rank, or a DTensor (as the dry-run's in-shardings give them). Each
parameter leaf is a DTensor under its ``spec_for`` placements, or a
plain tensor every rank holds alike; a layer gathers each leaf it uses
inside its own body over the axes it does not compute on (the FSDP split
over ``"data"``; ``remat`` recomputes the gathers), and the gather's
backward hands each rank its shard's gradient, summed over the ranks
that used it. A loss every rank holds
alike (``train.step.cross_entropy`` on the logits' DTensor) is
backpropagated divided by the mesh's size (``train.step.value_and_grad``):
the collectives' adjoints then sum the ranks' parts into the gradient of
the loss.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import (COMPUTE_DTYPE, cast, embed, embed_defs, mlp, mlp_defs,
                     mrope, rmsnorm, rmsnorm_def, rope, rounded,
                     sinusoidal_positions, unembed, vocab_blocks)
from .param import ParamDef, map_tree, placements, spec_tree
from .sharding_ctx import (TP, LocalShard, all_gather, axis_index,
                           batch_axes, column_in, contiguous_stride,
                           current_rules, gathered, gathered_tree, hint,
                           kv_share, local_rows, local_shards,
                           mesh_axis_size, mesh_shape_dict, row_parallel,
                           rows_dtensor, rows_in, rule_axes, tp_blocks,
                           tp_in, tp_leaf, tp_size)

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
    return _rope(cfg, q, positions, theta), _rope(cfg, k, positions, theta)


def _rope(cfg: ArchConfig, t, positions, theta):
    """``t`` rotated at ``positions``; as it is where the config has no
    rope or no positions are given (cross attention)."""
    if cfg.rope_kind == "none" or positions is None:
        return t
    if cfg.rope_kind == "mrope":
        return mrope(t, positions, cfg.rope_theta, cfg.mrope_sections)
    return rope(t, positions, theta)


def _residual(x, y):
    """x + y for the ffn sublayer, in f32. The reference's compiled layer
    body (XLA on the CPU, which may keep excess precision) feeds this sum
    to the ln2 statistics unrounded and rounds it to bf16 only where it
    joins the mlp's output; rounding it first, as an eager bf16 add
    does, moves an eighth of a layer's outputs by an ulp."""
    return x.to(torch.float32) + y.to(torch.float32)


class _Split(NamedTuple):
    """How a rank computes a decoder layer's attention: ``kind`` "heads"
    (its block ``r`` of ``n`` of the query heads), "rows" (its block of
    the query rows, the reference's ``attn_q_seq`` branch) or None
    (whole)."""
    kind: Optional[str]
    n: int
    r: int


def _attn_split(pa, cfg, s: int, mesh) -> _Split:
    """The reference's choice (``attention.py``'s ``heads_sharded``): the
    heads where they divide the ``heads`` axis, else the query rows
    over ``attn_q_seq``. The heads are this rank's where ``wq``'s spec
    splits them over ``"model"``; the rows where ``attn_q_seq`` maps to
    ``"model"`` and ``s`` divides it (the spec's fallback leaves them
    whole)."""
    n = tp_blocks(pa["wq"], 1)
    if n > 1:
        return _Split("heads", n, mesh.get_local_rank(TP))
    m = tp_size(mesh)
    heads_axis = rule_axes("heads", mesh) if m > 1 else ()
    if not heads_axis or \
            cfg.n_heads % mesh_axis_size(mesh, heads_axis) == 0:
        return _Split(None, 1, 0)
    rows_axis = rule_axes("attn_q_seq", mesh)
    if rows_axis not in ((), (TP,)):
        raise ValueError(f"query rows over {rows_axis}: only 'model' is "
                         f"handled")
    if not rows_axis or s % m:
        return _Split(None, 1, 0)
    return _Split("rows", m, mesh.get_local_rank(TP))


def _qkv(pa, hq, hkv, kv: Optional[Tuple[int, int]] = None,
         split: Optional[str] = None, mesh=None):
    """q of ``hq``, k and v of ``hkv``, each over the heads its leaves
    give this rank (``tp_leaf``); where ``"model"`` does not split the kv
    heads, ``kv = (lo, n)`` names the ones to compute. Under a "heads"
    split the products are this rank's columns (``column_in``). Also the
    k leaf's split."""
    w = {n: tp_leaf(pa[n], 1) for n in ("wq", "wk", "wv")}
    b = {n: tp_leaf(pa[n], 0) for n in ("bq", "bk", "bv") if n in pa}
    if w["wk"].n != w["wv"].n or any(
            b[n].n != w["w" + n[1]].n for n in b):
        raise ValueError("the attention's leaves split their heads "
                         "differently over 'model'")
    wk, wv = w["wk"].t, w["wv"].t
    bk, bv = (b[n].t if n in b else None for n in ("bk", "bv"))
    if kv is not None and w["wk"].n == 1 and kv[1] < wk.shape[1]:
        wk, wv = wk.narrow(1, *kv), wv.narrow(1, *kv)
        if b:
            bk, bv = bk.narrow(0, *kv), bv.narrow(0, *kv)
    proj = functools.partial(_proj_in,
                             mesh=mesh if split == "heads" else None)
    q = proj(hq, w["wq"].t)
    k, v = proj(hkv, wk), proj(hkv, wv)
    if b:
        q = q + cast(b["bq"].t, hq.dtype)
        k = k + cast(bk, hkv.dtype)
        v = v + cast(bv, hkv.dtype)
    return q, k, v, w["wk"]


def _proj_in(x, w, mesh=None):
    """``attention._proj`` as this rank's columns (``column_in``)."""
    if mesh is None:
        return attn._proj(x, w)
    d, h, e = w.shape
    return column_in(x, cast(w, x.dtype).reshape(d, h * e), mesh) \
        .reshape(x.shape[:-1] + (h, e))


def _kv_range(cfg, split: "_Split", r: int) -> Tuple[int, int]:
    """(first, count) of the kv heads that rank ``r``'s query heads read
    under ``split``, where ``"model"`` splits the query heads and not the
    kv heads (the reference's repeat-then-shard: a rank projects only
    those); all of them where the ranks' counts differ."""
    heads, kv = cfg.n_heads, cfg.n_kv_heads
    if split.kind != "heads":
        return 0, kv
    per, group = heads // split.n, heads // kv

    def run(rank):
        lo = rank * per // group
        return lo, (rank * per + per - 1) // group + 1 - lo

    if len({run(i)[1] for i in range(split.n)}) > 1:
        return 0, kv
    return run(r)


def _kv_holders(cfg, split: "_Split") -> List[int]:
    """How many ranks hold each kv head (``_kv_range``)."""
    count = [0] * cfg.n_kv_heads
    for r in range(split.n):
        lo, n = _kv_range(cfg, split, r)
        for h in range(lo, lo + n):
            count[h] += 1
    return count


def _kv_whole(t: torch.Tensor, cfg, split: "_Split", mesh) -> torch.Tensor:
    """Every kv head of ``t`` (.., this rank's ``_kv_range`` of the kv
    heads, head dim): the ranks' runs gathered over ``"model"``, each
    head taken from the first rank that holds it."""
    kv = cfg.n_kv_heads
    if t.shape[-2] == kv:
        return t
    runs = [_kv_range(cfg, split, r) for r in range(split.n)]
    n = runs[0][1]
    idx = [next(r * n + h - lo for r, (lo, _) in enumerate(runs)
                if lo <= h < lo + n) for h in range(kv)]
    t = all_gather(t, mesh, TP, t.ndim - 2)
    return t.index_select(t.ndim - 2, torch.tensor(idx, device=t.device))


def _attn_core(lp, cfg, x, positions, theta, window, block_kv, mesh=None,
               causal: bool = True):
    """The attention output o (before ``out_proj``) and the layer's
    rotated k and v, of ``ln1(x)`` (``_attention``)."""
    x = hint(x, "batch", "seq", None)
    h = rmsnorm(gathered(lp["ln1"]), x, cfg.norm_eps)
    return _attention(lp["attn"], cfg, h, h, positions, theta, window,
                      block_kv, mesh, causal)


def _attention(pa, cfg, h, hkv, positions, theta, window, block_kv,
               mesh=None, causal: bool = True):
    """The attention output o (before ``out_proj``) of queries from ``h``
    over keys and values from ``hkv`` (``h`` itself, or whisper's encoder
    output), and the rotated k and v (no rope where ``positions`` is
    None). Over a mesh o is this rank's share (``_attn_split``: its query
    heads, or its query rows); k and v hold, over every row, this rank's
    kv heads where ``"model"`` splits them, else those its query heads
    read (``_kv_range``)."""
    split = _attn_split(pa, cfg, h.shape[1], mesh)
    hq, pos_q, q_offset, p_dtype = h, positions, 0, None
    if split.kind == "rows":
        rows = h.shape[1] // split.n
        q_offset = split.r * rows
        hq = rows_in(h, mesh, 1)
        if positions is not None:
            pos_q = positions.narrow(-1, q_offset, rows)
    kv = _kv_range(cfg, split, split.r)
    q, k, v, wk = _qkv(pa, hq, hkv, kv, split.kind, mesh)
    q, k = _rope(cfg, q, pos_q, theta), _rope(cfg, k, positions, theta)
    kq, vq = k, v
    if split.kind == "rows":
        # every rank's query rows read all of k and v: the ranks' f32
        # gradients of the repeated heads are summed before they round,
        # as the mesh-free attention's single product rounds its own
        group = cfg.n_heads // cfg.n_kv_heads
        kq, vq = (tp_in(torch.repeat_interleave(t, group, dim=2), mesh,
                        f32=True) for t in (k, v))
        p_dtype = v.dtype
    if split.kind == "heads":
        per = cfg.n_heads // split.n
        group = cfg.n_heads // cfg.n_kv_heads
        kv_lo = wk.r * k.shape[2] if wk.n > 1 else kv[0]
        if wk.n == 1:
            holders = _kv_holders(cfg, split)
            if max(holders) > 1:
                k, v = (kv_share(t, kv_lo, cfg.n_kv_heads, holders, mesh)
                        for t in (k, v))
        kq, vq = (attn.heads_for(t, kv_lo, split.r * per, per, group)
                  for t in (k, v))
    o = attn.flash_attention(q, kq, vq, causal=causal, window=window,
                             q_offset=q_offset, block_kv=block_kv,
                             p_dtype=p_dtype)
    return o, k, v


def _attn_block(lp, cfg, x, positions, theta, window, block_kv, mesh=None,
                causal: bool = True):
    """x + attention(x) as ``_residual``'s f32 sum; also returns the
    layer's rotated k and v."""
    o, k, v = _attn_core(lp, cfg, x, positions, theta, window, block_kv,
                         mesh, causal)
    return _attn_residual(lp["attn"], cfg, x, o, mesh), k, v


def _attn_residual(pa, cfg, x, o, mesh=None, res_dtype=torch.float32):
    """x + out_proj(o) of a rank's share o (``_attention``), summed in
    ``res_dtype`` (``_residual``'s f32 by default): row-parallel over its
    query heads (one ``psum`` over ``"model"``), or over its query rows,
    gathered back over ``"model"``."""
    split = _attn_split(pa, cfg, x.shape[1], mesh)
    wo = tp_leaf(pa["wo"], 0)
    if wo.n != (split.n if split.kind == "heads" else 1):
        raise ValueError("wo and wq split their heads differently over "
                         "'model'")
    if split.kind == "heads":
        hl, e, d = wo.t.shape
        return row_parallel(o.reshape(o.shape[:-2] + (hl * e,)),
                            wo.t.reshape(hl * e, d), wo, x, res_dtype)
    y = attn.out_proj({"wo": wo.t}, o)
    if split.kind == "rows":
        y = all_gather(y, mesh, TP, 1)
    return x.to(res_dtype) + y.to(res_dtype)


def _ffn_layer(lp, cfg, x, auxes=None, mesh=None):
    """x (the f32 sum of ``_residual``) + mlp(ln2(x)) or moe(ln2(x)), in
    bf16. An MoE layer appends its aux loss to ``auxes`` when given (the
    forward sums them; prefill and decode compute none)."""
    x = hint(x, "batch", "seq", None)
    h = rmsnorm(gathered(lp["ln2"]), x, cfg.norm_eps, dtype=COMPUTE_DTYPE)
    if cfg.moe is None:
        return mlp(lp["mlp"], h, cfg.act, x)
    y, aux = moe_mod.moe_block(lp["moe"], tp_in(h, mesh), cfg, mesh,
                               cfg.act, aux=auxes is not None)
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
    """The unstacked leaves: the norms gathered whole, the embedding and
    unembedding as they are (``layers.embed`` and ``unembed`` take their
    vocabulary split over ``"model"``), the stacked layer trees as they
    are."""
    return {k: v if k in _STACKED + _VOCAB else gathered_tree(v)
            for k, v in params.items()}


_STACKED = ("layers", "enc_layers", "shared")
_VOCAB = ("embed", "unembed")
# batch entries whose batch dimension is not the first
_BATCH_DIM = {"mrope_positions": 1}


def _on_mesh(params, batch, mesh):
    """Each leaf as a ``LocalShard``, and this rank's rows of the batch."""
    local = {k: local_rows(v, mesh, _BATCH_DIM.get(k, 0))
             if isinstance(v, torch.Tensor) else v for k, v in batch.items()}
    return local_shards(params, mesh), local


class _Cache(NamedTuple):
    """This rank's block of a stacked kv cache (layers, batch, skv, kv
    heads, head dim): its mesh ``placements``, the axes splitting the
    sequence (``seq_axes``) and the first position of its block
    (``seq_lo``), the blocks ``"model"`` splits the kv heads into
    (``heads``) and the whole sequence length ``skv``."""
    placements: Any
    seq_axes: Tuple[str, ...]
    seq_lo: int
    heads: int
    skv: int


_WHOLE_CACHE = _Cache(None, (), 0, 1, 0)
# the stacked kv caches of the families (decoders "self", zamba2
# "shared", whisper "self" and "cross"); "ssm" is Mamba2's
_KV = ("self", "shared", "cross")


def _cache_layout(pl, mesh, skv: int) -> _Cache:
    """The ``_Cache`` of a stacked cache under placements ``pl``. Only the
    batch, the sequence and (over ``"model"``) the kv heads may be split;
    any other split raises."""
    names, seq, heads = list(mesh.mesh_dim_names), [], 1
    for i, p in enumerate(pl):
        if not isinstance(p, Shard) or mesh.size(i) == 1:
            continue
        if p.dim == 2:
            seq.append(names[i])
        elif p.dim == 3 and names[i] == TP:
            heads = mesh.size(i)
        elif p.dim != 1:
            raise ValueError(f"a cache split over {names[i]} along its "
                             f"dimension {p.dim} is not handled")
    seq_axes = tuple(seq)
    n = mesh_axis_size(mesh, seq_axes) if seq_axes else 1
    lo = axis_index(mesh, seq_axes) * (skv // n) if seq_axes else 0
    return _Cache(list(pl), seq_axes, lo, heads, skv)


class _SsmCache(NamedTuple):
    """How ``"model"`` splits a layer's SSM cache: the blocks of
    ``conv_x``'s channels and of ``state``'s heads (1: whole)."""
    conv: int
    state: int


_WHOLE_SSM = _SsmCache(1, 1)
# the dimension of a stacked SSM cache leaf that "model" may split
_SSM_TP_DIM = {"conv_x": 3, "state": 2}


def _ssm_layout(pls, mesh) -> _SsmCache:
    """The ``_SsmCache`` of a stacked SSM cache whose leaves lie under
    placements ``pls``: besides the batch, only ``"model"`` may split
    ``conv_x``'s channels and ``state``'s heads."""
    names, blocks = list(mesh.mesh_dim_names), {}
    for key, pl in pls.items():
        for i, p in enumerate(pl):
            if not isinstance(p, Shard) or mesh.size(i) == 1 or p.dim == 1:
                continue
            if names[i] != TP or _SSM_TP_DIM.get(key) != p.dim:
                raise ValueError(f"an SSM cache's {key} split over "
                                 f"{names[i]} along its dimension {p.dim} "
                                 f"is not handled")
            blocks[key] = mesh.size(i)
    return _SsmCache(blocks.get("conv_x", 1), blocks.get("state", 1))


def _layouts(pls, lengths, mesh) -> Dict[str, Any]:
    """Each cache's layout under its placements ``pls`` (a tree as the
    caches'): a ``_Cache`` of each kv cache (``lengths`` its sequence
    length), the ``_SsmCache`` of the SSM cache."""
    out = {}
    for key, tree in pls.items():
        if key == "ssm":
            out[key] = _ssm_layout(tree, mesh)
            continue
        k, v = (_cache_layout(tree[n], mesh, lengths[key]) for n in "kv")
        if k != v:
            raise ValueError("k and v caches lie under different placements")
        out[key] = k
    return out


def _prefill_layouts(cfg, mesh, batch: int, skv: int):
    """The placements of the caches ``prefill`` returns (the cache spec
    under the ambient rules, the default ones outside a context) and
    their layouts."""
    defs = cache_defs(cfg, batch, skv)
    specs = spec_tree(defs, current_rules(), mesh_shape_dict(mesh))
    pls = map_tree(lambda sp: placements(sp, mesh), specs)
    lengths = {k: defs[k]["k"].shape[2] for k in defs if k in _KV}
    return pls, _layouts(pls, lengths, mesh)


def _kv_cache(pa, cfg, k, v, s: int, skv: int, cl: _Cache, mesh):
    """A layer's k and v of ``s`` rows (as ``_attention`` gives them) as
    this rank's blocks of its cache under ``cl``, padded to ``skv``:
    where ``"model"`` does not split the cache's kv heads, the ranks'
    runs of them gathered first."""
    if mesh is not None and cl.heads == 1:
        split = _attn_split(pa, cfg, s, mesh)
        k, v = (_kv_whole(t.to(COMPUTE_DTYPE), cfg, split, mesh)
                for t in (k, v))
    return tuple(_cache_block(_pad_cache(t, skv), cl, cfg, mesh)
                 for t in (k, v))


def _cache_block(c: torch.Tensor, cl: _Cache, cfg, mesh) -> torch.Tensor:
    """This rank's block of one layer's cache (batch rows, skv, kv heads
    of this rank where ``"model"`` splits them in the projection, else
    all, head dim) under ``cl``, in a storage of its own."""
    if cl.placements is None:
        return c
    if cl.seq_axes:
        size = cl.skv // mesh_axis_size(mesh, cl.seq_axes)
        c = c.narrow(1, cl.seq_lo, size)
    c = _cache_heads(c, cfg, cl, mesh)
    if c.untyped_storage().nbytes() > c.numel() * c.element_size():
        c = c.clone(memory_format=torch.contiguous_format)
    return c


def _cache_heads(t: torch.Tensor, cfg, cl: _Cache, mesh) -> torch.Tensor:
    """``t`` (.., kv heads, head dim), this rank's block of the kv heads
    or all of them, as the cache holds them: its block where ``"model"``
    splits the cache's heads, else all."""
    kv = cfg.n_kv_heads
    if cl.heads > 1:
        if t.shape[-2] == kv:
            per = kv // cl.heads
            return t.narrow(-2, mesh.get_local_rank(TP) * per, per)
        return t
    if t.shape[-2] < kv:
        return all_gather(t, mesh, TP, t.ndim - 2)
    return t


def _reblock(t: torch.Tensor, dim: int, have: int, want: int, mesh
             ) -> torch.Tensor:
    """``t``, this rank's block of ``have`` along ``dim`` over ``"model"``
    (1: whole), as its block of ``want``: cut from the whole, or
    gathered whole over ``"model"``."""
    if have == want:
        return t
    if have == 1:
        per = t.shape[dim] // want
        return t.narrow(dim, mesh.get_local_rank(TP) * per, per)
    return all_gather(t, mesh, TP, dim)


def _ssm_reblock(cache, have: _SsmCache, want: _SsmCache, mesh):
    """One layer's SSM cache from the blocks ``have`` to ``want``."""
    out = dict(cache)
    for key, n, m in (("conv_x", have.conv, want.conv),
                      ("state", have.state, want.state)):
        out[key] = _reblock(cache[key], _SSM_TP_DIM[key] - 1, n, m, mesh)
    return out


def _caches_in(caches, mesh):
    """This rank's blocks of the caches and their placements: a DTensor
    keeps its local block (its batch split over the batch axes), a plain
    tensor (the whole batch) gives its rows."""
    axes = batch_axes(mesh)
    names = list(mesh.mesh_dim_names)

    def one(c):
        if isinstance(c, DTensor):
            pl = list(c.placements)
            split = tuple(a for a, p in zip(names, pl) if p == Shard(1))
            if split != axes:
                raise ValueError(f"a cache's batch split over {split}, not "
                                 f"the batch axes {axes}")
            return c.to_local(), pl
        return local_rows(c, mesh, 1), [Shard(1) if a in axes
                                        else Replicate() for a in names]

    pairs = map_tree(one, caches)
    return map_tree(lambda t: t[0], pairs), map_tree(lambda t: t[1], pairs)


def _caches_out(local, pls, mesh):
    """Each rank's cache blocks as DTensors under their placements."""
    def one(c, pl):
        shape = list(c.shape)
        for i, p in enumerate(pl):
            if isinstance(p, Shard):
                shape[p.dim] *= mesh.size(i)
        return DTensor.from_local(c, mesh, pl, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=contiguous_stride(shape))

    if isinstance(local, dict):
        return {k: _caches_out(v, pls[k], mesh) for k, v in local.items()}
    return one(local, pls)


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
    are a DTensor (the module docstring)."""
    if mesh is None:
        return _forward(params, cfg, batch, remat, block_kv, None)
    params, batch = _on_mesh(params, batch, mesh)
    logits, aux = _forward(params, cfg, batch, remat, block_kv, mesh)
    return rows_dtensor(logits, mesh, vocab_blocks(params)), aux


def _forward(params, cfg, batch, remat, block_kv, mesh):
    if cfg.enc_dec:
        return _whisper_forward(params, cfg, batch, remat, block_kv, mesh)
    if cfg.family == "ssm":
        return _ssm_forward(params, cfg, batch, remat, mesh)
    if cfg.family == "hybrid":
        return _hybrid_forward(params, cfg, batch, remat, block_kv, mesh)

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
    x = _ffn_layer(lp, cfg, _attn_residual(lp["attn"], cfg, x, o, mesh),
                   auxes, mesh)
    return x, (auxes[0] if auxes else None)


def _train_layer(lp, cfg, x, positions, theta, window, block_kv,
                 mesh=None):
    """One decoder layer of the forward: (x, the MoE aux loss or None)."""
    o = _attn_core(lp, cfg, x, positions, theta, window, block_kv, mesh)[0]
    return _attn_out_ffn(lp, cfg, x, o, mesh)


def _save_attn_layer(lp, cfg, x, positions, theta, window, block_kv,
                     mesh=None):
    """``_train_layer`` with its attention core and the rest checkpointed
    apart: the backward recomputes both, and keeps o between them."""
    o = checkpoint(_attn_core, lp, cfg, x, positions, theta, window,
                   block_kv, mesh, use_reentrant=False)[0]
    return checkpoint(_attn_out_ffn, lp, cfg, x, o, mesh,
                      use_reentrant=False)


def _ssm_layer(lp, cfg, x, mesh=None, layout: _SsmCache = _WHOLE_SSM,
               **kw):
    """x + ssm_block(ln(x)); with ``cache`` or ``return_cache`` also the
    layer's new cache. Over a mesh the block computes this rank's share
    (``ssm.ssm_block``); the cache comes and goes as ``layout`` splits it
    over ``"model"``, moved to and from the blocks the layer computes on
    where they differ (parameters that every rank holds alike)."""
    h = rmsnorm(gathered(lp["ln"]), x, cfg.norm_eps, mesh=mesh)
    lp_ssm = {k: v for k, v in lp.items() if k != "ln"}
    own = _SsmCache(tp_blocks(lp["wx"], 1), tp_blocks(lp["wdt"], 1))
    if kw.get("cache") is not None:
        kw["cache"] = _ssm_reblock(kw["cache"], layout, own, mesh)
    out = ssm_mod.ssm_block(lp_ssm, h, cfg, res=x, **kw)
    if isinstance(out, tuple):
        return out[0], _ssm_reblock(out[1], own, layout, mesh)
    return out


def _ssm_forward(params, cfg, batch, remat=False, mesh=None):
    top = _top(params)
    x = _embed_in(top, cfg, batch)
    layer = _remat(_ssm_layer, remat)
    for lp in _layers(params["layers"], cfg.n_layers):
        x = layer(lp, cfg, x, mesh)
    x = rmsnorm(top["final_norm"], x, cfg.norm_eps)
    return _logits(top, x), _zero(x.device)


def _shared_block(sp, cfg, x, positions, block_kv, kv_cache=None, pos=None,
                  mesh=None, cl: Optional[_Cache] = None):
    """Zamba2 weight-tied shared attention+MLP block. Params have a leading
    length-1 'layers' dim (sliced here). Returns (x, (k,v)) in forward and
    prefill, or (x, the updated caches) in decode when kv_cache is given
    (this rank's block of the ``"shared"`` cache under ``cl``). Over a
    mesh the attention and the MLP are tensor-parallel as the decoder
    layer's (``_attention``, ``layers.mlp``); k and v in the forward are
    those ``_attention`` gives. The reference runs it outside any
    ``lax.scan``, op by op, so its residual sums round to bf16 as eager
    adds do (the row-parallel sums join the stream in bf16)."""
    sl = _layer(sp, 0)
    bf16 = x.dtype
    if kv_cache is None:
        o, k, v = _attn_core(sl, cfg, x, positions, cfg.rope_theta, None,
                             block_kv, mesh)
        x = _attn_residual(sl["attn"], cfg, x, o, mesh, bf16)
        new_kv = (k, v)
    else:
        cl = cl or _WHOLE_CACHE._replace(skv=kv_cache[0].shape[1])
        y, kc, vc = _decode_attn(sl, cfg, x, *kv_cache, pos, positions,
                                 cfg.rope_theta, None, cl, mesh)
        x = x + y
        new_kv = (kc, vc)
    h2 = rmsnorm(gathered(sl["ln2"]), x, cfg.norm_eps)
    return mlp(sl["mlp"], h2, cfg.act, x), new_kv


def _groups(cfg):
    """Zamba2's stack: ``n_layers / shared_attn_every`` groups of layer
    indices, each followed by the shared block."""
    per = cfg.shared_attn_every
    return [range(g * per, (g + 1) * per)
            for g in range(cfg.n_layers // per)]


def _hybrid_forward(params, cfg, batch, remat, block_kv, mesh=None):
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
            x = layer(layers[i], cfg, x, mesh)
        x, _ = _shared_block(params["shared"], cfg, x, positions, block_kv,
                             mesh=mesh)
    x = rmsnorm(top["final_norm"], x, cfg.norm_eps)
    return _logits(top, x), _zero(x.device)


def _encode(params, cfg, batch, block_kv, remat=False, mesh=None):
    """Whisper's encoder over the stub frontend's frame embeddings
    (B,F,d): the normalized encoder output."""
    frames = batch["frames"].to(COMPUTE_DTYPE)
    f = frames.shape[1]
    xe = frames + sinusoidal_positions(f, cfg.d_model, frames.device).to(
        frames.dtype)[None]
    layer = _remat(_enc_layer, remat)
    for lp in _layers(params["enc_layers"], cfg.n_enc_layers):
        xe = layer(lp, cfg, xe, block_kv, mesh)
    return rmsnorm(gathered(params["enc_norm"]), xe, cfg.norm_eps)


def _enc_layer(lp, cfg, xe, block_kv, mesh=None):
    """One whisper encoder layer: attention over every frame (no mask,
    no rope), then the MLP; over a mesh both tensor-parallel as the
    decoder layer's."""
    x = _attn_block(lp, cfg, xe, None, None, None, block_kv, mesh,
                    causal=False)[0]
    return _ffn_layer(lp, cfg, x, mesh=mesh)


def _whisper_layer(lp, cfg, x, enc_out, block_kv, mesh=None):
    """One decoder layer over the whole sequence: (x, k, v, cross k, cross
    v). Self attention is causal (the positions are in the embedding),
    cross attention takes its queries from the decoder's rows and its
    keys and values from ``enc_out``; over a mesh both are
    tensor-parallel (``_attention``), as is the MLP."""
    x, k, v = _attn_block(lp, cfg, x, None, None, None, block_kv, mesh)
    hc = rmsnorm(gathered(lp["ln3"]), x, cfg.norm_eps, dtype=COMPUTE_DTYPE)
    oc, kc, vc = _attention(lp["cross"], cfg, hc, enc_out, None, None, None,
                            block_kv, mesh, causal=False)
    x = _attn_residual(lp["cross"], cfg, x.to(COMPUTE_DTYPE), oc, mesh)
    return _ffn_layer(lp, cfg, x, mesh=mesh), k, v, kc, vc


def _whisper_embed(params, cfg, tokens):
    s = tokens.shape[1]
    return embed(params, tokens) + sinusoidal_positions(
        s, cfg.d_model, tokens.device).to(COMPUTE_DTYPE)[None]


def _whisper_forward(params, cfg, batch, remat, block_kv, mesh=None):
    """Encoder and decoder layers under ``remat``, each recomputed whole
    (their bodies name no attention output)."""
    top = _top(params)
    enc_out = _encode(top, cfg, batch, block_kv, remat, mesh)
    x = _whisper_embed(top, cfg, batch["tokens"])
    layer = _remat(_whisper_layer, remat)
    for lp in _layers(params["layers"], cfg.n_layers):
        x = layer(lp, cfg, x, enc_out, block_kv, mesh)[0]
    x = rmsnorm(top["final_norm"], x, cfg.norm_eps)
    return _logits(top, x), _zero(x.device)


# ---------------------------------------------------------------------------
# Prefill: forward pass that also emits decode caches
# ---------------------------------------------------------------------------


def prefill(params, cfg: ArchConfig, batch, skv: Optional[int] = None,
            block_kv: int = attn.DEFAULT_BLOCK_KV, mesh=None):
    """Returns (last-token logits (B,V), caches sized for skv); over a
    mesh the logits as a DTensor and each rank's cache block as DTensors
    (the module docstring)."""
    if mesh is None:
        return _prefill(params, cfg, batch, skv, block_kv, None)
    b, s = batch["tokens"].shape
    skv = skv or s
    params, batch = _on_mesh(params, batch, mesh)
    pls, layouts = _prefill_layouts(cfg, mesh, b, skv)
    logits, caches = _prefill(params, cfg, batch, skv, block_kv, mesh,
                              layouts)
    return (rows_dtensor(logits, mesh, vocab_blocks(params)),
            _caches_out(caches, pls, mesh))


def _prefill(params, cfg, batch, skv, block_kv, mesh, layouts=None):
    layouts = layouts or {}
    if cfg.enc_dec:
        return _whisper_prefill(params, cfg, batch, skv, block_kv, mesh,
                                layouts)
    if cfg.family == "ssm":
        return _ssm_prefill(params, cfg, batch, mesh, layouts)
    if cfg.family == "hybrid":
        return _hybrid_prefill(params, cfg, batch, skv, block_kv, mesh,
                               layouts)

    b, s = batch["tokens"].shape
    skv = skv or s
    cl = layouts.get("self", _WHOLE_CACHE)
    top = _top(params)
    x = _embed_in(top, cfg, batch)
    positions = _positions(cfg, batch, b, s, x.device)
    ks, vs = [], []
    for i, (window, theta) in enumerate(_layer_scalars(cfg, skv)):
        lp = _layer(params["layers"], i)
        x, k, v = _attn_block(lp, cfg, x, positions, theta, window, block_kv,
                              mesh)
        x = _ffn_layer(lp, cfg, x, mesh=mesh)
        k, v = _kv_cache(lp["attn"], cfg, k, v, s, skv, cl, mesh)
        ks.append(k)
        vs.append(v)
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


def _ssm_prefill(params, cfg, batch, mesh=None, layouts=None):
    layout = (layouts or {}).get("ssm", _WHOLE_SSM)
    top = _top(params)
    x = _embed_in(top, cfg, batch)
    caches = []
    for i in range(cfg.n_layers):
        x, cache = _ssm_layer(_layer(params["layers"], i), cfg, x, mesh,
                              layout, return_cache=True)
        caches.append(cache)
    x = rmsnorm(top["final_norm"], x, cfg.norm_eps)
    return _last_logits(top, x), {"ssm": _stack_trees(caches)}


def _last_logits(top, x):
    return hint(unembed(top, x[:, -1]), "batch", "vocab")


def _hybrid_prefill(params, cfg, batch, skv, block_kv, mesh=None,
                    layouts=None):
    layouts = layouts or {}
    layout = layouts.get("ssm", _WHOLE_SSM)
    cl = layouts.get("shared", _WHOLE_CACHE)
    b, s = batch["tokens"].shape
    skv = skv or s
    top = _top(params)
    x = _embed_in(top, cfg, batch)
    positions = _positions(cfg, batch, b, s, x.device)
    ssm_caches, shared_k, shared_v = [], [], []
    for group in _groups(cfg):
        for i in group:
            x, cache = _ssm_layer(_layer(params["layers"], i), cfg, x, mesh,
                                  layout, return_cache=True)
            ssm_caches.append(cache)
        x, (k, v) = _shared_block(params["shared"], cfg, x, positions,
                                  block_kv, mesh=mesh)
        k, v = _kv_cache(_layer(params["shared"], 0)["attn"], cfg, k, v, s,
                         skv, cl, mesh)
        shared_k.append(k)
        shared_v.append(v)
    x = rmsnorm(top["final_norm"], x, cfg.norm_eps)
    return _last_logits(top, x), {
        "ssm": _stack_trees(ssm_caches),
        "shared": {"k": torch.stack(shared_k), "v": torch.stack(shared_v)},
    }


def _whisper_prefill(params, cfg, batch, skv, block_kv, mesh=None,
                     layouts=None):
    layouts = layouts or {}
    cl, cl_cross = (layouts.get(k, _WHOLE_CACHE) for k in ("self", "cross"))
    top = _top(params)
    enc_out = _encode(top, cfg, batch, block_kv, mesh=mesh)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    skv = skv or s
    f = enc_out.shape[1]
    x = _whisper_embed(top, cfg, tokens)
    ys = []
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        x, k, v, kc, vc = _whisper_layer(lp, cfg, x, enc_out, block_kv, mesh)
        ys.append(_kv_cache(lp["attn"], cfg, k, v, s, skv, cl, mesh)
                  + _kv_cache(lp["cross"], cfg, kc, vc, s, f, cl_cross,
                              mesh))
    x = rmsnorm(top["final_norm"], x, cfg.norm_eps)
    sk, sv, ck, cv = (torch.stack(t) for t in zip(*ys))
    return _last_logits(top, x), {"self": {"k": sk, "v": sv},
                                       "cross": {"k": ck, "v": cv}}


# ---------------------------------------------------------------------------
# Decode: one token against seq_len caches
# ---------------------------------------------------------------------------


def decode_step(params, cfg: ArchConfig, caches, batch, mesh=None):
    """batch: tokens (B,1), pos (B,). Returns (logits (B,V), new caches);
    over a mesh the caches are DTensors (as ``prefill`` gives them) or the
    whole batch's plain tensors, and the logits and the new caches come
    back as DTensors under the placements they came in (the module
    docstring)."""
    if mesh is None:
        return _decode_step(params, cfg, caches, batch, None)
    params, batch = _on_mesh(params, batch, mesh)
    local, pls = _caches_in(caches, mesh)
    lengths = {k: caches[k]["k"].shape[2] for k in caches if k in _KV}
    logits, new = _decode_step(params, cfg, local, batch, mesh,
                               _layouts(pls, lengths, mesh))
    return (rows_dtensor(logits, mesh, vocab_blocks(params)),
            _caches_out(new, pls, mesh))


def _kv_layout(layouts, caches, key) -> _Cache:
    """The layout of the kv cache ``key``: given over a mesh, else whole."""
    if key in layouts:
        return layouts[key]
    return _WHOLE_CACHE._replace(skv=caches[key]["k"].shape[2])


def _decode_step(params, cfg, caches, batch, mesh, layouts=None):
    layouts = layouts or {}
    if cfg.enc_dec:
        return _whisper_decode(params, cfg, caches, batch, mesh, layouts)
    if cfg.family == "ssm":
        return _ssm_decode(params, cfg, caches, batch, mesh, layouts)
    if cfg.family == "hybrid":
        return _hybrid_decode(params, cfg, caches, batch, mesh, layouts)

    tokens, pos = batch["tokens"], batch["pos"]
    b = tokens.shape[0]
    top = _top(params)
    x = _scale_embed(cfg, embed(top, tokens))
    cl = _kv_layout(layouts, caches, "self")
    positions = pos[:, None]
    if cfg.rope_kind == "mrope":
        positions = pos[None, :, None].expand(3, b, 1)
    ks, vs = [], []
    for i, (window, theta) in enumerate(_layer_scalars(cfg, cl.skv)):
        lp = _layer(params["layers"], i)
        kc = hint(caches["self"]["k"][i], "batch", "kv_seq", "kv_heads", None)
        vc = hint(caches["self"]["v"][i], "batch", "kv_seq", "kv_heads", None)
        y, kc, vc = _decode_attn(lp, cfg, x, kc, vc, pos, positions, theta,
                                 window, cl, mesh)
        x = _ffn_layer(lp, cfg, _residual(x, y), mesh=mesh)
        ks.append(kc)
        vs.append(vc)
    x = rmsnorm(top["final_norm"], x, cfg.norm_eps)
    return _last_logits(top, x), {
        "self": {"k": torch.stack(ks), "v": torch.stack(vs)}}


def _decode_attn(lp, cfg, x, kc, vc, pos, positions, theta, window,
                 cl: _Cache, mesh):
    """One layer's self attention of a decoded token: (out_proj of it,
    the layer's updated k and v caches), the new k and v written where
    this rank's block of the cache (``cl``) holds ``pos``
    (``_decode_read``)."""
    h = rmsnorm(gathered(lp["ln1"]), x, cfg.norm_eps)
    pa = lp["attn"]
    q, k, v, _ = _qkv(pa, h, h)
    q, k = _apply_rope(cfg, q, k, positions, theta)
    k, v = (_cache_heads(t, cfg, cl, mesh) for t in (k, v))
    lo = cl.seq_lo
    kc, vc = attn.update_cache(kc, vc, k, v, pos - lo if lo else pos)
    return _decode_read(pa, cfg, q, kc, vc, pos, window, cl, mesh), kc, vc


def _decode_read(pa, cfg, q, kc, vc, pos, window, cl: _Cache, mesh):
    """out_proj of the attention of q (the decoded token's query heads of
    this rank) over the cache. Over a mesh the rank's query heads read
    its block of the cache (``cl``): where the cache splits the sequence
    over ``"model"``, every query head, joined over the blocks
    (``attention.decode_combine``); else its own heads, against the kv
    heads they read. ``wo`` sums the rank's heads over ``"model"``."""
    lo = cl.seq_lo
    heads, group = cfg.n_heads, cfg.n_heads // cfg.n_kv_heads
    n_q = q.shape[2]
    q_lo = mesh.get_local_rank(TP) * n_q if n_q < heads else 0
    if n_q < heads and TP in cl.seq_axes:
        q, q_lo, n_q = all_gather(q, mesh, TP, 2), 0, heads
    kq, vq = kc, vc
    if n_q < heads or cl.heads > 1:
        kv_lo = mesh.get_local_rank(TP) * kc.shape[2] if cl.heads > 1 else 0
        kq, vq = (attn.heads_for(t, kv_lo, q_lo, n_q, group)
                  for t in (kc, vc))
    if cl.seq_axes:
        m, l, o = attn.decode_attention_block(q, kq, vq, pos, window=window,
                                              kv_offset=lo)
        l, o = attn.decode_combine(m, l, o, mesh, cl.seq_axes)
        o = attn.decode_output(o, l, q)
    else:
        o = attn.decode_attention(q, kq, vq, pos, window=window)
    wo = tp_leaf(pa["wo"], 0)
    if wo.n > 1:
        per = heads // wo.n
        if n_q == heads:
            o = o.narrow(2, wo.r * per, per)
        elif (q_lo, n_q) != (wo.r * per, per):
            raise ValueError("wo and wq split their heads differently over "
                             "'model'")
        hl, e, d = wo.t.shape
        y = row_parallel(o.reshape(o.shape[:-2] + (hl * e,)),
                         wo.t.reshape(hl * e, d), wo)
    else:
        if n_q < heads:
            o = all_gather(o, mesh, TP, 2)
        y = attn.out_proj({"wo": wo.t}, o)
    return y


def _ssm_decode(params, cfg, caches, batch, mesh=None, layouts=None):
    layout = (layouts or {}).get("ssm", _WHOLE_SSM)
    top = _top(params)
    x = embed(top, batch["tokens"])
    new = []
    for i in range(cfg.n_layers):
        x, cache = _ssm_layer(_layer(params["layers"], i), cfg, x, mesh,
                              layout, cache=_layer(caches["ssm"], i))
        new.append(cache)
    x = rmsnorm(top["final_norm"], x, cfg.norm_eps)
    return _last_logits(top, x), {"ssm": _stack_trees(new)}


def _hybrid_decode(params, cfg, caches, batch, mesh=None, layouts=None):
    layouts = layouts or {}
    layout = layouts.get("ssm", _WHOLE_SSM)
    cl = _kv_layout(layouts, caches, "shared")
    tokens, pos = batch["tokens"], batch["pos"]
    top = _top(params)
    x = embed(top, tokens)
    positions = pos[:, None]
    new_ssm, new_k, new_v = [], [], []
    for g, group in enumerate(_groups(cfg)):
        for i in group:
            x, cache = _ssm_layer(_layer(params["layers"], i), cfg, x, mesh,
                                  layout, cache=_layer(caches["ssm"], i))
            new_ssm.append(cache)
        kv = (caches["shared"]["k"][g], caches["shared"]["v"][g])
        x, (kc, vc) = _shared_block(params["shared"], cfg, x, positions,
                                    attn.DEFAULT_BLOCK_KV, kv_cache=kv,
                                    pos=pos, mesh=mesh, cl=cl)
        new_k.append(kc)
        new_v.append(vc)
    x = rmsnorm(top["final_norm"], x, cfg.norm_eps)
    return _last_logits(top, x), {
        "ssm": _stack_trees(new_ssm),
        "shared": {"k": torch.stack(new_k), "v": torch.stack(new_v)},
    }


def _whisper_decode(params, cfg, caches, batch, mesh=None, layouts=None):
    layouts = layouts or {}
    cl, cl_cross = (_kv_layout(layouts, caches, k) for k in ("self", "cross"))
    tokens, pos = batch["tokens"], batch["pos"]
    b = tokens.shape[0]
    top = _top(params)
    x = embed(top, tokens)
    # sinusoidal position of the current step, gathered per sequence
    pos_table = sinusoidal_positions(cl.skv, cfg.d_model, x.device).to(
        x.dtype)
    x = x + pos_table[pos.long()][:, None]
    # the cross attention reads every frame
    last = torch.full((b,), cl_cross.skv - 1, dtype=torch.int32,
                      device=x.device)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        y, kc, vc = _decode_attn(lp, cfg, x, caches["self"]["k"][i],
                                 caches["self"]["v"][i], pos, None, None,
                                 None, cl, mesh)
        x = _residual(x, y)
        hc = rmsnorm(gathered(lp["ln3"]), x, cfg.norm_eps,
                     dtype=COMPUTE_DTYPE)
        # the reference projects the cross query without ``bq`` here
        qc = attn._proj(hc, tp_leaf(lp["cross"]["wq"], 1).t)
        yc = _decode_read(lp["cross"], cfg, qc, caches["cross"]["k"][i],
                          caches["cross"]["v"][i], last, None, cl_cross,
                          mesh)
        x = _ffn_layer(lp, cfg, _residual(x.to(COMPUTE_DTYPE), yc),
                       mesh=mesh)
        ks.append(kc)
        vs.append(vc)
    x = rmsnorm(top["final_norm"], x, cfg.norm_eps)
    return _last_logits(top, x), {
        "self": {"k": torch.stack(ks), "v": torch.stack(vs)},
        "cross": caches["cross"]}
