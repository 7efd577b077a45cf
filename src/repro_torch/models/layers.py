"""Common layers: RMSNorm, RoPE/M-RoPE, SwiGLU MLP, embeddings.

Pure functions over ParamDef-described trees of tensors; compute dtype is
bf16 with f32 for normalization statistics and softmax accumulators
(MaxText-style mixed precision). Weights stay in their stored dtype until
cast at use.

Over a mesh the MLP and embedding leaves may be ``LocalShard``s: the MLP
is column-parallel over ``ffn`` (``w1``, ``w3``) and row-parallel into
``w2``, the embedding lookup vocabulary-parallel and the unembedding
column-parallel over ``vocab``, each as far as its spec splits the
dimension over ``"model"`` (``sharding_ctx.tp_leaf``).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import torch

from .param import ParamDef
from .sharding_ctx import (TP, column_in, psum, row_parallel, row_weight,
                           tp_blocks, tp_leaf)

COMPUTE_DTYPE = torch.bfloat16


def cast(x: torch.Tensor, dtype=COMPUTE_DTYPE) -> torch.Tensor:
    return x.to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_def(d: int, layers=None) -> ParamDef:
    if layers is None:
        return ParamDef((d,), (None,), init="ones")
    return ParamDef((layers, d), ("layers", None), init="ones")


def rmsnorm(w, x, eps: float = 1e-6, dtype=None, mesh=None):
    """f32 statistics + f32 normalize, cast at the output to ``dtype``
    (default x's). The reference measured a bf16 variant 20x worse at
    decode parity. Over a ``mesh`` the weight's gradient sums this rank's
    rows in f32 (``sharding_ctx.row_weight``)."""
    dtype = dtype or x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return row_weight(out.to(dtype), w, mesh)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def _rotate(x, ang):
    """Rotate halves of x (B,S,H,D) by angles ang (B,S,D/2), in f32."""
    half = x.shape[-1] // 2
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta) -> torch.Tensor:
    """x (B,S,H,D), positions (B,S) int -> rotated x. ``theta`` is a
    number (gemma3 passes each layer's own)."""
    half = x.shape[-1] // 2
    # filled on x's device: a host tensor would be one blocking copy a call
    log_theta = torch.log(torch.full((), theta, dtype=torch.float32,
                                     device=x.device))
    i = torch.arange(half, dtype=torch.float32, device=x.device)
    freqs = torch.exp(-log_theta * (i / half))
    return _rotate(x, positions.to(torch.float32)[..., None] * freqs)


def mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
          sections: Tuple[int, ...]) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): positions (3,B,S) for (t,h,w); frequency
    bands are split across the three position streams per `sections`
    (which sum to head_dim/2)."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    i = torch.arange(half, dtype=torch.float32, device=x.device)
    freqs = torch.pow(torch.full((), theta, dtype=torch.float32,
                                 device=x.device), -i / half)
    angs, lo = [], 0
    for s_idx, width in enumerate(sections):
        p = positions[s_idx].to(torch.float32)  # (B,S)
        angs.append(p[..., None] * freqs[lo:lo + width])
        lo += width
    return _rotate(x, torch.cat(angs, dim=-1))


def sinusoidal_positions(n: int, d: int, device) -> torch.Tensor:
    """Whisper-style sinusoidal absolute position embeddings (n, d), in
    float32 on ``device``."""
    half = d // 2
    i = torch.arange(half, dtype=torch.float32, device=device)
    freqs = torch.exp(-math.log(10000.0) * i / max(half - 1, 1))
    ang = torch.arange(n, dtype=torch.float32, device=device)[:, None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def mlp_defs(d: int, ff: int, layers: int, dtype=torch.float32):
    lax_ = ("layers", "embed", "ffn")
    return {
        "w1": ParamDef((layers, d, ff), lax_, dtype),
        "w3": ParamDef((layers, d, ff), lax_, dtype),
        "w2": ParamDef((layers, ff, d), ("layers", "ffn", "embed"), dtype),
    }


@functools.lru_cache(maxsize=None)
def rounded(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype``, as a Python number: an elementwise op
    with it computes what the op with a ``dtype`` constant computes (both
    operands widened to f32, the result rounded), without a tensor on
    the device."""
    return torch.tensor(v, dtype=dtype).item()


def _act(name: str, x):
    """``jax.nn.gelu`` (tanh approximation, its default) or
    ``jax.nn.silu``, written as the reference's op sequence in x's dtype
    with its constants rounded to that dtype: in bf16 each op rounds
    where XLA's rounds (``silu``'s logistic is XLA's ``1 / (1 + exp(-x))``),
    which ``F.gelu``/``F.silu`` miss by an ulp on a third of elements."""
    if name == "gelu":
        inner = rounded(math.sqrt(2 / math.pi), x.dtype) * (
            x + rounded(0.044715, x.dtype) * (x * x * x))
        return x * (0.5 * (torch.tanh(inner) + 1.0))
    return x * (1.0 / (torch.exp(-x) + 1.0))


def mlp(p, x, act: str = "silu", res=None):
    """The gated MLP (plus ``res``, the residual stream, when given, added
    in x's dtype); over a mesh ``w1``/``w3`` give this rank's ``ffn``
    columns and ``w2`` sums its rows over ``"model"`` (one ``psum``,
    ``row_parallel``)."""
    w1, w3, w2 = tp_leaf(p["w1"], 1), tp_leaf(p["w3"], 1), tp_leaf(p["w2"], 0)
    if not w1.n == w3.n == w2.n:
        raise ValueError(f"the MLP's ffn splits differ over 'model': "
                         f"{w1.n}, {w3.n}, {w2.n}")
    mesh = w1.mesh if w1.n > 1 else None
    h = _act(act, column_in(x, cast(w1.t, x.dtype), mesh)) * \
        column_in(x, cast(w3.t, x.dtype), mesh)
    return row_parallel(h, w2.t, w2, res, x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_defs(vocab: int, d: int, tie: bool, dtype=torch.float32):
    defs = {"embed": ParamDef((vocab, d), ("vocab", "embed"), dtype,
                              scale=1.0)}
    if not tie:
        defs["unembed"] = ParamDef((d, vocab), ("embed", "vocab"), dtype)
    return defs


def embed(p, tokens: torch.Tensor, dtype=COMPUTE_DTYPE) -> torch.Tensor:
    """The table's rows of ``tokens``. Where ``"model"`` splits the
    vocabulary, each rank reads the rows of its slice, zero for the
    others, and the ranks' rows are summed over ``"model"``."""
    # the reference casts the whole table, then indexes; indexing first
    # gives the same bits and reads only the rows it needs
    table = tp_leaf(p["embed"], 0)
    if table.n == 1:
        return cast(table.t[tokens.long()], dtype)
    rows = table.t.shape[0]
    idx = tokens.long() - table.r * rows
    own = ((idx >= 0) & (idx < rows))[..., None]
    got = cast(table.t[idx.clamp(0, rows - 1)], dtype)
    return psum(torch.where(own, got, torch.zeros((), dtype=dtype,
                                                  device=got.device)),
                table.mesh, TP)


def vocab_blocks(p) -> int:
    """How many blocks ``"model"`` splits the vocabulary of the
    unembedding into (1: whole)."""
    if "unembed" in p:
        return tp_blocks(p["unembed"], 1)
    return tp_blocks(p["embed"], 0)


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    """The logits; over a mesh those of this rank's vocabulary block
    (``vocab_blocks``)."""
    w = tp_leaf(p["unembed"], 1) if "unembed" in p else tp_leaf(p["embed"], 0)
    wb = cast(w.t, x.dtype) if "unembed" in p else cast(w.t, x.dtype).T
    return column_in(x, wb, w.mesh if w.n > 1 else None)
