"""Mamba2 block: chunked SSD (state-space duality) + single-step decode.

The SSD dual form (arXiv:2405.21060) splits the sequence into chunks of
length Q: within a chunk the recurrence is computed as a masked quadratic
attention-like product (dense matmuls); across chunks a linear scan
propagates the (H, P, N) state. Prefill uses the chunked form; decode is
the O(1) recurrent update.

Projections are separate matmuls (wz/wx/wB/wC/wdt) rather than one fused
in_proj, as in the reference, so the parameter tree carries across key
for key.

Causal depthwise conv (width 4) is computed as 4 shifted adds; its state
(last W-1 inputs) is carried in the decode cache.

Over a mesh the block is tensor-parallel as the reference's specs place
its leaves over ``"model"``: ``wz``, ``wx``, ``conv_x`` and ``norm`` are
this rank's block of ``ffn`` (``d_inner``), ``wdt``, ``dt_bias``,
``A_log`` and ``Dskip`` its block of ``ssm_heads``, and ``wo`` sums the
rank's rows into the residual stream (one ``psum``, ``row_parallel``).
``wB``, ``wC``, ``conv_B`` and ``conv_C`` are whole on every rank (as
GSPMD leaves them): B and C are computed whole and each rank repeats
them to its own heads, their gradient summed over every rank's heads
(``repeat_in``). The gated norm normalises over the whole ``d_inner``:
its f32 sum of squares is summed over ``"model"``. The chunked SSD is
head-local and runs on the rank's heads as it is. The weights broadcast
over the rows (the norm, the conv taps) sum their gradient over the
rank's rows in f32 (``row_weight``). The decode cache is laid out
alike: ``conv_x`` the rank's channels, ``state`` its heads,
``conv_B``/``conv_C`` whole.

The reference's ``lax.scan`` over chunks is a Python loop. Its bf16
products with ``preferred_element_type=float32`` run on f32 copies of
their operands (``attention._f32_einsum``); ``silu`` is the reference's
bf16 op sequence (``layers._act``) and ``softplus`` is
``jax.nn.softplus``'s ``logaddexp(x, 0)``, which ``F.softplus`` is not
above its threshold of 20.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .attention import _f32_einsum
from .layers import _act, cast, rmsnorm
from .param import ParamDef
from .sharding_ctx import (TP, column_in, hint, psum, repeat_in, row_parallel,
                           row_weight, tp_leaf)


class SSMDims(NamedTuple):
    d_inner: int
    n_heads: int
    head_dim: int
    n_groups: int
    d_state: int
    gn: int
    conv_w: int


def ssm_dims(cfg: ArchConfig) -> SSMDims:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    return SSMDims(d_inner, n_heads, s.head_dim, s.n_groups, s.d_state,
                   s.n_groups * s.d_state, s.conv_width)


def ssm_defs(cfg: ArchConfig, layers: int, dtype=torch.float32):
    d = cfg.d_model
    dims = ssm_dims(cfg)
    di, h, gn, w = dims.d_inner, dims.n_heads, dims.gn, dims.conv_w
    lef = ("layers", "embed", "ffn")
    return {
        "wz": ParamDef((layers, d, di), lef, dtype),
        "wx": ParamDef((layers, d, di), lef, dtype),
        "wB": ParamDef((layers, d, gn), ("layers", "embed", None), dtype),
        "wC": ParamDef((layers, d, gn), ("layers", "embed", None), dtype),
        "wdt": ParamDef((layers, d, h), ("layers", "embed", "ssm_heads"),
                        dtype),
        "dt_bias": ParamDef((layers, h), ("layers", "ssm_heads"), dtype,
                            init="zeros"),
        "A_log": ParamDef((layers, h), ("layers", "ssm_heads"), dtype,
                          init="zeros"),
        "Dskip": ParamDef((layers, h), ("layers", "ssm_heads"), dtype,
                          init="ones"),
        "conv_x": ParamDef((layers, w, di), ("layers", None, "ffn"), dtype,
                           scale=0.5),
        "conv_B": ParamDef((layers, w, gn), ("layers", None, None), dtype,
                           scale=0.5),
        "conv_C": ParamDef((layers, w, gn), ("layers", None, None), dtype,
                           scale=0.5),
        "norm": ParamDef((layers, di), ("layers", "ffn"), dtype,
                         init="ones"),
        "wo": ParamDef((layers, di, d), ("layers", "ffn", "embed"), dtype),
    }


def _silu(x):
    return _act("silu", x)


def _softplus(x):
    """``jax.nn.softplus``: ``lax.logaddexp(x, 0)``, its op sequence."""
    out = torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))
    return torch.where(torch.isnan(x), x, out)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None, mesh=None
                 ) -> torch.Tensor:
    """Depthwise causal conv: x (B,S,C), w (W,C). If `state` (B,W-1,C) is
    given it provides left context (prefill continuation). Over a
    ``mesh`` w's gradient sums the rank's rows in f32 (``row_weight``)."""
    width = w.shape[0]
    if state is None:
        ctx = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                          dtype=x.dtype, device=x.device)
    else:
        ctx = state.to(x.dtype)
    full = torch.cat([ctx, x], dim=1)
    out = torch.zeros_like(x)
    s = x.shape[1]
    for i in range(width):
        out = out + row_weight(full[:, i:i + s], w[i], mesh)
    return out


def _conv_tail(x: torch.Tensor, width: int) -> torch.Tensor:
    """The decode cache of a prefill over x (B,S,C): its last W-1 rows,
    behind the zeros ``_causal_conv`` assumes before the first token, so
    a prompt shorter than W-1 leaves a full cache."""
    s = x.shape[1]
    if s >= width - 1:
        return x[:, s - (width - 1):]
    pad = torch.zeros((x.shape[0], width - 1 - s, x.shape[2]),
                      dtype=x.dtype, device=x.device)
    return torch.cat([pad, x], dim=1)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, dA: torch.Tensor,
                bm: torch.Tensor, cm: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD dual form.

    x (B,S,H,P), dt/dA (B,S,H) f32, bm/cm (B,S,G,N).
    Returns (y (B,S,H,P), final_state (B,H,P,N) f32)."""
    b, s_orig, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    q = min(chunk, s_orig)
    pad = (-s_orig) % q
    if pad:
        # Zero-padding is exact: padded steps have dt=0 => no state update,
        # zero decay contribution, zero output rows (sliced off below).
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        dA = F.pad(dA, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, 0, 0, pad))
    s = s_orig + pad
    nc = s // q
    rep = h // g

    def c(t):  # chunk reshape (B,S,...) -> (B,nc,Q,...)
        return t.reshape((b, nc, q) + tuple(t.shape[2:]))

    xc = c(x)
    dtc = c(dt)
    dac = c(dA)
    bc = c(bm).repeat_interleave(rep, dim=3)  # (B,nc,Q,H,N)
    cc = c(cm).repeat_interleave(rep, dim=3)

    a_cs = torch.cumsum(dac, dim=2)  # (B,nc,Q,H) cumulative log-decay

    # --- intra-chunk (quadratic within Q) ---------------------------------
    # scores[i,j] = (C_i . B_j) * exp(a_i - a_j) * dt_j   for i >= j
    cb = _f32_einsum("bcqhn,bckhn->bcqkh", cc, bc)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    # Above the diagonal a_i - a_j is the decay summed over the steps
    # between, which passes float32's exp range within a chunk of 128 at
    # dt near 0.7; the reference takes exp there and masks the product,
    # so its backward multiplies the mask's zero by inf (NaN gradients).
    # Masked to -inf before the exp, those entries are 0: the forward is
    # the same bits, and the backward finite.
    tri5 = tri[None, None, :, :, None]
    decay = torch.exp(torch.where(
        tri5, a_cs[:, :, :, None, :] - a_cs[:, :, None, :, :], -torch.inf))
    scores = cb * decay * dtc[:, :, None, :, :]
    scores = torch.where(tri5, scores, 0.0)
    y_intra = _f32_einsum("bcqkh,bckhp->bcqhp", scores.to(x.dtype), xc)

    # --- chunk states ------------------------------------------------------
    # state_c = sum_j exp(a_last - a_j) * dt_j * B_j (x) x_j
    w = torch.exp(a_cs[:, :, -1:, :] - a_cs) * dtc  # (B,nc,Q,H)
    states = _f32_einsum("bckh,bckhn,bckhp->bchpn", w.to(x.dtype), bc, xc)

    # --- inter-chunk linear scan -------------------------------------------
    chunk_decay = torch.exp(a_cs[:, :, -1, :])  # (B,nc,H)
    s_prev = (torch.zeros((b, h, p, n), dtype=torch.float32,
                          device=x.device)
              if initial_state is None else initial_state.to(torch.float32))
    prev = []
    for ci in range(nc):
        prev.append(s_prev)
        s_prev = s_prev * chunk_decay[:, ci, :, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)  # (B,nc,H,P,N)

    y_inter = _f32_einsum("bcqh,bcqhn,bchpn->bcqhp",
                          torch.exp(a_cs).to(x.dtype), cc,
                          prev_states.to(x.dtype))
    y = (y_intra + y_inter).reshape(b, s, h, p)[:, :s_orig]
    return y.to(x.dtype), s_prev


def _gated_norm(w, g: torch.Tensor, dtype, width: int, tp=None, mesh=None,
                eps: float = 1e-6) -> torch.Tensor:
    """``rmsnorm(w, g)`` over the whole ``width`` channels, where ``g``
    (f32) and ``w`` are this rank's block of them over ``"model"`` when
    ``tp`` (the mesh) is given: the f32 sum of squares is summed over
    ``"model"`` and divided by ``width``. Without a split it is
    ``rmsnorm`` itself, whose mean need not round as a sum divided by
    ``width`` does."""
    if tp is None:
        return rmsnorm(w, g, eps, dtype=dtype, mesh=mesh)
    var = psum(torch.sum(g * g, dim=-1, keepdim=True), tp, TP) / width
    return row_weight((g * torch.rsqrt(var + eps)).to(dtype), w, mesh)


def _rank_groups(t: torch.Tensor, dims: SSMDims, heads: int, r: int
                 ) -> torch.Tensor:
    """``t`` (..., n_groups, d_state), whole, as the groups that the
    rank's ``heads`` heads (its block ``r``) read: all of them where there
    is one group (each head reads it) or the rank holds every head, else
    the rank's run of groups."""
    if dims.n_groups == 1 or heads == dims.n_heads:
        return t
    rep = dims.n_heads // dims.n_groups
    if heads % rep:
        raise ValueError(f"{heads} heads a rank do not hold whole groups of "
                         f"{rep}")
    return t.narrow(-2, r * heads // rep, heads // rep)


def ssm_block(p, x: torch.Tensor, cfg: ArchConfig,
              cache: Optional[dict] = None, pos=None,
              return_cache: bool = False,
              res: Optional[torch.Tensor] = None):
    """Full Mamba2 block. x (B,S,d); with ``res`` (the residual stream)
    the block's output is added to it in x's dtype.

    Forward: cache=None. Prefill: return_cache=True -> returns
    (out, cache). Decode: cache given, S==1 -> recurrent update (``pos``
    is not read: the state carries the position). Over a mesh the leaves
    are ``LocalShard``s and the block computes the rank's share (the
    module docstring); the cache is the rank's block of it."""
    dims = ssm_dims(cfg)
    b, s, d = x.shape
    decode = cache is not None and s == 1 and not return_cache

    x = hint(x, "batch", "seq", None)
    wz, wx, wdt = (tp_leaf(p[k], 1) for k in ("wz", "wx", "wdt"))
    wo = tp_leaf(p["wo"], 0)
    if not wz.n == wx.n == wo.n or (wx.n > 1) != (wdt.n > 1):
        raise ValueError(f"the SSM's ffn and ssm_heads split differently "
                         f"over 'model': {wz.n}, {wx.n}, {wdt.n}, {wo.n}")
    mesh = wx.mesh                      # None on plain tensors
    tp = mesh if wx.n > 1 else None     # the "model" split it computes on
    q = {k: tp_leaf(p[k], dim).t for k, dim in (
        ("wB", 1), ("wC", 1), ("conv_x", 1), ("conv_B", 1), ("conv_C", 1),
        ("dt_bias", 0), ("A_log", 0), ("Dskip", 0), ("norm", 0))}
    heads, inner = wdt.t.shape[-1], wx.t.shape[-1]     # the rank's share
    z = column_in(x, cast(wz.t, x.dtype), tp)
    xin = hint(column_in(x, cast(wx.t, x.dtype), tp), "batch", "seq", "ffn")
    bproj = x @ cast(q["wB"], x.dtype)
    cproj = x @ cast(q["wC"], x.dtype)
    dt = column_in(x, cast(wdt.t, x.dtype), tp).to(torch.float32)

    def rank_bc(t):
        # B or C whole, repeated to the rank's heads over "model"; its
        # gradient sums every rank's heads as the mesh-free repeat does
        g = _rank_groups(t, dims, heads, wdt.r)
        return repeat_in(g, heads // g.shape[-2], tp)

    if decode:
        new_cache = {}
        window_x = torch.cat([cache["conv_x"].to(x.dtype), xin], 1)
        window_b = torch.cat([cache["conv_B"].to(x.dtype), bproj], 1)
        window_c = torch.cat([cache["conv_C"].to(x.dtype), cproj], 1)
        new_cache["conv_x"] = window_x[:, 1:]
        new_cache["conv_B"] = window_b[:, 1:]
        new_cache["conv_C"] = window_c[:, 1:]
        xin = torch.einsum("bwc,wc->bc", window_x,
                           cast(q["conv_x"], x.dtype))
        bproj = torch.einsum("bwc,wc->bc", window_b,
                             cast(q["conv_B"], x.dtype))
        cproj = torch.einsum("bwc,wc->bc", window_c,
                             cast(q["conv_C"], x.dtype))
        xin, bproj, cproj = (_silu(t) for t in (xin, bproj, cproj))

        dtv = _softplus(dt[:, 0] + q["dt_bias"].to(torch.float32))
        a = -torch.exp(q["A_log"].to(torch.float32))  # (H,)
        da = torch.exp(dtv * a)  # (B,H)
        xh = xin.reshape(b, heads, dims.head_dim)
        bg, cg = (rank_bc(t.reshape(b, dims.n_groups, dims.d_state))
                  for t in (bproj, cproj))
        bh = bg.repeat_interleave(heads // bg.shape[1], dim=1)
        ch = cg.repeat_interleave(heads // cg.shape[1], dim=1)
        state = hint(cache["state"].to(torch.float32),
                     "batch", "ssm_heads", None, None)
        state = state * da[:, :, None, None] + _f32_einsum(
            "bh,bhn,bhp->bhpn", dtv, bh, xh)
        y = _f32_einsum("bhn,bhpn->bhp", ch, state)
        y = y + q["Dskip"].to(torch.float32)[None, :, None] \
            * xh.to(torch.float32)
        y = y.reshape(b, 1, inner).to(x.dtype)
        new_cache["state"] = state
        z = z.reshape(b, 1, inner)
    else:
        xin_raw, b_raw, c_raw = xin, bproj, cproj
        xin = _silu(_causal_conv(xin, q["conv_x"], mesh=mesh))
        bproj = _silu(_causal_conv(bproj, q["conv_B"], mesh=mesh))
        cproj = _silu(_causal_conv(cproj, q["conv_C"], mesh=mesh))
        dtv = _softplus(dt + q["dt_bias"].to(torch.float32))
        a = -torch.exp(q["A_log"].to(torch.float32))
        da = dtv * a  # (B,S,H) log-decay
        xh = xin.reshape(b, s, heads, dims.head_dim)
        bh, ch = (rank_bc(t.reshape(b, s, dims.n_groups, dims.d_state))
                  for t in (bproj, cproj))
        init_state = cache["state"] if cache is not None else None
        y, final_state = ssd_chunked(xh, dtv, da, bh, ch, cfg.ssm.chunk,
                                     init_state)
        y = y + q["Dskip"].to(x.dtype)[None, None, :, None] * xh
        y = y.reshape(b, s, inner)
        if return_cache:
            new_cache = {"conv_x": _conv_tail(xin_raw, dims.conv_w),
                         "conv_B": _conv_tail(b_raw, dims.conv_w),
                         "conv_C": _conv_tail(c_raw, dims.conv_w),
                         "state": final_state}

    # the gate product feeds rmsnorm's f32 statistics unrounded, as in
    # the reference's compiled layer body (see transformer._residual)
    gated = y.to(torch.float32) * _silu(z).to(torch.float32)
    y = _gated_norm(q["norm"], gated, x.dtype, dims.d_inner, tp, mesh)
    out = row_parallel(y, wo.t, wo, res, x.dtype)
    if decode or return_cache:
        return out, new_cache
    return out


def ssm_cache_defs(cfg: ArchConfig, layers: int, batch: int,
                   dtype=torch.bfloat16):
    """ParamDefs of the decode cache."""
    dims = ssm_dims(cfg)
    w = dims.conv_w
    return {
        "conv_x": ParamDef((layers, batch, w - 1, dims.d_inner),
                           ("layers", "batch", None, "ffn"), dtype,
                           init="zeros"),
        "conv_B": ParamDef((layers, batch, w - 1, dims.gn),
                           ("layers", "batch", None, None), dtype,
                           init="zeros"),
        "conv_C": ParamDef((layers, batch, w - 1, dims.gn),
                           ("layers", "batch", None, None), dtype,
                           init="zeros"),
        "state": ParamDef((layers, batch, dims.n_heads, dims.head_dim,
                           dims.d_state),
                          ("layers", "batch", "ssm_heads", None, None),
                          torch.float32, init="zeros"),
    }
