"""The port's models against the reference, on the CPU: every family
(dense, gemma3, vlm, MoE, SSM, hybrid, encoder-decoder).

Components take the same seeded numpy inputs through both packages:
float32 within rtol 1e-5 / atol 1e-5 (only the order of f32 sums may
differ), bf16 within two bf16 ulps (rtol 1.6e-2, atol 1e-3). Whole models
carry the reference's ``init(PRNGKey(0))`` across with
``convert.params_from_numpy`` and compare ``forward``, ``prefill``
(logits and caches) and four teacher-forced ``decode_step``s by
``max|port - ref| / max|ref|``, at most 5e-2: half the bound the
reference puts between its own decode and forward paths
(``tests/test_models.py``). The port's own decode-vs-forward stays under
that 1e-1.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY, get_config
from repro.models import attention as ja
from repro.models import build_model as ref_build
from repro.models import layers as jl
from repro.models import ssm as jssm
from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.configs import REGISTRY as PORT_REGISTRY
from repro_torch.models import attention as ta
from repro_torch.models import build_model
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt

ARCHS = sorted(REGISTRY)
# zamba2's reduced stack is chaotic at the reference's init: its shared
# attention block is a near-hard max (scores of std ~16), so an ulp of
# difference in an SSM layer's f32 transcendentals (XLA's exp and log1p
# are not the CPU library's) flips a key and moves whole rows. The
# reference's own eager and jitted forwards differ by 0.067 there, and its
# decode by 0.41 from its forward on these inputs. Its whole-model
# comparison is made group by group on the reference's residual stream
# (``test_hybrid_groups_match_reference``).
CHAOTIC = {"zamba2-2.7b"}
END_TO_END = [a for a in ARCHS if a not in CHAOTIC]
BOUND = 5e-2                # whole-model max-rel against the reference
SELF_BOUND = 1e-1           # decode vs forward (tests/test_models.py)
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=1.6e-2, atol=1e-3)
DTYPES = {"f32": (jnp.float32, torch.float32, F32),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16)}


def both(x, dtype):
    """One float32 numpy array as (jax, torch) arrays of ``dtype`` (both
    round to nearest even: the same bits)."""
    jd, td, _ = DTYPES[dtype]
    x = np.asarray(x, np.float32)
    return jnp.asarray(x).astype(jd), torch.from_numpy(x.copy()).to(td)


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    diff = np.abs(got.float().numpy() - want).max()
    return float(diff / (np.abs(want).max() + 1e-9))


# -- components ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    wj, wt = both(1 + normal(rng, 64, scale=0.1), "f32")
    xj, xt = both(normal(rng, 2, 7, 64, scale=3.0), dtype)
    close(tl.rmsnorm(wt, xt, 1e-6), jl.rmsnorm(wj, xj, 1e-6),
          DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("per_layer", [False, True])
def test_rope(dtype, per_layer):
    """Scalar theta, and gemma3's per-layer thetas as the stack hands
    them to each layer."""
    rng = np.random.default_rng(1)
    xj, xt = both(normal(rng, 2, 9, 3, 16), dtype)
    pos = rng.integers(0, 300, (2, 9)).astype(np.int32)
    cfg = get_config("gemma3-1b").reduced()
    if per_layer:
        pairs = list(zip(np.asarray(jt.layer_thetas(cfg)),
                         tt.layer_thetas(cfg)))
    else:
        pairs = [(1_000_000.0, 1_000_000.0)]
    for jth, tth in pairs:
        close(tl.rope(xt, torch.from_numpy(pos), tth),
              jl.rope(xj, jnp.asarray(pos), jth), DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mrope(dtype):
    rng = np.random.default_rng(2)
    xj, xt = both(normal(rng, 2, 5, 4, 16), dtype)
    pos = rng.integers(0, 200, (3, 2, 5)).astype(np.int32)
    close(tl.mrope(xt, torch.from_numpy(pos), 1e6, (2, 3, 3)),
          jl.mrope(xj, jnp.asarray(pos), 1e6, (2, 3, 3)), DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp(dtype, act):
    rng = np.random.default_rng(3)
    pj, pt = {}, {}
    for name, shape in (("w1", (32, 48)), ("w3", (32, 48)),
                        ("w2", (48, 32))):
        pj[name], pt[name] = both(normal(rng, *shape, scale=0.2), "f32")
    xj, xt = both(normal(rng, 2, 6, 32), dtype)
    close(tl.mlp(pt, xt, act), jl.mlp(pj, xj, act), DTYPES[dtype][2])


def test_activations_round_where_the_reference_rounds():
    """In bf16 the port's activations are the reference's op sequence,
    rounded where XLA rounds: at most one element in a thousand may
    differ (f32 transcendentals of the two libraries), against 27-43%
    for ``F.silu`` and ``F.gelu``."""
    rng = np.random.default_rng(4)
    xj, xt = both(normal(rng, 256, 128, scale=3.0), "bf16")
    for name, fn in (("silu", jax.nn.silu), ("gelu", jax.nn.gelu)):
        got = tl._act(name, xt).float().numpy()
        want = np.asarray(fn(xj).astype(jnp.float32))
        assert np.mean(got != want) <= 1e-3, name
        np.testing.assert_allclose(got, want, **BF16)


FLASH_CASES = {
    # name: (b, sq, skv, hq, hkv, causal, window, q_offset, block_kv)
    "gqa": (2, 9, 9, 8, 2, True, None, 0, 4),
    "window": (2, 13, 13, 4, 4, True, 5, 0, 8),
    "padded_tail": (1, 21, 21, 4, 2, True, None, 0, 8),
    "q_offset": (2, 4, 19, 4, 1, True, None, 15, 8),
    "full_cross": (2, 6, 11, 4, 2, False, None, 0, 4),
    "window_offset_tail": (1, 5, 23, 6, 3, True, 9, 18, 16),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention(dtype, case):
    b, sq, skv, hq, hkv, causal, window, q_offset, bkv = FLASH_CASES[case]
    rng = np.random.default_rng(5)
    qj, qt = both(normal(rng, b, sq, hq, 16), dtype)
    kj, kt = both(normal(rng, b, skv, hkv, 16), dtype)
    vj, vt = both(normal(rng, b, skv, hkv, 16), dtype)
    got = ta.flash_attention(qt, kt, vt, causal=causal, window=window,
                             q_offset=q_offset, block_kv=bkv)
    want = ja.flash_attention(
        qj, kj, vj, causal=causal,
        window=None if window is None else jnp.asarray(window),
        q_offset=q_offset, block_kv=bkv)
    assert got.dtype == DTYPES[dtype][1] and got.shape == want.shape
    close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("window", [None, 4])
def test_decode_attention(dtype, window):
    rng = np.random.default_rng(6)
    qj, qt = both(normal(rng, 3, 1, 8, 16), dtype)
    kj, kt = both(normal(rng, 3, 12, 2, 16), dtype)
    vj, vt = both(normal(rng, 3, 12, 2, 16), dtype)
    pos = np.array([0, 5, 11], np.int32)
    got = ta.decode_attention(qt, kt, vt, torch.from_numpy(pos), window)
    want = ja.decode_attention(
        qj, kj, vj, jnp.asarray(pos),
        None if window is None else jnp.asarray(window))
    close(got, want, DTYPES[dtype][2])


def test_update_cache():
    """The masked write is exact: same bits, one position a sequence."""
    rng = np.random.default_rng(7)
    kj, kt = both(normal(rng, 3, 10, 2, 4), "bf16")
    vj, vt = both(normal(rng, 3, 10, 2, 4), "bf16")
    knj, knt = both(normal(rng, 3, 1, 2, 4), "f32")
    vnj, vnt = both(normal(rng, 3, 1, 2, 4), "f32")
    pos = np.array([0, 4, 9], np.int32)
    got = ta.update_cache(kt, vt, knt, vnt, torch.from_numpy(pos))
    want = ja.update_cache(kj, vj, knj, vnj, jnp.asarray(pos))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert np.array_equal(g.float().numpy(), np.asarray(w, np.float32))


@pytest.mark.parametrize("n,d", [(24, 64), (1500, 768), (7, 2)])
def test_sinusoidal_positions(n, d):
    """Whisper's position table in f32. The two libraries' exp may differ
    by an ulp in a frequency, which moves an angle of up to n radians by
    an ulp of n: the table agrees to that, n * 2^-23, and to the f32
    tolerance elsewhere."""
    got = tl.sinusoidal_positions(n, d, "cpu")
    assert got.dtype == torch.float32 and got.shape == (n, d)
    close(got, jl.sinusoidal_positions(n, d),
          dict(rtol=1e-5, atol=max(1e-5, n * 2.0 ** -23)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("bias", [False, True])
def test_cross_qkv(dtype, bias):
    """Whisper's cross-attention projections: q from the decoder, k and v
    from the encoder output, with and without the q/k/v biases (the
    port's ``_qkv`` of the two inputs)."""
    rng = np.random.default_rng(8)
    pj, pt = {}, {}
    shapes = {"wq": (32, 4, 8), "wk": (32, 2, 8), "wv": (32, 2, 8)}
    if bias:
        shapes.update(bq=(4, 8), bk=(2, 8), bv=(2, 8))
    for name, shape in shapes.items():
        pj[name], pt[name] = both(normal(rng, *shape, scale=0.2), "f32")
    xj, xt = both(normal(rng, 2, 5, 32), dtype)
    ej, et = both(normal(rng, 2, 11, 32), dtype)
    for got, want in zip(tt._qkv(pt, xt, et)[:3],
                         jt._cross_qkv(pj, xj, ej)):
        assert got.shape == want.shape
        close(got, want, DTYPES[dtype][2])


# -- whole models ---------------------------------------------------------------

B, S, STEPS = 2, 16, 4


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(cfg, rng):
    """The family's extra inputs (vision embeddings, whisper frames) as
    numpy arrays."""
    if cfg.family == "vlm":
        return {"vision_embeds": normal(rng, B, cfg.vision_tokens,
                                        cfg.d_model),
                "vision_positions": np.tile(
                    np.arange(cfg.vision_tokens, dtype=np.int32)[None],
                    (B, 1))}
    if cfg.enc_dec:
        return {"frames": normal(rng, B, cfg.n_frames, cfg.d_model)}
    return {}


@functools.lru_cache(maxsize=None)
def _run(arch, grid=False):
    """Both packages on the reduced config with the reference's weights:
    forward over S+STEPS tokens, prefill over S, then STEPS teacher-
    forced decode steps. With ``grid`` the batch is ``chip_smoke.py``'s
    (``lm_batch``: the VLM's image on a grid of M-RoPE positions). Returns
    (ref outputs, port outputs); the port's also hold ``dropped``, the
    tokens each of its MoE calls dropped."""
    cfg = get_config(arch).reduced()
    ref_model = ref_build(cfg)
    params = ref_model.init(jax.random.PRNGKey(0))
    model = build_model(PORT_REGISTRY[arch].reduced())
    tp = model.load(convert.params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu"))
    if grid:
        batch = _chip_smoke().lm_batch(cfg, B, S + STEPS, prompt=S, seed=11)
    else:
        rng = np.random.default_rng(11)
        toks = rng.integers(0, cfg.vocab, (B, S + STEPS)).astype(np.int32)
        batch = dict(_inputs(cfg, rng), tokens=toks)
    toks = batch["tokens"]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pb = {k: torch.from_numpy(v) for k, v in batch.items()}
    prompt_part = _chip_smoke().prompt_part
    out = {"ref": {}, "port": {}}
    # chip_smoke.py's record of each moe._moe_local call: (expert ids,
    # the tokens that lost an assignment to capacity)
    with _chip_smoke()._Routing() as routing:
        out["ref"]["forward"] = ref_model.forward(params, jb)[0]
        out["port"]["forward"] = model.forward(tp, pb)[0]
        skv = S + STEPS
        jl_, jc = ref_model.prefill(params, prompt_part(jb, S), skv=skv)
        tl_, tc = model.prefill(tp, prompt_part(pb, S), skv=skv)
        out["ref"]["prefill"], out["port"]["prefill"] = jl_, tl_
        out["ref"]["cache"], out["port"]["cache"] = jc, tc
        for i in range(STEPS):
            t = toks[:, S + i:S + i + 1]
            p = np.full((B,), S + i, np.int32)
            jl_, jc = ref_model.decode_step(
                params, jc, {"tokens": jnp.asarray(t),
                             "pos": jnp.asarray(p)})
            tl_, tc = model.decode_step(
                tp, tc, {"tokens": torch.from_numpy(t),
                         "pos": torch.from_numpy(p)})
            out["ref"][f"decode{i}"], out["port"][f"decode{i}"] = jl_, tl_
    out["port"]["dropped"] = [dropped for _, dropped in routing.calls]
    return out["ref"], out["port"]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", END_TO_END)
def test_forward_matches_reference(arch):
    ref, port = _run(arch)
    assert port["forward"].shape == ref["forward"].shape
    assert rel(port["forward"], ref["forward"]) <= BOUND


@pytest.mark.parametrize("arch", END_TO_END)
def test_prefill_logits_and_caches_match_reference(arch):
    """The logits, and every leaf of the cache tree (k/v in bf16, the
    SSM's conv windows in bf16 and its state in f32)."""
    ref, port = _run(arch)
    assert rel(port["prefill"], ref["prefill"]) <= BOUND
    got = dict(_leaves(port["cache"]))
    want = dict(_leaves(ref["cache"]))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert str(g.dtype)[6:] == jnp.dtype(w.dtype).name, path
        assert g.shape == w.shape, path
        assert rel(g, w) <= BOUND, path


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("arch", END_TO_END)
def test_decode_steps_match_reference(arch, step):
    ref, port = _run(arch)
    assert rel(port[f"decode{step}"], ref[f"decode{step}"]) <= BOUND


@pytest.mark.parametrize("arch", END_TO_END)
def test_port_decode_matches_its_forward(arch):
    """The port's prefill + decode against its own forward, under the
    reference's bound between its two paths. An MoE forward sizes each
    expert's capacity for all its tokens, a decode step for one token a
    slot, so the forward (and the prefill) can drop an assignment that
    the decode keeps: the bound holds on the rows where neither dropped
    one that reaches the compared position (at the position itself, or
    before it below the last layer, whose outputs later positions read
    through attention)."""
    _, port = _run(arch)
    dropped = port["dropped"]
    n_layers = get_config(arch).reduced().n_layers
    fwd = torch.zeros((n_layers, B, S + STEPS), dtype=torch.bool)
    pre = torch.zeros((n_layers, B, S), dtype=torch.bool)
    if dropped:
        fwd = torch.stack(dropped[:n_layers]).reshape(n_layers, B, -1)
        pre = torch.stack(dropped[n_layers:2 * n_layers]).reshape(
            n_layers, B, -1)
        assert not torch.stack(dropped[2 * n_layers:]).any()  # decode
    held = 0
    for i in range(STEPS):
        q = S + i
        clean = ~(fwd[:, :, q].any(0) | fwd[:-1, :, :q].any((0, 2))
                  | pre[:-1].any((0, 2)))
        if clean.any():
            want = port["forward"][clean, q].float().numpy()
            assert rel(port[f"decode{i}"][clean], want) < SELF_BOUND, i
            held += 1
    assert held > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_port_decode_matches_its_forward_in_the_reference_setting(arch):
    """The reference suite's ``test_arch_decode_matches_forward`` on the
    port: its batch (``jax.random`` tokens, vision embeddings and frames
    from its keys), prefill over 16 tokens, one decode step against the
    forward's logits, under its bound."""
    cfg = get_config(arch).reduced()
    key = jax.random.PRNGKey(0)
    model = build_model(PORT_REGISTRY[arch].reduced())
    tp = model.load(convert.params_from_numpy(jax.tree.map(
        np.asarray, ref_build(cfg).init(key)), device="cpu"))
    b, s = 2, 16
    toks = torch.from_numpy(np.array(jax.random.randint(
        jax.random.PRNGKey(1), (b, s + 1), 0, cfg.vocab)))
    extra = {}
    if cfg.family == "vlm":
        extra = {"vision_embeds": jax.random.normal(
                     key, (b, cfg.vision_tokens, cfg.d_model)),
                 "vision_positions": jnp.tile(
                     jnp.arange(cfg.vision_tokens)[None], (b, 1))}
    if cfg.enc_dec:
        extra = {"frames": jax.random.normal(key, (b, cfg.n_frames,
                                                   cfg.d_model))}
    extra = {k: torch.from_numpy(np.array(v)) for k, v in extra.items()}
    want = model.forward(tp, dict(extra, tokens=toks))[0][:, s]
    _, caches = model.prefill(tp, dict(extra, tokens=toks[:, :s]),
                              skv=s + 4)
    got, _ = model.decode_step(tp, caches, {
        "tokens": toks[:, s:s + 1],
        "pos": torch.full((b,), s, dtype=torch.int32)})
    assert rel(got, want.float().numpy()) < SELF_BOUND


# -- qwen2-vl, image on a grid of M-RoPE positions ---------------------------

GRID = "qwen2-vl-7b"


@pytest.mark.parametrize("phase", ["forward", "prefill"] +
                         [f"decode{i}" for i in range(STEPS)])
def test_vlm_image_grid_positions_match_reference(phase):
    """qwen2-vl's reduced model on ``chip_smoke.py``'s VLM batch
    (``lm_batch``, as the card runs it): 8 image embeddings written at
    positions 0-7, their M-RoPE positions a 2 x 4 grid (t = 0, h = row,
    w = column: three streams that differ), the text from the grid's
    largest position + 1 on, the decoded tokens at their index; the
    prefill takes ``prompt_part``. The logits, and every cache leaf of
    the prefill, within the whole-model bound, and the first layer's
    rotated keys (its input the same on both sides) element by element
    within two bf16 ulps. A model that read the t stream for all three
    moves the forward's logits 0.23 from the reference's."""
    cfg = get_config(GRID).reduced()
    pos = _chip_smoke().lm_batch(cfg, B, S + STEPS, prompt=S,
                                 seed=11)["mrope_positions"]
    n = cfg.vision_tokens
    assert len({tuple(r) for r in pos[:, 0, :n]}) == 3
    assert (pos[:, 0, n:S] != np.arange(n, S)).all()
    ref, port = _run(GRID, grid=True)
    assert port[phase].shape == ref[phase].shape
    assert rel(port[phase], ref[phase]) <= BOUND
    if phase == "prefill":
        want = dict(_leaves(ref["cache"]))
        for path, g in _leaves(port["cache"]):
            assert rel(g, want[path]) <= BOUND, path
        close(port["cache"]["self"]["k"][0], ref["cache"]["self"]["k"][0],
              BF16)


# -- gemma3, layer by layer with its window binding ---------------------------

WINDOWED = "gemma3-1b"
S_W = 40        # the prefill's tokens: past the reduced window of 32


@functools.lru_cache(maxsize=None)
def _windowed_layers():
    """gemma3's reduced stack (twelve layers: five local and one global,
    twice) layer by layer on the reference's residual stream, over S_W +
    STEPS tokens from ``chip_smoke.py``'s ``lm_batch``, so that each
    local layer's window binds in the forward, the prefill and every
    decode step. Each reference layer is its stack's scan body run by
    ``lax.scan`` over that layer alone, on the previous one's output (and
    in decode on its own caches from the prefill and the steps before);
    the port's layer (``_train_layer``; ``_attn_block``, ``_ffn_layer``
    and ``_kv_cache``; ``_decode_attn`` and ``_ffn_layer``) takes the
    same input. Returns {phase: [(name, port, ref), ...]}: the embedding,
    each layer's output and (prefill, decode) k and v cache, and the
    logits of the reference's final stream."""
    cfg = get_config(WINDOWED).reduced()
    pcfg = PORT_REGISTRY[WINDOWED].reduced()
    params = ref_build(cfg).init(jax.random.PRNGKey(0))
    tp = build_model(pcfg).load(convert.params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu"))
    to_port = functools.partial(convert.params_from_numpy, device="cpu")
    skv = S_W + STEPS
    toks = _chip_smoke().lm_batch(cfg, B, skv, prompt=S_W,
                                  seed=11)["tokens"]
    n = cfg.n_layers
    bkv = ja.DEFAULT_BLOCK_KV
    jw, jth = jt.layer_windows(cfg, skv), jt.layer_thetas(cfg)
    scalars = tt._layer_scalars(pcfg, skv)
    assert [w for w, _ in scalars] == np.asarray(jw).tolist()
    assert min(w for w, _ in scalars) < S_W
    ln = functools.partial(jl.rmsnorm, eps=cfg.norm_eps)

    def layer_xs(i, *caches):
        """Layer i's scan inputs, each with a leading axis of one."""
        one = lambda a: a[i:i + 1]   # noqa: E731
        return (jax.tree.map(one, params["layers"]),
                *(one(c) for c in caches), one(jw), one(jth))

    def stream(phase, body, x, caches=(), port_layer=None):
        """The reference's layers in turn from x, each beside the port's
        on the same input; returns (rows, the final x, the new caches)."""
        run = jax.jit(lambda x, xs: jax.lax.scan(body, x, xs))
        rows, new = [], []
        for i in range(n):
            y, c = run(x, layer_xs(i, *caches))
            got = port_layer(tt._layer(tp["layers"], i), to_port(
                np.asarray(x)), scalars[i], i)
            rows.append((f"layer{i} out", got[0], y))
            if c is not None:
                rows += [(f"layer{i} k", got[1], c["k"][0]),
                         (f"layer{i} v", got[2], c["v"][0])]
                new.append(c)
            x = y
        caches = None if not new else jax.tree.map(
            lambda *a: jnp.concatenate(a), *new)
        return rows, x, caches

    def logits(x, last):
        x = jl.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        xt = tl.rmsnorm(tp["final_norm"], to_port(np.asarray(x)),
                        cfg.norm_eps)
        if last:
            x, xt = x[:, -1], xt[:, -1]
        return ("logits", tl.unembed(tp, xt), jl.unembed(params, x))

    out = {}
    top = tt._top(tp)
    # forward over every token
    x = jt._embed_in(params, cfg, {"tokens": jnp.asarray(toks)})
    pos = jt._positions(cfg, {}, B, skv)
    tpos = torch.from_numpy(np.array(pos))

    def fwd_body(x, xs):
        lp, w, th = xs
        x = jt._attn_layer(lp, cfg, x, pos, th, w, bkv)
        return jt._ffn_layer(lp, cfg, x, None)[0], None

    rows, x, _ = stream("forward", fwd_body, x, port_layer=lambda lp, xt, sc,
                        i: (tt._train_layer(lp, pcfg, xt, tpos, sc[1], sc[0],
                                            bkv)[0],))
    out["forward"] = [("embed", tt._embed_in(
        top, pcfg, {"tokens": torch.from_numpy(toks)}),
        jt._embed_in(params, cfg, {"tokens": jnp.asarray(toks)}))] + rows + [
        logits(x, False)]

    # prefill over the first S_W tokens, the caches padded to skv
    x = jt._embed_in(params, cfg, {"tokens": jnp.asarray(toks[:, :S_W])})
    ppos = jt._positions(cfg, {}, B, S_W)
    tppos = torch.from_numpy(np.array(ppos))

    def pre_body(x, xs):
        lp, w, th = xs
        h = ln(lp["ln1"], x)
        q, k, v = ja.qkv_proj(lp["attn"], h)
        q, k = jt._apply_rope(cfg, q, k, ppos, th)
        o = ja.flash_attention(q, k, v, causal=True, window=w, block_kv=bkv)
        x = x + ja.out_proj(lp["attn"], o)
        x, _ = jt._ffn_layer(lp, cfg, x, None)
        return x, {"k": jt._pad_cache(k, skv), "v": jt._pad_cache(v, skv)}

    def pre_port(lp, xt, sc, i):
        xt, k, v = tt._attn_block(lp, pcfg, xt, tppos, sc[1], sc[0], bkv)
        k, v = tt._kv_cache(lp["attn"], pcfg, k, v, S_W, skv,
                            tt._WHOLE_CACHE, None)
        return tt._ffn_layer(lp, pcfg, xt), k, v

    rows, x, caches = stream("prefill", pre_body, x, port_layer=pre_port)
    out["prefill"] = rows + [logits(x, True)]

    # decode steps past the window, each on the caches before it
    cl = tt._WHOLE_CACHE._replace(skv=skv)
    for step in range(STEPS):
        t = toks[:, S_W + step:S_W + step + 1]
        p = np.full((B,), S_W + step, np.int32)
        jp, tpp = jnp.asarray(p), torch.from_numpy(p)
        x = jt._embed_in(params, cfg, {"tokens": jnp.asarray(t)})

        def dec_body(x, xs, jp=jp):
            lp, kc, vc, w, th = xs
            h = ln(lp["ln1"], x)
            q, k, v = ja.qkv_proj(lp["attn"], h)
            q, k = jt._apply_rope(cfg, q, k, jp[:, None], th)
            kc, vc = ja.update_cache(kc, vc, k, v, jp)
            o = ja.decode_attention(q, kc, vc, jp, window=w)
            x = x + ja.out_proj(lp["attn"], o)
            x, _ = jt._ffn_layer(lp, cfg, x, None)
            return x, {"k": kc, "v": vc}

        def dec_port(lp, xt, sc, i, caches=caches, tpp=tpp):
            kc, vc = (to_port(np.asarray(caches[k][i])) for k in "kv")
            y, kc, vc = tt._decode_attn(lp, pcfg, xt, kc, vc, tpp,
                                        tpp[:, None], sc[1], sc[0], cl,
                                        None)
            return tt._ffn_layer(lp, pcfg, tt._residual(xt, y)), kc, vc

        rows, x, caches = stream(f"decode{step}", dec_body, x,
                                 (caches["k"], caches["v"]), dec_port)
        out[f"decode{step}"] = [("embed", tt._scale_embed(
            pcfg, tl.embed(top, torch.from_numpy(t))), jt._embed_in(
            params, cfg, {"tokens": jnp.asarray(t)}))] + rows + [
            logits(x, True)]
    return out


@pytest.mark.parametrize("phase", ["forward", "prefill"] +
                         [f"decode{i}" for i in range(STEPS)])
def test_windowed_layers_match_reference(phase):
    """gemma3 (reduced: window 32, a global layer every 6 with its own
    rope theta) layer by layer on the reference's residual stream, over
    40 prompt tokens and 4 decode steps past the window: each layer's
    output and, in prefill and decode, its k and v cache (the bf16
    leaves the next step reads) within the whole-model bound. The whole
    model is not compared end to end: its reduced stack is chaotic at
    the reference's init (0.28 max-rel over these tokens, 0.22 with the
    window widened so that it never binds)."""
    rows = _windowed_layers()[phase]
    n = get_config(WINDOWED).reduced().n_layers
    assert len(rows) == 2 + n * (1 if phase == "forward" else 3) - (
        phase == "prefill")
    for name, got, want in rows:
        assert got.shape == tuple(want.shape), name
        assert rel(got, want) <= BOUND, name


# -- zamba2, group by group -----------------------------------------------------

HYBRID = "zamba2-2.7b"


def _ref_ssm_layer(cfg, **kw):
    """The reference stacks' SSM scan body (``transformer._ssm_forward``
    and its kin), as ``lax.scan`` runs it."""
    def body(x, xs):
        lp, cache = xs if isinstance(xs, tuple) else (xs, None)
        h = jl.rmsnorm(lp["ln"], x, cfg.norm_eps)
        lp_ssm = {k: v for k, v in lp.items() if k != "ln"}
        if cache is not None:
            kw["cache"] = cache
        out = jssm.ssm_block(lp_ssm, h, cfg, **kw)
        if isinstance(out, tuple):
            return x + out[0], out[1]
        return x + out, None
    return body


@functools.lru_cache(maxsize=None)
def _hybrid_groups():
    """zamba2's reduced stack run group by group: the reference's groups
    as its ``_hybrid_*`` functions run them (their final logits must
    equal the reference's own, bit for bit), and each of the port's
    groups (six SSM layers, then the shared block) on the reference's
    input to that group and, in decode, its caches. Returns
    {phase: [(name, port, ref), ...]} for forward, prefill and STEPS
    decode steps."""
    cfg = get_config(HYBRID).reduced()
    ref_model = ref_build(cfg)
    params = ref_model.init(jax.random.PRNGKey(0))
    tp = build_model(PORT_REGISTRY[HYBRID].reduced()).load(
        convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                  device="cpu"))
    per = cfg.shared_attn_every
    groups = cfg.n_layers // per
    gl = jax.tree.map(lambda a: a.reshape((groups, per) + a.shape[1:]),
                      params["layers"])
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab, (B, S + STEPS)).astype(np.int32)
    to_port = functools.partial(convert.params_from_numpy, device="cpu")
    out = {}

    def run(phase, n, **kw):
        """Both packages over tokens[:, :n] (prefill: with caches)."""
        cache = kw.get("return_cache", False)
        x = jt._embed_in(params, cfg, {"tokens": jnp.asarray(toks[:, :n])})
        jpos = jt._positions(cfg, {}, B, n)
        tpos = torch.from_numpy(np.array(jpos))
        rows, caches = [], []
        for g in range(groups):
            lp_g = jax.tree.map(lambda a: a[g], gl)
            xt = to_port(np.asarray(x))
            y, c = jax.lax.scan(_ref_ssm_layer(cfg, **kw), x, lp_g)
            for i in range(g * per, (g + 1) * per):
                o = tt._ssm_layer(tt._layer(tp["layers"], i), cfg, xt, **kw)
                xt, ct = o if cache else (o, None)
                if cache:
                    rows += [(f"group{g} layer{i} ssm {k}", ct[k],
                              c[k][i - g * per]) for k in ct]
            rows.append((f"group{g} ssm out", xt, y))
            x, (k, v) = jt._shared_block(params["shared"], cfg, y, jpos,
                                         1024)
            xt, (kt, vt) = tt._shared_block(tp["shared"], cfg,
                                            to_port(np.asarray(y)), tpos,
                                            1024)
            rows.append((f"group{g} shared out", xt, x))
            if cache:
                rows += [(f"group{g} shared k", kt, k),
                         (f"group{g} shared v", vt, v)]
                caches.append((c, jt._pad_cache(k, S + STEPS),
                               jt._pad_cache(v, S + STEPS)))
        x = jl.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        xt = tl.rmsnorm(tp["final_norm"], to_port(np.asarray(x)),
                        cfg.norm_eps)
        logits = jl.unembed(params, x if not cache else x[:, -1])
        rows.append(("logits", tl.unembed(tp, xt if not cache
                                          else xt[:, -1]), logits))
        out[phase] = rows
        return logits, caches

    logits, _ = run("forward", S + STEPS)
    assert np.array_equal(np.asarray(logits), np.asarray(ref_model.forward(
        params, {"tokens": jnp.asarray(toks)})[0]))
    logits, caches = run("prefill", S, return_cache=True)
    want, jc = ref_model.prefill(params, {"tokens": jnp.asarray(toks[:, :S])},
                                 skv=S + STEPS)
    assert np.array_equal(np.asarray(logits), np.asarray(want))
    for step in range(STEPS):
        t = toks[:, S + step:S + step + 1]
        p = np.full((B,), S + step, np.int32)
        x = jl.embed(params, jnp.asarray(t))
        rows = []
        new_ssm, new_k, new_v = [], [], []
        for g in range(groups):
            lp_g = jax.tree.map(lambda a: a[g], gl)
            cache_g = jax.tree.map(lambda a: a[g * per:(g + 1) * per],
                                   jc["ssm"])
            xt = to_port(np.asarray(x))
            y, c = jax.lax.scan(_ref_ssm_layer(cfg), x, (lp_g, cache_g))
            for i in range(g * per, (g + 1) * per):
                xt, ct = tt._ssm_layer(
                    tt._layer(tp["layers"], i), cfg, xt,
                    cache=to_port(jax.tree.map(lambda a: np.asarray(a[i]),
                                               jc["ssm"])))
                rows += [(f"group{g} layer{i} ssm {k}", ct[k],
                          c[k][i - g * per]) for k in ct]
            rows.append((f"group{g} ssm out", xt, y))
            kv = (jc["shared"]["k"][g], jc["shared"]["v"][g])
            x, (kc, vc) = jt._shared_block(
                params["shared"], cfg, y, jnp.asarray(p)[:, None], 1024,
                kv_cache=kv, pos=jnp.asarray(p))
            xt, (kt, vt) = tt._shared_block(
                tp["shared"], cfg, to_port(np.asarray(y)),
                torch.from_numpy(p)[:, None], 1024,
                kv_cache=tuple(to_port(np.asarray(a)) for a in kv),
                pos=torch.from_numpy(p))
            rows += [(f"group{g} shared out", xt, x),
                     (f"group{g} shared k", kt, kc),
                     (f"group{g} shared v", vt, vc)]
            new_ssm.append(c)
            new_k.append(kc)
            new_v.append(vc)
        x = jl.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        xt = tl.rmsnorm(tp["final_norm"], to_port(np.asarray(x)),
                        cfg.norm_eps)
        logits = jl.unembed(params, x[:, -1])
        rows.append(("logits", tl.unembed(tp, xt[:, -1]), logits))
        want, jc = ref_model.decode_step(
            params, jc, {"tokens": jnp.asarray(t), "pos": jnp.asarray(p)})
        assert np.array_equal(np.asarray(logits), np.asarray(want))
        out[f"decode{step}"] = rows
    return out


@pytest.mark.parametrize("phase", ["forward", "prefill"] +
                         [f"decode{i}" for i in range(STEPS)])
def test_hybrid_groups_match_reference(phase):
    """zamba2 (reduced: two groups of six SSM layers, each followed by
    the weight-tied shared block), group by group on the reference's
    residual stream: each group's output, every layer's SSM cache, the
    shared block's k/v and the logits within the whole-model bound."""
    rows = _hybrid_groups()[phase]
    assert len(rows) > 4
    for name, got, want in rows:
        assert got.shape == tuple(want.shape), name
        assert rel(got, want) <= BOUND, name


@functools.lru_cache(maxsize=None)
def _hybrid_stack():
    """zamba2's reduced stack through the port's entry points
    (``model.forward``, ``prefill`` and STEPS ``decode_step``s, each step
    on the caches the entry points returned) beside the port's own
    groups chained by hand on its own residual stream: six SSM layers,
    then the shared block, group after group; in prefill the shared k/v
    zero-padded to skv, in decode layer i reading SSM cache i and group
    g the shared block's cache g. Returns {phase: [(name, stack, chain),
    ...]}: the logits and every cache leaf."""
    cfg = get_config(HYBRID).reduced()
    model = build_model(PORT_REGISTRY[HYBRID].reduced())
    tp = model.load(convert.params_from_numpy(jax.tree.map(
        np.asarray, ref_build(cfg).init(jax.random.PRNGKey(0))),
        device="cpu"))
    per, skv = cfg.shared_attn_every, S + STEPS
    groups = cfg.n_layers // per

    def chain(tokens, caches=None, pos=None, prefill=False):
        n = tokens.shape[1]
        x = tl.embed(tp, tokens)
        positions = (torch.arange(n)[None].expand(B, n) if pos is None
                     else pos[:, None])
        ssm, ks, vs = [], [], []
        for g in range(groups):
            for i in range(g * per, (g + 1) * per):
                lp = tt._layer(tp["layers"], i)
                if caches is not None:
                    x, c = tt._ssm_layer(lp, cfg, x, cache={
                        k: v[i] for k, v in caches["ssm"].items()})
                    ssm.append(c)
                elif prefill:
                    x, c = tt._ssm_layer(lp, cfg, x, return_cache=True)
                    ssm.append(c)
                else:
                    x = tt._ssm_layer(lp, cfg, x)
            kv = None if caches is None else (caches["shared"]["k"][g],
                                              caches["shared"]["v"][g])
            x, (k, v) = tt._shared_block(tp["shared"], cfg, x, positions,
                                         1024, kv_cache=kv, pos=pos)
            if prefill:
                k, v = (torch.cat([a.to(torch.bfloat16), torch.zeros(
                    (B, skv - n) + a.shape[2:], dtype=torch.bfloat16)], 1)
                        for a in (k, v))
            ks.append(k)
            vs.append(v)
        x = tl.rmsnorm(tp["final_norm"], x, cfg.norm_eps)
        if not ssm:
            return tl.unembed(tp, x), {}
        return tl.unembed(tp, x[:, -1]), {
            "ssm": {k: torch.stack([c[k] for c in ssm]) for k in ssm[0]},
            "shared": {"k": torch.stack(ks), "v": torch.stack(vs)}}

    def rows(stack, by_hand):
        (logits, caches), (want, want_caches) = stack, by_hand
        got, expect = dict(_leaves(caches)), dict(_leaves(want_caches))
        assert sorted(got) == sorted(expect)
        return [("logits", logits, want)] + [
            ("/".join(path), got[path], expect[path]) for path in expect]

    rng = np.random.default_rng(11)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S + STEPS))
                            .astype(np.int32))
    out = {"forward": rows((model.forward(tp, {"tokens": toks})[0], {}),
                           chain(toks))}
    stack = model.prefill(tp, {"tokens": toks[:, :S]}, skv=skv)
    out["prefill"] = rows(stack, chain(toks[:, :S], prefill=True))
    caches = stack[1]
    for step in range(STEPS):
        t = toks[:, S + step:S + step + 1]
        p = torch.full((B,), S + step, dtype=torch.int32)
        stack = model.decode_step(tp, caches, {"tokens": t, "pos": p})
        out[f"decode{step}"] = rows(stack, chain(t, caches, p))
        caches = stack[1]
    return out


@pytest.mark.parametrize("phase", ["forward", "prefill"] +
                         [f"decode{i}" for i in range(STEPS)])
def test_hybrid_stack_is_its_group_chain(phase):
    """zamba2's ``_hybrid_forward``, ``_hybrid_prefill`` and
    ``_hybrid_decode`` equal, bit for bit, the port's own groups chained
    by hand: the group order, the shared block after each group, the
    padded shared caches and the per-layer and per-group cache indexing.
    With ``test_hybrid_groups_match_reference`` (each group against the
    reference) this holds the whole stack where its chaos keeps an end
    to end comparison out."""
    rows = _hybrid_stack()[phase]
    assert len(rows) == (1 if phase == "forward" else 7)
    for name, got, want in rows:
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert torch.equal(got, want), name


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_trees_match_reference(arch):
    cfg = get_config(arch).reduced()
    ref_model, model = ref_build(cfg), build_model(PORT_REGISTRY[arch])
    model_r = build_model(PORT_REGISTRY[arch].reduced())
    assert model.n_params() == ref_build(get_config(arch)).n_params()
    assert model.n_active_params() == ref_build(
        get_config(arch)).n_active_params()
    assert model_r.n_params() == ref_model.n_params()
    shapes = jax.tree.map(lambda d: tuple(d.shape), ref_model.param_defs())
    assert tt.map_tree(lambda d: tuple(d.shape),
                       model_r.param_defs()) == shapes
    want = jax.tree.map(lambda d: (tuple(d.shape), jnp.dtype(d.dtype).name),
                        ref_model.cache_defs(3, 40))
    got = tt.map_tree(lambda d: (tuple(d.shape), str(d.dtype)[6:]),
                      model_r.cache_defs(3, 40))
    assert got == want
    cache = model_r.init_cache(3, 40, device="cpu")
    assert tt.map_tree(lambda a: tuple(a.shape), cache) == \
        jax.tree.map(lambda d: tuple(d.shape), ref_model.cache_defs(3, 40))


def test_init_draws_the_reference_distribution():
    """``init`` draws every tree leaf on the generator's device with the
    reference's scale: ones, zeros, N(0, 1) embeddings, 1/sqrt(fan_in)."""
    model = build_model(PORT_REGISTRY["qwen2.5-3b"].reduced())
    p = model.init(0, device="cpu")
    assert torch.equal(p["final_norm"], torch.ones(64))
    assert not p["layers"]["attn"]["bq"].any()
    assert abs(float(p["embed"].std()) - 1.0) < 0.05
    assert abs(float(p["layers"]["mlp"]["w1"].std()) - 64 ** -0.5) < 0.01
    again = build_model(PORT_REGISTRY["qwen2.5-3b"].reduced()).init(
        0, device="cpu")
    assert torch.equal(p["embed"], again["embed"])
    assert model.params["layers"]["mlp"]["w2"] is not None
    assert sum(t.numel() for t in model.parameters()) == model.n_params()


def test_load_rejects_a_tree_of_another_shape():
    model = build_model(PORT_REGISTRY["qwen2.5-3b"].reduced())
    tree = model.init(0, device="cpu")
    tree["final_norm"] = torch.ones(3)
    with pytest.raises(ValueError, match="does not match"):
        model.load(tree)


def test_configs_are_the_reference_configs():
    assert sorted(PORT_REGISTRY) == sorted(REGISTRY)
    for name, cfg in REGISTRY.items():
        assert repr(PORT_REGISTRY[name]) == repr(cfg)
        assert repr(PORT_REGISTRY[name].reduced()) == repr(cfg.reduced())
