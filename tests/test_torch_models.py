"""The port's dense-decoder models against the reference, on the CPU.

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
from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.configs import REGISTRY as PORT_REGISTRY
from repro_torch.models import attention as ta
from repro_torch.models import build_model
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt

DENSE = ["deepseek-67b", "gemma3-1b", "internlm2-20b", "qwen2-vl-7b",
         "qwen2.5-3b"]
OTHER = sorted(set(REGISTRY) - set(DENSE))
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


# -- whole models ---------------------------------------------------------------

B, S, STEPS = 2, 16, 4


@functools.lru_cache(maxsize=None)
def _run(arch):
    """Both packages on the reduced config with the reference's weights:
    forward over S+STEPS tokens, prefill over S, then STEPS teacher-
    forced decode steps. Returns (ref outputs, port outputs, port
    model, port params, batches)."""
    cfg = get_config(arch).reduced()
    ref_model = ref_build(cfg)
    params = ref_model.init(jax.random.PRNGKey(0))
    model = build_model(PORT_REGISTRY[arch].reduced())
    tp = model.load(convert.params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu"))
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab, (B, S + STEPS)).astype(np.int32)
    extra = {}
    if cfg.family == "vlm":
        extra = {"vision_embeds": normal(rng, B, cfg.vision_tokens,
                                         cfg.d_model),
                 "vision_positions": np.tile(
                     np.arange(cfg.vision_tokens, dtype=np.int32)[None],
                     (B, 1))}
    jb = {k: jnp.asarray(v) for k, v in extra.items()}
    pb = {k: torch.from_numpy(v) for k, v in extra.items()}
    out = {"ref": {}, "port": {}}
    out["ref"]["forward"] = ref_model.forward(
        params, dict(jb, tokens=jnp.asarray(toks)))[0]
    out["port"]["forward"] = model.forward(
        tp, dict(pb, tokens=torch.from_numpy(toks)))[0]
    skv = S + STEPS
    jl_, jc = ref_model.prefill(
        params, dict(jb, tokens=jnp.asarray(toks[:, :S])), skv=skv)
    tl_, tc = model.prefill(
        tp, dict(pb, tokens=torch.from_numpy(toks[:, :S])), skv=skv)
    out["ref"]["prefill"], out["port"]["prefill"] = jl_, tl_
    out["ref"]["cache"], out["port"]["cache"] = jc, tc
    for i in range(STEPS):
        t = toks[:, S + i:S + i + 1]
        p = np.full((B,), S + i, np.int32)
        jl_, jc = ref_model.decode_step(
            params, jc, {"tokens": jnp.asarray(t), "pos": jnp.asarray(p)})
        tl_, tc = model.decode_step(
            tp, tc, {"tokens": torch.from_numpy(t),
                     "pos": torch.from_numpy(p)})
        out["ref"][f"decode{i}"], out["port"][f"decode{i}"] = jl_, tl_
    return out["ref"], out["port"]


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_reference(arch):
    ref, port = _run(arch)
    assert port["forward"].shape == ref["forward"].shape
    assert rel(port["forward"], ref["forward"]) <= BOUND


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_logits_and_caches_match_reference(arch):
    ref, port = _run(arch)
    assert rel(port["prefill"], ref["prefill"]) <= BOUND
    for kv in ("k", "v"):
        got, want = port["cache"]["self"][kv], ref["cache"]["self"][kv]
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert rel(got, want) <= BOUND, kv


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("arch", DENSE)
def test_decode_steps_match_reference(arch, step):
    ref, port = _run(arch)
    assert rel(port[f"decode{step}"], ref[f"decode{step}"]) <= BOUND


@pytest.mark.parametrize("arch", DENSE)
def test_port_decode_matches_its_forward(arch):
    """The port's prefill + decode against its own forward, under the
    reference's bound between its two paths."""
    _, port = _run(arch)
    for i in range(STEPS):
        want = port["forward"][:, S + i].float().numpy()
        assert rel(port[f"decode{i}"], want) < SELF_BOUND, i


@pytest.mark.parametrize("arch", DENSE)
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


@pytest.mark.parametrize("arch", OTHER)
def test_unported_families_raise(arch):
    cfg = PORT_REGISTRY[arch].reduced()
    model = build_model(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item"):
        model.param_defs()
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item"):
        model.cache_defs(1, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item"):
        model.forward({}, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})


def test_configs_are_the_reference_configs():
    assert sorted(PORT_REGISTRY) == sorted(REGISTRY)
    for name, cfg in REGISTRY.items():
        assert repr(PORT_REGISTRY[name]) == repr(cfg)
        assert repr(PORT_REGISTRY[name].reduced()) == repr(cfg.reduced())
