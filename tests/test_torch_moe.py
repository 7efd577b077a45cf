"""The port's MoE block (``repro_torch.models.moe``) against the
reference's, on the CPU.

The same seeded numpy inputs go through both packages. The reference is
run under ``jax.jit``, as its stacks run it inside ``lax.scan``: compiled,
the router's bf16 product reaches the f32 logits unrounded, which the
port reproduces; an eager call would round it to bf16 first and route
some ties elsewhere. Tolerances are ``tests/test_torch_models.py``'s:
float32 rtol/atol 1e-5, bf16 two ulps (rtol 1.6e-2, atol 1e-3).
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import MoEConfig
from repro.models import moe as jm
from repro_torch.configs.base import MoEConfig as PortMoEConfig
from repro_torch.configs import get_config as port_config
from repro_torch.core import BulkBitwiseEngine
from repro_torch.models import moe as tm

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=1.6e-2, atol=1e-3)
DTYPES = {"f32": (jnp.float32, torch.float32, F32),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16)}

# name: (n_experts, e_pad, top_k, tokens, d, d_ff_expert, capacity_factor,
#        zero router, capacity or None for the block's own)
CASES = {
    # the reference's test_moe_sort_dispatch_matches_dense_loop
    "sort_dispatch": (8, 8, 2, 64, 16, 8, 8.0, False, None),
    # the reference's test_moe_capacity_drops_tokens: every logit ties
    "capacity_drops_all_tie": (4, 4, 1, 32, 8, 4, 0.25, True, 2),
    # granite's 40 experts padded to 48, top-8
    "padded_40_to_48": (40, 48, 8, 96, 32, 16, 1.25, False, None),
    # the reduced configs' 8 experts padded to 16, top-2
    "padded_8_to_16": (8, 16, 2, 40, 64, 32, 1.25, False, None),
}


def _case(name, dtype):
    e, e_pad, k, t, d, ffe, cf, zero, cap = CASES[name]
    moe = MoEConfig(n_experts=e, top_k=k, d_ff_expert=ffe,
                    capacity_factor=cf)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(t, d)).astype(np.float32)
    router = (np.zeros((d, e_pad)) if zero
              else rng.normal(size=(d, e_pad))).astype(np.float32)
    w1 = (rng.normal(size=(e_pad, d, ffe)) * 0.1).astype(np.float32)
    w3 = (rng.normal(size=(e_pad, d, ffe)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(e_pad, ffe, d)) * 0.1).astype(np.float32)
    kw = dict(moe=moe, e_pad=e_pad, n_local=e_pad, e_lo=0, act="silu",
              capacity=cap if cap is not None else jm._capacity(t, moe))
    jd, td, tol = DTYPES[dtype]
    ref = jax.jit(functools.partial(jm._moe_local, **kw))(
        jnp.asarray(x).astype(jd), *map(jnp.asarray, (router, w1, w3, w2)))
    port_kw = dict(kw, moe=PortMoEConfig(e, k, ffe, cf))
    port = tm._moe_local(torch.from_numpy(x).to(td),
                         *map(torch.from_numpy, (router, w1, w3, w2)),
                         **port_kw)
    return ref, port, tol, (x, router, w1, w3, w2), port_kw


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_local_matches_reference(name, dtype):
    (jout, jaux), (tout, taux), tol, _, _ = _case(name, dtype)
    assert tout.dtype == DTYPES[dtype][1] and tout.shape == jout.shape
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)), **tol)
    # the aux loss is f32 in both dtypes
    np.testing.assert_allclose(float(taux), float(jaux), **F32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_all_tie_router_chooses_and_drops_as_the_reference(dtype):
    """A zero router ties every logit: both packages take the lowest
    expert ids (``lax.top_k`` order) and drop the same tokens past the
    capacity of 2."""
    (jout, _), (tout, _), _, inputs, kw = _case("capacity_drops_all_tie",
                                                dtype)
    x, router = inputs[:2]
    td = DTYPES[dtype][1]
    _, _, idx = tm.route(torch.from_numpy(x).to(td),
                         torch.from_numpy(router), kw["moe"], kw["e_pad"])
    assert idx.reshape(-1).tolist() == [0] * 32
    got = tout.float().numpy()
    want = np.asarray(jout.astype(jnp.float32))
    zero_got = np.abs(got).sum(-1) == 0
    zero_want = np.abs(want).sum(-1) == 0
    assert np.array_equal(zero_got, zero_want)
    assert zero_got.sum() == 30          # two tokens kept, thirty dropped


def test_moe_local_matches_a_dense_loop_over_experts():
    """The reference suite's check on the port: sort + scatter equals an
    explicit per-expert loop when nothing is dropped."""
    (_, _), (out, aux), _, (x, router, w1, w3, w2), kw = _case(
        "sort_dispatch", "f32")
    logits = torch.from_numpy(x) @ torch.from_numpy(router)
    gates, idx = tm.top_k(logits, 2)
    gates = torch.softmax(gates, -1)
    want = torch.zeros_like(out)
    for ti in range(x.shape[0]):
        for j in range(2):
            ex = int(idx[ti, j])
            xt = torch.from_numpy(x[ti])
            h = torch.nn.functional.silu(xt @ torch.from_numpy(w1[ex])) * (
                xt @ torch.from_numpy(w3[ex]))
            want[ti] += gates[ti, j] * (h @ torch.from_numpy(w2[ex]))
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-3,
                               rtol=1e-2)
    assert np.isfinite(float(aux))


@pytest.mark.parametrize("ties", ["all", "some", "none"])
def test_top_k_breaks_ties_as_lax_top_k(ties):
    rng = np.random.default_rng(3)
    if ties == "all":
        logits = np.zeros((6, 48), np.float32)
    elif ties == "some":
        logits = rng.integers(-3, 3, (64, 48)).astype(np.float32)
    else:
        logits = rng.normal(size=(64, 48)).astype(np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(logits), 8)
    tv, ti = tm.top_k(torch.from_numpy(logits), 8)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "qwen3-moe-235b-a22b"])
def test_moe_block_matches_reference(arch):
    """The reduced config's block on (2, 9, d) bf16 activations with the
    reference's initial weights of layer 0, both jitted as in the
    stacks."""
    from repro.models import build_model as ref_build
    from repro_torch import convert
    cfg = get_config(arch).reduced()
    p = jax.tree.map(lambda a: a[0], ref_build(cfg).init(
        jax.random.PRNGKey(0))["layers"]["moe"])
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    jout, jaux = jax.jit(lambda p, x: jm.moe_block(p, x, cfg, None,
                                                   cfg.act))(
        p, jnp.asarray(x).astype(jnp.bfloat16))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, p),
                                   device="cpu")
    tout, taux = tm.moe_block(tp, torch.from_numpy(x).bfloat16(),
                              port_config(arch).reduced(), None, cfg.act)
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)), **BF16)
    np.testing.assert_allclose(float(taux), float(jaux), **F32)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "qwen3-moe-235b-a22b"])
def test_moe_block_without_aux_keeps_its_output(arch):
    """Prefill and decode discard the aux loss, so they ask for none
    (``aux=False``): the block's output stays the same bits; the stack's
    forward alone asks for it."""
    from repro_torch.models import build_model
    cfg = port_config(arch).reduced()
    tp = build_model(cfg).init(0, device="cpu")
    p = {k: v[0] for k, v in tp["layers"]["moe"].items()}
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 9, cfg.d_model)).astype(np.float32)).bfloat16()
    out, aux = tm.moe_block(p, x, cfg, None, cfg.act)
    bare, none = tm.moe_block(p, x, cfg, None, cfg.act, aux=False)
    assert aux.shape == () and none is None
    assert torch.equal(bare, out)
    asked = []
    local = tm._moe_local

    def spy(*args, **kw):
        asked.append(kw["aux"])
        return local(*args, **kw)

    model = build_model(cfg)
    toks = torch.zeros((2, 4), dtype=torch.int32)
    with mock.patch.object(tm, "_moe_local", spy):
        model.forward(tp, {"tokens": toks})
        n = len(asked)
        _, caches = model.prefill(tp, {"tokens": toks}, skv=5)
        model.decode_step(tp, caches, {
            "tokens": toks[:, :1], "pos": torch.full((2,), 4,
                                                     dtype=torch.int32)})
    assert n == cfg.n_layers and asked[:n] == [True] * n
    assert asked[n:] == [False] * (2 * cfg.n_layers)


def test_moe_block_raises_on_a_mesh():
    """A mesh must be a ``DeviceMesh`` (the expert-parallel branches are
    held on 8 ranks by tests/test_torch_distributed.py)."""
    cfg = port_config("granite-moe-3b-a800m").reduced()
    with pytest.raises(TypeError, match="DeviceMesh"):
        tm.moe_block({}, torch.zeros((1, 2, cfg.d_model)), cfg, object(),
                     cfg.act)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "qwen3-moe-235b-a22b"])
def test_padded_experts_and_capacity(arch):
    for reduced in (False, True):
        cfg = get_config(arch)
        pcfg = port_config(arch)
        if reduced:
            cfg, pcfg = cfg.reduced(), pcfg.reduced()
        assert tm.padded_experts(pcfg.moe) == jm.padded_experts(cfg.moe)
        for n in (1, 2, 4, 22, 1024):
            assert tm._capacity(n, pcfg.moe) == jm._capacity(n, cfg.moe)


def test_expert_bitmask_stats_matches_reference():
    """The reference suite's case, [1, 3, 1, 1], with the masks' words
    equal to the reference's."""
    idx = np.array([[0, 1], [1, 2], [1, 3]], np.int32)
    jmasks, jloads = jm.expert_bitmask_stats(jnp.asarray(idx), 4)
    masks, loads = tm.expert_bitmask_stats(torch.from_numpy(idx), 4)
    assert loads.tolist() == [1, 3, 1, 1] == np.asarray(jloads).tolist()
    assert masks.n_bits == jmasks.n_bits == 3
    assert np.array_equal(masks.data.numpy().view(np.uint32),
                          np.asarray(jmasks.data))


@pytest.mark.parametrize("t,k,e", [(1024, 8, 40), (37, 2, 8), (1, 8, 128)])
def test_expert_bitmask_stats_loads_are_a_bincount(t, k, e):
    """Loads equal ``numpy.bincount`` of the assignments; the default
    engine is ``"torch"`` on idx's device, and ``"cuda"`` on a CPU tensor
    takes the kernel's plain version."""
    rng = np.random.default_rng(t)
    idx = np.stack([rng.choice(e, k, replace=False) for _ in range(t)])
    want = np.bincount(idx.reshape(-1), minlength=e)
    for engine in (None, BulkBitwiseEngine("cuda", device="cpu")):
        masks, loads = tm.expert_bitmask_stats(torch.from_numpy(idx), e,
                                               engine=engine)
        assert loads.tolist() == want.tolist()
        bits = masks.bits().numpy()
        assert bits.shape == (e, t)
        for ti in range(t):
            assert sorted(np.nonzero(bits[:, ti])[0]) == sorted(idx[ti])
