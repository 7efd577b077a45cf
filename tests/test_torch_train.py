"""The port's training path against the reference, on the CPU: AdamW,
the schedule, the loss, EF-int8 quantization, the train step of every
reduced arch, microbatching and ``remat``.

The same numpy inputs (from a seed) go through both packages; weights
and optimizer state carry across with ``convert.state_from_numpy``.
Bounds, and why:

- ``schedule``, ``global_norm``, ``cross_entropy`` and ``update`` on the
  same float32 trees: 1e-6 relative (only the order of f32 sums and the
  last ulp of ``pow``/``cos`` may differ). ``ef_quantize``: ``q``
  exactly, scale and error within 1e-7.
- A train step: the loss and ``ce`` within 1e-4 relative; every gradient
  leaf within 2e-2 norm-relative (``|g_port - g_ref| / |g_ref|``: the
  products run in bf16, so each gradient element is good to a bf16 ulp,
  0.4%, in both). ``grad_norm`` within 1e-2: the reference reduces the
  gradient of a weight broadcast into a bf16 product (a norm scale, a
  bias) in bf16, the port in float32 (``test_bf16_broadcast_grad``), so
  reduced qwen2.5-3b's ``ln1`` gradient norm reads 1.2% apart and the
  global norm 3.5e-3 (measured on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY, get_config
from repro.models import build_model as ref_build
from repro.models import ssm as jssm
from repro.optim import optimizer as jopt
from repro.train import compression as jcomp
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.models import build_model
from repro_torch.models import ssm as tssm
from repro_torch.models.param import (ShardingRules, map_tree, tree_leaves,
                                      tree_unflatten)
from repro_torch.models.sharding_ctx import mesh_shape_dict
from repro_torch.optim import optimizer as topt
from repro_torch.train import compression as tcomp
from repro_torch.train import step as tstep
from torch_dist_ranks import one_rank_mesh, whole

ARCHS = sorted(REGISTRY)
EXACT = dict(rtol=1e-6, atol=0)
LOSS_RTOL = 1e-4
GRAD_NORM_RTOL = 1e-2
GRAD_BOUND = 2e-2
# Archs whose reduced stack is chaotic at the reference's init: an ulp of
# an f32 transcendental (XLA's tanh/exp/log1p are not the CPU library's)
# flips a near-hard maximum and the difference grows layer by layer.
# gemma3-1b's 12 layers on this batch: one ulp at layer 2, token 6 of row
# 0 (0.0019 of the logits) reads 0.31 max-rel at layer 12 (row 1 is
# exact), the loss 1.7e-2 apart; zamba2-2.7b (tests/test_torch_models.py):
# 7.6e-4.
# Both are held to the forward's whole-model bound (5e-2) on the loss,
# with finite gradients that move every parameter leaf, not per leaf.
CHAOTIC = {"gemma3-1b", "zamba2-2.7b"}
CHAOTIC_LOSS_RTOL = 5e-2
# Per-leaf exceptions to GRAD_BOUND: mamba2's ``Dskip`` enters as a bf16
# product broadcast over (batch, seq, head_dim) and the reference sums
# its gradient in bf16 (0.036 apart on the CPU).
GRAD_BOUND_OF = {("mamba2-780m", ("layers", "Dskip")): 5e-2}


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def _t(x):
    return torch.from_numpy(np.array(x))


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], path + (k,))
    else:
        yield path


def _batch(cfg, rng, b=2, s=24):
    """Tokens as their own labels plus the family's extra inputs, numpy."""
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
        batch["vision_positions"] = np.tile(
            np.arange(cfg.vision_tokens, dtype=np.int32)[None], (b, 1))
    if cfg.enc_dec:
        batch["frames"] = rng.standard_normal(
            (b, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return batch


def _setup(arch, seed=0):
    """The reference's reduced model and ``init_state(PRNGKey(0))``, the
    port's model, that state carried across, and one batch."""
    cfg = get_config(arch).reduced()
    ref_model = ref_build(cfg)
    state = jstep.init_state(ref_model, jax.random.PRNGKey(0))
    np_state = jax.tree.map(np.asarray, state)
    batch = _batch(cfg, np.random.default_rng(seed))
    return cfg, ref_model, np_state, build_model(cfg), batch


def _ref_value_and_grad(ref_model, np_state, batch, remat=False):
    fn = jax.value_and_grad(jstep.make_loss_fn(ref_model, remat=remat),
                            has_aux=True)
    (loss, metrics), grads = jax.jit(fn)(
        jax.tree.map(jnp.asarray, np_state["params"]),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return metrics, jax.tree.map(np.asarray, grads)


def _port_state(np_state):
    return convert.state_from_numpy(np_state, device="cpu")


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# -- the optimizer -------------------------------------------------------------


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (20, 20),
                                          (100, 10_000)])
def test_schedule(warmup, total):
    jc = jopt.OptimizerConfig(lr=3e-3, warmup_steps=warmup,
                              total_steps=total)
    tc = topt.OptimizerConfig(lr=3e-3, warmup_steps=warmup,
                              total_steps=total)
    for s in (0, 1, warmup // 2, warmup, warmup + 1, (warmup + total) // 2,
              total - 1, total, total + 7):
        want = float(jopt.schedule(jc, jnp.int32(s)))
        got = topt.schedule(tc, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, **EXACT)


def _rand_tree(rng, scale=1.0):
    return {"a": (rng.standard_normal((7, 5)) * scale).astype(np.float32),
            "b": {"c": (rng.standard_normal((3,)) * scale).astype(np.float32),
                  "d": (rng.standard_normal((2, 3, 4)) * scale)
                  .astype(np.float32)}}


def test_global_norm():
    tree = _rand_tree(np.random.default_rng(1), 3.0)
    want = float(jopt.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = topt.global_norm(convert.params_from_numpy(tree, device="cpu"))
    np.testing.assert_allclose(float(got), want, **EXACT)


@pytest.mark.parametrize("step", [0, 1, 41])
@pytest.mark.parametrize("grad_scale", [0.01, 30.0])     # unclipped, clipped
def test_update_in_place_matches_reference(step, grad_scale):
    rng = np.random.default_rng(2 + step)
    params, grads = _rand_tree(rng), _rand_tree(rng, grad_scale)
    m = _rand_tree(rng, 0.1)
    v = jax.tree.map(np.abs, _rand_tree(rng, 0.01))
    cfg = dict(lr=1e-2, warmup_steps=5, total_steps=60)
    jp, jo, jm = jopt.update(
        jopt.OptimizerConfig(**cfg), jax.tree.map(jnp.asarray, grads),
        {"m": jax.tree.map(jnp.asarray, m), "v": jax.tree.map(jnp.asarray, v),
         "step": jnp.int32(step)}, jax.tree.map(jnp.asarray, params))
    tp = convert.params_from_numpy(params, device="cpu")
    to = {"m": convert.params_from_numpy(m, device="cpu"),
          "v": convert.params_from_numpy(v, device="cpu"),
          "step": torch.tensor(step, dtype=torch.int32)}
    ids = [id(t) for t in tree_leaves({"p": tp, "o": to})]
    gp, go, gm = topt.update(topt.OptimizerConfig(**cfg),
                             convert.params_from_numpy(grads, device="cpu"),
                             to, tp)
    # in place: the returned trees are the state's own tensors
    assert [id(t) for t in tree_leaves({"p": gp, "o": go})] == ids
    assert go["step"].dtype == torch.int32 and go["step"].shape == ()
    assert int(go["step"]) == int(jo["step"]) == step + 1
    for got, want in ((gp, jp), (go["m"], jo["m"]), (go["v"], jo["v"])):
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-9)
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(gm[k]), float(jm[k]), **EXACT)


# -- the loss ------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy(masked):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((3, 11, 37)) * 4).astype(np.float32)
    labels = rng.integers(0, 37, (3, 11)).astype(np.int32)
    mask = (rng.random((3, 11)) < 0.6).astype(np.float32) if masked else None
    want = jstep.cross_entropy(
        jnp.asarray(logits).astype(jnp.bfloat16), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    got = tstep.cross_entropy(
        _t(logits).to(torch.bfloat16), _t(labels),
        None if mask is None else _t(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), **EXACT)


def test_cross_entropy_with_an_empty_mask_is_zero():
    logits = torch.randn(2, 3, 5)
    ce, zl = tstep.cross_entropy(logits, torch.zeros(2, 3, dtype=torch.int32),
                                 torch.zeros(2, 3))
    assert float(ce) == 0.0 and float(zl) == 0.0


# -- EF-int8 -------------------------------------------------------------------


@pytest.mark.parametrize("scale", [1e-3, 1.0, 250.0])
def test_ef_quantize(scale):
    rng = np.random.default_rng(4)
    g = (rng.standard_normal((33, 17)) * scale).astype(np.float32)
    err = (rng.standard_normal((33, 17)) * scale * 0.01).astype(np.float32)
    jq, js, je = jcomp.ef_quantize(jnp.asarray(g), jnp.asarray(err))
    tq, ts, te = tcomp.ef_quantize(_t(g), _t(err))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-7)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-7,
                               atol=1e-7 * float(js))


def test_ef_quantize_rounds_half_to_even():
    """Values on exact half steps of the scale (2**-3): both packages
    round them to the even integer."""
    g = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 127.0], np.float32) * 2.0 ** -3
    err = np.zeros_like(g)
    tq, ts, _ = tcomp.ef_quantize(_t(g), _t(err))
    jq, js, _ = jcomp.ef_quantize(jnp.asarray(g), jnp.asarray(err))
    assert float(ts) == float(js) == 2.0 ** -3
    assert tq.tolist() == np.asarray(jq).tolist() == [0, 2, 2, 0, -2, 127]


def test_ef_compress_tree():
    rng = np.random.default_rng(5)
    grads, errs = _rand_tree(rng), _rand_tree(rng, 0.01)
    want = jcomp.ef_compress_tree(jax.tree.map(jnp.asarray, grads),
                                  jax.tree.map(jnp.asarray, errs))
    got = tcomp.ef_compress_tree(
        convert.params_from_numpy(grads, device="cpu"),
        convert.params_from_numpy(errs, device="cpu"))
    for g_tree, w_tree in zip(got, want):
        assert list(_paths(g_tree)) == list(_paths(
            jax.tree.map(np.asarray, w_tree)))
        for g, w in zip(tree_leaves(g_tree), jax.tree.leaves(w_tree)):
            if g.dtype == torch.int8:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            else:
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-7, atol=1e-9)
    tree = {"w": np.zeros((1000,)), "b": np.zeros((3, 4))}
    assert tcomp.compression_ratio(tree) == jcomp.compression_ratio(tree)
    with one_rank_mesh() as mesh:     # the sum of one rank's q * s
        summed = tcomp.compressed_psum(got[0], got[1], "data", 2, mesh=mesh)
    for q, s, g in zip(tree_leaves(got[0]), tree_leaves(got[1]),
                       tree_leaves(summed)):
        assert torch.equal(g, q.to(torch.float32) * s / 2)


# -- gradients where the packages round differently ----------------------------


def test_bf16_broadcast_grad():
    """The gradient of a float32 weight broadcast into a bf16 product (how
    every norm scale and bias enters): the reference sums it in bf16, the
    port in float32 and rounds once, so the port's is nearer the float64
    sum - the reason for GRAD_NORM_RTOL."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((48, 64)).astype(np.float32)
    g = (rng.standard_normal((48, 64)) * 1e-3).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    xb, gb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, g))

    def f(w):
        return jnp.sum((xb * w.astype(jnp.bfloat16)).astype(jnp.float32)
                       * gb.astype(jnp.float32))

    want = np.asarray(jax.jit(jax.grad(f))(jnp.asarray(w)))
    xt, gt = (_t(a).to(torch.bfloat16) for a in (x, g))
    wt = _t(w).requires_grad_()
    got = torch.autograd.grad(
        ((xt * wt.to(torch.bfloat16)).float() * gt.float()).sum(), wt)[0]
    exact = (np.asarray(xb.astype(jnp.float32), np.float64)
             * np.asarray(gb.astype(jnp.float32), np.float64)).sum(0)
    assert rel(got.numpy(), exact) < rel(want, exact)
    assert rel(got.numpy(), exact) < 4e-3 < rel(want, exact)


def _ssd_inputs(s, dt_value):
    rng = np.random.default_rng(7)
    b, h, p, g, n = 1, 2, 4, 1, 4
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.full((b, s, h), dt_value, np.float32)
    bm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    return x, dt, bm, cm


def _ssd_grads(x, dt, bm, cm, chunk):
    xj, bj, cj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, bm, cm))

    def f(dt):
        y, st = jssm.ssd_chunked(xj, dt, -dt, bj, cj, chunk)
        return jnp.sum(y.astype(jnp.float32)) + jnp.sum(st)

    want_y = jssm.ssd_chunked(xj, jnp.asarray(dt), -jnp.asarray(dt), bj, cj,
                              chunk)[0]
    want = np.asarray(jax.grad(f)(jnp.asarray(dt)))
    xt, bt, ct = (_t(a).to(torch.bfloat16) for a in (x, bm, cm))
    dtt = _t(dt).requires_grad_()
    y, st = tssm.ssd_chunked(xt, dtt, -dtt, bt, ct, chunk)
    got = torch.autograd.grad(y.float().sum() + st.sum(), dtt)[0]
    assert rel(y.detach().float().numpy(),
               np.asarray(want_y.astype(jnp.float32))) < 1e-2
    return got.numpy(), want


def test_ssd_backward_matches_reference():
    """Chunks short enough that no decay leaves exp's range: the port's
    SSD gradient is the reference's."""
    got, want = _ssd_grads(*_ssd_inputs(40, 0.3), chunk=16)
    assert np.isfinite(want).all()
    assert rel(got, want) < GRAD_BOUND


def test_ssd_backward_is_finite_where_the_reference_is_nan():
    """A chunk of 128 at dt 0.8 sums the decay past 88, where float32's
    exp overflows. The forward is the same bits; the reference's masked
    product multiplies the mask's zero by inf in its backward, the port
    masks before the exp (``ssm.ssd_chunked``)."""
    got, want = _ssd_grads(*_ssd_inputs(128, 0.8), chunk=128)
    assert np.isnan(want).all()
    assert np.isfinite(got).all() and np.abs(got).max() > 0


# -- the train step ------------------------------------------------------------


def _grad_checks(arch, port_grads, ref_grads):
    worst = {}
    for path, g, w in zip(_paths(ref_grads), tree_leaves(port_grads),
                          jax.tree.leaves(ref_grads)):
        r = rel(g.numpy(), w)
        worst[path] = r
        assert r < GRAD_BOUND_OF.get((arch, path), GRAD_BOUND), (path, r)
    return worst


def _port_grads(model, state, batch, remat):
    loss_fn = tstep.make_loss_fn(model, remat=remat)
    return tstep.value_and_grad(loss_fn, state["params"], batch)


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_train_step(arch):
    """``tests/test_models.py::test_arch_smoke_forward_and_train_shapes``'s
    step on the port: the loss against the reference's on the same
    weights and batch, every gradient leaf against ``jax.grad``'s (the
    chaotic archs: finite), and one step moves every parameter leaf."""
    cfg, ref_model, np_state, model, batch = _setup(arch)
    ref_metrics, ref_grads = _ref_value_and_grad(ref_model, np_state, batch)
    state = _port_state(np_state)
    tb = _port_batch(batch)
    (_, metrics), grads = _port_grads(model, state, tb, remat=False)
    want = float(ref_metrics["loss"])
    bound = CHAOTIC_LOSS_RTOL if arch in CHAOTIC else LOSS_RTOL
    assert abs(float(metrics["loss"]) - want) <= bound * abs(want)
    if arch in CHAOTIC:
        assert all(torch.isfinite(g).all() for g in tree_leaves(grads))
    else:
        _grad_checks(arch, grads, ref_grads)
    step = tstep.make_train_step(model, topt.OptimizerConfig(total_steps=10),
                                 remat=False)
    before = [p.clone() for p in tree_leaves(state["params"])]
    new_state, m = step(state, tb)
    assert np.isfinite(float(m["loss"]))
    assert float(m["loss"]) == float(metrics["loss"])
    for b, a in zip(before, tree_leaves(new_state["params"])):
        assert torch.isfinite(a).all() and not torch.equal(a, b)
    assert int(new_state["opt"]["step"]) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_mesh_step_is_the_mesh_free_step(arch):
    """``make_train_step(mesh=)`` on a (1,1) mesh over a one-rank gloo
    group, from state placed by ``init_state(mesh=)``: the same loss,
    metrics, parameters and moments as the mesh-free step, bit for bit
    (one rank adds no arithmetic: its gathers and reductions move or
    keep the same values), with every leaf a DTensor under its spec."""
    cfg, _, _, model, batch = _setup(arch)
    tb = _port_batch(batch)
    opt_cfg = topt.OptimizerConfig(total_steps=10)
    want, wm = tstep.make_train_step(model, opt_cfg, remat=False)(
        tstep.init_state(model, 3, device="cpu"), tb)
    with one_rank_mesh() as mesh:
        state = tstep.init_state(model, 3, device="cpu", mesh=mesh)
        assert all(hasattr(p, "placements")
                   for p in tree_leaves(state["params"]))
        got, gm = tstep.make_train_step(model, opt_cfg, mesh=mesh,
                                        remat=False)(state, tb)
        got = map_tree(whole, got)
    assert set(gm) == set(wm)
    for k in wm:
        assert torch.equal(gm[k], wm[k]), k
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "granite-moe-3b-a800m"])
def test_one_rank_mesh_step_calls_no_collective(arch, monkeypatch):
    """Over a (1,1) mesh every gather and reduction runs over a group of
    one rank, which the mesh paths skip: a sharded train step (a dense
    and an MoE stack) calls no collective at all."""
    import torch.distributed as dist
    from repro_torch.models import sharding_ctx
    cfg, _, _, model, batch = _setup(arch)
    tb = _port_batch(batch)
    calls = []

    def counted(name, fn):
        def call(*args, **kw):
            calls.append(name)
            return fn(*args, **kw)
        return call

    with one_rank_mesh() as mesh:
        state = tstep.init_state(model, 3, device="cpu", mesh=mesh)
        step = tstep.make_train_step(model, topt.OptimizerConfig(
            total_steps=10), mesh=mesh, remat=False)
        for mod, name in ((dist, "all_reduce"),
                          (sharding_ctx, "_gather_into"),
                          (sharding_ctx, "_scatter_into")):
            monkeypatch.setattr(mod, name, counted(name, getattr(mod, name)))
        _, m = step(state, tb)
    assert np.isfinite(float(m["loss"]))
    assert calls == []


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_mesh_serving_is_mesh_free(arch):
    """``forward``, ``prefill`` and two ``decode_step``s over a (1,1)
    mesh on sharded parameters: the mesh-free logits and caches, bit for
    bit; the logits and the caches come back as DTensors."""
    cfg, _, np_state, model, batch = _setup(arch)
    tb = {k: v for k, v in _port_batch(batch).items() if k != "labels"}
    params = convert.params_from_numpy(np_state["params"], "cpu")
    skv = tb["tokens"].shape[1] + 2
    runs = []
    with one_rank_mesh() as mesh:
        sharded = convert.sharded_from_numpy(
            np_state["params"], mesh,
            model.param_specs(ShardingRules(), mesh_shape_dict(mesh)))
        for p, m in ((params, None), (sharded, mesh)):
            logits, aux = model.forward(p, tb, mesh=m)
            out = [logits, aux]
            lg, caches = model.prefill(p, tb, skv=skv, mesh=m)
            out.append(lg)
            for i in range(2):
                nxt = {"tokens": tb["tokens"][:, i:i + 1],
                       "pos": torch.full((tb["tokens"].shape[0],), skv - 2 + i,
                                         dtype=torch.int32)}
                lg, caches = model.decode_step(p, caches, nxt, mesh=m)
                out.append(lg)
            if m is not None:
                assert all(hasattr(c, "placements")
                           for c in tree_leaves(caches) + [out[0], out[2]])
                out = [whole(t) for t in out]
            runs.append(out + [whole(c) for c in tree_leaves(caches)])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_train_step_matches_reference():
    """One ``make_train_step`` on reduced qwen2.5-3b: the loss and ce,
    grad_norm and every gradient leaf against the reference's; the three
    ``remat`` settings give equal gradients, parameters and moments."""
    cfg, ref_model, np_state, model, batch = _setup("qwen2.5-3b")
    ref_metrics, ref_grads = _ref_value_and_grad(ref_model, np_state, batch)
    tb = _port_batch(batch)
    ref_gnorm = float(jopt.global_norm(ref_grads))
    outs = {}
    for remat in (False, True, "save_attn"):
        state = _port_state(np_state)
        (_, metrics), grads = _port_grads(model, state, tb, remat)
        step = tstep.make_train_step(model, topt.OptimizerConfig(
            total_steps=10), remat=remat)
        new_state, m = step(state, tb)
        outs[remat] = (grads, new_state, m)
        for k in ("loss", "ce"):
            np.testing.assert_allclose(float(m[k]), float(ref_metrics[k]),
                                       rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), ref_gnorm,
                                   rtol=GRAD_NORM_RTOL)
        assert float(m["grad_norm"]) == float(topt.global_norm(grads))
        _grad_checks("qwen2.5-3b", grads, ref_grads)
    base = outs[False]
    for remat in (True, "save_attn"):
        got, want = ({"grads": o[0], "state": o[1]}
                     for o in (outs[remat], base))
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(a, b), remat
        for k, v in outs[remat][2].items():
            assert torch.equal(v, base[2][k]), (remat, k)


def test_train_step_updates_like_the_reference_update():
    """The step's update is ``optim.update`` on its own gradients: fed
    the port's gradients, the reference's update gives the port's new
    parameters and moments."""
    cfg, ref_model, np_state, model, batch = _setup("qwen2.5-3b")
    state = _port_state(np_state)
    tb = _port_batch(batch)
    (_, _), grads = _port_grads(model, _port_state(np_state), tb, "save_attn")
    opt_cfg = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    new_state, m = tstep.make_train_step(
        model, topt.OptimizerConfig(**opt_cfg))(state, tb)
    jp, jo, jm = jopt.update(
        jopt.OptimizerConfig(**opt_cfg),
        jax.tree.map(lambda g: jnp.asarray(g.numpy()), grads),
        jax.tree.map(jnp.asarray, np_state["opt"]),
        jax.tree.map(jnp.asarray, np_state["params"]))
    for got, want in ((new_state["params"], jp), (new_state["opt"]["m"],
                                                  jo["m"]),
                      (new_state["opt"]["v"], jo["v"])):
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-9)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               **EXACT)


def test_microbatches_match_reference():
    """``microbatches=4`` against the reference's ``microbatches=4``: the
    metrics of its microbatched branch, the loss, the grad norm; and
    against the port's own single batch, as
    ``test_train_infra.py::test_microbatch_accumulation_matches_full_batch``
    holds the reference."""
    cfg, ref_model, np_state, model, batch = _setup("qwen2.5-3b")
    batch = _batch(cfg, np.random.default_rng(8), b=8, s=16)
    opt_cfg = dict(total_steps=10)
    jstate = jax.tree.map(jnp.asarray, np_state)
    _, jm = jax.jit(jstep.make_train_step(
        ref_model, jopt.OptimizerConfig(**opt_cfg), remat=False,
        microbatches=4))(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = _port_batch(batch)
    s4, m4 = tstep.make_train_step(model, topt.OptimizerConfig(**opt_cfg),
                                   remat=False, microbatches=4)(
        _port_state(np_state), tb)
    assert set(m4) == set(jm)
    for k in ("loss", "ce", "ppl_log"):
        np.testing.assert_allclose(float(m4[k]), float(jm[k]),
                                   rtol=LOSS_RTOL)
    assert float(m4["aux"]) == float(jm["aux"]) == 0.0
    np.testing.assert_allclose(float(m4["grad_norm"]), float(jm["grad_norm"]),
                               rtol=GRAD_NORM_RTOL)
    s1, m1 = tstep.make_train_step(model, topt.OptimizerConfig(**opt_cfg),
                                   remat=False)(_port_state(np_state), tb)
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=2e-2)
    w1, w4 = tree_leaves(s1["params"])[0], tree_leaves(s4["params"])[0]
    np.testing.assert_allclose(w1.numpy(), w4.numpy(), atol=1e-3)


def test_step_leaves_no_grad_behind():
    cfg, _, np_state, model, batch = _setup("qwen2.5-3b")
    state = _port_state(np_state)
    model.load(state["params"])
    tstep.make_train_step(model, topt.OptimizerConfig())(
        state, _port_batch(batch))
    for t in tree_leaves(state) + list(model.parameters()):
        assert t.grad is None and not t.requires_grad


def _graph_nodes(fn):
    seen, todo = set(), [fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo.extend(n for n, _ in node.next_functions)
    return seen


def test_stacked_leaves_are_unbound_once():
    """The backward reaches each stacked layer leaf through one unbind,
    never through a per-layer select (which would add a zero-filled
    copy of the whole stacked leaf for every layer)."""
    cfg, _, np_state, model, batch = _setup("qwen2.5-3b")
    params = _port_state(np_state)["params"]
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    stacked = {id(p) for p, path in zip(leaves, _paths(params))
               if path[0] == "layers"}
    tree = tree_unflatten(params, leaves)
    with torch.enable_grad():
        logits, _ = model.forward(tree, _port_batch(batch))
    into_leaf = {}
    for node in _graph_nodes(logits.grad_fn):
        for nxt, _ in node.next_functions:
            if nxt is not None and hasattr(nxt, "variable") and \
                    id(nxt.variable) in stacked:
                into_leaf.setdefault(id(nxt.variable), set()).add(
                    type(node).__name__)
    assert len(into_leaf) == len(stacked)
    assert all(kinds == {"UnbindBackward0"} for kinds in into_leaf.values())


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "granite-moe-3b-a800m",
                                  "mamba2-780m", "zamba2-2.7b",
                                  "whisper-small"])
def test_forward_is_the_same_under_remat_and_grad(arch):
    """``remat`` and autograd change nothing the forward computes: the
    logits bit for bit against the serving forward."""
    cfg, _, np_state, model, batch = _setup(arch)
    params = _port_state(np_state)["params"]
    tb = _port_batch(batch)
    with torch.no_grad():
        want = model.forward(params, tb)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    tree = tree_unflatten(params, leaves)
    for remat in (False, True, "save_attn"):
        with torch.enable_grad():
            got = model.forward(tree, tb, remat=remat)
        for g, w in zip(got, want):
            assert torch.equal(g.detach(), w), remat


def test_forward_over_a_mesh_raises():
    """A mesh must be a ``DeviceMesh`` (the mesh paths themselves are
    held by ``test_one_rank_mesh_step_is_the_mesh_free_step`` here and
    by tests/test_torch_distributed.py on 8 ranks)."""
    cfg = get_config("qwen2.5-3b").reduced()
    with pytest.raises(TypeError, match="DeviceMesh"):
        build_model(cfg).forward({}, {}, mesh=object())


def test_state_from_numpy_keeps_every_bit():
    cfg, _, np_state, _, _ = _setup("granite-moe-3b-a800m")
    state = _port_state(np_state)
    assert state["opt"]["step"].dtype == torch.int32
    assert state["opt"]["step"].shape == ()
    assert list(_paths(state)) == list(_paths(np_state))
    for got, want in zip(tree_leaves(state), jax.tree.leaves(np_state)):
        assert got.dtype == getattr(torch, str(want.dtype))
        np.testing.assert_array_equal(got.numpy(), want)


def test_init_state_draws_on_the_named_device():
    cfg = get_config("qwen2.5-3b").reduced()
    state = tstep.init_state(build_model(cfg), 3, device="cpu")
    again = tstep.init_state(build_model(cfg), 3, device="cpu")
    for a, b in zip(tree_leaves(state), tree_leaves(again)):
        assert a.device.type == "cpu" and torch.equal(a, b)
    assert int(state["opt"]["step"]) == 0
    assert all(not t.any() for t in tree_leaves(state["opt"]["m"]))


def test_gradient_norm_grows_with_depth_as_in_the_reference():
    """At the reference's init (``init_tree`` takes the head count as the
    fan-in of 4-D attention weights, so scores are far apart and the
    softmax a near-hard maximum) the gradient norm grows geometrically
    with depth, in both packages alike: reduced qwen2.5-3b (d_model 64)
    at 36 layers reads about 3e4 times its 2-layer norm (on the CPU:
    1.03e5 and 1.06e5 against 3.34 and 3.35). At full width the 36-layer
    norm passes float32's range (chip_smoke.py phase 10(b)). The stack is
    chaotic at depth (24 layers read 16% apart), hence a factor of 2."""
    import dataclasses
    norms = {}
    for layers in (2, 36):
        cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(),
                                  n_layers=layers)
        ref_model = ref_build(cfg)
        np_state = jax.tree.map(np.asarray, jstep.init_state(
            ref_model, jax.random.PRNGKey(0)))
        toks = np.random.default_rng(0).integers(
            0, cfg.vocab, (8, 33)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        _, ref_grads = _ref_value_and_grad(ref_model, np_state, batch)
        _, grads = _port_grads(build_model(cfg), _port_state(np_state),
                               _port_batch(batch), remat=False)
        norms[layers] = (float(topt.global_norm(grads)),
                         float(jopt.global_norm(ref_grads)))
    for pkg in (0, 1):
        assert norms[36][pkg] > 1e4 * norms[2][pkg], norms
    assert 0.5 < norms[36][0] / norms[36][1] < 2, norms
    np.testing.assert_allclose(norms[2][0], norms[2][1], rtol=GRAD_NORM_RTOL)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "qwen2-vl-7b"])
def test_chip_smoke_float64_step_widens_every_dtype(arch):
    """``chip_smoke.py``'s float64 step (``_float64_grads``, the archs of
    its ``TRAIN_ILL_CONDITIONED``) on the reduced config and its VLM
    batch: no call under its mode returns a narrower float (it fails
    otherwise), and the loss within 1e-5 and every gradient leaf within
    1e-3 of the global gradient norm agree with the same step with bf16
    widened to f32 only (the port's f32 statistics kept): 1e-4 at most
    on these inputs, where the port's own bf16 step reads 0.3-0.5 of the
    global norm from the float64 step in its worst leaves."""
    import importlib.util
    import os
    from torch.overrides import TorchFunctionMode
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert arch in cs.TRAIN_ILL_CONDITIONED

    class F32(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            def f32(a):
                return torch.float32 if a is torch.bfloat16 else a
            kwargs = {k: f32(v) for k, v in (kwargs or {}).items()}
            return func(*map(f32, args), **kwargs)

    from repro_torch.configs import get_config as port_config
    cfg = port_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    batch = cs._train_batch(torch, cfg, 2, 32 if cfg.family != "vlm" else 20)
    loss64, grads64 = cs._float64_grads(torch, model, params, batch)
    with F32():
        (loss, _), grads = tstep.value_and_grad(
            tstep.make_loss_fn(model, remat=False), params, batch)
    assert abs(float(loss) - loss64) <= 1e-5 * abs(loss64)
    norm64 = float(torch.sqrt(sum((w * w).sum()
                                  for w in tree_leaves(grads64))))
    for (p, g), (_, w) in zip(cs._named_leaves(grads),
                              cs._named_leaves(grads64)):
        assert w.dtype == torch.float64, p
        assert float((g.double() - w).norm()) <= 1e-3 * norm64, p
