"""The port's Mamba2 block (``repro_torch.models.ssm``) against the
reference's, on the CPU.

The same seeded numpy inputs go through both packages. ``ssm_block`` is
held against the reference under ``jax.jit``, as the reference's stacks
run it inside ``lax.scan``: compiled, the gate product ``y * silu(z)``
reaches rmsnorm's f32 statistics unrounded, which the port reproduces.
``ssd_chunked`` and ``_causal_conv`` are held against both the eager
and the jitted reference. Tolerances are ``tests/test_torch_models.py``'s:
float32 rtol/atol 1e-5, bf16 two ulps (rtol 1.6e-2, atol 1e-3). The
state leaves the bf16 path in f32, summed in another order: it is held
to 1e-5 of its largest value.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import build_model as ref_build
from repro.models import ssm as js
from repro_torch import convert
from repro_torch.configs import get_config as port_config
from repro_torch.models import ssm as ts

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=1.6e-2, atol=1e-3)
DTYPES = {"f32": (jnp.float32, torch.float32, F32),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16)}


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want)
                                          .astype(jnp.float32)), **tol)


def close_state(got, want):
    """f32 states: within 1e-5 of the largest magnitude."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _ssd_inputs(b, s, h, p, n, g=1, seed=0):
    """The reference suite's SSD inputs: x, dt in (0.1, 0.9), dA = -dt * a,
    B and C."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.1, 0.9, (b, s, h)).astype(np.float32)
    da = (-dt * rng.uniform(0.1, 1.0, (1, 1, h))).astype(np.float32)
    bm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    return x, dt, da, bm, cm


def _both(arrays, dtype, cast=(0, 3, 4)):
    """numpy inputs as (jax, torch) lists; the arrays at ``cast`` in
    ``dtype``, the rest (dt, dA) f32."""
    jd, td, _ = DTYPES[dtype]
    j = [jnp.asarray(a).astype(jd) if i in cast else jnp.asarray(a)
         for i, a in enumerate(arrays)]
    t = [torch.from_numpy(a).to(td) if i in cast else torch.from_numpy(a)
         for i, a in enumerate(arrays)]
    return j, t


@pytest.mark.parametrize("jit", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("chunk", [4, 8, 32])
def test_ssd_chunked_matches_reference(chunk, dtype, jit):
    """29 steps (a padded last chunk at 4 and 8, one padded chunk at 32),
    two groups of two heads."""
    j, t = _both(_ssd_inputs(2, 29, 4, 4, 8, g=2), dtype)
    fn = functools.partial(js.ssd_chunked, chunk=chunk)
    jy, jst = (jax.jit(fn) if jit else fn)(*j)
    ty, tst = ts.ssd_chunked(*t, chunk)
    assert ty.dtype == DTYPES[dtype][1] and tst.dtype == torch.float32
    close(ty, jy, DTYPES[dtype][2])
    if dtype == "f32":
        close_state(tst, jst)
    else:   # the states read bf16-rounded operands: two ulps of them
        close(tst, jst, BF16)


@pytest.mark.parametrize("chunk", [4, 8, 32])
def test_ssd_chunked_matches_sequential(chunk):
    """The reference suite's check on the port: the chunked dual form
    equals the naive recurrence."""
    x, dt, da, bm, cm = _ssd_inputs(2, 29, 3, 4, 8)
    state = np.zeros((2, 3, 4, 8))
    ys = []
    for t in range(29):
        state = state * np.exp(da[:, t])[:, :, None, None] + np.einsum(
            "bh,bn,bhp->bhpn", dt[:, t], bm[:, t, 0], x[:, t])
        ys.append(np.einsum("bn,bhpn->bhp", cm[:, t, 0], state))
    y, st = ts.ssd_chunked(*map(torch.from_numpy, (x, dt, da, bm, cm)),
                           chunk)
    np.testing.assert_allclose(y.numpy(), np.stack(ys, 1), atol=2e-3,
                               rtol=2e-2)
    np.testing.assert_allclose(st.numpy(), state, atol=2e-3, rtol=2e-2)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssd_initial_state_continuation(dtype):
    """The state after x[:k] continues x[k:] as the whole run does, in
    both packages alike."""
    x, dt, _, bm, cm = _ssd_inputs(1, 24, 2, 4, 4, seed=1)
    da = (-dt * 0.5).astype(np.float32)
    j, t = _both((x, dt, da, bm, cm), dtype)
    k = 16
    jy_all, jst_all = js.ssd_chunked(*j, 8)
    ty_all, tst_all = ts.ssd_chunked(*t, 8)
    _, jst1 = js.ssd_chunked(*[a[:, :k] for a in j], 8)
    _, tst1 = ts.ssd_chunked(*[a[:, :k] for a in t], 8)
    jy2, jst2 = js.ssd_chunked(*[a[:, k:] for a in j], 8,
                               initial_state=jst1)
    ty2, tst2 = ts.ssd_chunked(*[a[:, k:] for a in t], 8,
                               initial_state=tst1)
    tol = DTYPES[dtype][2]
    close(ty2, jy2, tol)
    close(tst2.to(DTYPES[dtype][1]), jst2.astype(DTYPES[dtype][0]), tol)
    # the continuation of the port equals its own whole run
    np.testing.assert_allclose(ty2.float().numpy(),
                               ty_all[:, k:].float().numpy(), atol=2e-3,
                               rtol=2e-2)
    np.testing.assert_allclose(tst2.numpy(), tst_all.numpy(), atol=2e-3,
                               rtol=2e-2)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(dtype, with_state):
    rng = np.random.default_rng(2)
    arrays = [rng.normal(size=(2, 7, 12)).astype(np.float32),
              (rng.normal(size=(4, 12)) * 0.5).astype(np.float32),
              rng.normal(size=(2, 3, 12)).astype(np.float32)]
    j, t = _both(arrays, dtype, cast=(0, 2))
    state_j = j[2] if with_state else None
    state_t = t[2] if with_state else None
    got = ts._causal_conv(t[0], t[1], state_t)
    for want in (js._causal_conv(j[0], j[1], state_j),
                 jax.jit(js._causal_conv)(j[0], j[1], state_j)):
        close(got, want, DTYPES[dtype][2])


def test_softplus_is_jax_softplus():
    """``lax.logaddexp(x, 0)``, also past 20 where ``F.softplus`` returns
    x, and at +-inf and nan."""
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(size=4000) * 30,
                        [0.0, 20.5, -88.0, 90.0, np.inf, -np.inf, np.nan]])
    x = x.astype(np.float32)
    got = ts._softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **F32)


@functools.lru_cache(maxsize=None)
def _layer(arch):
    """Layer 0 of the reduced config with the reference's initial weights,
    dt_bias, A_log and Dskip redrawn so that every term is live."""
    cfg = get_config(arch).reduced()
    p = jax.tree.map(lambda a: a[0], ref_build(cfg).init(
        jax.random.PRNGKey(0))["layers"])
    p = {k: v for k, v in p.items() if k != "ln"}
    rng = np.random.default_rng(4)
    h = p["dt_bias"].shape[0]
    p["dt_bias"] = jnp.asarray(rng.normal(size=h).astype(np.float32))
    p["A_log"] = jnp.asarray(rng.normal(size=h).astype(np.float32) * 0.5)
    p["Dskip"] = jnp.asarray(rng.normal(size=h).astype(np.float32))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, p),
                                   device="cpu")
    return cfg, port_config(arch).reduced(), p, tp


def _x(cfg, s, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).bfloat16()


@pytest.mark.parametrize("s", [5, 16, 37])
@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b"])
def test_ssm_block_prefill_with_cache_matches_reference(arch, s):
    """One chunk, a full chunk, and three chunks of 16 with padding."""
    cfg, pcfg, p, tp = _layer(arch)
    xj, xt = _x(cfg, s, 5)
    jy, jc = jax.jit(lambda p, x: js.ssm_block(p, x, cfg,
                                               return_cache=True))(p, xj)
    ty, tc = ts.ssm_block(tp, xt, pcfg, return_cache=True)
    close(ty, jy, BF16)
    assert sorted(tc) == sorted(jc)
    for k in ("conv_x", "conv_B", "conv_C"):
        assert tc[k].dtype == torch.bfloat16
        assert np.array_equal(tc[k].float().numpy(),
                              np.asarray(jc[k].astype(jnp.float32))), k
    close_state(tc["state"], jc["state"])
    # forward (no cache) is the same output
    close(ts.ssm_block(tp, xt, pcfg), jax.jit(
        lambda p, x: js.ssm_block(p, x, cfg))(p, xj), BF16)


@pytest.mark.parametrize("s", [1, 2, 3, 4])
@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b"])
def test_ssm_block_short_prefill_leaves_a_full_conv_cache(arch, s):
    """A prefill over fewer tokens than the conv window's W-1 = 3 leaves
    its input's rows behind the zeros ``_causal_conv`` assumes before the
    first token (the reference leaves a short cache, and its first decode
    step raises); from 3 tokens on, the reference's cache bit for bit.
    The decode step from that cache gives the forward's row over s+1
    tokens, within the decode-vs-forward bound of ``tests/test_models.py``
    (1e-1 of the row's largest value; the recurrence and the chunked SSD
    round differently)."""
    cfg, pcfg, p, tp = _layer(arch)
    xj, xt = _x(cfg, s + 1, 6)
    _, jc = jax.jit(lambda p, x: js.ssm_block(p, x, cfg,
                                              return_cache=True))(
        p, xj[:, :s])
    _, tc = ts.ssm_block(tp, xt[:, :s], pcfg, return_cache=True)
    w1 = pcfg.ssm.conv_width - 1
    for k in ("conv_x", "conv_B", "conv_C"):
        want = np.asarray(jc[k].astype(jnp.float32))
        n = min(s, w1)
        assert tc[k].shape[1] == w1 and want.shape[1] == n, k
        assert np.array_equal(tc[k][:, w1 - n:].float().numpy(), want), k
        assert bool((tc[k][:, :w1 - n] == 0).all()), k
    step, _ = ts.ssm_block(tp, xt[:, s:s + 1], pcfg, cache=tc, pos=None)
    whole = ts.ssm_block(tp, xt, pcfg)
    got, want = step[:, 0].float(), whole[:, s].float()
    assert float((got - want).abs().max() / want.abs().max()) < 1e-1


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b"])
def test_ssm_block_decode_matches_reference(arch):
    """Three decode steps from a prefill's cache, each step's output and
    cache against the reference's from the same cache."""
    cfg, pcfg, p, tp = _layer(arch)
    xj, xt = _x(cfg, 11, 6)
    _, jc = jax.jit(lambda p, x: js.ssm_block(p, x, cfg,
                                              return_cache=True))(p, xj)
    step = jax.jit(lambda p, x, c: js.ssm_block(p, x, cfg, cache=c))
    for i in range(3):
        sj, st = _x(cfg, 1, 7 + i)
        tc = convert.params_from_numpy(jax.tree.map(np.asarray, jc),
                                       device="cpu")
        ty, tc2 = ts.ssm_block(tp, st, pcfg, cache=tc, pos=None)
        jy, jc = step(p, sj, jc)
        close(ty, jy, BF16)
        for k in ("conv_x", "conv_B", "conv_C"):
            assert np.array_equal(tc2[k].float().numpy(),
                                  np.asarray(jc[k].astype(jnp.float32))), k
        close_state(tc2["state"], jc["state"])


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b"])
def test_ssm_dims_defs_and_cache_defs_match_reference(arch):
    for reduced in (False, True):
        cfg, pcfg = get_config(arch), port_config(arch)
        if reduced:
            cfg, pcfg = cfg.reduced(), pcfg.reduced()
        assert tuple(ts.ssm_dims(pcfg)) == tuple(js.ssm_dims(cfg))
        want = jax.tree.map(lambda d: (tuple(d.shape), d.axes, d.init,
                                       d.scale), js.ssm_defs(cfg, 3))
        got = {k: (tuple(d.shape), d.axes, d.init, d.scale)
               for k, d in ts.ssm_defs(pcfg, 3).items()}
        assert got == want
        want = jax.tree.map(lambda d: (tuple(d.shape),
                                       jnp.dtype(d.dtype).name),
                            js.ssm_cache_defs(cfg, 3, 2))
        got = {k: (tuple(d.shape), str(d.dtype)[6:])
               for k, d in ts.ssm_cache_defs(pcfg, 3, 2).items()}
        assert got == want
