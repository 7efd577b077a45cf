"""The port's binary-LM path against the reference, on the CPU.

The same numpy inputs (from ``default_rng`` with fixed seeds) go through
the JAX package (``kernels.ops`` in Pallas interpret mode, and the
functions of ``examples/binary_lm.py``) and the port
(``repro_torch.kernels.ops`` on the kernel's plain version, and
``repro_torch.apps.binary_lm``). Integer products agree exactly; float
results within the tolerances stated at each test. The kernel itself is
checked on the card by ``tests/test_torch_cuda.py``.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bitvector import pack_bits as jpack_bits
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.apps import binary_lm
from repro_torch.convert import from_numpy_u32, to_numpy_u32
from repro_torch.core.bitvector import pack_bits
from repro_torch.kernels import binary_matmul as kbmm
from repro_torch.kernels import ops

# (M, N, K bits): tests/test_kernels.py's sweep, then two ragged ones -
# Kw = 1250 spans several of the reference's 512-word K blocks, Kw = 513
# one word past one block, with M and N past its 64-row blocks.
SHAPES = [(1, 1, 32), (5, 9, 64), (16, 16, 128), (40, 70, 1000),
          (8, 128, 4096), (3, 5, 40000), (65, 67, 16416)]


def _load_example():
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "binary_lm.py")
    spec = importlib.util.spec_from_file_location("reference_binary_lm",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EXAMPLE = _load_example()


def packed_u32(bits: np.ndarray) -> np.ndarray:
    """0/1 (rows, k) -> little-endian-within-word uint32 (rows, ceil(k/32)),
    pad bits zero."""
    k = bits.shape[-1]
    pad = (-k) % 32
    b = np.packbits(np.pad(bits.astype(np.uint8), ((0, 0), (0, pad))),
                    axis=-1, bitorder="little")
    return np.ascontiguousarray(b).view("<u4")


@pytest.mark.parametrize("m,n,k", SHAPES)
def test_binary_matmul_matches_reference(m, n, k):
    rng = np.random.default_rng(1000 + k)
    abits = rng.integers(0, 2, (m, k))
    bbits = rng.integers(0, 2, (n, k))
    ap, bp = packed_u32(abits), packed_u32(bbits)
    want = np.asarray(jops.binary_matmul(jnp.asarray(ap), jnp.asarray(bp),
                                         k))
    ta, tb = from_numpy_u32(ap), from_numpy_u32(bp)
    launches = kbmm.binary_matmul.launches
    got = ops.binary_matmul(ta, tb, k)
    assert kbmm.binary_matmul.launches == launches   # plain path on the CPU
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert np.array_equal(got.numpy(), want)
    dense = (2 * abits - 1) @ (2 * bbits - 1).T
    assert np.array_equal(want, dense)
    want_mxu = np.asarray(jops.binary_matmul_mxu(jnp.asarray(ap),
                                                 jnp.asarray(bp), k))
    got_mxu = ops.binary_matmul_mxu(ta, tb, k)
    assert got_mxu.dtype == torch.int32
    assert np.array_equal(got_mxu.numpy(), want_mxu)


def test_plain_version_chunks_rows(monkeypatch):
    """Row chunks smaller than M give the same product (the chunking
    keeps the card's intermediate near 1 GiB at large shapes)."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(7)
    a = from_numpy_u32(rng.integers(0, 2**32, (37, 6), dtype=np.uint64)
                       .astype(np.uint32))
    b = from_numpy_u32(rng.integers(0, 2**32, (11, 6), dtype=np.uint64)
                       .astype(np.uint32))
    whole = ref.binary_matmul(a, b, 192)
    monkeypatch.setattr(ref, "BMM_CHUNK_ELEMS", 5 * 11 * 6)
    assert torch.equal(ref.binary_matmul(a, b, 192), whole)
    assert torch.equal(whole, ref.binary_matmul_mxu(a, b, 192))


@pytest.mark.parametrize("bad", ["dtype", "rank", "kw", "k_bits"])
def test_binary_matmul_rejects_what_the_kernel_does_not_take(bad):
    a = torch.zeros((4, 3), dtype=torch.int32)
    b = torch.zeros((5, 3), dtype=torch.int32)
    args = {"dtype": (a.long(), b, 96), "rank": (a[None], b, 96),
            "kw": (a, b[:, :2], 64), "k_bits": (a, b, 97)}[bad]
    with pytest.raises(ValueError):
        ops.binary_matmul(*args)


@pytest.mark.parametrize("d,batch", [(256, 8), (100, 5), (128, 64)])
def test_bitlinear_forward_matches_reference(d, batch):
    """Packed words and the int32 product exactly; the scaled output to
    rtol=1e-6 (tests/test_system.py's tolerance for this layer)."""
    rng = np.random.default_rng(d)
    x = rng.normal(size=(batch, d)).astype(np.float32)
    w = rng.normal(size=(8, d)).astype(np.float32)
    kw = (d + 31) // 32
    jxp = jpack_bits(jnp.asarray(x > 0).astype(jnp.uint32))[:, :kw]
    jwp = jpack_bits(jnp.asarray(w > 0).astype(jnp.uint32))[:, :kw]
    xp = pack_bits(torch.from_numpy(x) > 0)[:, :kw]
    wp = pack_bits(torch.from_numpy(w) > 0)[:, :kw]
    assert np.array_equal(to_numpy_u32(xp), np.asarray(jxp))
    assert np.array_equal(to_numpy_u32(wp), np.asarray(jwp))
    assert np.array_equal(ops.binary_matmul(xp, wp, d).numpy(),
                          np.asarray(jops.binary_matmul(jxp, jwp, d)))
    want = np.asarray(EXAMPLE.bitlinear_forward(jnp.asarray(x),
                                                jnp.asarray(w)))
    got = binary_lm.bitlinear_forward(torch.from_numpy(x),
                                      torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def _batch(seed, d=256, classes=8, n=256):
    rng = np.random.default_rng(seed)
    protos = rng.choice([-1.0, 1.0], size=(classes, d))
    y = rng.integers(0, classes, n)
    x = (protos[y] + rng.normal(size=(n, d)) * 2.0).astype(np.float32)
    w = (rng.normal(size=(classes, d)) * 0.1).astype(np.float32)
    return x, y, w


@pytest.mark.parametrize("seed", [0, 1])
def test_ste_gradient_matches_jax_grad(seed):
    """One STE gradient against ``jax.grad`` of the example's loss, to
    rtol=1e-5, atol=1e-6: the float32 sums run in another order."""
    x, y, w = _batch(seed)

    def loss_fn(w, xb, yb):
        logits = EXAMPLE.ste_forward(xb, w)
        return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(len(yb)),
                                                    yb])

    want = np.asarray(jax.grad(loss_fn)(jnp.asarray(w), jnp.asarray(x),
                                        jnp.asarray(y)))
    layer = convert.bitlinear_from_numpy(w, device="cpu")
    loss = binary_lm.ste_loss(layer.weight, torch.from_numpy(x),
                              torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(layer.weight.grad.numpy(), want, rtol=1e-5,
                               atol=1e-6)
    want_logits = np.asarray(EXAMPLE.ste_forward(jnp.asarray(x),
                                                 jnp.asarray(w)))
    got_logits = binary_lm.ste_forward(torch.from_numpy(x), layer.weight)
    np.testing.assert_allclose(got_logits.detach().numpy(), want_logits,
                               rtol=1e-5, atol=1e-6)


def test_bitlinear_layer_modes_and_convert():
    """The converted layer keeps every float; its training forward (STE)
    and its packed eval forward give the same logits (+-1 products are
    exact in float32)."""
    x, _, w = _batch(3)
    layer = convert.bitlinear_from_numpy(w, device="cpu")
    assert layer.weight.device.type == "cpu"
    assert np.array_equal(layer.weight.detach().numpy(), w)
    xt = torch.from_numpy(x)
    layer.train()
    trained = layer(xt)
    assert trained.requires_grad
    layer.eval()
    packed = layer(xt)
    assert not packed.requires_grad
    np.testing.assert_allclose(packed.numpy(), trained.detach().numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(
        packed.numpy(),
        np.asarray(EXAMPLE.bitlinear_forward(jnp.asarray(x),
                                             jnp.asarray(w))), rtol=1e-6)


def test_example_trains_in_both_packages(capsys):
    """The full 150-step example on the CPU: both packages above 0.5,
    accuracies within 0.02 (sign flips of near-zero weights may differ
    after 150 steps of float32 sums taken in different orders)."""
    acc = binary_lm.main(device="cpu")
    EXAMPLE.main()
    out = capsys.readouterr().out.splitlines()
    ref_line = [ln for ln in out if "chance" in ln and "on cpu" not in ln]
    ref_acc = float(ref_line[-1].split("inference: ")[1].split()[0])
    assert acc > 0.5 and ref_acc > 0.5
    assert abs(acc - ref_acc) <= 0.02
