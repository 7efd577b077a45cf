"""Binarized compute (paper Section 8.4.5): XNOR-popcount matmul as a
drop-in BitLinear layer, with straight-through-estimator training on a
toy classification task - the paper's ML application of bulk bitwise ops.

Training runs through ``ste_forward`` (a dense product of +-1 values
with straight-through gradients); inference runs through
``bitlinear_forward``, which packs the signs 32 to a word and calls the
XNOR-popcount kernel (``kernels/csrc/binary_matmul.cu`` on the card).

Run on the card (``device="cpu"`` in ``main`` for the CPU):

    PYTHONPATH=src python -m repro_torch.apps.binary_lm
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.bitvector import pack_bits
from ..core.engine import resolve_device
from ..kernels import ops


def _scales(x: torch.Tensor) -> torch.Tensor:
    return x.abs().mean(-1, keepdim=True)


def bitlinear_forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Binarize x, w to +-1 with mean-abs scales; packed XNOR-popcount."""
    d = x.shape[-1]
    kw = (d + 31) // 32
    xp = pack_bits(x > 0)[:, :kw]
    wp = pack_bits(w > 0)[:, :kw]
    return ops.binary_matmul(xp, wp, d) * _scales(x) * _scales(w).T


def ste_forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable surrogate: sign() with straight-through gradients."""
    bx = x + (torch.sign(x) - x).detach()
    bw = w + (torch.sign(w) - w).detach()
    return (bx @ bw.T) * _scales(x) * _scales(w).T


def ste_loss(w: torch.Tensor, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of the STE logits (the training objective)."""
    logp = torch.log_softmax(ste_forward(x, w), -1)
    return -logp[torch.arange(len(y), device=y.device), y].mean()


class BitLinear(torch.nn.Module):
    """A bias-free linear layer with +-1 weights and activations.

    Holds the float weight ``(out_features, in_features)``; in training
    mode the forward is ``ste_forward``, in eval mode the packed
    ``bitlinear_forward``. The initial weight is given as a numpy array,
    so the layer draws no random numbers itself."""

    def __init__(self, weight: np.ndarray, device=None):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.from_numpy(
            np.array(weight, np.float32)).to(resolve_device(device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return ste_forward(x, self.weight)
        with torch.no_grad():
            return bitlinear_forward(x, self.weight)


def main(device=None) -> float:
    """Train a BitLinear classifier with STE, then infer through the packed
    XNOR-popcount kernel; returns the accuracy. The numpy draws are those
    of ``examples/binary_lm.py`` in the reference, in the same order."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    d, classes, n, steps, batch, lr = 256, 8, 2048, 150, 256, 0.5
    # sign-pattern prototypes: representable exactly by binary weights
    protos = rng.choice([-1.0, 1.0], size=(classes, d))
    y = rng.integers(0, classes, n)
    x = (protos[y] + rng.normal(size=(n, d)) * 2.0).astype(np.float32)
    layer = BitLinear(rng.normal(size=(classes, d)) * 0.1, device=dev)

    xt = torch.from_numpy(x).to(dev)
    yt = torch.from_numpy(y).to(dev)
    for _ in range(steps):
        idx = torch.from_numpy(rng.integers(0, n, batch)).to(dev)
        (grad,) = torch.autograd.grad(
            ste_loss(layer.weight, xt[idx], yt[idx]), layer.weight)
        with torch.no_grad():
            layer.weight -= lr * grad

    # inference with the REAL packed XNOR-popcount kernel
    layer.eval()
    logits = layer(xt)
    acc = float((logits.argmax(-1) == yt).float().mean())
    print(f"BitLinear accuracy with packed XNOR-popcount inference: "
          f"{acc:.3f} (chance {1 / classes:.3f}) on {dev}")
    if not acc > 0.5:
        raise RuntimeError(f"BitLinear accuracy {acc} is not above 0.5")
    return acc


if __name__ == "__main__":
    main()
