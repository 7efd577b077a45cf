"""Packed bitvector container used throughout the framework.

Bits are packed little-endian-within-word into 32-bit words, 32x denser
than bool tensors. Words are ``torch.int32`` tensors that hold the same
bit patterns as the reference package's ``uint32`` arrays: PyTorch's
``uint32`` lacks ``~``, ``<<``, ``>>`` and ``>``, so the port works in
int32 and masks every logical right shift by hand (``>>`` on int32
sign-extends). An all-ones word is written ``-1``.

The trailing dimension is padded to a multiple of ``LANE_WORDS`` words,
mirroring the paper's requirement that bbop sizes are multiples of the
DRAM row size (Section 5.1/5.3) - residues are padded with zeros.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

WORD = 32
# The reference pads to one 128-lane TPU vector register row. The width
# means nothing to the GPU kernels (they take any row length), but it
# sets every handle's ``device_bytes`` and so every byte token of the
# ledgers, which must equal the reference's: it stays for parity.
LANE_WORDS = 128

Array = Union[np.ndarray, torch.Tensor]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless ``device``
    names another. Raises when the card is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev


def padded_words(n_bits: int) -> int:
    words = (n_bits + WORD - 1) // WORD
    return ((words + LANE_WORDS - 1) // LANE_WORDS) * LANE_WORDS


def _as_tensor(x: Array, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(
        resolve_device(device))


def pack_bits(bits: Array, device=None) -> torch.Tensor:
    """bool (..., n) -> packed int32 (..., padded_words(n)). Bit i of word
    w holds element w*32+i (little-endian within word). Runs on
    ``device`` (default: where ``bits`` lies; numpy input: the card)."""
    bits = _as_tensor(bits, device).to(torch.int32)
    n = bits.shape[-1]
    words = padded_words(n)
    pad = words * WORD - n
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.reshape(bits.shape[:-1] + (words, WORD))
    shifts = torch.arange(WORD, dtype=torch.int32, device=bits.device)
    # distinct powers of two: the int32 sum never overflows (bit 31 is
    # the one negative term)
    return (bits << shifts).sum(-1, dtype=torch.int32)


def unpack_bits(words: Array, n_bits: Optional[int] = None) -> torch.Tensor:
    """packed int32 (..., w) -> bool (..., n_bits or w*32)."""
    words = _as_tensor(words).to(torch.int32)
    shifts = torch.arange(WORD, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1     # sign fill is masked off
    bits = bits.reshape(words.shape[:-1] + (words.shape[-1] * WORD,))
    if n_bits is not None:
        bits = bits[..., :n_bits]
    return bits.to(torch.bool)


def popcount_words(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (SWAR; torch has no popcount op).
    Computed in int64 so no step can overflow. Returns int64."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


@dataclasses.dataclass
class BitVector:
    """A logical n_bits-long bitvector stored packed. Rows dimension allows
    batches of bitvectors ((rows, words) layout = rows of an Ambit subarray).
    """

    data: torch.Tensor  # int32, (..., words)
    n_bits: int

    @staticmethod
    def from_bits(bits: Array, device=None) -> "BitVector":
        return BitVector(pack_bits(bits, device), bits.shape[-1])

    @staticmethod
    def zeros(n_bits: int, rows: tuple = (), device=None) -> "BitVector":
        return BitVector(
            torch.zeros(rows + (padded_words(n_bits),), dtype=torch.int32,
                        device=resolve_device(device)), n_bits)

    @staticmethod
    def ones(n_bits: int, rows: tuple = (), device=None) -> "BitVector":
        words = padded_words(n_bits)
        data = torch.full(rows + (words,), -1, dtype=torch.int32,
                          device=resolve_device(device))
        return BitVector(_mask_tail(data, n_bits), n_bits)

    def bits(self) -> torch.Tensor:
        return unpack_bits(self.data, self.n_bits)

    @property
    def words(self) -> int:
        return self.data.shape[-1]

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.data.shape)) * 4

    def popcount(self) -> torch.Tensor:
        return popcount_words(self.data).sum(-1).to(torch.int32)

    def __and__(self, o: "BitVector") -> "BitVector":
        return BitVector(self.data & o.data, self.n_bits)

    def __or__(self, o: "BitVector") -> "BitVector":
        return BitVector(self.data | o.data, self.n_bits)

    def __xor__(self, o: "BitVector") -> "BitVector":
        return BitVector(self.data ^ o.data, self.n_bits)

    def __invert__(self) -> "BitVector":
        return BitVector(_mask_tail(~self.data, self.n_bits), self.n_bits)

    def andnot(self, o: "BitVector") -> "BitVector":
        """self & ~other (set difference)."""
        return BitVector(self.data & ~o.data, self.n_bits)


def _mask_tail(data: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Zero the padding bits beyond n_bits (keeps popcounts exact)."""
    full_words = n_bits // WORD
    rem = n_bits % WORD
    idx = torch.arange(data.shape[-1], device=data.device)
    zero = torch.zeros((), dtype=torch.int32, device=data.device)
    word_mask = torch.where(
        idx < full_words, zero - 1,
        torch.where(idx == full_words, zero + ((1 << rem) - 1), zero))
    return data & word_mask
