"""XNOR-popcount binary matmul kernel (CUDA, ``csrc/binary_matmul.cu``) -
the paper's ML application of bulk bitwise operations (Section 8.4.5).

For {-1,+1} vectors packed as bits (1 = +1) the dot product is
``K - 2 * popcount(a XOR b)``. The kernel expands the bits to int8 +-1 and
takes the product on the int8 tensor cores; ``plan`` picks its tile,
split of K and grid from the shape. ``binary_matmul`` launches the kernel
for CUDA tensors and counts the launch in ``binary_matmul.launches``; CPU
tensors take the plain PyTorch version beside it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build, ref

# Output tiles go on grid x (at most 2^31 - 1 of them) and the splits of K
# on grid z; N itself only has to be an int32.
MAX_N = 2 ** 31 - 1
MAX_TILES = 2 ** 31 - 1
# Largest row length in words: 32 * Kw and k_bits - 2 * popcount stay in int32.
MAX_KW = 1 << 25
# csrc/binary_matmul.cu's output tiles (rows, columns), by config number:
# 128x256 on wgmma (two warpgroups of 64x256), 64x64 on mma.sync (four
# warps of 32x32), 128x8 on mma.sync (four warps of 32x8, for N <= 8).
TILES = ((128, 256), (64, 64), (128, 8))
KC = 8                  # packed words of K a stage of the kernel
FILL_WAVES = 2          # blocks an SM a split K aims at
MIN_SPLIT_CHUNKS = 4    # the least chunks of K a split of K walks


class Plan(NamedTuple):
    config: int             # index into TILES
    tiles_m: int
    tiles_n: int
    splits: int             # grid z; > 1 lands partial sums with atomics
    chunks_per_split: int   # chunks of KC words each split walks


def plan(m: int, n: int, kw: int, sms: int) -> Plan:
    """The launch for an (m, kw) x (n, kw) product on a card of ``sms``
    SMs: 128x8 tiles for N <= 8, else the 128x256 wgmma tiles where they
    alone give every SM a block, else 64x64; then K split across grid z
    until about FILL_WAVES blocks an SM run, each split walking at least
    MIN_SPLIT_CHUNKS chunks. Raises past the grid's limits."""
    if m < 1 or n < 1 or kw < 0:
        raise ValueError(f"binary_matmul plans m, n >= 1, kw >= 0, got "
                         f"{m}, {n}, {kw}")
    if n > MAX_N:
        raise ValueError(f"binary_matmul takes N <= {MAX_N}, got {n}")

    def tiles(config):
        tm, tn = TILES[config]
        return -(-m // tm), -(-n // tn)

    if n <= 8:
        config = 2
    else:
        gm, gn = tiles(0)
        config = 0 if gm * gn >= sms else 1
    gm, gn = tiles(config)
    if gm * gn > MAX_TILES:
        raise ValueError(f"binary_matmul takes at most {MAX_TILES} output "
                         f"tiles, {m}x{n} needs {gm * gn}")
    chunks = max(1, -(-kw // KC))
    splits = max(1, min(FILL_WAVES * sms // (gm * gn),
                        chunks // MIN_SPLIT_CHUNKS))
    per = -(-chunks // splits)
    return Plan(config, gm, gn, -(-chunks // per), per)


def binary_matmul_plain(a: torch.Tensor, b: torch.Tensor,
                        k_bits: int) -> torch.Tensor:
    """(M, Kw) x (N, Kw) int32 -> (M, N) int32 = k_bits - 2*popcnt(xor)."""
    return ref.binary_matmul(a, b, k_bits)


def _lib():
    lib = build.load("binary_matmul")
    fn = lib.binary_matmul_launch
    if fn.argtypes is None:         # declare once: pointers stay 64-bit
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
    return lib


def _check(a: torch.Tensor, b: torch.Tensor, k_bits: int) -> None:
    if a.dtype != torch.int32 or b.dtype != torch.int32 or a.dim() != 2 \
            or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(
            "binary_matmul takes (M, Kw) and (N, Kw) int32 tensors, got "
            f"{a.dtype} {tuple(a.shape)} and {b.dtype} {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    kw = a.shape[1]
    if kw > MAX_KW or not 0 <= k_bits <= 32 * kw:
        raise ValueError(f"k_bits={k_bits} with Kw={kw}: need "
                         f"0 <= k_bits <= 32*Kw and Kw <= {MAX_KW}")


def binary_matmul(a: torch.Tensor, b: torch.Tensor,
                  k_bits: int) -> torch.Tensor:
    """(M, Kw) x (N, Kw) packed int32 -> (M, N) int32 in one launch.

    Pad bits beyond ``k_bits`` must be zero in both operands, as in the
    reference (they would count as disagreeing bits otherwise)."""
    k_bits = int(k_bits)
    _check(a, b, k_bits)
    if not a.is_cuda:
        if a.device.type != "cpu":
            raise ValueError(f"unsupported device {a.device}")
        return binary_matmul_plain(a, b, k_bits)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("binary_matmul takes contiguous operands")
    m, kw = a.shape
    n = b.shape[0]
    if m == 0 or n == 0:
        return torch.empty((m, n), dtype=torch.int32, device=a.device)
    p = plan(m, n, kw, build.sm_count(a.device))
    # split K lands its partial sums with atomics: start from zero
    out = (torch.zeros if p.splits > 1 else torch.empty)(
        (m, n), dtype=torch.int32, device=a.device)
    lib = _lib()
    rc = lib.binary_matmul_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, kw, k_bits,
        p.config, p.tiles_m, p.tiles_n, p.splits, p.chunks_per_split,
        torch.cuda.current_stream(a.device).cuda_stream)
    build.check(lib, rc, "binary_matmul launch")
    binary_matmul.launches += 1
    return out


binary_matmul.launches = 0
