"""XNOR-popcount binary matmul kernel (CUDA, ``csrc/binary_matmul.cu``) -
the paper's ML application of bulk bitwise operations (Section 8.4.5).

For {-1,+1} vectors packed as bits (1 = +1) the dot product is
``K - 2 * popcount(a XOR b)``. ``binary_matmul`` launches the kernel for
CUDA tensors and counts the launch in ``binary_matmul.launches``; CPU
tensors take the plain PyTorch version beside it.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, ref

# Grid y of the launch walks N in tiles of 64 (CUDA caps grid y at 65,535).
MAX_N = 65535 * 64
# Largest row length in words: 32 * Kw and k_bits - 2 * popcount stay in int32.
MAX_KW = 1 << 25


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
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
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
    if n > MAX_N:
        raise ValueError(f"binary_matmul takes N <= {MAX_N}, got {n}")
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    if m == 0 or n == 0:
        return out
    lib = _lib()
    rc = lib.binary_matmul_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, kw, k_bits,
        torch.cuda.current_stream(a.device).cuda_stream)
    build.check(lib, rc, "binary_matmul launch")
    binary_matmul.launches += 1
    return out


binary_matmul.launches = 0
