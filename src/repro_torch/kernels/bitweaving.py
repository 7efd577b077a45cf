"""BitWeaving-V predicate scan kernel (CUDA, ``csrc/bitweaving.cu``) -
Section 8.2.

Evaluates ``c1 <= v <= c2`` over a bit-sliced column: plane i holds bit
(b-1-i) (MSB first) of every value, packed 32 values a word. The
comparison runs MSB->LSB keeping packed gt/lt/eq masks per constant.
``bitweaving_scan`` launches the kernel for a CUDA tensor and counts the
launch in ``bitweaving_scan.launches``; a CPU tensor takes the plain
PyTorch version beside it.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, ref


def bitweaving_scan_plain(planes: torch.Tensor, c1: int,
                          c2: int) -> torch.Tensor:
    """(b, words) int32 planes -> (words,) int32 predicate bitvector."""
    return ref.bitweaving_scan(planes, c1, c2)


def _lib():
    lib = build.load("bitweaving")
    fn = lib.bitweaving_scan_launch
    if fn.argtypes is None:         # declare once: pointers stay 64-bit
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_uint, ctypes.c_uint,
                       ctypes.c_int, ctypes.c_void_p]
    return lib


def bitweaving_scan(planes: torch.Tensor, c1: int, c2: int) -> torch.Tensor:
    """One launch: (b <= 32, words) planes -> (words,) packed result."""
    if not planes.is_cuda:
        if planes.device.type != "cpu":
            raise ValueError(f"unsupported device {planes.device}")
        return bitweaving_scan_plain(planes, c1, c2)
    if planes.dtype != torch.int32 or planes.dim() != 2 or \
            not planes.is_contiguous():
        raise ValueError("bitweaving_scan takes contiguous (b, words) int32 "
                         f"planes, got {planes.dtype} {tuple(planes.shape)}")
    b, words = planes.shape
    if not 1 <= b <= 32:
        raise ValueError(f"bitweaving_scan takes 1..32 planes, got {b}")
    out = torch.empty(words, dtype=torch.int32, device=planes.device)
    if words == 0:
        return out
    vec = int(words % 4 == 0 and planes.data_ptr() % 16 == 0)
    lib = _lib()
    # only the low b bits of each constant matter (the reference reads
    # bit b-1-i of it), so they travel modulo 2^32
    rc = lib.bitweaving_scan_launch(
        planes.data_ptr(), out.data_ptr(), b, words,
        int(c1) & 0xFFFFFFFF, int(c2) & 0xFFFFFFFF, vec,
        torch.cuda.current_stream(planes.device).cuda_stream)
    build.check(lib, rc, "bitweaving_scan launch")
    bitweaving_scan.launches += 1
    return out


bitweaving_scan.launches = 0
