"""Per-row popcount kernel (CUDA, ``csrc/popcount.cu``) - the paper's
``bitcount`` (Section 9.1).

``popcount_rows`` launches the kernel for a CUDA tensor and counts the
launch in ``popcount_rows.launches``; a CPU tensor takes the plain
PyTorch version beside it.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, ref


def popcount_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """(rows, words) int32 -> (rows,) int32 set-bit counts (SWAR)."""
    return ref.popcount(x)


def _lib():
    lib = build.load("popcount")
    fn = lib.popcount_rows_launch
    if fn.argtypes is None:         # declare once: pointers stay 64-bit
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    return lib


def popcount_rows(x: torch.Tensor) -> torch.Tensor:
    """(rows, words) int32 -> (rows,) int32 popcounts in one launch."""
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"unsupported device {x.device}")
        return popcount_rows_plain(x)
    if x.dtype != torch.int32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("popcount_rows takes a contiguous (rows, words) "
                         f"int32 tensor, got {x.dtype} {tuple(x.shape)}")
    rows, words = x.shape
    out = torch.zeros(rows, dtype=torch.int32, device=x.device)
    if rows == 0 or words == 0:
        return out
    vec = int(words % 4 == 0 and x.data_ptr() % 16 == 0)
    lib = _lib()
    rc = lib.popcount_rows_launch(
        x.data_ptr(), out.data_ptr(), rows, words, vec,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, rc, "popcount_rows launch")
    popcount_rows.launches += 1
    return out


popcount_rows.launches = 0
