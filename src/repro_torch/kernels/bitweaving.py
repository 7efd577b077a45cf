"""BitWeaving-V predicate scan kernel (CUDA, ``csrc/bitweaving.cu``) -
Section 8.2.

Evaluates ``c1 <= v <= c2`` over a bit-sliced column: plane i holds bit
(b-1-i) (MSB first) of every value, packed 32 values a word. The
comparison runs MSB->LSB keeping packed gt/lt/eq masks per constant.
``bitweaving_scan`` launches the kernel for a CUDA tensor and counts the
launch in ``bitweaving_scan.launches``; a CPU tensor takes the plain
PyTorch version beside it. Given ``n_bits``, both zero the result's bits
from ``n_bits`` on (the kernel in its store), as ``_mask_tail`` does.
``plan`` picks the vector width every plane shares and the grid.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ..core.bitvector import _mask_tail
from . import build, ref

THREADS = 256           # threads a block (csrc THREADS)
WIDTHS = (16, 8, 4)     # vector bytes a thread, widest first


class Plan(NamedTuple):
    width: int          # bytes a thread loads from each plane
    blocks: int         # grid x: one vector position a thread


def plan(b: int, words: int, ptr: int) -> Plan:
    """The launch for (b, words) planes at address ``ptr``: the widest of
    16, 8 and 4 bytes dividing both ``ptr`` and the plane stride
    ``4 * words`` (so all b planes share it at every position), and a
    thread for each vector position."""
    if not 1 <= b <= 32 or words < 1:
        raise ValueError(f"bitweaving_scan plans 1..32 planes of >= 1 "
                         f"words, got {b}, {words}")
    if ptr % 4:
        raise ValueError(f"int32 planes start 4-byte aligned, got {ptr}")
    width = next(w for w in WIDTHS if ptr % w == 0 and 4 * words % w == 0)
    units = 4 * words // width
    return Plan(width, -(-units // THREADS))


# plan depends on the address only modulo 16: one plan a shape and offset
_plan = functools.lru_cache(maxsize=1024)(plan)


def tail_mask(n_bits: Optional[int], words: int):
    """(full, partial) of the kernel's store: words from ``full`` on keep
    no bit except word ``full``, which keeps ``partial``'s."""
    if n_bits is None or n_bits >= 32 * words:
        return words, 0
    if n_bits < 0:
        raise ValueError(f"n_bits must be >= 0, got {n_bits}")
    return n_bits // 32, (1 << n_bits % 32) - 1


def bitweaving_scan_plain(planes: torch.Tensor, c1: int, c2: int,
                          n_bits: Optional[int] = None) -> torch.Tensor:
    """(b, words) int32 planes -> (words,) int32 predicate bitvector, its
    bits from ``n_bits`` on zero when given."""
    out = ref.bitweaving_scan(planes, c1, c2)
    return out if n_bits is None else _mask_tail(out, n_bits)


def _lib():
    lib = build.load("bitweaving")
    fn = lib.bitweaving_scan_launch
    if fn.argtypes is None:         # declare once: pointers stay 64-bit
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_uint, ctypes.c_uint,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_uint, ctypes.c_void_p]
    return lib


def bitweaving_scan(planes: torch.Tensor, c1: int, c2: int,
                    n_bits: Optional[int] = None) -> torch.Tensor:
    """One launch: (b <= 32, words) planes -> (words,) packed result,
    masked to ``n_bits`` when given."""
    if not planes.is_cuda:
        if planes.device.type != "cpu":
            raise ValueError(f"unsupported device {planes.device}")
        return bitweaving_scan_plain(planes, c1, c2, n_bits)
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
    full, partial = tail_mask(n_bits, words)
    p = _plan(b, words, planes.data_ptr() % 16)
    lib = _lib()
    # only the low b bits of each constant matter (the reference reads
    # bit b-1-i of it), so they travel modulo 2^32
    rc = lib.bitweaving_scan_launch(
        planes.data_ptr(), out.data_ptr(), b, words,
        int(c1) & 0xFFFFFFFF, int(c2) & 0xFFFFFFFF, p.width, p.blocks, full,
        partial, torch.cuda.current_stream(planes.device).cuda_stream)
    build.check(lib, rc, "bitweaving_scan launch")
    bitweaving_scan.launches += 1
    return out


bitweaving_scan.launches = 0
