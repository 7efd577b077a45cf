"""Per-row popcount kernel (CUDA, ``csrc/popcount.cu``) - the paper's
``bitcount`` (Section 9.1).

``popcount_rows`` launches the kernel for a CUDA tensor - one launch a
call, into an output it does not zero, each row stored once - and counts
the launch in ``popcount_rows.launches``; a CPU tensor takes the plain
PyTorch version beside it. ``plan`` picks the route, the blocks a row and
the grid; ``row_parts`` is the cut of a row into head, body and tail that
the kernel makes for every row.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import torch

from . import build, ref

THREADS = 256           # threads a block (csrc THREADS)
UNROLL = 4              # 16-byte loads a thread in flight (csrc UNROLL)
SHORT_LOADS = 8         # words a thread of the short-row route (csrc)
SHORT_WORDS = 32 * SHORT_LOADS  # rows up to this long take the short route
FILL_WAVES = 4          # the most blocks an SM the rows of a launch split into
MIN_TICKETS = 1024      # ticket words allocated at the least
ROUTE_SHORT, ROUTE_LONG = 0, 1


class Plan(NamedTuple):
    route: int          # ROUTE_SHORT or ROUTE_LONG
    group: int          # short route: threads a row (a power of two <= 32)
    splits: int         # long route: blocks a row, meeting by ticket if > 1
    per: int            # long route: body vectors a block walks
    blocks: int         # grid x


def row_parts(words: int, addr: int) -> Tuple[int, int, int]:
    """(head, body, tail) of a row of ``words`` int32 at byte ``addr``:
    the words before the first 16-byte boundary, the 16-byte vectors, the
    words after the last vector. The kernel cuts every row so."""
    if addr % 4:
        raise ValueError(f"int32 rows start 4-byte aligned, got {addr}")
    head = min(words, (-addr % 16) // 4)
    body = (words - head) // 4
    return head, body, words - head - 4 * body


def plan(rows: int, words: int, sms: int) -> Plan:
    """The launch for (rows, words) int32 on a card of ``sms`` SMs: rows
    of at most SHORT_WORDS words take the short route, ``group`` threads a
    row; longer rows split into blocks that together fill the card (at
    least ``sms`` blocks, at most FILL_WAVES an SM, each thread at most
    UNROLL vectors a pass where that fits, at least one). The plan holds
    at any address: the kernel cuts each row by ``row_parts``."""
    if rows < 1 or words < 1:
        raise ValueError(f"popcount_rows plans rows, words >= 1, got "
                         f"{rows}, {words}")
    if words <= SHORT_WORDS:
        group = 1
        while group * SHORT_LOADS < words:
            group *= 2
        return Plan(ROUTE_SHORT, group, 1, 0, -(-rows * group // THREADS))
    nv = words // 4                      # the most vectors a row can hold
    passes = -(-nv // (THREADS * UNROLL))
    splits = max(-(-sms // rows), min(passes, -(-FILL_WAVES * sms // rows)))
    splits = max(1, min(splits, -(-nv // THREADS)))
    if rows * splits > 2**31 - 1:
        raise ValueError(f"popcount_rows takes at most 2^31 - 1 blocks, "
                         f"({rows}, {words}) needs {rows * splits}")
    return Plan(ROUTE_LONG, 1, splits, -(-nv // splits), rows * splits)


# one plan a shape, so a served launch does not plan again
_plan = functools.lru_cache(maxsize=1024)(plan)


def popcount_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """(rows, words) int32 -> (rows,) int32 set-bit counts (SWAR)."""
    return ref.popcount(x)


def _lib():
    lib = build.load("popcount")
    if lib.popcount_long_launch.argtypes is None:   # pointers stay 64-bit
        lib.popcount_long_launch.restype = ctypes.c_int
        lib.popcount_long_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.popcount_short_launch.restype = ctypes.c_int
        lib.popcount_short_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    return lib


# The ticket words of each (device, stream): one uint64 a row, the tickets
# drawn and the partials' running sum, all 0 between launches. They are
# zeroed once, when they are allocated (or grown); each launch's last
# block of a row resets that row's word, so no launch zeroes anything. A
# set of words serves one stream: launches queued on it run one after
# another and never share a word while they run, and launches on two
# streams at once each take their own stream's words.
_TICKETS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _tickets(device: torch.device, stream: int, rows: int) -> int:
    """The ticket words for a launch of ``rows`` rows on ``stream``."""
    words = _TICKETS.get((device, stream))
    if words is None or words.numel() < rows:
        words = torch.zeros(max(rows, MIN_TICKETS), dtype=torch.int64,
                            device=device)
        _TICKETS[(device, stream)] = words
    return words.data_ptr()


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
    if rows == 0 or words == 0:
        return torch.zeros(rows, dtype=torch.int32, device=x.device)
    out = torch.empty(rows, dtype=torch.int32, device=x.device)
    p = _plan(rows, words, build.sm_count(x.device))
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if p.route == ROUTE_SHORT:
        rc = lib.popcount_short_launch(x.data_ptr(), out.data_ptr(), rows,
                                       words, p.group, p.blocks, stream)
    else:
        tickets = _tickets(x.device, stream, rows) if p.splits > 1 else None
        rc = lib.popcount_long_launch(
            x.data_ptr(), out.data_ptr(), rows, words, p.splits, p.per,
            tickets, stream)
    build.check(lib, rc, "popcount_rows launch")
    popcount_rows.launches += 1
    return out


popcount_rows.launches = 0
