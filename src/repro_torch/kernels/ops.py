"""Public wrappers around the CUDA kernels.

These are the entry points the ``"cuda"`` backend of the engine and the
device store use (the store's planner through ``fused_eval``). A CUDA
tensor launches the hand-written kernel (or raises); a CPU tensor takes
the kernel's plain PyTorch version. The
kernels take any ``(rows, words)`` shape and mask the ragged edge
themselves, so there is no padding to tile multiples here; every
wrapper returns the shapes the reference package's wrappers return.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import expr as E
from . import binary_matmul as _bmm
from . import bitweaving as _bw
from . import bitwise as _bitwise
from . import popcount as _pc
from . import ref

# -- fused-dispatch probe ------------------------------------------------------
# Counts calls to ``fused_eval`` - one increment per fused kernel launch
# issued by Python. Tests and benchmarks assert "one fused dispatch per
# epoch" against this counter.

_FUSED_DISPATCHES = 0


def _count_dispatch() -> None:
    global _FUSED_DISPATCHES
    _FUSED_DISPATCHES += 1


def fused_dispatch_count() -> int:
    return _FUSED_DISPATCHES


def fused_dispatch_reset() -> None:
    global _FUSED_DISPATCHES
    _FUSED_DISPATCHES = 0


@functools.lru_cache(maxsize=256)
def _lowered(expression: E.Expr, names: tuple) -> _bitwise.Program:
    """The one lowering of each ``(expression, names)``; every launch
    passes it to the kernel by value."""
    return _bitwise.lower(expression, names)


def launch_args(expression: E.Expr, names: tuple, queries: int,
                evaluations: int) -> dict:
    """What a launch of ``queries`` queries in ``evaluations`` distinct
    jobs carries, for its host span: the kernel program's instructions,
    the evaluations, and whether the pointers go by value in the launch
    or in a device table."""
    program = _lowered(expression, names)
    return {"instructions": int(program.packed.shape[0]),
            "evaluations": evaluations,
            "pointers": "value" if _bitwise.by_value(
                program, queries, evaluations) else "table"}


def _rows_words(shape) -> tuple:
    lead, words = tuple(shape[:-1]), int(shape[-1])
    return (int(np.prod(lead)) if lead else 1), words


def fused_eval(expression: E.Expr, names: tuple,
               operands: Sequence[Sequence[torch.Tensor]],
               n_bits: Optional[int] = None,
               out: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """ONE fused dispatch for an epoch: ``operands[q]`` are query q's
    tensors in ``names`` order, each result tail-masked to ``n_bits`` when
    given. A single query launches ``fused_bitwise`` and may write into
    ``out`` (one of its operands: in place); an epoch of more launches
    ``fused_bitwise_stacked``. The entry of the public wrappers below and
    of ``DevicePlanner``; it counts the dispatch."""
    _count_dispatch()
    program = _lowered(expression, names)
    if len(operands) == 1:
        return [_bitwise.fused_bitwise(expression, names, operands[0],
                                       program, n_bits, out)]
    return _bitwise.fused_bitwise_stacked(expression, names, operands,
                                          program, n_bits)


def bitwise_eval(expression: E.Expr,
                 env: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Fused bitwise expression over packed int32 tensors of equal shape."""
    names = tuple(sorted(env.keys()))
    return fused_eval(expression, names,
                      [[env[n].contiguous() for n in names]])[0]


def bitwise_eval_stacked(expression: E.Expr, names: Sequence[str],
                         envs) -> List[torch.Tensor]:
    """Evaluate one expression over a batch of shape-compatible operand
    environments in a single kernel launch. ``envs`` is a list of
    name->(..., words) tensors, all equal-shaped; returns one result
    tensor per environment."""
    names = tuple(names)
    return fused_eval(expression, names,
                      [[env[nm].contiguous() for nm in names]
                       for env in envs])


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Per-row popcount: (..., words) int32 -> (...,) int32."""
    lead = tuple(x.shape[:-1])
    rows, words = _rows_words(x.shape)
    out = _pc.popcount_rows(x.contiguous().reshape(rows, words))
    return out.reshape(lead) if lead else out[0]


def bitweaving_scan(planes: torch.Tensor, c1: int, c2: int,
                    n_bits: Optional[int] = None) -> torch.Tensor:
    """(b, words) bit-sliced planes -> packed (words,) predicate bitvector,
    its bits from ``n_bits`` on zero when given (masked in the store)."""
    return _bw.bitweaving_scan(planes.contiguous(), int(c1), int(c2), n_bits)


def binary_matmul(a_packed: torch.Tensor, b_packed: torch.Tensor,
                  k_bits: int) -> torch.Tensor:
    """Packed XNOR-popcount matmul: (M,Kw) x (N,Kw) -> (M,N) int32."""
    return _bmm.binary_matmul(a_packed.contiguous(), b_packed.contiguous(),
                              int(k_bits))


def binary_matmul_mxu(a_packed: torch.Tensor, b_packed: torch.Tensor,
                      k_bits: int) -> torch.Tensor:
    """Dense-product alternative: unpack to +-1 and ``torch.matmul`` (a
    plain product outside any kernel, as the reference leaves it to XLA)."""
    return ref.binary_matmul_mxu(a_packed, b_packed, int(k_bits))
