"""Plain PyTorch oracles for the kernels of this package.

Each function is the semantic ground truth the kernels are validated
against (exact equality - these are integer/bit ops, so no tolerance).
Words are int32 tensors holding the reference's uint32 bit patterns.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..core import expr as E
from ..core.bitvector import popcount_words


def bitwise_eval(expression: E.Expr,
                 env: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Fused bitwise expression over packed int32 tensors."""
    return E.eval_expr(expression, env)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Total set bits per row: (rows, words) int32 -> (rows,) int32."""
    return popcount_words(x).sum(-1).to(torch.int32)


def bitweaving_scan(planes: torch.Tensor, c1: int, c2: int) -> torch.Tensor:
    """BitWeaving-V predicate scan: c1 <= v <= c2 (Section 8.2).

    planes: (b, words) int32 bit-sliced column - plane i holds bit
    (b-1-i) (MSB first) of each of the words*32 values.
    Returns a packed int32 result bitvector (words,) with bit j set iff
    c1 <= v_j <= c2.
    """
    b = planes.shape[0]

    def cmp(const: int):
        """Returns (gt, lt, eq) packed masks of v <op> const."""
        gt = torch.zeros_like(planes[0])
        lt = torch.zeros_like(planes[0])
        eq = torch.full_like(planes[0], -1)
        for i in range(b):
            cbit = (const >> (b - 1 - i)) & 1
            p = planes[i]
            if cbit:
                lt = lt | (eq & ~p)
            else:
                gt = gt | (eq & p)
            eq = eq & ~(p ^ (-1 if cbit else 0))
        return gt, lt, eq

    gt1, lt1, eq1 = cmp(c1)
    gt2, lt2, eq2 = cmp(c2)
    ge_c1 = gt1 | eq1
    le_c2 = lt2 | eq2
    return ge_c1 & le_c2


def bitslice(values: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack integer column (n,) -> bit-sliced planes (bits, n/32) int32,
    MSB-first plane order. n must be a multiple of 32."""
    n = values.shape[0]
    if n % 32:
        raise ValueError(f"bitslice needs a multiple of 32 values, got {n}")
    v = values.to(torch.int64)      # uint32 values do not fit int32
    planes = []
    for i in range(bits):
        bit = (v >> (bits - 1 - i)) & 1
        planes.append(_pack32(bit))
    return torch.stack(planes)


def _pack32(bits01: torch.Tensor) -> torch.Tensor:
    bits01 = bits01.reshape(-1, 32).to(torch.int32)
    shifts = torch.arange(32, dtype=torch.int32, device=bits01.device)
    return (bits01 << shifts).sum(-1, dtype=torch.int32)
