"""BulkBitwiseEngine: the `bbop` execution model exposed to applications.

Two interchangeable backends compute identical results:

  * "torch" - plain PyTorch tensor code over packed int32 words, on any
              device (the twin of the reference's "jnp").
  * "cuda"  - the hand-written CUDA kernels through ``kernels.ops`` (the
              twin of the reference's "pallas"): one fused launch per
              expression. On a CPU tensor the kernels' plain versions run.

The reference's third backend, "ambit_sim" (the bit-accurate DRAM device
model), is not ported yet (ROADMAP queue 1 item 8).

Entry points run on the card unless the caller asks for the CPU:
``device`` defaults to "cuda" and raises when no card is present.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import torch

from . import expr as E
from .bitvector import BitVector, _mask_tail
from ..obs import NULL_TRACER, MetricsRegistry, Tracer

BACKENDS = ("torch", "cuda")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless ``device``
    names another. Raises when the card is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev


def check_backend(backend: str) -> None:
    if backend == "ambit_sim":
        raise NotImplementedError(
            "backend 'ambit_sim' (the DRAM device model) is not ported yet: "
            "ROADMAP queue 1 item 8 (DRAM model) and item 9 (PIM runtime "
            "on ambit_sim)")
    if backend not in BACKENDS:
        raise ValueError(backend)


@dataclasses.dataclass
class OpStats:
    """Per-call accounting (DRAM model units when backend=ambit_sim).

    ``bytes_touched`` is host<->device traffic; ``channel_bytes`` /
    ``channel_ns`` are *inter-device* transfers on a multi-device
    cluster (pim.cluster) - measured from rows actually moved, never
    from an analytic formula. ``channel_ns`` is already included in
    ``ns`` (transfers serialize before the device programs run); the
    separate field exists so callers can see how much of the critical
    path the channel re-introduced.

    ``refresh_stolen_ns`` is DRAM refresh time interleaved with this
    call's bank-busy time (tRFC out of every tREFI, timing.py). It is
    deliberately NOT folded into ``ns`` - the base ledger stays the
    refresh-free device cost so results remain comparable across
    backends; refresh-aware wall clock is opt-in via
    ``AsyncScheduler.drain(refresh=True)``."""

    ns: float = 0.0
    energy_nj: float = 0.0
    aap_count: int = 0
    bytes_touched: int = 0
    channel_ns: float = 0.0
    channel_bytes: int = 0
    refresh_stolen_ns: float = 0.0

    def merge(self, other: "OpStats") -> "OpStats":
        """Accumulate another ledger into this one (all fields)."""
        self.ns += other.ns
        self.energy_nj += other.energy_nj
        self.aap_count += other.aap_count
        self.bytes_touched += other.bytes_touched
        self.channel_ns += other.channel_ns
        self.channel_bytes += other.channel_bytes
        self.refresh_stolen_ns += other.refresh_stolen_ns
        return self

    def __iadd__(self, other: "OpStats") -> "OpStats":
        return self.merge(other)


@functools.lru_cache(maxsize=256)
def _device_compiled(expression: E.Expr, names: tuple, backend: str,
                     n_bits: int, donate_idx: Optional[int]):
    """Callable LRU for the accelerator-resident path, keyed like the
    reference's jit LRU: one callable per ``(expression, names, backend,
    n_bits, donation slot)``. On "cuda" it is one fused launch through
    ``kernels.ops`` (which lowers each expression once). ``donate_idx``
    names the operand whose buffer the result overwrites in place
    (``out=`` rebinds of store-private buffers); the plain "torch"
    backend allocates a fresh result instead, as the reference does off
    the accelerator."""
    def compute(*arrays):
        if backend == "cuda":
            from ..kernels import ops as kops
            out = None if donate_idx is None else arrays[donate_idx]
            return kops._eval(expression, names, arrays, n_bits, out)
        return _mask_tail(E.eval_expr(expression, dict(zip(names, arrays))),
                          n_bits)
    return compute


@functools.lru_cache(maxsize=256)
def _device_compiled_stacked(expression: E.Expr, names: tuple, backend: str,
                             n_bits: int):
    """Epoch variant of ``_device_compiled``: the callable takes one list
    of operand tensors per query and evaluates the whole epoch in ONE
    launch on "cuda" (per-query operand and output pointers, no stacking
    copy), returning one result tensor per query."""
    def compute(operands):
        if backend == "cuda":
            from ..kernels import ops as kops
            return kops._eval_stacked(expression, names, operands, n_bits)
        return [_mask_tail(E.eval_expr(expression, dict(zip(names, arrays))),
                           n_bits) for arrays in operands]
    return compute


def device_compile_cache_info():
    """Cache statistics for the accelerator-resident callable LRUs."""
    return (_device_compiled.cache_info(),
            _device_compiled_stacked.cache_info())


def device_compile_cache_clear() -> None:
    _device_compiled.cache_clear()
    _device_compiled_stacked.cache_clear()


def binop_expr(op: str) -> E.Expr:
    """The bbop ISA's two-operand expressions over vars "a"/"b" (single
    source of truth for the engine and the pim runtime)."""
    x, y = E.Expr.var("a"), E.Expr.var("b")
    return {"and": x & y, "or": x | y, "xor": x ^ y,
            "nand": ~(x & y), "nor": ~(x | y), "xnor": ~(x ^ y)}[op]


class BulkBitwiseEngine:
    def __init__(self, backend: str = "torch", device=None,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None):
        check_backend(backend)
        self.backend = backend
        self.device = resolve_device(device)
        self.last_stats: Optional[OpStats] = None
        # Observability: metrics are always on (cheap counter adds);
        # span tracing is opt-in via a live Tracer (zero overhead off).
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else MetricsRegistry()

    # -- expression evaluation ------------------------------------------------

    def eval(self, expression: E.Expr,
             env: Dict[str, BitVector]) -> BitVector:
        some = next(iter(env.values()))
        n_bits = some.n_bits
        for v in env.values():
            if v.n_bits != n_bits or v.data.shape != some.data.shape:
                raise ValueError("bbop operands must be row-aligned and "
                                 "equal-sized (Section 5.3)")
        arrays = {k: v.data.to(self.device) for k, v in env.items()}
        if self.backend == "cuda":
            from ..kernels import ops as kops
            out = kops.bitwise_eval(expression, arrays)
        else:
            out = E.eval_expr(expression, arrays)
        self.last_stats = OpStats(
            bytes_touched=sum(v.nbytes for v in env.values()) + out.nbytes)
        self.metrics.counter("engine_evals").inc(1, backend=self.backend)
        self.metrics.counter("engine_bytes_touched").inc(
            self.last_stats.bytes_touched, backend=self.backend)
        return BitVector(out, n_bits)

    # -- bbop-style binary ops -------------------------------------------------

    def _binop(self, op: str, a: BitVector, b: BitVector) -> BitVector:
        return self.eval(binop_expr(op), {"a": a, "b": b})

    def and_(self, a, b):
        return self._binop("and", a, b)

    def or_(self, a, b):
        return self._binop("or", a, b)

    def xor(self, a, b):
        return self._binop("xor", a, b)

    def nand(self, a, b):
        return self._binop("nand", a, b)

    def nor(self, a, b):
        return self._binop("nor", a, b)

    def xnor(self, a, b):
        return self._binop("xnor", a, b)

    def not_(self, a: BitVector) -> BitVector:
        return self.eval(~E.Expr.var("a"), {"a": a})

    def maj(self, a: BitVector, b: BitVector, c: BitVector) -> BitVector:
        return self.eval(E.maj(E.Expr.var("a"), E.Expr.var("b"),
                               E.Expr.var("c")), {"a": a, "b": b, "c": c})

    def masked_set(self, x: BitVector, mask: BitVector) -> BitVector:
        """Masked initialization (Section 8.4.2): x | mask."""
        return self.or_(x, mask)

    def masked_clear(self, x: BitVector, mask: BitVector) -> BitVector:
        return self.eval(E.Expr.var("x") & ~E.Expr.var("m"),
                         {"x": x, "m": mask})

    def popcount(self, a: BitVector) -> torch.Tensor:
        """Bitcount (Section 9.1 future-op; we provide it natively)."""
        data = a.data.to(self.device)
        if self.backend == "cuda":
            from ..kernels import ops as kops
            out = kops.popcount(data)
        else:
            out = BitVector(data, a.n_bits).popcount()
        # Fresh ledger on every public entry point: callers accumulate
        # ``last_stats`` after each call.
        self.last_stats = OpStats(bytes_touched=a.nbytes + out.nbytes)
        return out

    def shift(self, a: BitVector, amount: int) -> BitVector:
        """Logical bit shift by `amount` positions (Section 9.1 future-op).
        Positive = toward higher bit indices; zeros shift in. Implemented
        over packed words for all backends (bit i of the result = bit
        i-amount of the input). Right shifts of int32 words sign-extend,
        so every one is masked to a logical shift."""
        n = a.n_bits
        # Fresh ledger per entry point (host-side op: two buffers cross).
        self.last_stats = OpStats(bytes_touched=2 * a.nbytes)
        data = a.data.to(self.device)
        if amount == 0:
            return BitVector(data, n)
        w = 32
        word_off, bit_off = divmod(abs(amount), w)
        nw = data.shape[-1]
        idx = torch.arange(nw, device=data.device)
        if amount > 0:
            x = torch.roll(data, word_off, dims=-1)
            x = torch.where(idx < word_off, 0, x)
            if bit_off:
                lo = x << bit_off
                carry = (torch.roll(x, 1, dims=-1) >> (w - bit_off)) & \
                    ((1 << bit_off) - 1)
                carry = torch.where(idx == 0, 0, carry)
                x = lo | carry
        else:
            x = torch.roll(data, -word_off, dims=-1)
            x = torch.where(idx >= nw - word_off, 0, x)
            if bit_off:
                hi = (x >> bit_off) & ((1 << (w - bit_off)) - 1)
                carry = torch.roll(x, -1, dims=-1) << (w - bit_off)
                carry = torch.where(idx == nw - 1, 0, carry)
                x = hi | carry
        return BitVector(_mask_tail(x, n), n)
