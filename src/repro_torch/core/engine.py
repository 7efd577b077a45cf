"""BulkBitwiseEngine: the `bbop` execution model exposed to applications.

Three interchangeable backends compute identical results:

  * "torch"     - plain PyTorch tensor code over packed int32 words, on any
                  device (the twin of the reference's "jnp").
  * "cuda"      - the hand-written CUDA kernels through ``kernels.ops``
                  (the twin of the reference's "pallas"): one fused launch
                  per expression. On a CPU tensor the kernels' plain
                  versions run.
  * "ambit_sim" - the bit-accurate DRAM device model (core/simulator.py),
                  which also returns the paper's DRAM timing/energy ledger.
                  Its row state lives on the engine's device.

Entry points run on the card unless the caller asks for the CPU:
``device`` defaults to "cuda" and raises when no card is present.

ambit_sim execution model (batched + cached)
--------------------------------------------
An eval call maps every row of the packed operands to one D-group row of a
simulated subarray (the Section 5.2 co-location contract). Two levers make
this fast enough for paper-table workloads at realistic bitvector sizes:

  * **Compiled-program cache.** ``compile_expr`` output depends only on
    ``(expression, sorted variable names, optimize, geometry.data_rows,
    timing)`` - expressions are hash-consed (expr.py), so an LRU keyed on
    those fields compiles each expression shape exactly once per process.
    Inspect/reset with ``compile_cache_info()`` / ``compile_cache_clear()``.
  * **Batched device execution.** All operand rows are written into one
    ``AmbitSubarray(n_rows=N)`` and the AAP program runs **once** over the
    whole batch instead of once per row (the per-row loop stays available
    as ``BulkBitwiseEngine(..., batch_rows=False)`` for differential
    testing and benchmarks). Stats are scaled per row-batch, so the
    reported DRAM ledger is identical to the per-row loop's.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import torch

from . import expr as E
from .bitvector import BitVector, _mask_tail, resolve_device
from .compiler import CompiledProgram, compile_expr
from .geometry import DEFAULT_GEOMETRY, DRAMGeometry
from .simulator import AmbitSubarray
from .timing import DEFAULT_TIMING, CommandStats, TimingParams
from ..obs import NULL_TRACER, MetricsRegistry, Tracer

# The resident-path backends (DeviceStore, AmbitRuntime); the engine also
# takes "ambit_sim".
BACKENDS = ("torch", "cuda")


def check_backend(backend: str) -> None:
    """Backends of the resident path (``AmbitRuntime``, ``DeviceStore``)."""
    if backend == "ambit_sim":
        raise NotImplementedError(
            "the PIM runtime on backend 'ambit_sim' (PimStore on the DRAM "
            "model) is not ported yet: ROADMAP queue 1 item 9")
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
def _compile_cached(expression: E.Expr, names: tuple, optimize: bool,
                    data_rows: int, timing: TimingParams) -> CompiledProgram:
    """Process-wide compiled-program cache.

    Valid because Expr nodes are interned (identity == structural equality),
    TimingParams is frozen, and CompiledProgram is immutable: the program
    depends only on the expression shape, the variable-name order (row
    assignment), the optimize flag and the D-group size."""
    var_rows = {nm: i for i, nm in enumerate(names)}
    return compile_expr(expression, var_rows, len(names), data_rows,
                        optimize, timing)


def compile_cache_info():
    """functools cache statistics for the ambit_sim compile cache."""
    return _compile_cached.cache_info()


def compile_cache_clear() -> None:
    _compile_cached.cache_clear()


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
                 geometry: DRAMGeometry = DEFAULT_GEOMETRY,
                 timing: TimingParams = DEFAULT_TIMING,
                 optimize: bool = True, batch_rows: bool = True,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None):
        if backend not in BACKENDS + ("ambit_sim",):
            raise ValueError(backend)
        self.backend = backend
        self.device = resolve_device(device)
        self.geometry = geometry
        self.timing = timing
        self.optimize = optimize
        # batch_rows=False forces the one-subarray-per-row loop
        # (differential-testing / benchmark baseline; ambit_sim only).
        self.batch_rows = batch_rows
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
        if self.backend == "ambit_sim":
            return self._eval_sim(expression, env, n_bits)
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

    # -- ambit_sim backend ---------------------------------------------------

    def _eval_sim(self, expression: E.Expr, env: Dict[str, BitVector],
                  n_bits: int) -> BitVector:
        """Execute the compiled AAP program on the device model.

        Each 'row' of the operand bitvectors maps to one D-group row of a
        simulated subarray (the Section 5.2 driver's co-location contract:
        corresponding rows of all operands share a subarray). The program
        is fetched from the process-wide compile cache and - unless
        ``batch_rows=False`` - executed once over a batch-``n_rows``
        subarray on the engine's device: one write / one run / one read."""
        names = sorted(env.keys())
        var_rows = {nm: i for i, nm in enumerate(names)}
        dst_row = len(names)
        compiled = _compile_cached(expression, tuple(names), self.optimize,
                                   self.geometry.data_rows, self.timing)
        # Pack to 64-bit words for the simulator.
        packed = {nm: _to_u64(env[nm].data.to(self.device)) for nm in names}
        some = packed[names[0]]
        lead = tuple(some.shape[:-1])
        flat = {nm: a.reshape(-1, a.shape[-1]) for nm, a in packed.items()}
        n_rows, words = next(iter(flat.values())).shape

        if n_rows == 0:  # zero-row operands: nothing to execute
            out_rows = torch.empty((0, words), dtype=torch.int64,
                                   device=self.device)
            total = CommandStats()
        elif self.batch_rows:
            sub = AmbitSubarray(self.geometry, self.timing, words=words,
                                n_rows=n_rows, device=self.device)
            for nm in names:
                sub.write_row(var_rows[nm], flat[nm])
            sub.run(compiled.program)
            out_rows = sub.read_row(dst_row).reshape(n_rows, words)
            total = sub.stats
        else:  # the per-row loop (differential baseline)
            out_rows = torch.empty((n_rows, words), dtype=torch.int64,
                                   device=self.device)
            total = CommandStats()
            sub = AmbitSubarray(self.geometry, self.timing, words=words,
                                device=self.device)
            for r in range(n_rows):
                for nm in names:
                    sub.write_row(var_rows[nm], flat[nm][r])
                sub.stats = CommandStats()
                sub.run(compiled.program)
                out_rows[r] = sub.read_row(dst_row)
                total.merge(sub.stats)

        out32 = _to_u32(out_rows.reshape(lead + (words,)))
        # bytes_touched is host<->device traffic: every operand is written
        # to the subarray and the result is read back (same accounting as
        # the torch path's inputs + output).
        self.last_stats = OpStats(ns=total.ns, energy_nj=total.energy_nj,
                                  aap_count=total.aap_count,
                                  bytes_touched=out32.nbytes +
                                  sum(v.nbytes for v in env.values()))
        self.metrics.counter("engine_evals").inc(1, backend=self.backend)
        self.metrics.counter("engine_bytes_touched").inc(
            self.last_stats.bytes_touched, backend=self.backend)
        self.metrics.counter("engine_aap_macros").inc(total.aap_count)
        self.metrics.counter("engine_ns").inc(total.ns)
        if self.tracer.enabled:
            # AAP macro batch: one span per compiled-program execution on
            # the engine's busy-time track.
            self.tracer.tick(("engine", "ambit_sim"), "aap_batch", "engine",
                             total.ns, args={"aaps": total.aap_count,
                                             "rows": n_rows,
                                             "vars": len(names)})
        # Padding rows beyond n_bits may be garbage from scratch state: mask.
        return BitVector(_mask_tail(out32, n_bits), n_bits)


def _to_u64(a32: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 words with the same bytes (little-endian, as
    numpy's uint32 -> uint64 view): an odd word count gains a zero word."""
    if a32.shape[-1] % 2:
        a32 = torch.cat([a32, a32.new_zeros(a32.shape[:-1] + (1,))], -1)
    return a32.contiguous().view(torch.int64)


def _to_u32(a64: torch.Tensor) -> torch.Tensor:
    return a64.contiguous().view(torch.int32)
