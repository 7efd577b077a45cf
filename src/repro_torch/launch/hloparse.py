"""Post-SPMD HLO text analysis: FLOPs / HBM traffic / collective bytes
with while-loop trip counts.

Why not compiled.cost_analysis(): XLA counts a while (lax.scan) body ONCE,
under-counting an L-layer scanned model by ~L x. This parser assigns every
computation an execution-count multiplier (while bodies x trip count,
fusion bodies inherit their caller) and weights costs accordingly.

The module analyzed is the per-partition SPMD program, so all returned
numbers are PER-DEVICE.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Tuple

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_COMP_HDR = re.compile(r"^(?:ENTRY\s+)?%([\w\.\-]+)\s*\(")
_WHILE_RE = re.compile(
    r"while\([^)]*\)[^\n]*condition=%?([\w\.\-]+)[^\n]*body=%?([\w\.\-]+)")
_CALLS_RE = re.compile(r"(?:calls|to_apply)=%?([\w\.\-]+)")
_CONST_RE = re.compile(r"constant\((\d+)\)")
_DEF_RE = re.compile(r"^(?:ROOT\s+)?%([\w\.\-]+)\s*=\s*(.+)$")
_PARAM_DECL_RE = re.compile(r"%?([\w\.\-]+):\s*(\(?[\w\[\],\s]+\)?)")
_CONTRACT_RE = re.compile(r"lhs_contracting_dims=\{([\d,]*)\}")
_OPERAND_RE = re.compile(r"%([\w\.\-]+)")

MAX_TRIP = 1_000_000  # ignore sentinel constants (INT_MAX bounds)


def _first_shape(type_str: str) -> Tuple[str, List[int]]:
    m = _SHAPE_RE.search(type_str)
    if not m:
        return "", []
    dims = [int(d) for d in m.group(2).split(",") if d]
    return m.group(1), dims


def _all_shapes_bytes(type_str: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(type_str):
        dt = m.group(1)
        if dt not in DTYPE_BYTES:
            continue
        n = 1
        for d in m.group(2).split(","):
            if d:
                n *= int(d)
        total += n * DTYPE_BYTES[dt]
    return total


def _shape_nbytes(dt: str, dims: List[int]) -> int:
    if dt not in DTYPE_BYTES:
        return 0
    n = 1
    for d in dims:
        n *= d
    return n * DTYPE_BYTES[dt]


class HloModule:
    """Parsed view: computations, per-op definitions, symbol shapes."""

    def __init__(self, hlo: str):
        self.comps: Dict[str, List[str]] = {}
        self.shapes: Dict[str, Tuple[str, List[int]]] = {}
        self.comp_params: Dict[str, List[str]] = {}
        name = None
        for raw in hlo.splitlines():
            ln = raw.strip()
            hdr = _COMP_HDR.match(raw) if raw and raw[0] in "%E" else None
            if hdr and raw.rstrip().endswith("{"):
                name = hdr.group(1)
                self.comps[name] = []
                self.comp_params[name] = []
                # parameter declarations carry shapes (ordered)
                header = raw.split("(", 1)[1].rsplit("->", 1)[0]
                for pm in _PARAM_DECL_RE.finditer(header):
                    dt, dims = _first_shape(pm.group(2))
                    if dt:
                        self.shapes[pm.group(1)] = (dt, dims)
                    self.comp_params[name].append(pm.group(1))
                continue
            if name is None or not ln or ln == "}":
                continue
            self.comps[name].append(ln)
            dm = _DEF_RE.match(ln)
            if dm:
                dt, dims = _first_shape(dm.group(2))
                self.shapes[dm.group(1)] = (dt, dims)

        self.mult = self._multipliers()

    def _multipliers(self) -> Dict[str, int]:
        mult: Dict[str, int] = defaultdict(lambda: 1)
        for _ in range(4):
            for cname, lines in self.comps.items():
                outer = mult[cname]
                body_txt = "\n".join(lines)
                for m in _WHILE_RE.finditer(body_txt):
                    cond, wbody = m.group(1), m.group(2)
                    tc = self._trip_count(cond)
                    mult[wbody] = max(mult[wbody], outer * tc)
                    mult[cond] = max(mult[cond], outer * tc)
                for m in _CALLS_RE.finditer(body_txt):
                    callee = m.group(1)
                    if callee in self.comps:
                        mult[callee] = max(mult[callee], outer)
        return mult

    def _trip_count(self, cond_name: str) -> int:
        lines = self.comps.get(cond_name, [])
        consts = []
        for ln in lines:
            for c in _CONST_RE.findall(ln):
                v = int(c)
                if 1 <= v <= MAX_TRIP:
                    consts.append(v)
        return max(consts) if consts else 1

    # -- queries ----------------------------------------------------------

    def dot_flops(self) -> float:
        """2 * prod(result) * prod(contracted lhs dims), trip-weighted."""
        total = 0.0
        for cname, lines in self.comps.items():
            factor = self.mult[cname]
            for ln in lines:
                if " dot(" not in ln:
                    continue
                dm = _DEF_RE.match(ln)
                if not dm:
                    continue
                rhs = dm.group(2)
                _, out_dims = _first_shape(rhs)
                args = rhs.split(" dot(", 1)[1].split(")", 1)[0]
                ops = _OPERAND_RE.findall(args)
                cm = _CONTRACT_RE.search(rhs)
                if not ops or cm is None:
                    continue
                lhs_dt, lhs_dims = self.shapes.get(ops[0], ("", []))
                k = 1
                for d in cm.group(1).split(","):
                    if d != "" and int(d) < len(lhs_dims):
                        k *= lhs_dims[int(d)]
                out_n = 1
                for d in out_dims:
                    out_n *= d
                total += 2.0 * out_n * k * factor
        return total

    _TRIVIAL_OPS = {"parameter", "constant", "convert", "bitcast", "copy",
                    "transpose", "reshape", "broadcast", "tuple",
                    "get-tuple-element", "iota", ""}

    def _is_trivial_fusion(self, callee: str) -> bool:
        """Fusions that only convert/copy/reshape would not exist on TPU
        (the CPU backend materializes bf16<->f32 promotion); treat them as
        free - consumers still pay to read their output."""
        for ln in self.comps.get(callee, []):
            dm = _DEF_RE.match(ln)
            if not dm:
                continue
            if self._op_kind(dm.group(2)) not in self._TRIVIAL_OPS:
                return False
        return True

    def _dus_update_bytes(self, callee: str) -> int:
        """If `callee` contains dynamic-update-slice ops, the fusion's
        RESULT is aliased in place (XLA donates while-carried buffers):
        actual HBM writes = the update slices, not the full buffer.
        Returns the summed update-operand bytes, or -1 if no dus."""
        total = -1
        for ln in self.comps.get(callee, []):
            if "dynamic-update-slice(" not in ln:
                continue
            args = ln.split("dynamic-update-slice(", 1)[1].split(")", 1)[0]
            ops = _OPERAND_RE.findall(args)
            if len(ops) >= 2:
                dt, dims = self.shapes.get(ops[1], ("", []))
                ub = _shape_nbytes(dt, dims)
                total = ub if total < 0 else total + ub
        return total

    def _sliced_read_bytes(self, callee: str, pos: int,
                           full_bytes: int) -> int:
        """If callee parameter `pos` is consumed via dynamic-slice/gather,
        the per-call HBM read is the SLICE size, not the full buffer
        (scan-stacked weights would otherwise be charged L x per step)."""
        params = self.comp_params.get(callee, [])
        if pos >= len(params):
            return full_bytes
        pname = params[pos]
        for ln in self.comps.get(callee, []):
            if ("dynamic-slice(" in ln or " gather(" in ln) and \
                    f"%{pname}" in ln.split("(", 1)[1]:
                dm = _DEF_RE.match(ln)
                if dm:
                    dt, dims = _first_shape(dm.group(2))
                    return _shape_nbytes(dt, dims)
        return full_bytes

    # Ops that fundamentally move HBM bytes (cannot be fused away).
    _ANCHOR_OPS = {"dot", "convolution", "scatter", "gather", "sort",
                   "dynamic-slice", "dynamic-update-slice", "reduce",
                   "reduce-window", "rng", "rng-bit-generator"}

    def _is_anchor_fusion(self, callee: str) -> bool:
        for ln in self.comps.get(callee, []):
            dm = _DEF_RE.match(ln)
            if dm and self._op_kind(dm.group(2)) in self._ANCHOR_OPS:
                return True
        return False

    def traffic_bytes(self) -> float:
        """HBM traffic under an IDEAL-FUSION model: only anchor ops (dots,
        convolutions, scatter/gather, sorts, reductions, collectives, and
        fusions containing one) move HBM bytes - each writes its result
        once and reads each distinct operand once; elementwise chains
        between anchors are assumed fully fused (as the TPU backend does;
        the CPU backend materializes them, which would inflate the memory
        term ~5-10x). Operands consumed only through dynamic-slice/gather
        inside a fusion are charged at slice size (else scan-stacked
        weights would be charged L x per step). Trip-weighted, per-device.
        Residual bias: CPU promotes bf16 math to f32 (~2x on activation
        buffers) - documented in EXPERIMENTS.md."""
        fused = set()
        for lines in self.comps.values():
            for ln in lines:
                for m in _CALLS_RE.finditer(ln):
                    fused.add(m.group(1))
        total = 0.0
        for cname, lines in self.comps.items():
            if cname in fused:
                continue
            factor = self.mult[cname]
            writes = 0.0
            reads: Dict[str, float] = {}
            for ln in lines:
                dm = _DEF_RE.match(ln)
                if not dm:
                    continue
                rhs = dm.group(2)
                opkind = self._op_kind(rhs)
                callee = None
                result_bytes = _all_shapes_bytes(rhs.split("(", 1)[0])
                if opkind == "fusion":
                    cm = _CALLS_RE.search(rhs)
                    callee = cm.group(1) if cm else None
                    if callee is None or not self._is_anchor_fusion(callee):
                        continue
                    # in-place dus: write = update slice, not full buffer
                    dus = self._dus_update_bytes(callee)
                    if dus >= 0:
                        writes += dus
                        continue  # carried buffer isn't re-read either
                elif opkind == "dynamic-update-slice":
                    args = rhs.split("(", 1)[1].split(")", 1)[0]
                    ops_ = _OPERAND_RE.findall(args)
                    if len(ops_) >= 2:
                        dt, dims = self.shapes.get(ops_[1], ("", []))
                        writes += _shape_nbytes(dt, dims)
                    continue
                elif opkind not in self._ANCHOR_OPS and not any(
                        opkind.startswith(c) for c in COLLECTIVES):
                    continue
                writes += result_bytes
                if opkind in ("dynamic-slice", "gather"):
                    # read ~= result size; big operand mostly untouched
                    writes += _all_shapes_bytes(rhs.split("(", 1)[0])
                    continue
                if "(" in rhs:
                    args = rhs.split("(", 1)[1].split(")", 1)[0]
                    for i, op in enumerate(_OPERAND_RE.findall(args)):
                        dt, dims = self.shapes.get(op, ("", []))
                        ob = _shape_nbytes(dt, dims)
                        if callee is not None and ob > 0:
                            ob = self._sliced_read_bytes(callee, i, ob)
                        if ob > 0:
                            prev = reads.get(op)
                            reads[op] = ob if prev is None else min(prev, ob)
            total += (writes + sum(reads.values())) * factor
        return total

    def collective_bytes(self) -> Tuple[int, Dict[str, int]]:
        """Wire-byte model per collective: result+operand sizes (a good
        proxy: ~2x tensor for ring all-reduce, ~tensor for gather/permute).
        -start ops are skipped; -done ops carry the result shape."""
        per_kind: Dict[str, int] = defaultdict(int)
        for cname, lines in self.comps.items():
            factor = self.mult[cname]
            for ln in lines:
                if "-start" in ln:
                    continue
                dm = _DEF_RE.match(ln)
                if not dm:
                    continue
                rhs = dm.group(2)
                opkind = self._op_kind(rhs)
                for kind in COLLECTIVES:
                    if opkind.startswith(kind):
                        nbytes = _all_shapes_bytes(rhs.split("(", 1)[0])
                        if "(" in rhs and not opkind.endswith("-done"):
                            args = rhs.split("(", 1)[1].split(")", 1)[0]
                            for op in _OPERAND_RE.findall(args):
                                dt, dims = self.shapes.get(op, ("", []))
                                nbytes += _shape_nbytes(dt, dims)
                        per_kind[kind] += nbytes * factor
                        break
        return sum(per_kind.values()), dict(per_kind)

    @staticmethod
    def _op_kind(rhs: str) -> str:
        """Op name from the rhs of '%x = type opname(...)'."""
        before_paren = rhs.split("(", 1)[0].strip()
        parts = before_paren.split()
        return parts[-1] if parts else ""


def dot_flops(hlo: str) -> float:
    return HloModule(hlo).dot_flops()


def traffic_bytes(hlo: str) -> float:
    return HloModule(hlo).traffic_bytes()


def collective_bytes(hlo: str) -> Tuple[int, Dict[str, int]]:
    return HloModule(hlo).collective_bytes()
