"""Bitwise expression DAG used by the Ambit compiler and the engine API.

Expressions are hash-consed (CSE falls out of construction) and support
operator overloading:  (a & b) | ~c,  a ^ b,  maj(a, b, c).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

_INTERN: Dict[Tuple, "Expr"] = {}


class Expr:
    """Immutable, interned expression node."""

    op: str
    args: Tuple["Expr", ...]
    name: str  # for Var/Lit

    def __new__(cls, op: str, args: Tuple["Expr", ...] = (), name: str = ""):
        key = (op, tuple(id(a) for a in args), name)
        node = _INTERN.get(key)
        if node is None:
            node = object.__new__(cls)
            node.op = op
            node.args = args
            node.name = name
            _INTERN[key] = node
        return node

    # -- constructors --------------------------------------------------------

    @staticmethod
    def var(name: str) -> "Expr":
        return Expr("var", (), name)

    @staticmethod
    def lit(value: int) -> "Expr":
        return Expr("lit", (), "one" if value else "zero")

    # -- operators -----------------------------------------------------------

    def __and__(self, o: "Expr") -> "Expr":
        return _fold(Expr("and", (self, o)))

    def __or__(self, o: "Expr") -> "Expr":
        return _fold(Expr("or", (self, o)))

    def __xor__(self, o: "Expr") -> "Expr":
        return _fold(Expr("xor", (self, o)))

    def __invert__(self) -> "Expr":
        return _fold(Expr("not", (self,)))

    def __repr__(self):
        if self.op in ("var", "lit"):
            return self.name
        if self.op == "not":
            return f"~{self.args[0]!r}"
        return f"({self.op} " + " ".join(map(repr, self.args)) + ")"


def maj(a: Expr, b: Expr, c: Expr) -> Expr:
    return _fold(Expr("maj", (a, b, c)))


ZERO = Expr.lit(0)
ONE = Expr.lit(1)


def _fold(e: Expr) -> Expr:
    """Constant folding + double-negation elimination + fused-negation
    strength reduction (and->nand etc. happens in the compiler; here we only
    simplify algebraically)."""
    a = e.args
    if e.op == "not":
        (x,) = a
        if x.op == "not":
            return x.args[0]
        if x is ZERO:
            return ONE
        if x is ONE:
            return ZERO
        return e
    if e.op == "and":
        x, y = a
        if x is y:
            return x
        if ZERO in a:
            return ZERO
        if x is ONE:
            return y
        if y is ONE:
            return x
        return e
    if e.op == "or":
        x, y = a
        if x is y:
            return x
        if ONE in a:
            return ONE
        if x is ZERO:
            return y
        if y is ZERO:
            return x
        return e
    if e.op == "xor":
        x, y = a
        if x is y:
            return ZERO
        if x is ZERO:
            return y
        if y is ZERO:
            return x
        if x is ONE:
            return ~y
        if y is ONE:
            return ~x
        return e
    if e.op == "maj":
        x, y, c = a
        if c is ZERO:
            return x & y
        if c is ONE:
            return x | y
        if x is y:
            return x
        return e
    return e


def eval_expr(e: Expr, env: Dict[str, np.ndarray]) -> np.ndarray:
    """Pure-numpy oracle over packed uint64/uint32 arrays."""
    if e.op == "var":
        return env[e.name]
    if e.op == "lit":
        some = next(iter(env.values()))
        zero = some ^ some  # dtype-generic, works for numpy and traced jax
        return ~zero if e.name == "one" else zero
    vals = [eval_expr(x, env) for x in e.args]
    if e.op == "not":
        return ~vals[0]
    if e.op == "and":
        return vals[0] & vals[1]
    if e.op == "or":
        return vals[0] | vals[1]
    if e.op == "xor":
        return vals[0] ^ vals[1]
    if e.op == "maj":
        x, y, z = vals
        return (x & y) | (y & z) | (z & x)
    raise KeyError(e.op)


def topo_order(root: Expr):
    """Post-order DAG traversal (each node once)."""
    seen, out = set(), []

    def visit(n: Expr):
        if id(n) in seen:
            return
        seen.add(id(n))
        for x in n.args:
            visit(x)
        out.append(n)

    visit(root)
    return out


def consumer_counts(root: Expr) -> Dict[int, int]:
    counts: Dict[int, int] = {}
    for n in topo_order(root):
        for x in n.args:
            counts[id(x)] = counts.get(id(x), 0) + 1
    counts.setdefault(id(root), 0)
    counts[id(root)] += 1  # the output itself is consumed
    return counts
