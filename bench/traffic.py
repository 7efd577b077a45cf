"""The one traffic generator: reads a mix from ``traffic/<mix>.json``.

A mix is data. ``load`` says how queries are offered:

  * ``{"loop": "closed", "clients": C}`` - C clients, each a tenant with
    one query outstanding and no think time. The frontend keeps its own
    clock (arrivals are not stamped), so its window drains when it fills.
  * ``{"loop": "open", "rate_qps": R, "tenants": T, "tenant_zipf": s}`` -
    R queries a second as a Poisson process: ``round(R * seconds)``
    arrivals whose gaps are the exponential distribution's quantiles at
    (i + 0.5) / n, shuffled, each from a tenant drawn Zipf(s) over T
    (balanced counts, shuffled). Every seed offers the same gaps and
    tenant counts in another order. The frontend's clock is the wall
    clock (ns since the window opened).

``families`` are the query shapes, each with an integer ``share``:
every block of queries holds the families in exact proportion, shuffled.
A family draws its ``params`` per query (``{"uniform": [lo, hi]}``, both
ends included, or ``{"zipf": s, "n": N}``, a rank 0..N-1 with weight
(rank+1)^-s), each param's values in a block balanced to their expected
counts and shuffled, and resolves its ``terms`` from them. A query is the
conjunction of its terms; each term resolves to one element of the spec
or more:

  * ``{"bitmaps": "week{j}", "j": [lo, hi]}`` - one bitmap a j in
    lo..hi, each its own element ``("bitmap", name)``; with
    ``"join": "any"``, one element, the OR of those bitmaps;
    ``{"bitmaps": "male"}`` - one named bitmap;
  * ``{"column": "l_quantity", "lo": lo, "hi": hi}`` - lo <= value <= hi,
    the element ``("range", column, lo, hi)``;
  * ``{"column": "c_city", "in": [[lo, hi], ...]}`` - an IN-list: the OR
    of its ranges over the one column;
  * ``{"any": [[term, ...], ...]}`` - the OR of its branches, each branch
    the conjunction of its terms: ``("any", (branch, ...))``, each branch
    a tuple of elements;
  * ``{"not": term}`` - the negation of the term, ``("not", element)``
    (a term of several elements is negated as one branch of an ``any``).
    Only the deployment's rows or users count: bits past them never do.

``lo``/``hi`` are integer expressions over the params (``+ - * // %``,
parentheses, and ``days(y, m, d)``: days since the mix's ``date_base``).
A spec is the tuple of a query's elements: hashable and sortable, and a
query of ranges (or of bitmaps) alone is the tuple of its ranges (or
bitmaps) in the order of its terms, as before any other form existed.
A family's terms are checked once, when the mix is read
(``compile_term``): a term of no known form raises, naming it. ``leaves``
walks a spec's ranges and bitmaps; ``fold`` evaluates a spec from its
leaves, for a deployment's plan and for a reference's count alike.
"""

from __future__ import annotations

import ast
import datetime
import functools
import itertools
import json
import operator
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np

BLOCK = 960             # queries a block of exact family shares
SALT_QUERIES, SALT_ARRIVALS, SALT_TENANTS = 1, 2, 3


def rng_for(seed: int, salt: int) -> np.random.Generator:
    """The numpy stream ``salt`` of ``seed`` (any whole number)."""
    return np.random.default_rng(
        np.random.SeedSequence([seed % (1 << 64), salt]))


def zipf_weights(n: int, s: float) -> np.ndarray:
    """Probabilities of ranks 0..n-1, proportional to (rank+1)^-s."""
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
    return w / w.sum()


class _Eval(ast.NodeVisitor):
    """Integer arithmetic over named params, and nothing else."""

    OPS = {ast.Add: lambda a, b: a + b, ast.Sub: lambda a, b: a - b,
           ast.Mult: lambda a, b: a * b, ast.FloorDiv: lambda a, b: a // b,
           ast.Mod: lambda a, b: a % b}

    def __init__(self, env: Dict[str, int], date_base: datetime.date):
        self.env, self.date_base = env, date_base

    def visit_Expression(self, node):
        return self.visit(node.body)

    def visit_BinOp(self, node):
        op = self.OPS.get(type(node.op))
        if op is None:
            raise ValueError(f"operator {type(node.op).__name__} not allowed")
        return op(self.visit(node.left), self.visit(node.right))

    def visit_UnaryOp(self, node):
        if not isinstance(node.op, ast.USub):
            raise ValueError("only unary minus is allowed")
        return -self.visit(node.operand)

    def visit_Constant(self, node):
        if not isinstance(node.value, int) or isinstance(node.value, bool):
            raise ValueError(f"only integer constants, got {node.value!r}")
        return node.value

    def visit_Name(self, node):
        return int(self.env[node.id])

    def visit_Call(self, node):
        if not (isinstance(node.func, ast.Name) and node.func.id == "days"
                and len(node.args) == 3 and not node.keywords):
            raise ValueError("the only call is days(y, m, d)")
        y, m, d = (self.visit(a) for a in node.args)
        return (datetime.date(y, m, d) - self.date_base).days

    def generic_visit(self, node):
        raise ValueError(f"{type(node).__name__} not allowed in an "
                         "expression")


def evaluate(text, env: Dict[str, int], date_base: datetime.date) -> int:
    """The integer value of ``text`` (an int or an expression string)."""
    if isinstance(text, int):
        return text
    return int(_Eval(env, date_base).visit(ast.parse(text, mode="eval")))


def _support(dist: dict) -> List[int]:
    if "uniform" in dist:
        lo, hi = dist["uniform"]
        return list(range(int(lo), int(hi) + 1))
    if "zipf" in dist:
        return list(range(int(dist["n"])))
    raise ValueError(f"unknown distribution {dist}")


def _weights(dist: dict) -> np.ndarray:
    if "uniform" in dist:
        lo, hi = dist["uniform"]
        return np.full(int(hi) - int(lo) + 1, 1.0 / (int(hi) - int(lo) + 1))
    return zipf_weights(int(dist["n"]), float(dist["zipf"]))


def balanced(values, weights: np.ndarray, rng: np.random.Generator,
             size: int) -> np.ndarray:
    """``size`` draws holding each value as near its expected count as
    whole numbers allow (largest remainders), in a shuffled order: every
    seed draws the same multiset, in another order."""
    exact = np.asarray(weights, np.float64) * size
    counts = np.floor(exact).astype(np.int64)
    rest = size - int(counts.sum())
    if rest:
        order = np.lexsort((np.arange(len(exact)), -(exact - counts)))
        counts[order[:rest]] += 1
    out = np.repeat(np.asarray(values), counts)
    rng.shuffle(out)
    return out


def _draw(dist: dict, rng: np.random.Generator, size: int) -> np.ndarray:
    return balanced(_support(dist), _weights(dist), rng, size)


def _bad(term, why: str) -> ValueError:
    return ValueError(f"malformed term {term!r}: {why}")


def _pair(term, x) -> list:
    if not (isinstance(x, list) and len(x) == 2):
        raise _bad(term, f"{x!r} is not a [lo, hi] pair")
    return x


def _some(term, items, what: str) -> list:
    if not (isinstance(items, list) and items):
        raise _bad(term, f"{what} is a list of at least one")
    return items


_RANGE, _IN = {"column", "lo", "hi"}, {"column", "in"}
_BITMAPS = {"bitmaps", "j", "join"}


def compile_term(term) -> Callable:
    """One term of a family, its form checked once: a function of the
    param values and the date base to the term's spec elements. Raises,
    naming the term, on a term of no known form (and, when called, on an
    OR or a NOT of nothing)."""
    if not isinstance(term, dict):
        raise _bad(term, "a term is a JSON object")
    keys = term.keys()
    if keys == _RANGE:
        column, lo, hi = term["column"], term["lo"], term["hi"]
        return lambda env, base: [("range", column, evaluate(lo, env, base),
                                   evaluate(hi, env, base))]
    if "bitmaps" in keys:
        join = term.get("join", "all")
        if not keys <= _BITMAPS or ("join" in keys and "j" not in keys) \
                or join not in ("all", "any"):
            raise _bad(term, "a bitmaps term takes j, and join (all or "
                       "any) with j")
        name = term["bitmaps"]
        if "j" not in keys:
            return lambda env, base: [("bitmap", name)]
        lo, hi = _pair(term, term["j"])

        def bitmaps(env, base):
            out = [("bitmap", name.format(j=j)) for j in range(
                evaluate(lo, env, base), evaluate(hi, env, base) + 1)]
            if join == "all":
                return out
            if not out:
                raise _bad(term, "join any over no bitmap")
            return [("any", tuple((b,) for b in out))]
        return bitmaps
    if keys == _IN:
        column = term["column"]
        pairs = [_pair(term, r) for r in _some(term, term["in"], "in")]
        return lambda env, base: [("any", tuple(
            (("range", column, evaluate(lo, env, base),
              evaluate(hi, env, base)),) for lo, hi in pairs))]
    if keys == {"any"}:
        branches = [[compile_term(t) for t in _some(term, b, "a branch")]
                    for b in _some(term, term["any"], "any")]

        def any_(env, base):
            out = []
            for branch in branches:
                out.append(tuple(e for t in branch for e in t(env, base)))
                if not out[-1]:
                    raise _bad(term, "a branch has no element")
            return [("any", tuple(out))]
        return any_
    if keys == {"not"}:
        inner = compile_term(term["not"])

        def not_(env, base):
            out = inner(env, base)
            if not out:
                raise _bad(term, "not of no element")
            return [("not", out[0] if len(out) == 1
                     else ("any", (tuple(out),)))]
        return not_
    raise _bad(term, "no known form")


def leaves(spec) -> Iterator[tuple]:
    """Every ``range`` and ``bitmap`` element of ``spec``, nested or not,
    in order."""
    for e in spec:
        if e[0] == "any":
            for branch in e[1]:
                yield from leaves(branch)
        elif e[0] == "not":
            yield from leaves((e[1],))
        else:
            yield e


def fold(spec, leaf: Callable, invert: Callable = operator.invert):
    """``spec`` evaluated from its leaves: ``leaf(element)`` for each range
    or bitmap, ``&`` over a conjunction left to right, ``|`` over an
    ``any``'s branches, and ``invert`` for a ``not``."""
    def element(e):
        if e[0] == "any":
            return functools.reduce(operator.or_,
                                    (fold(b, leaf, invert) for b in e[1]))
        if e[0] == "not":
            return invert(element(e[1]))
        return leaf(e)
    return functools.reduce(operator.and_, (element(e) for e in spec))


class Family:
    def __init__(self, doc: dict, date_base: datetime.date):
        self.name = doc["name"]
        self.share = int(doc["share"])
        self.params = dict(doc.get("params", {}))
        self.terms = list(doc["terms"])
        self.date_base = date_base
        self._terms = [compile_term(t) for t in self.terms]

    def resolve(self, values: Dict[str, int]) -> tuple:
        """The spec of one query with these param values."""
        spec = []
        for term in self._terms:
            spec += term(values, self.date_base)
        return tuple(spec)

    def specs(self) -> List[tuple]:
        """Every spec the family can draw."""
        names = sorted(self.params)
        out = []
        for combo in itertools.product(*(_support(self.params[n])
                                         for n in names)):
            out.append(self.resolve(dict(zip(names, combo))))
        return out

    def draw(self, rng: np.random.Generator, size: int) -> List[tuple]:
        names = sorted(self.params)
        cols = {n: _draw(self.params[n], rng, size) for n in names}
        return [self.resolve({n: int(cols[n][i]) for n in names})
                for i in range(size)]


class Mix:
    """One traffic mix, loaded from its JSON document."""

    def __init__(self, doc: dict, name: str = ""):
        self.name = name
        self.load = dict(doc["load"])
        if self.load["loop"] not in ("closed", "open"):
            raise ValueError(f"load.loop is closed or open, got "
                             f"{self.load['loop']!r}")
        self.date_base = datetime.date.fromisoformat(
            doc.get("date_base", "1970-01-01"))
        self.families = [Family(f, self.date_base) for f in doc["families"]]
        self.sweep = doc.get("sweep")

    @staticmethod
    def read(path: Path) -> "Mix":
        return Mix(json.loads(Path(path).read_text()), Path(path).stem)

    @property
    def loop(self) -> str:
        return self.load["loop"]

    def specs(self) -> List[tuple]:
        """Every distinct spec of the mix, sorted."""
        return sorted({s for f in self.families for s in f.specs()})

    def _block(self, rng: np.random.Generator, size: int) -> List[tuple]:
        total = sum(f.share for f in self.families)
        counts = [size * f.share // total for f in self.families]
        for k in range(size - sum(counts)):          # remainder in order
            counts[k % len(counts)] += 1
        labels = np.repeat(np.arange(len(self.families)), counts)
        rng.shuffle(labels)
        drawn = [iter(f.draw(rng, c)) for f, c in zip(self.families, counts)]
        return [next(drawn[int(k)]) for k in labels]

    def queries(self, seed: int) -> Iterator[tuple]:
        """An endless stream of specs from ``seed``, in blocks of exact
        family shares."""
        rng = rng_for(seed, SALT_QUERIES)
        while True:
            yield from self._block(rng, BLOCK)

    def first(self, seed: int, n: int) -> List[tuple]:
        return list(itertools.islice(self.queries(seed), n))

    def arrivals(self, seed: int, seconds: float, rate_qps: float = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """The open loop's due times (ns from the window's start, sorted)
        and tenants (ints) for ``seconds`` at ``rate_qps`` (the mix's own
        rate unless given)."""
        rate = float(rate_qps if rate_qps is not None
                     else self.load["rate_qps"])
        n = max(1, int(round(rate * seconds)))
        gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate * 1e9
        rng_for(seed, SALT_ARRIVALS).shuffle(gaps)
        times = np.cumsum(gaps) - gaps[0] * 0.5
        n_ten = int(self.load["tenants"])
        tenants = balanced(np.arange(n_ten), zipf_weights(
            n_ten, float(self.load["tenant_zipf"])),
            rng_for(seed, SALT_TENANTS), n)
        return times.astype(np.int64), tenants

