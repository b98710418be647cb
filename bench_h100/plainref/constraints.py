"""A circuit's constraints as the verifier needs them: their order and
degrees, and their values at the out-of-domain point ζ.

The values come from a plain recursive evaluation of the circuit author's
expression trees (`evaluate`), with no compiled node vector.  The order and
the degrees are part of the protocol: the transcript observes the
constraint count and the largest degree, and the α-fold takes the
constraints in the order of the upstream's hash-consed constraint graph
(src/graph.rs:120-211): lookups first, each tree walked left to right,
identical subtrees (up to operand order of sums and products, with
constants folded) sharing the position they first took; constant roots
dropped, identical roots kept once, roots sorted by position.  `order`
states that rule by itself.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

from .expr import Add, Const, Expr, IsFirstRow, IsLastRow, IsTransition, Lookup, Mul, Neg, Public, Source, Sub, Var


class ConstraintOrder:
    """The roots of a circuit's base constraints in fold order, one
    expression for each, and the degrees the transcript observes."""

    def __init__(self, roots: List[Expr], root_degrees: List[int], lookup_degrees: List[Tuple[int, int]]):
        self.roots = roots
        self.root_degrees = root_degrees
        self.lookup_degrees = lookup_degrees  # (multiplicity degree, largest argument degree) per lookup

    @property
    def max_constraint_degree(self) -> int:
        return max(self.root_degrees, default=0)


def order(p: int, constraints: Sequence[Expr], lookups: Sequence[Lookup]) -> ConstraintOrder:
    keys: Dict[tuple, int] = {}  # structural key -> position of first appearance
    degree: List[int] = []
    const: Dict[int, int] = {}  # position -> value, for constant positions

    def at(key: tuple, deg: int) -> int:
        if key not in keys:
            keys[key] = len(degree)
            degree.append(deg)
            if key[0] == "c":
                const[keys[key]] = key[1]
        return keys[key]

    def num(v: int) -> int:
        return at(("c", v % p), 0)

    def walk(e: Expr) -> int:
        if isinstance(e, Const):
            return num(e.value)
        if isinstance(e, Var):
            if e.source == Source.STAGE2:
                raise ValueError("a stage-2 column in a base constraint")
            return at(("v", e.source.value, e.column, e.offset.value), 1)
        if isinstance(e, Public):
            return at(("p", e.index), 0)
        if isinstance(e, IsFirstRow):
            return at(("first",), 1)
        if isinstance(e, IsLastRow):
            return at(("last",), 1)
        if isinstance(e, IsTransition):
            return at(("trans",), 0)
        if isinstance(e, Neg):
            a = walk(e.arg)
            return num(-const[a]) if a in const else at(("neg", a), degree[a])
        a, b = walk(e.lhs), walk(e.rhs)
        ca, cb = const.get(a), const.get(b)
        if isinstance(e, Add):
            if ca is not None and cb is not None:
                return num(ca + cb)
            if ca == 0 or cb == 0:
                return b if ca == 0 else a
            return at(("add", min(a, b), max(a, b)), max(degree[a], degree[b]))
        if isinstance(e, Sub):
            if ca is not None and cb is not None:
                return num(ca - cb)
            if cb == 0:
                return a
            return num(0) if a == b else at(("sub", a, b), max(degree[a], degree[b]))
        if isinstance(e, Mul):
            if ca is not None and cb is not None:
                return num(ca * cb)
            if ca == 0 or cb == 0:
                return num(0)
            if ca == 1 or cb == 1:
                return b if ca == 1 else a
            return at(("mul", min(a, b), max(a, b)), degree[a] + degree[b])
        raise TypeError(type(e))

    lookup_degrees = []
    for lk in lookups:
        m = walk(lk.multiplicity)
        lookup_degrees.append((degree[m], max((degree[walk(x)] for x in lk.args), default=0)))
    first: Dict[int, Expr] = {}
    for c in constraints:
        r = walk(c)
        if r in const:
            if const[r] != 0:
                raise ValueError(f"an unsatisfiable constant constraint == {const[r]}")
            continue
        first.setdefault(r, c)
    ranks = sorted(first)
    return ConstraintOrder([first[r] for r in ranks], [degree[r] for r in ranks], lookup_degrees)


def evaluate(e: Expr, he, leaf: Callable, publics: Sequence, selectors, memo: dict) -> Tuple[int, ...]:
    """The value of `e` in the extension field: trace cells from
    leaf(source, column, offset), publics and selectors as given; subtrees
    the author shared are evaluated once (`memo`, by identity)."""
    k = id(e)
    if k in memo:
        return memo[k]
    if isinstance(e, Const):
        v = he.from_base(e.value % he.base.p)
    elif isinstance(e, Var):
        v = leaf(e.source, e.column, e.offset.value)
    elif isinstance(e, Public):
        v = publics[e.index]
    elif isinstance(e, IsFirstRow):
        v = selectors.is_first_row
    elif isinstance(e, IsLastRow):
        v = selectors.is_last_row
    elif isinstance(e, IsTransition):
        v = selectors.is_transition
    elif isinstance(e, Neg):
        v = he.neg(evaluate(e.arg, he, leaf, publics, selectors, memo))
    else:
        a = evaluate(e.lhs, he, leaf, publics, selectors, memo)
        b = evaluate(e.rhs, he, leaf, publics, selectors, memo)
        v = he.add(a, b) if isinstance(e, Add) else he.sub(a, b) if isinstance(e, Sub) else he.mul(a, b)
    memo[k] = v
    return v
