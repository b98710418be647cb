"""Constraint compiler: expression trees -> interned, topologically ordered,
base-field-only node vector (reference src/graph.rs).

Hash-consing with commutative operand sorting means index equality =
structural equality; constants fold; extension constraints are expanded to D
base-coordinate roots (3-mul Karatsuba for D=2, reference src/graph.rs:458-473,
schoolbook otherwise).  Lookups are interned FIRST so they occupy a prefix of
the node vector, enabling partial evaluation for witness generation
(reference src/graph.rs:120-137).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .expr import (
    Add,
    Const,
    Expr,
    ExtAdd,
    ExtBase,
    ExtCoords,
    ExtExpr,
    ExtMul,
    ExtNeg,
    ExtSub,
    IsFirstRow,
    IsLastRow,
    IsTransition,
    Lookup,
    Mul,
    Neg,
    Public,
    Source,
    Sub,
    Var,
)
from .fields.host import ExtensionParams


class CompileError(Exception):
    """reference src/graph.rs:79-110."""

    def __init__(self, kind: str, detail: str = ""):
        self.kind = kind
        super().__init__(f"{kind}: {detail}" if detail else kind)


@dataclass
class ConstraintGraph:
    """Flat node vector.  Node encodings:
      ('c', value)                      constant (canonical)
      ('v', source, column, offset)     trace variable (two-row window)
      ('p', index)                      public value
      ('first',) ('last',) ('trans',)   row selectors
      ('add', i, j) ('sub', i, j) ('mul', i, j) ('neg', i)
    """

    p: int
    nodes: List[tuple]
    degrees: List[int]
    zeros: List[int]  # constraint roots (must evaluate to zero)
    lookups: List[Tuple[int, Tuple[int, ...]]]  # (multiplicity node, arg nodes)
    lookup_end: int  # nodes[:lookup_end] suffice for lookup evaluation

    @property
    def max_constraint_degree(self) -> int:
        return max((self.degrees[i] for i in self.zeros), default=0)

    def check_topological_order(self) -> None:
        for i, op in enumerate(self.nodes):
            for operand in _operands(op):
                assert operand < i, f"node {i} references later node {operand}"


def _operands(op: tuple) -> Tuple[int, ...]:
    kind = op[0]
    if kind in ("add", "sub", "mul"):
        return (op[1], op[2])
    if kind == "neg":
        return (op[1],)
    return ()


class Interner:
    def __init__(self, p: int, allow_stage2_base: bool = False):
        self.p = p
        self.nodes: List[tuple] = []
        self.degrees: List[int] = []
        self.index: Dict[tuple, int] = {}

    def _push(self, key: tuple, degree: int) -> int:
        idx = self.index.get(key)
        if idx is None:
            idx = len(self.nodes)
            self.nodes.append(key)
            self.degrees.append(degree)
            self.index[key] = idx
        return idx

    # -- leaves -----------------------------------------------------------
    def const(self, v: int) -> int:
        return self._push(("c", v % self.p), 0)

    def var(self, source: Source, col: int, offset) -> int:
        return self._push(("v", source.value, col, offset.value), 1)

    def public(self, i: int) -> int:
        return self._push(("p", i), 0)

    def first(self) -> int:
        return self._push(("first",), 1)

    def last(self) -> int:
        return self._push(("last",), 1)

    def transition(self) -> int:
        return self._push(("trans",), 0)

    # -- ops with folding -------------------------------------------------
    def _const_val(self, i: int) -> Optional[int]:
        op = self.nodes[i]
        return op[1] if op[0] == "c" else None

    def add(self, i: int, j: int) -> int:
        ci, cj = self._const_val(i), self._const_val(j)
        if ci is not None and cj is not None:
            return self.const(ci + cj)
        if ci == 0:
            return j
        if cj == 0:
            return i
        if i > j:
            i, j = j, i  # commutative normalization (reference graph.rs:273)
        return self._push(("add", i, j), max(self.degrees[i], self.degrees[j]))

    def sub(self, i: int, j: int) -> int:
        ci, cj = self._const_val(i), self._const_val(j)
        if ci is not None and cj is not None:
            return self.const(ci - cj)
        if cj == 0:
            return i
        if i == j:
            return self.const(0)
        return self._push(("sub", i, j), max(self.degrees[i], self.degrees[j]))

    def mul(self, i: int, j: int) -> int:
        ci, cj = self._const_val(i), self._const_val(j)
        if ci is not None and cj is not None:
            return self.const(ci * cj)
        if ci == 0 or cj == 0:
            return self.const(0)
        if ci == 1:
            return j
        if cj == 1:
            return i
        if i > j:
            i, j = j, i  # commutative normalization (reference graph.rs:312)
        return self._push(("mul", i, j), self.degrees[i] + self.degrees[j])

    def neg(self, i: int) -> int:
        ci = self._const_val(i)
        if ci is not None:
            return self.const(-ci)
        return self._push(("neg", i), self.degrees[i])

    # -- expression interning ---------------------------------------------
    def intern(self, e: Expr, allow_stage2: bool) -> int:
        if isinstance(e, Const):
            return self.const(e.value)
        if isinstance(e, Var):
            if e.source == Source.STAGE2 and not allow_stage2:
                raise CompileError(
                    "Stage2InBaseContext",
                    "stage-2 columns are extension slots; reference them via "
                    "stage2_ext coordinates (reference graph.rs:79-110)",
                )
            return self.var(e.source, e.column, e.offset)
        if isinstance(e, Public):
            return self.public(e.index)
        if isinstance(e, IsFirstRow):
            return self.first()
        if isinstance(e, IsLastRow):
            return self.last()
        if isinstance(e, IsTransition):
            return self.transition()
        if isinstance(e, Add):
            return self.add(self.intern(e.lhs, allow_stage2), self.intern(e.rhs, allow_stage2))
        if isinstance(e, Sub):
            return self.sub(self.intern(e.lhs, allow_stage2), self.intern(e.rhs, allow_stage2))
        if isinstance(e, Mul):
            return self.mul(self.intern(e.lhs, allow_stage2), self.intern(e.rhs, allow_stage2))
        if isinstance(e, Neg):
            return self.neg(self.intern(e.arg, allow_stage2))
        raise TypeError(type(e))

    def intern_ext(self, e: ExtExpr, params: ExtensionParams) -> Tuple[int, ...]:
        """Coordinate expansion (reference src/graph.rs:442-506)."""
        D, W = params.degree, params.w
        zero = self.const(0)
        if isinstance(e, ExtBase):
            return (self.intern(e.arg, allow_stage2=False),) + (zero,) * (D - 1)
        if isinstance(e, ExtCoords):
            assert len(e.coords) == D
            return tuple(self.intern(c, allow_stage2=True) for c in e.coords)
        if isinstance(e, ExtAdd):
            a = self.intern_ext(e.lhs, params)
            b = self.intern_ext(e.rhs, params)
            return tuple(self.add(x, y) for x, y in zip(a, b))
        if isinstance(e, ExtSub):
            a = self.intern_ext(e.lhs, params)
            b = self.intern_ext(e.rhs, params)
            return tuple(self.sub(x, y) for x, y in zip(a, b))
        if isinstance(e, ExtNeg):
            return tuple(self.neg(x) for x in self.intern_ext(e.arg, params))
        if isinstance(e, ExtMul):
            a = self.intern_ext(e.lhs, params)
            b = self.intern_ext(e.rhs, params)
            # scalar detection (reference graph.rs:442-446)
            if all(x == zero for x in a[1:]):
                return tuple(self.mul(a[0], y) for y in b)
            if all(y == zero for y in b[1:]):
                return tuple(self.mul(x, b[0]) for x in a)
            if D == 2 and params.karatsuba:
                # 3-mul Karatsuba (reference graph.rs:458-473)
                t0 = self.mul(a[0], b[0])
                t1 = self.mul(a[1], b[1])
                t2 = self.mul(self.add(a[0], a[1]), self.add(b[0], b[1]))
                c0 = self.add(t0, self.mul(self.const(W), t1))
                c1 = self.sub(t2, self.add(t0, t1))
                return (c0, c1)
            # schoolbook (reference graph.rs:474-506)
            out: List[Optional[int]] = [None] * D
            for i in range(D):
                for j in range(D):
                    t = self.mul(a[i], b[j])
                    k = i + j
                    if k >= D:
                        k -= D
                        t = self.mul(self.const(W), t)
                    out[k] = t if out[k] is None else self.add(out[k], t)
            return tuple(out)  # type: ignore[return-value]
        raise TypeError(type(e))


def compile_graph(
    p: int,
    constraints: Sequence[Expr],
    ext_constraints: Sequence[ExtExpr],
    lookups: Sequence[Lookup],
    ext_params: ExtensionParams,
) -> ConstraintGraph:
    """reference src/graph.rs:120-188."""
    it = Interner(p)

    # lookups first: they form a prefix for partial evaluation
    compiled_lookups = []
    for lk in lookups:
        mult = it.intern(lk.multiplicity, allow_stage2=False)
        args = tuple(it.intern(a, allow_stage2=False) for a in lk.args)
        compiled_lookups.append((mult, args))
    lookup_end = len(it.nodes)

    roots: List[int] = []
    for c in constraints:
        roots.append(it.intern(c, allow_stage2=False))
    for ec in ext_constraints:
        if ec.is_purely_base():
            raise CompileError(
                "PurelyBaseExtConstraint",
                "author base-field constraints as base constraints "
                "(reference expr.rs:287-301)",
            )
        roots.extend(it.intern_ext(ec, ext_params))

    # canonicalize roots (reference graph.rs:138-158, 193-211)
    zeros: List[int] = []
    for r in roots:
        op = it.nodes[r]
        if op[0] == "c":
            if op[1] != 0:
                raise CompileError("UnsatisfiableConstant", f"constraint == {op[1]}")
            continue  # trivially satisfied
        zeros.append(r)
    zeros = sorted(set(zeros))

    g = ConstraintGraph(
        p=p,
        nodes=it.nodes,
        degrees=it.degrees,
        zeros=zeros,
        lookups=compiled_lookups,
        lookup_end=lookup_end,
    )
    g.check_topological_order()
    return g
