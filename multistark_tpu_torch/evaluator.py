"""Graph evaluation: one dense forward sweep, generic over the working
algebra (the counterpart of multistark_tpu/evaluator.py).

The prover sweeps with `program.Recorder`, which turns the graph into a
flat per-row program for kernel K11 (the JAX package's `DeviceAlgebra` made
one whole-column op per node instead); the verifier with `HostExtAlgebra`,
one scalar in the extension field per node at the out-of-domain point.
`eval_expr` evaluates an expression tree recursively on host ints, apart
from the graph (the tests' reference).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .expr import Add, Const, Expr, IsFirstRow, IsLastRow, IsTransition, Mul, Neg, Public, Sub, Var
from .graph import ConstraintGraph


def sweep(graph: ConstraintGraph, alg, limit: Optional[int] = None) -> list:
    """Dense forward sweep over nodes[:limit]."""
    buf = []
    for op in graph.nodes[:limit]:
        kind = op[0]
        if kind == "c":
            buf.append(alg.const(op[1]))
        elif kind == "v":
            buf.append(alg.var(op[1], op[2], op[3]))
        elif kind == "p":
            buf.append(alg.public(op[1]))
        elif kind == "first":
            buf.append(alg.first())
        elif kind == "last":
            buf.append(alg.last())
        elif kind == "trans":
            buf.append(alg.transition())
        elif kind == "add":
            buf.append(alg.add(buf[op[1]], buf[op[2]]))
        elif kind == "sub":
            buf.append(alg.sub(buf[op[1]], buf[op[2]]))
        elif kind == "mul":
            buf.append(alg.mul(buf[op[1]], buf[op[2]]))
        elif kind == "neg":
            buf.append(alg.neg(buf[op[1]]))
        else:
            raise ValueError(kind)
    return buf


def sweep_lookup_prefix(graph: ConstraintGraph, alg) -> list:
    """Partial evaluation of the lookup prefix."""
    return sweep(graph, alg, limit=graph.lookup_end)


def constraint_values(graph: ConstraintGraph, buf: list) -> list:
    return [buf[i] for i in graph.zeros]


def lookup_values(graph: ConstraintGraph, buf: list) -> List[Tuple[object, tuple]]:
    return [(buf[m], tuple(buf[a] for a in args)) for m, args in graph.lookups]


class HostExtAlgebra:
    """Scalar evaluation in the extension field at the out-of-domain point ζ
    (the verifier): publics are extension values, trace cells the opened
    values."""

    def __init__(self, he, var_provider, publics, selectors):
        self.he = he
        self._var = var_provider
        self._publics = publics
        self._sel = selectors

    def const(self, v: int):
        return self.he.from_base(v % self.he.base.p)

    def var(self, source, column, offset):
        return self._var(source, column, offset)

    def public(self, index):
        return self._publics[index]

    def first(self):
        return self._sel.is_first_row

    def last(self):
        return self._sel.is_last_row

    def transition(self):
        return self._sel.is_transition

    def add(self, a, b):
        return self.he.add(a, b)

    def sub(self, a, b):
        return self.he.sub(a, b)

    def mul(self, a, b):
        return self.he.mul(a, b)

    def neg(self, a):
        return self.he.neg(a)


# --- recursive reference evaluator (tests only; reference eval.rs:133-199) ---

def eval_expr(e: Expr, hf, var_fn, publics, selectors) -> int:
    """Direct recursive evaluation of an Expr tree on host ints, independent
    of the graph and its sweep.  var_fn(source, column, offset) gives a
    trace cell; selectors maps "first", "last" and "transition"."""

    def ev(x: Expr) -> int:
        return eval_expr(x, hf, var_fn, publics, selectors)

    if isinstance(e, Const):
        return e.value % hf.p
    if isinstance(e, Var):
        return var_fn(e.source.value, e.column, e.offset.value)
    if isinstance(e, Public):
        return publics[e.index]
    if isinstance(e, IsFirstRow):
        return selectors["first"]
    if isinstance(e, IsLastRow):
        return selectors["last"]
    if isinstance(e, IsTransition):
        return selectors["transition"]
    if isinstance(e, Add):
        return hf.add(ev(e.lhs), ev(e.rhs))
    if isinstance(e, Sub):
        return hf.sub(ev(e.lhs), ev(e.rhs))
    if isinstance(e, Mul):
        return hf.mul(ev(e.lhs), ev(e.rhs))
    if isinstance(e, Neg):
        return hf.neg(ev(e.arg))
    raise TypeError(type(e))
