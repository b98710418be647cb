"""Graph evaluation: one dense forward sweep, generic over the working
algebra (the counterpart of multistark_tpu/evaluator.py).

The port sweeps with one algebra, `program.Recorder`, which turns the
graph into a flat per-row program for kernel K11 (the JAX package's
`DeviceAlgebra` made one whole-column op per node instead).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

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
