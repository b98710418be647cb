"""The per-row constraint program, and kernel K11 (expr_sweep) that runs it.

A `Recorder` is a working algebra with the interface that
`evaluator.sweep` and `lookup.logup_constraint_values` take (const, var,
public, first, last, transition, add, sub, mul, neg).  Its values are
nodes of an interned DAG over the base field: equal operations give one
node, and operations on constants fold.  All arithmetic is exact mod p, so
the values of a program do not depend on the order it computes them in.

`Recorder.compile` turns the DAG into a flat `Program`: it schedules the
nodes depth first from the anchors and outputs in the order they were
given, reloads a leaf (constant, trace cell, public, selector, α power) at
every use instead of keeping it live, and assigns registers by liveness.
Each instruction is four int32 words (op, dst, a, b):

  CONST dst k            r[dst] = consts[k]
  VAR   dst col 2·src+o  r[dst] = source src, column col, this row (o = 0)
                         or the next one (o = 1)
  PUB   dst i            r[dst] = pubs[i]
  SEL   dst s            r[dst] = selector s (first, last, transition,
                         inv_vanishing) at this row
  APOW  dst k            r[dst] = apows[k]: coordinate d of α^j at d·K + j
  ADD / SUB / MUL dst a b,  NEG dst a
  OUT   slot a plane     out[plane·plane_stride + row·row_stride + slot] = r[a]

The callers record three programs per circuit and cache them on the System
(`System.cached_program`): the quotient composition (prover.py), the lookup
values of the witness (system.py) and the stage-2 slot messages
(lookup.py).

K11 (csrc/expr_sweep.cu, `expr_sweep` below) runs a program with one thread
per row; `expr_sweep_plain` interprets the same program over whole columns
with the field's plain ops, and is what a CPU tensor takes.  Rows may be
stored bit-reversed: with `brev_log` set, position t holds natural row
bitrev(t) and the next row of that is natural row bitrev(t) + step.
"""

from __future__ import annotations

import ctypes
import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import kernels
from .utils import bit_reverse_indices, to_device

CONST, VAR, PUB, SEL, APOW, ADD, SUB, MUL, NEG, OUT = range(10)
SELECTORS = ("first", "last", "transition", "inv_vanishing")
REGISTER_FILES = (16, 32, 64, 128)  # the register-file sizes csrc/expr_sweep.cu instantiates
MAX_SOURCES = 4
_LEAVES = frozenset(("c", "v", "p", "s", "a"))


class RegisterFileExceeded(ValueError):
    """A program needs more registers than K11's largest register file."""


@dataclass
class Program:
    """A flat base-field program (see the module docstring)."""

    name: str
    code: np.ndarray  # (n_instr, 4) int32
    consts: np.ndarray  # uint64
    n_regs: int
    sources: Tuple[int, ...]  # the source ids its VAR instructions read
    _device: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = field(default_factory=dict, repr=False)

    def on(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(code, consts) as int tensors on `device`, uploaded once."""
        key = str(torch.device(device))
        if key not in self._device:
            consts = self.consts if len(self.consts) else np.zeros(1, np.uint64)
            self._device[key] = (to_device(self.code, device), to_device(consts.view(np.int64), device))
        return self._device[key]

    def check_registers(self) -> None:
        if self.n_regs > REGISTER_FILES[-1]:
            raise RegisterFileExceeded(
                f"{self.name}: the program needs {self.n_regs} registers, K11's register file holds "
                f"{REGISTER_FILES[-1]}"
            )


class Recorder:
    """Records base-field operations as an interned DAG (see the module
    docstring).  `sources` limits the trace sources a VAR may read and
    `publics` whether publics exist: the witness's lookup values have no
    stage-2 trace and no publics."""

    def __init__(self, p: int, sources: Sequence[int] = (0, 1, 2), publics: bool = True):
        self.p = p
        self.nodes: List[tuple] = []
        self._index: Dict[tuple, int] = {}
        self._sources = frozenset(sources)
        self._publics = publics
        self._roots: List[Tuple[int, Optional[Tuple[int, int]]]] = []  # (node, (plane, slot) or None)

    def _push(self, key: tuple) -> int:
        idx = self._index.get(key)
        if idx is None:
            idx = self._index[key] = len(self.nodes)
            self.nodes.append(key)
        return idx

    def _const_of(self, i: int) -> Optional[int]:
        op = self.nodes[i]
        return op[1] if op[0] == "c" else None

    # -- leaves -----------------------------------------------------------
    def const(self, v: int) -> int:
        return self._push(("c", v % self.p))

    def var(self, source: int, column: int, offset: int) -> int:
        if source not in self._sources:
            raise ValueError(f"trace source {source} is not available to this program")
        return self._push(("v", source, column, offset))

    def public(self, index: int) -> int:
        if not self._publics:
            raise ValueError("publics are not available during witness generation")
        return self._push(("p", index))

    def selector(self, name: str) -> int:
        return self._push(("s", SELECTORS.index(name)))

    def first(self) -> int:
        return self.selector("first")

    def last(self) -> int:
        return self.selector("last")

    def transition(self) -> int:
        return self.selector("transition")

    def apow(self, k: int) -> int:
        return self._push(("a", k))

    # -- operations (constants fold) ----------------------------------------
    def add(self, a: int, b: int) -> int:
        ca, cb = self._const_of(a), self._const_of(b)
        if ca is not None and cb is not None:
            return self.const(ca + cb)
        if ca == 0:
            return b
        if cb == 0:
            return a
        return self._push(("add",) + tuple(sorted((a, b))))

    def sub(self, a: int, b: int) -> int:
        ca, cb = self._const_of(a), self._const_of(b)
        if ca is not None and cb is not None:
            return self.const(ca - cb)
        if cb == 0:
            return a
        if ca == 0:
            return self.neg(b)
        return self._push(("sub", a, b))

    def mul(self, a: int, b: int) -> int:
        ca, cb = self._const_of(a), self._const_of(b)
        if ca is not None and cb is not None:
            return self.const(ca * cb)
        if ca == 0 or cb == 0:
            return self.const(0)
        if ca == 1:
            return b
        if cb == 1:
            return a
        return self._push(("mul",) + tuple(sorted((a, b))))

    def neg(self, a: int) -> int:
        ca = self._const_of(a)
        if ca is not None:
            return self.const(-ca)
        return self._push(("neg", a))

    # -- program shape --------------------------------------------------------
    def anchor(self, v: int) -> None:
        """Compute v at this point of the schedule (the depth-first walk
        takes anchors and outputs in the order they were given)."""
        self._roots.append((v, None))

    def out(self, v: int, plane: int, slot: int = 0) -> None:
        self._roots.append((v, (plane, slot)))

    def compile(self, name: str) -> Program:
        """Schedule, reload leaves at each use, assign registers."""
        nodes = self.nodes
        # seq entries: ("load", node) | ("op", node, operand ids) | ("out", id, plane, slot); the id of
        # the value an entry defines is its index in seq
        seq: List[tuple] = []
        id_of: Dict[int, int] = {}

        def emit(entry) -> int:
            seq.append(entry)
            return len(seq) - 1

        def value(i: int) -> int:
            """The id of node i's value, emitting its computation if needed."""
            if nodes[i][0] in _LEAVES:
                return emit(("load", i))
            stack = [i]
            while stack:
                x = stack[-1]
                if x in id_of:
                    stack.pop()
                    continue
                pending = [o for o in nodes[x][1:] if nodes[o][0] not in _LEAVES and o not in id_of]
                if pending:
                    stack.extend(reversed(pending))
                    continue
                stack.pop()
                operands = [id_of[o] if o in id_of else emit(("load", o)) for o in nodes[x][1:]]
                id_of[x] = emit(("op", x, operands))
            return id_of[i]

        for node, where in self._roots:
            v = value(node)
            if where is not None:
                emit(("out", v) + where)

        # liveness: the last entry that reads each ssa value
        last_use: Dict[int, int] = {}
        for k, e in enumerate(seq):
            for s in _reads(e):
                last_use[s] = k
        reg_of: Dict[int, int] = {}
        free: List[int] = []
        n_regs = 0
        consts: Dict[int, int] = {}
        code = []
        sources = set()
        for k, e in enumerate(seq):
            reads = _reads(e)
            regs_in = [reg_of[s] for s in reads]
            for s in set(reads):
                if last_use[s] == k:
                    heapq.heappush(free, reg_of.pop(s))
            if e[0] == "out":
                code.append((OUT, e[3], regs_in[0], e[2]))
                continue
            if free:
                r = heapq.heappop(free)
            else:
                r, n_regs = n_regs, n_regs + 1
            if k in last_use:
                reg_of[k] = r
            else:  # never read: the register is free again at once
                heapq.heappush(free, r)
            op = nodes[e[1]]
            kind = op[0]
            if kind == "c":
                code.append((CONST, r, consts.setdefault(op[1], len(consts)), 0))
            elif kind == "v":
                sources.add(op[1])
                code.append((VAR, r, op[2], 2 * op[1] + op[3]))
            elif kind == "p":
                code.append((PUB, r, op[1], 0))
            elif kind == "s":
                code.append((SEL, r, op[1], 0))
            elif kind == "a":
                code.append((APOW, r, op[1], 0))
            elif kind == "neg":
                code.append((NEG, r, regs_in[0], 0))
            else:
                code.append(({"add": ADD, "sub": SUB, "mul": MUL}[kind], r, regs_in[0], regs_in[1]))
        return Program(
            name=name,
            code=np.asarray(code, np.int32).reshape(-1, 4),
            consts=np.asarray(list(consts), np.uint64),
            n_regs=n_regs,
            sources=tuple(sorted(sources)),
        )


def _reads(entry: tuple) -> List[int]:
    if entry[0] == "op":
        return list(entry[2])
    if entry[0] == "out":
        return [entry[1]]
    return []


@dataclass
class Operands:
    """What one run of a program reads: trace sources by id ((w, N)
    matrices; a program reads the first `rows` entries of each row), the
    selector columns by SELECTORS index, the publics and the α-power table
    (flat, device resident)."""

    sources: Sequence[Optional[torch.Tensor]]
    rows: int
    step: int = 1
    brev_log: int = 0
    selectors: Sequence[Optional[torch.Tensor]] = ()
    pubs: Optional[torch.Tensor] = None
    apows: Optional[torch.Tensor] = None


def expr_sweep_plain(F, prog: Program, ops: Operands, out_shape, plane_stride: int, row_stride: int) -> torch.Tensor:
    """Plain version of K11: the program over whole columns with the field's
    plain ops (register r holds a (rows,) column or a broadcast scalar)."""
    prog.check_registers()
    rows = ops.rows
    dev = _first_operand(ops).device
    pos = torch.arange(rows, dtype=torch.int64, device=dev)
    if ops.brev_log:
        brev = torch.from_numpy(bit_reverse_indices(ops.brev_log)).to(dev)
        nxt = brev[(brev + ops.step) % rows]
    else:
        nxt = (pos + ops.step) % rows
    consts = torch.from_numpy(prog.consts.view(np.int64)).to(dev)
    pubs = None if ops.pubs is None else ops.pubs.reshape(-1)
    apows = None if ops.apows is None else ops.apows.reshape(-1)
    out = torch.empty(tuple(out_shape), dtype=torch.int64, device=dev).reshape(-1)
    binary = {ADD: F.add_plain, SUB: F.sub_plain, MUL: F.mul_plain}
    r: List[Optional[torch.Tensor]] = [None] * prog.n_regs
    for op, dst, a, b in prog.code.tolist():
        if op == CONST:
            r[dst] = consts[a]
        elif op == VAR:
            col = ops.sources[b >> 1][a]
            r[dst] = col[nxt] if b & 1 else col[:rows]
        elif op == PUB:
            r[dst] = pubs[a]
        elif op == SEL:
            r[dst] = ops.selectors[a][:rows]
        elif op == APOW:
            r[dst] = apows[a]
        elif op == NEG:
            r[dst] = F.neg_plain(r[a])
        elif op == OUT:
            out[b * plane_stride + dst + row_stride * pos] = r[a].expand(rows)
        else:
            r[dst] = binary[op](r[a], r[b])
    return out.reshape(tuple(out_shape))


def _first_operand(ops: Operands) -> torch.Tensor:
    for t in (*ops.sources, *ops.selectors, ops.pubs, ops.apows):
        if t is not None:
            return t
    raise ValueError("a program run needs at least one operand tensor")


def expr_sweep(F, prog: Program, ops: Operands, out_shape, plane_stride: int, row_stride: int) -> torch.Tensor:
    """Run `prog` over ops.rows rows into a new int64 tensor of `out_shape`
    (the program's OUT instructions must cover it).  K11 when the operands
    are CUDA tensors, the plain version when they are CPU tensors.  Raises
    RegisterFileExceeded for a program that needs more registers than the
    kernel holds, on either device."""
    prog.check_registers()
    first = _first_operand(ops)
    if not kernels.use_kernel(first):
        return expr_sweep_plain(F, prog, ops, out_shape, plane_stride, row_stride)
    if len(ops.sources) > MAX_SOURCES:
        raise ValueError(f"expr_sweep reads at most {MAX_SOURCES} sources")
    if ops.brev_log and ops.rows != 1 << ops.brev_log:
        raise ValueError("expr_sweep: bit-reversed rows must number 2^brev_log")
    src = list(ops.sources) + [None] * (MAX_SOURCES - len(ops.sources))
    for s in prog.sources:
        t = src[s]
        if t is None or t.dim() != 2 or t.shape[1] < ops.rows:
            raise ValueError(f"{prog.name}: source {s} must be a (w, >= {ops.rows}) matrix")
    sels = list(ops.selectors) + [None] * (len(SELECTORS) - len(ops.selectors))
    used = {int(s) for s in prog.code[prog.code[:, 0] == SEL, 2]}
    for s in used:
        if sels[s] is None or sels[s].numel() < ops.rows:
            raise ValueError(f"{prog.name}: selector {SELECTORS[s]} must have {ops.rows} rows")
    if ((prog.code[:, 0] == PUB).any() and ops.pubs is None) or ((prog.code[:, 0] == APOW).any() and ops.apows is None):
        raise ValueError(f"{prog.name}: the program reads publics or α powers that were not given")
    dev = first.device
    code, consts = prog.on(dev)
    operands = [t for t in (*src, *sels, ops.pubs, ops.apows) if t is not None]
    kernels.check_cuda(*operands)
    out = torch.empty(tuple(out_shape), dtype=torch.int64, device=dev)
    bases = (ctypes.c_void_p * MAX_SOURCES)(*[None if t is None else t.data_ptr() for t in src])
    strides = (ctypes.c_int64 * MAX_SOURCES)(*[0 if t is None else t.shape[1] for t in src])
    sel_ptrs = (ctypes.c_void_p * len(SELECTORS))(*[None if t is None else t.data_ptr() for t in sels])

    def ptr_or_null(t):
        return None if t is None else kernels.ptr(t)

    kernels.EXPR_SWEEP.launch(
        "expr_sweep", F.field_id, kernels.ptr(code), len(prog.code), prog.n_regs, kernels.ptr(consts),
        ctypes.cast(bases, ctypes.c_void_p), ctypes.cast(strides, ctypes.c_void_p), ops.rows, ops.step,
        ops.brev_log, ctypes.cast(sel_ptrs, ctypes.c_void_p), ptr_or_null(ops.pubs), ptr_or_null(ops.apows),
        kernels.ptr(out), plane_stride, row_stride,
    )
    return out
