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

K11 is one compiled kernel per program.  `program_body` turns the program
into straight-line code: each value a `const uint64_t` (SSA: a register's
every definition gets a name of its own), constants as literals, each
distinct leaf loaded once.  `cuda_source` puts the body into the
hand-written template csrc/expr_sweep.cu (the row loop: sources and
strides, selectors, bit-reversed rows, the next-row wrap, the output
staging); `build` compiles every program it is given that is not built yet
with nvcc for sm_90a into build/torch_kernels/programs/expr_<key>.so, all
at once, under the build lock (native.build_lock), and `expr_sweep` loads
and launches it.  The key is a hash of the generated source, the field
headers and the nvcc flags, so an unchanged program is built once per
checkout; deleting build/torch_kernels/programs/ (or `build(...,
force=True)`) forces a rebuild.  A failed build raises: nothing falls back.
`host_source` puts the same body into csrc/expr_sweep_host.c, which the CPU
tests build with `cc`.  `expr_sweep_plain` interprets the program over
whole columns with the field's plain ops, and is what a CPU tensor takes.
Rows may be stored bit-reversed: with `brev_log` set, position t holds
natural row bitrev(t) and the next row of that is natural row bitrev(t) +
step.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import heapq
import itertools
import os
import subprocess
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import kernels
from .native import build_lock
from .utils import bit_reverse_indices

CONST, VAR, PUB, SEL, APOW, ADD, SUB, MUL, NEG, OUT = range(10)
SELECTORS = ("first", "last", "transition", "inv_vanishing")
# the largest live set a program may have (the register file of the
# interpreting kernel the compiled ones replaced); the compiled kernels have
# no such limit of their own
REGISTER_FILES = (16, 32, 64, 128)
MAX_SOURCES = 4
TEMPLATE = kernels.PROGRAM_TEMPLATE
HOST_TEMPLATE = os.path.join(kernels.CSRC_DIR, "expr_sweep_host.c")
HEADERS = ("field.cuh", "goldilocks.cuh", "babybear.cuh")
PROGRAM_DIR = os.path.join(kernels.BUILD_DIR, "programs")
FIELD_TRAITS = ("Goldilocks", "BabyBear")  # by FieldOps.field_id
STAGE_BYTES = 40960  # shared memory a block may stage its outputs in
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
    _sources: Dict[int, Tuple[str, str]] = field(default_factory=dict, repr=False)  # field id -> (key, .cu)

    def cuda_source(self, field_id: int) -> Tuple[str, str]:
        """(key, the kernel's CUDA source) over field `field_id`."""
        if field_id not in self._sources:
            self._sources[field_id] = cuda_source(self, field_id)
        return self._sources[field_id]

    @functools.cached_property
    def columns_read(self) -> int:
        """The trace columns and selectors it reads (a column read at this
        row and the next counts once)."""
        code = self.code
        cols = {(int(b) >> 1, int(a)) for a, b in code[code[:, 0] == VAR][:, 2:4].tolist()}
        return len(cols) + len(self.reads[0])

    @functools.cached_property
    def reads(self) -> Tuple[frozenset, bool, bool]:
        """(the selectors it reads, whether it reads publics, α powers)."""
        ops = self.code[:, 0]
        return (frozenset(int(s) for s in self.code[ops == SEL, 2]), bool((ops == PUB).any()),
                bool((ops == APOW).any()))

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


# -- the compiled kernels ------------------------------------------------------

def program_body(prog: Program, indent: str = "      ") -> str:
    """The program as straight-line code over the templates' macros: each
    value a `const uint64_t` of its own, constants as literals, each distinct
    leaf loaded once (at its first use)."""
    lines = [f"{indent}// {prog.name.replace(chr(10), ' ')}: {len(prog.code)} instructions"]
    reg: Dict[int, str] = {}  # register -> the name of the value it holds
    leaves: Dict[tuple, str] = {}
    names = itertools.count()

    def define(expr: str) -> str:
        name = f"v{next(names)}"
        lines.append(f"{indent}const uint64_t {name} = {expr};")
        return name

    def leaf(key: tuple, expr: str) -> str:
        if key not in leaves:
            leaves[key] = define(expr)
        return leaves[key]

    for op, dst, a, b in prog.code.tolist():
        if op == CONST:
            reg[dst] = f"{int(prog.consts[a]):#x}ull"
        elif op == VAR:
            reg[dst] = leaf(("v", a, b), f"VAR({b >> 1}, {a}, {b & 1})")
        elif op == PUB:
            reg[dst] = leaf(("p", a), f"PUB({a})")
        elif op == SEL:
            reg[dst] = leaf(("s", a), f"SEL({a})")
        elif op == APOW:
            reg[dst] = leaf(("a", a), f"APOW({a})")
        elif op == NEG:
            reg[dst] = define(f"NEG({reg[a]})")
        elif op == OUT:
            lines.append(f"{indent}OUT({b}, {dst}, {reg[a]});")
        else:
            reg[dst] = define(f"{('ADD', 'SUB', 'MUL')[op - ADD]}({reg[a]}, {reg[b]})")
    return "\n".join(lines)


def staging(prog: Program) -> Tuple[int, int, int]:
    """(threads per block, slots staged per row, planes) of the program's
    kernel: a program with several slots per row stages its outputs in
    shared memory (at most STAGE_BYTES, so fewer threads for wide rows);
    one with a slot per row, or rows too wide, stores them directly."""
    outs = prog.code[prog.code[:, 0] == OUT]
    slots = int(outs[:, 1].max()) + 1 if len(outs) else 1
    planes = int(outs[:, 3].max()) + 1 if len(outs) else 1
    threads = 128
    if slots == 1:
        return threads, 0, planes
    while threads > 32 and 8 * planes * slots * threads > STAGE_BYTES:
        threads //= 2
    return (threads, slots, planes) if 8 * planes * slots * threads <= STAGE_BYTES else (128, 0, planes)


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def cuda_source(prog: Program, field_id: int) -> Tuple[str, str]:
    """(key, CUDA source) of the program's kernel over field `field_id`: the
    template with the body filled in; the key hashes that source, the field
    headers and the nvcc flags, and names the kernel
    (expr_sweep_kernel_<key>) and its C entry (expr_sweep_<key>)."""
    threads, slots, planes = staging(prog)
    text = (_read(TEMPLATE).replace("@THREADS@", str(threads)).replace("@SLOTS@", str(slots))
            .replace("@PLANES@", str(planes)).replace("@FIELD@", FIELD_TRAITS[field_id])
            .replace("@BODY@", program_body(prog)))
    h = hashlib.sha256(text.encode())
    for name in HEADERS:
        h.update(_read(os.path.join(kernels.CSRC_DIR, name)).encode())
    h.update(" ".join(kernels.NVCC_FLAGS).encode())
    key = h.hexdigest()[:20]
    return key, text.replace("@KEY@", key)


def host_source(prog: Program, field_id: int) -> str:
    """The program's body in the host C template (csrc/expr_sweep_host.c):
    the same generated code, for the CPU tests."""
    return (_read(HOST_TEMPLATE).replace("@FIELD_ID@", str(field_id))
            .replace("@BODY@", program_body(prog, indent="    ")))


_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
ENTRY_ARGS = [_vp, _vp, _i64, _i64, _i32, _vp, _vp, _vp, _vp, _i64, _i64]  # the C entry's, before the stream
_LOADED: Dict[str, Tuple[ctypes.CDLL, str, int]] = {}  # key -> (library, C entry, slots staged per row)


def _so(key: str) -> str:
    return os.path.join(PROGRAM_DIR, f"expr_{key}.so")


def build(F, progs: Sequence[Program], force: bool = False) -> Dict[str, float]:
    """Build the kernels of `progs` over field F that are not built yet (all
    of them with force): one nvcc per program, all started together, under
    the build lock; each writes its library through a temporary name and
    its `-Xptxas -v` report to expr_<key>.log beside it.  Returns {program
    name: seconds from the start to its nvcc's end}.  Raises
    CalledProcessError with nvcc's output if a build fails."""
    jobs = {}
    for prog in progs:
        key, text = prog.cuda_source(F.field_id)
        jobs.setdefault(key, (prog.name, text))
    os.makedirs(PROGRAM_DIR, exist_ok=True)
    seconds: Dict[str, float] = {}
    with build_lock(kernels.BUILD_DIR):
        todo = {k: v for k, v in jobs.items() if force or not os.path.exists(_so(k))}
        t0 = time.perf_counter()
        procs = []
        for key, (name, text) in todo.items():
            cu, tmp = os.path.join(PROGRAM_DIR, f"expr_{key}.cu"), f"{_so(key)}.{os.getpid()}.tmp"
            with open(f"{cu}.{os.getpid()}.tmp", "w") as f:
                f.write(text)
            os.replace(f"{cu}.{os.getpid()}.tmp", cu)
            cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-I", kernels.CSRC_DIR, "-shared",
                   "-o", tmp, cu]
            procs.append((key, name, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                                           text=True)))
        try:
            for key, name, tmp, proc in procs:
                out, err = proc.communicate(timeout=900)
                if proc.returncode != 0:
                    raise subprocess.CalledProcessError(proc.returncode, proc.args, output=out, stderr=err)
                seconds[name] = time.perf_counter() - t0
                with open(f"{_so(key)[:-3]}.log", "w") as f:
                    f.write(out + err)
                os.replace(tmp, _so(key))
        finally:
            for _, _, tmp, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if os.path.exists(tmp):
                    os.remove(tmp)
    return seconds


def ptxas_report(F, prog: Program) -> str:
    """The `-Xptxas -v` lines of the program's last build (registers, spills)."""
    key, _ = prog.cuda_source(F.field_id)
    path = f"{_so(key)[:-3]}.log"
    return _read(path).strip() if os.path.exists(path) else ""


def _kernel(F, prog: Program) -> Tuple[ctypes.CDLL, str, int]:
    """(the loaded library of the program's kernel, its C entry, the slots
    it stages per row), built first if needed."""
    key, _ = prog.cuda_source(F.field_id)
    if key not in _LOADED:
        if not os.path.exists(_so(key)):
            build(F, [prog])
        with build_lock(kernels.BUILD_DIR):
            lib = ctypes.CDLL(_so(key))
        fn = getattr(lib, f"expr_sweep_{key}")
        fn.argtypes = ENTRY_ARGS + [_vp]
        fn.restype = ctypes.c_int
        _LOADED[key] = (lib, f"expr_sweep_{key}", staging(prog)[1])
    return _LOADED[key]


def expr_sweep(F, prog: Program, ops: Operands, out_shape, plane_stride: int, row_stride: int) -> torch.Tensor:
    """Run `prog` over ops.rows rows into a new int64 tensor of `out_shape`
    (the program's OUT instructions must cover it).  The program's compiled
    K11 kernel when the operands are CUDA tensors (built at first use), the
    plain version when they are CPU tensors.  Raises RegisterFileExceeded
    for a program whose live set exceeds REGISTER_FILES, on either device."""
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
    used, reads_pubs, reads_apows = prog.reads
    for s in used:
        if sels[s] is None or sels[s].numel() < ops.rows:
            raise ValueError(f"{prog.name}: selector {SELECTORS[s]} must have {ops.rows} rows")
    if (reads_pubs and ops.pubs is None) or (reads_apows and ops.apows is None):
        raise ValueError(f"{prog.name}: the program reads publics or α powers that were not given")
    lib, entry, slots = _kernel(F, prog)
    if slots and row_stride != slots:
        raise ValueError(f"{prog.name}: its {slots} slots per row need a row stride of {slots}")
    operands = [t for t in (*src, *sels, ops.pubs, ops.apows) if t is not None]
    kernels.check_cuda(*operands)
    out = torch.empty(tuple(out_shape), dtype=torch.int64, device=first.device)
    bases = (ctypes.c_void_p * MAX_SOURCES)(*[None if t is None else t.data_ptr() for t in src])
    strides = (ctypes.c_int64 * MAX_SOURCES)(*[0 if t is None else t.shape[1] for t in src])
    sel_ptrs = (ctypes.c_void_p * len(SELECTORS))(*[None if t is None else t.data_ptr() for t in sels])

    def ptr_or_null(t):
        return None if t is None else kernels.ptr(t)

    kernels.EXPR_SWEEP.launch(
        entry, ctypes.cast(bases, ctypes.c_void_p), ctypes.cast(strides, ctypes.c_void_p), ops.rows, ops.step,
        ops.brev_log, ctypes.cast(sel_ptrs, ctypes.c_void_p), ptr_or_null(ops.pubs), ptr_or_null(ops.apows),
        kernels.ptr(out), plane_stride, row_stride, lib=lib,
        cost=(8 * ops.rows * prog.columns_read + 8 * out.numel(), 0),
    )
    return out
