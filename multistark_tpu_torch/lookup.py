"""logUp multiset-channel lookup argument over tensors (the counterpart of
multistark_tpu/lookup.py; layout and chained-accumulator scheme as
documented there).

Layout contracts:
  - publics per circuit = 4 extension values flattened:
    (beta, gamma, acc_initial, acc_final)  =>  num_publics = 4·D
  - stage-2 width = max(L, 1)·D base columns: one partial accumulator per
    lookup slot (or a single pass-through slot when the circuit has none)

Chained accumulators: with m_{r,j} = beta + fingerprint(gamma, args_{r,j}),

  step j < L-1 :  m_{r,j}·(acc_{r,j+1} - acc_{r,j}) - mult_{r,j} = 0
  wrap (j=L-1) :  m_{r,L-1}·(acc_{r+1,0} - acc_{r,L-1} - is_last_row·Δ)
                      - mult_{r,L-1} = 0

The stage-2 traces are built on the device: the slot messages by each
circuit's stage-2 program on kernel K11 (program.py), then the whole chain
(inverses, terms, prefix sum, accumulator, column layout) in one launch of
K4's stage-2 chain (`utils.stage2_chain`).  The claims accumulator of both
transcripts and both fields runs on the device with β and γ device
scalars, in one launch of kernel K9 (csrc/claims_fp.cu, `claims_acc`
below) from the claims as uploaded: the messages and the sum of their
inverses.

`synthesize_lookups` (the constraints as compilable ExtExprs) and the NumPy
`stage_2_traces` are the executable specs the tests hold the direct
evaluation and the device stage 2 against; no prover calls them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import expr as ex
from . import kernels
from .fields.device import ExtOps, FieldOps
from .fields.host import ExtensionParams, HostExtField, HostField
from .graph import ConstraintGraph
from .program import Operands, Program, Recorder, expr_sweep
from .utils import ext_pack_device, inv_sum_plain, scratch, stage2_chain

ExtVal = Tuple[int, ...]


# --- layout (reference src/lookup.rs:78-99) ----------------------------------

def num_publics(degree: int) -> int:
    return 4 * degree


def stage2_width(num_lookups: int, degree: int) -> int:
    return max(num_lookups, 1) * degree


def logup_constraint_count(num_lookups: int, degree: int) -> int:
    return max(num_lookups, 1) * degree


def logup_max_degree(graph: ConstraintGraph) -> int:
    """Analytic degree of the logUp constraints (reference
    src/lookup.rs:262-278): per lookup max(max arg degree + 1, mult degree);
    1 for the pass-through circuit."""
    if not graph.lookups:
        return 1
    out = 1
    for mult, args in graph.lookups:
        arg_deg = max((graph.degrees[a] for a in args), default=0)
        out = max(out, arg_deg + 1, graph.degrees[mult])
    return out


# --- host fingerprints (reference src/lookup.rs:375-384) ---------------------

def fingerprint(he: HostExtField, gamma: ExtVal, vals: Sequence[int]) -> ExtVal:
    """Horner: v_0 + γ·(v_1 + γ·(...))  =  Σ v_i γ^i."""
    acc = he.zero
    for v in reversed(vals):
        acc = he.add(he.mul(acc, gamma), he.from_base(v % he.base.p))
    return acc


def claims_accumulator(
    he: HostExtField, beta: ExtVal, gamma: ExtVal, claims: Sequence[Sequence[int]]
) -> ExtVal:
    """acc_0 = Σ_claims (β + fingerprint(γ, claim))^-1 on the host (the
    verifier's; the provers take `claims_accumulator_device` for every
    batch `claims_matrix` stacks).  Claims of one length are vectorized:
    Horner over the claim positions in NpExt and one batch inverse, a zero
    message contributing zero as in K9; ragged claims go one at a time,
    where a zero message raises ZeroDivisionError."""
    from .fields.npref import NpExt, NpField

    arr = claims_matrix(claims, he.base.p)
    if arr is None:
        acc = he.zero
        for claim in claims:
            fp = fingerprint(he, gamma, [int(v) for v in claim])
            acc = he.add(acc, he.inv(he.add(beta, fp)))
        return acc
    if arr.shape[0] == 0:
        return he.zero
    nf = NpField(he.base)
    ne = NpExt(nf, he)
    g = ne.of_scalar(gamma)
    msg = np.zeros((arr.shape[0], he.D), np.uint64)
    for j in range(arr.shape[1] - 1, -1, -1):
        msg = ne.mul(msg, g)
        msg[:, 0] = nf.add(msg[:, 0], arr[:, j])
    msg = ne.add(msg, ne.of_scalar(beta, (arr.shape[0],)))
    zero = ~msg.any(axis=1)
    msg[zero, 0] = 1
    inv = ne.batch_inv(msg)
    inv[zero] = 0
    return tuple(int(c) for c in nf.sum_axis(inv, 0))


def claims_matrix(claims, p: int) -> Optional[np.ndarray]:
    """The claims as an (n, L) canonical-uint64 array, or None when there
    are none or they are ragged (not all of one length)."""
    from .challenger import _canonical_claims_array

    arr = _canonical_claims_array(claims, p)
    if arr is not None or len(claims) == 0:
        return arr
    lens = {len(c) for c in claims}
    if len(lens) != 1:
        return None
    return np.asarray([[int(v) % p for v in c] for c in claims], np.uint64).reshape(len(claims), lens.pop())


# --- the device claims accumulator (kernel K9) ------------------------------------

def claims_acc_plain(E: ExtOps, claims: torch.Tensor, beta: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """Plain version of K9: the messages β + Σ_j γ^j·v_j of (n, L) claims by
    Horner over the claim positions, then the sum of their inverses (zeros
    contributing zero: utils.inv_sum_plain), as a (D,) tensor."""
    n, L = claims.shape
    g, b = gamma.reshape(E.D, 1), beta.reshape(E.D, 1)
    m = torch.zeros((E.D, n), dtype=torch.int64, device=claims.device)
    for j in range(L - 1, -1, -1):
        m = E.mul_plain(m, g)
        m[0] = E.base.add_plain(m[0], claims[:, j])
    return inv_sum_plain(E.add_plain(m, b), E)


def claims_acc(E: ExtOps, claims: torch.Tensor, beta: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """acc_0 = Σ_i (β + Σ_j γ^j·claims[i, j])^-1 of (n, L) canonical claims
    (row-major, as uploaded), β and γ (D,) device scalars, as a (D,) device
    scalar; a zero message contributes zero.  On a CUDA tensor one K9
    launch (no sync), the plain version on a CPU one."""
    if claims.dim() != 2 or claims.dtype != torch.int64:
        raise ValueError("claims_acc takes (n, L) int64 claims")
    if not kernels.use_kernel(claims):
        return claims_acc_plain(E, claims, beta, gamma)
    claims = claims.contiguous()
    beta, gamma = beta.reshape(-1).contiguous(), gamma.reshape(-1).contiguous()
    if beta.shape[0] != E.D or gamma.shape[0] != E.D:
        raise ValueError("claims_acc: β and γ must have D coordinates")
    kernels.check_cuda(claims, beta, gamma)
    n, L = claims.shape
    if n == 0:
        return torch.zeros(E.D, dtype=torch.int64, device=claims.device)
    out = torch.empty(E.D, dtype=torch.int64, device=claims.device)
    fid = E.base.field_id
    blocks = kernels.library().claims_acc_blocks(n)
    done, partials = scratch(claims).take_sums(claims, 1, E.D * blocks)
    ext_muls = E.D * E.D + E.D * (E.D - 1) // 2
    kernels.CLAIMS_FP.launch(
        "claims_acc", fid, kernels.ptr(claims), L, n, kernels.ptr(beta), kernels.ptr(gamma), kernels.ptr(done),
        kernels.ptr(partials), kernels.ptr(out),
        # the claims read once; per claim L - 1 base scales and two extension products; one inversion's latency
        cost=(8 * claims.numel() + 24 * E.D, n * (max(L - 1, 0) * E.D + 2 * ext_muls) * kernels.OPS_PER_MUL[fid],
              kernels.EXT_INV_LATENCY_MS[fid]),
    )
    return out


def ext_inv_chain(E: ExtOps, x: torch.Tensor, n: int) -> torch.Tensor:
    """x ((D,)) inverted n times in a row in one thread on the card: n
    dependent extension inversions' latency, K9's floor (a measurement, not
    a launch of K9: not counted).  The plain version on a CPU tensor."""
    if x.numel() != E.D or n < 0:
        raise ValueError(f"ext_inv_chain takes {E.D} coordinates and n >= 0")
    x = x.reshape(E.D, 1)
    if not kernels.use_kernel(x):
        for _ in range(n):
            x = E.inv_plain(x)
        return x.reshape(E.D)
    out = x.reshape(E.D).clone()
    kernels.check_cuda(out)
    rc = kernels.library().claims_inv_chain(E.base.field_id, kernels.ptr(out), n, kernels.current_stream())
    if rc != 0:
        raise RuntimeError(f"claims_inv_chain failed with cudaError_t {rc}")
    return out


def claims_accumulator_device(F: FieldOps, E: ExtOps, claims_arr: np.ndarray, beta: torch.Tensor,
                              gamma: torch.Tensor) -> torch.Tensor:
    """acc_0 = Σ_claims (β + fingerprint(γ, claim))^-1 over an (n, L)
    canonical-uint64 claims array, with β and γ device scalars: one upload
    of the claims as they are (not waited for), one K9 launch.  Returns a
    (D,) device scalar.  A zero message maps to zero, as in the host
    `claims_accumulator` of stacked claims (its one-claim-at-a-time path for
    ragged claims raises instead; either is a ~2^-128 event for
    Goldilocks^2, ~2^-124 for BabyBear^4)."""
    return claims_acc(E, F.from_np(claims_arr, beta.device), beta, gamma)


# --- generic ext-coordinate arithmetic over a working algebra ----------------

class ExtCoordOps:
    """Binomial-extension arithmetic where each coordinate is a working-type
    value W of an underlying Algebra (base arrays on device, ext scalars in
    the verifier).  Karatsuba for D=2 (reference src/lookup.rs:152-256)."""

    def __init__(self, alg, ep: ExtensionParams):
        self.alg = alg
        self.D = ep.degree
        self.w = ep.w
        self.karatsuba = ep.karatsuba

    def embed_host(self, v: ExtVal):
        return tuple(self.alg.const(c) for c in v)

    def from_w(self, w):
        zero = self.alg.const(0)
        return (w,) + (zero,) * (self.D - 1)

    def add(self, a, b):
        return tuple(self.alg.add(x, y) for x, y in zip(a, b))

    def sub(self, a, b):
        return tuple(self.alg.sub(x, y) for x, y in zip(a, b))

    def scale_w(self, a, w):
        return tuple(self.alg.mul(x, w) for x in a)

    def mul(self, a, b):
        alg = self.alg
        if self.D == 2 and self.karatsuba:
            t0 = alg.mul(a[0], b[0])
            t1 = alg.mul(a[1], b[1])
            t2 = alg.mul(alg.add(a[0], a[1]), alg.add(b[0], b[1]))
            c0 = alg.add(t0, alg.mul(alg.const(self.w), t1))
            c1 = alg.sub(t2, alg.add(t0, t1))
            return (c0, c1)
        D = self.D
        out = [None] * D
        for i in range(D):
            for j in range(D):
                t = alg.mul(a[i], b[j])
                k = i + j
                if k >= D:
                    k -= D
                    t = alg.mul(alg.const(self.w), t)
                out[k] = t if out[k] is None else alg.add(out[k], t)
        return tuple(out)


# --- direct logUp constraint evaluation (reference src/lookup.rs:152-256) ----

def logup_constraint_values(
    alg,
    ep: ExtensionParams,
    hf: HostField,
    num_lookups: int,
    stage2_fn,  # (base_column, offset:0|1) -> W
    lookup_vals: Sequence[Tuple[object, Tuple[object, ...]]],  # (mult W, args)
    is_last_row_w,  # W value of the unnormalized is_last_row selector
    publics_emb,  # (β, γ, acc_i, acc_f) — each a D-tuple of W values
    log_n: int,
) -> List[Tuple]:
    """Returns max(L,1) extension constraint values as D-tuples of W, in slot
    order.  Evaluated directly — never compiled (SURVEY.md lookup row).
    Publics arrive pre-embedded in the working type so jitted callers pass
    them as arguments rather than baking transcript values into the trace."""
    X = ExtCoordOps(alg, ep)
    D = ep.degree
    beta_emb, gamma_emb, acc_i, acc_f = publics_emb
    n = 1 << log_n
    g = hf.two_adic_generator(log_n)
    inv_ng = alg.const(hf.inv(hf.mul(n % hf.p, g)))
    delta = X.scale_w(X.sub(acc_i, acc_f), inv_ng)

    def s2(slot: int, offset: int):
        return tuple(stage2_fn(slot * D + d, offset) for d in range(D))

    if num_lookups == 0:
        diff = X.sub(s2(0, 1), s2(0, 0))
        return [X.sub(diff, X.scale_w(delta, is_last_row_w))]

    out = []
    for j in range(num_lookups):
        mult, args = lookup_vals[j]
        zero = alg.const(0)
        m = (zero,) * D
        for a in reversed(args):
            m = X.add(X.mul(m, gamma_emb), X.from_w(a))
        m = X.add(m, beta_emb)
        if j < num_lookups - 1:
            diff = X.sub(s2(j + 1, 0), s2(j, 0))
        else:
            diff = X.sub(s2(0, 1), s2(j, 0))
            diff = X.sub(diff, X.scale_w(delta, is_last_row_w))
        c = X.mul(m, diff)
        c = (alg.sub(c[0], mult),) + c[1:]
        out.append(c)
    return out


# --- executable synthesized spec (reference src/lookup.rs:326-371) -----------

def synthesize_lookups(
    lookups: Sequence[ex.Lookup], ep: ExtensionParams, hf: HostField, log_n: int
) -> List[ex.ExtExpr]:
    """The same constraints as `logup_constraint_values`, as compilable
    ExtExprs over the publics (β, γ, acc_initial, acc_final) and the
    stage-2 slots (tests only)."""
    D = ep.degree
    beta = ex.public_ext(0, D)
    gamma = ex.public_ext(1, D)
    acc_i = ex.public_ext(2, D)
    acc_f = ex.public_ext(3, D)
    n = 1 << log_n
    inv_ng = hf.inv(hf.mul(n % hf.p, hf.two_adic_generator(log_n)))
    delta = ex.ExtBase(ex.Const(inv_ng)) * (acc_i - acc_f)
    L = len(lookups)
    if L == 0:
        diff = ex.stage2_ext_next(0, D) - ex.stage2_ext(0, D)
        return [diff - ex.ExtBase(ex.IsLastRow()) * delta]
    out = []
    for j, lookup in enumerate(lookups):
        m = ex.ExtBase(ex.Const(0))
        for a in reversed(lookup.args):
            m = m * gamma + ex.ExtBase(a)
        m = m + beta
        if j < L - 1:
            diff = ex.stage2_ext(j + 1, D) - ex.stage2_ext(j, D)
        else:
            diff = ex.stage2_ext_next(0, D) - ex.stage2_ext(j, D)
            diff = diff - ex.ExtBase(ex.IsLastRow()) * delta
        out.append(m * diff - ex.ExtBase(lookup.multiplicity))
    return out


# --- witness-side lookup values and stage-2 traces ----------------------------

@dataclass
class LookupValues:
    """Per-circuit lookup witness: for each slot, the multiplicity column and
    argument columns, as rows of one (Σ_j (1 + arity_j), n) matrix (slot 0's
    multiplicity, its arguments, slot 1's multiplicity, ...), with the
    circuit's stage-2 message program."""

    height: int
    matrix: Optional[torch.Tensor]  # None when the circuit has no lookups
    arities: Tuple[int, ...]
    stage2_program: Optional[Program]

    def _starts(self) -> List[int]:
        starts, row = [], 0
        for a in self.arities:
            starts.append(row)
            row += 1 + a
        return starts

    @property
    def mults(self) -> List[torch.Tensor]:  # L tensors (n,)
        return [self.matrix[r] for r in self._starts()]

    @property
    def args(self) -> List[List[torch.Tensor]]:  # L lists of tensors (n,)
        return [[self.matrix[r + 1 + i] for i in range(a)] for r, a in zip(self._starts(), self.arities)]


def stage2_program(p: int, ep: ExtensionParams, arities: Sequence[int], name: str) -> Program:
    """Record the stage-2 slot messages β + Σ_i arg_i·γ^i (Horner) of lookups
    with these arities as a K11 program over the lookup-values matrix
    (source 0; β at publics 0..D-1, γ at D..2D-1).  Out: plane d <
    D = coordinate d of the message, plane D = the multiplicity, each at
    slot j of its row: the chain order, row-major and slot-minor."""
    rec = Recorder(p, sources=(0,))
    X = ExtCoordOps(rec, ep)
    D = ep.degree
    beta = tuple(rec.public(d) for d in range(D))
    gamma = tuple(rec.public(D + d) for d in range(D))
    row = 0
    for j, arity in enumerate(arities):
        mult = rec.var(0, row, 0)
        m = (rec.const(0),) * D
        for i in reversed(range(arity)):
            m = X.add(X.mul(m, gamma), X.from_w(rec.var(0, row + 1 + i, 0)))
        m = X.add(m, beta)
        for d in range(D):
            rec.out(m[d], d, j)
        rec.out(mult, D, j)
        row += 1 + arity
    return rec.compile(name)


def stage_2_traces_device(E: ExtOps, lookup_values: Sequence[LookupValues], beta, gamma, acc0):
    """All active circuits' stage-2 traces + per-circuit running
    accumulators, threading one global accumulator from acc₀; each circuit's
    serial row chain is a parallel prefix sum.  β, γ, acc₀ are (D,) device
    scalars and no value leaves the device.  Per circuit: the slot messages
    and multiplicities in chain order (K11), then the chain (K4's
    stage-2 chain: inverses, terms mult/message, prefix sum, accumulator).

    Under a mesh, a circuit with n % D == 0 rows takes
    parallel.sharded_stage2 (JAX lookup.py:350-361) and its blocks are
    gathered for the commit, whose iDFT runs replicated.

    Returns (stage2_mats: [(max(L,1)·D, n) tensors], accs: [(D,) tensors])."""
    from . import parallel

    pm = parallel.current_mesh()
    mats, accs = [], []
    acc = acc0.reshape(E.D)
    pubs = None
    for lv in lookup_values:
        n, L = lv.height, len(lv.arities)
        if L == 0:
            # pass-through: a (D, n) matrix of the constant accumulator
            mats.append(acc[:, None].expand(E.D, n).contiguous())
            accs.append(acc)
            continue
        if pm is not None and n >= pm.n and n % pm.n == 0:
            blk, total = parallel.sharded_stage2(E, pm, lv, beta, gamma, acc)
            acc = E.add(acc, total)
            mats.append(parallel.gather_blocks(pm, blk, "stage2"))
            accs.append(acc)
            continue
        if pubs is None:
            pubs = ext_pack_device((beta, gamma)).reshape(-1)
        ops = Operands(sources=[lv.matrix], rows=n, pubs=pubs)
        msgs = expr_sweep(E.base, lv.stage2_program, ops, (E.D + 1, n * L), n * L, L)
        mat, total = stage2_chain(E, L, msgs, acc)
        acc = E.add(acc, total)
        mats.append(mat)
        accs.append(acc)
    return mats, accs


def stage_2_traces(hf: HostField, he: HostExtField, lookup_values: Sequence[LookupValues], beta: ExtVal,
                   gamma: ExtVal, acc0: ExtVal):
    """The stage-2 traces and running accumulators in plain NumPy, on the
    host (tests only; the provers take `stage_2_traces_device`).  Per
    circuit with L > 0 lookups: the slot messages m = β + Σ_i γ^i·arg_i in
    the chain order (row-major, slot-minor), the terms mult/m, their
    inclusive prefix sum, and at each slot the sum before it plus the
    accumulator the circuit starts from; a circuit without lookups passes
    that accumulator through as a constant (D, n) matrix.

    Returns (mats: [(max(L,1)·D, n) uint64 arrays, row j·D + d = coordinate
    d of slot j], accs: [ExtVal], the accumulator after each circuit)."""
    from .fields.npref import NpExt, NpField

    nf = NpField(hf)
    ne = NpExt(nf, he)
    D = he.D
    g, b = ne.of_scalar(gamma), ne.of_scalar(beta)
    acc = tuple(int(c) for c in acc0)
    mats, accs = [], []
    for lv in lookup_values:
        n, L = lv.height, len(lv.arities)
        if L == 0:
            mats.append(np.repeat(ne.of_scalar(acc)[:, None], n, axis=1))
            accs.append(acc)
            continue
        msgs = np.empty((n, L, D), np.uint64)
        mults = np.empty((n, L), np.uint64)
        for j, (mult, args) in enumerate(zip(lv.mults, lv.args)):
            m = np.zeros((n, D), np.uint64)
            for a in reversed(args):
                m = ne.mul(m, g)
                m[:, 0] = nf.add(m[:, 0], FieldOps.to_np(a))
            msgs[:, j] = ne.add(m, b)
            mults[:, j] = FieldOps.to_np(mult)
        terms = ne.scale(ne.batch_inv(msgs.reshape(n * L, D)), mults.reshape(-1))
        incl, s = terms, 1
        while s < n * L:  # inclusive prefix sum (Hillis-Steele)
            incl = np.concatenate([incl[:s], nf.add(incl[s:], incl[:-s])])
            s <<= 1
        excl = np.concatenate([np.zeros((1, D), np.uint64), incl[:-1]])
        rows = ne.add(excl, ne.of_scalar(acc, (n * L,))).reshape(n, L, D)
        mats.append(rows.transpose(1, 2, 0).reshape(L * D, n))
        acc = he.add(acc, tuple(int(c) for c in incl[-1]))
        accs.append(acc)
    return mats, accs
