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

The stage-2 traces are built on the device: messages through the field's
elementwise kernel (K1 or K5), their inverses through the K4 batch inverse,
the chain through the K4 prefix sum.  The claims accumulator stays on the
host: a native C pass for Goldilocks^2, NumPy for BabyBear^4.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .fields.device import ExtOps
from .fields.host import ExtensionParams, HostExtField, HostField
from .fields.npref import NpExt, NpField
from .graph import ConstraintGraph
from .utils import batch_inv, cumsum

ExtVal = Tuple[int, ...]


# --- layout (reference src/lookup.rs:78-99) ----------------------------------

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
    """acc_0 = Σ_claims (β + fingerprint(γ, claim))^-1 on the host.
    Homogeneous claim batches (the bench proves one claim per row) take one
    vectorized pass: for Goldilocks^2 the native C helper
    (csrc/host/b3.c msgl_claims_acc2), for BabyBear^4 NumPy (Horner
    fingerprints and a product-tree batch inverse); short or ragged lists
    the scalar loop."""
    from .challenger import _canonical_claims_array

    vals = _canonical_claims_array(claims, he.base.p)
    if vals is not None:
        if he.name == "Goldilocks^2":
            return _claims_accumulator_native(he, beta, gamma, vals)
        return _claims_accumulator_np(he, beta, gamma, vals)
    acc = he.zero
    for claim in claims:
        fp = fingerprint(he, gamma, [int(v) for v in claim])
        acc = he.add(acc, he.inv(he.add(beta, fp)))
    return acc


def _claims_accumulator_np(he, beta, gamma, vals: np.ndarray) -> ExtVal:
    """vals: (n, L) canonical uint64 claims.  Raises ZeroDivisionError on a
    zero denominator like the scalar path."""
    nf = NpField(he.base)
    ne = NpExt(nf, he)
    n = vals.shape[0]
    g = ne.of_scalar(gamma)
    acc = np.zeros((n, he.D), np.uint64)
    for j in range(vals.shape[1] - 1, -1, -1):  # Horner over claim positions
        acc = ne.mul(acc, g)
        acc[..., 0] = nf.add(acc[..., 0], vals[:, j])
    acc = ne.add(acc, ne.of_scalar(beta, (n,)))
    total = nf.sum_axis(ne.batch_inv(acc), 0)  # (D,)
    return tuple(int(c) for c in total)


def _claims_accumulator_native(he, beta, gamma, vals: np.ndarray) -> ExtVal:
    """vals: (n, L) canonical uint64 claims.  Raises ZeroDivisionError on a
    zero denominator like the scalar path."""
    import ctypes

    from .native import lib

    n, L = vals.shape
    vals = np.ascontiguousarray(vals, np.uint64)
    g = np.asarray([c % he.base.p for c in gamma], np.uint64)
    b = np.asarray([c % he.base.p for c in beta], np.uint64)
    scratch = np.empty(2 * n, np.uint64)
    out = np.empty(2, np.uint64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    rc = lib().msgl_claims_acc2(
        vals.ctypes.data_as(u64p), n, L, g.ctypes.data_as(u64p),
        b.ctypes.data_as(u64p), scratch.ctypes.data_as(u64p),
        out.ctypes.data_as(u64p),
    )
    if rc != 0:
        raise ZeroDivisionError("zero denominator in claims accumulator")
    return (int(out[0]), int(out[1]))


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


# --- witness-side lookup values and stage-2 traces ----------------------------

@dataclass
class LookupValues:
    """Per-circuit lookup witness: for each slot, the multiplicity column and
    argument columns as (n,) base tensors."""

    height: int
    mults: List[torch.Tensor]  # L tensors (n,)
    args: List[List[torch.Tensor]]  # L lists of tensors (n,)


def stage_2_traces(E: ExtOps, lookup_values: Sequence[LookupValues], beta, gamma, acc0, device):
    """All active circuits' stage-2 traces + per-circuit intermediate
    accumulators, threading one global accumulator; each circuit's serial row
    chain is a parallel prefix sum.

    Returns (stage2_mats: [(max(L,1)·D, n) tensors], accs: [ExtVal])."""
    beta_t, gamma_t = E.const(beta, device), E.const(gamma, device)
    mats, accs = [], []
    acc = acc0
    for lv in lookup_values:
        n, L = lv.height, len(lv.mults)
        if L == 0:
            # pass-through: a (D, n) matrix of the constant accumulator
            mats.append(E.const(acc, device)[:, None].expand(E.D, n).contiguous())
            accs.append(acc)
            continue
        flat_msgs, flat_mults = _stage2_msgs(E, lv.args, lv.mults, beta_t, gamma_t)
        inv_msgs = batch_inv(flat_msgs, E)
        mat, total = _stage2_scan(E, L, inv_msgs, flat_mults, E.const(acc, device))
        acc = E.host.add(acc, E.to_host(total)[0])
        mats.append(mat)
        accs.append(acc)
    return mats, accs


def _stage2_msgs(E: ExtOps, args_list, mults_list, beta_t, gamma_t):
    """Slot messages β + Σ_i arg_i·γ^i (Horner) as one (D, n·L) ext tensor
    in the chain order, row-major and slot-minor; multiplicities likewise."""
    slot_msgs = []
    for args in args_list:
        m = torch.zeros((E.D,) + tuple(args[0].shape), dtype=torch.int64, device=beta_t.device)
        for a in reversed(args):
            m = E.add(E.mul(m, gamma_t), E.from_base(a))
        slot_msgs.append(E.add(m, beta_t))
    flat_msgs = torch.stack(slot_msgs, dim=-1).reshape(E.D, -1)
    flat_mults = torch.stack(list(mults_list), dim=-1).reshape(-1)
    return flat_msgs, flat_mults


def _stage2_scan(E: ExtOps, L: int, inv_msgs, flat_mults, acc_t):
    """Terms mult/m, inclusive prefix sum, exclusive accumulator injection,
    and the stage-2 column layout: row (j·D + d) = coordinate d of slot j.
    Returns (matrix (L·D, n), chain total (D, 1))."""
    D = E.D
    terms = E.scale(inv_msgs, flat_mults)
    incl = cumsum(terms, E)
    excl = torch.cat([torch.zeros_like(incl[:, :1]), incl[:, :-1]], dim=1)
    acc_flat = E.add(excl, acc_t)
    n = acc_flat.shape[1] // L
    mat = acc_flat.reshape(D, n, L).permute(2, 0, 1).reshape(L * D, n).contiguous()
    return mat, incl[:, -1:]
