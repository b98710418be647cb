"""The logUp lookup argument, as the verifier needs it: the stage-2 layout,
the degree of the logUp constraints, the claims accumulator and the logUp
constraints at one point (reference src/lookup.rs)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .field_host import ExtensionParams, HostExtField, HostField
from .npref import NpExt, NpField


ExtVal = Tuple[int, ...]


# --- layout (reference src/lookup.rs:78-99) ----------------------------------

def num_publics(degree: int) -> int:
    return 4 * degree


def stage2_width(num_lookups: int, degree: int) -> int:
    return max(num_lookups, 1) * degree


def logup_constraint_count(num_lookups: int, degree: int) -> int:
    return max(num_lookups, 1) * degree


def logup_max_degree(lookup_degrees: Sequence[Tuple[int, int]]) -> int:
    """Degree of the logUp constraints (reference src/lookup.rs:262-278):
    per lookup max(largest argument degree + 1, multiplicity degree); 1
    for the pass-through circuit.  `lookup_degrees`: (multiplicity degree,
    largest argument degree) per lookup."""
    return max([1] + [max(a + 1, m) for m, a in lookup_degrees])


# --- host fingerprints (reference src/lookup.rs:375-384) ---------------------

def claims_accumulator(he: HostExtField, beta: ExtVal, gamma: ExtVal, claims: np.ndarray) -> ExtVal:
    """acc_0 = Σ_claims (β + Σ_i v_i γ^i)^-1 over an (n, L) uint64 claims
    array: Horner over the claim positions in NpExt and one batch inverse;
    a zero message contributes zero."""
    arr = np.asarray(claims, np.uint64) % np.uint64(he.base.p)
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


# --- the logUp constraints at ζ (reference src/lookup.rs:152-256) ------------

def logup_constraint_values(he: HostExtField, ep: ExtensionParams, hf: HostField, stage2, lookup_vals,
                            is_last_row, publics, log_n: int) -> List[tuple]:
    """max(L, 1) constraints, each D base-coordinate values in the extension
    field, in slot order.  An element of the extension is a D-tuple of such
    values (X^D = w): stage2(slot, offset) the slot's opened coordinates,
    lookup_vals the (multiplicity, arguments) values per lookup, publics
    (β, γ, acc_initial, acc_final) as D-tuples.  For lookup j, with
    m = β + Σ_i args_i γ^i:

        m · (s_{j+1} - s_j) - multiplicity = 0                  (j < L - 1)
        m · (s_0' - s_j - is_last_row · δ) - multiplicity = 0   (j = L - 1)

    where s' is the next row and δ = (acc_initial - acc_final) / (n · g)."""
    D = ep.degree

    def add(a, b):
        return tuple(he.add(x, y) for x, y in zip(a, b))

    def sub(a, b):
        return tuple(he.sub(x, y) for x, y in zip(a, b))

    def scale(a, s):
        return tuple(he.mul(x, s) for x in a)

    def mul(a, b):
        out = [he.zero] * D
        for i in range(D):
            for j in range(D):
                t = he.mul(a[i], b[j])
                if i + j >= D:
                    t = he.mul(he.from_base(ep.w), t)
                out[(i + j) % D] = he.add(out[(i + j) % D], t)
        return tuple(out)

    beta, gamma, acc_i, acc_f = publics
    n = 1 << log_n
    delta = scale(sub(acc_i, acc_f), he.from_base(hf.inv(hf.mul(n % hf.p, hf.two_adic_generator(log_n)))))
    last = sub(stage2(0, 1), scale(delta, is_last_row))
    if not lookup_vals:
        return [sub(last, stage2(0, 0))]
    out = []
    for j, (mult, args) in enumerate(lookup_vals):
        m = (he.zero,) * D
        for a in reversed(args):
            m = add(mul(m, gamma), (a,) + (he.zero,) * (D - 1))
        m = add(m, beta)
        nxt = stage2(j + 1, 0) if j < len(lookup_vals) - 1 else last
        c = mul(m, sub(nxt, stage2(j, 0)))
        out.append((he.sub(c[0], mult),) + c[1:])
    return out
