"""The verifier (reference src/verifier.rs), on the host in NumPy and Python
integers.

Five steps: the proof's shape against the system, the channel balance (the
last intermediate accumulator must be zero), the Fiat-Shamir replay the
prover ran, the PCS check (`pcs.TwoAdicFriPcs.verify`), and per active
circuit the out-of-domain check

    composition(ζ) · Z_H(ζ)^{-1}  ==  Q(ζ) = Σ ζ^{i·n} · c_i(ζ)
"""

from __future__ import annotations

import numpy as np

from . import lookup as lk
from .domains import TwoAdicCoset
from .errors import ensure
from .constraints import evaluate
from .expr import Source
from .serialization import Proof
from .system import System


def verify_multiple_claims(system: System, claims: np.ndarray, proof: Proof) -> None:
    """Accept the proof of `claims` (an (n, L) uint64 array), or raise
    VerificationError."""
    config = system.config
    hf, he = config.host_field, config.host_ext
    D = config.extension_params.degree

    verify_shape(system, proof)

    # the global accumulator chain must close
    ensure(he.is_zero(proof.intermediate_accumulators[-1]), "UnbalancedChannel", "final accumulator nonzero")

    # --- Fiat-Shamir replay ---------------------------------------------------
    ch = config.initialise_challenger()
    system.observe_shape(ch)
    for b in proof.active:
        ch.observe_bytes(bytes([1 if b else 0]))
    active_idx = [i for i, b in enumerate(proof.active) if b]
    if system.preprocessed_commit is not None:
        ch.observe_commitment(system.preprocessed_commit)
    ch.observe_commitment(proof.commitments.stage_1_trace)
    for ld in proof.log_degrees:
        ch.observe_bytes(bytes([ld]))
    ch.observe_claims(claims)
    beta = ch.sample_ext()
    gamma = ch.sample_ext()
    acc0 = lk.claims_accumulator(he, beta, gamma, claims)
    ch.observe_commitment(proof.commitments.stage_2_trace)
    for a in proof.intermediate_accumulators:
        ch.observe_ext(a)
    alpha = ch.sample_ext()
    ch.observe_commitment(proof.commitments.quotient_chunks)
    zeta = ch.sample_ext()

    # --- the opening rounds ----------------------------------------------------
    rounds = []
    if system.preprocessed_commit is not None:
        pre_mats = []
        p_ord = 0
        for c_idx, p_idx in enumerate(system.preprocessed_index):
            if p_idx is None:
                continue
            ph, pw = system.circuits[c_idx].preprocessed_dims
            pts = []
            if proof.active[c_idx]:
                zg = he.scale(zeta, hf.two_adic_generator(proof.log_degrees[active_idx.index(c_idx)]))
                pts = [(zeta, proof.preprocessed_opened[p_ord][0]), (zg, proof.preprocessed_opened[p_ord][1])]
            pre_mats.append((ph.bit_length() - 1, pw, pts))
            p_ord += 1
        rounds.append((system.preprocessed_commit, pre_mats))

    s1_mats, s2_mats, q_mats = [], [], []
    for k, i in enumerate(active_idx):
        circuit = system.circuits[i]
        log_n = proof.log_degrees[k]
        zg = he.scale(zeta, hf.two_adic_generator(log_n))
        s1_mats.append((log_n, circuit.main_width, [(zeta, proof.stage1_opened[k][0]), (zg, proof.stage1_opened[k][1])]))
        s2_mats.append((log_n, circuit.stage2_width,
                        [(zeta, proof.stage2_opened[k][0]), (zg, proof.stage2_opened[k][1])]))
        q_mats.append((log_n, circuit.quotient_degree * D, [(zeta, proof.quotient_opened[k][0])]))
    rounds.append((proof.commitments.stage_1_trace, s1_mats))
    rounds.append((proof.commitments.stage_2_trace, s2_mats))
    rounds.append((proof.commitments.quotient_chunks, q_mats))

    config.pcs.verify(rounds, proof.fri_proof, ch)

    # --- per-circuit out-of-domain check ----------------------------------------
    acc_prev = acc0
    for k, i in enumerate(active_idx):
        circuit = system.circuits[i]
        log_n = proof.log_degrees[k]
        sel = TwoAdicCoset(hf, log_n, 1).selectors_at_point(he, zeta)
        acc_final = proof.intermediate_accumulators[k]
        publics = [he.from_base(c) for v in (beta, gamma, acc_prev, acc_final) for c in v]
        p_ord = system.preprocessed_index[i]

        def leaf(source, col, offset, k=k, p_ord=p_ord):
            if source == Source.MAIN:
                return proof.stage1_opened[k][offset][col]
            if source == Source.STAGE2:
                return proof.stage2_opened[k][offset][col]
            ensure(p_ord is not None, "InvalidProofShape", "preprocessed var without trace")
            return proof.preprocessed_opened[p_ord][offset][col]

        memo: dict = {}

        def at_zeta(e):
            return evaluate(e, he, leaf, publics, sel, memo)

        values = [at_zeta(e) for e in circuit.constraints.roots]
        lookup_vals = [(at_zeta(lk_.multiplicity), tuple(at_zeta(a) for a in lk_.args)) for lk_ in circuit.lookups]
        emb = [tuple(publics[D * s:D * s + D]) for s in range(4)]
        for lv in lk.logup_constraint_values(
            he, config.extension_params, hf,
            lambda slot, off, k=k: tuple(proof.stage2_opened[k][off][slot * D:slot * D + D]),
            lookup_vals, sel.is_last_row, emb, log_n,
        ):
            values.extend(lv)

        folded = he.zero  # α-fold by Horner
        for v in values:
            folded = he.add(he.mul(folded, alpha), v)

        # Q(ζ) = Σ ζ^{i·n}·c_i(ζ)
        q_row = proof.quotient_opened[k][0]
        zn = he.pow(zeta, 1 << log_n)
        quotient = he.zero
        for ci in range(circuit.quotient_degree - 1, -1, -1):
            c_val = he.zero
            for d in range(D):
                basis = tuple(1 if e == d else 0 for e in range(D))
                c_val = he.add(c_val, he.mul(basis, q_row[ci * D + d]))
            quotient = he.add(he.mul(quotient, zn), c_val)

        ensure(he.mul(folded, sel.inv_vanishing) == quotient, "OodEvaluationMismatch", f"circuit {i}")
        acc_prev = acc_final


def verify_shape(system: System, proof: Proof) -> None:
    """Structural validation before any cryptography."""
    config = system.config
    D = config.extension_params.degree
    p = config.host_field.p

    ensure(len(proof.active) == len(system.circuits), "InvalidProofShape", "bitmap length")
    ensure(any(proof.active), "InvalidProofShape", "no active circuits")
    active_idx = [i for i, b in enumerate(proof.active) if b]
    n_active = len(active_idx)
    ensure(len(proof.log_degrees) == n_active, "InvalidProofShape", "log_degrees length")
    ensure(len(proof.intermediate_accumulators) == n_active, "InvalidProofShape", "accumulator count")
    for a in proof.intermediate_accumulators:
        _check_ext(a, D, p)

    for k, i in enumerate(active_idx):
        circuit = system.circuits[i]
        log_n = proof.log_degrees[k]
        ensure(0 <= log_n, "InvalidProofShape", "negative log degree")
        # the shift-overflow guard on adversarial proofs
        q_bits = circuit.quotient_degree.bit_length() - 1
        ensure(log_n + q_bits <= config.max_log_degree(), "InvalidProofShape",
               f"log_degree {log_n} + log_quotient {q_bits} exceeds max {config.max_log_degree()}")
        if circuit.preprocessed_dims is not None:
            ensure(1 << log_n == circuit.preprocessed_dims[0], "InvalidProofShape", "main height != preprocessed height")

    ensure(len(proof.stage1_opened) == n_active, "InvalidProofShape", "stage1 count")
    ensure(len(proof.stage2_opened) == n_active, "InvalidProofShape", "stage2 count")
    ensure(len(proof.quotient_opened) == n_active, "InvalidProofShape", "quotient count")
    for k, i in enumerate(active_idx):
        circuit = system.circuits[i]
        _check_opened(proof.stage1_opened[k], 2, circuit.main_width, D, p)
        _check_opened(proof.stage2_opened[k], 2, circuit.stage2_width, D, p)
        _check_opened(proof.quotient_opened[k], 1, circuit.quotient_degree * D, D, p)

    n_pre = sum(1 for x in system.preprocessed_index if x is not None)
    ensure(len(proof.preprocessed_opened) == n_pre, "InvalidProofShape", "preprocessed count")
    p_ord = 0
    for c_idx, p_idx in enumerate(system.preprocessed_index):
        if p_idx is None:
            continue
        _, pw = system.circuits[c_idx].preprocessed_dims
        _check_opened(proof.preprocessed_opened[p_ord], 2 if proof.active[c_idx] else 0, pw, D, p)
        p_ord += 1


def _check_opened(mat_vals, n_points: int, width: int, D: int, p: int) -> None:
    ensure(len(mat_vals) == n_points, "InvalidProofShape", "point count")
    for pt in mat_vals:
        ensure(len(pt) == width, "InvalidProofShape", "opened width")
        for v in pt:
            _check_ext(v, D, p)


def _check_ext(v, D: int, p: int) -> None:
    ensure(
        isinstance(v, tuple) and len(v) == D and all(isinstance(c, int) and 0 <= c < p for c in v),
        "InvalidProofShape",
        "malformed extension value",
    )
