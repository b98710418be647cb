"""Two-adic FRI, as the verifier needs it (reference p3-fri and the
multi-stark PCS): the arity schedule, the replay of the opening's
transcript and the check of every query (Merkle paths, reduced openings,
the fold walk and the final polynomial), all queries at once over NumPy
arrays; and the one commitment a verifier makes itself, that of the
preprocessed traces (`commit`): each matrix's LDE on GENERATOR·H_{n·B},
stored in bit-reversed row order, in one mixed-height Merkle tree."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .errors import VerificationError, ensure
from .field_host import HostExtField, HostField
from .merkle import BatchOpening, MerkleMmcs, mmcs_verify_batch_queries
from .npref import NpExt, NpField, reverse_bits_vec

ExtVal = Tuple[int, ...]
VerifyRound = Tuple[np.ndarray, List[Tuple[int, int, list]]]  # (cap, [(log_n, width, [(z, values)])])


@dataclass
class QueryProof:
    input_openings: List[BatchOpening]  # one per round
    commit_openings: List[Tuple[np.ndarray, np.ndarray]]  # (fold row u64 (A·D,), path)


@dataclass
class FriProof:
    commit_caps: List[np.ndarray]
    commit_pow_witnesses: List[int]
    final_poly: List[ExtVal]
    query_pow_witness: int
    query_proofs: List[QueryProof]


@dataclass(frozen=True)
class FriParameters:
    log_blowup: int
    cap_height: int
    log_final_poly_len: int
    max_log_arity: int
    num_queries: int
    commit_proof_of_work_bits: int
    query_proof_of_work_bits: int


class TwoAdicFriPcs:
    def __init__(self, hf: HostField, he: HostExtField, fri: FriParameters):
        self.hf = hf
        self.he = he
        self.fri = fri
        self.log_blowup = fri.log_blowup
        self.mmcs = MerkleMmcs(fri.cap_height)

    def commit(self, mats: Sequence[np.ndarray]) -> np.ndarray:
        """The cap of the LDEs of natural-order (h, w) uint64 matrices."""
        ldes = [lde_bitrev(self.hf, m, self.log_blowup) for m in mats]
        return self.mmcs.commit(ldes)

    def fri_schedule(self, ro_heights, log_max_ro: int) -> List[int]:
        """Deterministic arity schedule (mirrored by the verifier): arity per
        round capped so we never fold below the final size and never skip an
        input height that must be absorbed."""
        log_final = self.log_blowup + self.fri.log_final_poly_len
        schedule: List[int] = []
        ls = log_max_ro
        while ls > log_final:
            a_bits = min(self.fri.max_log_arity, ls - log_final)
            for h in ro_heights:
                if ls - a_bits < h < ls:
                    a_bits = ls - h
            schedule.append(a_bits)
            ls -= a_bits
        return schedule

    def verify(self, rounds: Sequence[VerifyRound], proof: FriProof, challenger) -> None:
        """Replay the opening's transcript on `challenger` and check every
        query; raises VerificationError.  Each tree's Merkle paths are
        checked for all queries at once, and the arithmetic runs over
        (Q, ...) NumPy arrays."""
        he, fri = self.he, self.fri
        for cap, mats in rounds:  # TranscriptProfile.fri_observe_claims_before_alpha
            for _, _, pts in mats:
                for _, vals in pts:
                    for v in vals:
                        challenger.observe_ext(v)
        alpha = challenger.sample_ext()

        log_max = max(log_n + self.log_blowup for _, mats in rounds for log_n, _, _ in mats)
        heights = {log_n + self.log_blowup for _, mats in rounds for log_n, _, pts in mats if pts}
        log_max_ro = max(heights)
        schedule = self.fri_schedule(heights, log_max_ro)
        ensure(len(proof.commit_caps) == len(schedule), "InvalidProofShape", "fold count")
        ensure(len(proof.commit_pow_witnesses) == len(schedule), "InvalidProofShape", "pow count")
        betas = []
        for cap, pow_w in zip(proof.commit_caps, proof.commit_pow_witnesses):
            challenger.observe_commitment(cap)
            ensure(challenger.check_witness(fri.commit_proof_of_work_bits, pow_w), "InvalidOpeningArgument",
                   "commit PoW")
            betas.append(challenger.sample_ext())
        ensure(len(proof.final_poly) == 1 << fri.log_final_poly_len, "InvalidProofShape", "final poly len")
        for c in proof.final_poly:
            challenger.observe_ext(c)
        ensure(challenger.check_witness(fri.query_proof_of_work_bits, proof.query_pow_witness),
               "InvalidOpeningArgument", "query PoW")
        indices = [challenger.sample_bits(log_max) for _ in range(fri.num_queries)]
        ensure(len(proof.query_proofs) == len(indices), "InvalidProofShape", "query count")

        # a malformed proof that passes the shape checks (ragged rows, wrong
        # dtypes, short paths) is a VerificationError, never a NumPy one
        try:
            self._verify_merkle_batched(rounds, proof, indices, log_max, log_max_ro, schedule)
            self._verify_queries_batched(rounds, alpha, betas, proof, indices, log_max, log_max_ro, schedule)
        except VerificationError:
            raise
        except (ValueError, TypeError, IndexError, KeyError, OverflowError) as e:
            raise VerificationError("InvalidProofShape", f"malformed proof ({type(e).__name__})") from e

    def _verify_merkle_batched(self, rounds, proof, indices, log_max, log_max_ro, schedule) -> None:
        """Every input tree's and fold level's Merkle paths, all queries of a
        tree at once."""
        idx = np.asarray(indices, np.int64)
        for qp in proof.query_proofs:
            ensure(len(qp.input_openings) == len(rounds), "InvalidProofShape", "round count")
            ensure(len(qp.commit_openings) == len(schedule), "InvalidProofShape", "level count")
        for r, (cap, mats) in enumerate(rounds):
            round_log_max = max(log_n for log_n, _, _ in mats) + self.log_blowup
            dims = [(w, 1 << (log_n + self.log_blowup)) for log_n, w, _ in mats]
            openings = [qp.input_openings[r] for qp in proof.query_proofs]
            ensure(mmcs_verify_batch_queries(self.mmcs, cap, dims, idx >> (log_max - round_log_max), openings),
                   "InvalidOpeningArgument", "input Merkle path")
        D = self.he.D
        log_size = log_max_ro
        pos = idx >> (log_max - log_max_ro)
        for l, a_bits in enumerate(schedule):
            A = 1 << a_bits
            for qp in proof.query_proofs:
                ensure(len(qp.commit_openings[l][0]) == A * D, "InvalidProofShape", "fold row width")
            openings = [BatchOpening(opened_rows=[np.asarray(qp.commit_openings[l][0], np.uint64)],
                                     path=qp.commit_openings[l][1]) for qp in proof.query_proofs]
            ensure(mmcs_verify_batch_queries(self.mmcs, proof.commit_caps[l], [(A * D, 1 << (log_size - a_bits))],
                                             pos >> a_bits, openings),
                   "InvalidOpeningArgument", "commit-phase Merkle path")
            log_size -= a_bits
            pos = pos >> a_bits

    def _verify_queries_batched(self, rounds, alpha, betas, proof, indices, log_max, log_max_ro, schedule) -> None:
        """`_verify_query`'s arithmetic (reduced openings, fold walk, final
        polynomial) for all queries at once over (Q, ...) uint64 arrays: the
        same checks and error kinds.  The Merkle paths are checked by
        `_verify_merkle_batched`."""
        he, hf = self.he, self.hf
        nf = NpField(hf)
        ne = NpExt(nf, he)
        Q, D = len(indices), he.D
        idx = np.asarray(indices, np.uint64)

        def stack_rows(get, width, what):
            try:
                rows = np.stack([np.asarray(get(qp), np.uint64) for qp in proof.query_proofs])
            except ValueError:
                raise VerificationError("InvalidProofShape", what) from None
            ensure(rows.ndim == 2 and rows.shape[1] == width, "InvalidProofShape", what)
            return nf.reduce(rows)

        def x_vec(log_size, shift, positions):  # host_x_at over all queries
            g = hf.two_adic_generator(log_size)
            return nf.mul(np.uint64(shift % hf.p), nf.pow_vec(g, reverse_bits_vec(positions, log_size), log_size))

        for qp in proof.query_proofs:
            ensure(len(qp.input_openings) == len(rounds), "InvalidProofShape", "round count")
            ensure(len(qp.commit_openings) == len(betas), "InvalidProofShape", "level count")

        # reduced openings: α-combined (row - opened values) / (x - z) per LDE height
        apow_cache = [he.one]

        def apows(lo, hi):
            while len(apow_cache) < hi:
                apow_cache.append(he.mul(apow_cache[-1], alpha))
            return apow_cache[lo:hi]

        ro: Dict[int, Optional[np.ndarray]] = {}
        offsets: Dict[int, int] = {}
        pending = []  # (log_lde, numerator (Q, D), denominator (Q, D))
        for r, (cap, mats) in enumerate(rounds):
            for m_idx, (log_n, w, pts) in enumerate(mats):
                if not pts:
                    continue
                log_lde = log_n + self.log_blowup
                rows = stack_rows(lambda qp: qp.input_openings[r].opened_rows[m_idx], w, "row width")
                xb = x_vec(log_lde, hf.generator, idx >> np.uint64(log_max - log_lde))
                off = offsets.get(log_lde, 0)
                for z, vals in pts:
                    ensure(len(vals) == w, "InvalidProofShape", "opened values width")
                    ap = apows(off, off + w)
                    amat = np.asarray([[int(c) % hf.p for c in a] for a in ap], np.uint64)  # (w, D)
                    num = nf.sum_axis(nf.mul(rows[:, :, None], amat[None, :, :]), 1)
                    cs = he.zero  # Σ_j α^(off+j)·vals_j
                    for a_, v in zip(ap, vals):
                        cs = he.add(cs, he.mul(a_, v))
                    num = ne.sub(num, ne.of_scalar(cs, (Q,)))
                    pending.append((log_lde, num, ne.sub(ne.from_base_vec(xb), ne.of_scalar(z, (Q,)))))
                    off += w
                offsets[log_lde] = off
                ro.setdefault(log_lde, None)
        if pending:
            denoms = np.concatenate([d for _, _, d in pending])
            ensure(not np.all(denoms == 0, axis=1).any(), "InvalidOpeningArgument", "OOD point on evaluation domain")
            invs = ne.batch_inv(denoms)
            for i, (log_lde, num, _) in enumerate(pending):
                term = ne.mul(num, invs[i * Q : (i + 1) * Q])
                ro[log_lde] = term if ro[log_lde] is None else ne.add(ro[log_lde], term)

        # fold walk
        log_size = log_max_ro
        pos = idx >> np.uint64(log_max - log_max_ro)
        value = ro.get(log_max_ro)
        if value is None:
            value = ne.of_scalar(he.zero, (Q,))
        for l, (beta, a_bits) in enumerate(zip(betas, schedule)):
            A = 1 << a_bits
            vals = stack_rows(lambda qp: qp.commit_openings[l][0], A * D, "fold row width").reshape(Q, A, D)
            sel = vals[np.arange(Q), (pos & np.uint64(A - 1)).astype(np.int64)]
            ensure(np.array_equal(sel, value), "InvalidOpeningArgument", "fold consistency")
            shift = self._shift_at(log_max_ro, log_size)
            value = self._np_fold_block(ne, vals, log_size, shift, pos - (pos & np.uint64(A - 1)), beta)
            log_size -= a_bits
            pos = pos >> np.uint64(a_bits)
            if ro.get(log_size) is not None:
                value = ne.add(value, ro[log_size])

        xf = x_vec(log_size, self._shift_at(log_max_ro, log_size), pos)
        acc = ne.of_scalar(he.zero, (Q,))
        for c in reversed(proof.final_poly):
            acc = ne.add(ne.scale(acc, xf), ne.of_scalar(c, (Q,)))
        ensure(np.array_equal(acc, value), "InvalidOpeningArgument", "final poly mismatch")

    def _np_fold_block(self, ne: NpExt, vals: np.ndarray, log_m: int, shift: int, base, beta) -> np.ndarray:
        """`_host_fold_block` for all queries: (Q, A, D) opened blocks ->
        (Q, D) folded values."""
        nf, hf = ne.nf, self.hf
        half_inv = np.uint64(hf.inv(2))
        beta_v = ne.of_scalar(beta)
        b = np.asarray(base, np.uint64)
        A = vals.shape[1]
        while A > 1:
            g_inv = hf.inv(hf.two_adic_generator(log_m))
            shift_inv = np.uint64(hf.inv(shift))
            outs = []
            for i in range(A // 2):
                inv_x_even = nf.mul(shift_inv, nf.pow_vec(g_inv, reverse_bits_vec(b + np.uint64(2 * i), log_m), log_m))
                s = ne.scale(ne.add(vals[:, 2 * i], vals[:, 2 * i + 1]), half_inv)
                d = ne.scale(ne.sub(vals[:, 2 * i], vals[:, 2 * i + 1]), nf.mul(half_inv, inv_x_even))
                outs.append(ne.add(s, ne.mul(beta_v, d)))
            vals = np.stack(outs, axis=1)
            A //= 2
            log_m -= 1
            shift = hf.mul(shift, shift)
            b = b >> np.uint64(1)
            if A > 1:
                beta_v = ne.mul(beta_v, beta_v)
        return vals[:, 0]

    def _shift_at(self, log_max: int, log_size: int) -> int:
        """LDE shift after folding from log_max to log_size: GENERATOR^(2^k)."""
        return self.hf.exp_power_of_2(self.hf.generator, log_max - log_size)



def _ntt(nf: NpField, a: np.ndarray, root: int) -> np.ndarray:
    """The DFT of the rows of a ((w, n) uint64, natural order) by the n-th
    root of unity `root`: out[:, j] = Σ_k a[:, k]·root^(jk)."""
    n = a.shape[1]
    log_n = n.bit_length() - 1
    x = a[:, reverse_bits_vec(np.arange(n, dtype=np.uint64), log_n).astype(np.int64)].copy()
    hf = nf.host
    half = 1
    while half < n:
        w = np.asarray([hf.pow(root, (n // (2 * half)) * j) for j in range(half)], np.uint64)
        x = x.reshape(x.shape[0], n // (2 * half), 2, half)
        t = nf.mul(x[:, :, 1], w)
        u = x[:, :, 0]
        x = np.stack([nf.add(u, t), nf.sub(u, t)], axis=2).reshape(x.shape[0], n)
        half *= 2
    return x


def lde_bitrev(hf: HostField, mat: np.ndarray, log_blowup: int) -> np.ndarray:
    """The (h·2^log_blowup, w) LDE of an (h, w) natural-order matrix: row i
    holds the column polynomials at GENERATOR·ω^rev(i)."""
    nf = NpField(hf)
    cols = nf.reduce(np.asarray(mat, np.uint64).T)  # (w, h)
    h = cols.shape[1]
    log_h = h.bit_length() - 1
    g = hf.two_adic_generator(log_h)
    coeffs = nf.mul(_ntt(nf, cols, hf.inv(g)), np.uint64(hf.inv(h % hf.p)))
    coeffs = nf.mul(coeffs, np.asarray([hf.pow(hf.generator, k) for k in range(h)], np.uint64))
    big = np.zeros((cols.shape[0], h << log_blowup), np.uint64)
    big[:, :h] = coeffs
    evals = _ntt(nf, big, hf.two_adic_generator(log_h + log_blowup))
    return evals[:, reverse_bits_vec(np.arange(h << log_blowup, dtype=np.uint64), log_h + log_blowup)
                 .astype(np.int64)].T.copy()
