"""Two-adic FRI polynomial commitment scheme over tensors (prover side).

The counterpart of multistark_tpu/pcs.py, with the Fiat-Shamir transcript
on the host throughout:

  commit : coset-LDE every matrix onto GENERATOR·H (blowup B), stored in
           bit-reversed row order, Merkle-committed in one mixed-height tree.
  open   : claimed evaluations by barycentric interpolation on the size-n
           same-shift sub-coset (a stored prefix); reduced openings per LDE
           height  ro_H(x) = Σ -α^off·(u(x) - S_p)/(z_p - x);  FRI commit
           phase (fold pairs with β, commit each level); query phase
           (gather the input trees and fold levels at the sampled indices).

Transcript schedule (same bytes as the JAX package): observe all claimed
values -> sample α -> per fold round (observe cap, grind commit PoW, sample
β) -> observe final poly -> grind query PoW -> sample query indices.

The config's field ops F (base) and E (extension, degree D) carry the
field arithmetic on tensors: K1 or K5 (fields/device.py) and K4 (utils.py);
its hasher the hashing (merkle.py: K3 or K6); slicing, stacking and gathers
are plain tensor indexing.  Scalars the transcript produces (α powers, S_p,
z^n) are computed on the host with the host field, as transcript values.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from .config import CommitmentParameters, FriParameters
from .domains import TwoAdicCoset
from .fields.device import ExtOps, FieldOps
from .fields.host import HostExtField, HostField
from .fields.npref import np_mul, np_powers
from .merkle import BatchOpening, MerkleMmcs, MerkleProverData
from .ntt import NttEngine
from .utils import batch_inv, bit_reverse_indices, field_sum, reverse_bits

ExtVal = Tuple[int, ...]  # host extension element


@dataclass
class PcsProverData:
    mmcs_data: MerkleProverData
    log_trace_heights: List[int]  # degree-bound exponent per matrix
    log_blowup: int

    @property
    def log_max_lde(self) -> int:
        return max(self.log_trace_heights) + self.log_blowup


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


class TwoAdicFriPcs:
    def __init__(
        self,
        F: FieldOps,
        E: ExtOps,
        host_field: HostField,
        host_ext: HostExtField,
        hasher,
        commitment_parameters: CommitmentParameters,
        fri_parameters: FriParameters,
        device,
    ):
        if not 1 <= fri_parameters.max_log_arity <= 4:
            raise ValueError("max_log_arity must be in [1, 4]")
        self.F = F
        self.E = E
        self.hf = host_field
        self.he = host_ext
        self.mmcs = MerkleMmcs(hasher, commitment_parameters.cap_height)
        self.params = commitment_parameters
        self.fri = fri_parameters
        self.device = torch.device(device)
        self.engine = NttEngine(F, host_field, self.device)
        self._x_tables: Dict[tuple, torch.Tensor] = {}

    # -- domains ----------------------------------------------------------
    @property
    def log_blowup(self) -> int:
        return self.params.log_blowup

    def natural_domain_for_degree(self, degree: int) -> TwoAdicCoset:
        assert degree & (degree - 1) == 0
        return TwoAdicCoset(self.hf, degree.bit_length() - 1, 1)

    # -- x tables ---------------------------------------------------------
    def x_table_storage(self, log_n: int, shift: int, inverse: bool = False) -> torch.Tensor:
        """Coset points shift·G^rev(i) in storage (bit-reversed) order, or
        their inverses; host-built once, cached on the device."""
        key = (log_n, shift % self.hf.p, inverse)
        if key not in self._x_tables:
            g = self.hf.two_adic_generator(log_n)
            s = shift
            if inverse:
                g, s = self.hf.inv(g), self.hf.inv(shift)
            tab = np_mul(self.hf, np_powers(self.hf, g, 1 << log_n), s)[bit_reverse_indices(log_n)]
            self._x_tables[key] = self.F.from_np(tab, self.device)
        return self._x_tables[key]

    def x_table_natural(self, log_n: int, shift: int) -> torch.Tensor:
        """Coset points shift·g^i in natural order."""
        key = (log_n, shift % self.hf.p, "nat")
        if key not in self._x_tables:
            g = self.hf.two_adic_generator(log_n)
            tab = np_mul(self.hf, np_powers(self.hf, g, 1 << log_n), shift)
            self._x_tables[key] = self.F.from_np(tab, self.device)
        return self._x_tables[key]

    # -- commit -----------------------------------------------------------
    def _commit_ldes(self, ldes, logs) -> Tuple[np.ndarray, PcsProverData]:
        cap, mdata = self.mmcs.commit(ldes)
        return cap, PcsProverData(mdata, logs, self.log_blowup)

    def commit(self, domains_and_mats) -> Tuple[np.ndarray, PcsProverData]:
        """domains_and_mats: [(TwoAdicCoset, natural-order evals (w, n))].
        LDEs land on GENERATOR·H_{n·B}, bit-reversed."""
        ldes, logs = [], []
        for dom, mat in domains_and_mats:
            shift = self.hf.mul(self.hf.generator, self.hf.inv(dom.shift))
            ldes.append(self.engine.coset_lde_bitrev(mat, dom.log_n, self.log_blowup, shift))
            logs.append(dom.log_n)
        return self._commit_ldes(ldes, logs)

    def commit_from_coeffs(self, coeff_mats) -> Tuple[np.ndarray, PcsProverData]:
        """coeff_mats: [(w, n) natural coefficient matrices].  Commits their
        evaluations on GENERATOR·H_{n·B} directly from the coefficients."""
        ldes, logs = [], []
        for coeffs in coeff_mats:
            log_n = coeffs.shape[-1].bit_length() - 1
            shifted = self.F.mul(coeffs, self.engine.scale_table(log_n, self.hf.generator))
            ldes.append(self.engine.lde_bitrev_from_coeffs(shifted, log_n + self.log_blowup))
            logs.append(log_n)
        return self._commit_ldes(ldes, logs)

    def get_evaluations_on_domain(self, data: PcsProverData, idx: int, domain: TwoAdicCoset):
        """Natural-order evals of matrix `idx` on `domain` (the GENERATOR-
        shifted sub-coset of the LDE): a stored prefix, un-reversed."""
        assert domain.shift == self.hf.generator
        assert domain.log_n <= data.log_trace_heights[idx] + self.log_blowup
        return self.engine.prefix_to_natural(data.mmcs_data.mats[idx], domain.log_n)

    # -- open -------------------------------------------------------------
    def open(self, rounds, challenger):
        """rounds: [(PcsProverData, points_per_matrix: [[ExtVal]])].
        Returns (opened_values[r][m][p] = [ExtVal per column], FriProof).
        Every claimed value is observed before α is sampled
        (TranscriptProfile.fri_observe_claims_before_alpha)."""
        opened = self._claimed_evaluations(rounds)
        for round_vals in opened:
            for mat_vals in round_vals:
                for pt_vals in mat_vals:
                    for v in pt_vals:
                        challenger.observe_ext(v)
        alpha = challenger.sample_ext()
        ro = self._reduced_openings(rounds, opened, alpha)
        caps, commit_datas, commit_pows, final_poly, query_pow, indices, schedule, log_max, log_max_ro = (
            self._commit_phase(rounds, ro, challenger)
        )
        query_proofs = self._query_phase(rounds, commit_datas, indices, schedule, log_max, log_max_ro)
        proof = FriProof(
            commit_caps=caps,
            commit_pow_witnesses=commit_pows,
            final_poly=final_poly,
            query_pow_witness=query_pow,
            query_proofs=query_proofs,
        )
        return opened, proof

    def _claimed_evaluations(self, rounds):
        """Opened values [round][matrix][point] = [host ext value per column]."""
        opened = []
        for data, points_list in rounds:
            round_vals = []
            for m_idx, points in enumerate(points_list):
                if not points:
                    round_vals.append([])
                    continue
                mat = data.mmcs_data.mats[m_idx]
                vals = self._eval_matrix(mat, data.log_trace_heights[m_idx], points)
                round_vals.append([self.E.to_host(v) for v in vals])
            opened.append(round_vals)
        return opened

    def _eval_matrix(self, mat: torch.Tensor, log_n: int, points) -> List[torch.Tensor]:
        """Barycentric evaluation of a stored bit-reversed LDE at each point:
        p(z) = (z^n - s^n)/(n·s^n) · Σ_i e_i·x_i/(z - x_i) over the size-n
        same-shift sub-coset.  Returns one (D, w) tensor per point."""
        F, E, hf, he = self.F, self.E, self.hf, self.he
        small = self.engine.prefix_to_natural(mat, log_n)  # (w, n) on GEN·H_n
        n = 1 << log_n
        s = hf.generator
        x = self.x_table_natural(log_n, s)
        s_n = hf.pow(s, n)
        inv_ns = hf.inv(hf.mul(n % hf.p, s_n))
        out = []
        for z in points:
            w_i = E.scale(batch_inv(_ext_minus_base(F, E, z, x), E), x)
            zn = z
            for _ in range(log_n):
                zn = he.square(zn)
            c = he.scale(he.sub(zn, he.from_base(s_n)), inv_ns)
            acc = torch.stack([field_sum(F.mul(small, w_i[d]), F) for d in range(E.D)])  # (D, w)
            out.append(E.mul(acc, E.const(c, self.device)))
        return out

    def _reduced_openings(self, rounds, opened, alpha) -> Dict[int, torch.Tensor]:
        """Per LDE height, Σ_p (-α^{off_p})·(u - S_p)/(z_p - x) over the
        stored LDEs, with u = Σ_j α^j·col_j and S_p = Σ_j α^j·v_{p,j}.
        1/(z_p - x) depends only on (height, point), so it is computed once
        per pair and shared by every matrix of that height."""
        F, E, he = self.F, self.E, self.he
        ro: Dict[int, torch.Tensor] = {}
        offsets: Dict[int, int] = {}
        inv_diffs: Dict[tuple, torch.Tensor] = {}
        for (data, points_list), round_vals in zip(rounds, opened):
            for m_idx, points in enumerate(points_list):
                if not points:
                    continue
                mat = data.mmcs_data.mats[m_idx]
                w = data.mmcs_data.dims[m_idx][0]
                log_lde = data.log_trace_heights[m_idx] + self.log_blowup
                apows = self._host_ext_powers(alpha, w)
                u = None
                for j in range(w):
                    term = E.scale(E.const(apows[j], self.device), mat[j])
                    u = term if u is None else E.add(u, term)
                x_full = self.x_table_storage(log_lde, self.hf.generator)
                off = offsets.get(log_lde, 0)
                for p_idx, z in enumerate(points):
                    s_p = he.zero
                    for a, v in zip(apows, round_vals[m_idx][p_idx]):
                        s_p = he.add(s_p, he.mul(a, v))
                    if (log_lde, z) not in inv_diffs:
                        inv_diffs[log_lde, z] = batch_inv(_ext_minus_base(F, E, z, x_full), E)
                    inv_diff = inv_diffs[log_lde, z]
                    num = E.sub(u, E.const(s_p, self.device))
                    aoff = he.neg(he.pow(alpha, off + p_idx * w))
                    contrib = E.mul(E.mul(num, inv_diff), E.const(aoff, self.device))
                    ro[log_lde] = contrib if log_lde not in ro else E.add(ro[log_lde], contrib)
                offsets[log_lde] = off + w * len(points)
        return ro

    def _commit_phase(self, rounds, ro, challenger):
        """FRI commit phase on the host transcript: fold with per-round β,
        committing each level."""
        log_max = max(data.log_max_lde for data, _ in rounds)  # query index range
        log_max_ro = max(ro.keys())  # fold start (tallest matrix WITH openings)
        log_final = self.log_blowup + self.fri.log_final_poly_len
        # deterministic arity schedule (mirrored by the verifier): arity per
        # round capped so we never fold below the final size and never skip
        # an input height that must be absorbed
        schedule: List[int] = []
        ls = log_max_ro
        while ls > log_final:
            a_bits = min(self.fri.max_log_arity, ls - log_final)
            for h in ro:
                if ls - a_bits < h < ls:
                    a_bits = ls - h
            schedule.append(a_bits)
            ls -= a_bits
        caps: List[np.ndarray] = []
        commit_datas: List[MerkleProverData] = []
        commit_pows: List[int] = []
        current = ro[log_max_ro]
        log_size = log_max_ro
        for r, a_bits in enumerate(schedule):
            cap, mdata = self.mmcs.commit([_fold_rows(current, a_bits)])
            caps.append(cap)
            commit_datas.append(mdata)
            challenger.observe_commitment(cap)
            commit_pows.append(challenger.grind(self.fri.commit_proof_of_work_bits))
            beta = challenger.sample_ext()
            shift = self._shift_at(log_max_ro, log_size)
            current = self._fold_multi(current, beta, log_size, a_bits, shift)
            log_size -= a_bits
            if log_size in ro:
                current = self.E.add(current, ro[log_size])
        final_poly, query_pow, indices = self._commit_tail(current, log_size, log_max_ro, log_max, challenger)
        return caps, commit_datas, commit_pows, final_poly, query_pow, indices, schedule, log_max, log_max_ro

    def _commit_tail(self, current, log_size, log_max_ro, log_max, challenger):
        """Observe the final poly, grind the query PoW, sample the query
        indices."""
        final_poly = self._final_poly_host(current, log_size, log_max_ro)
        for c in final_poly:
            challenger.observe_ext(c)
        query_pow = challenger.grind(self.fri.query_proof_of_work_bits)
        indices = [challenger.sample_bits(log_max) for _ in range(self.fri.num_queries)]
        return final_poly, query_pow, indices

    def _fold_multi(self, current, beta: ExtVal, log_size: int, a_bits: int, shift: int) -> torch.Tensor:
        """Arity-2^a fold as a chain of pair folds with β, β², β⁴, ...
        Each pair step: (v_even+v_odd)/2 + β_s·(v_even-v_odd)/(2x)."""
        F, E, hf, he = self.F, self.E, self.hf, self.he
        half_inv = F.const(hf.inv(2), self.device)
        beta_s = beta
        for s in range(a_bits):
            inv_x = self.x_table_storage(log_size - s, hf.exp_power_of_2(shift, s), inverse=True)
            a, b = current[:, 0::2], current[:, 1::2]
            sm = E.scale(E.add(a, b), half_inv)
            df = E.scale(E.sub(a, b), F.mul(inv_x[0::2], half_inv))
            current = E.add(sm, E.mul(df, E.const(beta_s, self.device)))
            beta_s = he.square(beta_s)
        return current

    def _final_poly_host(self, current, log_size: int, log_max_ro: int) -> List[ExtVal]:
        """Host iDFT of the remaining (tiny) fold vector -> coefficients.
        Degree < 2^log_final_poly_len for honest provers."""
        he, hf = self.he, self.hf
        n = 1 << log_size
        evals = self.E.to_host(current)
        nat = [he.zero] * n
        for i in range(n):
            nat[reverse_bits(i, log_size)] = evals[i]
        shift = self._shift_at(log_max_ro, log_size)
        g = hf.two_adic_generator(log_size)
        n_inv = hf.inv(n % hf.p)
        coeffs = []
        for j in range(n):
            acc = he.zero
            g_mj = hf.pow(hf.inv(g), j)
            xp = 1
            for i in range(n):
                acc = he.add(acc, he.scale(nat[i], xp))
                xp = hf.mul(xp, g_mj)
            coeffs.append(he.scale(acc, hf.mul(n_inv, hf.pow(hf.inv(shift), j))))
        keep = 1 << self.fri.log_final_poly_len
        for c in coeffs[keep:]:
            if not he.is_zero(c):
                raise AssertionError("final poly degree too high (prover bug)")
        return coeffs[:keep]

    def _query_phase(self, rounds, commit_datas, indices, arities, log_max, log_max_ro):
        """Open the input trees and the fold levels at the sampled indices:
        every tree's gathers in one device-to-host transfer."""
        nq = len(indices)
        round_idxs = [[i >> (log_max - data.log_max_lde) for i in indices] for data, _ in rounds]
        level_idxs = []
        drop = log_max - log_max_ro
        bits_before = 0
        for level in range(len(commit_datas)):
            level_idxs.append([(i >> (drop + bits_before)) >> arities[level] for i in indices])
            bits_before += arities[level]
        datas = [data.mmcs_data for data, _ in rounds] + list(commit_datas)
        fetched = self.mmcs.gather_many(datas, round_idxs + level_idxs)
        openings = [self.mmcs.assemble(d, nq, f) for d, f in zip(datas, fetched)]
        per_round, per_level = openings[: len(rounds)], openings[len(rounds):]
        return [
            QueryProof(
                input_openings=[pr[qi] for pr in per_round],
                commit_openings=[(pl[qi].opened_rows[0], pl[qi].path) for pl in per_level],
            )
            for qi in range(nq)
        ]

    # -- helpers ----------------------------------------------------------
    def _shift_at(self, log_max: int, log_size: int) -> int:
        """LDE shift after folding from log_max to log_size: GENERATOR^(2^k)."""
        return self.hf.exp_power_of_2(self.hf.generator, log_max - log_size)

    def _host_ext_powers(self, alpha: ExtVal, count: int) -> List[ExtVal]:
        out = [self.he.one]
        for _ in range(1, count):
            out.append(self.he.mul(out[-1], alpha))
        return out


def _ext_minus_base(F: FieldOps, E: ExtOps, z: ExtVal, x: torch.Tensor) -> torch.Tensor:
    """Host ext scalar z minus a base vector x -> (D, n) ext tensor."""
    c0 = F.sub(F.const(z[0], x.device), x)
    return torch.stack([c0] + [F.const(z[d], x.device).expand_as(c0) for d in range(1, E.D)])


def _fold_rows(vec: torch.Tensor, a_bits: int) -> torch.Tensor:
    """A (D, N) ext vector as the (A·D, N/A) base matrix a fold level
    commits: row (j·D + d) = coordinate d of vec[j::A] (flatten_to_base)."""
    A, D = 1 << a_bits, vec.shape[0]
    return vec.reshape(D, -1, A).permute(2, 0, 1).reshape(D * A, -1).contiguous()
