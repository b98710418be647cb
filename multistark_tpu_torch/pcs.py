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

A commit follows a plan made on the host from the shapes alone
(`commit_plan`): per LDE height, each matrix's iDFT runs K2 passes (several
stages per launch) above a tile and K14 (commit_tile.lde_tile, no hashing)
for the tile's stages; the height's matrices are stacked, K2 passes run the
forward DIF's stages above the tile, and one K14 launch runs the tile's
stages, hashes the leaves and folds the lowest tree levels in shared
memory, injecting the shorter heights' leaf digests (from their own K14
launches); K15 (commit_tile.merkle_levels) folds the levels above, up to
the cap, in one launch.

The config's field ops F (base) and E (extension, degree D) carry the
field arithmetic on tensors: K1 or K5 (fields/device.py) and K4 (utils.py);
its hasher the hashing of the trees that are not LDE commits (merkle.py: K3
or K6 leaves, K15 levels).  The claimed evaluations run
K12 per trace height (`bary_eval_height` below) and the reduced openings
K13 per LDE height (`reduced_open_height`), each for all of the height's
matrices and points, both in
csrc/open_reduce.cu, and each fold round K10 (csrc/fri_fold.cu,
`fri_fold_level`: the fold written straight into the next level's matrix
and, for BLAKE3, its leaves); slicing, stacking and gathers are plain
tensor indexing.  Opening points and α are device extension scalars ((D,)
tensors), whether they came from the host challenger or the device duplex,
so the same code serves both transcripts.

A FRI level's tree: the first level's matrix and leaves by K3's FRI entry
(BLAKE3) or K10's layout and K6 (Poseidon2), every later level's by the
round's K10 launch, the levels above the leaves by K15.  With a
Goldilocks/BLAKE3 byte challenger the FRI commit phase runs its rounds on
the device (K8 grinds and samples β from the duplex digest, K10 folds with
it into the next level, K15 commits it) and syncs once at the end; the
host challenger then replays the rounds from the fetched caps, witnesses and
βs and stays the authority (`replay_commit_phase_host`).  Other challengers
take the host loop, one β per round.

Under an active mesh (parallel.use_mesh) with D ranks, at the JAX package's
thresholds: a matrix whose LDE has >= D² rows takes the sharded LDE and
every tree with a matrix of >= D rows the sharded commit (`_commit_sharded`);
the claimed evaluations gather each stored prefix and run K12 replicated;
the reduced opening of a height of >= D rows runs K13 on the rank's blocks
(`_ro_sharded`, no collective); a FRI round keeps its vector sharded while
it has >= D² positions and its fold >= D (`_fri_layout`), its tree then
sharded too; the query openings come from the ranks that own the leaves
(merkle.py).  Caps, grinds and the final polynomial are replicated.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import device_transcript as dt
from . import kernels, parallel
from .challenger import SerializingChallenger64
from .commit_tile import WARP_LOG, lde_tile, merkle_levels, tile_log_for
from .config import CommitmentParameters, FriParameters
from .domains import TwoAdicCoset
from .fields.device import ExtOps, FieldOps
from .fields.host import HostExtField, HostField
from .fields.npref import np_mul, np_powers
from .merkle import BatchOpening, Blake3FieldHasher, MerkleMmcs, MerkleProverData, digest_layer_to_np
from .ntt import NttEngine
from .utils import (batch_inv, bit_reverse_indices, ext_powers_device, fetch, field_sum_plain, fold_rows, reverse_bits,
                    scratch, to_device)

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


@dataclass(frozen=True)
class CommitGroup:
    """The matrices of one LDE height in a commit, and how their transforms
    and tree split between K2, K14 and K15."""

    members: Tuple[int, ...]  # positions in the commit's matrix list
    cols: int  # their widths summed: the columns of one K14 row
    log_n: int  # the trace height: each member's iDFT (or coefficient count)
    log_lde: int
    idft_tile: int  # K14's tile (no hashing) of each member's iDFT: K2 passes run the log_n - idft_tile stages above
    tile: int  # K14's tile of the forward DIF, hashed: K2 passes run the log_lde - tile stages above
    levels: int  # tree levels K14 folds inside its tiles (the tallest group; 0 for the others)
    inject_level: int  # the tree level its leaf digests are injected at (0 for the tallest group)


def commit_plan(widths: Sequence[int], logs: Sequence[int], log_blowup: int, cap_height: int,
                tile_log: Optional[int] = None) -> List[CommitGroup]:
    """A commit's groups, tallest first, from the matrices' widths and log
    heights alone.  By default each K14 tile is commit_tile.tile_log_for's
    and the tallest group's K14 folds the levels that keep a warp busy
    (tile - WARP_LOG, at most the tree's depth); tile_log forces every tile
    (capped at its height) and folds the whole tile, so that small heights
    reach every injection geometry.  K15 folds the rest, up to the cap."""
    by_log: Dict[int, List[int]] = {}
    for i, ln in enumerate(logs):
        by_log.setdefault(ln, []).append(i)
    log_max = max(logs) + log_blowup
    groups = []
    for ln in sorted(by_log, reverse=True):
        members = tuple(by_log[ln])
        cols = sum(widths[i] for i in members)
        lde = ln + log_blowup
        if tile_log is None:
            idft_tile = tile_log_for(max(widths[i] for i in members), ln, hashed=False)
            tile = tile_log_for(cols, lde, hashed=True)
            in_tile = max(tile - WARP_LOG, 0)
        else:
            idft_tile, tile = min(tile_log, ln), min(tile_log, lde)
            in_tile = tile
        levels = min(in_tile, log_max - cap_height) if lde == log_max else 0
        groups.append(CommitGroup(members, cols, ln, lde, idft_tile, tile, levels, log_max - lde))
    return groups


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
    def x_table_storage(self, log_n: int, shift: int) -> torch.Tensor:
        """Coset points shift·G^rev(i) in storage (bit-reversed) order;
        host-built once, cached on the device."""
        key = (log_n, shift % self.hf.p)
        if key not in self._x_tables:
            g = self.hf.two_adic_generator(log_n)
            tab = np_mul(self.hf, np_powers(self.hf, g, 1 << log_n), shift)[bit_reverse_indices(log_n)]
            self._x_tables[key] = self.F.from_np(tab, self.device)
        return self._x_tables[key]

    def inv_x_even(self, log_n: int, shift: int) -> torch.Tensor:
        """The inverses of the even entries of x_table_storage(log_n, shift),
        1/x_2m for m < 2^(log_n - 1): what a FRI fold's first step reads (K10
        squares them for the later steps, x_{s+1}[m] = x_s[2m]²).  Entry 2m
        of the bit-reversed table is G^rev(m) over log_n - 1 bits.
        Host-built once, cached on the device."""
        key = (log_n, shift % self.hf.p, "inverse even")
        if key not in self._x_tables:
            hf = self.hf
            g_inv, s_inv = hf.inv(hf.two_adic_generator(log_n)), hf.inv(shift)
            tab = np_mul(hf, np_powers(hf, g_inv, 1 << (log_n - 1)), s_inv)[bit_reverse_indices(log_n - 1)]
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
    def _commit(self, mats, specs, from_coeffs: bool, tile_log: Optional[int]) -> Tuple[torch.Tensor, PcsProverData]:
        """Every matrix's LDE on GENERATOR·H_{n·B}, stored bit-reversed, and
        their mixed-height tree, by the plan `commit_plan` makes from the
        shapes: per height group K2 passes above the tile, then one K14
        launch for the tile's stages, the leaves and the lowest levels; K15
        for the levels above.  specs: [(log_n, shift)] per matrix.  No sync.  Under
        a mesh whose size the tallest LDE reaches: `_commit_sharded`."""
        F, eng, hasher, b = self.F, self.engine, self.mmcs.hasher, self.log_blowup
        logs = [ln for ln, _ in specs]
        pm = parallel.current_mesh()
        if pm is not None and (1 << (max(logs) + b)) >= pm.n:
            return self._commit_sharded(pm, mats, specs, from_coeffs)
        self.mmcs.check_heights([1 << (ln + b) for ln in logs])
        plan = commit_plan([int(m.shape[0]) for m in mats], logs, b, self.mmcs.cap_height, tile_log)
        ldes: List[torch.Tensor] = [None] * len(mats)
        inject: Dict[int, torch.Tensor] = {}  # tree level -> leaf digests of the shorter rows injected there
        for g in reversed(plan):  # the shorter groups first: the tallest group's tree injects their leaves
            parts = []
            for i in g.members:
                ln, shift = specs[i]
                if from_coeffs:  # the shift scale comes before the zero pad
                    parts.append(eng.zero_extend(F.mul(mats[i], eng.scale_table(ln, shift)), g.log_lde))
                else:
                    parts.append(eng.coset_extend(mats[i], ln, b, shift, g.idft_tile))
            x = parts[0] if len(parts) == 1 else torch.cat(parts)
            eng.dif_above_(x, g.log_lde, g.tile, inverse=False)
            below = {lv: d for lv, d in inject.items() if lv <= g.levels} if g is plan[0] else {}
            layers = lde_tile(F, hasher, x, g.tile, eng.tail_table(g.tile, False), g.levels, below)
            if g is not plan[0]:
                inject[g.inject_level] = layers[0]
            off = 0
            for i in g.members:
                ldes[i] = x[off : off + mats[i].shape[0]]
                off += mats[i].shape[0]
        top = plan[0]  # the loop's last group: `layers` holds its leaves and in-tile levels
        above = {lv - top.levels: d for lv, d in inject.items() if lv > top.levels}
        layers += merkle_levels(hasher, layers[-1], top.log_lde - self.mmcs.cap_height - top.levels, above)
        mdata = MerkleProverData(mats=ldes, dims=[(int(m.shape[0]), int(m.shape[1])) for m in ldes], layers=layers,
                                 log_max=top.log_lde)
        return layers[-1], PcsProverData(mdata, logs, b)

    def _commit_sharded(self, pm, mats, specs, from_coeffs: bool) -> Tuple[torch.Tensor, PcsProverData]:
        """The commit under a mesh (JAX pcs.py:225-262, 328-332), per matrix:
        an LDE of >= D² rows through the sharded LDE (this rank's block);
        a shorter one through the single-device transforms (K2 + K14), then
        its block taken if it has >= D rows; then the sharded tree."""
        F, eng, b = self.F, self.engine, self.log_blowup
        self.mmcs.check_heights([1 << (ln + b) for ln, _ in specs])
        ldes, heights = [], []
        for m, (ln, shift) in zip(mats, specs):
            big = ln + b
            if from_coeffs:
                m = F.mul(m, eng.scale_table(ln, shift))
            if (1 << big) >= pm.n * pm.n:
                if from_coeffs:
                    lde = parallel.sharded_lde_bitrev_from_coeffs(eng, pm, m, big)
                else:
                    lde = parallel.sharded_coset_lde_bitrev(eng, pm, m, ln, b, shift)
            else:
                lde = eng.lde_bitrev_from_coeffs(m, big) if from_coeffs else eng.coset_lde_bitrev(m, ln, b, shift)
                if (1 << big) >= pm.n:
                    lde = parallel.shard_rows(pm, lde)
            ldes.append(lde)
            heights.append(1 << big)
        cap, mdata = parallel.sharded_mmcs_commit(self.mmcs, pm, ldes, heights)
        return cap, PcsProverData(mdata, [ln for ln, _ in specs], b)

    def commit_device(self, domains_and_mats, tile_log: Optional[int] = None) -> Tuple[torch.Tensor, PcsProverData]:
        """domains_and_mats: [(TwoAdicCoset, natural-order evals (w, n))].
        LDEs land on GENERATOR·H_{n·B}, bit-reversed.  The cap stays a
        device (2^cap_height, 8) int32 tensor.  tile_log forces K14's tile
        (tests; default: the largest that fits)."""
        mats, specs = [], []
        for dom, mat in domains_and_mats:
            mats.append(mat)
            specs.append((dom.log_n, self.hf.mul(self.hf.generator, self.hf.inv(dom.shift))))
        return self._commit(mats, specs, False, tile_log)

    def commit(self, domains_and_mats, tile_log: Optional[int] = None) -> Tuple[np.ndarray, PcsProverData]:
        """`commit_device` with the cap fetched as (2^cap_height, 8) uint32."""
        cap, data = self.commit_device(domains_and_mats, tile_log)
        return digest_layer_to_np(cap), data

    def commit_from_coeffs_device(self, coeff_mats,
                                  tile_log: Optional[int] = None) -> Tuple[torch.Tensor, PcsProverData]:
        """coeff_mats: [(w, n) natural coefficient matrices].  Commits their
        evaluations on GENERATOR·H_{n·B} directly from the coefficients; the
        cap stays on the device."""
        specs = [(c.shape[-1].bit_length() - 1, self.hf.generator) for c in coeff_mats]
        return self._commit(list(coeff_mats), specs, True, tile_log)

    def commit_from_coeffs(self, coeff_mats, tile_log: Optional[int] = None) -> Tuple[np.ndarray, PcsProverData]:
        cap, data = self.commit_from_coeffs_device(coeff_mats, tile_log)
        return digest_layer_to_np(cap), data

    # -- open -------------------------------------------------------------
    def open(self, rounds, challenger):
        """rounds: [(PcsProverData, points_per_matrix: [[ExtVal]])] with
        host points.  Returns (opened_values[r][m][p] = [ExtVal per column],
        FriProof).  Every claimed value is observed before α is sampled
        (TranscriptProfile.fri_observe_claims_before_alpha)."""
        consts = {}
        dev_rounds = [
            (data, [[(z, consts.setdefault(z, self.E.const(z, self.device))) for z in pts] for pts in points_list])
            for data, points_list in rounds
        ]
        vals = self._claimed_evaluations(dev_rounds)
        opened = opened_to_host(vals)
        for round_vals in opened:
            for mat_vals in round_vals:
                for pt_vals in mat_vals:
                    for v in pt_vals:
                        challenger.observe_ext(v)
        alpha = challenger.sample_ext()
        ro = self._reduced_openings(dev_rounds, vals, self.E.const(alpha, self.device))
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
        """rounds: [(PcsProverData, [[(key, z (D,) device point)] per
        matrix])].  Returns [round][matrix] = one (D, w) device tensor per
        point.  The matrices are grouped by trace height, across rounds, as
        the JAX package merges them (_eval_all_kern), and each height is
        evaluated at once (`_eval_height`: one K12 launch for all of its
        matrices and points)."""
        heights: Dict[int, list] = {}  # log_n -> [(round, matrix, stored LDE or gathered prefix, its points)]
        out = [[[] for _ in points_list] for _, points_list in rounds]
        for r_idx, (data, points_list) in enumerate(rounds):
            for m_idx, points in enumerate(points_list):
                if not points:
                    continue
                log_n = data.log_trace_heights[m_idx]
                mat = data.mmcs_data.mats[m_idx]
                if data.mmcs_data.is_block(m_idx):  # the stored prefix, gathered (JAX pcs.py:521-560)
                    mat = parallel.whole_prefix(data.mmcs_data, m_idx, 1 << log_n, "evals")
                heights.setdefault(log_n, []).append((r_idx, m_idx, mat, points))
        for log_n, members in heights.items():
            keys = list({key: (key, z) for *_, points in members for key, z in points}.values())
            index = {key: i for i, (key, _) in enumerate(keys)}
            vals = self._eval_height(log_n, [mat for _, _, mat, _ in members],
                                     [[index[key] for key, _ in points] for *_, points in members], keys)
            for (r_idx, m_idx, _, _), v in zip(members, vals):
                out[r_idx][m_idx] = v
        return out

    def _eval_height(self, log_n: int, mats, openings, points) -> List[List[torch.Tensor]]:
        """Barycentric evaluation of the stored bit-reversed LDEs of one trace
        height at their device points: p(z) = (z^n - s^n)/(n·s^n) ·
        Σ_i e_i·x_i/(z - x_i) over the size-n same-shift sub-coset, the
        stored prefix, read in its storage order.  points: the height's
        (key, (D,) tensor) pairs; openings[m]: matrix m's points as indices
        into them.  1/(z - x) comes from one K4 batch inverse for all the
        points, the rest from K12 (`bary_eval_height`).  Returns [matrix]
        [its point] (D, w) tensors."""
        hf = self.hf
        n = 1 << log_n
        inv: dict = {}
        self._inverse_diffs(log_n, points, inv)
        s_n = hf.pow(hf.generator, n)
        inv_ns = hf.inv(hf.mul(n % hf.p, s_n))
        return bary_eval_height(self.E, mats, log_n, openings, [z for _, z in points],
                                [inv[log_n, key] for key, _ in points], self.x_table_storage(log_n, hf.generator),
                                s_n, inv_ns)

    def _reduced_openings(self, rounds, vals, alpha: torch.Tensor) -> Dict[int, torch.Tensor]:
        """Per LDE height, Σ_p (-α^{off_p})·(u - S_p)/(z_p - x) over the
        stored LDEs, with u = Σ_j α^j·col_j and S_p = Σ_j α^j·v_{p,j}, for a
        device α; rounds as `_claimed_evaluations` takes them, vals as it
        returns them.  One `reduced_open_height` per height (K13: a scalar
        launch and a row launch) for all of its matrices and points, as the
        JAX package merges them.  1/(z_p - x) depends only on (height,
        point): one batch inverse per height for all of its points."""
        heights: Dict[int, list] = {}  # log_lde -> [(matrix, its (key, z) points, its (offset, (D, w) values))]
        offsets: Dict[int, int] = {}
        widths = []
        for r_idx, (data, points_list) in enumerate(rounds):
            for m_idx, points in enumerate(points_list):
                if not points:
                    continue
                w = data.mmcs_data.dims[m_idx][0]
                log_lde = data.log_trace_heights[m_idx] + self.log_blowup
                off = offsets.get(log_lde, 0)
                opened = [(off + p_idx * w, v) for p_idx, v in enumerate(vals[r_idx][m_idx])]
                heights.setdefault(log_lde, []).append((data.mmcs_data.mats[m_idx], points, opened))
                offsets[log_lde] = off + w * len(points)
                widths.append(w)
        if not heights:
            return {}
        apows = ext_powers_device(self.E, alpha, max(max(widths), max(offsets.values()))).contiguous()  # (D, count)
        pm = parallel.current_mesh()
        inv_diffs: Dict[tuple, torch.Tensor] = {}
        ro: Dict[int, torch.Tensor] = {}
        for log_lde, members in heights.items():
            keys = list({key: (key, z) for _, points, _ in members for key, z in points}.values())
            index = {key: i for i, (key, _) in enumerate(keys)}
            openings = [[(index[key], off, v) for (key, _), (off, v) in zip(points, opened)]
                        for _, points, opened in members]
            mats = [mat for mat, _, _ in members]
            x = None
            if pm is not None and (1 << log_lde) >= pm.n:
                mats, x = self._ro_sharded(pm, log_lde, mats)
            self._inverse_diffs(log_lde, keys, inv_diffs, x=x)
            ro[log_lde] = reduced_open_height(self.E, mats, apows, openings,
                                              [inv_diffs[log_lde, key] for key, _ in keys])
        return ro

    def _ro_sharded(self, pm, log_lde: int, mats) -> Tuple[list, torch.Tensor]:
        """A height's reduced opening on this rank's block of its LDEs (JAX
        pcs.py:696): the matrices' blocks and the block's x, over which
        1/(z - x) is a block-local K4 batch inverse (inverses are
        elementwise, so the values are the single-device ones), then K13 on
        the block, no collective.  A replicated matrix (the preprocessed one,
        committed at setup) contributes the block it slices.  The result
        stays block-sharded."""
        parallel.SHARDED_CALLS["ro_sharded"] += 1
        mats = [parallel.shard_rows(pm, m) if m.shape[1] == 1 << log_lde else m for m in mats]
        return mats, parallel.shard_rows(pm, self.x_table_storage(log_lde, self.hf.generator))

    def _inverse_diffs(self, log_n: int, points, cache: dict, x: Optional[torch.Tensor] = None) -> None:
        """Cache under (log_n, key) 1/(z - x) over the 2^log_n-point coset
        GENERATOR·H in storage order (or over the given part x of it), as a
        contiguous (D, len(x)) tensor, for each (key, z) of points not cached
        yet: all of them in one batch inverse."""
        F, E = self.F, self.E
        todo = [(key, z) for key, z in points if (log_n, key) not in cache]
        if not todo:
            return
        if x is None:
            x = self.x_table_storage(log_n, self.hf.generator)
        inv = batch_inv(_ext_minus_base(F, E, torch.stack([z for _, z in todo], dim=1), x), E)  # (D, P, n)
        inv = inv.transpose(0, 1).contiguous()  # (P, D, n): each point's rows contiguous
        for i, (key, _) in enumerate(todo):
            cache[log_n, key] = inv[i]

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

    def _commit_phase(self, rounds, ro, challenger):
        """FRI commit phase: the device rounds where the challenger allows
        them (one sync, then the host replay), else the host loop; then the
        transcript tail."""
        log_max = max(data.log_max_lde for data, _ in rounds)  # query index range
        log_max_ro = max(ro.keys())  # fold start (tallest matrix WITH openings)
        schedule = self.fri_schedule(ro.keys(), log_max_ro)
        result = None
        if schedule and self._device_transcript_eligible(challenger):
            result = self._commit_phase_device(ro, schedule, log_max_ro, challenger)
        if result is None:
            result = self._commit_phase_host(ro, schedule, log_max_ro, challenger)
        caps, commit_datas, commit_pows, current, log_size = result
        if current.shape[-1] != 1 << log_size:  # a block: the final polynomial is replicated
            current = parallel.gather_blocks(parallel.current_mesh(), current, "fri")
        final_poly, query_pow, indices = self._commit_tail(
            self.E.to_host(current), log_size, log_max_ro, log_max, challenger
        )
        return caps, commit_datas, commit_pows, final_poly, query_pow, indices, schedule, log_max, log_max_ro

    def _commit_phase_host(self, ro, schedule, log_max_ro, challenger):
        """One host-transcript round per fold: observe the level's cap, grind,
        sample β, fold into the next level and commit it."""
        caps: List[np.ndarray] = []
        commit_datas: List[MerkleProverData] = []
        commit_pows: List[int] = []
        log_size = log_max_ro
        if not schedule:
            return caps, commit_datas, commit_pows, ro[log_max_ro], log_size
        level, cap_d, mdata = self._fri_level(ro[log_max_ro], log_size, schedule[0])
        for r, a_bits in enumerate(schedule):
            cap = digest_layer_to_np(cap_d)
            caps.append(cap)
            commit_datas.append(mdata)
            challenger.observe_commitment(cap)
            commit_pows.append(challenger.grind(self.fri.commit_proof_of_work_bits))
            beta = self.E.const(challenger.sample_ext(), self.device)
            next_a = schedule[r + 1] if r + 1 < len(schedule) else 0
            level, cap_d, mdata = self._fri_round(level, beta, log_size, a_bits, next_a, log_max_ro,
                                                  ro.get(log_size - a_bits))
            log_size -= a_bits
        return caps, commit_datas, commit_pows, level, log_size

    def _device_transcript_eligible(self, challenger) -> bool:
        """The device rounds replicate the BLAKE3 byte duplex of a
        Goldilocks SerializingChallenger64 over BLAKE3 trees, for D <= 3 (β's
        coordinates fit one digest after the grind draw) and a word-aligned
        input buffer."""
        return (
            isinstance(challenger, SerializingChallenger64)
            and isinstance(self.mmcs.hasher, Blake3FieldHasher)
            and self.hf.p == dt.GOLDILOCKS_P
            and 1 <= self.E.D <= 3
            and len(challenger.inner.input_buffer) % 4 == 0
        )

    def _commit_phase_device(self, ro, schedule, log_max_ro, challenger):
        """The device rounds from the challenger's state, one fetch of every
        cap, witness, β and flag, then the host replay; None (counted in
        device_transcript.FALLBACKS) when the replay cannot adopt them."""
        entry = dt.entry_buffer_words(bytes(challenger.inner.input_buffer))
        caps_d, ws, betas, oks, commit_datas, current, log_size = self._commit_phase_device_core(
            ro, schedule, log_max_ro, to_device(entry.view(np.int32), self.device)
        )
        n = len(schedule)
        got = fetch(caps_d + ws + betas + oks)
        try:
            caps, commit_pows = self.replay_commit_phase_host(
                challenger, schedule, got[:n], got[n : 2 * n], got[2 * n : 3 * n], got[3 * n :]
            )
        except dt.Fallback as reason:
            dt.FALLBACKS[str(reason)] += 1
            return None
        return caps, commit_datas, commit_pows, current, log_size

    def _commit_phase_device_core(self, ro, schedule, log_max_ro, chain: torch.Tensor):
        """The FRI rounds on the device, with no sync and no replay (the
        caller owns both): per round, K8 grinds over chain ‖ cap and gives β,
        K10 folds with it (adding the next height's reduced opening) into the
        next level's matrix and leaves, and K15 commits them.  chain: the
        duplex input buffer as int32 words.  Returns (caps, witnesses, βs, ok
        flags, commit datas, the last fold, its log size)."""
        bits = self.fri.commit_proof_of_work_bits
        log_size = log_max_ro
        level, cap, mdata = self._fri_level(ro[log_max_ro], log_size, schedule[0])
        caps, commit_datas = [cap], [mdata]
        ws, betas, oks = [], [], []
        for r, a_bits in enumerate(schedule):
            w, ok, beta, chain = dt.fri_grind(torch.cat([chain, caps[r].reshape(-1)]), bits, self.E.D)
            ws.append(w)
            betas.append(beta)
            oks.append(ok)
            next_a = schedule[r + 1] if r + 1 < len(schedule) else 0
            level, cap, mdata = self._fri_round(level, beta, log_size, a_bits, next_a, log_max_ro,
                                                ro.get(log_size - a_bits))
            log_size -= a_bits
            if cap is not None:
                caps.append(cap)
                commit_datas.append(mdata)
        return caps, ws, betas, oks, commit_datas, level, log_size

    def replay_commit_phase_host(self, challenger, schedule, caps_np, ws_np, betas_np, oks_np):
        """The authoritative host replay of the device rounds from their
        fetched values: observe each cap, check each witness, compare each β
        with the host's draw.  Adopts the replayed challenger state and
        returns (caps, witnesses).  Raises device_transcript.Fallback on a
        round the device could not finish (a grind miss, a draw >= p) and
        device_transcript.TranscriptDivergence on a witness the host rejects
        or a β it draws otherwise; either leaves the challenger as it was."""
        bits = self.fri.commit_proof_of_work_bits
        if not all(int(o) == 1 for o in oks_np):
            raise dt.Fallback("grind miss or non-canonical β draw in a FRI round")
        probe = challenger.clone()
        caps = [np.asarray(c, np.uint32) for c in caps_np]
        commit_pows: List[int] = []
        for r in range(len(schedule)):
            probe.observe_commitment(caps[r])
            w = int(ws_np[r])
            if not probe.check_witness(bits, w):
                raise dt.TranscriptDivergence(f"FRI replay: the host rejects round {r}'s witness {w}")
            host_beta, device_beta = probe.sample_ext(), tuple(int(c) for c in betas_np[r])
            if host_beta != device_beta:
                raise dt.TranscriptDivergence(
                    f"FRI replay: the device drew round {r}'s β = {device_beta}, the host {host_beta}"
                )
            commit_pows.append(w)
        challenger.inner.input_buffer = probe.inner.input_buffer
        challenger.inner.output_buffer = probe.inner.output_buffer
        return caps, commit_pows

    def _commit_tail(self, current_host, log_size, log_max_ro, log_max, challenger):
        """Observe the final poly (from the last fold's host values, storage
        order), grind the query PoW, sample the query indices."""
        final_poly = self._final_poly_host(current_host, log_size, log_max_ro)
        for c in final_poly:
            challenger.observe_ext(c)
        query_pow = challenger.grind(self.fri.query_proof_of_work_bits)
        indices = [challenger.sample_bits(log_max) for _ in range(self.fri.num_queries)]
        return final_poly, query_pow, indices

    def _fri_layout(self, current, log_size: int, a_bits: int):
        """Under a mesh, a block-sharded fold vector of 2^log_size positions
        stays sharded for a round of arity 2^a_bits while it has >= D²
        positions and its fold >= D (each block then folds and commits
        locally: fold partners are adjacent in storage); otherwise one
        all_gather makes it whole.  A whole vector stays whole."""
        pm = parallel.current_mesh()
        if current.shape[-1] == 1 << log_size:
            return current
        if (1 << log_size) >= pm.n * pm.n and (1 << (log_size - a_bits)) >= pm.n:
            return current
        return parallel.gather_blocks(pm, current, "fri")

    def _fri_level(self, vec, log_size: int, a_bits: int):
        """A FRI level from its fold vector (2^log_size positions), committed
        for a round of arity 2^a_bits: (what its round folds, the device cap,
        the tree data).  Whole: the level's (A·D, N/A) matrix and its leaves,
        by K3's FRI entry in one launch (BLAKE3) or by K10 laying the vector
        out and the hasher hashing it (Poseidon2, K6); K15 folds the levels.
        Under a mesh the vector takes `_fri_layout` first, and a block is laid
        out by PyTorch and committed sharded; its round folds the block."""
        vec = self._fri_layout(vec, log_size, a_bits)
        if vec.shape[-1] != 1 << log_size:
            mat = fold_rows(vec, a_bits)
            cap, mdata = parallel.sharded_mmcs_commit(self.mmcs, parallel.current_mesh(), [mat],
                                                      [1 << (log_size - a_bits)])
            return vec, cap, mdata
        hasher = self.mmcs.hasher
        if hasher.hashes_fri_levels:
            mat, leaves = hasher.fri_leaves(vec, a_bits)
        else:
            mat, leaves = fri_fold_level(self.E, vec, None, None, 0, 0, a_bits, hasher=hasher)
        cap, mdata = self.mmcs.commit_leaves([mat], leaves)
        return mat, cap, mdata

    def _fri_round(self, level, beta: torch.Tensor, log_size: int, a_bits: int, next_a: int, log_max_ro: int,
                   absorb=None):
        """One arity-2^a_bits fold round of a level (2^log_size positions)
        with the device β, plus `absorb` (the next height's reduced opening)
        when given, into the next level committed for a round of arity
        2^next_a: (what the next round folds, its device cap, its tree data).
        A level's matrix folds in one K10 launch that writes the next
        level's matrix and (BLAKE3) its leaves; K15 commits them.  With
        next_a = 0 (the last round) the result is the final (D, M) vector
        and no tree.  A whole level's (D, N) vector folds the same way.  A
        block of the level's vector (under a mesh) folds with the block of
        the inverse-x table and the next level takes `_fri_level`; a sharded
        absorb into a whole level is gathered first."""
        E, pm = self.E, parallel.current_mesh()
        inv_x = self.inv_x_even(log_size, self._shift_at(log_max_ro, log_size))
        log_next = log_size - a_bits
        if level.shape[0] == E.D and level.shape[-1] != 1 << log_size:  # a block of the level's vector
            folded = fri_fold(E, level, beta, parallel.shard_rows(pm, inv_x), self.hf.inv(2), a_bits, absorb)
            return (folded, None, None) if not next_a else self._fri_level(folded, log_next, next_a)
        if absorb is not None and absorb.shape[-1] != 1 << log_next:
            absorb = parallel.gather_blocks(pm, absorb, "fri")
        mat, leaves = fri_fold_level(E, level, beta, inv_x, self.hf.inv(2), a_bits, next_a, absorb,
                                     hasher=self.mmcs.hasher if next_a else None)
        if not next_a:
            return mat, None, None
        cap, mdata = self.mmcs.commit_leaves([mat], leaves)
        return mat, cap, mdata

    def _final_poly_host(self, evals, log_size: int, log_max_ro: int) -> List[ExtVal]:
        """Host iDFT of the remaining (tiny) fold vector -> coefficients.
        Degree < 2^log_final_poly_len for honest provers."""
        he, hf = self.he, self.hf
        n = 1 << log_size
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
        idxs = round_idxs + level_idxs
        if any(d.shard is not None for d in datas):
            fetched = self.mmcs.fetch(parallel.gather_openings(self.mmcs, datas, idxs))
        else:
            fetched = self.mmcs.gather_many(datas, idxs)
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


def _ext_minus_base(F: FieldOps, E: ExtOps, z: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A device ext scalar z ((D,)) or points z ((D, P)) minus a base vector
    x ((n,)) -> the (D, n) or (D, P, n) ext tensor z - x_i: one launch of
    the field's kernel, the points a column against x."""
    if z.dim() == 2:
        z = z.reshape(E.D, -1, 1)
    c0 = F.sub(z[0], x)
    return torch.stack([c0] + [z[d].expand_as(c0) for d in range(1, E.D)])


def opened_to_host(vals) -> list:
    """[round][matrix] lists of (D, w) device tensors -> [round][matrix]
    [point] = [ExtVal per column], in one fetch."""
    flat = [v for round_vals in vals for mat_vals in round_vals for v in mat_vals]
    host = iter(fetch(flat))
    return [[[[tuple(int(c) for c in col) for col in next(host).T] for _ in mat_vals] for mat_vals in round_vals]
            for round_vals in vals]


# --- K12 and K13: the opening reductions ------------------------------------------

_MAX_POINTS = 4
_MATS, _PAIRS = 16, 32  # MAX_MATS, MAX_PAIRS in csrc/open_reduce.cu: one K12 or K13 launch's matrices and pairs
_BARY_WEIGHTS = 4096  # BARY_WEIGHTS in csrc/open_reduce.cu: weight words of one K12 tile (P·D·rows)


def _launch_groups(widths_points) -> List[List[int]]:
    """The matrices (by (width, number of points)) split into runs of at most
    _MATS matrices and _PAIRS (matrix, point) pairs: one K12 or K13 launch
    each (one for every height of the bench)."""
    groups, cur, pairs = [], [], 0
    for m, (_, k) in enumerate(widths_points):
        if k > _PAIRS:
            raise ValueError(f"a matrix opened at more than {_PAIRS} points")
        if cur and (len(cur) == _MATS or pairs + k > _PAIRS):
            groups.append(cur)
            cur, pairs = [], 0
        cur.append(m)
        pairs += k
    groups.append(cur)
    return groups


def _carr(ctype, values):
    return ctypes.cast((ctype * len(values))(*values), ctypes.c_void_p)


def bary_eval_height_plain(E: ExtOps, mats, log_n: int, openings, zs, invs, x: torch.Tensor, s_n: int,
                           inv_ns: int) -> List[List[torch.Tensor]]:
    """Plain version of K12 for one trace height: per matrix and each of its
    points p, Σ_i mat[:, i]·x_i·inv_p[i] over the stored prefix i < n, times
    (z_p^n - s^n)·inv_ns."""
    F = E.base
    n = 1 << log_n
    scales = []
    for z in zs:
        zn = z.reshape(E.D, 1)
        for _ in range(log_n):
            zn = E.mul_plain(zn, zn)
        zn = zn.clone()
        zn[0] = F.sub_plain(zn[0], F.const(s_n, zn.device))
        scales.append(E.scale_plain(zn, F.const(inv_ns, zn.device)))
    weights = [E.scale_plain(inv, x) for inv in invs]  # x_i/(z_p - x_i)
    out = []
    for mat, points in zip(mats, openings):
        small = mat[:, :n]
        out.append([E.mul_plain(torch.stack([field_sum_plain(F.mul_plain(small, weights[p][d]), F)
                                             for d in range(E.D)]), scales[p]) for p in points])
    return out


def bary_eval_height(E: ExtOps, mats, log_n: int, openings, zs, invs, x: torch.Tensor, s_n: int,
                     inv_ns: int) -> List[List[torch.Tensor]]:
    """The claimed evaluations of one trace height n = 2^log_n: mats M stored
    LDEs ((w_m, N_m), N_m >= n, rows may be strided; the first n entries of
    a row are the stored prefix), openings[m] matrix m's points as indices
    into zs (P (D,) device points, 1 to 4), invs P (D, n) 1/(z_p - x), x
    (n,) the sub-coset's points in the prefix's storage order, and the
    scale s^n, inv_ns = 1/(n·s^n).  Returns [matrix][its point] (D, w_m)
    tensors.  K12 on a CUDA tensor: one launch per group of up to 16
    matrices and 32 (matrix, point) pairs (one for every height of the
    bench); the plain version on a CPU one."""
    P, n, D = len(zs), 1 << log_n, E.D
    if not 1 <= P <= _MAX_POINTS or len(invs) != P or not mats or len(openings) != len(mats):
        raise ValueError(f"bary_eval_height takes matrices with their openings and 1 to {_MAX_POINTS} points")
    for mat, points in zip(mats, openings):
        if mat.dim() != 2 or mat.shape[1] < n or not points or any(not 0 <= p < P for p in points):
            raise ValueError(f"bary_eval_height: every matrix (w, >= {n}) opened at one of the points")
    if any(tuple(i.shape) != (D, n) for i in invs) or tuple(x.shape) != (n,) or any(z.numel() != D for z in zs):
        raise ValueError(f"bary_eval_height: inverses ({D}, {n}), x ({n},) and points of {D} coordinates")
    if not kernels.use_kernel(mats[0]):
        return bary_eval_height_plain(E, mats, log_n, openings, zs, invs, x, s_n, inv_ns)
    mats = [m if m.stride(1) == 1 else m.contiguous() for m in mats]
    zs = [z.reshape(-1).contiguous() for z in zs]
    invs = [i.contiguous() for i in invs]
    x = x.contiguous()
    kernels.check_cuda(x, *invs, *zs)
    for m in mats:
        if m.device != x.device or m.dtype != torch.int64:
            raise ValueError("bary_eval_height: matrices are int64 on the points' device")
    # tiles of up to _BARY_WEIGHTS / (P·D) rows, fewer where that would leave SMs without a tile
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    log_tile = min((_BARY_WEIGHTS // (P * D)).bit_length() - 1, max(5, (n // sms).bit_length() - 1))
    fid = E.base.field_id
    ip, zp = _carr(ctypes.c_void_p, [t.data_ptr() for t in invs]), _carr(ctypes.c_void_p, [t.data_ptr() for t in zs])
    out: List[List[torch.Tensor]] = []
    for group in _launch_groups([(int(m.shape[0]), len(o)) for m, o in zip(mats, openings)]):
        widths = [int(mats[m].shape[0]) for m in group]
        pairs = [p for m in group for p in openings[m]]
        words = D * sum(w * len(openings[m]) for w, m in zip(widths, group))
        vals = torch.empty(words, dtype=torch.int64, device=x.device)
        kernels.BARY_EVAL.launch(
            "bary_height", fid, _carr(ctypes.c_void_p, [mats[m].data_ptr() for m in group]),
            _carr(ctypes.c_int64, [mats[m].stride(0) for m in group]), _carr(ctypes.c_int, widths),
            _carr(ctypes.c_int, [int(e) for e in np.cumsum([len(openings[m]) for m in group])]), len(group),
            _carr(ctypes.c_int, pairs), len(pairs), ip, kernels.ptr(x), zp, P, n, log_tile, log_n, s_n, inv_ns,
            kernels.ptr(scratch(x).take_counters(x, 1 + 2 * words)), kernels.ptr(vals),
            # each prefix element, inverse word and x read once, the values written; the products
            cost=(8 * (n * (sum(widths) + P * D + 1) + words), n * (words + P * D) * kernels.OPS_PER_MUL[fid]),
        )
        off = 0
        for m, w in zip(group, widths):
            out.append([])
            for _ in openings[m]:
                out[-1].append(vals[off : off + D * w].view(D, w))
                off += D * w
    return out


def reduced_open_plain(E: ExtOps, mat: torch.Tensor, apows: torch.Tensor, vals, invs, offs, ro=None) -> torch.Tensor:
    """Plain version of K13: ro + Σ_p (-α^{off_p})·(u - S_p)·inv_p with
    u = Σ_j α^j·mat[j] and S_p = Σ_j α^j·v_{p,j}."""
    F = E.base
    w = mat.shape[0]
    u = None
    for j in range(w):
        term = E.scale_plain(apows[:, j : j + 1], mat[j])
        u = term if u is None else E.add_plain(u, term)
    total = ro
    for v, inv, off in zip(vals, invs, offs):
        s_p = field_sum_plain(E.mul_plain(v, apows[:, :w]), E).reshape(E.D, 1)
        aoff = F.neg_plain(apows[:, off : off + 1])
        contrib = E.mul_plain(E.mul_plain(E.sub_plain(u, s_p), inv), aoff)
        total = contrib if total is None else E.add_plain(total, contrib)
    return total


def reduced_open_height_plain(E: ExtOps, mats, apows: torch.Tensor, openings, invs, ro=None) -> torch.Tensor:
    """Plain version of K13 for one height: `reduced_open_plain` per matrix,
    summed."""
    for mat, opened in zip(mats, openings):
        ro = reduced_open_plain(E, mat, apows, [v for _, _, v in opened], [invs[p] for p, _, _ in opened],
                                [off for _, off, _ in opened], ro)
    return ro


def reduced_open_height(E: ExtOps, mats, apows: torch.Tensor, openings, invs, ro=None) -> torch.Tensor:
    """The reduced opening of one LDE height, Σ over its matrices m and their
    points p of (-α^{off})·(u_m - S_{m,p})·inv_p (module docstring of
    csrc/open_reduce.cu): mats M (w_m, N) stored LDEs (rows may be strided),
    apows (D, count) the powers α^0 .. α^(count - 1) of one α (the kernel
    weighs a matrix's columns by its first point's -α^{off} and reaches its
    other points by α^{off' - off}), openings[m] matrix m's [(point index, α
    offset, (D, w_m) claimed values)], invs P (D, N) 1/(z_p - x).  Returns
    a new (D, N) tensor, or adds to ro.  K13 on a CUDA tensor: per launch
    group of up to 16 matrices and 32 (matrix, point) pairs (one for the
    bench's heights) one ro_scalars launch and one ro_rows launch, the
    first group writing ro, the others adding to it; the plain version on a
    CPU tensor."""
    P, N = len(invs), mats[0].shape[1] if mats else 0
    if not 1 <= P <= _MAX_POINTS or not mats or len(openings) != len(mats):
        raise ValueError(f"reduced_open_height takes matrices with their openings and 1 to {_MAX_POINTS} points")
    count = apows.shape[1]
    for mat, opened in zip(mats, openings):
        if mat.dim() != 2 or mat.shape[1] != N or mat.shape[0] > count or not opened:
            raise ValueError("reduced_open_height: every matrix (w <= α powers, N rows) opened at a point")
        if any(not 0 <= p < P or not 0 <= off < count or tuple(v.shape) != (E.D, mat.shape[0])
               for p, off, v in opened):
            raise ValueError("reduced_open_height: a point, offset or claimed value does not fit")
    if any(tuple(i.shape) != (E.D, N) for i in invs) or (ro is not None and tuple(ro.shape) != (E.D, N)):
        raise ValueError("reduced_open_height: inverses and ro are (D, N)")
    if not kernels.use_kernel(mats[0]):
        return reduced_open_height_plain(E, mats, apows, openings, invs, ro)
    mats = [m if m.stride(1) == 1 else m.contiguous() for m in mats]
    apows = apows.contiguous()
    invs = [i.contiguous() for i in invs]
    openings = [[(p, off, v.contiguous()) for p, off, v in opened] for opened in openings]
    kernels.check_cuda(apows, *invs, *[v for opened in openings for _, _, v in opened])
    for m in mats:
        if m.device != apows.device or m.dtype != torch.int64:
            raise ValueError("reduced_open_height: matrices are int64 on the α powers' device")
    add = ro is not None
    if not add:
        ro = torch.empty((E.D, N), dtype=torch.int64, device=apows.device)
    else:
        kernels.check_cuda(ro, apows)
    D, fid = E.D, E.base.field_id
    groups = _launch_groups([(int(m.shape[0]), len(o)) for m, o in zip(mats, openings)])
    ip = _carr(ctypes.c_void_p, [t.data_ptr() for t in invs])
    for group in groups:
        pairs = [(p, off, v) for m in group for p, off, v in sorted(openings[m], key=lambda o: o[1])]
        Q, M = len(pairs), len(group)
        widths = [int(mats[m].shape[0]) for m in group]
        cols = sum(widths)
        shape = (_carr(ctypes.c_int, widths), _carr(ctypes.c_int, [int(e) for e in np.cumsum([len(openings[m])
                                                                                         for m in group])]), M,
                 _carr(ctypes.c_int, [p for p, _, _ in pairs]), _carr(ctypes.c_int64, [off for _, off, _ in pairs]))
        table = torch.empty(((cols + 2 * Q + P) * D,), dtype=torch.int64, device=apows.device)
        kernels.REDUCED_OPEN.launch(
            "ro_scalars", fid, *shape, _carr(ctypes.c_void_p, [v.data_ptr() for _, _, v in pairs]), Q, P,
            kernels.ptr(apows), count, kernels.ptr(table),
            cost=(8 * D * (sum(int(mats[m].shape[0]) * len(openings[m]) for m in group) + cols) + 8 * table.numel(),
                  0),
        )
        adding = add or group is not groups[0]
        kernels.REDUCED_OPEN.launch(
            "ro_rows", fid, _carr(ctypes.c_void_p, [mats[m].data_ptr() for m in group]),
            _carr(ctypes.c_int64, [mats[m].stride(0) for m in group]), *shape, Q, count, ip, P, N,
            kernels.ptr(table), int(adding), kernels.ptr(ro),
            # the matrices and inverse rows read once, ro written (and read when adding); the products
            cost=(8 * N * (cols + P * D + D * (2 if adding else 1)),
                  N * D * (cols + D * (Q - M + P)) * kernels.OPS_PER_MUL[fid]),
        )
    return ro


# --- K10: one FRI fold round into the next level ------------------------------------

def fri_fold_plain(E: ExtOps, vec: torch.Tensor, beta: torch.Tensor, inv_x_even: torch.Tensor, half_inv: int,
                   a_bits: int, absorb=None):
    """Plain version of K10's fold of a (D, N) vector: the chain of pair
    steps with β, β², β⁴, ..., each (v_even + v_odd)/2 + β_s·(v_even -
    v_odd)/(2x); step 0 reads inv_x_even (TwoAdicFriPcs.inv_x_even) and step
    s + 1 the squares of step s's even entries.  Adds `absorb` when given."""
    F = E.base
    half = torch.full((), half_inv, dtype=torch.int64, device=vec.device)
    beta_s, inv_x = beta.reshape(E.D, 1), inv_x_even
    for _ in range(a_bits):
        a, b = vec[:, 0::2], vec[:, 1::2]
        sm = E.scale_plain(E.add_plain(a, b), half)
        df = E.scale_plain(E.sub_plain(a, b), F.mul_plain(inv_x, half))
        vec = E.add_plain(sm, E.mul_plain(df, beta_s))
        beta_s = E.mul_plain(beta_s, beta_s)
        inv_x = F.mul_plain(inv_x[0::2], inv_x[0::2])
    if absorb is not None:
        vec = E.add_plain(vec, absorb)
    return vec


def _level_vector(E: ExtOps, src: torch.Tensor, a_bits: int) -> torch.Tensor:
    """A level's (D, N) vector from itself or from its (A·D, N/A) matrix
    (row k·D + d = coordinate d of vec[k::A])."""
    if src.shape[0] == E.D:
        return src
    return src.reshape(1 << a_bits, E.D, -1).permute(1, 2, 0).reshape(E.D, -1)


def fri_fold_level_plain(E: ExtOps, src: torch.Tensor, beta, inv_x_even, half_inv: int, a_bits: int,
                         next_a_bits: int, absorb=None, hasher=None):
    """Plain version of `fri_fold_level`: the fold of the level's vector
    (`fri_fold_plain`), the next level's matrix (utils.fold_rows' layout)
    and the hasher's plain row hash."""
    vec = _level_vector(E, src, a_bits)
    if a_bits:
        vec = fri_fold_plain(E, vec, beta, inv_x_even, half_inv, a_bits, absorb)
    mat = fold_rows(vec, next_a_bits)
    return mat, (hasher.hash_plain([mat]) if hasher is not None and next_a_bits else None)


def fri_fold_level(E: ExtOps, src: torch.Tensor, beta, inv_x_even, half_inv: int, a_bits: int, next_a_bits: int,
                   absorb=None, hasher=None):
    """One FRI fold round of arity A = 2^a_bits with the device β ((D,)),
    written as the next level: (its (A2·D, M/A2) matrix, A2 = 2^next_a_bits,
    row j·D + d = coordinate d of folded[j::A2]; its (M/A2, 8) int32 leaf
    digests by `hasher`, or None).  src: the level's (A·D, N/A) matrix (row
    k·D + d = coordinate d of vec[k::A]) or its (D, N) vector; inv_x_even:
    the level's TwoAdicFriPcs.inv_x_even, (N/2,); `absorb` ((D, M)), the
    next height's reduced opening, is added to the M = N/A folded values.
    With next_a_bits = 0 the matrix is the (D, M) folded vector and there
    are no leaves; with a_bits = 0 nothing is folded (β, inv_x_even and
    absorb unused): the vector is laid out as its level's matrix.  On a CUDA
    tensor one K10 launch writes the matrix, and for a BLAKE3 hasher
    (`hashes_fri_levels`) the leaves too; another hasher (K6) hashes the
    matrix after it.  The folded vector is never stored.  On a CPU tensor
    the plain version."""
    D, A = E.D, 1 << a_bits
    vector = src.dim() == 2 and src.shape[0] == D
    if src.dim() != 2 or not (vector or src.shape[0] == A * D) or not 0 <= a_bits <= 4 or not 0 <= next_a_bits <= 4:
        raise ValueError(f"fri_fold_level takes a ({D}, N) vector or an ({A * D}, N/{A}) matrix and arities 2^0 to "
                         f"2^4, got {tuple(src.shape)}, {a_bits}, {next_a_bits}")
    N = src.shape[1] if vector else src.shape[1] * A
    M = N >> a_bits
    M2 = M >> next_a_bits
    if M2 == 0 or M2 << next_a_bits != M or M << a_bits != N:
        raise ValueError(f"fri_fold_level: 2^{a_bits}·2^{next_a_bits} must divide the level's {N} positions")
    if a_bits and (beta is None or beta.numel() != D or inv_x_even is None or inv_x_even.shape != (N // 2,)):
        raise ValueError("fri_fold_level: β must have D coordinates and inv_x_even N/2 entries")
    if absorb is not None and (not a_bits or tuple(absorb.shape) != (D, M)):
        raise ValueError("fri_fold_level: absorb must have the folded shape (D, M) and a fold to add to")
    if not kernels.use_kernel(src):
        return fri_fold_level_plain(E, src, beta, inv_x_even, half_inv, a_bits, next_a_bits, absorb, hasher)
    src = src.contiguous()
    ops = [src]
    if a_bits:
        beta, inv_x_even = beta.reshape(D).contiguous(), inv_x_even.contiguous()
        ops += [beta, inv_x_even]
    if absorb is not None:
        absorb = absorb.contiguous()
        ops.append(absorb)
    kernels.check_cuda(*ops)
    fused = hasher is not None and next_a_bits and hasher.hashes_fri_levels
    mat = torch.empty((D << next_a_bits, M2), dtype=torch.int64, device=src.device)
    leaves = torch.empty((M2, 8), dtype=torch.int32, device=src.device) if fused else None
    strides = (N, 1, A) if vector else (N // A, D * N // A, 1)  # coordinate, partner, output
    # products: per pair step (M·(A - 1) in all) the x scale, two scales and the β product; the table's squares
    fold_muls = M * ((A - 1) * (1 + 2 * D + D * D + D * (D - 1) // 2) + A // 2 - 1) if a_bits else 0
    blocks = -(-(8 * D << next_a_bits) // 64)  # BLAKE3 blocks of a leaf
    p = kernels.ptr
    kernels.FRI_FOLD.launch(
        "fri_fold_level", E.base.field_id, p(src), *strides, a_bits, next_a_bits, M2,
        p(inv_x_even) if a_bits else None, p(beta) if a_bits else None, half_inv,
        p(absorb) if absorb is not None else None, p(mat), p(leaves) if fused else None,
        # the level and half of step 0's table read, the next matrix (and the absorb) and the leaves
        cost=(8 * D * N + (4 * N if a_bits else 0) + 8 * D * M * (2 if absorb is not None else 1)
              + (32 * M2 if fused else 0),
              fold_muls * kernels.OPS_PER_MUL[E.base.field_id] + (M2 * blocks * kernels.OPS_PER_BLAKE3 if fused
                                                                   else 0)),
    )
    if hasher is not None and next_a_bits and not fused:
        leaves = hasher.hash_matrices([mat])
    return mat, leaves


def fri_fold(E: ExtOps, vec: torch.Tensor, beta: torch.Tensor, inv_x_even: torch.Tensor, half_inv: int,
             a_bits: int, absorb=None) -> torch.Tensor:
    """Fold a (D, N) storage-order vector (or a rank's block of one) by
    2^a_bits with the device β ((D,)), adding `absorb` ((D, N >> a_bits))
    when given: `fri_fold_level` with next_a_bits = 0 (one K10 launch on a
    CUDA tensor, the plain version on a CPU one)."""
    return fri_fold_level(E, vec, beta, inv_x_even, half_inv, a_bits, 0, absorb)[0]
