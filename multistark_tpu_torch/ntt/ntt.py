"""Batched radix-2 NTT / low-degree extension over Goldilocks or BabyBear:
kernel K2 (ntt_stage).

Layout conventions (the protocol's storage conventions, as in
multistark_tpu/ntt/ntt.py):

  - matrices are (width, n) int64 tensors: row w = polynomial w
  - committed LDEs are stored in *bit-reversed* order, so that FRI fold
    partners (x, -x) are adjacent and the restriction of an LDE to a
    same-shift sub-coset is a stored *prefix* (`prefix_to_natural`)
  - DIF maps natural input to bit-reversed output; DIT on bit-reversed
    input gives natural output

A DIF runs its stages above the tile in K2 passes (`ntt_pass_`: up to
PASS_STAGES consecutive stages per launch, `pass_plan` splits them evenly) on
a copy of its input, then K14 (commit_tile.lde_tile, hashing off) for the
last `tile_log` stages in shared memory; a DIT runs K14's DIT mode for its
first `tile_log` stages, then K2 passes above them.  The PCS's commits run
the forward DIF's tail and the Merkle leaves in one K14 launch of their own
(pcs.py).  The coset scale and n^-1 go through the field's elementwise
kernel (K1 or K5: one mul by a host-built table); bit reversal and zero
padding are plain tensor indexing.  Twiddles, shifts and the generator come
from the host field (two-adicity 32 for Goldilocks, 27 for BabyBear).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import commit_tile, kernels
from ..fields.device import FieldOps
from ..fields.host import HostField
from ..fields.npref import np_mul, np_powers
from ..utils import bit_reverse_indices

PASS_MAX = 6  # MAX_PASS in csrc/ntt_stage.cu: the most stages one K2 launch runs
PASS_STAGES = 5  # the engines' passes: at six, a Goldilocks thread's 64 elements spill registers


def _stage_plain_(F: FieldOps, x: torch.Tensor, tw: torch.Tensor, dif: bool) -> None:
    rows, n = x.shape
    half = tw.shape[0]
    xr = x.view(rows, n // (2 * half), 2, half)
    a, b = xr[:, :, 0, :], xr[:, :, 1, :]
    if dif:
        lo, hi = F.add_plain(a, b), F.mul_plain(F.sub_plain(a, b), tw)
    else:
        t = F.mul_plain(b, tw)
        lo, hi = F.add_plain(a, t), F.sub_plain(a, t)
    xr[:, :, 0, :] = lo
    xr[:, :, 1, :] = hi


def _pass_plain_(F: FieldOps, x: torch.Tensor, tw: torch.Tensor, s_lo: int, r: int, dif: bool) -> None:
    base = 1 << (s_lo - 1)
    for s in (range(s_lo + r - 1, s_lo - 1, -1) if dif else range(s_lo, s_lo + r)):
        half = 1 << (s - 1)
        _stage_plain_(F, x, tw[half - base : 2 * half - base], dif)


def ntt_pass_(F: FieldOps, x: torch.Tensor, tw: torch.Tensor, s_lo: int, r: int, dif: bool) -> None:
    """Butterfly stages s_lo .. s_lo + r - 1 (DIF top down, DIT bottom up)
    over a contiguous (rows, n) tensor of F's elements, IN PLACE, in one K2
    launch.  `tw` holds the stages' tables concatenated from stage s_lo's
    (stage s at 2^(s-1) - 2^(s_lo-1), as in `NttEngine.tail_table`)."""
    if x.dim() != 2 or not x.is_contiguous() or x.dtype != torch.int64:
        raise ValueError("ntt_pass_ takes a contiguous (rows, n) int64 tensor")
    rows, n = x.shape
    log_n = n.bit_length() - 1
    if n != 1 << log_n or not 1 <= r <= PASS_MAX or s_lo < 1 or s_lo + r - 1 > log_n:
        raise ValueError(f"bad pass geometry n={n} s_lo={s_lo} r={r}")
    if tw.dim() != 1 or tw.shape[0] < (1 << (s_lo + r - 1)) - (1 << (s_lo - 1)):
        raise ValueError("twiddle table shorter than the pass's stages")
    if not kernels.use_kernel(x):
        _pass_plain_(F, x, tw, s_lo, r, dif)
        return
    kernels.check_cuda(x, tw)
    twiddles = (1 << (s_lo + r - 1)) - (1 << (s_lo - 1))
    kernels.NTT_STAGE.launch("ntt_pass", F.field_id, kernels.ptr(x), rows, log_n, s_lo, r, kernels.ptr(tw), int(dif),
                             cost=(16 * x.numel() + 8 * twiddles, 0))


def ntt_stage_(F: FieldOps, x: torch.Tensor, tw: torch.Tensor, dif: bool) -> None:
    """One butterfly stage (the r = 1 pass) with `tw` any table of 2^(s-1)
    twiddles for stage s, such as a rank's cyclic slice (parallel.py)."""
    half = tw.shape[0]
    if half & (half - 1):
        raise ValueError(f"bad stage table of {half} twiddles")
    ntt_pass_(F, x, tw, half.bit_length(), 1, dif)


def pass_plan(top: int, bottom: int, pass_max: int) -> List[Tuple[int, int]]:
    """Stages bottom+1 .. top as K2 passes (s_lo, r), top pass first: the
    fewest passes of at most pass_max stages, as even as they come."""
    stages = top - bottom
    if stages <= 0:
        return []
    count = -(-stages // pass_max)
    plan, s = [], top
    for i in range(count):
        r = stages // count + (i < stages % count)
        plan.append((s - r + 1, r))
        s -= r
    return plan


class NttEngine:
    """Twiddle and index caches + the public transforms, for one field on
    one device."""

    def __init__(self, F: FieldOps, host_field: HostField, device):
        self.F = F
        self.device = torch.device(device)
        self.host = host_field
        self._tails: Dict[bool, torch.Tensor] = {}
        self._brev: Dict[int, torch.Tensor] = {}
        self._scales: Dict[Tuple[int, int, int], torch.Tensor] = {}

    # -- caches -----------------------------------------------------------
    def tail_table(self, k: int, inverse: bool) -> torch.Tensor:
        """The twiddles of stages 1..k concatenated, stage s at 2^(s-1) - 1
        ([w_s^0 .. w_s^(2^(s-1)-1)], w_s the canonical generator of order
        2^s, inverted for inverse transforms): a prefix of one table per
        direction, grown on demand.  K14 and the K2 passes take it."""
        tab = self._tails.get(inverse)
        if tab is None or tab.shape[0] < (1 << k) - 1:
            parts = []
            for s in range(1, max(k, 1) + 1):
                w = self.host.two_adic_generator(s)
                parts.append(np_powers(self.host, self.host.inv(w) if inverse else w, 1 << (s - 1)))
            tab = self._tails[inverse] = self.F.from_np(np.concatenate(parts), self.device)
        return tab[: (1 << k) - 1]

    def stage_table(self, s: int, inverse: bool) -> torch.Tensor:
        """Twiddles of butterfly stage s (blocks of 2^s): the same table for
        every transform size."""
        return self.tail_table(s, inverse)[(1 << (s - 1)) - 1 :]

    def brev(self, log_n: int) -> torch.Tensor:
        if log_n not in self._brev:
            self._brev[log_n] = torch.from_numpy(bit_reverse_indices(log_n)).to(self.device)
        return self._brev[log_n]

    def scale_table(self, log_n: int, shift: int, scale: int = 1) -> torch.Tensor:
        """[scale·shift^i for i < 2^log_n] (host-built once, device-cached)."""
        key = (log_n, shift % self.host.p, scale % self.host.p)
        if key not in self._scales:
            tab = np_mul(self.host, np_powers(self.host, shift, 1 << log_n), scale % self.host.p)
            self._scales[key] = self.F.from_np(tab, self.device)
        return self._scales[key]

    # -- butterfly passes -------------------------------------------------
    def passes_(self, x: torch.Tensor, top: int, bottom: int, inverse: bool, dif: bool) -> None:
        """Stages bottom+1 .. top of contiguous (rows, n) x in place, in K2
        passes of at most PASS_STAGES stages (DIF top down, DIT bottom up)."""
        plan = pass_plan(top, bottom, PASS_STAGES)
        tab = self.tail_table(top, inverse)
        for s_lo, r in plan if dif else reversed(plan):
            ntt_pass_(self.F, x, tab[(1 << (s_lo - 1)) - 1 :], s_lo, r, dif)

    def dif_above_(self, x: torch.Tensor, log_n: int, tile_log: int, inverse: bool) -> None:
        """DIF stages log_n..tile_log+1 of contiguous (rows, 2^log_n) x in
        place (K2 passes)."""
        self.passes_(x, log_n, tile_log, inverse, dif=True)

    def _dif_(self, x: torch.Tensor, log_n: int, inverse: bool, tile_log: Optional[int] = None) -> torch.Tensor:
        """DIF of contiguous (rows, 2^log_n) x in place: K2 passes above the
        tile, K14 (no hashing) for the last tile_log stages (default: the
        tile commit_tile.tile_log_for picks)."""
        k = commit_tile.tile_log_for(x.shape[0], log_n, hashed=False) if tile_log is None else min(tile_log, log_n)
        self.dif_above_(x, log_n, k, inverse)
        commit_tile.lde_tile(self.F, None, x, k, self.tail_table(k, inverse), hashed=False)
        return x

    def _dif(self, x: torch.Tensor, log_n: int, inverse: bool, tile_log: Optional[int] = None) -> torch.Tensor:
        return self._dif_(x.reshape(-1, 1 << log_n).clone(), log_n, inverse, tile_log)

    def _dit(self, x: torch.Tensor, log_n: int, inverse: bool, tile_log: Optional[int] = None) -> torch.Tensor:
        """DIT of (rows, 2^log_n) x on a copy: K14's DIT mode for the first
        tile_log stages (default: commit_tile.tile_log_for's tile), then K2
        passes above them."""
        x = x.reshape(-1, 1 << log_n).clone()
        k = commit_tile.tile_log_for(x.shape[0], log_n, hashed=False) if tile_log is None else min(tile_log, log_n)
        commit_tile.lde_tile(self.F, None, x, k, self.tail_table(k, inverse), hashed=False, dif=False)
        self.passes_(x, log_n, k, inverse, dif=False)
        return x

    def _unbrev(self, x: torch.Tensor, log_n: int) -> torch.Tensor:
        return x.index_select(-1, self.brev(log_n))

    # -- public transforms ------------------------------------------------
    def dft_natural(self, coeffs: torch.Tensor, log_n: int) -> torch.Tensor:
        """natural coeffs -> natural evals on the subgroup H: the DIT of the
        bit-reversed coefficients (K14's DIT head, then K2 passes)."""
        return self._dit(self._unbrev(coeffs, log_n), log_n, inverse=False).reshape(coeffs.shape)

    def idft_natural(self, evals: torch.Tensor, log_n: int) -> torch.Tensor:
        """natural evals on H -> natural coeffs: the inverse DIT, then n^-1
        (one K1/K5 product by a scalar)."""
        out = self._dit(self._unbrev(evals, log_n), log_n, inverse=True)
        n_inv = self.host.inv((1 << log_n) % self.host.p)
        return self.F.mul(out, self.F.const(n_inv, out.device)).reshape(evals.shape)

    def coset_eval_bitrev(self, coeffs: torch.Tensor, log_n: int, shift: int) -> torch.Tensor:
        """natural coeffs -> evals on shift·H in bit-reversed order: the
        coefficients times shift^i (K1/K5), then the DIF (K2 passes, K14's
        tail)."""
        c = self.F.mul(coeffs, self.scale_table(log_n, shift))
        return self._dif(c, log_n, inverse=False).reshape(coeffs.shape)

    def icoset_from_natural(self, evals: torch.Tensor, log_n: int, shift: int) -> torch.Tensor:
        """natural evals on shift·H -> natural coeffs."""
        return self.icoset_from_bitrev(self._unbrev(evals, log_n), log_n, shift)

    def icoset_from_bitrev(self, evals: torch.Tensor, log_n: int, shift: int) -> torch.Tensor:
        """bit-reversed evals on shift·H -> natural coeffs."""
        out = self._dit(evals, log_n, inverse=True)
        n_inv = self.host.inv((1 << log_n) % self.host.p)
        tab = self.scale_table(log_n, self.host.inv(shift), n_inv)
        return self.F.mul(out, tab).reshape(evals.shape)

    def coset_extend(self, evals: torch.Tensor, log_n: int, log_blowup: int, shift: int,
                     tile_log: Optional[int] = None) -> torch.Tensor:
        """(w, n) evals on the subgroup H_n -> the natural coefficients of
        their interpolant times shift^i, zero-padded to n·2^log_blowup: the
        input of the coset LDE's forward DIF.  iDFT (DIF, bit-reversed
        coefficients), un-reverse, scale by n^-1·shift^i, zero-pad."""
        cb = self._dif(evals, log_n, inverse=True, tile_log=tile_log)
        n_inv = self.host.inv((1 << log_n) % self.host.p)
        co = self.F.mul(self._unbrev(cb, log_n), self.scale_table(log_n, shift, n_inv))
        return self.zero_extend(co, log_n + log_blowup)

    @staticmethod
    def zero_extend(coeffs: torch.Tensor, log_big: int) -> torch.Tensor:
        w, n = coeffs.shape
        pad = torch.zeros((w, 1 << log_big), dtype=torch.int64, device=coeffs.device)
        pad[:, :n] = coeffs
        return pad

    def coset_lde_bitrev(self, evals: torch.Tensor, log_n: int, log_blowup: int, shift: int) -> torch.Tensor:
        """(w, n) evals on the subgroup H_n -> evals on shift·H_N
        (N = n·2^log_blowup), bit-reversed: `coset_extend`, then the DIF."""
        return self._dif_(self.coset_extend(evals, log_n, log_blowup, shift), log_n + log_blowup, inverse=False)

    def lde_bitrev_from_coeffs(self, coeffs: torch.Tensor, log_big: int) -> torch.Tensor:
        """Zero-extend (w, n) natural coefficients to 2^log_big and evaluate
        on the unshifted big subgroup, bit-reversed (callers bake any coset
        shift into the coefficients)."""
        return self._dif_(self.zero_extend(coeffs, log_big), log_big, inverse=False)

    def prefix_to_natural(self, lde_bitrev: torch.Tensor, log_sub: int) -> torch.Tensor:
        """First 2^log_sub entries of a bit-reversed LDE = the same-shift
        sub-coset in bit-reversed order; un-reverse to natural order."""
        return self._unbrev(lde_bitrev[..., : 1 << log_sub], log_sub)
