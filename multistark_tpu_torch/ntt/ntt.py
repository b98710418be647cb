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

A DIF runs one `ntt_stage_` launch per butterfly stage above its tile on a
copy of its input, then K14 (commit_tile.lde_tile, hashing off) for the
last `tile_log` stages in shared memory; a DIT runs one launch per stage.
The PCS's commits run the forward DIF's tail and the Merkle leaves in one
K14 launch of their own (pcs.py).  The coset scale and n^-1 go through the
field's elementwise kernel (K1 or K5: one mul by a host-built table); bit
reversal and zero padding are plain tensor indexing.  Twiddles, shifts and
the generator come from the host field (two-adicity 32 for Goldilocks, 27
for BabyBear).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .. import commit_tile, kernels
from ..fields.device import FieldOps
from ..fields.host import HostField
from ..fields.npref import np_mul, np_powers
from ..utils import bit_reverse_indices


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


def ntt_stage_(F: FieldOps, x: torch.Tensor, tw: torch.Tensor, dif: bool) -> None:
    """One butterfly stage over a contiguous (rows, n) tensor of F's
    elements, IN PLACE (each butterfly reads and writes only its own pair,
    so no second buffer is needed).  `tw` holds the stage's 2^k twiddles
    [w^0 .. w^(half-1)]."""
    if x.dim() != 2 or not x.is_contiguous() or x.dtype != torch.int64:
        raise ValueError("ntt_stage_ takes a contiguous (rows, n) int64 tensor")
    rows, n = x.shape
    half = tw.shape[0]
    if n & (n - 1) or half & (half - 1) or 2 * half > n:
        raise ValueError(f"bad stage geometry n={n} half={half}")
    if not kernels.use_kernel(x):
        _stage_plain_(F, x, tw, dif)
        return
    kernels.check_cuda(x, tw)
    kernels.NTT_STAGE.launch(
        "ntt_stage", F.field_id, kernels.ptr(x), rows, n.bit_length() - 1, half.bit_length() - 1,
        kernels.ptr(tw), int(dif),
    )


class NttEngine:
    """Twiddle and index caches + the public transforms, for one field on
    one device."""

    def __init__(self, F: FieldOps, host_field: HostField, device):
        self.F = F
        self.device = torch.device(device)
        self.host = host_field
        self._stages: Dict[Tuple[int, bool], torch.Tensor] = {}
        self._tails: Dict[Tuple[int, bool], torch.Tensor] = {}
        self._brev: Dict[int, torch.Tensor] = {}
        self._scales: Dict[Tuple[int, int, int], torch.Tensor] = {}

    # -- caches -----------------------------------------------------------
    def stage_table(self, s: int, inverse: bool) -> torch.Tensor:
        """Twiddles of butterfly stage s (blocks of 2^s): [w^0 .. w^(2^(s-1)-1)]
        with w the canonical generator of order 2^s (inverted for inverse
        transforms) -- the same table for every transform size."""
        key = (s, inverse)
        if key not in self._stages:
            w = self.host.two_adic_generator(s)
            if inverse:
                w = self.host.inv(w)
            self._stages[key] = self.F.from_np(np_powers(self.host, w, 1 << (s - 1)), self.device)
        return self._stages[key]

    def tail_table(self, k: int, inverse: bool) -> torch.Tensor:
        """The twiddles of stages 1..k concatenated (stage s at 2^(s-1) - 1),
        as K14 takes them."""
        key = (k, inverse)
        if key not in self._tails:
            parts = [self.stage_table(s, inverse) for s in range(1, k + 1)]
            self._tails[key] = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.int64, device=self.device)
        return self._tails[key]

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
    def dif_above_(self, x: torch.Tensor, log_n: int, tile_log: int, inverse: bool) -> None:
        """DIF stages log_n..tile_log+1 of contiguous (rows, 2^log_n) x in
        place, one K2 launch each."""
        for s in range(log_n, tile_log, -1):
            ntt_stage_(self.F, x, self.stage_table(s, inverse), dif=True)

    def _dif_(self, x: torch.Tensor, log_n: int, inverse: bool, tile_log: Optional[int] = None) -> torch.Tensor:
        """DIF of contiguous (rows, 2^log_n) x in place: K2 above the tile,
        K14 (no hashing) for the last tile_log stages (default: the largest
        tile that fits)."""
        k = commit_tile.tile_log_for(x.shape[0], log_n, hashed=False) if tile_log is None else min(tile_log, log_n)
        self.dif_above_(x, log_n, k, inverse)
        commit_tile.lde_tile(self.F, None, x, k, self.tail_table(k, inverse), hashed=False)
        return x

    def _dif(self, x: torch.Tensor, log_n: int, inverse: bool, tile_log: Optional[int] = None) -> torch.Tensor:
        return self._dif_(x.reshape(-1, 1 << log_n).clone(), log_n, inverse, tile_log)

    def _dit(self, x: torch.Tensor, log_n: int, inverse: bool) -> torch.Tensor:
        x = x.reshape(-1, 1 << log_n).clone()
        for s in range(1, log_n + 1):
            ntt_stage_(self.F, x, self.stage_table(s, inverse), dif=False)
        return x

    def _unbrev(self, x: torch.Tensor, log_n: int) -> torch.Tensor:
        return x.index_select(-1, self.brev(log_n))

    # -- public transforms ------------------------------------------------
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
