"""Two-adic multiplicative cosets (the counterpart of
multistark_tpu/domains.py).

The prover's quotient-domain selectors are the *unnormalized* p3 ones; with
v = x/shift on the trace domain H of size n:

    Z_H(x)        = v^n - 1
    is_first_row  = Z_H / (v - 1)          (value n   at the first point)
    is_last_row   = Z_H / (v - g^{-1})     (value n·g at the last point)
    is_transition = v - g^{-1}
    inv_vanishing = 1 / Z_H

The logUp boundary injection absorbs 1/(n·g), so these exact constants
decide the proof; `prover._selectors_device` builds them on the device, and
the verifier takes them at one out-of-domain point (`selectors_at_point`).
`selectors_on_coset` is their host NumPy reference over a whole coset (the
tests hold the device ones against it).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import numpy as np

from .fields.host import HostExtField, HostField
from .fields.npref import NpField, np_powers


@dataclass(frozen=True)
class TwoAdicCoset:
    field: HostField
    log_n: int
    shift: int  # canonical int

    @property
    def size(self) -> int:
        return 1 << self.log_n

    @property
    def gen(self) -> int:
        return self.field.two_adic_generator(self.log_n)

    @property
    def first_point(self) -> int:
        return self.shift

    def next_point_ext(self, ext: HostExtField, x: Tuple[int, ...]) -> Tuple[int, ...]:
        return ext.scale(x, self.gen)

    def create_disjoint_domain(self, min_size: int) -> "TwoAdicCoset":
        """Coset disjoint from self (and from any other domain built this
        way from a same-shift domain): multiply the shift by the field
        generator (p3 convention, used for the quotient domain)."""
        log = (min_size - 1).bit_length()  # log2_ceil
        return TwoAdicCoset(self.field, log, self.field.mul(self.shift, self.field.generator))

    def selectors_at_point(self, ext: HostExtField, zeta: Tuple[int, ...]) -> "LagrangeSelectorsAtPoint":
        """The selectors at an out-of-domain extension point (the verifier's
        out-of-domain check)."""
        F = self.field
        v = ext.scale(zeta, F.inv(self.shift))
        vn = v
        for _ in range(self.log_n):
            vn = ext.square(vn)
        z_h = ext.sub(vn, ext.one)
        last_den = ext.sub(v, ext.from_base(F.inv(self.gen)))
        return LagrangeSelectorsAtPoint(
            is_first_row=ext.div(z_h, ext.sub(v, ext.one)),
            is_last_row=ext.div(z_h, last_den),
            is_transition=last_den,
            inv_vanishing=ext.inv(z_h),
        )

    def selectors_on_coset(self, coset: "TwoAdicCoset") -> "LagrangeSelectorsOnCoset":
        """The selectors of this domain at every point of `coset`, in natural
        order (the quotient-domain selectors), as host NumPy arrays, cached."""
        if coset.log_n < self.log_n:
            raise ValueError("selectors_on_coset takes a coset at least as large as the domain")
        return _selectors_on_coset_cached(self.field, self.log_n, self.shift, coset.log_n, coset.shift)


@dataclass(frozen=True)
class LagrangeSelectorsAtPoint:
    is_first_row: Tuple[int, ...]
    is_last_row: Tuple[int, ...]
    is_transition: Tuple[int, ...]
    inv_vanishing: Tuple[int, ...]


@dataclass(frozen=True)
class LagrangeSelectorsOnCoset:
    """uint64 numpy arrays over the evaluation coset, natural order."""

    is_first_row: np.ndarray
    is_last_row: np.ndarray
    is_transition: np.ndarray
    inv_vanishing: np.ndarray


@lru_cache(maxsize=64)
def _selectors_on_coset_cached(field: HostField, log_n: int, shift: int, log_big: int,
                               big_shift: int) -> LagrangeSelectorsOnCoset:
    nf = NpField(field)
    n, N = 1 << log_n, 1 << log_big
    # v_i = (big_shift / shift)·G^i over the big coset, natural order
    v = nf.mul(np_powers(field, field.two_adic_generator(log_big), N),
               np.uint64(field.mul(big_shift, field.inv(shift))))
    # v^n has period q = N/n: q values, tiled
    q = N >> log_n
    z_h = nf.sub(np.tile(nf.pow(v[:q], n), n), np.uint64(1))
    first_den = nf.sub(v, np.uint64(1))
    last_den = nf.sub(v, np.uint64(field.inv(field.two_adic_generator(log_n))))
    inv_all = nf.inv(np.concatenate([first_den, last_den, z_h]))
    return LagrangeSelectorsOnCoset(
        is_first_row=nf.mul(z_h, inv_all[:N]),
        is_last_row=nf.mul(z_h, inv_all[N : 2 * N]),
        is_transition=last_den,
        inv_vanishing=inv_all[2 * N :],
    )
