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
decide the proof; the verifier takes them at one out-of-domain point
(`selectors_at_point`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from .field_host import HostExtField, HostField


@dataclass(frozen=True)
class TwoAdicCoset:
    field: HostField
    log_n: int
    shift: int  # canonical int

    @property
    def gen(self) -> int:
        return self.field.two_adic_generator(self.log_n)

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


@dataclass(frozen=True)
class LagrangeSelectorsAtPoint:
    is_first_row: Tuple[int, ...]
    is_last_row: Tuple[int, ...]
    is_transition: Tuple[int, ...]
    inv_vanishing: Tuple[int, ...]
