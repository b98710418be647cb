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
decide the proof; `prover._selectors_device` builds them on the device.
"""

from __future__ import annotations

from dataclasses import dataclass

from .fields.host import HostField


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

    def create_disjoint_domain(self, min_size: int) -> "TwoAdicCoset":
        """Coset disjoint from self (and from any other domain built this
        way from a same-shift domain): multiply the shift by the field
        generator (p3 convention, used for the quotient domain)."""
        log = (min_size - 1).bit_length()  # log2_ceil
        return TwoAdicCoset(self.field, log, self.field.mul(self.shift, self.field.generator))
