"""Host-side (pure Python int) prime-field and binomial-extension arithmetic.

Used for everything small and serial: challenger transcript values, verifier
out-of-domain evaluation, domain/twiddle parameter derivation, and as ground
truth in tests.  Mirrors the trait surface the reference consumes from
p3-field (reference src/config.rs:15-61, SURVEY.md §2.2).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Sequence, Tuple


class HostField:
    """Prime field F_p with a fixed multiplicative generator and two-adicity.

    All values are canonical Python ints in ``[0, p)``.
    """

    def __init__(self, p: int, generator: int, two_adicity: int, name: str):
        self.p = p
        self.generator = generator
        self.two_adicity = two_adicity
        self.name = name
        assert (p - 1) % (1 << two_adicity) == 0
        assert pow(generator, (p - 1) // 2, p) == p - 1, "generator must be a non-residue"

    # -- ring ops ---------------------------------------------------------
    def add(self, a: int, b: int) -> int:
        s = a + b
        return s - self.p if s >= self.p else s

    def sub(self, a: int, b: int) -> int:
        d = a - b
        return d + self.p if d < 0 else d

    def neg(self, a: int) -> int:
        return (self.p - a) % self.p

    def mul(self, a: int, b: int) -> int:
        return a * b % self.p

    def pow(self, a: int, e: int) -> int:
        return pow(a, e, self.p)

    def inv(self, a: int) -> int:
        if a == 0:
            raise ZeroDivisionError(f"inverse of zero in {self.name}")
        return pow(a, self.p - 2, self.p)

    def div(self, a: int, b: int) -> int:
        return self.mul(a, self.inv(b))

    # -- structure --------------------------------------------------------
    @lru_cache(maxsize=None)
    def two_adic_generator(self, bits: int) -> int:
        """Canonical generator of the order-2^bits subgroup: g^((p-1)/2^bits)."""
        assert 0 <= bits <= self.two_adicity
        return pow(self.generator, (self.p - 1) >> bits, self.p)

    def exp_power_of_2(self, a: int, k: int) -> int:
        for _ in range(k):
            a = a * a % self.p
        return a

    def batch_inv(self, xs: Sequence[int]) -> list[int]:
        """Montgomery batch inverse; zero entries map to zero (matching
        p3_field::batch_multiplicative_inverse used at reference
        src/lookup.rs:501)."""
        n = len(xs)
        out = [0] * n
        prefix = [1] * (n + 1)
        for i, x in enumerate(xs):
            prefix[i + 1] = prefix[i] * (x if x != 0 else 1) % self.p
        acc = self.inv(prefix[n])
        for i in range(n - 1, -1, -1):
            x = xs[i]
            if x == 0:
                continue
            out[i] = acc * prefix[i] % self.p
            acc = acc * x % self.p
        return out


class HostExtField:
    """Binomial extension F_p[X]/(X^D - W).  Elements are D-tuples of ints.

    Matches the reference's BinomialExtensionField layout: coordinate i is the
    coefficient of X^i ("basis coefficients", reference src/config.rs:58-61).
    """

    def __init__(self, base: HostField, degree: int, w: int, name: str):
        self.base = base
        self.D = degree
        self.w = w
        self.name = name
        p = base.p
        # binomial irreducibility (Lang, Alg. VI §9): X^D - W irreducible iff
        # W is not a q-th power for every prime q | D, AND (when 4 | D)
        # W ∉ -4·F^4.  We support D ∈ {2, 4} (both have q=2 only).
        assert degree in (2, 4), f"unsupported extension degree {degree}"
        assert pow(w, (p - 1) // 2, p) != 1, f"X^{degree}-{w} reducible (W is a square)"
        if degree % 4 == 0:
            assert p % 4 == 1
            # W = -4c^4 ⟺ -W/4 is a fourth power; p ≡ 1 (mod 4) so the
            # fourth-power test is t^((p-1)/4) == 1
            t = (-w * pow(4, p - 2, p)) % p
            assert pow(t, (p - 1) // 4, p) != 1, (
                f"X^{degree}-{w} reducible (W ∈ -4·F^4)"
            )

    # -- embedding --------------------------------------------------------
    def from_base(self, a: int) -> Tuple[int, ...]:
        return (a,) + (0,) * (self.D - 1)

    @property
    def zero(self) -> Tuple[int, ...]:
        return (0,) * self.D

    @property
    def one(self) -> Tuple[int, ...]:
        return self.from_base(1)

    def is_zero(self, a) -> bool:
        return all(c == 0 for c in a)

    # -- ring ops ---------------------------------------------------------
    def add(self, a, b):
        f = self.base
        return tuple(f.add(x, y) for x, y in zip(a, b))

    def sub(self, a, b):
        f = self.base
        return tuple(f.sub(x, y) for x, y in zip(a, b))

    def neg(self, a):
        f = self.base
        return tuple(f.neg(x) for x in a)

    def scale(self, a, s: int):
        p = self.base.p
        return tuple(c * s % p for c in a)

    def mul(self, a, b):
        """Schoolbook with X^D = W wraparound (the host side deliberately does
        NOT use Karatsuba so it can serve as an independent reference for the
        compiled device path, mirroring reference src/eval.rs:151-154)."""
        p, D, w = self.base.p, self.D, self.w
        out = [0] * D
        for i, ai in enumerate(a):
            if ai == 0:
                continue
            for j, bj in enumerate(b):
                k = i + j
                t = ai * bj
                if k >= D:
                    out[k - D] = (out[k - D] + t * w) % p
                else:
                    out[k] = (out[k] + t) % p
        return tuple(out)

    def square(self, a):
        return self.mul(a, a)

    def pow(self, a, e: int):
        r = self.one
        b = a
        while e:
            if e & 1:
                r = self.mul(r, b)
            b = self.mul(b, b)
            e >>= 1
        return r

    def inv(self, a):
        if self.is_zero(a):
            raise ZeroDivisionError(f"inverse of zero in {self.name}")
        if self.D == 2:
            # (a0 + a1 X)^-1 = (a0 - a1 X) / (a0^2 - W a1^2)
            f, w = self.base, self.w
            a0, a1 = a
            norm = f.sub(f.mul(a0, a0), f.mul(w, f.mul(a1, a1)))
            ninv = f.inv(norm)
            return (f.mul(a0, ninv), f.mul(f.neg(a1), ninv))
        # generic: Fermat a^(p^D - 2)
        return self.pow(a, self.base.p**self.D - 2)

    def div(self, a, b):
        return self.mul(a, self.inv(b))

    def batch_inv(self, xs):
        n = len(xs)
        out = [self.zero] * n
        prefix = [self.one] * (n + 1)
        for i, x in enumerate(xs):
            prefix[i + 1] = self.mul(prefix[i], x if not self.is_zero(x) else self.one)
        acc = self.inv(prefix[n])
        for i in range(n - 1, -1, -1):
            x = xs[i]
            if self.is_zero(x):
                continue
            out[i] = self.mul(acc, prefix[i])
            acc = self.mul(acc, x)
        return out

    # -- misc -------------------------------------------------------------
    def sample_from_u64s(self, limbs: Sequence[int]):
        """Build an element from D already-reduced base values."""
        assert len(limbs) == self.D
        return tuple(x % self.base.p for x in limbs)


# --- concrete fields (reference src/types.rs:20-26, test_circuits/baby_bear_config.rs:15-34)

GOLDILOCKS = HostField(
    p=2**64 - 2**32 + 1,
    generator=7,
    two_adicity=32,
    name="Goldilocks",
)
# Degree-2 binomial extension X^2 = 7 (~2^128 security for FRI challenges,
# reference src/types.rs:26).
GOLDILOCKS_EXT2 = HostExtField(GOLDILOCKS, 2, 7, "Goldilocks^2")


@dataclass(frozen=True)
class ExtensionParams:
    """(D, W) of the binomial extension — what the constraint compiler needs
    to expand extension-field constraints into base-field coordinates
    (reference src/graph.rs:49-57)."""

    degree: int
    w: int
    karatsuba: bool  # use the 3-mul Karatsuba expansion for D=2 (graph.rs:458-473)
