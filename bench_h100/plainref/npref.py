"""Vectorized NumPy Goldilocks arithmetic: elements in ``uint64`` arrays
(full 64x64→128 products via 32-bit limb splits, exact in uint64), and its
binomial extension (`NpExt`).  The verifier's arithmetic over all queries
at once, the claims accumulator and the preprocessed LDE run here.
"""

from __future__ import annotations

import numpy as np

from .field_host import GOLDILOCKS

_GL_P = np.uint64(GOLDILOCKS.p)
_MASK32 = np.uint64(0xFFFFFFFF)


# --- Goldilocks --------------------------------------------------------------

def gl_add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.asarray(a, np.uint64)
    b = np.asarray(b, np.uint64)
    with np.errstate(over="ignore"):
        s = a + b
        over = s < a
        # on wrap the true sum is s + 2^64 ≡ s + (2^64 - p) = s + 2^32 - 1
        s = np.where(over, s + _MASK32, s)
        s = np.where(s >= _GL_P, s - _GL_P, s)
    return s


def gl_sub(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.asarray(a, np.uint64)
    b = np.asarray(b, np.uint64)
    with np.errstate(over="ignore"):
        d = a - b
        under = a < b
        d = np.where(under, d - _MASK32, d)  # d + p ≡ d - (2^64 - p) mod 2^64
    return d


def _mul_64_128(a: np.ndarray, b: np.ndarray):
    """Full 128-bit product as four 32-bit chunks (x0..x3, little-endian)."""
    a0 = a & _MASK32
    a1 = a >> np.uint64(32)
    b0 = b & _MASK32
    b1 = b >> np.uint64(32)
    with np.errstate(over="ignore"):
        p00 = a0 * b0  # exact, < 2^64
        p01 = a0 * b1
        p10 = a1 * b0
        p11 = a1 * b1
        x0 = p00 & _MASK32
        t1 = (p00 >> np.uint64(32)) + (p01 & _MASK32) + (p10 & _MASK32)
        x1 = t1 & _MASK32
        t2 = (t1 >> np.uint64(32)) + (p01 >> np.uint64(32)) + (p10 >> np.uint64(32)) + (p11 & _MASK32)
        x2 = t2 & _MASK32
        x3 = (t2 >> np.uint64(32)) + (p11 >> np.uint64(32))
    return x0, x1, x2, x3


def gl_reduce128(x0, x1, x2, x3) -> np.ndarray:
    """Reduce x3·2^96 + x2·2^64 + x1·2^32 + x0 mod p using
    2^64 ≡ 2^32 - 1 and 2^96 ≡ -1 (mod p)."""
    with np.errstate(over="ignore"):
        lo = x0 | (x1 << np.uint64(32))
        # x2 · (2^32 - 1) fits in 64 bits exactly
        m = x2 * _MASK32
        r = gl_add(np.where(lo >= _GL_P, lo - _GL_P, lo), np.where(m >= _GL_P, m - _GL_P, m))
        r = gl_sub(r, np.where(x3 >= _GL_P, x3 - _GL_P, x3))
    return r


def gl_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.asarray(a, np.uint64)
    b = np.asarray(b, np.uint64)
    return gl_reduce128(*_mul_64_128(a, b))


# --- generic -------------------------------------------------------------------

class NpField:
    """Vectorized mod-p ops over uint64 ndarrays for one host field."""

    def __init__(self, host):
        self.host = host
        self.p = np.uint64(host.p)
        if host.name != "Goldilocks":
            raise KeyError(host.name)
        self.add, self.sub, self.mul = gl_add, gl_sub, gl_mul

    def reduce(self, a: np.ndarray) -> np.ndarray:
        """Exact mod p of arbitrary uint64 values."""
        return np.asarray(a, np.uint64) % self.p

    def pow_vec(self, base: int, exps: np.ndarray, max_bits: int) -> np.ndarray:
        """base^exps with per-element exponents < 2^max_bits."""
        exps = np.asarray(exps, np.uint64)
        r = np.ones_like(exps)
        sq = np.uint64(base % self.host.p)
        for bit in range(max_bits):
            take = ((exps >> np.uint64(bit)) & np.uint64(1)).astype(bool)
            r = np.where(take, self.mul(r, sq), r)
            sq = self.mul(sq, sq)
        return r

    def sum_axis(self, a: np.ndarray, axis: int) -> np.ndarray:
        """Sum mod p along `axis` by pairwise halving (stays in uint64)."""
        a = np.moveaxis(np.asarray(a, np.uint64), axis, 0)
        while a.shape[0] > 1:
            if a.shape[0] & 1:
                a = np.concatenate([a, np.zeros((1,) + a.shape[1:], np.uint64)])
            a = self.add(a[0::2], a[1::2])
        return a[0]


class NpExt:
    """Vectorized binomial extension F_p[X]/(X^D - W): elements are
    (..., D) uint64 arrays (coordinate i = coefficient of X^i, matching
    HostExtField)."""

    def __init__(self, nf: NpField, he):
        self.nf = nf
        self.he = he
        self.D = he.D
        self.W = np.uint64(he.w % he.base.p)

    def of_scalar(self, a, shape=()) -> np.ndarray:
        """Host ext tuple -> broadcast (..., D) array."""
        v = np.asarray([int(c) % self.nf.host.p for c in a], np.uint64)
        return np.broadcast_to(v, tuple(shape) + (self.D,)).copy()

    def from_base_vec(self, b: np.ndarray) -> np.ndarray:
        out = np.zeros(b.shape + (self.D,), np.uint64)
        out[..., 0] = b
        return out

    def add(self, a, b):
        return self.nf.add(a, b)

    def sub(self, a, b):
        return self.nf.sub(a, b)

    def scale(self, a, b_base):
        """(..., D) extension elements times (...,) base elements."""
        return self.nf.mul(a, np.asarray(b_base, np.uint64)[..., None])

    def mul(self, a, b):
        """Schoolbook (..., D)x(..., D) with X^D = W wraparound."""
        nf, D = self.nf, self.D
        a = np.asarray(a, np.uint64)
        b = np.asarray(b, np.uint64)
        out = np.zeros(np.broadcast_shapes(a.shape, b.shape), np.uint64)
        for i in range(D):
            for j in range(D):
                t = nf.mul(a[..., i], b[..., j])
                k = i + j
                if k >= D:
                    k -= D
                    t = nf.mul(t, self.W)
                out[..., k] = nf.add(out[..., k], t)
        return out

    def batch_inv(self, a: np.ndarray) -> np.ndarray:
        """(Q, D) -> elementwise inverses via a pairwise product tree and one
        host inversion at the root (Montgomery trick).  Raises
        ZeroDivisionError on any zero element."""
        he = self.he
        one = self.of_scalar(he.one)
        levels = [a]
        cur = a
        while cur.shape[0] > 1:  # reduce up: pairwise products
            if cur.shape[0] & 1:
                cur = np.concatenate([cur, one[None]])
            cur = self.mul(cur[0::2], cur[1::2])
            levels.append(cur)
        inv = self.of_scalar(he.inv(tuple(int(c) for c in levels[-1][0])))[None]
        for lvl in levels[-2::-1]:  # walk down: split each inverse
            n = lvl.shape[0]
            even = lvl[0::2]
            odd = lvl[1::2] if n % 2 == 0 else np.concatenate([lvl[1::2], one[None]])
            down = np.empty((even.shape[0] * 2, self.D), np.uint64)
            down[0::2] = self.mul(odd, inv)
            down[1::2] = self.mul(even, inv)
            inv = down[:n]
        return inv


def reverse_bits_vec(x: np.ndarray, bits: int) -> np.ndarray:
    """Bit-reverse each element within `bits` bits."""
    x = np.asarray(x, np.uint64)
    r = np.zeros_like(x)
    for i in range(bits):
        r |= ((x >> np.uint64(i)) & np.uint64(1)) << np.uint64(bits - 1 - i)
    return r
