"""Vectorized NumPy Goldilocks arithmetic on the host.

Goldilocks lives in ``uint64`` arrays (full 64x64→128 products via 32-bit
limb splits, exact in uint64).  Twiddle, coset and selector tables are
precomputed here before being shipped to the device.
"""

from __future__ import annotations

import numpy as np

from .host import GOLDILOCKS

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


def np_powers(host, base: int, n: int) -> np.ndarray:
    """[1, base, base^2, ..., base^(n-1)] as uint64 (host precompute,
    O(log n) vectorized doubling passes)."""
    if host.name != "Goldilocks":
        raise KeyError(host.name)
    out = np.ones(1, np.uint64)
    cur = np.uint64(base % host.p)
    while len(out) < n:
        out = np.concatenate([out, gl_mul(out, cur)])
        cur = gl_mul(cur, cur)
    return out[:n]
