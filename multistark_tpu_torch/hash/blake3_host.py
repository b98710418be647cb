"""BLAKE3 on the host: the native C helper (csrc/host/b3.c, built by
native.py), and the BLAKE3 constants the tensor half shares.

This is the host half of multistark_tpu.hash.blake3, split out so that
nothing here imports JAX.  The Fiat-Shamir challenger (hashing, grinding)
and the claims accumulator use it; the tensor half (row hashing and Merkle
compression, kernel K3) is multistark_tpu_torch.hash.blake3.  The BLAKE3
circuit family's witness (test_circuits/blake3_circuit.py) takes the
compression function from here: `compress` for one, `compress_batch` for
many independent ones in NumPy.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence

import numpy as np

from ..native import lib as _native_lib

IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)
MSG_PERM = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

CHUNK_START = 1 << 0
CHUNK_END = 1 << 1
PARENT = 1 << 2
ROOT = 1 << 3

CHUNK_LEN = 1024
BLOCK_LEN = 64

_M32 = 0xFFFFFFFF
# G's four state words per call of a round: the columns, then the diagonals
G_INDEX = (
    (0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
    (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14),
)


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _M32


def _g(st: List[int], a: int, b: int, c: int, d: int, mx: int, my: int) -> None:
    st[a] = (st[a] + st[b] + mx) & _M32
    st[d] = _rotr(st[d] ^ st[a], 16)
    st[c] = (st[c] + st[d]) & _M32
    st[b] = _rotr(st[b] ^ st[c], 12)
    st[a] = (st[a] + st[b] + my) & _M32
    st[d] = _rotr(st[d] ^ st[a], 8)
    st[c] = (st[c] + st[d]) & _M32
    st[b] = _rotr(st[b] ^ st[c], 7)


def compress(cv: Sequence[int], block: Sequence[int], counter: int, block_len: int, flags: int) -> List[int]:
    """One BLAKE3 compression; returns the full 16-word output state."""
    st = list(cv[:8]) + list(IV[:4]) + [counter & _M32, (counter >> 32) & _M32, block_len, flags]
    m = list(block)
    for _ in range(7):
        for gi, (a, b, c, d) in enumerate(G_INDEX):
            _g(st, a, b, c, d, m[2 * gi], m[2 * gi + 1])
        m = [m[p] for p in MSG_PERM]
    return [st[i] ^ st[i + 8] for i in range(8)] + [st[i + 8] ^ cv[i] for i in range(8)]


def _words_of(block: bytes) -> List[int]:
    block = block + b"\x00" * (BLOCK_LEN - len(block))
    return [int.from_bytes(block[4 * i : 4 * i + 4], "little") for i in range(16)]


def _np_rotr(x: np.ndarray, n: int) -> np.ndarray:
    return (x >> np.uint32(n)) | (x << np.uint32(32 - n))


def compress_batch(cv, block, counter, block_len, flags) -> np.ndarray:
    """n independent BLAKE3 compressions in NumPy: cv (n, 8) and block
    (n, 16) words, counter, block_len and flags (n,) or scalars.  Returns
    the (n, 16) uint32 output states (`compress` of each row)."""
    cv = np.asarray(cv, np.uint32)
    n = cv.shape[0]
    counter = np.broadcast_to(np.asarray(counter, np.uint64), (n,))
    st = np.empty((16, n), np.uint32)  # word-major: each word a contiguous (n,) vector
    st[:8] = cv.T
    st[8:12] = np.asarray(IV[:4], np.uint32)[:, None]
    st[12] = (counter & np.uint64(_M32)).astype(np.uint32)
    st[13] = (counter >> np.uint64(32)).astype(np.uint32)
    st[14] = np.broadcast_to(np.asarray(block_len, np.uint32), (n,))
    st[15] = np.broadcast_to(np.asarray(flags, np.uint32), (n,))
    m = np.ascontiguousarray(np.asarray(block, np.uint32).T)
    for _ in range(7):
        for gi, (a, b, c, d) in enumerate(G_INDEX):
            st[a] += st[b] + m[2 * gi]
            st[d] = _np_rotr(st[d] ^ st[a], 16)
            st[c] += st[d]
            st[b] = _np_rotr(st[b] ^ st[c], 12)
            st[a] += st[b] + m[2 * gi + 1]
            st[d] = _np_rotr(st[d] ^ st[a], 8)
            st[c] += st[d]
            st[b] = _np_rotr(st[b] ^ st[c], 7)
        m = m[list(MSG_PERM)]
    return np.concatenate([st[:8] ^ st[8:], st[8:] ^ cv.T]).T.copy()


def _left_len(n_chunks: int) -> int:
    """Largest power-of-two number of chunks strictly less than the total."""
    p = 1
    while p * 2 < n_chunks:
        p *= 2
    return p


def blake3_hash(data: bytes) -> bytes:
    """Full BLAKE3 hash, 32-byte output, through the native C helper."""
    out = (ctypes.c_uint8 * 32)()
    _native_lib().msb3_hash(data, len(data), out)
    return bytes(out)


def native_hash_words(words: np.ndarray):
    """Full BLAKE3 of each row of (B, W) uint32 words -> (B, 8) digests,
    through the native C helper."""
    lib = _native_lib()
    words = np.ascontiguousarray(words, np.uint32)
    B, W = words.shape
    out = np.empty((B, 8), np.uint32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.msb3_hash_batch(
        words.ctypes.data_as(ctypes.c_char_p), W * 4, W * 4, B,
        out.ctypes.data_as(u32p),
    )
    return out


def native_compress_pairs(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """Merkle 2-to-1 compression of (B, 8) + (B, 8) uint32 digest rows ->
    (B, 8), through the native C helper (one 64-byte single-chunk BLAKE3
    message per pair)."""
    left = np.ascontiguousarray(left, np.uint32)
    right = np.ascontiguousarray(right, np.uint32)
    out = np.empty((left.shape[0], 8), np.uint32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    _native_lib().msb3_compress_pairs(
        left.ctypes.data_as(u32p), right.ctypes.data_as(u32p), left.shape[0], out.ctypes.data_as(u32p),
    )
    return out
