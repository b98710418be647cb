"""BLAKE3 on the host: the native C helper (csrc/host/b3.c, built by
native.py), and the BLAKE3 constants the tensor half shares.

This is the host half of multistark_tpu.hash.blake3, split out so that
nothing here imports JAX.  The Fiat-Shamir challenger (hashing, grinding)
and the claims accumulator use it; the tensor half (row hashing and Merkle
compression, kernel K3) is multistark_tpu_torch.hash.blake3.  The BLAKE3
circuit family's witness (test_circuits/blake3_circuit.py) takes the
compression function from here: `compress` for one, `compress_batch` for
many independent ones in NumPy.  A transcript buffer that holds a claims
array is hashed from its parts (`parts_hash`, `parts_chunk_cvs`), with no
byte image of the claims.
"""
from __future__ import annotations

import ctypes
import weakref
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


_NO_MEMORY = "no memory for the chunk chaining values"


def blake3_hash(data: bytes) -> bytes:
    """Full BLAKE3 hash, 32-byte output, through the native C helper."""
    out = (ctypes.c_uint8 * 32)()
    if _native_lib().msb3_hash(data, len(data), out):
        raise MemoryError(_NO_MEMORY)
    return bytes(out)


_LOCKED: dict = {}  # id(array) -> the live claims segments that hold it read-only


def _unlock(arr: np.ndarray) -> None:
    _LOCKED[id(arr)] -= 1
    if not _LOCKED[id(arr)]:
        del _LOCKED[id(arr)]
        arr.flags.writeable = True


class ClaimsSegment:
    """A homogeneous batch of claims inside a transcript buffer: the (n, L)
    uint64 array `arr`, observed row by row as u64(L) then the L values mod
    p, all little-endian (SerializingChallenger64.observe_claims).  The
    host C helper reads it straight from the array; its bytes are made only
    where a reader asks for them (`parts_bytes`).

    The array is not copied, so it is read-only while a segment holds it: a
    write to the claims before the buffer is hashed would change the
    transcript, and raises instead.  It is writeable again once the last
    segment over it is dropped (by the flush that hashes it, or a reader
    that takes the buffer's bytes)."""

    __slots__ = ("arr", "p", "__weakref__")

    def __init__(self, arr: np.ndarray, p: int):
        self.arr, self.p = arr, p
        if arr.flags.writeable or id(arr) in _LOCKED:
            arr.flags.writeable = False
            _LOCKED[id(arr)] = _LOCKED.get(id(arr), 0) + 1
            weakref.finalize(self, _unlock, arr)

    @property
    def nbytes(self) -> int:
        n, L = self.arr.shape
        return 8 * n * (L + 1)


def part_nbytes(part) -> int:
    """The bytes a part of a transcript buffer stands for (see `parts_hash`)."""
    if isinstance(part, ClaimsSegment):
        return part.nbytes
    return part if isinstance(part, int) else len(part)


def _part_table(parts):
    """The table msb3_parts takes, four u64 a part (kind, address, a, b),
    with its number of parts, the buffers its addresses point into (alive
    until the call returns), and the claims segments' p."""
    words, keep, p = [], [], 0
    for part in parts:
        if isinstance(part, ClaimsSegment):
            arr = part.arr
            if arr.dtype != np.uint64 or arr.ndim != 2 or not arr.flags.c_contiguous:
                raise TypeError("a claims segment holds a C-contiguous (n, L) uint64 array")
            if p and p != part.p:
                raise ValueError("the claims segments of one buffer share p")
            words += (2, arr.ctypes.data, arr.shape[0], arr.shape[1])
            keep.append(arr)
            p = part.p
        elif isinstance(part, int):
            words += (1, 0, part, 0)
        elif len(part):
            if isinstance(part, bytearray):
                view = (ctypes.c_char * len(part)).from_buffer(part)
                address = ctypes.addressof(view)
            else:
                view = ctypes.c_char_p(bytes(part))
                address = ctypes.cast(view, ctypes.c_void_p).value
            words += (0, address, len(part), 0)
            keep.append(view)
    return (ctypes.c_uint64 * max(1, len(words)))(*words), len(words) // 4, keep, p


def parts_hash(parts) -> bytes:
    """BLAKE3 of the concatenated parts: each is host bytes, a
    ClaimsSegment, or an int for that many zero bytes.  No byte image of
    the whole is made; chunks go through the helper 16 at a time."""
    table, k, keep, p = _part_table(parts)
    out = (ctypes.c_uint8 * 32)()
    if _native_lib().msb3_parts(table, k, p, None, out):
        raise MemoryError(_NO_MEMORY)
    del keep
    return bytes(out)


def parts_chunk_cvs(parts) -> np.ndarray:
    """The non-root chaining value of every 1024-byte chunk of the
    concatenated parts (`parts_hash`'s kinds), (n_chunks, 8) uint32: what
    msb3_chunk_cvs gives for their bytes."""
    table, k, keep, p = _part_table(parts)
    total = sum(part_nbytes(part) for part in parts)
    out = np.empty((max(1, -(-total // CHUNK_LEN)), 8), np.uint32)
    _native_lib().msb3_parts(table, k, p, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), None)
    del keep
    return out


def parts_bytes(parts, start: int = 0, stop: int = None) -> bytearray:
    """Bytes [start, stop) of the concatenated parts (`parts_hash`'s kinds;
    stop defaults to, and stops at, their end)."""
    total = sum(part_nbytes(part) for part in parts)
    stop = total if stop is None else min(stop, total)
    out = bytearray(max(0, stop - start))
    if out:
        table, k, keep, p = _part_table(parts)
        view = (ctypes.c_char * len(out)).from_buffer(out)
        _native_lib().msb3_parts_bytes(table, k, p, start, len(out), ctypes.addressof(view))
        del view, keep
    return out


def native_hash_words(words: np.ndarray):
    """Full BLAKE3 of each row of (B, W) uint32 words -> (B, 8) digests,
    through the native C helper."""
    lib = _native_lib()
    words = np.ascontiguousarray(words, np.uint32)
    B, W = words.shape
    out = np.empty((B, 8), np.uint32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    if lib.msb3_hash_batch(words.ctypes.data_as(ctypes.c_char_p), W * 4, W * 4, B, out.ctypes.data_as(u32p)):
        raise MemoryError(_NO_MEMORY)
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
