"""BLAKE3 on the host: the native C helper (csrc/host/b3.c, built by
native.py), and the BLAKE3 constants the tensor half shares.

This is the host half of multistark_tpu.hash.blake3, split out so that
nothing here imports JAX.  The Fiat-Shamir challenger (hashing, grinding)
and the claims accumulator use it; the tensor half (row hashing and Merkle
compression, kernel K3) is multistark_tpu_torch.hash.blake3.
"""
from __future__ import annotations

import ctypes

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
