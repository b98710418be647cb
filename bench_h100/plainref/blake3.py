"""BLAKE3 in NumPy: the compression function over many rows at once, and the
full hash of many equal-length messages or of one long message.

Written from the BLAKE3 specification (one 1024-byte chunk is a chain of
64-byte blocks; chunk chaining values merge pairwise, left to right, with
an odd node carried up, which gives the left-balanced tree of the
specification; the last node to be compressed gets the ROOT flag).  The
tests hold it against the official test vectors' first bytes.
"""

from __future__ import annotations

import numpy as np

IV = np.array([0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
               0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19], np.uint32)
MSG_PERM = [2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8]
CHUNK_START, CHUNK_END, PARENT, ROOT = 1, 2, 4, 8
CHUNK_LEN, BLOCK_LEN = 1024, 64
# G's four state words per call of a round: the columns, then the diagonals
_G = ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
      (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14))


def _rotr(x: np.ndarray, n: int) -> np.ndarray:
    return (x >> np.uint32(n)) | (x << np.uint32(32 - n))


def compress(cv, block, counter, block_len, flags) -> np.ndarray:
    """n compressions: cv (n, 8) and block (n, 16) uint32 words, counter,
    block_len and flags (n,) or scalars.  Returns the (n, 16) output."""
    cv = np.asarray(cv, np.uint32)
    n = cv.shape[0]
    counter = np.broadcast_to(np.asarray(counter, np.uint64), (n,))
    st = np.empty((16, n), np.uint32)
    st[:8] = cv.T
    st[8:12] = IV[:4, None]
    st[12] = (counter & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    st[13] = (counter >> np.uint64(32)).astype(np.uint32)
    st[14] = np.broadcast_to(np.asarray(block_len, np.uint32), (n,))
    st[15] = np.broadcast_to(np.asarray(flags, np.uint32), (n,))
    m = np.ascontiguousarray(np.asarray(block, np.uint32).T)
    with np.errstate(over="ignore"):
        for _ in range(7):
            for gi, (a, b, c, d) in enumerate(_G):
                st[a] += st[b] + m[2 * gi]
                st[d] = _rotr(st[d] ^ st[a], 16)
                st[c] += st[d]
                st[b] = _rotr(st[b] ^ st[c], 12)
                st[a] += st[b] + m[2 * gi + 1]
                st[d] = _rotr(st[d] ^ st[a], 8)
                st[c] += st[d]
                st[b] = _rotr(st[b] ^ st[c], 7)
            m = m[MSG_PERM]
    return np.concatenate([st[:8] ^ st[8:], st[8:] ^ cv.T]).T.copy()


def hash_many(data: np.ndarray) -> np.ndarray:
    """The BLAKE3 digests of the B rows of data ((B, L) uint8, each row one
    message of L bytes), as (B, 8) uint32 little-endian words."""
    data = np.ascontiguousarray(data, np.uint8)
    B, L = data.shape
    n_chunks = max(1, -(-L // CHUNK_LEN))
    padded = np.zeros((B, n_chunks * CHUNK_LEN), np.uint8)
    padded[:, :L] = data
    words = padded.view("<u4").reshape(B, n_chunks, CHUNK_LEN // BLOCK_LEN, 16)
    last_len = L - (n_chunks - 1) * CHUNK_LEN
    blocks = [CHUNK_LEN // BLOCK_LEN] * (n_chunks - 1) + [max(1, -(-last_len // BLOCK_LEN))]
    cv = np.broadcast_to(IV, (B, n_chunks, 8)).copy()
    counters = np.broadcast_to(np.arange(n_chunks, dtype=np.uint64), (B, n_chunks))
    for b in range(max(blocks)):
        act = np.asarray([c for c in range(n_chunks) if blocks[c] > b])
        blen = np.asarray([BLOCK_LEN if c < n_chunks - 1 else min(BLOCK_LEN, last_len - BLOCK_LEN * b) for c in act],
                          np.uint32)
        flags = np.asarray([(CHUNK_START if b == 0 else 0) | (CHUNK_END if blocks[c] - 1 == b else 0) |
                            (ROOT if n_chunks == 1 and blocks[c] - 1 == b else 0) for c in act], np.uint32)
        k = len(act)
        out = compress(cv[:, act].reshape(B * k, 8), words[:, act, b].reshape(B * k, 16),
                       counters[:, act].reshape(B * k), np.tile(blen, B), np.tile(flags, B))
        cv[:, act] = out[:, :8].reshape(B, k, 8)
    nodes = cv  # (B, n, 8): merge pairs left to right, carrying an odd last node up
    while nodes.shape[1] > 1:
        n = nodes.shape[1]
        pairs = n // 2
        flag = PARENT | (ROOT if n == 2 else 0)
        block = np.concatenate([nodes[:, 0:2 * pairs:2], nodes[:, 1:2 * pairs:2]], axis=2).reshape(B * pairs, 16)
        merged = compress(np.broadcast_to(IV, (B * pairs, 8)), block, 0, BLOCK_LEN, flag)[:, :8]
        merged = merged.reshape(B, pairs, 8)
        nodes = np.concatenate([merged, nodes[:, 2 * pairs:]], axis=1) if n % 2 else merged
    return np.ascontiguousarray(nodes[:, 0])


def hash_bytes(data: bytes) -> bytes:
    """The 32-byte BLAKE3 digest of one message."""
    return hash_many(np.frombuffer(data, np.uint8).reshape(1, -1)).astype("<u4").tobytes()


def hash_rows_u64(rows: np.ndarray) -> np.ndarray:
    """Merkle leaves: each row of (B, w) uint64 field elements hashed as its
    u64 little-endian bytes -> (B, 8) uint32 digests."""
    rows = np.ascontiguousarray(rows, "<u8")
    return hash_many(rows.view(np.uint8).reshape(rows.shape[0], -1))


def compress_pairs(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """Merkle nodes: BLAKE3 of each 64-byte left ‖ right pair of (B, 8)
    digests -> (B, 8) digests."""
    block = np.concatenate([np.asarray(left, np.uint32), np.asarray(right, np.uint32)], axis=1)
    n = block.shape[0]
    return compress(np.broadcast_to(IV, (n, 8)), block, 0, BLOCK_LEN, CHUNK_START | CHUNK_END | ROOT)[:, :8]
