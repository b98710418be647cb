"""BLAKE3 over tensors: kernel K3 (blake3_merkle).

`hash_rows` is the full BLAKE3 of each row's u64-LE serialization across
several same-height (w_j, n) matrices (the Merkle leaf).  Digests are (n, 8)
int32 tensors holding the u32 words.  The Merkle 2-to-1, blake3(left ||
right), runs on the card inside K14 and K15 (commit_tile.py);
`compress_pairs_plain` is its plain version.

A CUDA tensor launches the hand-written kernel (csrc/blake3_merkle.cu); a
CPU tensor takes the plain PyTorch version beside it, which computes the
u32 words in int64 with masking, vectorized over rows.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from .. import kernels
from .blake3_host import BLOCK_LEN, CHUNK_END, CHUNK_LEN, CHUNK_START, IV, MSG_PERM, PARENT, ROOT, _left_len

_M32 = 0xFFFFFFFF
_MAX_MATS = 16  # MAX_MATS in csrc/blake3_merkle.cu


# --- plain PyTorch version (any device) -----------------------------------------

def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & _M32


def _g(s, a, b, c, d, mx, my):
    s[a] = (s[a] + s[b] + mx) & _M32
    s[d] = _rotr(s[d] ^ s[a], 16)
    s[c] = (s[c] + s[d]) & _M32
    s[b] = _rotr(s[b] ^ s[c], 12)
    s[a] = (s[a] + s[b] + my) & _M32
    s[d] = _rotr(s[d] ^ s[a], 8)
    s[c] = (s[c] + s[d]) & _M32
    s[b] = _rotr(s[b] ^ s[c], 7)


def _compress_plain(cv: List[torch.Tensor], block: List[torch.Tensor], counter: int, block_len: int, flags: int):
    """Batched compression over int64 word vectors (values < 2^32)."""
    z = torch.zeros_like(cv[0])
    s = list(cv) + [z + IV[0], z + IV[1], z + IV[2], z + IV[3],
                    z + (counter & _M32), z + (counter >> 32), z + block_len, z + flags]
    m = list(block)
    for _ in range(7):
        _g(s, 0, 4, 8, 12, m[0], m[1])
        _g(s, 1, 5, 9, 13, m[2], m[3])
        _g(s, 2, 6, 10, 14, m[4], m[5])
        _g(s, 3, 7, 11, 15, m[6], m[7])
        _g(s, 0, 5, 10, 15, m[8], m[9])
        _g(s, 1, 6, 11, 12, m[10], m[11])
        _g(s, 2, 7, 8, 13, m[12], m[13])
        _g(s, 3, 4, 9, 14, m[14], m[15])
        m = [m[p] for p in MSG_PERM]
    return [s[i] ^ s[i + 8] for i in range(8)]


def _to_i32(words: torch.Tensor) -> torch.Tensor:
    return torch.where(words >= (1 << 31), words - (1 << 32), words).to(torch.int32)


def _words(x: torch.Tensor) -> torch.Tensor:
    """int32 digest words -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & _M32


def _hash_words_plain(words: torch.Tensor) -> torch.Tensor:
    """Full BLAKE3 of each row of (B, W) int64 u32 words -> (B, 8) int64."""
    B, W = words.shape
    n_bytes = W * 4
    n_chunks = max(1, -(-n_bytes // CHUNK_LEN))
    pad = n_chunks * (CHUNK_LEN // 4) - W
    words = torch.cat([words, words.new_zeros((B, pad))], dim=1)
    cvs = []
    for c in range(n_chunks):
        cb = min(CHUNK_LEN, n_bytes - c * CHUNK_LEN)
        n_blocks = max(1, -(-cb // BLOCK_LEN))
        cv = [torch.full((B,), IV[i], dtype=torch.int64, device=words.device) for i in range(8)]
        for b in range(n_blocks):
            flags = (CHUNK_START if b == 0 else 0) | (CHUNK_END if b == n_blocks - 1 else 0)
            if n_chunks == 1 and b == n_blocks - 1:
                flags |= ROOT
            off = c * (CHUNK_LEN // 4) + 16 * b
            blen = min(BLOCK_LEN, cb - b * BLOCK_LEN)
            cv = _compress_plain(cv, [words[:, off + i] for i in range(16)], c, blen, flags)
        cvs.append(cv)

    def tree(sub, is_root):
        if len(sub) == 1:
            return sub[0]
        split = _left_len(len(sub))
        left, right = tree(sub[:split], False), tree(sub[split:], False)
        cv = [torch.full((B,), IV[i], dtype=torch.int64, device=words.device) for i in range(8)]
        return _compress_plain(cv, left + right, 0, BLOCK_LEN, PARENT | (ROOT if is_root else 0))

    return torch.stack(tree(cvs, True), dim=1)


def hash_rows_plain(mats: Sequence[torch.Tensor]) -> torch.Tensor:
    cols = []
    for m in mats:
        cols.append(torch.stack([m & _M32, (m >> 32) & _M32], dim=1).reshape(-1, m.shape[1]))
    words = torch.cat(cols, dim=0).T.contiguous()  # (n, W): element-major, low word first
    return _to_i32(_hash_words_plain(words))


def compress_pairs_plain(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    block = [_words(left[:, i]) for i in range(8)] + [_words(right[:, i]) for i in range(8)]
    cv = [torch.full_like(block[0], IV[i]) for i in range(8)]
    out = _compress_plain(cv, block, 0, BLOCK_LEN, CHUNK_START | CHUNK_END | ROOT)
    return _to_i32(torch.stack(out, dim=1))


# --- dispatch -------------------------------------------------------------------

def hash_rows(mats: Sequence[torch.Tensor]) -> torch.Tensor:
    """Leaf digests (n, 8) int32 of the rows of same-height (w_j, n) int64
    matrices, concatenated in order, each element as u64-LE."""
    mats = [m.contiguous() for m in mats]
    n = mats[0].shape[1]
    if any(m.dim() != 2 or m.shape[1] != n or m.dtype != torch.int64 for m in mats):
        raise ValueError("hash_rows takes same-height (w, n) int64 matrices")
    dev = mats[0].device
    if not kernels.use_kernel(mats[0]):
        return hash_rows_plain(mats)
    if len(mats) > _MAX_MATS:
        raise ValueError(f"hash_rows takes at most {_MAX_MATS} matrices")
    kernels.check_cuda(*mats)
    out = torch.empty((n, 8), dtype=torch.int32, device=dev)
    ptrs = (ctypes.c_void_p * len(mats))(*[m.data_ptr() for m in mats])
    widths = (ctypes.c_int64 * len(mats))(*[m.shape[0] for m in mats])
    row_bytes = 8 * sum(m.shape[0] for m in mats)
    kernels.BLAKE3_MERKLE.launch(
        "b3_hash_rows", ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(widths, ctypes.c_void_p),
        len(mats), n, kernels.ptr(out),
        cost=((row_bytes + 32) * n, n * max(1, -(-row_bytes // 64)) * kernels.OPS_PER_BLAKE3),
    )
    return out
