"""The mixed-height Merkle tree (MMCS) with BLAKE3: one tree over matrices
of power-of-two heights; the leaves hash the rows of the tallest matrices
(u64 little-endian), nodes hash left ‖ right, and a shorter matrix is
injected when the layer reaches its height:
layer' = compress(compress(left, right), hash(rows)).  The commitment is a
cap of 2^cap_height digests; an opening gives each matrix's row at
index >> (log_max - log_h) and the sibling path up to the cap."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .blake3 import compress_pairs, hash_rows_u64


@dataclass
class BatchOpening:
    """One opened index: per-matrix rows (u64 numpy) + sibling path."""

    opened_rows: List[np.ndarray]
    path: np.ndarray  # (log_max - cap_height, 8) uint32


class _Hasher:
    np_hash_rows_batch = staticmethod(hash_rows_u64)
    np_compress_batch = staticmethod(compress_pairs)


class MerkleMmcs:
    def __init__(self, cap_height: int = 0):
        self.hasher = _Hasher()
        self.cap_height = cap_height

    def commit(self, mats: Sequence[np.ndarray]) -> np.ndarray:
        """The cap over (h, w) uint64 matrices (storage order)."""
        heights = sorted({m.shape[0] for m in mats}, reverse=True)
        by_height = {h: np.concatenate([m for m in mats if m.shape[0] == h], axis=1) for h in heights}
        node = hash_rows_u64(by_height[heights[0]])
        size = heights[0]
        while size > 1 << self.cap_height:
            node = compress_pairs(node[0::2], node[1::2])
            size >>= 1
            if size in by_height:
                node = compress_pairs(node, hash_rows_u64(by_height[size]))
        return node


def mmcs_verify_batch_queries(mmcs: MerkleMmcs, cap: np.ndarray, dims: Sequence[Tuple[int, int]], indices,
                              openings: Sequence[BatchOpening], log_max: Optional[int] = None) -> bool:
    """Verify all query openings of one tree at once: a few batched host C
    hash calls per level instead of one per query and node.  Ragged or
    malformed openings are a failed check."""
    try:
        return _verify_batch_queries_impl(mmcs, cap, dims, indices, openings, log_max)
    except (ValueError, TypeError):
        return False


def _verify_batch_queries_impl(mmcs, cap, dims, indices, openings, log_max) -> bool:
    if log_max is None:
        log_max = max(h for _, h in dims).bit_length() - 1
    heights = sorted({h for _, h in dims}, reverse=True)
    if heights[-1] < (1 << mmcs.cap_height):
        return False  # sub-cap matrices are never bound (see check_heights)
    if heights[0] != 1 << log_max:
        return False
    for op in openings:
        for i, (w, h) in enumerate(dims):
            if len(op.opened_rows[i]) != w:
                return False
    idx = np.asarray(indices, np.int64)
    by_height = {
        h: np.concatenate([np.stack([np.asarray(op.opened_rows[i], np.uint64) for op in openings])
                           for i, (w, mh) in enumerate(dims) if mh == h], axis=1)
        for h in heights
    }
    paths = np.stack([op.path for op in openings])  # (B, path_len, 8)
    if paths.shape[1] != log_max - mmcs.cap_height:
        return False
    node = mmcs.hasher.np_hash_rows_batch(by_height[heights[0]])
    size = heights[0]
    for l in range(log_max - mmcs.cap_height):
        sib = paths[:, l].astype(np.uint32)
        bit = ((idx >> l) & 1).astype(bool)[:, None]
        node = mmcs.hasher.np_compress_batch(np.where(bit, sib, node), np.where(bit, node, sib))
        size >>= 1
        if size in by_height:
            node = mmcs.hasher.np_compress_batch(node, mmcs.hasher.np_hash_rows_batch(by_height[size]))
    final_idx = idx >> (log_max - mmcs.cap_height)
    return bool(np.array_equal(np.atleast_2d(cap)[final_idx], node))
