"""Mixed-height Merkle-tree batch commitment (MMCS) over tensors.

The counterpart of multistark_tpu/merkle.py: one tree over a batch of
matrices of power-of-two heights; the leaf layer hashes the rows of all the
tallest matrices, and shorter matrices are *injected* when the digest layer
reaches their height:  layer' = compress(compress(left, right), hash(rows)).
The commitment is a cap of 2^cap_height digests; an opening returns the
per-matrix rows (at index >> (log_max - log_h)) and the sibling path up to
the cap.

Digest layers are (h, 8) int32 tensors (row i = node i's eight u32 words),
so the children of node i are rows 2i and 2i+1.  The config's hasher hashes
the leaves: BLAKE3 through K3 (hash/blake3.py) or Poseidon2 through K6
(hash/poseidon2.py); every tree's levels above the leaves, injections
included, go through K15 (commit_tile.merkle_levels, one launch per tree),
and the PCS's LDE
commits hash their leaves and lowest levels in K14 (pcs.py).  Gathers for
openings are plain tensor indexing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .commit_tile import merkle_levels
from .hash import blake3, poseidon2


class Blake3FieldHasher:
    """Hash field-matrix rows with BLAKE3 over u64-LE serialization
    (p3 SerializingHasher convention)."""

    kernel_id = 0  # the hasher's number in csrc/commit_tile.cu
    hash_plain = staticmethod(blake3.hash_rows_plain)
    compress_plain = staticmethod(blake3.compress_pairs_plain)

    def hash_matrices(self, mats: Sequence[torch.Tensor]) -> torch.Tensor:
        """Same-height (w, n) matrices -> (n, 8) int32 row digests."""
        return blake3.hash_rows(mats)

    def consts(self, device) -> None:
        return None


class Poseidon2FieldHasher:
    """Hash BabyBear-matrix rows with the Poseidon2 padding-free sponge
    (leaf) and truncated permutation (compress); digests are 8 canonical
    field elements."""

    kernel_id = 1
    hash_plain = staticmethod(poseidon2.hash_rows_plain)
    compress_plain = staticmethod(poseidon2.compress_pairs_plain)

    def hash_matrices(self, mats: Sequence[torch.Tensor]) -> torch.Tensor:
        """Same-height (w, n) matrices -> (n, 8) int32 row digests."""
        return poseidon2.hash_rows(mats)

    def consts(self, device) -> torch.Tensor:
        """The round constants the kernels stage, on `device`."""
        return poseidon2.device_constants(device)


def digest_layer_to_np(layer: torch.Tensor) -> np.ndarray:
    """An (h, 8) int32 digest layer -> (h, 8) uint32 numpy."""
    return layer.detach().cpu().contiguous().numpy().view(np.uint32)


@dataclass(frozen=True)
class RowShard:
    """How a tree is split across the ranks of a mesh (parallel.py): the
    matrices of height >= D and the layers below `local_levels` hold this
    rank's contiguous block; the shorter matrices and the layers from
    `local_levels` up are whole, the same on every rank."""

    mesh: Any  # parallel.ProverMesh
    local_levels: int


@dataclass
class MerkleProverData:
    """Device-resident tree: committed matrices + all digest layers."""

    mats: List[torch.Tensor]  # (w, n) int64 matrices in submission order
    dims: List[Tuple[int, int]]  # (width, height) per matrix
    layers: List[torch.Tensor]  # layers[0] = leaves; each (h, 8) int32
    log_max: int
    shard: Optional[RowShard] = None  # None: one device holds the whole tree

    def is_block(self, i: int) -> bool:
        """Whether mats[i] is this rank's block (w, h/D) of a sharded tree."""
        return self.shard is not None and self.dims[i][1] >= self.shard.mesh.n


@dataclass
class BatchOpening:
    """One opened index: per-matrix rows (u64 numpy) + sibling path."""

    opened_rows: List[np.ndarray]
    path: np.ndarray  # (log_max - cap_height, 8) uint32


class MerkleMmcs:
    def __init__(self, hasher, cap_height: int = 0):
        self.hasher = hasher
        self.cap_height = cap_height

    def commit(self, mats: Sequence[torch.Tensor]) -> Tuple[np.ndarray, MerkleProverData]:
        """mats: (w, n) int64 matrices, power-of-two heights.  Returns
        (cap (2^cap_height, 8) uint32 numpy, prover data)."""
        cap, data = self.commit_device(mats)
        return digest_layer_to_np(cap), data

    def commit_device(self, mats: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, MerkleProverData]:
        """`commit` with the cap left where the tree is: a (2^cap_height, 8)
        int32 digest layer, which the device transcript observes without a
        fetch."""
        dims = [(int(m.shape[0]), int(m.shape[1])) for m in mats]
        heights = self.check_heights([h for _, h in dims])
        by_height: Dict[int, list] = {h: [m for m, (_, mh) in zip(mats, dims) if mh == h] for h in heights}
        leaves = self.hasher.hash_matrices(by_height[heights[0]])
        log_max = heights[0].bit_length() - 1
        inject = {log_max - h.bit_length() + 1: self.hasher.hash_matrices(by_height[h]) for h in heights[1:]}
        layers = [leaves] + merkle_levels(self.hasher, leaves, log_max - self.cap_height, inject)
        return layers[-1], MerkleProverData(mats=list(mats), dims=dims, layers=layers, log_max=log_max)

    def check_heights(self, heights: Sequence[int]) -> List[int]:
        """The distinct heights, tallest first; raises on a height that is
        not a power of two, a tree shorter than the cap, or a matrix below
        the cap."""
        heights = sorted(set(heights), reverse=True)
        for h in heights:
            if h & (h - 1):
                raise ValueError(f"height {h} not a power of two")
        if heights[0] < (1 << self.cap_height):
            raise ValueError("cap larger than tree")
        # matrices shorter than the cap would never be injected into a digest
        # (the compress loop stops at the cap), silently unbinding their data
        # -- reject the combination loudly
        if heights[-1] < (1 << self.cap_height):
            raise ValueError(
                f"matrix height {heights[-1]} below cap size {1 << self.cap_height}: "
                "sub-cap matrices are not bound by the commitment"
            )
        return heights

    # -- open (device gathers, one host transfer, host assembly) -----------
    def gather_device(self, data: MerkleProverData, ix) -> tuple:
        """One tree's sibling paths (path_len, Q, 8) int32 and opened rows
        [(w, Q) int64 per matrix] at leaf indices ix, on the device (a tree
        sharded over a mesh opens through parallel.gather_openings)."""
        assert data.shard is None, "a sharded tree's lower layers are rank-local"
        dev = data.layers[0].device
        idx = torch.as_tensor(np.asarray(ix, np.int64), device=dev)
        path_len = data.log_max - self.cap_height
        sibs = [data.layers[lv].index_select(0, (idx >> lv) ^ 1) for lv in range(path_len)]
        sib = torch.stack(sibs) if sibs else torch.zeros((0, len(ix), 8), dtype=torch.int32, device=dev)
        rows = [m.index_select(1, idx >> (data.log_max - (h.bit_length() - 1)))
                for m, (_, h) in zip(data.mats, data.dims)]
        return sib, rows

    def gather_many(self, datas: Sequence[MerkleProverData], indices_list) -> list:
        """Sibling paths and opened rows of many trees at their query
        indices, gathered on the device and fetched to the host in ONE
        transfer.  Returns per tree (sibs (path_len, Q, 8) uint32, rows: per
        matrix (w, Q) uint64)."""
        return self.fetch([self.gather_device(d, ix) for d, ix in zip(datas, indices_list)])

    def fetch(self, gathered) -> list:
        """Device gathers [(sibs, rows)] (gather_device, or
        parallel.gather_openings for sharded trees) to the host in one
        transfer, as gather_many returns them."""
        parts: List[torch.Tensor] = []
        shapes = []
        for sib, rows in gathered:
            parts.append(sib.reshape(-1))
            for r in rows:
                parts.append(r.reshape(-1).view(torch.int32))
            shapes.append((tuple(sib.shape), [tuple(r.shape) for r in rows]))
        flat = torch.cat(parts).cpu().numpy().view(np.uint32) if parts else np.zeros(0, np.uint32)
        out, off = [], 0
        for sib_shape, row_shapes in shapes:
            k = int(np.prod(sib_shape))
            sib = flat[off : off + k].reshape(sib_shape)
            off += k
            rows = []
            for shp in row_shapes:
                k = 2 * int(np.prod(shp))
                rows.append(flat[off : off + k].view(np.uint64).reshape(shp))
                off += k
            out.append((sib, rows))
        return out

    def assemble(self, data: MerkleProverData, n_queries: int, fetched) -> List[BatchOpening]:
        """Per-query openings from one tree's fetched gathers."""
        sib, rows = fetched
        return [
            BatchOpening(
                opened_rows=[r[:, qi] for r in rows],
                path=np.ascontiguousarray(sib[:, qi]),
            )
            for qi in range(n_queries)
        ]

    def open_batch(self, data: MerkleProverData, indices) -> List[BatchOpening]:
        """Open all `indices` (leaf-level, < 2^log_max) in one pass."""
        return self.assemble(data, len(indices), self.gather_many([data], [indices])[0])
