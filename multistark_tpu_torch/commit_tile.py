"""The stage and quotient commit's kernels: K14 (lde_tile) and K15
(merkle_levels), both in csrc/commit_tile.cu.

`lde_tile` runs the last `tile_log` stages of a DIF (or the first
`tile_log` stages of a DIT) over a contiguous (cols, n) batch in place, in
tiles of 2^tile_log storage positions of every column; with hashing on (DIF
only) it also hashes each stored row (the Merkle leaf of the batch's
columns, in order) and folds the tile's digests `levels` levels up the
tree, injecting shorter rows' leaf digests where asked.  `merkle_levels`
folds a digest layer up `levels` levels with the same injections in one
launch, by the plan `levels_plan` makes from the layer's size: each block
of the first tier folds a subtree, and the last block of each group to
finish folds the group's roots higher.  `tile_log_for` picks the tile from
the shapes: the largest that lets BLOCKS_PER_SM blocks share an H100 SM (a
hashed tile at most a row per thread), and at least a warp of rows where
one block's opt-in shared memory allows it.

A CUDA tensor launches the kernel (a build or launch error raises); a CPU
tensor takes the plain PyTorch version beside it: the tile's stages on a
(cols, n / 2^tile_log, 2^tile_log) view, the plain row hash and one plain
pair compress per level.  Digest layers are (h, 8) int32 tensors, as in
merkle.py; an injection is {level: (h >> level, 8) digests}, levels counted
from the input layer.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from . import kernels, utils

SMEM_BYTES = 232448  # an H100's opt-in shared memory per block (227 KB)
SM_SMEM_BYTES = 233472  # an H100 SM's shared memory (228 KB), 1 KB of it reserved per resident block
BLOCKS_PER_SM = 3  # K14 blocks a tile should leave room for on one SM
TILE_BUDGET = SM_SMEM_BYTES // BLOCKS_PER_SM - 1024
WARP_LOG = 5  # a warp: 2^5 rows hash, or nodes fold, in parallel
HASHED_ROWS_LOG = 8  # TILE_THREADS in csrc/commit_tile.cu: a hashed tile has at most a row per thread
CONST_BYTES = 4 * 157  # Poseidon2's round constants, staged beside a hashed tile
MAX_TILE_LOG = 16  # MAX_TILE_LOG in csrc/commit_tile.cu
SMS = 132  # an H100 SXM's SMs
TREE_THREADS = 256  # TREE_THREADS in csrc/commit_tile.cu: a K15 block's most threads
MAX_GROUP_LOG = 10  # MAX_GROUP_LOG in csrc/commit_tile.cu: the most levels one K15 block folds per tier
MAX_TIERS = 8  # MAX_TIERS in csrc/commit_tile.cu
SPREAD_LOG = (SMS - 1).bit_length()  # 2^8 = 256 first-tier blocks cover every SM
MIN_GROUP_LOG = 6  # a first-tier block of a spread tree folds at least 2^6 nodes: a warp of first-level nodes
NODE_LANES = (1, 4)  # H::LANES in csrc/commit_tile.cu by hasher kernel id: lanes per node at the narrow levels

MODE_DIF, MODE_HASHED, MODE_DIT = 0, 1, 2  # K14's modes in csrc/commit_tile.cu

Injections = Dict[int, torch.Tensor]


@dataclass(frozen=True)
class LevelsPlan:
    """K15's launch for `levels` levels above a layer of 2^log_size nodes:
    each of `blocks` first-tier blocks folds tiers[0] levels of its own
    subtree; tier t >= 1 is folded by the last block to finish of each group
    of 2^tiers[t] blocks of the tier below (its arrival counters:
    `counters` words in all); `threads` per block."""

    tiers: Tuple[int, ...]
    blocks: int
    threads: int
    counters: int


def levels_plan(log_size: int, levels: int, lanes: int = 1) -> LevelsPlan:
    """The plan of one K15 launch.  A layer whose first level fits one
    block's threads (2^(log_size - 1) <= TREE_THREADS) is folded whole by
    each of the 2^(log_size - levels) top nodes' blocks.  A larger one is
    spread: first-tier blocks of 2^s0 nodes, s0 = log_size - SPREAD_LOG (at
    least MIN_GROUP_LOG, at most MAX_GROUP_LOG and `levels`), so that from
    2^16 nodes up the first level's blocks (256 or more) cover all SMS SMs;
    the levels above go in as few tiers as MAX_GROUP_LOG allows, split
    evenly.  Threads: `lanes` (the hasher's NODE_LANES) per first-level
    node of the largest tier, 32 to TREE_THREADS."""
    if not 1 <= levels <= log_size:
        raise ValueError(f"{levels} levels above a layer of 2^{log_size} nodes")
    if log_size - 1 <= TREE_THREADS.bit_length() - 1:
        s0 = levels
    else:
        s0 = min(levels, MAX_GROUP_LOG, max(MIN_GROUP_LOG, log_size - SPREAD_LOG))
    rest = levels - s0
    n = -(-rest // MAX_GROUP_LOG)
    tiers = (s0,) + tuple(rest // n + (i < rest % n) for i in range(n))
    if len(tiers) > MAX_TIERS:
        raise ValueError(f"{levels} levels above 2^{log_size} nodes need more than {MAX_TIERS} tiers")
    blocks = 1 << (log_size - s0)
    counters, groups = 0, blocks
    for s in tiers[1:]:
        groups >>= s
        counters += groups
    threads = min(TREE_THREADS, max(32, lanes << (max(tiers) - 1)))
    return LevelsPlan(tiers, blocks, threads, counters)


def tile_log_for(cols: int, log_n: int, hashed: bool) -> int:
    """K14's tile for a (cols, 2^log_n) batch: the largest k <= log_n (and,
    when hashed, <= HASHED_ROWS_LOG) whose tile (2^k positions of `cols` u64
    columns, plus 32-byte digests and the round constants when hashed) fits
    TILE_BUDGET, so that BLOCKS_PER_SM blocks share an SM; raised towards
    2^WARP_LOG rows while it fits SMEM_BYTES, so that wide rows still hash a
    warp at a time.  Raises if not even one row fits."""
    if tile_bytes(cols, 0, hashed) > SMEM_BYTES:
        raise ValueError(f"a row of {cols} columns does not fit a tile's shared memory")
    top = min(log_n, MAX_TILE_LOG, HASHED_ROWS_LOG if hashed else MAX_TILE_LOG)
    k = 0
    while k < top and tile_bytes(cols, k + 1, hashed) <= TILE_BUDGET:
        k += 1
    while k < min(top, WARP_LOG) and tile_bytes(cols, k + 1, hashed) <= SMEM_BYTES:
        k += 1
    return k


def tile_bytes(cols: int, k: int, hashed: bool) -> int:
    """K14's shared memory for a tile of 2^k rows of `cols` u64 columns (its
    elements in whole runs of 16), plus 32-byte digests and the round
    constants when hashed: the launch's size in csrc/commit_tile.cu."""
    slots = -(-(cols << k) // 16) * 16
    return 8 * slots + ((32 << k) + CONST_BYTES if hashed else 0)


def _tail_stages_plain_(F, x: torch.Tensor, tile_log: int, tw: torch.Tensor, dif: bool = True) -> None:
    from .ntt.ntt import _stage_plain_

    view = x.view(-1, 1 << tile_log)  # (cols · n / 2^k, 2^k): the tiles of every column
    for s in range(tile_log, 0, -1) if dif else range(1, tile_log + 1):
        _stage_plain_(F, view, tw[(1 << (s - 1)) - 1 : (1 << s) - 1], dif)


def merkle_levels_plain(hasher, layer: torch.Tensor, levels: int,
                        inject: Optional[Injections] = None) -> List[torch.Tensor]:
    out = []
    for lv in range(1, levels + 1):
        layer = hasher.compress_plain(layer[0::2], layer[1::2])
        if inject and lv in inject:
            layer = hasher.compress_plain(layer, inject[lv])
        out.append(layer)
    return out


def lde_tile_plain(F, hasher, x: torch.Tensor, tile_log: int, tw: torch.Tensor, levels: int = 0,
                   inject: Optional[Injections] = None, hashed: bool = True, dif: bool = True) -> List[torch.Tensor]:
    _tail_stages_plain_(F, x, tile_log, tw, dif)
    if not hashed:
        return []
    leaves = hasher.hash_plain([x])
    return [leaves] + merkle_levels_plain(hasher, leaves, levels, inject)


def _check_digests(*layers: torch.Tensor) -> None:
    for t in layers:
        if t.dim() != 2 or t.shape[1] != 8 or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("digest layers are contiguous (h, 8) int32 tensors")
        if t.data_ptr() % 16:
            raise ValueError("digest layers must be 16-byte aligned")


def _layers(size: int, count: int, device) -> List[torch.Tensor]:
    """`count` digest layers of size, size / 2, ... in one allocation."""
    sizes = [size >> lv for lv in range(count)]
    buf = torch.empty((sum(sizes), 8), dtype=torch.int32, device=device)
    return list(torch.split(buf, sizes))


def _pointers(outs: List[torch.Tensor], inject: Injections, first: int):
    """Host arrays of the output layers' and the injections' device
    pointers; injection level first + i goes beside outs[i]."""
    out_arr = (ctypes.c_void_p * len(outs))(*[t.data_ptr() for t in outs])
    inj_arr = (ctypes.c_void_p * len(outs))(*[inject[first + i].data_ptr() if first + i in inject else None
                                              for i in range(len(outs))])
    return ctypes.cast(out_arr, ctypes.c_void_p), ctypes.cast(inj_arr, ctypes.c_void_p)


def _check_inject(inject: Injections, size: int, levels: int) -> None:
    for lv, d in inject.items():
        if not 1 <= lv <= levels or d.shape != (size >> lv, 8):
            raise ValueError(f"injection at level {lv} of shape {tuple(d.shape)} does not fit the tree")


def lde_tile(F, hasher, x: torch.Tensor, tile_log: int, tw: torch.Tensor, levels: int = 0,
             inject: Optional[Injections] = None, hashed: bool = True, dif: bool = True) -> List[torch.Tensor]:
    """K14 on x, a contiguous (cols, n) int64 batch, IN PLACE: DIF stages
    tile_log..1 (or, with dif=False, DIT stages 1..tile_log) with `tw` the
    stages' twiddles concatenated (stage s at 2^(s-1) - 1,
    `NttEngine.tail_table`).  When hashed (DIF only), returns the digest
    layers [leaves (n, 8), level 1, ..., level `levels`] with `inject`'s
    digests injected at their levels (levels <= tile_log); else []."""
    inject = inject or {}
    if x.dim() != 2 or not x.is_contiguous() or x.dtype != torch.int64:
        raise ValueError("lde_tile takes a contiguous (cols, n) int64 tensor")
    cols, n = x.shape
    log_n = n.bit_length() - 1
    if n != 1 << log_n or not 0 <= tile_log <= min(log_n, MAX_TILE_LOG):
        raise ValueError(f"bad tile geometry n={n} tile_log={tile_log}")
    if tw.shape[0] < (1 << tile_log) - 1:
        raise ValueError("twiddle table shorter than the tile's stages")
    if hashed:
        if not dif:
            raise ValueError("lde_tile hashes the rows of a DIF only")
        if not 0 <= levels <= tile_log:
            raise ValueError(f"{levels} levels do not fit a tile of 2^{tile_log}")
        _check_inject(inject, n, levels)
    if not kernels.use_kernel(x):
        return lde_tile_plain(F, hasher, x, tile_log, tw, levels, inject, hashed, dif)
    kernels.check_cuda(x, tw, *inject.values())
    if hashed:
        _check_digests(*inject.values())
        outs = _layers(n, levels + 1, x.device)
        out_p, inj_p = _pointers(outs, inject, 0)
        hasher_id, consts = hasher.kernel_id, hasher.consts(x.device)
    else:
        outs, out_p, inj_p, hasher_id, consts = [], None, None, F.field_id, None
    n_bytes, ops = 16 * x.numel() + 8 * ((1 << tile_log) - 1), 0
    if hashed:  # the digest layers written, the injected ones read; the leaves' and the levels' hashes
        n_bytes += 32 * sum(t.shape[0] for t in outs) + 32 * sum(t.shape[0] for t in inject.values())
        leaf_hashes = -(-(8 * cols) // 64) if hasher_id == 0 else -(-cols // 8)
        nodes = sum(t.shape[0] for t in outs[1:]) + sum(t.shape[0] for t in inject.values())
        ops = (n * leaf_hashes + nodes) * kernels.OPS_PER_HASH[hasher_id]
    kernels.LDE_TILE.launch(
        "lde_tile", F.field_id, hasher_id, kernels.ptr(x), cols, log_n, tile_log, kernels.ptr(tw),
        MODE_HASHED if hashed else MODE_DIF if dif else MODE_DIT,
        out_p, inj_p, levels, None if consts is None else kernels.ptr(consts), cost=(n_bytes, ops),
    )
    return outs


def merkle_levels(hasher, layer: torch.Tensor, levels: int, inject: Optional[Injections] = None,
                  plan: Optional[LevelsPlan] = None) -> List[torch.Tensor]:
    """K15: the `levels` digest layers above `layer` ((h, 8) int32), with
    `inject`'s digests injected at their levels; one launch, by
    `levels_plan(log2 h, levels, the hasher's NODE_LANES)` unless `plan`
    names another (tests force small tiers)."""
    inject = inject or {}
    size = layer.shape[0]
    log_size = size.bit_length() - 1
    if size != 1 << log_size or not 0 <= levels <= log_size:
        raise ValueError(f"{levels} levels above a layer of {size} nodes")
    _check_inject(inject, size, levels)
    if not kernels.use_kernel(layer):
        return merkle_levels_plain(hasher, layer, levels, inject)
    _check_digests(layer, *inject.values())
    if levels == 0:
        return []
    plan = plan or levels_plan(log_size, levels, NODE_LANES[hasher.kernel_id])
    if sum(plan.tiers) != levels or plan.blocks != 1 << (log_size - plan.tiers[0]):
        raise ValueError(f"plan {plan} does not fold {levels} levels above 2^{log_size} nodes")
    consts = hasher.consts(layer.device)
    outs = _layers(size >> 1, levels, layer.device)
    out_p, inj_p = _pointers(outs, inject, 1)
    tiers = (ctypes.c_int * len(plan.tiers))(*plan.tiers)
    counters = utils.scratch(layer).take_counters(layer, plan.counters)
    injected = sum(d.shape[0] for d in inject.values())
    nodes = size - (size >> levels) + injected  # compressions
    kernels.MERKLE_LEVELS.launch(
        "merkle_levels", hasher.kernel_id, kernels.ptr(layer), log_size, levels, out_p, inj_p,
        ctypes.cast(tiers, ctypes.c_void_p), len(plan.tiers), plan.threads, kernels.ptr(counters),
        counters.numel(), None if consts is None else kernels.ptr(consts),
        cost=(32 * (size + size - (size >> levels) + injected), nodes * kernels.OPS_PER_HASH[hasher.kernel_id]),
    )
    return outs


def node_chain_plain(hasher, digest: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        digest = hasher.compress_plain(digest, digest)
    return digest


def node_chain(hasher, digest: torch.Tensor, n: int) -> torch.Tensor:
    """K15's node compressing a (1, 8) int32 digest with itself n times in a
    row, as the narrow levels run it (one thread for BLAKE3, a group of
    four lanes for Poseidon2): n compressions' latency on the card (a
    measurement: it is not a launch of K15 and is not counted).  The plain
    version on a CPU tensor."""
    if tuple(digest.shape) != (1, 8) or n < 0:
        raise ValueError("node_chain takes a (1, 8) digest and n >= 0")
    if not kernels.use_kernel(digest):
        return node_chain_plain(hasher, digest, n)
    out = digest.clone()
    _check_digests(out)
    consts = hasher.consts(out.device)
    rc = kernels.library().node_chain(hasher.kernel_id, kernels.ptr(out), n,
                                      None if consts is None else kernels.ptr(consts), kernels.current_stream())
    if rc != 0:
        raise RuntimeError(f"node_chain failed with cudaError_t {rc}")
    return out
