"""The stage and quotient commit's kernels: K14 (lde_tile) and K15
(merkle_levels), both in csrc/commit_tile.cu.

`lde_tile` runs the last `tile_log` stages of a DIF over a contiguous
(cols, n) batch in place, in tiles of 2^tile_log storage positions of every
column; with hashing on it also hashes each stored row (the Merkle leaf of
the batch's columns, in order) and folds the tile's digests `levels` levels
up the tree, injecting shorter rows' leaf digests where asked.
`merkle_levels` folds a digest layer up `levels` levels with the same
injections, at most 2^10 nodes and 10 levels per block.  `tile_log_for`
picks the tile from the shapes: the largest that fits a block's opt-in
shared memory on an H100.

A CUDA tensor launches the kernel (a build or launch error raises); a CPU
tensor takes the plain PyTorch version beside it: the tile's stages on a
(cols, n / 2^tile_log, 2^tile_log) view, the plain row hash and one plain
pair compress per level.  Digest layers are (h, 8) int32 tensors, as in
merkle.py; an injection is {level: (h >> level, 8) digests}, levels counted
from the input layer.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional

import torch

from . import kernels

SMEM_BYTES = 232448  # an H100's opt-in shared memory per block (227 KB)
CONST_BYTES = 4 * 157  # Poseidon2's round constants, staged beside a hashed tile
MAX_TILE_LOG = 16  # MAX_TILE_LOG in csrc/commit_tile.cu
FOLD_LOG = 10  # MAX_FOLD_LOG in csrc/commit_tile.cu: levels per K15 launch

Injections = Dict[int, torch.Tensor]


def tile_log_for(cols: int, log_n: int, hashed: bool) -> int:
    """The largest k <= log_n whose tile (2^k positions of `cols` u64
    columns, plus 32-byte digests and the round constants when hashed) fits
    SMEM_BYTES.  Raises if not even one row fits."""
    row = 8 * cols + (32 if hashed else 0)
    room = SMEM_BYTES - (CONST_BYTES if hashed else 0)
    if row > room:
        raise ValueError(f"a row of {cols} columns does not fit a tile's shared memory")
    k = 0
    while k < min(log_n, MAX_TILE_LOG) and (row << (k + 1)) <= room:
        k += 1
    return k


def _tail_stages_plain_(F, x: torch.Tensor, tile_log: int, tw: torch.Tensor) -> None:
    from .ntt.ntt import _stage_plain_

    view = x.view(-1, 1 << tile_log)  # (cols · n / 2^k, 2^k): the tiles of every column
    for s in range(tile_log, 0, -1):
        _stage_plain_(F, view, tw[(1 << (s - 1)) - 1 : (1 << s) - 1], dif=True)


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
                   inject: Optional[Injections] = None, hashed: bool = True) -> List[torch.Tensor]:
    _tail_stages_plain_(F, x, tile_log, tw)
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
             inject: Optional[Injections] = None, hashed: bool = True) -> List[torch.Tensor]:
    """K14 on x, a contiguous (cols, n) int64 batch, IN PLACE: DIF stages
    tile_log..1 with `tw` the stages' twiddles concatenated (stage s at
    2^(s-1) - 1, `NttEngine.tail_table`).  When hashed, returns the digest
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
        if not 0 <= levels <= tile_log:
            raise ValueError(f"{levels} levels do not fit a tile of 2^{tile_log}")
        _check_inject(inject, n, levels)
    if not kernels.use_kernel(x):
        return lde_tile_plain(F, hasher, x, tile_log, tw, levels, inject, hashed)
    kernels.check_cuda(x, tw, *inject.values())
    if hashed:
        _check_digests(*inject.values())
        outs = _layers(n, levels + 1, x.device)
        out_p, inj_p = _pointers(outs, inject, 0)
        hasher_id, consts = hasher.kernel_id, hasher.consts(x.device)
    else:
        outs, out_p, inj_p, hasher_id, consts = [], None, None, F.field_id, None
    kernels.LDE_TILE.launch(
        "lde_tile", F.field_id, hasher_id, kernels.ptr(x), cols, log_n, tile_log, kernels.ptr(tw), int(hashed),
        out_p, inj_p, levels, None if consts is None else kernels.ptr(consts),
    )
    return outs


def merkle_levels(hasher, layer: torch.Tensor, levels: int, inject: Optional[Injections] = None) -> List[torch.Tensor]:
    """K15: the `levels` digest layers above `layer` ((h, 8) int32), with
    `inject`'s digests injected at their levels; one launch per FOLD_LOG
    levels."""
    inject = inject or {}
    size = layer.shape[0]
    log_size = size.bit_length() - 1
    if size != 1 << log_size or not 0 <= levels <= log_size:
        raise ValueError(f"{levels} levels above a layer of {size} nodes")
    _check_inject(inject, size, levels)
    if not kernels.use_kernel(layer):
        return merkle_levels_plain(hasher, layer, levels, inject)
    _check_digests(layer, *inject.values())
    consts = hasher.consts(layer.device)
    out: List[torch.Tensor] = []
    done = 0
    while done < levels:
        fold = min(FOLD_LOG, levels - done)
        outs = _layers(size >> (done + 1), fold, layer.device)
        out_p, inj_p = _pointers(outs, inject, done + 1)
        kernels.MERKLE_LEVELS.launch(
            "merkle_levels", hasher.kernel_id, kernels.ptr(layer), log_size - done, fold, out_p, inj_p,
            None if consts is None else kernels.ptr(consts),
        )
        out += outs
        layer = outs[-1]
        done += fold
    return out
