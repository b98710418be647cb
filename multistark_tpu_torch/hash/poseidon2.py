"""Poseidon2 (BabyBear, width 16) over tensors: kernel K6 (poseidon2_merkle).

`hash_rows` is the padding-free sponge (rate 8) over each row's values
across several same-height (w_j, n) matrices (the Merkle leaf).  The Merkle
2-to-1, the permutation of left || right truncated to 8 lanes, runs on the
card inside K14 and K15 (commit_tile.py); `compress_pairs_plain` is its
plain version.  Inputs are int64 tensors of canonical BabyBear
values; digests are (n, 8) int32 tensors of canonical words, the layout
merkle.py uses for BLAKE3.

A CUDA tensor launches the hand-written kernel (csrc/poseidon2_merkle.cu);
a CPU tensor takes the plain PyTorch version beside it, which runs the
permutation vectorized over rows in int64 (every product of two values
below 2^31 is exact).  The constants are hash/poseidon2_host.py's.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence

import torch

from .. import kernels
from .poseidon2_host import _M4, CONSTANTS, CONSTANTS_U32, OUT, P, RATE, ROUNDS_F, ROUNDS_P, WIDTH

_MAX_MATS = 16  # MAX_MATS in csrc/poseidon2_merkle.cu
_DEVICE_CONSTS: Dict[torch.device, torch.Tensor] = {}


# --- plain PyTorch version (any device) -----------------------------------------

def _sbox(x):
    x2 = x * x % P
    x4 = x2 * x2 % P
    return x4 * x2 % P * x % P


def _external_linear(s: List[torch.Tensor]) -> List[torch.Tensor]:
    t = [None] * WIDTH
    for b in range(0, WIDTH, 4):
        for i in range(4):
            t[b + i] = sum(_M4[i][j] * s[b + j] for j in range(4)) % P
    sums = [sum(t[b + i] for b in range(0, WIDTH, 4)) for i in range(4)]
    return [(t[k] + sums[k % 4]) % P for k in range(WIDTH)]


def _internal_linear(s: List[torch.Tensor]) -> List[torch.Tensor]:
    tot = sum(s)
    return [(CONSTANTS["diag"][i] * s[i] + tot) % P for i in range(WIDTH)]


def permute_plain(s: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The permutation on 16 int64 lane tensors of canonical values."""
    s = _external_linear(list(s))
    for r in range(ROUNDS_F):
        if r == ROUNDS_F // 2:
            for k in range(ROUNDS_P):
                s[0] = _sbox((s[0] + CONSTANTS["internal"][k]) % P)
                s = _internal_linear(s)
        s = [_sbox((x + c) % P) for x, c in zip(s, CONSTANTS["external"][r])]
        s = _external_linear(s)
    return s


def hash_rows_plain(mats: Sequence[torch.Tensor]) -> torch.Tensor:
    cols = [row for m in mats for row in m]
    state = [torch.zeros_like(mats[0][0]) for _ in range(WIDTH)]
    for i in range(0, len(cols), RATE):
        chunk = cols[i : i + RATE]
        state = permute_plain(chunk + state[len(chunk):])  # absorb overwrites the first lanes
    return torch.stack(state[:OUT], dim=1).to(torch.int32)


def compress_pairs_plain(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    lanes = [left[:, k].to(torch.int64) for k in range(8)] + [right[:, k].to(torch.int64) for k in range(8)]
    return torch.stack(permute_plain(lanes)[:OUT], dim=1).to(torch.int32)


# --- dispatch -------------------------------------------------------------------

def device_constants(device: torch.device) -> torch.Tensor:
    """The round constants as an int64 tensor on `device` (made once)."""
    if device not in _DEVICE_CONSTS:
        _DEVICE_CONSTS[device] = torch.from_numpy(CONSTANTS_U32.astype("int64")).to(device)
    return _DEVICE_CONSTS[device]


def hash_rows(mats: Sequence[torch.Tensor]) -> torch.Tensor:
    """Leaf digests (n, 8) int32 of the rows of same-height (w_j, n) int64
    matrices of canonical BabyBear values, concatenated in order."""
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
    width = sum(m.shape[0] for m in mats)
    kernels.POSEIDON2_MERKLE.launch(
        "p2_hash_rows", ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(widths, ctypes.c_void_p),
        len(mats), n, kernels.ptr(device_constants(dev)), kernels.ptr(out),
        cost=((8 * width + 32) * n, n * max(1, -(-width // 8)) * kernels.OPS_PER_POSEIDON2),
    )
    return out
