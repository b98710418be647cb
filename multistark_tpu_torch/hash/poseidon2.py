"""Poseidon2 (BabyBear, width 16) over tensors: kernel K6 (poseidon2_merkle).

`hash_rows` is the padding-free sponge (rate 8) over each row's values
across several same-height (w_j, n) matrices (the Merkle leaf).  The Merkle
2-to-1, the permutation of left || right truncated to 8 lanes, runs on the
card inside K14 and K15 (commit_tile.py); `compress_pairs_plain` is its
plain version.  Inputs are int64 tensors of canonical BabyBear
values; digests are (n, 8) int32 tensors of canonical words, the layout
merkle.py uses for BLAKE3.

A CUDA tensor launches the hand-written kernel (csrc/poseidon2_merkle.cu)
in the mode `hash_rows_plan` picks from the row count and the card's SM
count: a thread per row where rows are many, a group of four lanes per row
where they are few; a CPU tensor takes the plain PyTorch version beside
it, which runs the permutation vectorized over rows in int64 (every
product of two values below 2^31 is exact).  The constants are
hash/poseidon2_host.py's; the kernel's thread mode reads them in Montgomery
form from constant memory, filled once per device.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from .. import kernels
from ..utils import to_device
from .poseidon2_host import _M4, CONSTANTS, CONSTANTS_U32, OUT, P, RATE, ROUNDS_F, ROUNDS_P, WIDTH

_MAX_MATS = 16  # MAX_MATS in csrc/poseidon2_merkle.cu
THREADS = 128  # THREADS in csrc/poseidon2_merkle.cu: a block of either mode
RESIDENT = 8  # MIN_BLOCKS in csrc/poseidon2_merkle.cu: thread-mode blocks its register cap keeps on an SM
LANES = 4  # the four-lane mode's lanes per row
WARP = 32
MODE_THREAD, MODE_LANES = 0, 1  # MODE_* in csrc/poseidon2_merkle.cu
# The four-lane mode hashes up to this many rows per SM (16896 on an H100's
# 132): `scripts/tile_sweep.py --only rows` on an NVIDIA H100 80GB HBM3 at
# 700 W timed both modes at 2^2-2^19 rows of 8, 14 and 52 columns; four
# lanes were faster up to 2^14 rows (8 columns: 0.0122 against 0.0174 ms),
# a thread per row from 2^15 (0.0168 against 0.0218 ms).
LANE_ROWS_PER_SM = 128
_DEVICE_CONSTS: Dict[torch.device, torch.Tensor] = {}
_CONSTANT_BANK: Set[torch.device] = set()  # devices whose kernel constant memory holds the constants
_SMS: Dict[torch.device, int] = {}


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
        _DEVICE_CONSTS[device] = to_device(CONSTANTS_U32.astype("int64"), device)
    return _DEVICE_CONSTS[device]


@dataclass(frozen=True)
class HashRowsPlan:
    """K6's launch over n rows: `mode` (MODE_THREAD or MODE_LANES), `blocks`
    of `threads` threads."""

    mode: int
    blocks: int
    threads: int


def hash_rows_plan(n: int, sms: int, mode: Optional[int] = None) -> HashRowsPlan:
    """K6's mode and grid for n rows on a card of `sms` SMs: a group of
    LANES lanes per row up to LANE_ROWS_PER_SM rows per SM (the short FRI
    levels, bound by a permutation's latency), else a thread per row, unless
    `mode` names one (the sweeps).  Rows that fill blocks of THREADS on
    every SM take at most one wave of resident blocks (RESIDENT per SM),
    which strides over the rows; fewer rows spread over every SM in smaller
    blocks (whole warps)."""
    if n < 1 or sms < 1 or mode not in (None, MODE_THREAD, MODE_LANES):
        raise ValueError(f"no plan for {n} rows on {sms} SMs in mode {mode}")
    if mode is None:
        mode = MODE_LANES if n <= LANE_ROWS_PER_SM * sms else MODE_THREAD
    lanes = LANES if mode == MODE_LANES else 1
    if n * lanes >= sms * THREADS:
        return HashRowsPlan(mode, min(-(-n * lanes // THREADS), RESIDENT * sms), THREADS)
    threads = max(WARP, n * lanes // sms // WARP * WARP)  # whole warps, so that every SM gets a block
    return HashRowsPlan(mode, -(-n * lanes // threads), threads)


def _sms(device: torch.device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]


def _mont_constants(device: torch.device) -> None:
    """Fill the kernel's constant memory on `device` with the round
    constants in Montgomery form, the first time."""
    if device in _CONSTANT_BANK:
        return
    mont = to_device(np.array([(int(c) << 32) % P for c in CONSTANTS_U32], dtype=np.uint32).view(np.int32), device)
    with torch.cuda.device(device):
        rc = kernels.library().p2_load_constants(kernels.ptr(mont), kernels.current_stream())
    if rc != 0:
        raise RuntimeError(f"poseidon2_merkle: p2_load_constants failed with cudaError_t {rc}")
    _CONSTANT_BANK.add(device)


def hash_rows(mats: Sequence[torch.Tensor], plan: Optional[HashRowsPlan] = None) -> torch.Tensor:
    """Leaf digests (n, 8) int32 of the rows of same-height (w_j, n) int64
    matrices of canonical BabyBear values, concatenated in order; on the
    card by `hash_rows_plan` unless `plan` names another (the sweeps force
    a mode)."""
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
    plan = plan or hash_rows_plan(n, _sms(dev))
    _mont_constants(dev)
    out = torch.empty((n, 8), dtype=torch.int32, device=dev)
    ptrs = (ctypes.c_void_p * len(mats))(*[m.data_ptr() for m in mats])
    widths = (ctypes.c_int64 * len(mats))(*[m.shape[0] for m in mats])
    chunks = max(1, -(-sum(m.shape[0] for m in mats) // RATE))
    kernels.POSEIDON2_MERKLE.launch(
        "p2_hash_rows", ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(widths, ctypes.c_void_p),
        len(mats), n, plan.mode, plan.blocks, plan.threads, kernels.ptr(device_constants(dev)), kernels.ptr(out),
        # the values read and the digests written; the permutations; a row's chain of them, at the faster
        # mode's latency whatever the plan
        cost=(8 * sum(m.numel() for m in mats) + 32 * n, n * chunks * kernels.OPS_PER_POSEIDON2,
              chunks * min(kernels.POSEIDON2_LATENCY_MS)),
    )
    return out


def permute_chain_plain(state: torch.Tensor, n: int) -> torch.Tensor:
    lanes = [state[:, i].to(torch.int64) for i in range(WIDTH)]
    for _ in range(n):
        lanes = permute_plain(lanes)
    return torch.stack(lanes, dim=1).to(torch.int32)


def permute_chain(state: torch.Tensor, n: int, mode: int = MODE_THREAD) -> torch.Tensor:
    """A (1, 16) int32 state of canonical values permuted n times in a row,
    as K6's `mode` runs a permutation (one thread, or one group of LANES
    lanes): n permutations' latency on the card (a measurement: it is not a
    launch of K6 and is not counted).  The plain version on a CPU tensor."""
    if tuple(state.shape) != (1, WIDTH) or state.dtype != torch.int32 or n < 0:
        raise ValueError("permute_chain takes a (1, 16) int32 state and n >= 0")
    if not kernels.use_kernel(state):
        return permute_chain_plain(state, n)
    out = state.clone()
    _mont_constants(out.device)
    rc = kernels.library().p2_chain(LANES if mode == MODE_LANES else 1, kernels.ptr(out), n,
                                    kernels.ptr(device_constants(out.device)), kernels.current_stream())
    if rc != 0:
        raise RuntimeError(f"p2_chain failed with cudaError_t {rc}")
    return out
