"""Scans and reductions over field tensors: kernel K4 (gl_scan), plus index
helpers.

`batch_inv`, `cumsum` and `field_sum` work along the LAST axis of a base
tensor (..., n) or a coordinate-major extension tensor (2, ..., n).  A CUDA
tensor launches the hand-written kernel (csrc/gl_scan.cu): a tile-local scan
or sum, the same kernels over the (rows, tiles) array of tile totals, and an
add-back.  A CPU tensor takes the plain PyTorch version beside it
(log-depth Hillis-Steele scans over the field ops of fields/device.py).
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels
from .fields import device as fd

_TILE = 2048  # THREADS * ITEMS in csrc/gl_scan.cu
_MAX_ROWS = 65535  # gridDim.y
_ADD, _MUL_NONZERO = 0, 2


def bit_reverse_indices(log_n: int) -> np.ndarray:
    """Permutation i -> reverse_bits(i, log_n) as an int64 numpy array."""
    n = 1 << log_n
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def reverse_bits(i: int, bits: int) -> int:
    return int(f"{i:0{bits}b}"[::-1], 2) if bits else 0


# --- plain PyTorch versions (any device) ---------------------------------------

def _scan_plain(x: torch.Tensor, combine, reverse: bool = False) -> torch.Tensor:
    """Inclusive scan along the last axis (Hillis-Steele)."""
    if reverse:
        x = x.flip(-1)
    n, s = x.shape[-1], 1
    while s < n:
        x = torch.cat([x[..., :s], combine(x[..., s:], x[..., :-s])], dim=-1)
        s <<= 1
    return x.flip(-1) if reverse else x


def cumsum_plain(x: torch.Tensor) -> torch.Tensor:
    return _scan_plain(x, fd.add_plain)


def field_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """Mod-p sum along the last axis by pairwise halving."""
    while x.shape[-1] > 1:
        if x.shape[-1] & 1:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
        x = fd.add_plain(x[..., 0::2], x[..., 1::2])
    return x[..., 0]


def batch_inv_plain(x: torch.Tensor, ext: bool) -> torch.Tensor:
    """Montgomery-trick inverse of every element along the last axis:
    prefix and suffix products of the zero-masked values and one inversion
    of each row's total; zeros map to zero."""
    if ext:
        zero = (x[0] == 0) & (x[1] == 0)
        safe = torch.stack([torch.where(zero, torch.ones_like(x[0]), x[0]), torch.where(zero, 0, x[1])])
        mul, inv = fd.ext_mul_plain, fd.ext_inv_plain
        one = torch.stack([torch.ones_like(x[0][..., :1]), torch.zeros_like(x[0][..., :1])])
    else:
        zero = x == 0
        safe = torch.where(zero, torch.ones_like(x), x)
        mul, inv = fd.mul_plain, fd.inv_plain
        one = torch.ones_like(x[..., :1])
    pre = _scan_plain(safe, mul)
    suf = _scan_plain(safe, mul, reverse=True)
    tinv = inv(pre[..., -1:])
    pre_prev = torch.cat([one, pre[..., :-1]], dim=-1)
    suf_next = torch.cat([suf[..., 1:], one], dim=-1)
    out = mul(mul(pre_prev, suf_next), tinv)
    return torch.where(zero, 0, out)


# --- CUDA launches --------------------------------------------------------------

def _rows(x: torch.Tensor, ext: bool):
    """(coordinate stride, rows, n) of a contiguous base or ext tensor."""
    n = x.shape[-1]
    per_coord = x.numel() // (2 if ext else 1)
    rows = per_coord // n if n else 0
    if rows > _MAX_ROWS:
        raise ValueError(f"gl_scan takes at most {_MAX_ROWS} rows, got {rows}")
    return per_coord, rows, n


def _scan_cuda(x: torch.Tensor, ext: bool, combine: int, reverse: bool) -> torch.Tensor:
    cs, rows, n = _rows(x, ext)
    out = torch.empty_like(x)
    tiles = -(-n // _TILE)
    tot = torch.empty(((2,) if ext else ()) + (rows, tiles), dtype=torch.int64, device=x.device)
    p = kernels.ptr
    kernels.GL_SCAN.launch(
        "gls_scan_tile", int(ext), p(x), cs, p(out), cs, p(tot), rows * tiles, rows, n,
        combine, int(reverse),
    )
    if tiles > 1:
        # tile totals are in logical (scan) order, so their scan runs forward
        tot = _scan_cuda(tot, ext, combine, reverse=False)
        kernels.GL_SCAN.launch(
            "gls_scan_addback", int(ext), p(out), cs, p(tot), rows * tiles, rows, n,
            combine, int(reverse),
        )
    return out


def _sum_cuda(x: torch.Tensor) -> torch.Tensor:
    lead = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1])
    while x.shape[-1] > 1:
        rows, n = x.shape
        if rows > _MAX_ROWS:
            raise ValueError(f"gl_scan takes at most {_MAX_ROWS} rows, got {rows}")
        tiles = -(-n // _TILE)
        tot = torch.empty((rows, tiles), dtype=torch.int64, device=x.device)
        kernels.GL_SCAN.launch(
            "gls_sum_tile", 0, kernels.ptr(x), rows * n, kernels.ptr(tot), rows * tiles, rows, n,
        )
        x = tot
    return x[:, 0].reshape(lead)


def _batch_inv_cuda(x: torch.Tensor, ext: bool) -> torch.Tensor:
    cs, rows, n = _rows(x, ext)
    pre = _scan_cuda(x, ext, _MUL_NONZERO, reverse=False)
    suf = _scan_cuda(x, ext, _MUL_NONZERO, reverse=True)
    tinv = torch.empty(((2,) if ext else ()) + (rows,), dtype=torch.int64, device=x.device)
    out = torch.empty_like(x)
    p = kernels.ptr
    kernels.GL_SCAN.launch("gls_row_inv", int(ext), p(pre), cs, p(tinv), rows, rows, n)
    kernels.GL_SCAN.launch(
        "gls_binv_finish", int(ext), p(x), cs, p(pre), p(suf), cs, p(tinv), rows,
        p(out), cs, rows, n,
    )
    return out


# --- dispatch -------------------------------------------------------------------

def batch_inv(x: torch.Tensor, ext: bool) -> torch.Tensor:
    """Elementwise inverse along the last axis, zeros mapping to zero."""
    x = x.contiguous()
    if x.shape[-1] == 0:
        return x.clone()
    if not kernels.use_kernel(x):
        return batch_inv_plain(x, ext)
    kernels.check_cuda(x)
    return _batch_inv_cuda(x, ext)


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive mod-p prefix sum along the last axis (base or ext: the
    extension adds coordinatewise)."""
    x = x.contiguous()
    if not kernels.use_kernel(x):
        return cumsum_plain(x)
    kernels.check_cuda(x)
    return _scan_cuda(x, False, _ADD, reverse=False)


def field_sum(x: torch.Tensor) -> torch.Tensor:
    """Mod-p sum along the last axis (base or ext)."""
    x = x.contiguous()
    if not kernels.use_kernel(x):
        return field_sum_plain(x)
    kernels.check_cuda(x)
    return _sum_cuda(x)
