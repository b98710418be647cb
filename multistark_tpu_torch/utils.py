"""Scans and reductions over field tensors: kernel K4 (gl_scan), plus index
helpers and the host boundary (uploads, the one fetch, device ext scalars).

`batch_inv`, `cumsum` and `field_sum` work along the LAST axis of a base
tensor (..., n) or a coordinate-major extension tensor (D, ..., n), and take
the ops of its field (fields/device.py: GL_OPS, BB_OPS, or an extension's
GL2_OPS, BB4_OPS).  A CUDA tensor launches the hand-written kernel
(csrc/gl_scan.cu, which serves both fields): a tile-local scan or sum, the
same kernels over the (rows, tiles) array of tile totals, and an add-back.
A CPU tensor takes the plain PyTorch version beside it (log-depth
Hillis-Steele scans over the plain field ops).
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels
from .fields.device import ExtOps

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


# --- the host boundary -----------------------------------------------------------

def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on `device` (sharing the array's memory on
    the CPU).  A CUDA upload is staged through pinned memory and does not
    block the host: it queues behind the kernels already launched instead of
    waiting for them, so uploads of transcript-derived tables and scalars
    make no sync."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def fetch(tensors) -> list:
    """Many device tensors to the host in ONE transfer (one sync): int64
    tensors come back as uint64 arrays, int32 ones as uint32, each in its
    own shape."""
    tensors = list(tensors)
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1).to(torch.int64) for t in tensors]).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        part = flat[off : off + t.numel()]
        off += t.numel()
        arr = (part & 0xFFFFFFFF).astype(np.uint32) if t.dtype == torch.int32 else part.view(np.uint64)
        out.append(arr.reshape(tuple(t.shape)))
    return out


def ext_pack_device(vals) -> torch.Tensor:
    """k device extension scalars ((D,) tensors) stacked into one (k, D)
    tensor; element [i, d] is coordinate d of value i."""
    return torch.stack([v.reshape(-1) for v in vals])


def ext_powers_device(E: ExtOps, alpha: torch.Tensor, count: int) -> torch.Tensor:
    """[α^0, ..., α^(count-1)] of a device ext scalar α as a (D, count)
    tensor, by doubling: the table so far times α^m, then α^m squared, so
    2·log2(count) launches of the field kernel instead of count."""
    pows = torch.zeros((E.D, 1), dtype=torch.int64, device=alpha.device)
    pows[0] = 1
    step = alpha.reshape(E.D, 1)
    while pows.shape[1] < count:
        pows = torch.cat([pows, E.mul(pows, step)], dim=1)
        if pows.shape[1] < count:
            step = E.square(step)
    return pows[:, :count]


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


def _split(ops):
    """(base FieldOps, extension degree or 0) of a field's ops."""
    return (ops.base, ops.D) if isinstance(ops, ExtOps) else (ops, 0)


def cumsum_plain(x: torch.Tensor, ops) -> torch.Tensor:
    return _scan_plain(x, _split(ops)[0].add_plain)


def field_sum_plain(x: torch.Tensor, ops) -> torch.Tensor:
    """Mod-p sum along the last axis by pairwise halving."""
    F = _split(ops)[0]
    while x.shape[-1] > 1:
        if x.shape[-1] & 1:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
        x = F.add_plain(x[..., 0::2], x[..., 1::2])
    return x[..., 0]


def batch_inv_plain(x: torch.Tensor, ops) -> torch.Tensor:
    """Montgomery-trick inverse of every element along the last axis:
    prefix and suffix products of the zero-masked values and one inversion
    of each row's total; zeros map to zero."""
    F, D = _split(ops)
    if D:
        zero = (x == 0).all(dim=0)
        safe = x.clone()  # a zero element becomes the one (1, 0, ..., 0)
        safe[0] = torch.where(zero, 1, x[0])
        one = torch.zeros_like(x[..., :1])
        one[0] = 1
    else:
        zero = x == 0
        safe = torch.where(zero, torch.ones_like(x), x)
        one = torch.ones_like(x[..., :1])
    pre = _scan_plain(safe, ops.mul_plain)
    suf = _scan_plain(safe, ops.mul_plain, reverse=True)
    tinv = ops.inv_plain(pre[..., -1:])
    pre_prev = torch.cat([one, pre[..., :-1]], dim=-1)
    suf_next = torch.cat([suf[..., 1:], one], dim=-1)
    out = ops.mul_plain(ops.mul_plain(pre_prev, suf_next), tinv)
    return torch.where(zero, 0, out)


# --- CUDA launches --------------------------------------------------------------

def _rows(x: torch.Tensor, D: int):
    """(coordinate stride, rows, n) of a contiguous base or ext tensor."""
    n = x.shape[-1]
    per_coord = x.numel() // max(D, 1)
    rows = per_coord // n if n else 0
    if rows > _MAX_ROWS:
        raise ValueError(f"gl_scan takes at most {_MAX_ROWS} rows, got {rows}")
    return per_coord, rows, n


def _scan_cuda(x: torch.Tensor, F, D: int, combine: int, reverse: bool) -> torch.Tensor:
    cs, rows, n = _rows(x, D)
    out = torch.empty_like(x)
    tiles = -(-n // _TILE)
    tot = torch.empty(((D,) if D else ()) + (rows, tiles), dtype=torch.int64, device=x.device)
    p = kernels.ptr
    kernels.GL_SCAN.launch(
        "gls_scan_tile", F.field_id, int(D > 0), p(x), cs, p(out), cs, p(tot), rows * tiles, rows, n,
        combine, int(reverse),
    )
    if tiles > 1:
        # tile totals are in logical (scan) order, so their scan runs forward
        tot = _scan_cuda(tot, F, D, combine, reverse=False)
        kernels.GL_SCAN.launch(
            "gls_scan_addback", F.field_id, int(D > 0), p(out), cs, p(tot), rows * tiles, rows, n,
            combine, int(reverse),
        )
    return out


def _sum_cuda(x: torch.Tensor, F) -> torch.Tensor:
    lead = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1])
    while x.shape[-1] > 1:
        rows, n = x.shape
        if rows > _MAX_ROWS:
            raise ValueError(f"gl_scan takes at most {_MAX_ROWS} rows, got {rows}")
        tiles = -(-n // _TILE)
        tot = torch.empty((rows, tiles), dtype=torch.int64, device=x.device)
        kernels.GL_SCAN.launch(
            "gls_sum_tile", F.field_id, 0, kernels.ptr(x), rows * n, kernels.ptr(tot), rows * tiles, rows, n,
        )
        x = tot
    return x[:, 0].reshape(lead)


def _batch_inv_cuda(x: torch.Tensor, F, D: int) -> torch.Tensor:
    cs, rows, n = _rows(x, D)
    pre = _scan_cuda(x, F, D, _MUL_NONZERO, reverse=False)
    suf = _scan_cuda(x, F, D, _MUL_NONZERO, reverse=True)
    tinv = torch.empty(((D,) if D else ()) + (rows,), dtype=torch.int64, device=x.device)
    out = torch.empty_like(x)
    p, ext = kernels.ptr, int(D > 0)
    kernels.GL_SCAN.launch("gls_row_inv", F.field_id, ext, p(pre), cs, p(tinv), rows, rows, n)
    kernels.GL_SCAN.launch(
        "gls_binv_finish", F.field_id, ext, p(x), cs, p(pre), p(suf), cs, p(tinv), rows,
        p(out), cs, rows, n,
    )
    return out


# --- dispatch -------------------------------------------------------------------

def batch_inv(x: torch.Tensor, ops) -> torch.Tensor:
    """Elementwise inverse along the last axis, zeros mapping to zero."""
    x = x.contiguous()
    if x.shape[-1] == 0:
        return x.clone()
    if not kernels.use_kernel(x):
        return batch_inv_plain(x, ops)
    kernels.check_cuda(x)
    return _batch_inv_cuda(x, *_split(ops))


def cumsum(x: torch.Tensor, ops) -> torch.Tensor:
    """Inclusive mod-p prefix sum along the last axis (base or ext: the
    extension adds coordinatewise)."""
    x = x.contiguous()
    if not kernels.use_kernel(x):
        return cumsum_plain(x, ops)
    kernels.check_cuda(x)
    return _scan_cuda(x, _split(ops)[0], 0, _ADD, reverse=False)


def field_sum(x: torch.Tensor, ops) -> torch.Tensor:
    """Mod-p sum along the last axis (base or ext)."""
    x = x.contiguous()
    if not kernels.use_kernel(x):
        return field_sum_plain(x, ops)
    kernels.check_cuda(x)
    return _sum_cuda(x, _split(ops)[0])
