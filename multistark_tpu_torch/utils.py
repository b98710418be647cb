"""Scans and reductions over field tensors: kernel K4 (gl_scan), plus index
helpers and the host boundary (uploads, the one fetch, device ext scalars).

`batch_inv`, `cumsum`, `field_sum` and `inv_sum` work along the LAST axis of
a base tensor (..., n) or a coordinate-major extension tensor (D, ..., n),
and take the ops of its field (fields/device.py: GL_OPS, BB_OPS, or an
extension's GL2_OPS, BB4_OPS); `stage2_chain` is the logUp stage-2 chain of
one circuit.  A CUDA tensor launches the hand-written kernel
(csrc/gl_scan.cu, which serves both fields): one launch per call, at any
size (per-tile batch inverses, single-pass scans with decoupled look-back,
last-block-done sums).  A CPU tensor takes the plain PyTorch version beside
each (log-depth Hillis-Steele scans over the plain field ops).

The single-pass entries keep status words between calls in scratch buffers
per device and stream (`_Scratch`): each scan takes a new epoch and each
sum's last block resets its counter, so no launch ever resets them.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from . import kernels
from .fields.device import ExtOps
from .profiling import span

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
    with span("stark/fetch"):
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
    tensor: one launch of the field's kernel (ExtOps.powers)."""
    return E.powers(alpha, count)


def fold_rows(vec: torch.Tensor, a_bits: int) -> torch.Tensor:
    """A (D, N) ext vector as the (A·D, N/A) base matrix a FRI level
    commits: row (j·D + d) = coordinate d of vec[j::A] (flatten_to_base).
    A PyTorch copy, counted in kernels.COPIES["fold_rows"]: on one device
    K3's FRI entry (hash/blake3.fri_leaves) and K10 (pcs.fri_fold_level)
    write this matrix themselves; a block of a sharded level takes it."""
    kernels.COPIES["fold_rows"] += 1
    A, D = 1 << a_bits, vec.shape[0]
    return vec.reshape(D, -1, A).permute(2, 0, 1).reshape(D * A, -1).contiguous()


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


def inv_sum_plain(x: torch.Tensor, ops) -> torch.Tensor:
    """Plain version of `inv_sum`: the batch inverse, then the sum."""
    return field_sum_plain(batch_inv_plain(x, ops), ops)


def stage2_chain_plain(E: ExtOps, L: int, msgs: torch.Tensor, acc: torch.Tensor):
    """Plain version of `stage2_chain`, the composition the JAX package runs
    (utils.py batch_inv, then lookup.py _stage2_scan): the inverses of the
    messages, terms mult/message, their inclusive prefix sum, the exclusive
    shift plus acc, and the stage-2 column layout, row (j·D + d) =
    coordinate d of slot j."""
    D = E.D
    terms = E.scale_plain(batch_inv_plain(msgs[:D], E), msgs[D])
    incl = cumsum_plain(terms, E)
    excl = torch.cat([torch.zeros_like(incl[:, :1]), incl[:, :-1]], dim=1)
    acc_flat = E.add_plain(excl, acc.reshape(D, 1))
    n = acc_flat.shape[1] // L
    mat = acc_flat.reshape(D, n, L).permute(2, 0, 1).reshape(L * D, n).contiguous()
    return mat, incl[:, -1]


# --- CUDA launches --------------------------------------------------------------

_BATCH, _SUM, _SCAN, _CHAIN = range(4)  # the tile kinds of csrc/gl_scan.cu gls_tiles


class _Scratch:
    """The kernels' scratch words on one device and stream, in int64
    buffers that only grow (zeroed when they do): K4's single-pass scans'
    status words (word 0 the ticket counter, then epoch-tagged flags and
    values), with the last epoch used and the tickets issued so far; K4's
    row sums' counters (0 between launches: the last block of a row resets
    its own); their partial sums; the arrival counters of K8, K12 and K15
    (0 between launches: the block that arrives last resets its own).
    Launches on one stream run one after another, so they share them."""

    def __init__(self):
        self.status = self.counters = self.partials = self.arrivals = None
        self.epoch = 0
        self.tickets = 0

    def take_status(self, like: torch.Tensor, words: int) -> Tuple[torch.Tensor, int, int]:
        """(status buffer of >= words, a new epoch, the tickets issued before)."""
        if self.status is None or self.status.numel() < words:
            self.status = _grown(self.status, words, like)
            self.tickets = 0  # a new counter
        self.epoch += 1
        return self.status, self.epoch, self.tickets

    def take_sums(self, like: torch.Tensor, rows: int, words: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(rows counters, a buffer of >= words for the partial sums)."""
        if self.counters is None or self.counters.numel() < rows:
            self.counters = _grown(self.counters, rows, like)
        if self.partials is None or self.partials.numel() < words:
            self.partials = _grown(self.partials, words, like)
        return self.counters, self.partials

    def take_counters(self, like: torch.Tensor, words: int) -> torch.Tensor:
        """Arrival counters, 0 between launches: a buffer of >= words (at
        least one)."""
        if self.arrivals is None or self.arrivals.numel() < max(words, 1):
            self.arrivals = _grown(self.arrivals, max(words, 1), like)
        return self.arrivals


def _grown(buf, words: int, like: torch.Tensor) -> torch.Tensor:
    size = max(words, 2 * (0 if buf is None else buf.numel()))
    return torch.zeros(size, dtype=torch.int64, device=like.device)


_SCRATCH: Dict[tuple, _Scratch] = {}
_TILES: Dict[tuple, int] = {}


def scratch(x: torch.Tensor) -> _Scratch:
    key = (x.device, kernels.current_stream())
    if key not in _SCRATCH:
        _SCRATCH[key] = _Scratch()
    return _SCRATCH[key]


def _tiles(F, ext: bool, kind: int, n: int) -> int:
    key = (F.field_id, ext, kind, n)
    if key not in _TILES:
        _TILES[key] = kernels.library().gls_tiles(F.field_id, int(ext), kind, n)
    return _TILES[key]


def _rows(x: torch.Tensor, D: int) -> Tuple[int, int]:
    """(rows, n) of a contiguous base or ext tensor."""
    n = x.shape[-1]
    return x.numel() // max(D, 1) // n, n


# --- dispatch -------------------------------------------------------------------

def batch_inv(x: torch.Tensor, ops) -> torch.Tensor:
    """Elementwise inverse along the last axis, zeros mapping to zero."""
    x = x.contiguous()
    if x.shape[-1] == 0 or x.numel() == 0:
        return x.clone()
    if not kernels.use_kernel(x):
        return batch_inv_plain(x, ops)
    kernels.check_cuda(x)
    F, D = _split(ops)
    rows, n = _rows(x, D)
    out = torch.empty_like(x)
    kernels.GL_SCAN.launch("gls_batch_inv", F.field_id, int(D > 0), kernels.ptr(x), kernels.ptr(out), rows, n,
                           cost=(16 * x.numel(), 0))
    return out


def cumsum(x: torch.Tensor, ops) -> torch.Tensor:
    """Inclusive mod-p prefix sum along the last axis (base or ext: the
    extension adds coordinatewise)."""
    x = x.contiguous()
    if not kernels.use_kernel(x):
        return cumsum_plain(x, ops)
    if x.numel() == 0:
        return x.clone()
    kernels.check_cuda(x)
    F = _split(ops)[0]
    rows, n = _rows(x, 0)
    tiles = _tiles(F, False, _SCAN, n)
    sc = scratch(x)
    buf, epoch, issued = sc.take_status(x, 1 + 3 * rows * tiles)
    out = torch.empty_like(x)
    p = kernels.ptr
    kernels.GL_SCAN.launch("gls_cumsum", F.field_id, p(x), p(out), rows, n, p(buf), issued, epoch,
                           cost=(16 * x.numel(), 0))
    sc.tickets += rows * tiles
    return out


def field_sum(x: torch.Tensor, ops) -> torch.Tensor:
    """Mod-p sum along the last axis (base or ext)."""
    x = x.contiguous()
    if not kernels.use_kernel(x):
        return field_sum_plain(x, ops)
    kernels.check_cuda(x)
    F = _split(ops)[0]
    rows, n = _rows(x, 0)
    tiles = _tiles(F, False, _SUM, n)
    done, partials = scratch(x).take_sums(x, rows, rows * tiles)
    out = torch.empty(x.shape[:-1], dtype=torch.int64, device=x.device)
    p = kernels.ptr
    kernels.GL_SCAN.launch("gls_sum", F.field_id, p(x), p(out), rows, n, p(done), p(partials),
                           cost=(8 * (x.numel() + out.numel()), 0))
    return out


def inv_sum(x: torch.Tensor, ops) -> torch.Tensor:
    """The sum of the inverses of the elements along the last axis (zeros
    contributing zero): `field_sum(batch_inv(x))` in one launch.  Not on
    the prove's path: the claims accumulator is K9's one launch."""
    x = x.contiguous()
    if not kernels.use_kernel(x):
        return inv_sum_plain(x, ops)
    kernels.check_cuda(x)
    F, D = _split(ops)
    rows, n = _rows(x, D)
    tiles = _tiles(F, D > 0, _BATCH, n)
    done, partials = scratch(x).take_sums(x, rows, rows * tiles * max(D, 1))
    out = torch.empty(x.shape[:-1], dtype=torch.int64, device=x.device)
    p = kernels.ptr
    kernels.GL_SCAN.launch("gls_inv_sum", F.field_id, int(D > 0), p(x), p(out), rows, n, p(done), p(partials),
                           cost=(8 * (x.numel() + out.numel()), 0))
    return out


def stage2_chain(E: ExtOps, L: int, msgs: torch.Tensor, acc: torch.Tensor):
    """The logUp stage-2 chain of one circuit from K11's messages: msgs
    (D+1, n·L), planes 0..D-1 the slot messages in chain order (row-major,
    slot-minor), plane D the multiplicities; acc the (D,) accumulator before
    the circuit.  Returns (the stage-2 matrix (L·D, n), row j·D + d =
    coordinate d of slot j, holding acc plus the chain's exclusive prefix;
    the chain's total (D,)).  One K4 launch on a CUDA tensor, the plain
    composition on a CPU one."""
    D = E.D
    if msgs.dim() != 2 or msgs.shape[0] != D + 1 or msgs.shape[1] % L:
        raise ValueError(f"stage2_chain takes ({D + 1}, n·L) messages")
    if not kernels.use_kernel(msgs):
        return stage2_chain_plain(E, L, msgs, acc)
    msgs, acc = msgs.contiguous(), acc.reshape(D).contiguous()
    kernels.check_cuda(msgs, acc)
    n = msgs.shape[1] // L
    F = E.base
    tiles = _tiles(F, True, _CHAIN, n * L)
    sc = scratch(msgs)
    buf, epoch, issued = sc.take_status(msgs, 1 + (1 + 2 * D) * tiles)
    mat = torch.empty((L * D, n), dtype=torch.int64, device=msgs.device)
    total = torch.empty(D, dtype=torch.int64, device=msgs.device)
    p = kernels.ptr
    kernels.GL_SCAN.launch("gls_stage2_chain", F.field_id, p(msgs), n, L, p(acc), p(mat), p(total), p(buf),
                           issued, epoch, cost=(8 * (msgs.numel() + mat.numel() + 2 * D), 0))
    sc.tickets += tiles
    return mat, total
