"""Row-sharded proving on torch.distributed (the counterpart of
multistark_tpu/parallel.py and of the sharded branches of its prover.py,
pcs.py and lookup.py).

SPMD: one process per rank, and every rank runs the whole prove.  The rows
of the LDE-sized arrays are split across the D ranks of a `ProverMesh` (D a
power of two); the transcript and the small arrays are replicated, and every
rank ends with the same `Proof` bytes as a single-device prove (all
arithmetic is exact mod p, all hashing exact).  `use_mesh` activates the
mesh; the PCS commits, stage 2, the quotient, the claimed evaluations, the
reduced openings, the FRI rounds and the query openings then take their
sharded branches wherever the JAX package's thresholds hold.

Layout contract (as in the JAX package):

  - NATURAL-order rows are sharded CYCLICALLY for a DIF: rank r holds the
    natural indices j·D + r.  Every coarse DIF butterfly (span >= D) pairs
    two indices of equal residue, so the coarse stages run on the rank's
    residue class with the stage table taken at stride D from offset r.
  - BIT-REVERSED storage rows are sharded in contiguous BLOCKS: rank r holds
    storage positions [r·n/D, (r+1)·n/D).  One all-to-all after the coarse
    stages moves the residue axis local (the four-step transpose); the
    size-D fine stages then run locally and leave the rank's block of the
    bit-reversed output, which is a whole Merkle subtree.

Kernels: the DIF stages run on K2 (ntt_stage), the field ops on K1/K5, the
stage-2 messages and the quotient on K11, the scans and inverses on K4, the
leaves on K3/K6, the tree levels on K15, the openings on K12/K13 and the
folds on K10; the collectives are torch.distributed calls (NCCL, or gloo).
`SHARDED_CALLS` counts each sharded function per rank (the JAX package's
tests read `_last_sharded_qmat_spec` for the same purpose),
`COLLECTIVE_BYTES` the bytes this rank receives from the others per kind.

Where GSPMD moved data implicitly in the JAX package, the port makes one
explicit collective (bytes received per rank, u64 words; w columns,
N LDE rows, n trace rows, m = n·q quotient rows, D ranks):

  dif       the four-step transpose: one all_to_all, w·N/D·(D-1)/D·8
  stage2    the D block totals, then the blocks themselves (the commit's
            iDFT runs replicated): (D-1)·(D_ext·8 + L·D_ext·n/D·8)
  tree      the D subtree roots: (D-1)·32 per tree
  quotient  each source's stored prefix (prefix_to_natural), broadcast by
            the ranks whose blocks hold it (the q-row halo of the next-row
            window comes from this prefix, so no send/receive pair is
            needed); the block-to-cyclic all_to_all before the inverse DIF;
            the (D_ext, m) coefficients for _unbrev and the chunk slicing:
            at most w·m·8 per source + D_ext·m/D·(D-1)/D·8
            + D_ext·m·(D-1)/D·8 + the DIF's transpose
  evals     each stored prefix of n rows for the claimed evaluations (K12
            runs replicated), broadcast the same way: at most w·n·8 per
            matrix
  fri       the fold vector once a round could not stay sharded (shorter
            than D², or its fold shorter than D): D_ext·len·(D-1)/D·8
  queries   each query's rows and lower path from the rank that owns its
            leaf, one all_gather per tree phase: (D-1)·Q·(row + path) bytes
  dft       distributed_dft's transpose: w·n/D·(D-1)/D·8

The backend follows the device: NCCL for CUDA tensors, gloo for CPU ones.
gloo with CUDA tensors runs only when the caller named gloo when joining
(`init_distributed(backend="gloo")`, `Ranks(..., backend="gloo")`), for
ranks that share one card, which NCCL refuses: then every collective copies
its CUDA tensor through pinned host memory, counts the bytes in
`STAGED_BYTES` and `use_mesh` prints the count when it closes.  A CUDA
tensor on a gloo group that nobody named, and a CPU tensor on NCCL, raise.
There is no other route and no fallback between backends.
"""

from __future__ import annotations

import gc
import os
import tempfile
import weakref
from collections import Counter
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from .commit_tile import merkle_levels
from .merkle import MerkleProverData, RowShard
from .ntt.ntt import ntt_stage_
from .program import Operands, expr_sweep
from .utils import batch_inv, cumsum, ext_pack_device

SHARDED_CALLS: Counter = Counter()  # sharded function -> calls on this rank
COLLECTIVE_BYTES: Counter = Counter()  # kind -> bytes this rank received from the others
STAGED_BYTES: Counter = Counter()  # "device_to_host" / "host_to_device" copies of staged gloo collectives
ROW27 = ("sharded_dif", "sharded_coset_lde_bitrev", "sharded_lde_bitrev_from_coeffs", "sharded_stage2",
         "sharded_mmcs_commit", "quotient_chunk_sharded", "ro_sharded")


_GLOO_NAMED = False  # this process joined with gloo named by its caller: CUDA tensors may be staged


def reset_counts() -> None:
    SHARDED_CALLS.clear()
    COLLECTIVE_BYTES.clear()
    STAGED_BYTES.clear()


@dataclass(frozen=True)
class ProverMesh:
    group: Optional[dist.ProcessGroup]  # None: the default group
    rank: int
    n: int
    log_n: int

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group))


_CURRENT: Optional[ProverMesh] = None


def current_mesh() -> Optional[ProverMesh]:
    return _CURRENT


def _mesh(group: Optional[dist.ProcessGroup]) -> ProverMesh:
    """This rank's mesh over `group` (default: every rank)."""
    n = dist.get_world_size(group)
    if n & (n - 1):
        raise ValueError(f"mesh size must be a power of two, got {n} ranks")
    return ProverMesh(group, dist.get_rank(group), n, n.bit_length() - 1)


@contextmanager
def use_mesh(group: Optional[dist.ProcessGroup] = None):
    """Activate row-sharded proving over `group` on this rank."""
    global _CURRENT
    pm = _mesh(group)
    prev = _CURRENT
    _CURRENT = pm
    try:
        yield pm
    finally:
        _CURRENT = prev
        if STAGED_BYTES:
            print(f"[parallel rank {pm.rank}] gloo staged {sum(STAGED_BYTES.values())} bytes of CUDA tensors "
                  f"through pinned host memory ({dict(STAGED_BYTES)})", flush=True)


def init_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None, device="cuda") -> ProverMesh:
    """Join the process group (backend: NCCL for a CUDA device, gloo for
    the CPU, unless named; gloo named with CUDA tensors stages them through
    host memory; init_method, world_size and rank as torch.distributed takes
    them, from the environment when None) and return the mesh over every
    rank."""
    global _GLOO_NAMED
    _GLOO_NAMED = backend == "gloo"
    backend = backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank)
    return global_mesh()


def global_mesh() -> ProverMesh:
    """The mesh over every rank of the default group."""
    return _mesh(None)


# -- collectives ----------------------------------------------------------------

def _staged(pm: ProverMesh, t: torch.Tensor) -> bool:
    if pm.backend == "nccl":
        if not t.is_cuda:
            raise ValueError("the nccl backend takes CUDA tensors")
        return False
    if t.is_cuda and not _GLOO_NAMED:
        raise ValueError("gloo carries CUDA tensors only when named: init_distributed(backend='gloo') or "
                         "Ranks(..., backend='gloo'); NCCL is the backend for CUDA tensors")
    return t.is_cuda


def _host(pm: ProverMesh, t: torch.Tensor, copy: bool = True):
    """(tensor the collective takes, whether it was staged); copy=False
    for a tensor the collective only writes."""
    t = t.contiguous()
    if not _staged(pm, t):
        return t, False
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    if copy:
        h.copy_(t)
        STAGED_BYTES["device_to_host"] += t.numel() * t.element_size()
    return h, True


def _back(out: torch.Tensor, staged: bool, device) -> torch.Tensor:
    if not staged:
        return out
    STAGED_BYTES["host_to_device"] += out.numel() * out.element_size()
    return out.to(device)


def all_to_all(pm: ProverMesh, x: torch.Tensor, kind: str) -> torch.Tensor:
    """x (D, ...): chunk s goes to rank s; returns (D, ...) whose chunk s came
    from rank s."""
    src, staged = _host(pm, x)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=pm.group)
    COLLECTIVE_BYTES[kind] += src.numel() * src.element_size() * (pm.n - 1) // pm.n
    return _back(out, staged, x.device)


def broadcast(pm: ProverMesh, x: torch.Tensor, src: int, kind: str) -> torch.Tensor:
    """Rank src's x on every rank (x gives the shape and dtype elsewhere)."""
    t, staged = _host(pm, x, copy=pm.rank == src)
    dist.broadcast(t, src if pm.group is None else dist.get_global_rank(pm.group, src), group=pm.group)
    if pm.rank != src:
        COLLECTIVE_BYTES[kind] += t.numel() * t.element_size()
    return _back(t, staged, x.device) if pm.rank != src else x


def all_gather(pm: ProverMesh, x: torch.Tensor, kind: str) -> torch.Tensor:
    """(D, *x.shape): every rank's x in rank order."""
    src, staged = _host(pm, x)
    parts = [torch.empty_like(src) for _ in range(pm.n)]
    dist.all_gather(parts, src, group=pm.group)
    COLLECTIVE_BYTES[kind] += src.numel() * src.element_size() * (pm.n - 1)
    return _back(torch.stack(parts), staged, x.device)


# -- layouts --------------------------------------------------------------------

def shard_rows(pm: ProverMesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous block of the last axis (no communication)."""
    b = x.shape[-1] // pm.n
    return x[..., pm.rank * b : (pm.rank + 1) * b].contiguous()


def gather_blocks(pm: ProverMesh, blk: torch.Tensor, kind: str) -> torch.Tensor:
    """Every rank's block of the last axis, concatenated: the whole array."""
    g = all_gather(pm, blk, kind)  # (D, ..., b)
    return g.movedim(0, -2).reshape(*blk.shape[:-1], -1).contiguous()


def whole_prefix(data: MerkleProverData, i: int, length: int, kind: str) -> torch.Tensor:
    """The first `length` stored rows of matrix i of a tree, replicated: a
    slice of a whole matrix; of a block-sharded one, each rank whose block
    holds part of the prefix broadcasts that part."""
    mat = data.mats[i]
    if not data.is_block(i):
        return mat[:, :length].contiguous()
    pm, b = data.shard.mesh, mat.shape[-1]
    parts = []
    for s in range(-(-length // b)):
        c = min(b, length - s * b)
        part = mat[:, :c] if pm.rank == s else torch.empty((mat.shape[0], c), dtype=mat.dtype, device=mat.device)
        parts.append(broadcast(pm, part, s, kind))
    return torch.cat(parts, dim=-1)


def cyclic_slice(pm: ProverMesh, x: torch.Tensor, length: int) -> torch.Tensor:
    """This rank's residue class x[..., r::D] of natural-order rows, zero
    padded to `length` (no communication)."""
    c = x[..., pm.rank :: pm.n]
    out = torch.zeros(c.shape[:-1] + (length,), dtype=x.dtype, device=x.device)
    out[..., : c.shape[-1]] = c
    return out


def cyclic_from_blocks(pm: ProverMesh, blk: torch.Tensor, kind: str) -> torch.Tensor:
    """Natural-order rows held in contiguous blocks (w, J) -> this rank's
    residue class (w, J): one all_to_all (block element l goes to rank
    l mod D, at position rank·J/D + l // D there)."""
    w, J = blk.shape
    send = blk.reshape(w, J // pm.n, pm.n).permute(2, 0, 1)  # (D, w, J/D): chunk s = residue s
    recv = all_to_all(pm, send, kind)  # chunk s = my residue from rank s's block
    return recv.permute(1, 0, 2).reshape(w, J)


# -- the sharded DIF and LDEs (JAX parallel.py:130-268) ------------------------

_CYCLIC_TABLES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _cyclic_table(engine, pm: ProverMesh, s: int, inverse: bool) -> torch.Tensor:
    """Stage s's table taken at stride D from offset rank: the twiddles of
    the rank's residue class, tw[s].reshape(-1, D)[:, rank]."""
    cache = _CYCLIC_TABLES.setdefault(engine, {})
    key = (s, inverse, pm.n, pm.rank)
    if key not in cache:
        cache[key] = engine.stage_table(s, inverse).reshape(-1, pm.n)[:, pm.rank].contiguous()
    return cache[key]


def sharded_dif(engine, pm: ProverMesh, x_cyc: torch.Tensor, log_n: int, inverse: bool) -> torch.Tensor:
    """Forward/inverse DIF of natural-order rows (w, n), row axis sharded:
    x_cyc is this rank's residue class (w, n/D) (`cyclic_slice`,
    `cyclic_from_blocks`); returns this rank's block (w, n/D) of the
    bit-reversed output.  Coarse stages (span >= D) on the residue class
    with the rank's table slices (K2), one all_to_all, the size-D fine
    stages (K2)."""
    D, log_D = pm.n, pm.log_n
    n = 1 << log_n
    J = n // D
    assert J >= D, f"need 2^{log_n} >= D^2 (D={D}) for the all-to-all transpose"
    SHARDED_CALLS["sharded_dif"] += 1
    F = engine.F
    x = x_cyc.reshape(-1, J).contiguous().clone()
    w = x.shape[0]
    for s in range(log_n, log_D, -1):
        ntt_stage_(F, x, _cyclic_table(engine, pm, s, inverse), dif=True)
    # four-step transpose: chunk s = my residue at the j of rank s's block
    recv = all_to_all(pm, x.reshape(w, D, J // D).permute(1, 0, 2), "dif")
    y = recv.permute(1, 2, 0).reshape(w, J).contiguous()  # position j'·D + r' holds residue r' at j'
    for s in range(log_D, 0, -1):
        ntt_stage_(F, y, engine.stage_table(s, inverse), dif=True)
    return y


def sharded_coset_lde_bitrev(engine, pm: ProverMesh, evals_natural: torch.Tensor, log_n: int, log_blowup: int,
                             shift: int) -> torch.Tensor:
    """The commit LDE: iDFT, shift scale (replicated, K2 + K14 + K1/K5), the
    zero pad of the rank's residue class, then the sharded forward DIF.
    Returns this rank's block of the bit-reversed LDE (w, n·B/D)."""
    SHARDED_CALLS["sharded_coset_lde_bitrev"] += 1
    coeffs = engine.coset_extend(evals_natural, log_n, 0, shift)  # (w, n) natural coefficients
    big = log_n + log_blowup
    return sharded_dif(engine, pm, cyclic_slice(pm, coeffs, (1 << big) // pm.n), big, inverse=False)


def sharded_lde_bitrev_from_coeffs(engine, pm: ProverMesh, coeffs_natural: torch.Tensor,
                                   log_big: int) -> torch.Tensor:
    """The quotient commit's LDE from natural coefficients (any coset shift
    baked in): zero pad the rank's residue class, the sharded forward DIF."""
    SHARDED_CALLS["sharded_lde_bitrev_from_coeffs"] += 1
    return sharded_dif(engine, pm, cyclic_slice(pm, coeffs_natural, (1 << log_big) // pm.n), log_big,
                       inverse=False)


# -- the sharded stage-2 logUp scan (JAX parallel.py:271-380) ------------------

def sharded_stage2(E, pm: ProverMesh, lv, beta: torch.Tensor, gamma: torch.Tensor, acc0: torch.Tensor):
    """Stage 2 of one circuit on this rank's block of rows (n % D == 0):
    the block's slot messages (K11), their inverses (K4), the terms and
    their inclusive scan (K1/K5, K4); one all_gather of the D block totals
    gives the exclusive offset, added with acc0 (K1/K5).  The chain order is
    row-major, slot-minor, so a block of rows is a run of the chain and the
    values are the single-device ones.  Returns (this rank's block of the
    stage-2 matrix (L·D_ext, n/D), the chain total (D_ext,) replicated)."""
    SHARDED_CALLS["sharded_stage2"] += 1
    D = E.D
    n, L = lv.height, len(lv.arities)
    b = n // pm.n
    blk = lv.matrix[:, pm.rank * b : (pm.rank + 1) * b].contiguous()
    pubs = ext_pack_device((beta, gamma)).reshape(-1)
    msgs = expr_sweep(E.base, lv.stage2_program, Operands(sources=[blk], rows=b, pubs=pubs), (D + 1, b * L), b * L, L)
    incl = cumsum(E.scale(batch_inv(msgs[:D], E), msgs[D]), E)
    totals = all_gather(pm, incl[:, -1], "stage2")  # (ranks, D)
    offset, total = acc0.reshape(D), None
    for s in range(pm.n):
        total = totals[s] if total is None else E.add(total, totals[s])
        if s < pm.rank:
            offset = E.add(offset, totals[s])
    excl = torch.cat([torch.zeros_like(incl[:, :1]), incl[:, :-1]], dim=1)
    acc_flat = E.add(excl, offset)
    mat = acc_flat.reshape(D, b, L).permute(2, 0, 1).reshape(L * D, b).contiguous()
    return mat, total


# -- the sharded Merkle commit (JAX parallel.py:383-411) -----------------------

def sharded_mmcs_commit(mmcs, pm: ProverMesh, mats: Sequence[torch.Tensor], heights: Sequence[int]):
    """MMCS commit with every matrix of height h >= D block-sharded (mats[i]
    is this rank's block (w, h/D)) and every shorter one replicated (mats[i]
    the whole (w, h)).  The rank hashes its blocks (K3/K6) and folds its
    subtree with the sharded shorter matrices injected inside it (K15); one
    all_gather of the subtree roots (or, for a cap of more than D digests,
    of the rank's part of the cap); the top levels with the replicated
    matrices injected and the cap, replicated (K15).  Returns (cap, data)
    with the cap the single-device one."""
    SHARDED_CALLS["sharded_mmcs_commit"] += 1
    hasher = mmcs.hasher
    hs = mmcs.check_heights(heights)
    H = hs[0]
    if H < pm.n:
        raise ValueError(f"a sharded tree needs a matrix of at least D = {pm.n} rows")
    log_max = H.bit_length() - 1
    n_local = min(log_max - pm.log_n, log_max - mmcs.cap_height)  # levels each rank folds alone

    def digests(h):
        return hasher.hash_matrices([m.contiguous() for m, mh in zip(mats, heights) if mh == h])

    leaves = digests(H)
    inside = {log_max - h.bit_length() + 1: digests(h) for h in hs[1:] if h >= pm.n}
    local = [leaves] + merkle_levels(hasher, leaves, n_local, inside)
    top = all_gather(pm, local[-1], "tree").reshape(-1, 8)
    above = {log_max - h.bit_length() + 1 - n_local: digests(h) for h in hs if h < pm.n}
    layers = local[:-1] + [top] + merkle_levels(hasher, top, log_max - mmcs.cap_height - n_local, above)
    dims = [(int(m.shape[0]), int(h)) for m, h in zip(mats, heights)]
    data = MerkleProverData(mats=list(mats), dims=dims, layers=layers, log_max=log_max,
                            shard=RowShard(pm, n_local))
    return layers[-1], data


def gather_openings(mmcs, datas: Sequence[MerkleProverData], indices_list) -> list:
    """The device gathers of `MerkleMmcs.gather_device` for trees some of
    which are sharded: each query's block rows and lower path (the rank-local
    layers) come from the rank that owns its leaf, all trees in one
    all_gather; the upper path and the replicated matrices' rows are local.
    Every rank returns the same (sibs (path_len, Q, 8), rows [(w, Q)])."""
    pm = next(d.shard.mesh for d in datas if d.shard is not None)
    out: List[Optional[tuple]] = [None] * len(datas)
    pending, pieces = [], []
    for t, (data, ix) in enumerate(zip(datas, indices_list)):
        if data.shard is None:
            out[t] = mmcs.gather_device(data, ix)
            continue
        assert data.shard.mesh == pm, "one mesh per opening"
        idx = torch.as_tensor([int(i) for i in ix], dtype=torch.int64, device=data.layers[0].device)
        local_log = data.log_max - pm.log_n
        lidx = idx & ((1 << local_log) - 1)
        nl, path_len = data.shard.local_levels, data.log_max - mmcs.cap_height
        own = [data.layers[lv].index_select(0, (lidx >> lv) ^ 1) for lv in range(nl)]  # (Q, 8) each
        upper = [data.layers[lv].index_select(0, (idx >> lv) ^ 1) for lv in range(nl, path_len)]
        rows, block_rows = [], []
        for i, (m, (w, h)) in enumerate(zip(data.mats, data.dims)):
            shift = data.log_max - (h.bit_length() - 1)
            if data.is_block(i):
                r = m.index_select(1, lidx >> shift)  # (w, Q)
                block_rows.append(i)
                own.append(r.t().reshape(-1).view(torch.int32).reshape(len(ix), 2 * w))  # (Q, 2w)
                rows.append(None)
            else:
                rows.append(m.index_select(1, idx >> shift))
        piece = torch.cat(own, dim=1) if own else torch.zeros((len(ix), 0), dtype=torch.int32, device=idx.device)
        pending.append((t, idx >> local_log, nl, upper, rows, block_rows, piece.shape[1]))
        pieces.append(piece.reshape(-1))
    g = all_gather(pm, torch.cat(pieces), "queries")  # (D, Σ Q·k)
    off = 0
    for t, owner, nl, upper, rows, block_rows, k in pending:
        q = owner.shape[0]
        sel = g[:, off : off + q * k].reshape(pm.n, q, k)[owner, torch.arange(q, device=owner.device)]  # (Q, k)
        off += q * k
        sibs = sel[:, : nl * 8].reshape(q, nl, 8).permute(1, 0, 2)
        sib = torch.cat([sibs] + [u.unsqueeze(0) for u in upper]) if nl + len(upper) else sibs
        col = nl * 8
        for i in block_rows:
            w = datas[t].dims[i][0]
            rows[i] = sel[:, col : col + 2 * w].reshape(-1).view(torch.int64).reshape(q, w).t()
            col += 2 * w
        out[t] = (sib.contiguous(), rows)
    return out


# -- SPMD launches ----------------------------------------------------------------

def _rank_entry(rank: int, fn: Callable, world: int, backend: str, store: str, args: tuple) -> None:
    global _GLOO_NAMED
    torch.set_num_threads(1)
    _GLOO_NAMED = backend == "gloo"
    dist.init_process_group(backend, init_method=f"file://{store}/store", world_size=world, rank=rank)
    try:
        torch.save(fn(rank, *args), os.path.join(store, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


class Ranks:
    """`world` processes started together with the spawn method, each
    joined to one group of `backend` ("nccl" or "gloo", named by the caller)
    through a file:// store in a fresh temporary directory, each running
    fn(rank, *args).  `results()` waits for all of them (a rank that raises
    raises here) and returns their return values in rank order."""

    def __init__(self, fn: Callable, world: int, args: tuple, backend: str):
        import torch.multiprocessing as mp

        self._tmp = tempfile.TemporaryDirectory(prefix="msrank")
        self.world = world
        self._ctx = mp.spawn(_rank_entry, args=(fn, world, backend, self._tmp.name, args), nprocs=world,
                             join=False)

    def results(self, timeout: float = 900.0) -> list:
        """The ranks' return values; a rank still running after `timeout`
        seconds is killed, with every other, and TimeoutError raised."""
        import time

        deadline = time.monotonic() + timeout
        try:
            while not self._ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    for proc in self._ctx.processes:
                        proc.kill()
                        proc.join()
                    raise TimeoutError(f"{self.world} ranks still running after {timeout} s")
            return [torch.load(os.path.join(self._tmp.name, f"rank{r}.pt"), weights_only=False)
                    for r in range(self.world)]
        finally:
            self._tmp.cleanup()
            self._ctx = None  # its error queues' semaphores unregister from the tracker here
            gc.collect()
            _stop_resource_tracker()


def _stop_resource_tracker() -> None:
    """Stop the helper process that the spawn method starts beside the ranks
    (multiprocessing's resource tracker).  Left alone it outlives the
    process that started it; the next spawn starts it again."""
    from multiprocessing import resource_tracker

    tracker = resource_tracker._resource_tracker
    with tracker._lock:
        if tracker._fd is not None and tracker._pid is not None:
            os.close(tracker._fd)  # the tracker exits when this pipe closes
            os.waitpid(tracker._pid, 0)
            tracker._fd = tracker._pid = None


def dryrun_multichip(n: int, device: str = "cuda") -> list:
    """A real sharded prove on n ranks: the bench system (U32Add +
    preprocessed ByteTable, claims) at 2^10 rows on GoldilocksBlake3, every
    rank's bytes held against a single-device prove in this process, and
    every sharded function of row 27 counted on every rank.  device "cuda":
    NCCL with one rank per card when the machine has n cards, else gloo
    named for n ranks on card 0 (collectives staged through pinned host
    memory); "cpu": gloo on the CPU.  Returns every rank's report."""
    from .examples.sharded_proof import run_world

    if device == "cpu":
        backend = "gloo"
    elif not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA device (pass device='cpu')")
    else:
        backend = "nccl" if torch.cuda.device_count() >= n else "gloo"
    reports, want = run_world(n, backend, device, [("goldilocks_blake3", (10,))])
    for rep in reports:
        missing = [f for f in ROW27 if rep["counts"]["goldilocks_blake3"]["sharded_calls"].get(f, 0) <= 0]
        if missing:
            raise AssertionError(f"rank {rep['rank']}: sharded functions never called {missing}")
    d = want["goldilocks_blake3", 10]
    print(f"dryrun_multichip({n}): {n} ranks ({backend} on {device}), proof {d['n_bytes']} bytes sha256 "
          f"{d['sha256']} on every rank")
    return reports
