"""The Fiat-Shamir duplex on the device (the counterpart of
multistark_tpu/device_transcript.py): kernels K7 (dt_flush) and K8
(fri_grind), both in csrc/dt_blake3.cu.

The host challenger (`SerializingChallenger64` over BLAKE3) is
transcript-serial: every sample needs the bytes observed before it, so a
prove that keeps its transcript on the host fetches every cap, accumulator
and claimed value before the next challenge.  `DeviceDuplex` replicates its
byte duplex with device values: observed device words stay tensors, each
flush hashes on the device, and the sampled challenges are device scalars
that the next stage consumes directly.  The host replays the transcript
after one global fetch and stays the authority (dt_prover.py).

Duplex byte layout (challenger.py ByteHashChallenger / SerializingChallenger64):
  - flush: digest = blake3(input buffer); the input becomes the digest
    (chaining) and the output is the digest's bytes, popped from the END;
  - a u64 draw pops 8 bytes and reads them little-endian, so draw k of one
    digest has low word bswap32(word[7-2k]) and high word bswap32(word[6-2k]);
  - grind(bits): the least witness w whose flush over (input ‖ w_le8) gives
    a canonical draw 0 with `bits` low zero bits; the witness check pops that
    draw, so β's D coordinates are draws 1..D of the same digest.

A device word is an int32 tensor holding the u32 bit pattern; a digest is an
(8,) int32 tensor, a cap the Merkle tree's (k, 8) int32 digest layer, an
extension scalar a (D,) int64 tensor of canonical values.  A draw that is
not canonical (>= p, about 2^-32 per draw) is not modelled: its flag goes to
`valids`, and the caller falls back to the host transcript.

K7 and K8 each have their plain PyTorch version beside them; the wrappers
take it for CPU tensors only, and a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import kernels
from .hash.blake3 import _compress_plain, _hash_words_plain, _to_i32
from .hash.blake3_host import (BLOCK_LEN, CHUNK_END, CHUNK_LEN, CHUNK_START, IV, PARENT, ROOT, ClaimsSegment,
                               part_nbytes, parts_bytes, parts_chunk_cvs, parts_hash)
from .native import lib as native_lib
from .utils import scratch, to_device

GOLDILOCKS_P = 0xFFFFFFFF_00000001
_M32 = 0xFFFFFFFF

# Device-transcript results the host replay could not adopt, by reason.  Each
# one reran its part of the prove through the host transcript.
FALLBACKS: Counter = Counter()


class Fallback(Exception):
    """A device-transcript run the host cannot adopt for a reason the device
    path does not model (a draw >= p, a grind miss, or a shape it does not
    take); the message names the reason."""


class TranscriptDivergence(RuntimeError):
    """The host replay drew another challenge, or rejected a grind witness,
    where the device transcript had its own: only a wrong kernel (K7-K10) or
    a bug on the device path can cause that, so it is raised, never taken as
    a fallback.  The message names the draw."""


# --- draws (plain tensor ops on u32 words held in int64) ---------------------------

def bswap32(x: torch.Tensor) -> torch.Tensor:
    return ((x & 0xFF) << 24) | ((x & 0xFF00) << 8) | ((x >> 8) & 0xFF00) | ((x >> 24) & 0xFF)


def digest_draws(digest: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(..., 8) digest words -> the four (lo, hi) draws in pop order, as
    int64 u32 values."""
    d = digest.to(torch.int64) & _M32
    return [(bswap32(d[..., 7 - 2 * k]), bswap32(d[..., 6 - 2 * k])) for k in range(4)]


def draw_lt_p(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """u64 (lo, hi) < p for Goldilocks p = 2^64 - 2^32 + 1."""
    return (hi != _M32) | (lo == 0)


def u64_of_pair(lo: int, hi: int) -> int:
    return (int(lo) & _M32) | ((int(hi) & _M32) << 32)


def entry_buffer_words(input_buffer: bytes) -> Optional[np.ndarray]:
    """The challenger's input buffer as u32 words, or None if it is not
    word-aligned (the device commit phase is then skipped)."""
    if len(input_buffer) % 4:
        return None
    return np.frombuffer(bytes(input_buffer), dtype="<u4").copy()


# --- K8: the FRI commit-phase grind -------------------------------------------------

def grind_round(input_words: torch.Tensor, bits: int):
    """Plain version of K8's search: the least w < 64·2^bits whose flush
    over (input ‖ w_le8) has a canonical draw 0 with `bits` low zero bits.
    input_words: (L,) int32.  Returns (w 0-d int64, digest (8,) int32, found
    0-d bool); without a passing w, candidate 0 and found False.  Candidates
    go in batches in increasing order, and the first batch with a pass ends
    the search: the same least w as hashing them all."""
    words = input_words.to(torch.int64) & _M32
    dev, L, n = words.device, words.shape[0], 64 << bits
    mask = (1 << bits) - 1
    batch = min(n, 4 << bits)
    for start in range(0, n, batch):
        cands = torch.arange(start, min(n, start + batch), dtype=torch.int64, device=dev)
        msgs = torch.cat([words.expand(cands.shape[0], L), cands[:, None], torch.zeros_like(cands)[:, None]], dim=1)
        digests = _hash_words_plain(msgs)
        lo, hi = bswap32(digests[:, 7]), bswap32(digests[:, 6])
        ok = draw_lt_p(lo, hi) & ((lo & mask) == 0)
        if bool(ok.any()):
            i = int(torch.argmax(ok.to(torch.int64)))
            return cands[i], _to_i32(digests[i]), torch.ones((), dtype=torch.bool, device=dev)
    zero = torch.zeros((1, 1), dtype=torch.int64, device=dev)
    digest = _hash_words_plain(torch.cat([words[None, :], zero, zero], dim=1))[0]
    return zero[0, 0], _to_i32(digest), torch.zeros((), dtype=torch.bool, device=dev)


def sample_ext_from_digest(digest: torch.Tensor, degree: int):
    """β after a grind: draws 1..D of the grind digest (draw 0 was popped by
    the witness check).  Returns (β (D,) int64, valid 0-d bool); valid is
    False when a draw is >= p, which the device path does not model."""
    if not 1 <= degree <= 3:
        raise ValueError("only D <= 3 fits in one digest after the grind draw")
    draws = digest_draws(digest)[1 : degree + 1]
    beta = torch.stack([lo | (hi << 32) for lo, hi in draws])
    valid = torch.stack([draw_lt_p(lo, hi) for lo, hi in draws]).all()
    return beta, valid


def fri_grind_plain(inp: torch.Tensor, bits: int, degree: int):
    w, digest, found = grind_round(inp, bits)
    beta, valid = sample_ext_from_digest(digest, degree)
    return w, (found & valid).to(torch.int64), beta, digest


def fri_grind(inp: torch.Tensor, bits: int, degree: int):
    """One FRI round's grind and β on the duplex input `inp` (chain ‖ cap,
    (L,) int32).  Returns (w 0-d int64, ok 0-d int64: 1 when a witness was
    found and β is canonical, β (D,) int64, digest (8,) int32: the next
    round's chain).  K8 on a CUDA tensor (one launch), the plain version on
    a CPU one."""
    inp = inp.reshape(-1).contiguous()
    if inp.dtype != torch.int32:
        raise TypeError("fri_grind takes int32 words")
    if not kernels.use_kernel(inp):
        return fri_grind_plain(inp, bits, degree)
    if not 0 <= bits <= 24 or not 1 <= degree <= 3:
        raise ValueError(f"fri_grind takes 0 <= bits <= 24 and 1 <= D <= 3, got {bits}, {degree}")
    kernels.check_cuda(inp)
    out = torch.empty(8, dtype=torch.int64, device=inp.device)
    digest = torch.empty(8, dtype=torch.int32, device=inp.device)
    L = inp.shape[0]
    kernels.FRI_GRIND.launch("fri_grind", kernels.ptr(inp), L, bits, degree, kernels.ptr(out), kernels.ptr(digest),
                             kernels.ptr(scratch(inp).take_counters(inp, 2)), cost=grind_cost(L, bits))
    return out[0], out[1], out[2 : 2 + degree], digest


def grind_compressions(L: int) -> Tuple[int, int]:
    """(the dependent compressions of K8's prefix, those of one candidate)
    for an L-word duplex input.  The prefix: the whole chunks before w's
    chunk c, 32 at a time side by side (16 blocks each), merged one after
    another (c - popcount(c) parents), then chunk c's blocks before w's.
    A candidate: from w's block to the end of its chunk, then the chunk
    tree's parents above it."""
    T = L + 2
    c, n_chunks = L // 256, -(-T // 256)
    prefix = 16 * -(-c // 32) + c - bin(c).count("1") + (L % 256) // 16
    chunk_words = min(256, T - 256 * c)
    candidate = -(-chunk_words // 16) - (L % 256) // 16
    if n_chunks > 1:
        candidate += bin(c).count("1") + (c + 1 < n_chunks)  # parents above w's chunk
    return prefix, candidate


def grind_cost(L: int, bits: int) -> Tuple[float, float, float]:
    """K8's least time per round, as kernels.CudaKernel.launch takes it: the
    bytes (the input read, w, the flag, β and the digest written), the
    operations of the about 2^bits candidates a round hashes to its first
    passing one, and the latency of the round's dependent compressions: the
    prefix, one candidate, the winner hashed again."""
    prefix, candidate = grind_compressions(L)
    return (4 * L + 8 * 8 + 32, (1 << bits) * candidate * kernels.OPS_PER_BLAKE3,
            (prefix + 2 * candidate) * kernels.BLAKE3_LATENCY_MS)


# --- K7: one duplex flush ------------------------------------------------------------

class FlushInputs(NamedTuple):
    """K7's operands: the spliced chunks holding device bytes (T, 256)
    int32, the plan (int32, layout in csrc/dt_blake3.cu), the host sibling
    chaining values (S, 8) int32, the plan's number of parent ops, and the
    flush's dependent compressions (the most blocks of a device chunk, then
    the parent ops, which one thread runs in order)."""

    chunks: torch.Tensor
    plan: torch.Tensor
    sibs: torch.Tensor
    n_ops: int
    chain: int


_PLAN_HEAD = 5  # n_chunks, T, S, n_ops, root source


def dt_flush_plain(chunks: torch.Tensor, plan: torch.Tensor, sibs: torch.Tensor, n_ops: int):
    """Plain version of K7: (digest (8,) int32, draws (8,) int64: the four
    draws, then their `< p` flags as 0/1)."""
    head = plan.tolist()
    n_chunks, T, S, n_ops, root_src = head[:_PLAN_HEAD]
    meta = head[_PLAN_HEAD : _PLAN_HEAD + 2 * T]
    ops = head[_PLAN_HEAD + 2 * T : _PLAN_HEAD + 2 * T + 3 * n_ops]
    words = chunks.to(torch.int64) & _M32
    sib_words = sibs.to(torch.int64) & _M32
    dev = chunks.device

    def iv():
        return [torch.full((1,), IV[i], dtype=torch.int64, device=dev) for i in range(8)]

    cvs = []
    for t in range(T):
        counter, nbytes = meta[2 * t], meta[2 * t + 1]
        n_blocks = max(1, -(-nbytes // BLOCK_LEN))
        cv = iv()
        for b in range(n_blocks):
            flags = (CHUNK_START if b == 0 else 0) | (CHUNK_END if b == n_blocks - 1 else 0)
            if n_chunks == 1 and b == n_blocks - 1:
                flags |= ROOT
            block = [words[t, 16 * b + i : 16 * b + i + 1] for i in range(16)]
            cv = _compress_plain(cv, block, counter, min(BLOCK_LEN, nbytes - b * BLOCK_LEN), flags)
        cvs.append(cv)

    def cv_at(s):
        if s < T:
            return cvs[s]
        if s < T + S:
            return [sib_words[s - T, i : i + 1] for i in range(8)]
        return cvs[s - S]

    for j in range(n_ops):
        left, right, flags = ops[3 * j : 3 * j + 3]
        cvs.append(_compress_plain(iv(), cv_at(left) + cv_at(right), 0, BLOCK_LEN, PARENT | flags))
    digest = torch.cat(cv_at(root_src))
    draws = digest_draws(digest)
    vals = [lo | (hi << 32) for lo, hi in draws]
    oks = [draw_lt_p(lo, hi).to(torch.int64) for lo, hi in draws]
    return _to_i32(digest), torch.stack(vals + oks)


def dt_flush(chunks: torch.Tensor, plan: torch.Tensor, sibs: torch.Tensor, n_ops: int, chain: int):
    """One duplex flush (K7) of `FlushInputs`: returns (digest (8,) int32,
    draws (8,) int64: draws 0-3, then their `< p` flags).  `chain` only
    enters the launch's least time."""
    if not kernels.use_kernel(chunks):
        return dt_flush_plain(chunks, plan, sibs, n_ops)
    kernels.check_cuda(chunks, plan, sibs)
    if chunks.dim() != 2 or chunks.shape[1] != 256 or chunks.dtype != torch.int32:
        raise ValueError("dt_flush takes (T, 256) int32 chunks")
    T = chunks.shape[0]
    dev = chunks.device
    cvs = torch.empty((T + n_ops, 8), dtype=torch.int32, device=dev)
    digest = torch.empty(8, dtype=torch.int32, device=dev)
    draws = torch.empty(8, dtype=torch.int64, device=dev)
    p = kernels.ptr
    kernels.DT_FLUSH.launch("dt_flush", p(chunks), p(plan), p(sibs), p(cvs), T, p(digest), p(draws),
                            cost=(4 * (chunks.numel() + plan.numel() + sibs.numel()) + 32 + 64,
                                  (16 * T + n_ops) * kernels.OPS_PER_BLAKE3, chain * kernels.BLAKE3_LATENCY_MS))
    return digest, draws


def _host_parent_level(cvs: np.ndarray) -> np.ndarray:
    out = np.empty(((cvs.shape[0] + 1) // 2, 8), np.uint32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    native_lib().msb3_parent_level(np.ascontiguousarray(cvs).ctypes.data_as(u32p), cvs.shape[0],
                                   out.ctypes.data_as(u32p))
    return out


# --- the duplex --------------------------------------------------------------------

class DeviceDuplex:
    """Device mirror of the BLAKE3 byte duplex for the whole prove schedule.

    Observation only records segments: host bytes verbatim, a homogeneous
    batch of claims as its array (a claims segment), device values as flat
    int32 word tensors.  A flush lays the buffer out (the chain, then the
    segments), lets the host C helper hash every chunk and parent level of
    the host parts straight from them (device positions zero; the claims
    from their array, 16 chunks at a time), uploads the chunks that hold
    device bytes with the sibling chaining values their root path needs and
    the plan, splices the device bytes into those chunks by tensor slicing,
    and runs K7: O(1) device compressions whatever the buffer's size (the
    β/γ flush carries the megabytes of claims at 2^18 rows).  `sample_ext`
    pops draws like SerializingChallenger64 and returns device scalars."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.chain: Optional[torch.Tensor] = None  # (8,) int32 digest words, None before the first flush
        self.segments: list = []  # ("h", bytearray) | ("c", ClaimsSegment) | ("d", flat int32 tensor)
        self.valids: List[torch.Tensor] = []  # one 0/1 int64 flag per consumed draw
        self._draws_left = 0
        self._draws: Optional[torch.Tensor] = None  # (8,) int64: draws 0-3, then their flags

    # -- observation -------------------------------------------------------
    def observe_bytes(self, data: bytes) -> None:
        self._draws_left = 0
        if self.segments and self.segments[-1][0] == "h":
            self.segments[-1][1].extend(data)
        else:
            self.segments.append(("h", bytearray(data)))

    def observe_u64(self, v: int) -> None:
        self.observe_bytes(int(v).to_bytes(8, "little"))

    def observe_claims_array(self, arr: np.ndarray, p: int) -> None:
        """Canonical (n, L) uint64 claims as a claims segment (u64(L), then
        the values, per row): hashed from `arr` at the next flush, which the
        prove schedule makes right after (β); `arr` is read-only until then
        (blake3_host.ClaimsSegment)."""
        self._draws_left = 0
        self.segments.append(("c", ClaimsSegment(np.ascontiguousarray(arr, np.uint64), p)))

    def observe_words_device(self, words: torch.Tensor) -> None:
        """Device u32 words (int32), observed as their little-endian bytes."""
        if words.dtype != torch.int32:
            raise TypeError("device words are int32")
        self._draws_left = 0
        self.segments.append(("d", words.reshape(-1).contiguous()))

    def observe_cap_device(self, cap: torch.Tensor) -> None:
        """A tree's (k, 8) int32 cap, observed as digest_0 ‖ digest_1 ‖ ...,
        8 LE words each (SerializingChallenger64.observe_commitment)."""
        self.observe_words_device(cap)

    def observe_ext_device(self, value: torch.Tensor) -> None:
        """A (D,) int64 extension scalar, observed as D canonical u64 LE."""
        self.observe_words_device(value.reshape(-1).contiguous().view(torch.int32))

    # -- flush -------------------------------------------------------------
    def _layout(self):
        """(total bytes, the host parts in order (blake3_host.parts_hash's
        kinds: host bytes, a claims segment, the number of zero bytes at a
        device run), device runs [(byte offset, words)])."""
        segments = ([("d", self.chain)] if self.chain is not None else []) + self.segments
        parts, runs, off = [], [], 0
        for kind, data in segments:
            if kind == "d":
                runs.append((off, data))
                data = 4 * data.shape[0]
            parts.append(data)
            off += part_nbytes(data)
        return off, parts, runs

    def flush_inputs(self) -> Optional[FlushInputs]:
        """K7's operands for the buffer as it stands, the device bytes
        spliced in; None when every byte is a host byte."""
        total, parts, runs = self._layout()
        if not runs:
            return None
        n_chunks = max(1, -(-total // CHUNK_LEN))
        dev_chunks = sorted({
            c for off, w in runs for c in range(off // CHUNK_LEN, (off + 4 * w.shape[0] - 1) // CHUNK_LEN + 1)
        })
        levels = [parts_chunk_cvs(parts)]
        while levels[-1].shape[0] > 1:
            levels.append(_host_parent_level(levels[-1]))
        # the root path: parent ops over device nodes and host siblings
        src = {(0, c): ("c", t) for t, c in enumerate(dev_chunks)}
        sibs, ops = [], []

        def source(level, idx):
            if (level, idx) not in src:
                src[(level, idx)] = ("s", len(sibs))
                sibs.append(levels[level][idx])
            return src[(level, idx)]

        cur, count, level = set(dev_chunks), n_chunks, 0
        while count > 1:
            pairs, odd = count // 2, count % 2
            nxt = set()
            for p in range(pairs):
                if 2 * p in cur or 2 * p + 1 in cur:
                    left, right = source(level, 2 * p), source(level, 2 * p + 1)
                    ops.append((left, right, ROOT if pairs + odd == 1 else 0))
                    src[(level + 1, p)] = ("o", len(ops) - 1)
                    nxt.add(p)
            if odd and count - 1 in cur:
                src[(level + 1, pairs)] = src[(level, count - 1)]
                nxt.add(pairs)
            cur, count, level = nxt, pairs + odd, level + 1
        T, S = len(dev_chunks), len(sibs)

        def sid(s):
            return {"c": 0, "s": T, "o": T + S}[s[0]] + s[1]

        plan = [n_chunks, T, S, len(ops), sid(src[(level, 0)])]
        for c in dev_chunks:
            plan += [c, min(CHUNK_LEN, total - c * CHUNK_LEN)]
        for left, right, flags in ops:
            plan += [sid(left), sid(right), flags]
        templates = np.zeros((T, CHUNK_LEN), np.uint8)
        for t, c in enumerate(dev_chunks):
            piece = parts_bytes(parts, c * CHUNK_LEN, min(total, (c + 1) * CHUNK_LEN))
            templates[t, : len(piece)] = np.frombuffer(piece, np.uint8)
        sib_arr = np.asarray(sibs, np.uint32).reshape(S, 8)
        host = np.concatenate([templates.view(np.int32).reshape(-1), sib_arr.view(np.int32).reshape(-1),
                               np.asarray(plan, np.int64).astype(np.int32)])
        dev = to_device(host, self.device)  # ONE upload, not waited for
        chunks = dev[: T * 256].view(T, 256)
        chunk_bytes = chunks.reshape(-1).view(torch.uint8)
        pos_of = {c: t for t, c in enumerate(dev_chunks)}
        for off, words in runs:  # splice the device bytes into their chunks
            run_bytes = words.view(torch.uint8)
            done = 0
            while done < run_bytes.shape[0]:
                pos = off + done
                at, take = pos % CHUNK_LEN, min(run_bytes.shape[0] - done, CHUNK_LEN - pos % CHUNK_LEN)
                t = pos_of[pos // CHUNK_LEN]
                chunk_bytes[t * CHUNK_LEN + at : t * CHUNK_LEN + at + take] = run_bytes[done : done + take]
                done += take
        sib_t = dev[T * 256 : T * 256 + S * 8].view(S, 8)
        blocks = max(max(1, -(-min(CHUNK_LEN, total - c * CHUNK_LEN) // BLOCK_LEN)) for c in dev_chunks)
        return FlushInputs(chunks, dev[T * 256 + S * 8 :], sib_t, len(ops), blocks + len(ops))

    def _flush(self) -> None:
        inputs = self.flush_inputs()
        if inputs is None:
            # every byte is a host byte (a transcript that has observed no
            # device value yet): hash on the host
            _, parts, _ = self._layout()
            d = np.frombuffer(parts_hash(parts), dtype="<u4").astype(np.int64)
            digest = torch.from_numpy(d)
            draws = digest_draws(digest)
            host = torch.stack([lo | (hi << 32) for lo, hi in draws] + [draw_lt_p(lo, hi).to(torch.int64)
                                                                         for lo, hi in draws])
            self.chain = to_device(_to_i32(digest).numpy(), self.device)
            self._draws = to_device(host.numpy(), self.device)
        else:
            self.chain, self._draws = dt_flush(*inputs)
        self.segments = []
        self._draws_left = 4

    # -- sampling ----------------------------------------------------------
    def sample_ext(self, degree: int) -> torch.Tensor:
        """D draws as a (D,) int64 device scalar.  The prove schedule always
        observes between samples, so the draws of one sample never span two
        digests."""
        if not 1 <= degree <= 4:
            raise ValueError("1 <= D <= 4")
        if self._draws_left < degree:
            self._flush()
        start = 4 - self._draws_left
        if start + degree > 4:
            raise AssertionError("draws would span two digests (schedule bug)")
        self.valids.append(self._draws[4 + start : 4 + start + degree])
        self._draws_left -= degree
        return self._draws[start : start + degree]

    def entry_words(self) -> Optional[torch.Tensor]:
        """The input buffer as int32 words (the FRI commit phase's chain);
        None if it is not word-aligned.  In the prove schedule it is called
        right after a sample, when the buffer is exactly the chain."""
        if not self.segments:
            return self.chain
        parts = [] if self.chain is None else [self.chain]
        for kind, data in self.segments:
            if kind == "d":
                parts.append(data)
                continue
            data = parts_bytes([data])
            if len(data) % 4:
                return None
            parts.append(to_device(np.frombuffer(data, dtype="<u4").view(np.int32), self.device))
        return torch.cat(parts)
