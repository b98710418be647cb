"""The proof reader: the bincode layout of the reference's Proof struct
(fixed-width little-endian integers, Vec as a u64 length and its
elements, Option as a tag byte; field elements as u64 LE, digests as 32
bytes).  Every length is bounds-checked; truncated input, trailing bytes
or a bad tag raise VerificationError("InvalidProofShape")."""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from .errors import VerificationError
from .merkle import BatchOpening
from .pcs import FriProof, QueryProof

ExtVal = Tuple[int, ...]


@dataclass
class Commitments:
    stage_1_trace: np.ndarray
    stage_2_trace: np.ndarray
    quotient_chunks: np.ndarray


@dataclass
class Proof:
    active: List[bool]
    commitments: Commitments
    intermediate_accumulators: List[ExtVal]
    log_degrees: List[int]  # per active circuit
    preprocessed_opened: list  # per matrix, per point, per column (ext coords)
    stage1_opened: list
    stage2_opened: list
    quotient_opened: list
    fri_proof: FriProof


class _Reader:
    def __init__(self, data: bytes, field_bytes: int):
        self.data = data
        self.pos = 0
        self.field_bytes = field_bytes

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise VerificationError("InvalidProofShape", "truncated proof bytes")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self._take(1)[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def field(self) -> int:
        return int.from_bytes(self._take(self.field_bytes), "little")

    def fields(self, n: int) -> np.ndarray:
        """n base elements as uint64."""
        return np.frombuffer(self._take(n * self.field_bytes), f"<u{self.field_bytes}").astype(np.uint64)

    def ext(self, D: int) -> Tuple[int, ...]:
        return tuple(self.field() for _ in range(D))

    def digests(self, n: int) -> np.ndarray:
        """n 32-byte digests as an (n, 8) uint32 array."""
        return np.frombuffer(self._take(32 * n), "<u4").astype(np.uint32).reshape(n, 8)

    def cap(self) -> np.ndarray:
        n = self.u64()
        if n > 1 << 20:
            raise VerificationError("InvalidProofShape", "cap too large")
        return self.digests(n)

    def done(self) -> bool:
        return self.pos == len(self.data)



def _guard(n: int, limit: int = 1 << 24) -> int:
    if n > limit:
        raise VerificationError("InvalidProofShape", "length field too large")
    return n



def _read_opened(r: _Reader, D: int):
    out = []
    for _ in range(_guard(r.u64())):
        mat = []
        for _ in range(_guard(r.u64())):
            mat.append([r.ext(D) for _ in range(_guard(r.u64()))])
        out.append(mat)
    return out



def _read_batch_opening(r: _Reader) -> BatchOpening:
    rows = [r.fields(_guard(r.u64())) for _ in range(_guard(r.u64()))]
    return BatchOpening(opened_rows=rows, path=r.digests(_guard(r.u64(), 64)))



def _read_fri_proof(r: _Reader, D: int):
    """The FriProof `_write_fri_proof` writes (PoW witnesses after the
    commits)."""

    commit_caps = [r.cap() for _ in range(_guard(r.u64(), 64))]
    commit_pows = [r.u64() for _ in range(_guard(r.u64(), 64))]
    query_proofs = []
    for _ in range(_guard(r.u64(), 1 << 16)):
        input_openings = [_read_batch_opening(r) for _ in range(_guard(r.u64(), 64))]
        commit_openings = []
        for _ in range(_guard(r.u64(), 64)):
            row = r.fields(_guard(r.u64(), 1 << 16))
            commit_openings.append((row, r.digests(_guard(r.u64(), 64))))
        query_proofs.append(QueryProof(input_openings, commit_openings))
    final_poly = [r.ext(D) for _ in range(_guard(r.u64()))]
    return FriProof(
        commit_caps=commit_caps,
        commit_pow_witnesses=commit_pows,
        final_poly=final_poly,
        query_pow_witness=r.u64(),
        query_proofs=query_proofs,
    )



def proof_from_bytes(data: bytes, D: int) -> Proof:
    """The proof in `data`, over Goldilocks with an extension of degree D."""
    r = _Reader(data, 8)
    active = [bool(r.u8()) for _ in range(_guard(r.u64()))]
    s1, s2, qc = r.cap(), r.cap(), r.cap()
    accs = [r.ext(D) for _ in range(_guard(r.u64()))]
    log_degrees = [r.u8() for _ in range(_guard(r.u64()))]
    fri_proof = _read_fri_proof(r, D)
    q_opened = _read_opened(r, D)
    pre_tag = r.u8()
    if pre_tag not in (0, 1):
        raise VerificationError("InvalidProofShape", "bad Option tag")
    pre_opened = _read_opened(r, D) if pre_tag else []
    s1_opened = _read_opened(r, D)
    s2_opened = _read_opened(r, D)
    if not r.done():
        raise VerificationError("InvalidProofShape", "trailing bytes")
    return Proof(
        active=active,
        commitments=Commitments(s1, s2, qc),
        intermediate_accumulators=accs,
        log_degrees=log_degrees,
        preprocessed_opened=pre_opened,
        stage1_opened=s1_opened,
        stage2_opened=s2_opened,
        quotient_opened=q_opened,
        fri_proof=fri_proof,
    )
