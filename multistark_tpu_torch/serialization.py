"""Proof serialization — bincode-compatible layout (reference
src/prover.rs:202-243: `standard().with_little_endian().with_fixed_int_encoding()`).

Field-by-field layout, mirroring the Rust `Proof` struct's declaration order
(bincode fixint encodes struct fields in order, `Vec<T>` as u64-LE length +
elements, `Option<T>` as one tag byte (0|1) + value, `bool`/`u8` as one
byte, fixed-size arrays with no length prefix):

  Proof (prover.rs:215-238):
    active                     Vec<bool>            u64 len + 1 byte each
    commitments                Commitments<Com>     3 caps in declaration
                               (prover.rs:203-210)  order: stage_1_trace,
                                                    stage_2_trace,
                                                    quotient_chunks
    intermediate_accumulators  Vec<Challenge>       u64 len + D field elems
                                                    each (BinomialExtension-
                                                    Field serializes as the
                                                    fixed [F; D] array)
    log_degrees                Vec<u8>              u64 len + raw bytes
    opening_proof              PcsProof<SC>         FRI proof (below)
    quotient_opened_values     OpenedValuesForRound Vec<Vec<Vec<Challenge>>>
    preprocessed_opened_values Option<...>          1 tag byte + value
    stage_1_opened_values      OpenedValuesForRound
    stage_2_opened_values      OpenedValuesForRound

  Com (Merkle cap): u64 count + 32-byte digests (Vec<Hash>; the digest
  itself is a fixed [u8; 32] / [F; 8] with no inner prefix).

  FRI proof (p3-fri FriProof declaration order):
    commit_phase_commits   Vec<Com>
    commit_pow_witnesses   Vec<u64>   (argumentcomputer commit-phase PoW
                                      extension, directly after the commits:
                                      config.TranscriptProfile.
                                      commit_pow_witness_placement)
    query_proofs           Vec<QueryProof>
    final_poly             Vec<Challenge>
    pow_witness            u64

  QueryProof:
    input_proof            Vec<BatchOpening>
      BatchOpening:
        opened_values      Vec<Vec<F>>     (per matrix: u64 len + values)
        opening_proof      Vec<[u8; 32]>   (path: u64 len + raw digests)
    commit_phase_openings  Vec<CommitPhaseProofStep>
      CommitPhaseProofStep:
        opened_row         Vec<F>          (flattened ext values)
        opening_proof      Vec<[u8; 32]>

Base field elements are u64 LE for 64-bit fields (Goldilocks) and u32 LE
for 31-bit fields (BabyBear), p3's serde of the canonical value
(`Proof.field_bytes`).  A Poseidon2 digest is 8 canonical field elements,
written as 8 u32 LE words like a BLAKE3 digest.

The reader (`proof_from_bytes`) is defensive: every length is bounds-checked,
and truncated input, trailing bytes, a bad Option tag or an oversized count
raise VerificationError("InvalidProofShape"); the counts are cross-checked
against the system by the verifier's `verify_shape` afterwards.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

from .errors import VerificationError
from .merkle import BatchOpening


class _Writer:
    def __init__(self, field_bytes: int):
        self.parts: List[bytes] = []
        self.field_bytes = field_bytes

    def u8(self, v: int):
        self.parts.append(struct.pack("<B", v))

    def u64(self, v: int):
        self.parts.append(struct.pack("<Q", v))

    def field(self, v: int):
        self.parts.append(int(v).to_bytes(self.field_bytes, "little"))

    def ext(self, v):
        for c in v:
            self.field(c)

    def digest(self, row: np.ndarray):
        self.parts.append(np.asarray(row, "<u4").tobytes())

    def cap(self, cap: np.ndarray):
        cap = np.atleast_2d(cap)
        self.u64(cap.shape[0])
        for row in cap:
            self.digest(row)

    def bytes(self) -> bytes:
        return b"".join(self.parts)


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


def _write_opened(w: _Writer, opened):
    w.u64(len(opened))
    for mat in opened:
        w.u64(len(mat))
        for pt in mat:
            w.u64(len(pt))
            for v in pt:
                w.ext(v)


def _read_opened(r: _Reader, D: int):
    out = []
    for _ in range(_guard(r.u64())):
        mat = []
        for _ in range(_guard(r.u64())):
            mat.append([r.ext(D) for _ in range(_guard(r.u64()))])
        out.append(mat)
    return out


def _write_batch_opening(w: _Writer, op: BatchOpening):
    w.u64(len(op.opened_rows))
    for row in op.opened_rows:
        w.u64(len(row))
        for v in np.asarray(row, np.uint64):
            w.field(int(v))
    w.u64(op.path.shape[0])
    for d in op.path:
        w.digest(d)


def _read_batch_opening(r: _Reader) -> BatchOpening:
    rows = [r.fields(_guard(r.u64())) for _ in range(_guard(r.u64()))]
    return BatchOpening(opened_rows=rows, path=r.digests(_guard(r.u64(), 64)))


def _write_fri_proof(w: _Writer, fp):
    """FRI proof in p3-fri's FriProof field order, with the commit-phase PoW
    witnesses directly after the commits (see module doc)."""
    w.u64(len(fp.commit_caps))
    for cap in fp.commit_caps:
        w.cap(cap)
    w.u64(len(fp.commit_pow_witnesses))
    for pw in fp.commit_pow_witnesses:
        w.u64(pw)
    w.u64(len(fp.query_proofs))
    for qp in fp.query_proofs:
        w.u64(len(qp.input_openings))
        for op in qp.input_openings:
            _write_batch_opening(w, op)
        w.u64(len(qp.commit_openings))
        for row, path in qp.commit_openings:
            w.u64(len(row))
            for v in np.asarray(row, np.uint64):
                w.field(int(v))
            w.u64(path.shape[0])
            for d in path:
                w.digest(d)
    w.u64(len(fp.final_poly))
    for c in fp.final_poly:
        w.ext(c)
    w.u64(fp.query_pow_witness)


def proof_to_bytes(proof) -> bytes:
    """Serialize in the Rust Proof struct's bincode field order
    (prover.rs:215-238; see module doc)."""
    w = _Writer(proof.field_bytes)
    w.u64(len(proof.active))
    for b in proof.active:
        w.u8(1 if b else 0)
    w.cap(proof.commitments.stage_1_trace)
    w.cap(proof.commitments.stage_2_trace)
    w.cap(proof.commitments.quotient_chunks)
    w.u64(len(proof.intermediate_accumulators))
    for a in proof.intermediate_accumulators:
        w.ext(a)
    w.u64(len(proof.log_degrees))
    for ld in proof.log_degrees:
        w.u8(ld)
    _write_fri_proof(w, proof.fri_proof)
    _write_opened(w, proof.quotient_opened)
    # preprocessed is Option<OpenedValuesForRound> in the Rust struct
    if proof.preprocessed_opened:
        w.u8(1)
        _write_opened(w, proof.preprocessed_opened)
    else:
        w.u8(0)
    _write_opened(w, proof.stage1_opened)
    _write_opened(w, proof.stage2_opened)
    return w.bytes()


def _read_fri_proof(r: _Reader, D: int):
    """The FriProof `_write_fri_proof` writes (PoW witnesses after the
    commits)."""
    from .pcs import FriProof, QueryProof

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


def proof_from_bytes(data: bytes, system):
    """The Proof `proof_to_bytes` wrote, read for `system`'s config: its
    field's element width (8 bytes Goldilocks, 4 BabyBear) and extension
    degree."""
    from .prover import Commitments, Proof

    config = system.config
    field_bytes = 8 if config.host_field.p.bit_length() > 32 else 4
    D = config.extension_params.degree
    r = _Reader(data, field_bytes)
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
        field_bytes=field_bytes,
    )
