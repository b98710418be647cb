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
written as 8 u32 LE words like a BLAKE3 digest.  The verifier, and with it
the proof reader, is not ported yet.
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

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


def _write_opened(w: _Writer, opened):
    w.u64(len(opened))
    for mat in opened:
        w.u64(len(mat))
        for pt in mat:
            w.u64(len(pt))
            for v in pt:
                w.ext(v)


def _write_batch_opening(w: _Writer, op: BatchOpening):
    w.u64(len(op.opened_rows))
    for row in op.opened_rows:
        w.u64(len(row))
        for v in np.asarray(row, np.uint64):
            w.field(int(v))
    w.u64(op.path.shape[0])
    for d in op.path:
        w.digest(d)


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
