"""The committed cross-implementation vectors (fixtures/reference_vectors.json)
reproduced by the port's generator, multistark_tpu_torch/fixtures.py: its
challengers, BLAKE3, Poseidon2, Merkle tree, NTT constants, Fiat-Shamir
schedule and proof serialization give every section of the file, on the
inputs of multistark_tpu/fixtures.py (which generates the file from the JAX
package; tests/test_fixtures.py holds that side), the tensors on the CPU.
The outputs come from port code only.  Tolerance: exact, the FRI schedule
compared less the grinds' clone draws (fixtures.without_clone_checks)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from multistark_tpu_torch import fixtures
from multistark_tpu_torch.merkle import Blake3FieldHasher, MerkleMmcs, Poseidon2FieldHasher, mmcs_verify_batch_queries
from multistark_tpu_torch.hash import poseidon2_host as p2
from multistark_tpu_torch.prover import Proof

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def committed():
    with open(os.path.join(ROOT, "fixtures", "reference_vectors.json")) as f:
        return json.load(f)


def _less_clone_draws(fri_transcript: dict) -> dict:
    return dict(fri_transcript, schedule=fixtures.without_clone_checks(fri_transcript["schedule"]))


def test_challenger(committed):
    assert fixtures.challenger_vectors() == committed["challenger"]
    assert fixtures.serializing_sample_bits_vectors() == committed["serializing_sample_bits"]


def test_duplex_challenger(committed):
    got = fixtures.duplex_challenger_vectors()
    assert got == committed["duplex_challenger"]


def test_blake3(committed):
    assert fixtures.blake3_vectors() == committed["blake3"]
    # the leaf hash of eight u64 values through the verifier's row hash
    leaf = Blake3FieldHasher().host_hash_rows([list(range(8))])
    assert leaf.astype("<u4").tobytes().hex() == committed["blake3"]["leaf_8_u64"]


def test_merkle(committed):
    """A two-height tree's cap and the opening of leaf 5 (device commit and
    gathers on CPU tensors), which both verifier walks accept."""
    got = fixtures.merkle_vectors(device="cpu")
    assert got == committed["merkle"]
    from multistark_tpu_torch.merkle import BatchOpening

    mmcs = MerkleMmcs(Blake3FieldHasher())
    cap = np.asarray([got["root"]], np.uint32)
    op = BatchOpening([np.asarray(r, np.uint64) for r in got["open_5_rows"]], np.asarray(got["open_5_path"], np.uint32))
    dims = [(2, 8), (2, 4)]
    assert mmcs.verify_batch(cap, dims, 5, op)
    assert mmcs_verify_batch_queries(mmcs, cap, dims, [5], [op])


def test_poseidon2(committed):
    want = committed["poseidon2"]
    assert fixtures.poseidon2_vectors() == want
    # the host C helper: the permutation, and the verifier's row hash and compression
    assert p2.native_permute(list(range(16))) == want["permute_0_15"]
    hasher = Poseidon2FieldHasher()
    assert hasher.host_hash_rows([list(range(4)), list(range(4, 10))]).tolist() == want["hash_10"]
    assert hasher.host_compress(np.arange(8), np.arange(8, 16)).tolist() == want["compress"]


def test_ntt(committed):
    assert fixtures.ntt_vectors() == committed["ntt"]


def test_fri_transcript_and_serialization(committed):
    """Every draw of the host challenger during the tiny prove, in order (both
    schedules less the grinds' clone draws: 42 of the JAX package's 52
    remain), the proof's accumulators and final polynomial, and its bytes
    (length, sha256, header), read back by Proof.from_bytes and accepted."""
    got = fixtures.fri_transcript_vectors(device="cpu")
    assert len(got["schedule"]) == 42 and len(committed["fri_transcript"]["schedule"]) == 52
    assert _less_clone_draws(got) == _less_clone_draws(committed["fri_transcript"])
    assert fixtures.serialization_vectors(device="cpu") == committed["serialization"]
    config, system, key, witness, proof, schedule = fixtures._tiny_proof("cpu")
    data = proof.to_bytes()
    system.verify(Proof.from_bytes(data, system))


def test_generator_main_reproduces_the_committed_file(committed):
    """`python -m multistark_tpu_torch.fixtures --device cpu` prints every
    section of the committed file (the schedule less its clone draws)."""
    out = subprocess.run([sys.executable, "-m", "multistark_tpu_torch.fixtures", "--device", "cpu"], cwd=ROOT,
                         check=True, capture_output=True, text=True, timeout=300).stdout
    got = json.loads(out)
    assert list(got) == list(committed)
    assert dict(got, fri_transcript=_less_clone_draws(got["fri_transcript"])) == \
        dict(committed, fri_transcript=_less_clone_draws(committed["fri_transcript"]))
