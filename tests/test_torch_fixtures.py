"""The committed cross-implementation vectors (fixtures/reference_vectors.json)
reproduced by the port: its challengers, BLAKE3, Poseidon2, Merkle tree,
NTT constants, Fiat-Shamir schedule and proof serialization give every
section of the file, on the inputs of multistark_tpu/fixtures.py (which
generates the file from the JAX package; tests/test_fixtures.py holds that
side).  The outputs here come from port code only.  Tolerance: exact."""

import hashlib
import json
import os

import numpy as np
import pytest

from multistark_tpu_torch import expr as ex
from multistark_tpu_torch.challenger import DuplexChallenger, SerializingChallenger64
from multistark_tpu_torch.config import CommitmentParameters, FriParameters
from multistark_tpu_torch.configs import GoldilocksBlake3Config
from multistark_tpu_torch.fields.device import GL_OPS
from multistark_tpu_torch.fields.host import BABYBEAR, BABYBEAR_EXT4, GOLDILOCKS, GOLDILOCKS_EXT2
from multistark_tpu_torch.fields.npref import np_powers
from multistark_tpu_torch.hash import poseidon2_host as p2
from multistark_tpu_torch.hash.blake3_host import blake3_hash
from multistark_tpu_torch.merkle import Blake3FieldHasher, MerkleMmcs, Poseidon2FieldHasher
from multistark_tpu_torch.prover import Proof
from multistark_tpu_torch.system import CircuitInputs, System, SystemWitness

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def committed():
    with open(os.path.join(ROOT, "fixtures", "reference_vectors.json")) as f:
        return json.load(f)


def test_challenger(committed):
    ch = SerializingChallenger64(GOLDILOCKS, GOLDILOCKS_EXT2)
    ch.observe_bytes(b"multi-stark/v0")
    for v in (1, 0, 0, 1, 100, 10, 10):
        ch.observe_u64(v)
    got = {"after_params_sample": ch.sample_field(), "sample_ext": list(ch.sample_ext()),
           "sample_bits_20": ch.sample_bits(20)}
    ch.observe_field(123456789)
    got["after_observe_field"] = ch.sample_field()
    got["grind_8_witness"] = ch.grind(8)
    assert got == committed["challenger"]
    got = {}
    for bits in (1, 8, 20, 31):
        ch = SerializingChallenger64(GOLDILOCKS, GOLDILOCKS_EXT2)
        ch.observe_bytes(b"sample-bits-pin")
        got[f"bits_{bits}"] = ch.sample_bits(bits)
    assert got == committed["serializing_sample_bits"]


def test_duplex_challenger(committed):
    ch = DuplexChallenger(BABYBEAR, BABYBEAR_EXT4)
    ch.observe_bytes(b"multi-stark/v0")
    for v in (2, 1, 4, 4):
        ch.observe_field(v)
    got = {"sample_field": ch.sample_field(), "sample_ext": list(ch.sample_ext()), "sample_bits_20": ch.sample_bits(20),
           "sample_bits_1": ch.sample_bits(1), "grind_4_witness": ch.grind(4)}
    assert got == committed["duplex_challenger"]


def test_blake3(committed):
    words = np.frombuffer(bytes(range(64)), "<u4")
    pair = Blake3FieldHasher().host_compress(words[:8], words[8:])
    got = {
        "empty": blake3_hash(b"").hex(),
        "leaf_8_u64": blake3_hash(b"".join(i.to_bytes(8, "little") for i in range(8))).hex(),
        "leaf_2048_bytes": blake3_hash(bytes(i % 251 for i in range(2048))).hex(),
        "compress_pair": pair.astype("<u4").tobytes().hex(),
    }
    assert got == committed["blake3"]
    # the leaf hash of eight u64 values through the verifier's row hash
    leaf = Blake3FieldHasher().host_hash_rows([list(range(8))])
    assert leaf.astype("<u4").tobytes().hex() == committed["blake3"]["leaf_8_u64"]


def test_merkle(committed):
    """A two-height tree's cap and the opening of leaf 5 (device commit and
    gathers on CPU tensors), which both verifier walks accept."""
    mmcs = MerkleMmcs(Blake3FieldHasher())
    m1 = np.arange(16, dtype=np.uint64).reshape(2, 8)
    m2 = (np.arange(8, dtype=np.uint64) * 1000 + 7).reshape(2, 4)
    cap, data = mmcs.commit([GL_OPS.from_np(m1, "cpu"), GL_OPS.from_np(m2, "cpu")])
    (op,) = mmcs.open_batch(data, np.array([5]))
    got = {"root": cap[0].tolist(), "open_5_rows": [r.tolist() for r in op.opened_rows],
           "open_5_path": op.path.tolist()}
    assert got == committed["merkle"]
    from multistark_tpu_torch.merkle import mmcs_verify_batch_queries

    dims = [(2, 8), (2, 4)]
    assert mmcs.verify_batch(cap, dims, 5, op)
    assert mmcs_verify_batch_queries(mmcs, cap, dims, [5], [op])


def test_poseidon2(committed):
    want = committed["poseidon2"]
    got = {"permute_0_15": p2.permute(list(range(16))), "hash_10": p2.host_hash_values(list(range(10))),
           "compress": p2.host_compress(list(range(8)), list(range(8, 16)))}
    assert got == want
    # the host C helper: the permutation, and the verifier's row hash and compression
    assert p2.native_permute(list(range(16))) == want["permute_0_15"]
    hasher = Poseidon2FieldHasher()
    assert hasher.host_hash_rows([list(range(4)), list(range(4, 10))]).tolist() == want["hash_10"]
    assert hasher.host_compress(np.arange(8), np.arange(8, 16)).tolist() == want["compress"]


def test_ntt(committed):
    g16 = GOLDILOCKS.two_adic_generator(4)
    got = {"two_adic_generator_16": g16, "two_adic_generator_2^32": GOLDILOCKS.two_adic_generator(32),
           "powers_g16": [int(x) for x in np_powers(GOLDILOCKS, g16, 16)]}
    assert got == committed["ntt"]


def _tiny_prove():
    """multistark_tpu/fixtures.py's tiny prove (the mul circuit at 32 rows,
    blowup 4, 4 queries, arity 2, PoW 1+1), on CPU tensors."""
    config = GoldilocksBlake3Config(CommitmentParameters(log_blowup=2, cap_height=0),
                                    FriParameters(log_final_poly_len=0, max_log_arity=1, num_queries=4,
                                                  commit_proof_of_work_bits=1, query_proof_of_work_bits=1),
                                    device="cpu")
    inputs = CircuitInputs(main_width=3, constraints=[ex.main(0) * ex.main(1) - ex.main(2)], ext_constraints=[],
                           lookups=[])
    system, key = System.new(config, [inputs])
    rng = np.random.default_rng(42)
    a = rng.integers(0, 1 << 31, 32, dtype=np.uint64)
    b = rng.integers(0, 1 << 31, 32, dtype=np.uint64)
    c = (a.astype(object) * b.astype(object)) % config.host_field.p
    trace = np.stack([a, b, np.asarray(c, np.uint64)], axis=1)
    witness = SystemWitness.from_stage_1([trace], system, key)
    return system, system.prove(key, witness)


def _without_clone_checks(schedule):
    """A recorded schedule without the draws a grind makes on a clone of the
    challenger (`grind`: the search, a check on a clone, then the witness
    observed and sampled).  The JAX package's host replay of the device
    transcript grinds every PoW again this way, the port's replay checks the
    device's witnesses once (`check_witness`) and grinds on the host only
    where the device did not, so the two record the same draws with a
    different number of clone checks.  Each clone draw is the (field, bits)
    pair repeated right after it."""
    out, i = [], 0
    while i < len(schedule):
        if schedule[i][0] == "field" and schedule[i + 1 : i + 2] and schedule[i + 1][0].startswith("bits") \
                and schedule[i : i + 2] == schedule[i + 2 : i + 4]:
            i += 2
            continue
        out.append(schedule[i])
        i += 1
    return out


def test_fri_transcript_and_serialization(committed, monkeypatch):
    """Every draw of the host challenger during the tiny prove, in order (both
    schedules less the grinds' clone draws), the proof's
    accumulators and final polynomial, and its bytes (length,
    sha256, header), read back by Proof.from_bytes and accepted."""
    samples = []
    sample_field, sample_bits = SerializingChallenger64.sample_field, SerializingChallenger64.sample_bits

    def rec_field(self):
        v = sample_field(self)
        samples.append(["field", v])
        return v

    def rec_bits(self, bits):
        v = sample_bits(self, bits)
        samples.append([f"bits{bits}", v])
        return v

    monkeypatch.setattr(SerializingChallenger64, "sample_field", rec_field)
    monkeypatch.setattr(SerializingChallenger64, "sample_bits", rec_bits)
    system, proof = _tiny_prove()
    monkeypatch.undo()
    want = dict(committed["fri_transcript"], schedule=_without_clone_checks(committed["fri_transcript"]["schedule"]))
    got = {"schedule": _without_clone_checks(samples),
           "intermediate_accumulators": [list(map(int, a)) for a in proof.intermediate_accumulators],
           "final_poly": [list(map(int, c)) for c in proof.fri_proof.final_poly]}
    assert got == want
    data = proof.to_bytes()
    assert {"len": len(data), "sha256": hashlib.sha256(data).hexdigest(),
            "header_128_hex": data[:128].hex()} == committed["serialization"]
    assert Proof.from_bytes(data, system).to_bytes() == data
    system.verify(Proof.from_bytes(data, system))
