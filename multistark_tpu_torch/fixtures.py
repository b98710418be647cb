"""Cross-implementation test vectors (the counterpart of
multistark_tpu/fixtures.py): the port's challengers, BLAKE3, Poseidon2,
Merkle tree, NTT constants, Fiat-Shamir schedule and proof serialization on
the inputs that generate fixtures/reference_vectors.json, each from port
code.

    python -m multistark_tpu_torch.fixtures [--device cpu|cuda]

prints `generate()` as JSON (the tensors on `--device`, `cuda` by default).

One section differs from the committed file by design:
`fri_transcript.schedule` lists the draws the port's host challenger makes
during the tiny prove, and the JAX package's host replay of its device
transcript grinds every proof of work again on a clone of the challenger
(the search, a check on the clone, then the witness observed and sampled),
where the port checks the device's witnesses once and grinds on the host
only where the device did not.  So the JAX schedule has one more (field,
bits) clone draw for every such grind: 52 draws against the port's 42 for
the tiny prove, on either transcript.  Less those clone draws
(`without_clone_checks`) the two schedules are equal; every other section
equals the committed file.
"""

from __future__ import annotations

import argparse
import hashlib
import json
from typing import List

import numpy as np


def challenger_vectors() -> dict:
    """Deterministic draws after a fixed observation schedule."""
    from .challenger import SerializingChallenger64
    from .fields.host import GOLDILOCKS, GOLDILOCKS_EXT2

    ch = SerializingChallenger64(GOLDILOCKS, GOLDILOCKS_EXT2)
    ch.observe_bytes(b"multi-stark/v0")
    for v in (1, 0, 0, 1, 100, 10, 10):
        ch.observe_u64(v)
    out = {
        "after_params_sample": ch.sample_field(),
        "sample_ext": list(ch.sample_ext()),
        "sample_bits_20": ch.sample_bits(20),
    }
    ch.observe_field(123456789)
    out["after_observe_field"] = ch.sample_field()
    out["grind_8_witness"] = ch.grind(8)
    return out


def blake3_vectors() -> dict:
    from .hash.blake3_host import blake3_hash
    from .merkle import Blake3FieldHasher

    words = np.frombuffer(bytes(range(64)), "<u4")
    return {
        "empty": blake3_hash(b"").hex(),
        "leaf_8_u64": blake3_hash(b"".join(i.to_bytes(8, "little") for i in range(8))).hex(),
        "leaf_2048_bytes": blake3_hash(bytes(i % 251 for i in range(2048))).hex(),
        "compress_pair": Blake3FieldHasher().host_compress(words[:8], words[8:]).astype("<u4").tobytes().hex(),
    }


def merkle_vectors(device: str = "cuda") -> dict:
    """A two-height tree's cap and the opening of leaf 5, committed from
    tensors on `device`."""
    from .fields.device import GL_OPS
    from .merkle import Blake3FieldHasher, MerkleMmcs

    mmcs = MerkleMmcs(Blake3FieldHasher())
    m1 = np.arange(16, dtype=np.uint64).reshape(2, 8)  # (w=2, n=8)
    m2 = (np.arange(8, dtype=np.uint64) * 1000 + 7).reshape(2, 4)
    cap, data = mmcs.commit([GL_OPS.from_np(m1, device), GL_OPS.from_np(m2, device)])
    (op,) = mmcs.open_batch(data, np.array([5]))
    return {
        "root": np.asarray(cap[0]).tolist(),
        "open_5_rows": [r.tolist() for r in op.opened_rows],
        "open_5_path": op.path.tolist(),
    }


def poseidon2_vectors() -> dict:
    from .hash.poseidon2_host import host_compress, host_hash_values, permute

    return {
        "permute_0_15": permute(list(range(16))),
        "hash_10": host_hash_values(list(range(10))),
        "compress": host_compress(list(range(8)), list(range(8, 16))),
    }


def ntt_vectors() -> dict:
    from .fields.host import GOLDILOCKS
    from .fields.npref import np_powers

    g16 = GOLDILOCKS.two_adic_generator(4)
    return {
        "two_adic_generator_16": g16,
        "two_adic_generator_2^32": GOLDILOCKS.two_adic_generator(32),
        "powers_g16": [int(x) for x in np_powers(GOLDILOCKS, g16, 16)],
    }


def duplex_challenger_vectors() -> dict:
    """The DuplexChallenger (BabyBear, Poseidon2): observe_bytes feeds one
    byte per field element, and sample_bits takes the low `bits` of a
    sampled field element (the JAX package's conventions)."""
    from .challenger import DuplexChallenger
    from .fields.host import BABYBEAR, BABYBEAR_EXT4

    ch = DuplexChallenger(BABYBEAR, BABYBEAR_EXT4)
    ch.observe_bytes(b"multi-stark/v0")
    for v in (2, 1, 4, 4):
        ch.observe_field(v)
    return {
        "sample_field": ch.sample_field(),
        "sample_ext": list(ch.sample_ext()),
        "sample_bits_20": ch.sample_bits(20),
        "sample_bits_1": ch.sample_bits(1),
        "grind_4_witness": ch.grind(4),
    }


def serializing_sample_bits_vectors() -> dict:
    """sample_bits of the production challenger: the low bits of a sampled
    field element, without rejection."""
    from .challenger import SerializingChallenger64
    from .fields.host import GOLDILOCKS, GOLDILOCKS_EXT2

    out = {}
    for bits in (1, 8, 20, 31):
        ch = SerializingChallenger64(GOLDILOCKS, GOLDILOCKS_EXT2)
        ch.observe_bytes(b"sample-bits-pin")
        out[f"bits_{bits}"] = ch.sample_bits(bits)
    return out


_TINY_PROOF_CACHE: dict = {}


def _tiny_proof(device: str = "cuda"):
    """One fixed tiny prove on the production config (the mul circuit at 32
    rows, blowup 4, 4 queries, arity 2, PoW 1+1), made once per device and
    shared by the FRI transcript and serialization vectors.  Returns
    (config, system, key, witness, proof, the host challenger's draws during
    the prove as [kind, value] pairs)."""
    if device in _TINY_PROOF_CACHE:
        return _TINY_PROOF_CACHE[device]
    from . import expr as ex
    from .challenger import SerializingChallenger64
    from .config import CommitmentParameters, FriParameters
    from .configs import GoldilocksBlake3Config
    from .system import CircuitInputs, System, SystemWitness

    config = GoldilocksBlake3Config(
        CommitmentParameters(log_blowup=2, cap_height=0),
        FriParameters(
            log_final_poly_len=0, max_log_arity=1, num_queries=4,
            commit_proof_of_work_bits=1, query_proof_of_work_bits=1,
        ),
        device=device,
    )
    inputs = CircuitInputs(
        main_width=3,
        constraints=[ex.main(0) * ex.main(1) - ex.main(2)],
        ext_constraints=[],
        lookups=[],
    )
    system, key = System.new(config, [inputs])
    p = config.host_field.p
    rng = np.random.default_rng(42)
    a = rng.integers(0, 1 << 31, 32, dtype=np.uint64)
    b = rng.integers(0, 1 << 31, 32, dtype=np.uint64)
    c = (a.astype(object) * b.astype(object)) % p
    trace = np.stack([a, b, np.asarray(c, np.uint64)], axis=1)
    witness = SystemWitness.from_stage_1([trace], system, key)

    samples: List[list] = []
    orig_field, orig_bits = SerializingChallenger64.sample_field, SerializingChallenger64.sample_bits

    def rec_field(self):
        v = orig_field(self)
        samples.append(["field", int(v)])
        return v

    def rec_bits(self, bits):
        v = orig_bits(self, bits)
        samples.append([f"bits{bits}", int(v)])
        return v

    SerializingChallenger64.sample_field = rec_field
    SerializingChallenger64.sample_bits = rec_bits
    try:
        proof = system.prove(key, witness)
    finally:
        SerializingChallenger64.sample_field = orig_field
        SerializingChallenger64.sample_bits = orig_bits
    _TINY_PROOF_CACHE[device] = (config, system, key, witness, proof, samples)
    return _TINY_PROOF_CACHE[device]


def without_clone_checks(schedule: List[list]) -> List[list]:
    """A recorded schedule without the draws a grind makes on a clone of the
    challenger: each clone draw is a (field, bits) pair repeated right
    after it (module docstring)."""
    out, i = [], 0
    while i < len(schedule):
        if schedule[i][0] == "field" and schedule[i + 1 : i + 2] and schedule[i + 1][0].startswith("bits") \
                and schedule[i : i + 2] == schedule[i + 2 : i + 4]:
            i += 2
            continue
        out.append(schedule[i])
        i += 1
    return out


def fri_transcript_vectors(device: str = "cuda") -> dict:
    """Every Fiat-Shamir draw of the port's host challenger during the tiny
    prove, in order, with the proof's accumulators and final polynomial.
    The schedule is the port's own: the JAX package's has ten more clone
    draws (module docstring; compare both through `without_clone_checks`)."""
    config, system, key, witness, proof, samples = _tiny_proof(device)
    return {
        "schedule": [list(s) for s in samples],
        "intermediate_accumulators": [list(map(int, a)) for a in proof.intermediate_accumulators],
        "final_poly": [list(map(int, c)) for c in proof.fri_proof.final_poly],
    }


def serialization_vectors(device: str = "cuda") -> dict:
    """The tiny proof's bytes: total length, sha256 and the first 128 bytes;
    Proof.from_bytes must read them back to the same bytes."""
    from .prover import Proof

    config, system, key, witness, proof, samples = _tiny_proof(device)
    data = proof.to_bytes()
    if Proof.from_bytes(data, system).to_bytes() != data:
        raise AssertionError("Proof.from_bytes(data).to_bytes() != data")
    return {
        "len": len(data),
        "sha256": hashlib.sha256(data).hexdigest(),
        "header_128_hex": data[:128].hex(),
    }


def generate(device: str = "cuda") -> dict:
    return {
        "challenger": challenger_vectors(),
        "serializing_sample_bits": serializing_sample_bits_vectors(),
        "duplex_challenger": duplex_challenger_vectors(),
        "blake3": blake3_vectors(),
        "merkle": merkle_vectors(device),
        "poseidon2": poseidon2_vectors(),
        "ntt": ntt_vectors(),
        "fri_transcript": fri_transcript_vectors(device),
        "serialization": serialization_vectors(device),
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help="the tensors' device: cuda (default) or cpu")
    args = parser.parse_args(argv)
    print(json.dumps(generate(args.device), indent=2, default=int))


if __name__ == "__main__":
    main()
