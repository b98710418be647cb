"""The port proves the workload circuits with the JAX package's bytes, on
CPU tensors: each proof's sha256 and length equal the entry the JAX package
made for it (fixtures/torch_port_golden_workloads.json, written by
scripts/torch_port_golden.py --workload; no JAX prove runs here), the JAX
verifier accepts it, and both verifiers reject a tampered claim.  Systems:
the 10-circuit BLAKE3 family at 4-bit limbs on the 2-block message of
tests/test_blake3_circuit.py::TestBlake3E2E (both GoldilocksBlake3
transcripts; no fallback, the claims are all 45 wide), byte_operations at
4 bits on tests/test_byte_operations.py's ragged claims (the device
transcript falls back once, as the JAX one does), and the limb-xor +
U32Xor subfamily of tests/test_blake3_subfamily.py.  Each proof is made
once per module and every check is a case of its own."""

import hashlib
import json
import os
import sys

import numpy as np
import pytest

import multistark_tpu_torch as mt
from multistark_tpu.config import CommitmentParameters as JaxCommit, FriParameters as JaxFri
from multistark_tpu.configs import GoldilocksBlake3Config as JaxConfig
from multistark_tpu.errors import VerificationError as JaxVerificationError
from multistark_tpu.prover import Proof as JaxProof
from multistark_tpu.system import System as JaxSystem
from multistark_tpu.test_circuits import blake3_circuit as jax_b3c, byte_operations as jax_bo
from multistark_tpu.verifier import verify_multiple_claims as jax_verify
from multistark_tpu_torch import device_transcript as dt
from multistark_tpu_torch.config import CommitmentParameters, FriParameters
from multistark_tpu_torch.configs import GoldilocksBlake3Config
from multistark_tpu_torch.errors import VerificationError
from multistark_tpu_torch.prover import prove_host_transcript, prove_multiple_claims
from multistark_tpu_torch.system import System, SystemWitness
from multistark_tpu_torch.test_circuits import blake3_circuit as b3c, byte_operations as bo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch_port_golden as golden  # noqa: E402

# (golden entry, prover entry point, the device transcript's fallbacks, the
# claim value to tamper: BLAKE3 a digest word of the root compression)
CASES = [
    ("blake3 2 blocks 4 bits", "prove_multiple_claims", {}, (-1, -9)),
    ("blake3 2 blocks 4 bits", "prove_host_transcript", {}, (-1, -9)),
    ("byte_operations 4 bits ragged", "prove_multiple_claims", {"ragged claims": 1}, (0, 3)),
    ("limb xor + U32Xor 4 bits", "prove_multiple_claims", {}, (0, 3)),
]
IDS = [f"{name}-{entry}" for name, entry, _, _ in CASES]
PROVERS = {"prove_multiple_claims": prove_multiple_claims, "prove_host_transcript": prove_host_transcript}


def workload(name):
    """(port system, key, witness, claims as the port takes them, JAX
    system, claims as lists) of a golden workload entry."""
    fri = golden.WORKLOADS[name][2]
    config = GoldilocksBlake3Config(CommitmentParameters(**golden.BENCH_COMMIT), FriParameters(**fri), device="cpu")
    system, key = System.new(config, golden.workload_inputs(name, b3c, bo))
    traces, claims = golden.workload_witness(name, b3c, bo)
    ttraces, tclaims = mt.witness_from_numpy(traces, claims, "cpu")
    witness = SystemWitness.from_stage_1(ttraces, system, key)
    jconfig = JaxConfig(JaxCommit(**golden.BENCH_COMMIT), JaxFri(**fri))
    jsys, _ = JaxSystem.new(jconfig, golden.workload_inputs(name, jax_b3c, jax_bo))
    return system, key, witness, tclaims, jsys, [[int(v) for v in c] for c in claims]


@pytest.fixture(scope="module")
def entries():
    with open(golden.WORKLOADS_PATH) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def proved():
    """prove(case) -> (its workload, its proof, the fallbacks the prove
    counted); each workload is built and each case proved once."""
    systems, proofs = {}, {}

    def prove(case):
        name, entry, _, _ = case
        if name not in systems:
            systems[name] = workload(name)
        if (name, entry) not in proofs:
            system, key, witness, claims = systems[name][:4]
            dt.FALLBACKS.clear()
            proof = PROVERS[entry](system, key, witness, claims)
            proofs[name, entry] = (proof, dict(dt.FALLBACKS))
        return (systems[name], *proofs[name, entry])

    return prove


def tampered(jclaims, at):
    bad = [list(c) for c in jclaims]
    bad[at[0]][at[1]] ^= 1
    return bad


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_proof_bytes_are_the_golden_entry(proved, entries, case):
    """The JAX bytes, and the fallbacks the JAX device transcript takes:
    none for claims of one width, one "ragged claims" (JAX dt_prover.py:99)
    for the byte_operations claims beside a RANGE claim of three values."""
    (_, _, _, claims, _, _), proof, fallbacks = proved(case)
    if case[0].startswith("blake3"):
        assert claims.shape == (2, 45)
    data = proof.to_bytes()
    assert {"sha256": hashlib.sha256(data).hexdigest(), "n_bytes": len(data)} == entries[case[0]]
    assert fallbacks == (case[2] if case[1] == "prove_multiple_claims" else {})


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_port_verifier_accepts(proved, case):
    (system, _, _, claims, _, _), proof, _ = proved(case)
    system.verify_multiple_claims(claims, proof)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_jax_verifier_accepts(proved, case):
    (_, _, _, _, jsys, jclaims), proof, _ = proved(case)
    jax_verify(jsys, jclaims, JaxProof.from_bytes(proof.to_bytes(), jsys))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_port_verifier_rejects_a_tampered_claim(proved, case):
    (system, _, _, _, _, jclaims), proof, _ = proved(case)
    with pytest.raises(VerificationError):
        system.verify_multiple_claims([np.asarray(c, np.uint64) for c in tampered(jclaims, case[3])], proof)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_jax_verifier_rejects_a_tampered_claim(proved, case):
    (_, _, _, _, jsys, jclaims), proof, _ = proved(case)
    with pytest.raises(JaxVerificationError):
        jax_verify(jsys, tampered(jclaims, case[3]), JaxProof.from_bytes(proof.to_bytes(), jsys))
