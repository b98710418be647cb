"""fixtures/torch_port_golden.json holds the JAX package's proof digests for
the bench workload; chip_smoke.py holds the port's proofs on the GPU against
it.  Here both packages reproduce the log_n=10 entry on the CPU, which keeps
the fixture and the port honest without a GPU."""

import hashlib
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch_port_golden as golden  # noqa: E402

LOG_N = 10


@pytest.fixture(scope="module")
def entry():
    with open(golden.GOLDEN_PATH) as f:
        return json.load(f)["goldilocks_blake3"][str(LOG_N)]


def test_jax_package_reproduces_the_golden_entry(entry):
    assert golden.digest_entry(golden.jax_proof_bytes(LOG_N)) == entry


def test_port_reproduces_the_golden_entry(entry):
    import multistark_tpu_torch as mt
    from multistark_tpu_torch.config import CommitmentParameters, FriParameters
    from multistark_tpu_torch.configs import GoldilocksBlake3Config
    from multistark_tpu_torch.prover import prove_multiple_claims
    from multistark_tpu_torch.system import System, SystemWitness
    from multistark_tpu_torch.test_circuits import u32_add_system_inputs, u32_add_witness

    config = GoldilocksBlake3Config(
        CommitmentParameters(**golden.BENCH_COMMIT), FriParameters(**golden.BENCH_FRI), device="cpu"
    )
    system, key = System.new(config, u32_add_system_inputs())
    traces, claims = mt.witness_from_numpy(
        *u32_add_witness(golden.bench_witness(LOG_N), 1 << LOG_N), config.device
    )
    proof = prove_multiple_claims(system, key, SystemWitness.from_stage_1(traces, system, key), claims)
    data = proof.to_bytes()
    assert {"sha256": hashlib.sha256(data).hexdigest(), "n_bytes": len(data)} == entry
