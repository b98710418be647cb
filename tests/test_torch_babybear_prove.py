"""BabyBearPoseidon2 proofs of U32Add + ByteTable (the bench's circuits
and FRI parameters) at 2^4 and 2^6 rows: the port's proof bytes on the CPU
equal the JAX package's, and the JAX verifier accepts them.  One JAX system
and one port system serve both sizes."""

import numpy as np
import pytest

import multistark_tpu_torch as mt
from multistark_tpu.config import CommitmentParameters as JaxCommit, FriParameters as JaxFri
from multistark_tpu.configs import BabyBearPoseidon2Config as JaxConfig
from multistark_tpu.prover import Proof as JaxProof, prove_multiple_claims as jax_prove
from multistark_tpu.system import System as JaxSystem, SystemWitness as JaxWitness
from multistark_tpu.test_circuits import u32_add_system_inputs as jax_u32_inputs, u32_add_witness
from multistark_tpu.verifier import verify_multiple_claims as jax_verify
from multistark_tpu_torch.config import CommitmentParameters, FriParameters
from multistark_tpu_torch.configs import BabyBearPoseidon2Config
from multistark_tpu_torch.prover import prove_multiple_claims
from multistark_tpu_torch.system import System, SystemWitness
from multistark_tpu_torch.test_circuits import u32_add_system_inputs

BENCH_FRI = dict(
    log_final_poly_len=0, max_log_arity=1, num_queries=100,
    commit_proof_of_work_bits=10, query_proof_of_work_bits=10,
)


@pytest.fixture(scope="module")
def systems():
    jcfg = JaxConfig(JaxCommit(log_blowup=2, cap_height=0), JaxFri(**BENCH_FRI))
    tcfg = BabyBearPoseidon2Config(CommitmentParameters(log_blowup=2, cap_height=0), FriParameters(**BENCH_FRI),
                                   device="cpu")
    return (jcfg, *JaxSystem.new(jcfg, jax_u32_inputs())), (*System.new(tcfg, u32_add_system_inputs()),)


@pytest.mark.parametrize("log_n, n_pairs", [(4, 16), (6, 40)])
def test_u32_add_proof_bytes_match_jax_and_verify(systems, log_n, n_pairs):
    rng = np.random.default_rng(2000 + log_n)
    xs = rng.integers(0, 1 << 32, n_pairs, dtype=np.uint64)
    ys = rng.integers(0, 1 << 32, n_pairs, dtype=np.uint64)
    traces, claims = u32_add_witness(list(zip(xs.tolist(), ys.tolist())), 1 << log_n)
    (jcfg, jsys, jkey), (tsys, tkey) = systems
    want = jax_prove(jsys, jkey, JaxWitness.from_stage_1(traces, jsys, jkey), claims).to_bytes(jcfg)
    ttraces, tclaims = mt.witness_from_numpy(traces, claims, "cpu")
    got = prove_multiple_claims(tsys, tkey, SystemWitness.from_stage_1(ttraces, tsys, tkey), tclaims).to_bytes()
    assert got == want
    jax_verify(jsys, claims, JaxProof.from_bytes(got, jsys))
