"""The slice end to end: the port's `prove_multiple_claims` on CPU tensors
gives the JAX package's proof bytes, bit for bit, and the JAX verifier
accepts them -- u32_add (with claims) at several sizes, a cap_height=1 case,
and the README's no-lookup Pythagorean AIR."""

import numpy as np
import pytest

import multistark_tpu_torch as mt
from multistark_tpu.air import Air as JaxAir, LookupAir as JaxLookupAir
from multistark_tpu.config import CommitmentParameters as JaxCommit, FriParameters as JaxFri
from multistark_tpu.configs import GoldilocksBlake3Config as JaxConfig
from multistark_tpu.prover import Proof as JaxProof, prove_multiple_claims as jax_prove
from multistark_tpu.system import System as JaxSystem, SystemWitness as JaxWitness
from multistark_tpu.test_circuits import u32_add_system_inputs as jax_u32_inputs, u32_add_witness
from multistark_tpu.verifier import verify_multiple_claims as jax_verify
from multistark_tpu_torch.air import Air as TorchAir, LookupAir as TorchLookupAir
from multistark_tpu_torch.config import CommitmentParameters, FriParameters
from multistark_tpu_torch.configs import GoldilocksBlake3Config
from multistark_tpu_torch.prover import prove_multiple_claims
from multistark_tpu_torch.system import System, SystemWitness
from multistark_tpu_torch.test_circuits import u32_add_system_inputs

BENCH_FRI = dict(
    log_final_poly_len=0, max_log_arity=1, num_queries=100,
    commit_proof_of_work_bits=10, query_proof_of_work_bits=10,
)


def _prove_both(jax_inputs, torch_inputs, traces, claims, cap_height, fri):
    jcfg = JaxConfig(JaxCommit(log_blowup=2, cap_height=cap_height), JaxFri(**fri))
    jsys, jkey = JaxSystem.new(jcfg, jax_inputs)
    jproof = jax_prove(jsys, jkey, JaxWitness.from_stage_1(traces, jsys, jkey), claims)
    tcfg = GoldilocksBlake3Config(
        CommitmentParameters(log_blowup=2, cap_height=cap_height), FriParameters(**fri), device="cpu"
    )
    tsys, tkey = System.new(tcfg, torch_inputs)
    ttraces, tclaims = mt.witness_from_numpy(traces, claims, tcfg.device)
    tproof = prove_multiple_claims(tsys, tkey, SystemWitness.from_stage_1(ttraces, tsys, tkey), tclaims)
    return jcfg, jsys, jproof.to_bytes(jcfg), tproof.to_bytes()


def _u32_case(log_n, n_pairs, seed):
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, 1 << 32, n_pairs, dtype=np.uint64)
    ys = rng.integers(0, 1 << 32, n_pairs, dtype=np.uint64)
    return u32_add_witness(list(zip(xs.tolist(), ys.tolist())), 1 << log_n)


@pytest.mark.parametrize(
    "log_n, n_pairs, cap_height",
    [(4, 16, 0), (6, 40, 0), (8, 256, 0), (6, 64, 1)],
)
def test_u32_add_proof_bytes_match_jax_and_verify(log_n, n_pairs, cap_height):
    traces, claims = _u32_case(log_n, n_pairs, 1000 + log_n)
    jcfg, jsys, want, got = _prove_both(
        jax_u32_inputs(), u32_add_system_inputs(), traces, claims, cap_height, BENCH_FRI
    )
    assert got == want
    jax_verify(jsys, claims, JaxProof.from_bytes(got, jsys))


class _JaxPythagorean(JaxAir):
    width = 3

    def eval(self, b):
        a, bb, c = b.main().row(0)
        b.assert_eq(a * a + bb * bb, c * c)


class _TorchPythagorean(TorchAir):
    width = 3

    def eval(self, b):
        a, bb, c = b.main().row(0)
        b.assert_eq(a * a + bb * bb, c * c)


def test_pythagorean_air_proof_bytes_match_jax_and_verify():
    """The README's quick start: one circuit, no lookups, standard_fast FRI."""
    trace = np.asarray([(3, 4, 5), (6, 8, 10), (5, 12, 13), (8, 15, 17)], np.uint64)
    fri = vars(JaxFri.standard_fast())
    jcfg, jsys, want, got = _prove_both(
        [JaxLookupAir(_JaxPythagorean(), []).to_circuit_inputs()],
        [TorchLookupAir(_TorchPythagorean(), []).to_circuit_inputs()],
        [trace], [], 0, fri,
    )
    assert got == want
    jax_verify(jsys, [], JaxProof.from_bytes(got, jsys))


def test_tampered_port_proof_is_rejected():
    """The JAX verifier's acceptance above means something: one flipped
    byte of the port's proof is rejected."""
    from multistark_tpu.errors import VerificationError

    traces, claims = _u32_case(4, 16, 7)
    _, jsys, _, got = _prove_both(jax_u32_inputs(), u32_add_system_inputs(), traces, claims, 0, BENCH_FRI)
    bad = bytearray(got)
    bad[len(bad) // 2] ^= 1
    with pytest.raises(VerificationError):
        jax_verify(jsys, claims, JaxProof.from_bytes(bytes(bad), jsys))
