"""State carried across from the JAX package: both systems built from the
same AIR definitions agree on the compiled constraint graphs, the
preprocessed commitment, the transcript shape bytes, the witness lookup
values, and the stage-2 traces with their intermediate accumulators."""

import numpy as np
import pytest
import torch

import multistark_tpu_torch as mt
from multistark_tpu import lookup as jax_lk
from multistark_tpu.config import CommitmentParameters as JaxCommit, FriParameters as JaxFri
from multistark_tpu.configs import GoldilocksBlake3Config as JaxConfig
from multistark_tpu.fields.device import GL2_OPS, GL_OPS
from multistark_tpu.fields.host import GOLDILOCKS, GOLDILOCKS_EXT2
from multistark_tpu.system import System as JaxSystem, SystemWitness as JaxWitness
from multistark_tpu.test_circuits import u32_add_system_inputs as jax_u32_inputs, u32_add_witness
from multistark_tpu_torch import lookup as lk
from multistark_tpu_torch.config import CommitmentParameters, FriParameters
from multistark_tpu_torch.configs import GoldilocksBlake3Config
from multistark_tpu_torch.fields import device as fd
from multistark_tpu_torch.fields.device import GL2_OPS as TGL2
from multistark_tpu_torch.system import System, SystemWitness
from multistark_tpu_torch.test_circuits import u32_add_system_inputs
from multistark_tpu_torch.utils import fetch

LOG_N = 5


@pytest.fixture(scope="module")
def both():
    fri = FriParameters.standard_fast()
    jcfg = JaxConfig(JaxCommit(log_blowup=2, cap_height=1), JaxFri(**vars(fri)))
    tcfg = GoldilocksBlake3Config(CommitmentParameters(log_blowup=2, cap_height=1), fri, device="cpu")
    jsys, jkey = JaxSystem.new(jcfg, jax_u32_inputs())
    tsys, tkey = System.new(tcfg, u32_add_system_inputs())
    rng = np.random.default_rng(11)
    pairs = list(zip(*(rng.integers(0, 1 << 32, 20, dtype=np.uint64).tolist() for _ in range(2))))
    traces, claims = u32_add_witness(pairs, 1 << LOG_N)
    jwit = JaxWitness.from_stage_1(traces, jsys, jkey)
    ttraces, _ = mt.witness_from_numpy(traces, claims, tcfg.device)
    twit = SystemWitness.from_stage_1(ttraces, tsys, tkey)
    return (jcfg, jsys, jwit), (tcfg, tsys, twit), traces


def test_constraint_graphs_are_equal(both):
    (_, jsys, _), (_, tsys, _), _ = both
    for jc, tc in zip(jsys.circuits, tsys.circuits):
        assert tc.graph.nodes == jc.graph.nodes
        assert tc.graph.zeros == jc.graph.zeros and tc.graph.lookups == jc.graph.lookups
        assert (tc.constraint_count, tc.max_constraint_degree, tc.stage2_width) == (
            jc.constraint_count, jc.max_constraint_degree, jc.stage2_width
        )


def test_transcript_profile_is_the_jax_default():
    """The port implements one transcript convention: the JAX default's."""
    from multistark_tpu.config import DEFAULT_TRANSCRIPT_PROFILE as jax_profile
    from multistark_tpu_torch.config import TranscriptProfile

    for name in (
        "fri_observe_claims_before_alpha", "commit_pow_witness_placement", "duplex_observe_bytes",
        "poseidon2_constants",
    ):
        assert getattr(TranscriptProfile, name) == getattr(jax_profile, name), name


def test_preprocessed_commit_and_shape_transcript_are_equal(both):
    (jcfg, jsys, _), (tcfg, tsys, _), _ = both
    np.testing.assert_array_equal(tsys.preprocessed_commit, jsys.preprocessed_commit)
    jch, tch = jcfg.initialise_challenger(), tcfg.initialise_challenger()
    jsys.observe_shape(jch)
    tsys.observe_shape(tch)
    assert bytes(tch.inner.input_buffer) == bytes(jch.inner.input_buffer)


def test_witness_from_numpy_keeps_the_bit_patterns(both):
    *_, traces = both
    ttraces, claims = mt.witness_from_numpy(traces, np.asarray([[1, 2**64 - 1]], np.uint64), "cpu")
    for t, want in zip(ttraces, traces):
        assert t.dtype == torch.int64 and t.shape == want.shape
        np.testing.assert_array_equal(fd.to_np(t), want)
    assert claims.dtype == np.uint64 and claims[0, 1] == 2**64 - 1


def test_lookup_values_are_equal(both):
    (_, _, jwit), (_, _, twit), _ = both
    for jlv, tlv in zip(jwit.lookup_values, twit.lookup_values):
        for jm, tm in zip(jlv.mults, tlv.mults):
            np.testing.assert_array_equal(fd.to_np(tm), np.broadcast_to(GL_OPS.to_np(jm), tm.shape))
        for ja, ta in zip(jlv.args, tlv.args):
            for x, y in zip(ja, ta):
                np.testing.assert_array_equal(fd.to_np(y), np.broadcast_to(GL_OPS.to_np(x), y.shape))


def test_stage_2_traces_and_accumulators_are_equal(both):
    (_, _, jwit), (tcfg, _, twit), _ = both
    rng = np.random.default_rng(3)
    beta, gamma, acc0 = (tuple(int(v) for v in rng.integers(0, GOLDILOCKS.p, 2, dtype=np.uint64)) for _ in range(3))
    jmats, jaccs = jax_lk.stage_2_traces(
        GL_OPS, GL2_OPS, GOLDILOCKS, GOLDILOCKS_EXT2, jwit.lookup_values, beta, gamma, acc0
    )
    tmats, taccs = lk.stage_2_traces_device(
        TGL2, twit.lookup_values, *(TGL2.const(v, tcfg.device) for v in (beta, gamma, acc0))
    )
    assert [tuple(int(c) for c in a) for a in fetch(taccs)] == jaccs
    for jm, tm in zip(jmats, tmats):
        np.testing.assert_array_equal(fd.to_np(tm), GL_OPS.to_np(jm))
