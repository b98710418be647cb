"""The device-transcript prove end to end on CPU tensors: the port's
`prove_multiple_claims` (which takes dt_prover for GoldilocksBlake3) and
its `prove_host_transcript` (host transcript, device FRI rounds) give the
JAX package's host-path proof bytes, bit for bit, the JAX verifier accepts
them, and no run falls back.  JAX's own contract makes its host-path bytes
equal to its device-transcript bytes (tests/test_dt_prover.py)."""

import numpy as np
import pytest

import multistark_tpu_torch as mt
from multistark_tpu import expr as jex
from multistark_tpu.config import CommitmentParameters as JaxCommit, FriParameters as JaxFri
from multistark_tpu.configs import GoldilocksBlake3Config as JaxConfig
from multistark_tpu.fields.host import GOLDILOCKS as JF
from multistark_tpu.prover import Proof as JaxProof, prove_multiple_claims as jax_prove
from multistark_tpu.system import CircuitInputs as JaxInputs, System as JaxSystem, SystemWitness as JaxWitness
from multistark_tpu.test_circuits import u32_add_system_inputs as jax_u32_inputs, u32_add_witness
from multistark_tpu.verifier import verify_multiple_claims as jax_verify
from multistark_tpu_torch import device_transcript as dt, dt_prover
from multistark_tpu_torch import expr as tex
from multistark_tpu_torch.config import CommitmentParameters, FriParameters
from multistark_tpu_torch.configs import BabyBearPoseidon2Config, GoldilocksBlake3Config
from multistark_tpu_torch.pcs import TwoAdicFriPcs
from multistark_tpu_torch.prover import prove_host_transcript, prove_multiple_claims
from multistark_tpu_torch.system import CircuitInputs, System, SystemWitness
from multistark_tpu_torch.test_circuits import u32_add_system_inputs

SMALL_FRI = dict(log_final_poly_len=0, num_queries=16, commit_proof_of_work_bits=4, query_proof_of_work_bits=4)


def _prove_all(jax_inputs, torch_inputs, traces, claims, cap_height, max_log_arity):
    """(JAX system, JAX host-path bytes, port device-transcript bytes, port
    host-transcript bytes)."""
    fri = dict(SMALL_FRI, max_log_arity=max_log_arity)
    jcfg = JaxConfig(JaxCommit(log_blowup=2, cap_height=cap_height), JaxFri(**fri))
    jsys, jkey = JaxSystem.new(jcfg, jax_inputs)
    want = jax_prove(jsys, jkey, JaxWitness.from_stage_1(traces, jsys, jkey), claims).to_bytes(jcfg)
    tcfg = GoldilocksBlake3Config(CommitmentParameters(log_blowup=2, cap_height=cap_height), FriParameters(**fri),
                                  device="cpu")
    assert dt_prover.eligible(tcfg)
    tsys, tkey = System.new(tcfg, torch_inputs)
    ttraces, tclaims = mt.witness_from_numpy(traces, claims, tcfg.device)
    witness = SystemWitness.from_stage_1(ttraces, tsys, tkey)
    dt.FALLBACKS.clear()
    got_dt = prove_multiple_claims(tsys, tkey, witness, tclaims).to_bytes()
    got_host = prove_host_transcript(tsys, tkey, witness, tclaims).to_bytes()
    assert not dt.FALLBACKS, dict(dt.FALLBACKS)
    return jsys, want, got_dt, got_host


@pytest.mark.parametrize("log_n, cap_height, max_log_arity", [(4, 0, 1), (5, 1, 2), (6, 0, 2), (6, 1, 1)])
def test_u32_add_device_transcript_bytes_match_jax_and_verify(log_n, cap_height, max_log_arity):
    rng = np.random.default_rng(300 + log_n)
    n = 1 << log_n
    xs = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    ys = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    traces, claims = u32_add_witness(list(zip(xs.tolist(), ys.tolist())), n)
    jsys, want, got_dt, got_host = _prove_all(
        jax_u32_inputs(), u32_add_system_inputs(), traces, claims, cap_height, max_log_arity
    )
    assert got_dt == want
    assert got_host == want
    jax_verify(jsys, claims, JaxProof.from_bytes(got_dt, jsys))


def test_mul_system_device_transcript_bytes_match_jax_and_verify():
    """One circuit, no lookups, no claims (tests/test_device_transcript.py's
    _mul_system)."""
    rng = np.random.default_rng(7)
    n = 64
    a = rng.integers(0, 1 << 31, n, dtype=np.uint64)
    b = rng.integers(0, 1 << 31, n, dtype=np.uint64)
    c = np.asarray((a.astype(object) * b.astype(object)) % JF.p, np.uint64)
    trace = np.stack([a, b, c], axis=1)

    def inputs(ex, cls):
        return [cls(main_width=3, constraints=[ex.main(0) * ex.main(1) - ex.main(2)], ext_constraints=[],
                    lookups=[])]

    jsys, want, got_dt, got_host = _prove_all(inputs(jex, JaxInputs), inputs(tex, CircuitInputs), [trace], [], 0, 1)
    assert got_dt == want
    assert got_host == want
    jax_verify(jsys, [], JaxProof.from_bytes(got_dt, jsys))


def test_a_fallback_is_counted_and_the_host_transcript_gives_the_bytes(monkeypatch):
    """A Fallback in the device phase (here: a forced unaligned FRI entry
    buffer) is counted by its reason, and prove_multiple_claims returns the
    host transcript's proof."""
    cfg = GoldilocksBlake3Config(CommitmentParameters(log_blowup=2), FriParameters(max_log_arity=1, **SMALL_FRI),
                                 device="cpu")
    system, key = System.new(cfg, u32_add_system_inputs())
    traces, claims = u32_add_witness([(1, 2), (3, 4)], 16)
    traces, claims = mt.witness_from_numpy(traces, claims, "cpu")
    witness = SystemWitness.from_stage_1(traces, system, key)
    want = prove_host_transcript(system, key, witness, claims).to_bytes()
    monkeypatch.setattr(dt.DeviceDuplex, "entry_words", lambda self: None)
    dt.FALLBACKS.clear()
    assert dt_prover.prove_device_transcript(system, key, witness, claims) is None
    assert prove_multiple_claims(system, key, witness, claims).to_bytes() == want
    assert dict(dt.FALLBACKS) == {"unaligned duplex buffer at FRI entry": 2}


def _flip(t):
    """A device ext scalar with one bit of its first coordinate flipped."""
    t = t.clone()
    t[0] ^= 1
    return t


@pytest.mark.parametrize("entry, planted", [
    ("prove_multiple_claims", "β"),
    ("prove_multiple_claims", "FRI β"),
    ("prove_host_transcript", "FRI β"),
])
def test_a_replay_divergence_raises_and_names_the_draw(monkeypatch, entry, planted):
    """A device draw that the host replay does not reproduce (here: a β
    planted after the device phase) is a fault of the device path: it raises
    TranscriptDivergence naming the draw, and nothing falls back."""
    cfg = GoldilocksBlake3Config(CommitmentParameters(log_blowup=2), FriParameters(max_log_arity=1, **SMALL_FRI),
                                 device="cpu")
    system, key = System.new(cfg, u32_add_system_inputs())
    traces, claims = u32_add_witness([(1, 2), (3, 4)], 16)
    traces, claims = mt.witness_from_numpy(traces, claims, "cpu")
    witness = SystemWitness.from_stage_1(traces, system, key)
    if planted == "β":
        device_phase = dt_prover._device_phase

        def planting(*args):
            ph = device_phase(*args)
            ph.challenges[0] = _flip(ph.challenges[0])
            return ph

        monkeypatch.setattr(dt_prover, "_device_phase", planting)
        match = "replay: the device drew β = "
    else:
        core = TwoAdicFriPcs._commit_phase_device_core

        def planting(self, *args):
            caps, ws, betas, *rest = core(self, *args)
            return (caps, ws, [_flip(betas[0])] + betas[1:], *rest)

        monkeypatch.setattr(TwoAdicFriPcs, "_commit_phase_device_core", planting)
        match = "FRI replay: the device drew round 0's β = "
    prove = prove_multiple_claims if entry == "prove_multiple_claims" else prove_host_transcript
    dt.FALLBACKS.clear()
    with pytest.raises(dt.TranscriptDivergence, match=match):
        prove(system, key, witness, claims)
    assert not dt.FALLBACKS


def test_ragged_claims_fall_back():
    dd = dt.DeviceDuplex("cpu")
    with pytest.raises(dt.Fallback, match="ragged"):
        dt_prover._observe_claims_dd(dd, [[1, 2], [3]], JF.p)


def test_babybear_keeps_the_host_transcript():
    cfg = BabyBearPoseidon2Config(CommitmentParameters(log_blowup=2), FriParameters.standard_fast(), device="cpu")
    assert not dt_prover.eligible(cfg)
