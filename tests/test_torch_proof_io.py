"""The port's proof reader (serialization.proof_from_bytes, Proof.from_bytes)
against the JAX package's: the JAX package's bytes read by the port give the
same bytes back, the port's bytes read by the JAX package give the same
proof, and malformed bytes (truncations, trailing bytes, a bad Option tag,
oversized counts, bit flips, garbage) raise the same error kind in both
readers.  Both configs: GoldilocksBlake3 (8-byte elements; a proof with and
one without a preprocessed round) and BabyBearPoseidon2 (4-byte elements).
The proofs are the port's, proved on CPU tensors.  Tolerance: exact."""

import struct

import numpy as np
import pytest

import multistark_tpu_torch as mt
from multistark_tpu import expr as jex
from multistark_tpu.config import CommitmentParameters as JaxCommit, FriParameters as JaxFri
from multistark_tpu.configs import BabyBearPoseidon2Config as JaxBabyBear, GoldilocksBlake3Config as JaxGoldilocks
from multistark_tpu.errors import VerificationError as JaxVerificationError
from multistark_tpu.prover import Proof as JaxProof
from multistark_tpu.system import CircuitInputs as JaxInputs, System as JaxSystem
from multistark_tpu.test_circuits import u32_add_system_inputs as jax_u32_inputs, u32_add_witness
from multistark_tpu_torch import expr as tex
from multistark_tpu_torch import serialization
from multistark_tpu_torch.config import CommitmentParameters, FriParameters
from multistark_tpu_torch.configs import BabyBearPoseidon2Config, GoldilocksBlake3Config
from multistark_tpu_torch.errors import VerificationError
from multistark_tpu_torch.fields.host import BABYBEAR
from multistark_tpu_torch.prover import Proof
from multistark_tpu_torch.system import CircuitInputs, System, SystemWitness
from multistark_tpu_torch.test_circuits import u32_add_system_inputs

FRI = (0, 2, 4, 1, 1)


def _mul(ex, cls):
    return [cls(main_width=3, constraints=[ex.main(0) * ex.main(1) - ex.main(2)], ext_constraints=[], lookups=[])]


def _mul_trace(p: int) -> np.ndarray:
    rng = np.random.default_rng(11)
    a = rng.integers(0, 1 << 30, 16, dtype=np.uint64)
    b = rng.integers(0, 1 << 30, 16, dtype=np.uint64)
    return np.stack([a, b, np.asarray((a.astype(object) * b.astype(object)) % p, np.uint64)], axis=1)


@pytest.fixture(scope="module", params=["goldilocks u32_add", "goldilocks mul", "babybear mul"])
def case(request):
    """(JAX system, JAX config, port system, the port's proof bytes)."""
    field, circuit = request.param.split()
    jcls, tcls = (JaxGoldilocks, GoldilocksBlake3Config) if field == "goldilocks" else (JaxBabyBear,
                                                                                          BabyBearPoseidon2Config)
    jcfg = jcls(JaxCommit(2, 0), JaxFri(*FRI))
    tcfg = tcls(CommitmentParameters(2, 0), FriParameters(*FRI), device="cpu")
    if circuit == "u32_add":
        jsys, _ = JaxSystem.new(jcfg, jax_u32_inputs())
        tsys, tkey = System.new(tcfg, u32_add_system_inputs())
        traces, claims = u32_add_witness([(1, 2), (3 << 30, 7 << 29), (5, 6)], 16)
    else:
        jsys, _ = JaxSystem.new(jcfg, _mul(jex, JaxInputs))
        tsys, tkey = System.new(tcfg, _mul(tex, CircuitInputs))
        traces, claims = [_mul_trace(tcfg.host_field.p)], []
    ttraces, tclaims = mt.witness_from_numpy(traces, claims, "cpu")
    proof = tsys.prove_multiple_claims(tkey, SystemWitness.from_stage_1(ttraces, tsys, tkey), tclaims)
    return jsys, jcfg, tsys, proof.to_bytes()


def _same_proof(jp, tp) -> None:
    """The JAX package's Proof and the port's hold the same values."""
    assert tp.active == jp.active and tp.log_degrees == jp.log_degrees
    for name in ("stage_1_trace", "stage_2_trace", "quotient_chunks"):
        np.testing.assert_array_equal(getattr(tp.commitments, name), getattr(jp.commitments, name))
    assert tp.intermediate_accumulators == jp.intermediate_accumulators
    for name in ("preprocessed_opened", "stage1_opened", "stage2_opened", "quotient_opened"):
        assert getattr(tp, name) == getattr(jp, name), name
    tf, jf = tp.fri_proof, jp.fri_proof
    assert len(tf.commit_caps) == len(jf.commit_caps)
    for a, b in zip(tf.commit_caps, jf.commit_caps):
        np.testing.assert_array_equal(a, b)
    assert tf.commit_pow_witnesses == jf.commit_pow_witnesses
    assert tf.final_poly == jf.final_poly and tf.query_pow_witness == jf.query_pow_witness
    assert len(tf.query_proofs) == len(jf.query_proofs)
    for tq, jq in zip(tf.query_proofs, jf.query_proofs):
        assert len(tq.input_openings) == len(jq.input_openings)
        for to, jo in zip(tq.input_openings, jq.input_openings):
            assert len(to.opened_rows) == len(jo.opened_rows)
            for a, b in zip(to.opened_rows, jo.opened_rows):
                assert a.dtype == b.dtype == np.uint64
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(to.path, jo.path)
            assert to.path.dtype == jo.path.dtype == np.uint32
        assert len(tq.commit_openings) == len(jq.commit_openings)
        for (tr, tpath), (jr, jpath) in zip(tq.commit_openings, jq.commit_openings):
            np.testing.assert_array_equal(tr, jr)
            np.testing.assert_array_equal(tpath, jpath)


def test_jax_bytes_round_trip_through_the_port(case):
    """JAX Proof.to_bytes() -> port Proof.from_bytes -> to_bytes(): the same
    bytes, and the element width is the config's."""
    jsys, jcfg, tsys, data = case
    jax_bytes = JaxProof.from_bytes(data, jsys).to_bytes(jcfg)
    assert jax_bytes == data
    proof = Proof.from_bytes(jax_bytes, tsys)
    assert proof.field_bytes == (8 if tsys.config.host_field.p > BABYBEAR.p else 4)
    assert proof.to_bytes() == jax_bytes
    assert bool(proof.preprocessed_opened) == (tsys.preprocessed_commit is not None)


def test_port_bytes_read_by_jax_give_the_same_proof(case):
    jsys, jcfg, tsys, data = case
    _same_proof(JaxProof.from_bytes(data, jsys), Proof.from_bytes(data, tsys))


def _read(reader, data: bytes, system, error):
    try:
        return reader(data, system)
    except error as e:
        return e.kind


def _tag_offset(proof) -> int:
    """The byte offset of the preprocessed Option tag in proof.to_bytes()."""
    w = serialization._Writer(proof.field_bytes)
    w.u64(len(proof.active))
    for b in proof.active:
        w.u8(b)
    for cap in (proof.commitments.stage_1_trace, proof.commitments.stage_2_trace, proof.commitments.quotient_chunks):
        w.cap(cap)
    w.u64(len(proof.intermediate_accumulators))
    for a in proof.intermediate_accumulators:
        w.ext(a)
    w.u64(len(proof.log_degrees))
    for ld in proof.log_degrees:
        w.u8(ld)
    serialization._write_fri_proof(w, proof.fri_proof)
    serialization._write_opened(w, proof.quotient_opened)
    return len(w.bytes())


def _malformed(data: bytes, proof):
    """(label, bytes) of the malformed-input families."""
    L = len(data)
    rng = np.random.default_rng(0xF00D)
    for cut in (0, 1, 7, 8, L // 3, L // 2, L - 8, L - 1):
        yield f"truncated to {cut}", data[:cut]
    for _ in range(20):
        yield "truncated", data[: int(rng.integers(0, L))]
    yield "one trailing byte", data + b"\x00"
    yield "trailing bytes", data + bytes(range(17))
    tag = _tag_offset(proof)
    for v in (2, 7, 255):
        yield f"Option tag {v}", data[:tag] + bytes([v]) + data[tag + 1 :]
    n_active = len(proof.active)
    for off, what in ((0, "circuit count"), (8 + n_active, "stage-1 cap count")):
        for v in (1 << 20, (1 << 20) + 1, 1 << 24, (1 << 24) + 1, 1 << 40, (1 << 64) - 1):
            yield f"{what} {v}", data[:off] + struct.pack("<Q", v) + data[off + 8 :]
    for _ in range(120):  # single bit flips
        i = int(rng.integers(0, L))
        b = bytearray(data)
        b[i] ^= 1 << int(rng.integers(0, 8))
        yield f"bit flip at {i}", bytes(b)
    for n in (0, 10, 1000):
        yield f"{n} garbage bytes", rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def test_malformed_bytes_raise_the_same_kind(case):
    """Every malformed input: both readers raise VerificationError of the
    same kind, or both read it, to proofs that write the same bytes."""
    jsys, jcfg, tsys, data = case
    proof = Proof.from_bytes(data, tsys)
    seen = set()
    for label, blob in _malformed(data, proof):
        want = _read(JaxProof.from_bytes, blob, jsys, JaxVerificationError)
        got = _read(Proof.from_bytes, blob, tsys, VerificationError)
        if isinstance(want, str) or isinstance(got, str):
            assert got == want, label
            seen.add(label.split(" at ")[0].split(" to ")[0])
        else:
            assert got.to_bytes() == want.to_bytes(jcfg), label
    assert {"truncated", "one trailing byte", "Option tag 2", "circuit count 16777217",
            "stage-1 cap count 1048577"} <= seen
