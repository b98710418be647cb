"""The BabyBearPoseidon2 slice of the port on the CPU against the JAX
package, exact (tolerance zero: everything is mod p): BB_OPS / BB4_OPS
(kernel K5's plain versions), the BabyBear NTT (K2) and scans (K4), the
Poseidon2 host and C permutations, Poseidon2 Merkle commitments (K6),
the duplex challenger, a whole MulAir proof that the JAX verifier accepts
and the bench workload's golden entry; plus the port's isolation from the
JAX package.  The U32Add + ByteTable proofs are in
test_torch_babybear_prove.py (a file of their own: the JAX side's eager
Poseidon2 trees take over a minute per proof on the CPU)."""

import ast
import glob
import hashlib
import json
import os

import numpy as np
import pytest

import multistark_tpu_torch as mt
from multistark_tpu import expr as jex
from multistark_tpu import utils as jax_utils
from multistark_tpu.challenger import DuplexChallenger as JaxDuplex, observe_claims as jax_observe_claims
from multistark_tpu.config import CommitmentParameters as JaxCommit, FriParameters as JaxFri
from multistark_tpu.configs import BabyBearPoseidon2Config as JaxConfig
from multistark_tpu.fields.device import BB4_OPS, BB_OPS
from multistark_tpu.fields.host import BABYBEAR, BABYBEAR_EXT4
from multistark_tpu.hash import poseidon2 as jax_p2
from multistark_tpu.merkle import MerkleMmcs as JaxMmcs
from multistark_tpu.ntt import get_engine
from multistark_tpu.prover import Proof as JaxProof, prove_multiple_claims as jax_prove
from multistark_tpu.system import CircuitInputs as JaxCircuitInputs, System as JaxSystem
from multistark_tpu.system import SystemWitness as JaxWitness
from multistark_tpu.test_circuits import u32_add_witness
from multistark_tpu.verifier import verify_multiple_claims as jax_verify
from multistark_tpu_torch import expr as tex, utils
from multistark_tpu_torch.challenger import DuplexChallenger, observe_claims
from multistark_tpu_torch.config import CommitmentParameters, FriParameters
from multistark_tpu_torch.configs import BabyBearPoseidon2Config
from multistark_tpu_torch.fields import device as fd
from multistark_tpu_torch.fields.device import BB4_OPS as TBB4, BB_OPS as TBB
from multistark_tpu_torch.hash import poseidon2 as tp2, poseidon2_host
from multistark_tpu_torch.merkle import MerkleMmcs, Poseidon2FieldHasher
from multistark_tpu_torch.ntt import NttEngine
from multistark_tpu_torch.prover import prove_multiple_claims
from multistark_tpu_torch.system import CircuitInputs, System, SystemWitness
from multistark_tpu_torch.test_circuits import u32_add_system_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = BABYBEAR.p
EDGES = np.asarray([0, 1, P - 1, 2, (P - 1) // 2], np.uint64)


def _t(x):
    return TBB.from_np(x, "cpu")


def _operands(seed: int, n: int = 300):
    """Random canonical values plus every pair of edge values."""
    rng = np.random.default_rng(seed)
    a = np.concatenate([rng.integers(0, P, n, dtype=np.uint64), np.repeat(EDGES, len(EDGES))])
    b = np.concatenate([rng.integers(0, P, n, dtype=np.uint64), np.tile(EDGES, len(EDGES))])
    return a, b


def _ext(seed: int, n: int = 120):
    """(n, 4) random BB4 values with zeros, a unit and a base-only value."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, P, (n, 4), dtype=np.uint64)
    x[0], x[1], x[2, 1:] = 0, (1, 0, 0, 0), 0
    x[3] = (P - 1, 0, P - 1, 0)
    return x


def _te(x):  # (n, 4) host -> coordinate-major (4, n) tensor
    return TBB.from_np(np.ascontiguousarray(x.T), "cpu")


# --- K5: BB_OPS / BB4_OPS ----------------------------------------------------------

@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_bb_binary_ops_match_jax(op):
    a, b = _operands(1)
    want = BB_OPS.to_np(getattr(BB_OPS, op)(BB_OPS.from_np(a), BB_OPS.from_np(b)))
    np.testing.assert_array_equal(fd.to_np(getattr(TBB, op)(_t(a), _t(b))), want)


def test_bb_neg_inv_pow_match_jax():
    a, _ = _operands(2, n=40)
    ja = BB_OPS.from_np(a)
    np.testing.assert_array_equal(fd.to_np(TBB.neg(_t(a))), BB_OPS.to_np(BB_OPS.neg(ja)))
    np.testing.assert_array_equal(fd.to_np(TBB.inv(_t(a))), BB_OPS.to_np(BB_OPS.inv(ja)))
    np.testing.assert_array_equal(fd.to_np(TBB.pow(_t(a), 0xDEADBEEF)), BB_OPS.to_np(BB_OPS.pow_const(ja, 0xDEADBEEF)))
    assert fd.to_np(TBB.inv(_t(np.zeros(1, np.uint64))))[0] == 0  # 0 maps to 0


def test_bb_from_np_reduces_like_jax():
    """A u32 trace value >= p is its residue, as the JAX package's from_np makes it."""
    v = np.asarray([P, P + 5, (1 << 32) - 1, 7], np.uint64)
    np.testing.assert_array_equal(fd.to_np(_t(v)), BB_OPS.to_np(BB_OPS.from_np(v)))


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_bb4_binary_ops_match_jax(op):
    a, b = _ext(3), _ext(4)[::-1].copy()
    want = BB4_OPS.to_np(getattr(BB4_OPS, op)(BB4_OPS.from_np(a), BB4_OPS.from_np(b)))
    np.testing.assert_array_equal(fd.to_np(getattr(TBB4, op)(_te(a), _te(b))).T, want)


def test_bb4_scale_inverse_and_scalar_broadcast_match_jax():
    a, b = _ext(5), _ext(6)
    ja = BB4_OPS.from_np(a)
    np.testing.assert_array_equal(
        fd.to_np(TBB4.scale(_te(a), _t(b[:, 0]))).T, BB4_OPS.to_np(BB4_OPS.scale(ja, BB_OPS.from_np(b[:, 0])))
    )
    np.testing.assert_array_equal(fd.to_np(TBB4.inv(_te(a))).T, BB4_OPS.to_np(BB4_OPS.inv(ja)))
    assert not fd.to_np(TBB4.inv(_te(a)))[:, 0].any()  # inv(0) = 0
    z = TBB4.const([int(c) for c in b[7]], "cpu")
    want = BB4_OPS.to_np(BB4_OPS.mul(ja, BB4_OPS.from_np(np.broadcast_to(b[7], a.shape))))
    np.testing.assert_array_equal(fd.to_np(TBB4.mul(_te(a), z)).T, want)


# --- K2 and K4 over BabyBear --------------------------------------------------------

@pytest.mark.parametrize("log_n", [3, 6, 9])
def test_babybear_ntt_matches_jax(log_n):
    rng = np.random.default_rng(log_n)
    m = rng.integers(0, P, (3, 1 << log_n), dtype=np.uint64)
    jax_eng, eng = get_engine(BB_OPS), NttEngine(TBB, BABYBEAR, "cpu")
    shift = BABYBEAR.mul(BABYBEAR.generator, 5)
    want = BB_OPS.to_np(jax_eng.coset_lde_bitrev(BB_OPS.from_np(m), log_n, 2, shift))
    np.testing.assert_array_equal(fd.to_np(eng.coset_lde_bitrev(_t(m), log_n, 2, shift)), want)
    want = BB_OPS.to_np(jax_eng.icoset_from_natural(BB_OPS.from_np(m), log_n, BABYBEAR.generator))
    np.testing.assert_array_equal(fd.to_np(eng.icoset_from_natural(_t(m), log_n, BABYBEAR.generator)), want)


@pytest.mark.parametrize("n", [1, 5, 300])
def test_babybear_scans_match_jax(n):
    rng = np.random.default_rng(50 + n)
    x = rng.integers(0, P, (2, n), dtype=np.uint64)
    x[0, :: max(1, n // 3)] = 0
    want = np.stack([BB_OPS.to_np(jax_utils._batch_inv_impl(BB_OPS, BB_OPS.from_np(r))) for r in x])
    np.testing.assert_array_equal(fd.to_np(utils.batch_inv(_t(x), TBB)), want)
    jx = BB_OPS.from_np(x)
    np.testing.assert_array_equal(fd.to_np(utils.field_sum(_t(x), TBB)), BB_OPS.to_np(jax_utils.field_sum(BB_OPS, jx)))
    np.testing.assert_array_equal(fd.to_np(utils.cumsum(_t(x), TBB)), BB_OPS.to_np(jax_utils.cumsum(BB_OPS, jx)))
    e = _ext(60 + n, max(n, 4))[:n]
    je = BB4_OPS.from_np(e)
    want = BB4_OPS.to_np(jax_utils._batch_inv_impl(BB4_OPS, je, axis=0))
    np.testing.assert_array_equal(fd.to_np(utils.batch_inv(_te(e), TBB4)).T, want)
    np.testing.assert_array_equal(
        fd.to_np(utils.field_sum(_te(e), TBB4)), BB4_OPS.to_np(jax_utils.field_sum(BB4_OPS, je, axis=0))
    )
    np.testing.assert_array_equal(
        fd.to_np(utils.cumsum(_te(e), TBB4)).T, BB4_OPS.to_np(jax_utils.cumsum(BB4_OPS, je, axis=0))
    )


# --- Poseidon2: host, C, K6 ---------------------------------------------------------

def test_poseidon2_constants_and_permutations_match_jax():
    assert poseidon2_host.CONSTANTS == jax_p2.CONSTANTS
    rng = np.random.default_rng(7)
    states = [list(range(16)), [0] * 16, [P - 1] * 16] + [
        [int(v) for v in rng.integers(0, P, 16, dtype=np.uint64)] for _ in range(5)
    ]
    for s in states:
        want = jax_p2.permute(s)
        assert poseidon2_host.permute(s) == want
        assert poseidon2_host.native_permute(s) == want
    lanes = [TBB.from_np(np.asarray([st[i] for st in states], np.uint64), "cpu") for i in range(16)]
    got = np.stack([fd.to_np(x) for x in tp2.permute_plain(lanes)], axis=1)
    np.testing.assert_array_equal(got, np.asarray([jax_p2.permute(s) for s in states], np.uint64))


POSEIDON2_CASES = [
    [(1, 16)], [(3, 16)], [(8, 16)], [(9, 16)], [(14, 16)], [(17, 16)],
    [(14, 64), (4, 16), (1, 16), (5, 4)],  # mixed heights, two at one height, injections
]


@pytest.mark.parametrize("case", range(len(POSEIDON2_CASES)))
def test_poseidon2_commit_matches_jax(case):
    rng = np.random.default_rng(100 + case)
    mats = [rng.integers(0, P, (w, h), dtype=np.uint64) for w, h in POSEIDON2_CASES[case]]
    jax_mmcs = JaxMmcs(jax_p2.Poseidon2FieldHasher(BB_OPS), 1)
    jax_cap, jax_data = jax_mmcs.commit([BB_OPS.from_np(m) for m in mats])
    mmcs = MerkleMmcs(Poseidon2FieldHasher(), 1)
    cap, data = mmcs.commit([_t(m) for m in mats])
    np.testing.assert_array_equal(cap, jax_cap)
    idx = np.asarray([0, 3, 15, 7])
    for a, b in zip(mmcs.open_batch(data, idx), jax_mmcs.open_batch(jax_data, idx)):
        np.testing.assert_array_equal(a.path, b.path)


def test_poseidon2_leaf_of_an_extension_matrix_matches_jax():
    """An ext matrix is hashed as its flattened base columns [s0_0..s0_3, s1_0, ...]."""
    e = [_ext(8 + j, 32) for j in range(2)]  # two BB4 columns of 32 rows
    flat = np.concatenate([x.T for x in e])  # (8, 32): column j*4 + d
    hasher = jax_p2.Poseidon2FieldHasher(BB_OPS)
    want = [hasher.host_hash_rows([flat[:, i]]) for i in range(32)]
    got = tp2.hash_rows([_t(flat)]).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, np.stack(want))


# --- duplex challenger ------------------------------------------------------------

def _transcripts():
    return JaxDuplex(BABYBEAR, BABYBEAR_EXT4, jax_p2.permute), DuplexChallenger(BABYBEAR, BABYBEAR_EXT4)


def test_duplex_transcript_matches_jax():
    rng = np.random.default_rng(9)
    claims = [[int(v) for v in rng.integers(0, 1 << 32, 4, dtype=np.uint64)] for _ in range(45)]
    for ch in _transcripts():
        ch.observe_bytes(b"multi-stark/v0")
        ch.observe_u64(2**40 + 3)
        ch.observe_ext((1, 2, 3, P - 1))
    outs = []
    for ch, observe in zip(_transcripts(), (jax_observe_claims, observe_claims)):
        ch.observe_bytes(b"tag")
        out = [ch.sample_field(), ch.sample_ext()]
        ch.observe_commitment(np.arange(16, dtype=np.uint32).reshape(2, 8) * 1000)
        observe(ch, claims)  # 45 claims of 4 values >= p included: the bulk path
        out += [ch.sample_ext(), ch.sample_bits(12)]
        observe(ch, claims[:3])  # too few for the bulk path
        out += [ch.grind(4), ch.sample_field()]
        for _ in range(7):
            ch.observe_field(5)
        out += [ch.grind(4), list(ch.state), ch.sample_ext()]
        outs.append(out)
    assert outs[1] == outs[0]


# --- whole proofs ---------------------------------------------------------------------

def _mul_air(ex):
    a, b, c = ex.main(0), ex.main(1), ex.main(2)
    return dict(
        main_width=3,
        constraints=[a * b - c],
        ext_constraints=[],
        lookups=[ex.Lookup.push(ex.Const(1), [ex.Const(9), a, c]), ex.Lookup.pull(ex.Const(1), [ex.Const(9), a, c])],
    )


def _prove_both(jax_inputs, torch_inputs, traces, claims, fri):
    jcfg = JaxConfig(JaxCommit(log_blowup=2, cap_height=0), JaxFri(**fri))
    jsys, jkey = JaxSystem.new(jcfg, jax_inputs)
    jproof = jax_prove(jsys, jkey, JaxWitness.from_stage_1(traces, jsys, jkey), claims)
    tcfg = BabyBearPoseidon2Config(CommitmentParameters(log_blowup=2, cap_height=0), FriParameters(**fri), device="cpu")
    tsys, tkey = System.new(tcfg, torch_inputs)
    ttraces, tclaims = mt.witness_from_numpy(traces, claims, tcfg.device)
    tproof = prove_multiple_claims(tsys, tkey, SystemWitness.from_stage_1(ttraces, tsys, tkey), tclaims)
    return jsys, jproof.to_bytes(jcfg), tproof.to_bytes()


def test_mul_air_proof_bytes_match_jax_and_verify():
    """tests/test_babybear.py's MulAir with a self-canceling push/pull pair."""
    rng = np.random.default_rng(88)
    rows = []
    for _ in range(4):
        a, b = (int(v) for v in rng.integers(1, P, 2))
        rows.append((a, b, a * b % P))
    fri = dict(log_final_poly_len=0, max_log_arity=1, num_queries=6,
               commit_proof_of_work_bits=1, query_proof_of_work_bits=1)
    jsys, want, got = _prove_both(
        [JaxCircuitInputs(**_mul_air(jex))], [CircuitInputs(**_mul_air(tex))], [np.asarray(rows, np.uint64)], [], fri
    )
    assert got == want
    jax_verify(jsys, [], JaxProof.from_bytes(got, jsys))


def test_port_reproduces_the_babybear_golden_entry():
    """The bench workload at 2^10 rows against the JAX package's digest
    (fixtures/torch_port_golden.json, made by scripts/torch_port_golden.py)."""
    import sys

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch_port_golden as golden

    with open(golden.GOLDEN_PATH) as f:
        entry = json.load(f)["babybear_poseidon2"]["10"]
    config = BabyBearPoseidon2Config(
        CommitmentParameters(**golden.BENCH_COMMIT), FriParameters(**golden.BENCH_FRI), device="cpu"
    )
    system, key = System.new(config, u32_add_system_inputs())
    traces, claims = mt.witness_from_numpy(*u32_add_witness(golden.bench_witness(10), 1 << 10), config.device)
    proof = prove_multiple_claims(system, key, SystemWitness.from_stage_1(traces, system, key), claims)
    data = proof.to_bytes()
    assert {"sha256": hashlib.sha256(data).hexdigest(), "n_bytes": len(data)} == entry


# --- isolation ---------------------------------------------------------------------

def _imported_modules(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_nothing_of_jax_and_builds_only_its_own_sources():
    """No module of the port, and not chip_smoke.py, imports jax or the JAX
    package; every source the port compiles lies inside its package."""
    from multistark_tpu_torch import kernels, native

    files = glob.glob(os.path.join(ROOT, "multistark_tpu_torch", "**", "*.py"), recursive=True)
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "multistark_tpu"), f"{path} imports {mod}"
    pkg = os.path.join(ROOT, "multistark_tpu_torch") + os.sep
    srcs = kernels.sources() + native.sources() + [kernels.PROGRAM_TEMPLATE]
    assert len(kernels.sources()) == 11 and len(native.sources()) == 2  # K11 builds per program from its template
    assert os.path.exists(kernels.PROGRAM_TEMPLATE) and kernels.PROGRAM_TEMPLATE not in kernels.sources()
    assert all(os.path.abspath(s).startswith(pkg) for s in srcs), srcs
    assert {k.name for k in kernels.KERNELS} >= {"bb_arith", "poseidon2_merkle", "dt_flush", "fri_grind",
                                                 "claims_fp", "fri_fold", "expr_sweep", "bary_eval", "reduced_open",
                                                 "lde_tile", "merkle_levels"}


def test_configs_default_to_cuda():
    import inspect

    from multistark_tpu_torch.configs import GoldilocksBlake3Config

    for cls in (GoldilocksBlake3Config, BabyBearPoseidon2Config):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
