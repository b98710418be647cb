"""The port's verifier (multistark_tpu_torch/verifier.py, pcs.verify,
MerkleMmcs.verify_batch) against the JAX package's, verdict for verdict: the
same proof goes to both, and both accept or both raise VerificationError of
the same kind.  The proofs are the port's, proved on CPU tensors (their
bytes equal the JAX package's: tests/test_torch_dt_prove.py,
tests/test_torch_babybear_prove.py), read by each side's Proof.from_bytes.

Cases: a seeded sweep of 200 structural mutants of a U32Add proof in the
manner of tests/test_pcs_fuzz.py (opened rows, fold rows, paths, caps,
widths, counts), each checked by the JAX package's batched and per-query
walks and the port's (the port's batched walk must give the JAX batched
kind, its per-query walk the JAX per-query kind, and the two port walks the
same verdict); a wrong claim; the sparse-activation and ragged-claims
systems of tests/test_e2e_lookups.py; the degree-5 circuit of
tests/test_system_guards.py and a proof checked against another system;
and a BabyBearPoseidon2 proof (the JAX package walks BabyBear one query at
a time).  Tolerance: exact (verdicts and kinds)."""

import copy

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
from multistark_tpu.verifier import verify_multiple_claims as jax_verify
from multistark_tpu_torch import expr as tex
from multistark_tpu_torch.config import CommitmentParameters, FriParameters
from multistark_tpu_torch.configs import BabyBearPoseidon2Config, GoldilocksBlake3Config
from multistark_tpu_torch.errors import VerificationError
from multistark_tpu_torch.fields.host import BABYBEAR, GOLDILOCKS
from multistark_tpu_torch.prover import Proof
from multistark_tpu_torch.system import CircuitInputs, System, SystemWitness
from multistark_tpu_torch.test_circuits import u32_add_system_inputs
from multistark_tpu_torch.verifier import verify_multiple_claims

FUZZ_FRI = (0, 2, 4, 1, 1)  # log_final_poly_len, max_log_arity, num_queries, PoW bits (tests/test_pcs_fuzz.py)
N_MUTANTS, CHUNKS = 200, 4
CONFIGS = {"goldilocks": (JaxGoldilocks, GoldilocksBlake3Config), "babybear": (JaxBabyBear, BabyBearPoseidon2Config)}


def _jax_kind(jsys, claims, proof, per_query: bool, monkeypatch) -> str:
    with monkeypatch.context() as m:
        if per_query:
            m.setenv("MULTISTARK_VERIFY_MODE", "perquery")
        else:
            m.delenv("MULTISTARK_VERIFY_MODE", raising=False)
        try:
            jax_verify(jsys, claims, proof)
        except JaxVerificationError as e:
            return e.kind
    return "accepted"


def _port_kind(tsys, claims, proof, per_query: bool) -> str:
    try:
        verify_multiple_claims(tsys, claims, proof, per_query=per_query)
    except VerificationError as e:
        return e.kind
    return "accepted"


def _proved(name, inputs_jax, inputs_port, traces, claims, commit=(2, 0), fri=FUZZ_FRI):
    """(JAX system, port system, port claims, the port's proof bytes)."""
    jcls, tcls = CONFIGS[name]
    jsys, _ = JaxSystem.new(jcls(JaxCommit(*commit), JaxFri(*fri)), inputs_jax)
    tsys, tkey = System.new(tcls(CommitmentParameters(*commit), FriParameters(*fri), device="cpu"), inputs_port)
    ttraces, tclaims = mt.witness_from_numpy(traces, claims, "cpu")
    proof = tsys.prove_multiple_claims(tkey, SystemWitness.from_stage_1(ttraces, tsys, tkey), tclaims)
    return jsys, tsys, tclaims, proof.to_bytes()


def _check_parity(jsys, tsys, claims, tclaims, data, monkeypatch, want=None, jax_per_query=False):
    """Both verifiers on the proof `data`: the same verdict (and `want`, if
    given); the port's two walks agree."""
    jk = _jax_kind(jsys, claims, JaxProof.from_bytes(data, jsys), jax_per_query, monkeypatch)
    proof = Proof.from_bytes(data, tsys)
    assert _port_kind(tsys, tclaims, proof, per_query=False) == jk
    assert _port_kind(tsys, tclaims, proof, per_query=True) == jk
    if want is not None:
        assert jk == want
    return jk


# --- the U32Add proof and its mutants -----------------------------------------

@pytest.fixture(scope="module")
def u32_add():
    rng = np.random.default_rng(0xF422)
    n = 32
    xs = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    ys = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    traces, claims = u32_add_witness(list(zip(xs.tolist(), ys.tolist())), n)
    jsys, tsys, tclaims, data = _proved("goldilocks", jax_u32_inputs(), u32_add_system_inputs(), traces, claims,
                                        commit=(2, 1))
    return jsys, tsys, claims, tclaims, data


def _mutate_ext(v, rng):
    v = list(v)
    v[int(rng.integers(len(v)))] = int(rng.integers(0, np.iinfo(np.int64).max))
    return tuple(v)


def _mutate(proof, rng) -> str:
    """One random structural mutation of a proof object of either package
    (the same fields), in place; returns its label.  tests/test_pcs_fuzz.py's
    mutations, drawn from `rng`."""
    fp = proof.fri_proof
    choice = int(rng.integers(18))
    if choice == 0:
        i = int(rng.integers(len(proof.intermediate_accumulators)))
        proof.intermediate_accumulators[i] = _mutate_ext(proof.intermediate_accumulators[i], rng)
        return "accumulator"
    if choice == 1:
        cap = proof.commitments.stage_1_trace.copy()
        cap[int(rng.integers(cap.shape[0])), int(rng.integers(cap.shape[1]))] ^= np.uint32(1 << int(rng.integers(32)))
        proof.commitments.stage_1_trace = cap
        return "stage1 cap bitflip"
    if choice == 2 and fp.commit_caps:
        l = int(rng.integers(len(fp.commit_caps)))
        cap = fp.commit_caps[l].copy()
        cap[int(rng.integers(cap.shape[0]))] += np.uint32(1)
        fp.commit_caps[l] = cap
        return "fri cap stomp"
    if choice == 3 and fp.commit_pow_witnesses:
        l = int(rng.integers(len(fp.commit_pow_witnesses)))
        fp.commit_pow_witnesses[l] ^= 1 << int(rng.integers(20))
        return "commit pow"
    if choice == 4:
        fp.query_pow_witness ^= 1 << int(rng.integers(20))
        return "query pow"
    if choice == 5 and fp.final_poly:
        i = int(rng.integers(len(fp.final_poly)))
        fp.final_poly[i] = _mutate_ext(fp.final_poly[i], rng)
        return "final poly"
    if choice == 6:
        fp.query_proofs.pop(int(rng.integers(len(fp.query_proofs))))
        return "drop query"
    qp = fp.query_proofs[int(rng.integers(len(fp.query_proofs)))]
    if choice == 7:
        op = qp.input_openings[int(rng.integers(len(qp.input_openings)))]
        m = int(rng.integers(len(op.opened_rows)))
        row = np.asarray(op.opened_rows[m], np.uint64).copy()
        row[int(rng.integers(row.size))] += np.uint64(1)
        op.opened_rows[m] = row
        return "opened row stomp"
    if choice == 8:
        op = qp.input_openings[int(rng.integers(len(qp.input_openings)))]
        m = int(rng.integers(len(op.opened_rows)))
        row = np.asarray(op.opened_rows[m], np.uint64)
        k = int(rng.integers(3))
        if k == 0:
            op.opened_rows[m] = row[:-1]
        elif k == 1:
            op.opened_rows[m] = np.concatenate([row, row[:1]])
        else:
            op.opened_rows[m] = row.astype(np.float64)  # the walks read rows as uint64
            return "noop"
        return "opened row reshape"
    if choice == 9:
        op = qp.input_openings[int(rng.integers(len(qp.input_openings)))]
        path = op.path.copy()
        path[int(rng.integers(path.shape[0])), int(rng.integers(path.shape[1]))] ^= np.uint32(1)
        op.path = path
        return "path stomp"
    if choice == 10:
        op = qp.input_openings[int(rng.integers(len(qp.input_openings)))]
        op.path = op.path[:-1]
        return "path truncate"
    if choice == 11:
        l = int(rng.integers(len(qp.commit_openings)))
        row, path = qp.commit_openings[l]
        row = np.asarray(row, np.uint64).copy()
        row[int(rng.integers(row.size))] += np.uint64(1)
        qp.commit_openings[l] = (row, path)
        return "fold row stomp"
    if choice == 12:
        l = int(rng.integers(len(qp.commit_openings)))
        row, path = qp.commit_openings[l]
        qp.commit_openings[l] = (np.asarray(row, np.uint64)[: max(0, len(row) - 2)], path)
        return "fold row truncate"
    if choice == 13:
        qp.commit_openings.pop(int(rng.integers(len(qp.commit_openings))))
        return "drop fold level"
    if choice == 14:
        qp.input_openings.pop(int(rng.integers(len(qp.input_openings))))
        return "drop round opening"
    if choice == 15:
        i = int(rng.integers(len(proof.log_degrees)))
        new = int(rng.integers(1, 30))
        while new == proof.log_degrees[i]:
            new = int(rng.integers(1, 30))
        proof.log_degrees[i] = new
        return "log degree"
    if choice == 16:
        m = int(rng.integers(len(proof.stage1_opened)))
        p = int(rng.integers(len(proof.stage1_opened[m])))
        c = int(rng.integers(len(proof.stage1_opened[m][p])))
        proof.stage1_opened[m][p][c] = _mutate_ext(proof.stage1_opened[m][p][c], rng)
        return "stage1 opened value"
    row = proof.quotient_opened[int(rng.integers(len(proof.quotient_opened)))][0]
    row.pop(int(rng.integers(len(row))))
    return "quotient width"


@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_mutant_sweep_verdicts_match_jax(u32_add, chunk, monkeypatch):
    """Each mutant, made alike in both packages' proof objects from one seed:
    the port's batched walk gives the JAX batched walk's verdict and kind,
    its per-query walk the JAX per-query walk's, and the port's two walks
    the same verdict; only a no-op mutant may verify.  (Both packages' walks
    differ in kind on a short Merkle path: the per-query walk indexes past
    it, InvalidProofShape; the batched walk cannot stack the paths,
    InvalidOpeningArgument.)"""
    jsys, tsys, claims, tclaims, data = u32_add
    jax_proof, port_proof = JaxProof.from_bytes(data, jsys), Proof.from_bytes(data, tsys)
    kinds = {}
    for i in range(chunk, N_MUTANTS, CHUNKS):
        jm, tm = copy.deepcopy(jax_proof), copy.deepcopy(port_proof)
        label = _mutate(jm, np.random.default_rng((0xF422, i)))
        assert _mutate(tm, np.random.default_rng((0xF422, i))) == label
        want = _jax_kind(jsys, claims, jm, False, monkeypatch)
        want_pq = _jax_kind(jsys, claims, jm, True, monkeypatch)
        got = _port_kind(tsys, tclaims, tm, per_query=False)
        got_pq = _port_kind(tsys, tclaims, tm, per_query=True)
        assert (got, got_pq) == (want, want_pq), f"mutant {i} ({label})"
        assert (got == "accepted") == (got_pq == "accepted"), f"mutant {i} ({label})"
        assert got == "accepted" and label == "noop" or got != "accepted", f"mutant {i} ({label}) verified"
        kinds[label, got] = kinds.get((label, got), 0) + 1
    assert sum(n for (label, k), n in kinds.items() if k != "accepted") >= 0.8 * (N_MUTANTS // CHUNKS)


def test_valid_proof_and_wrong_claim(u32_add, monkeypatch):
    jsys, tsys, claims, tclaims, data = u32_add
    _check_parity(jsys, tsys, claims, tclaims, data, monkeypatch, want="accepted")
    wrong = [list(c) for c in claims]
    wrong[3][1] ^= 1
    bad = np.asarray(wrong, np.uint64)
    jk = _jax_kind(jsys, wrong, JaxProof.from_bytes(data, jsys), False, monkeypatch)
    assert jk != "accepted"
    proof = Proof.from_bytes(data, tsys)
    assert _port_kind(tsys, bad, proof, per_query=False) == jk
    assert _port_kind(tsys, bad, proof, per_query=True) == jk
    assert _port_kind(tsys, bad[:-1], proof, per_query=False) == _jax_kind(
        jsys, wrong[:-1], JaxProof.from_bytes(data, jsys), False, monkeypatch)


def test_tampered_bytes_match_jax(u32_add, monkeypatch):
    """A flipped byte in the opened-values region: both readers take it, and
    both verifiers reject it with the same kind (tests/test_verify_batched.py)."""
    jsys, tsys, claims, tclaims, data = u32_add
    blob = bytearray(data)
    blob[len(blob) // 2] ^= 1
    assert _check_parity(jsys, tsys, claims, tclaims, bytes(blob), monkeypatch) != "accepted"


# --- the lookup systems of tests/test_e2e_lookups.py ---------------------------

def _lookup_inputs(ex, cls, with_z: bool):
    """A preprocessed square table, a circuit pushing (1, x, x^2) and pulling
    the claims (2, x, x^2), a circuit left empty; with_z adds a circuit
    pulling the claims (3, z)."""
    table = np.asarray([[x, x * x] for x in range(8)], np.uint64)
    inputs = [
        cls(main_width=1, constraints=[], ext_constraints=[],
            lookups=[ex.Lookup.pull(ex.main(0), [ex.Const(1), ex.preprocessed(0), ex.preprocessed(1)])],
            preprocessed=table),
        cls(main_width=2, constraints=[], ext_constraints=[],
            lookups=[ex.Lookup.push(ex.Const(1), [ex.Const(1), ex.main(0), ex.main(1)]),
                     ex.Lookup.pull(ex.Const(1), [ex.Const(2), ex.main(0), ex.main(1)])]),
        cls(main_width=1, constraints=[ex.main(0) * ex.main(0) - ex.main(0)], ext_constraints=[], lookups=[]),
    ]
    if with_z:
        inputs.append(cls(main_width=1, constraints=[], ext_constraints=[],
                          lookups=[ex.Lookup.pull(ex.Const(1), [ex.Const(3), ex.main(0)])]))
    return inputs


@pytest.mark.parametrize("case", ["sparse activation", "ragged claims"])
def test_lookup_systems_match_jax(case, monkeypatch):
    """The sparse-activation system (an empty circuit, inactive in the
    proof) and the same system with ragged claims ((2, x, x^2) x 4 and
    (3, z) x 2): both verifiers accept; a changed claim and a dropped claim
    are rejected by both with the same kind."""
    ragged = case == "ragged claims"
    xs, zs = (3, 5, 2, 3), ((11, 1 << 40) if ragged else ())
    mult = np.zeros((8, 1), np.uint64)
    for x in xs:
        mult[x] += 1
    traces = [mult, np.asarray([[x, x * x] for x in xs], np.uint64), np.zeros((0, 1), np.uint64)]
    claims = [[2, x, x * x] for x in xs]
    if ragged:
        traces.append(np.asarray([[z] for z in zs], np.uint64))
        claims += [[3, z] for z in zs]
    fri = (0, 1, 6, 4, 4)
    jsys, tsys, tclaims, data = _proved("goldilocks", _lookup_inputs(jex, JaxInputs, ragged),
                                        _lookup_inputs(tex, CircuitInputs, ragged), traces, claims, fri=fri)
    assert Proof.from_bytes(data, tsys).active == [True, True, False] + ([True] if ragged else [])
    _check_parity(jsys, tsys, claims, tclaims, data, monkeypatch, want="accepted")
    for bad in ([c[:] for c in claims], claims[1:]):
        if len(bad) == len(claims):
            bad[-1][-1] += 1
        _, bad_t = mt.witness_from_numpy([], bad, "cpu")
        jk = _jax_kind(jsys, bad, JaxProof.from_bytes(data, jsys), False, monkeypatch)
        assert jk != "accepted"
        assert _port_kind(tsys, bad_t, Proof.from_bytes(data, tsys), per_query=False) == jk
        assert _port_kind(tsys, bad_t, Proof.from_bytes(data, tsys), per_query=True) == jk


# --- the setup guards' systems (tests/test_system_guards.py) -------------------

def _degree5(ex, cls):
    x = ex.main(0)
    return [cls(2, [x * x * x * x * x - ex.main(1)], [], [])]


def _mul(ex, cls):
    return [cls(main_width=3, constraints=[ex.main(0) * ex.main(1) - ex.main(2)], ext_constraints=[], lookups=[])]


def test_degree5_circuit_and_another_systems_proof(monkeypatch):
    """The degree-5 circuit accepted at blowup 4 by both verifiers; its proof
    checked against the mul system (same field, other widths) rejected by
    both with the same kind; and the port's System.new refuses the circuit
    at blowup 2 as the JAX package's does."""
    p = GOLDILOCKS.p
    trace = np.asarray([[x, pow(x, 5, p)] for x in (2, 3, 4, 5)], np.uint64)
    jsys, tsys, tclaims, data = _proved("goldilocks", _degree5(jex, JaxInputs), _degree5(tex, CircuitInputs), [trace],
                                        [], fri=(0, 1, 4, 1, 1))
    _check_parity(jsys, tsys, [], tclaims, data, monkeypatch, want="accepted")
    jmul, _ = JaxSystem.new(JaxGoldilocks(JaxCommit(2, 0), JaxFri(0, 1, 4, 1, 1)), _mul(jex, JaxInputs))
    tmul, _ = System.new(GoldilocksBlake3Config(CommitmentParameters(2, 0), FriParameters(0, 1, 4, 1, 1), device="cpu"),
                         _mul(tex, CircuitInputs))
    assert _check_parity(jmul, tmul, [], [], data, monkeypatch) == "InvalidProofShape"
    with pytest.raises(ValueError, match="raise log_blowup"):
        System.new(GoldilocksBlake3Config(CommitmentParameters(1, 0), FriParameters(0, 1, 4, 1, 1), device="cpu"),
                   _degree5(tex, CircuitInputs))


# --- BabyBearPoseidon2 ------------------------------------------------------------

def test_babybear_proof_matches_jax(monkeypatch):
    """A BabyBearPoseidon2 proof of the mul circuit (tests/test_verify_batched.py):
    accepted by both; a wrong claim and six mutants of the sweep rejected by
    the JAX package's walk (one query at a time for BabyBear) and the port's
    per-query walk with the same kind, and the port's batched walk rejects
    them too."""
    rng = np.random.default_rng(11)
    n = 32
    a = rng.integers(0, 1 << 30, n, dtype=np.uint64)
    b = rng.integers(0, 1 << 30, n, dtype=np.uint64)
    trace = np.stack([a, b, np.asarray((a.astype(object) * b.astype(object)) % BABYBEAR.p, np.uint64)], axis=1)
    jsys, tsys, tclaims, data = _proved("babybear", _mul(jex, JaxInputs), _mul(tex, CircuitInputs), [trace], [],
                                        fri=(0, 2, 4, 1, 1))
    _check_parity(jsys, tsys, [], tclaims, data, monkeypatch, want="accepted", jax_per_query=True)
    wrong = [[1]]
    jk = _jax_kind(jsys, wrong, JaxProof.from_bytes(data, jsys), True, monkeypatch)
    assert jk != "accepted"
    assert _port_kind(tsys, np.asarray(wrong, np.uint64), Proof.from_bytes(data, tsys), per_query=True) == jk
    jax_proof, port_proof = JaxProof.from_bytes(data, jsys), Proof.from_bytes(data, tsys)
    for i in (7, 9, 11, 15, 21, 40):  # opened rows, paths, fold rows, log degrees, ...
        jm, tm = copy.deepcopy(jax_proof), copy.deepcopy(port_proof)
        label = _mutate(jm, np.random.default_rng((0xBB, i)))
        assert _mutate(tm, np.random.default_rng((0xBB, i))) == label
        want = _jax_kind(jsys, [], jm, True, monkeypatch)
        assert _port_kind(tsys, [], tm, per_query=True) == want, f"mutant {i} ({label})"
        got = _port_kind(tsys, [], tm, per_query=False)
        assert (got == "accepted") == (want == "accepted"), f"mutant {i} ({label})"
