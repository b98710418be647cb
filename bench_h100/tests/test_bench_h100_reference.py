"""The plain reference against the program's CPU path, and the correctness
decision of a run driven end to end on the CPU: sound runs come out
correct; the control (the program proving under a weaker guarantee than
the configuration states) and each fault a proof job can have come out
not correct."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

import run as harness
from plainref import blake3
from plainref.errors import VerificationError
from plainref.serialization import proof_from_bytes
from plainref.verifier import verify_multiple_claims

SMALL_FRI = dict(num_queries=4, commit_proof_of_work_bits=1, query_proof_of_work_bits=1)
EMPTY = bytes.fromhex("af1349b9f5f9a1a6a0404dea36dcc9499bcb25c9adc112b7cc9a93cae41f3262")


def cell(config: str, traffic: dict, **cfg_changes) -> harness.Cell:
    with open(os.path.join(BENCH, "configs", f"{config}.json")) as f:
        cfg = json.load(f)
    cfg.update(SMALL_FRI)
    cfg.update(cfg_changes)
    return harness.Cell({"name": "cpu", "chips": 1}, cfg, traffic, [])


CASES = {
    "u32add": lambda: cell("u32add_gl", {"rows": 64, "pool": 2}),
    "blake3": lambda: cell("blake3_gl", {"message_bytes": 1100, "pool": 2}, limb_bits=4),
}


def test_blake3_against_known_digests():
    assert blake3.hash_bytes(b"") == EMPTY
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 256, (3, 2049), dtype=np.uint8)
    one = [blake3.hash_bytes(r.tobytes()) for r in rows]
    assert [blake3.hash_many(rows)[i].astype("<u4").tobytes() for i in range(3)] == one


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_accepts_the_program_and_agrees_on_the_key(case):
    c = CASES[case]()
    pool = harness.make_pool(c, 11)
    program = harness.Program(c, pool, "cpu")
    ref = harness.reference_system(c)
    assert np.array_equal(ref.preprocessed_commit, program.system.preprocessed_commit)
    data = program.job(0)
    claims = pool[0][1]
    verify_multiple_claims(ref, claims, proof_from_bytes(data, 2))
    tampered = bytearray(data)
    tampered[len(data) // 3] ^= 4
    with pytest.raises(VerificationError):
        verify_multiple_claims(ref, claims, proof_from_bytes(bytes(tampered), 2))
    other = claims.copy()
    other[-1, 1] ^= 1
    with pytest.raises(VerificationError):
        verify_multiple_claims(ref, other, proof_from_bytes(data, 2))


@pytest.mark.parametrize("config", ["u32add_gl", "blake3_gl"])
def test_plain_evaluation_agrees_with_the_program_graph(config):
    """At the configuration's own sizes, the reference's constraint order,
    degrees and values at a random point (a recursive walk of the author's
    trees) against the program's compiled constraint graph, swept node by
    node here."""
    from multistark_tpu_torch.fields.host import ExtensionParams as ProgramExtension
    from multistark_tpu_torch.graph import compile_graph
    from plainref.constraints import evaluate
    from plainref.field_host import GOLDILOCKS_EXT2 as he
    from plainref.lookup import logup_max_degree

    c = cell(config, {})
    ref = harness.reference_system(c)
    rng = np.random.default_rng(5)

    def rand():
        return tuple(int(x) for x in rng.integers(0, he.base.p, 2, dtype=np.uint64))

    cells, publics = {}, [rand() for _ in range(8)]
    sel = type("Sel", (), {"is_first_row": rand(), "is_last_row": rand(), "is_transition": rand()})

    def leaf(source, col, off):
        return cells.setdefault((getattr(source, "value", source), col, off), rand())

    for circuit, ci in zip(ref.circuits, c.family.program_inputs(c.cfg)):
        g = compile_graph(he.base.p, ci.constraints, ci.ext_constraints, ci.lookups, ProgramExtension(2, 7, True))
        assert len(circuit.constraints.roots) == len(g.zeros)
        assert circuit.constraints.max_constraint_degree == g.max_constraint_degree
        assert logup_max_degree(circuit.constraints.lookup_degrees) == max(
            [1] + [max(max((g.degrees[a] for a in args), default=0) + 1, g.degrees[m]) for m, args in g.lookups])
        buf = []
        for op in g.nodes:
            k = op[0]
            buf.append(he.from_base(op[1]) if k == "c" else leaf(*op[1:]) if k == "v" else publics[op[1]] if k == "p"
                       else {"first": sel.is_first_row, "last": sel.is_last_row, "trans": sel.is_transition}[k]
                       if k in ("first", "last", "trans") else he.neg(buf[op[1]]) if k == "neg"
                       else {"add": he.add, "sub": he.sub, "mul": he.mul}[k](buf[op[1]], buf[op[2]]))
        memo: dict = {}
        plain = [evaluate(e, he, leaf, publics, sel, memo) for e in circuit.constraints.roots]
        assert plain == [buf[i] for i in g.zeros]
        for lk_, (m, args) in zip(circuit.lookups, g.lookups):
            assert evaluate(lk_.multiplicity, he, leaf, publics, sel, memo) == buf[m]
            assert [evaluate(a, he, leaf, publics, sel, memo) for a in lk_.args] == [buf[a] for a in args]


def verdict(c, monkeypatch, make_program=None, job=None):
    if make_program is not None:
        monkeypatch.setattr(harness, "Program", make_program)
    if job is not None:
        monkeypatch.setattr(harness.Program, "job", job)
    return harness.measure(c, 2 ** 31 + 7, 0.01, False, device="cpu")[2]


def test_sound_run_is_correct(monkeypatch):
    v = verdict(CASES["u32add"](), monkeypatch)
    assert v["rejected"] == 0 and v["distinct"] >= 1


def test_control_weaker_guarantee_is_not_correct(monkeypatch):
    """The control: the program proving without its proof-of-work grinds
    (0 + 0 bits where the configuration states 1 + 1 here, 10 + 10 in the
    cells), judged at the stated parameters."""
    c = CASES["u32add"]()
    weak = cell("u32add_gl", c.traffic, commit_proof_of_work_bits=0, query_proof_of_work_bits=0)
    program = harness.Program
    v = verdict(c, monkeypatch, make_program=lambda _cell, pool, device: program(weak, pool, device))
    assert v["rejected"] == v["distinct"] >= 1


def test_fault_answer_altered_is_not_correct(monkeypatch):
    job = harness.Program.job

    def altered(self, k, witness_times=None):
        data = bytearray(job(self, k, witness_times))
        data[-9] ^= 1  # an opened value of the last stage-2 matrix
        return bytes(data)

    v = verdict(CASES["u32add"](), monkeypatch, job=altered)
    assert v["rejected"] == v["distinct"] >= 1


def test_fault_half_the_claims_left_out_is_not_correct(monkeypatch):
    """The prover is handed the first half of the job's claims: its proof
    can only be of those, and the reference holds it to all of them."""
    original = harness.Program.__init__

    def halve(self, c, pool, device="cuda"):
        original(self, c, pool, device)
        self.pool = [(traces, claims[: len(claims) // 2]) for traces, claims in self.pool]

    monkeypatch.setattr(harness.Program, "__init__", halve)
    v = verdict(CASES["u32add"](), monkeypatch)
    assert v["rejected"] == v["distinct"] >= 1


def test_harness_loads_no_jax():
    """A run's process, driven on the CPU, loads neither JAX nor the JAX
    package (whole top-level names)."""
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import json, run as h\n"
            "cfg = dict(json.load(open(%r)), num_queries=2, commit_proof_of_work_bits=0, query_proof_of_work_bits=0)\n"
            "c = h.Cell({'name': 'cpu', 'chips': 1}, cfg, {'rows': 16, 'pool': 1}, [])\n"
            "h.measure(c, 5, 0.01, False, device='cpu')\n"
            "print(h.forbidden_modules())\n") % (BENCH, ROOT, os.path.join(BENCH, "configs", "u32add_gl.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.card
def test_cell_on_the_card():
    """One short run of the first cell on the card, from the checkout's root."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark runs only on the card")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        first = json.load(f)["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "bench_h100/run.py", "--workload", first, "--seed", "3", "--seconds", "2",
                          "--trace", "0"], capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
