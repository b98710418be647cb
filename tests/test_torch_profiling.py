"""The port's stage spans (multistark_tpu_torch/profiling.py) against the JAX
package's (multistark_tpu/profiling.py) on the CPU: the same nested spans
give the same names, counts, nesting order and streamed `[texray]` lines,
and a prove records the JAX package's `stark/*` spans on both
GoldilocksBlake3 transcripts and on BabyBearPoseidon2, with the port's own
five (each a leaf or outside `stark/prove`) beside them.  Without
MULTISTARK_TEXRAY a span reads no host memory.  Tolerance: exact (times and
memory are not compared, only their keys)."""

import contextlib
import io
import os
import re
import resource

import numpy as np
import pytest

import multistark_tpu_torch as mt
from multistark_tpu import expr as jex
from multistark_tpu import profiling as jprof
from multistark_tpu.config import CommitmentParameters as JaxCommit, FriParameters as JaxFri
from multistark_tpu.configs import BabyBearPoseidon2Config as JaxBB, GoldilocksBlake3Config as JaxGL
from multistark_tpu.system import CircuitInputs as JaxInputs, System as JaxSystem, SystemWitness as JaxWitness
from multistark_tpu_torch import device_transcript as dt, dt_prover
from multistark_tpu_torch import expr as tex
from multistark_tpu_torch import profiling as tprof
from multistark_tpu_torch.config import CommitmentParameters, FriParameters
from multistark_tpu_torch.configs import BabyBearPoseidon2Config, GoldilocksBlake3Config
from multistark_tpu_torch.prover import prove_host_transcript, prove_multiple_claims
from multistark_tpu_torch.system import CircuitInputs, System, SystemWitness

TEXRAY = re.compile(r"^\[texray\] ( *)(\S+): [0-9.]+ms ── RAM Δ [+-][0-9]+MiB peakΔ \+[0-9]+MiB$")
STAGES = ["stark/stage1_commit", "stark/lookup_construction", "stark/stage2_commit", "stark/quotient",
          "stark/fri_open/eval", "stark/fri_open/ro", "stark/fri_open/fold", "stark/fri_open/queries",
          "stark/fri_open", "stark/prove"]
# the port's own spans a job opens (witness, prove, to_bytes), per prove path
PORT_SPANS = {
    "goldilocks_blake3 device transcript": {"stark/witness": 1, "stark/claims": 1, "stark/fetch": 2,
                                            "stark/replay": 1, "stark/to_bytes": 1},
    "goldilocks_blake3 host transcript": {"stark/witness": 1, "stark/claims": 1, "stark/fetch": 4,
                                          "stark/to_bytes": 1},
    "babybear_poseidon2": {"stark/witness": 1, "stark/claims": 1, "stark/fetch": 3, "stark/to_bytes": 1},
}
QUIET = "nothing/"  # MULTISTARK_TEXRAY prefix that matches no span: memory readings on, no lines
# the tiny prove of multistark_tpu/fixtures.py:135 (GoldilocksBlake3, 32 rows),
# and BabyBearPoseidon2 at 8 rows with a cap of 4 digests and one FRI round
# (few Poseidon2 trees: the JAX side hashes them eagerly)
PROVES = {
    "goldilocks_blake3": (dict(log_blowup=2, cap_height=0),
                          dict(log_final_poly_len=0, max_log_arity=1, num_queries=4, commit_proof_of_work_bits=1,
                               query_proof_of_work_bits=1), 5),
    "babybear_poseidon2": (dict(log_blowup=1, cap_height=2),
                           dict(log_final_poly_len=2, max_log_arity=2, num_queries=2, commit_proof_of_work_bits=0,
                                query_proof_of_work_bits=0), 3),
}


def _nested(prof, fail: bool):
    """A fixed sequence of nested spans, one name repeated at two depths, and
    (fail) an exception through two of them."""
    with prof.span("stark/prove"):
        with prof.span("stark/stage1_commit"):
            pass
        with prof.span("other/inner"):
            with prof.span("stark/stage1_commit"):
                pass
        with prof.span("a/leaf"):
            pass
    if fail:
        with pytest.raises(ZeroDivisionError):
            with prof.span("stark/outer"):
                with prof.span("a/raises"):
                    1 // 0


def _streamed(text: str):
    """(indent, name) of each [texray] line, in order; every line must have
    the JAX format."""
    out = []
    for line in text.splitlines():
        if line.startswith("[texray]"):
            m = TEXRAY.match(line)
            assert m, line
            out.append((len(m.group(1)), m.group(2)))
    return out


def _run(prof, fn, env):
    old = os.environ.pop("MULTISTARK_TEXRAY", None)
    if env is not None:
        os.environ["MULTISTARK_TEXRAY"] = env
    buf = io.StringIO()
    try:
        prof.reset_spans()
        with contextlib.redirect_stdout(buf):
            result = fn()
    finally:
        os.environ.pop("MULTISTARK_TEXRAY", None)
        if old is not None:
            os.environ["MULTISTARK_TEXRAY"] = old
    return result, _streamed(buf.getvalue())


@pytest.mark.parametrize("fail", [False, True])
def test_nested_spans_match_jax(fail):
    _, jlines = _run(jprof, lambda: _nested(jprof, fail), QUIET)
    _, tlines = _run(tprof, lambda: _nested(tprof, fail), QUIET)
    assert jlines == tlines == []
    assert list(tprof.span_times()) == list(jprof.span_times())
    assert tprof.span_counts() == jprof._COUNTS
    assert tprof.span_counts()["stark/stage1_commit"] == 2
    assert list(tprof.span_memory()) == list(jprof.span_memory())
    for m in tprof.span_memory().values():
        assert set(m) == {"rss_delta_mib", "hwm_rise_mib", "rss_mib"} and m["hwm_rise_mib"] >= 0
    assert tprof._STACK == jprof._STACK == []
    tprof.reset_spans()
    jprof.reset_spans()
    assert tprof.span_times() == jprof.span_times() == {}
    assert tprof.span_memory() == jprof.span_memory() == {}
    assert tprof.span_counts() == jprof._COUNTS == {}


@pytest.mark.parametrize("prof", [jprof, tprof], ids=["jax", "port"])
def test_span_memory_follows_rss(prof, monkeypatch):
    """64 MiB touched inside a span and kept past it: both modules count
    the RSS change and the RSS at exit; freed inside another, no change
    (the port reads memory under MULTISTARK_TEXRAY only)."""
    monkeypatch.setenv("MULTISTARK_TEXRAY", QUIET)
    prof.reset_spans()
    with prof.span("stark/alloc"):
        held = np.ones(64 << 17)  # 64 MiB of float64, written
    with prof.span("stark/transient"):
        np.ones(64 << 17).sum()
    mem = prof.span_memory()
    assert mem["stark/alloc"]["rss_delta_mib"] >= 48
    assert mem["stark/alloc"]["rss_mib"] >= mem["stark/alloc"]["rss_delta_mib"]
    assert abs(mem["stark/transient"]["rss_delta_mib"]) < 48
    assert held.size and all(m["hwm_rise_mib"] >= 0 for m in mem.values())
    prof.reset_spans()


@pytest.mark.parametrize("env", [None, "stark/", "", "a/,stark/"], ids=["unset", "stark", "empty", "two"])
def test_texray_lines_match_jax(env):
    _, jlines = _run(jprof, lambda: _nested(jprof, True), env)
    _, tlines = _run(tprof, lambda: _nested(tprof, True), env)
    assert tlines == jlines
    names = {name for _, name in tlines}
    if env is None:
        assert not tlines
    else:
        assert {"stark/prove", "stark/stage1_commit", "stark/outer"} <= names and "other/inner" not in names
        assert ("a/leaf" in names) == (env == "a/,stark/")
        assert (2, "stark/stage1_commit") in tlines  # inside other/inner


def _tiny(pkg: str, config_name: str, device=None):
    """(config, system, key, a function that builds the witness) of the tiny mul-circuit
    prove in either package."""
    commit, fri, log_n = PROVES[config_name]
    if pkg == "jax":
        ex, Inputs, Sys, Wit = jex, JaxInputs, JaxSystem, JaxWitness
        cls = {"goldilocks_blake3": JaxGL, "babybear_poseidon2": JaxBB}[config_name]
        config = cls(JaxCommit(**commit), JaxFri(**fri))
    else:
        ex, Inputs, Sys, Wit = tex, CircuitInputs, System, SystemWitness
        cls = {"goldilocks_blake3": GoldilocksBlake3Config, "babybear_poseidon2": BabyBearPoseidon2Config}[config_name]
        config = cls(CommitmentParameters(**commit), FriParameters(**fri), device=device)
    system, key = Sys.new(config, [Inputs(main_width=3, constraints=[ex.main(0) * ex.main(1) - ex.main(2)],
                                          ext_constraints=[], lookups=[])])
    p = config.host_field.p
    rng = np.random.default_rng(42)
    a = rng.integers(0, 1 << 31, 1 << log_n, dtype=np.uint64) % np.uint64(p)
    b = rng.integers(0, 1 << 31, 1 << log_n, dtype=np.uint64) % np.uint64(p)
    trace = np.stack([a, b, np.asarray((a.astype(object) * b.astype(object)) % p, np.uint64)], axis=1)
    if pkg != "jax":
        (trace,), _ = mt.witness_from_numpy([trace], [], device)
    return config, system, key, lambda: Wit.from_stage_1([trace], system, key)


def _port_job(path: str):
    """One job of the port on `path`'s prove (the witness, the prove,
    `to_bytes`), as a function that returns the proof bytes."""
    config_name = path.split()[0]
    _, system, key, witness = _tiny("torch", config_name, "cpu")
    prove = prove_host_transcript if path.endswith("host transcript") else prove_multiple_claims
    return lambda: prove(system, key, witness(), []).to_bytes()


def _ancestors(lines, i):
    """The names of the spans open around [texray] line i (lines in closing
    order: a span's children close right before it, one level deeper)."""
    out, depth = [], lines[i][0]
    for d, name in lines[i + 1:]:
        if d < depth:
            out.append(name)
            depth = d
    return out


def _is_leaf(lines, i):
    return i == 0 or lines[i - 1][0] <= lines[i][0]


@pytest.fixture(scope="module")
def jax_spans():
    """Each JAX prove once, streamed under MULTISTARK_TEXRAY=stark/: its span
    counts in closing order, its streamed lines and its proof bytes."""
    out = {}
    for name in PROVES:
        config, system, key, witness = _tiny("jax", name)
        witness = witness()
        proof, lines = _run(jprof, lambda: system.prove(key, witness), "stark/")
        out[name] = (list(jprof._COUNTS.items()), lines, proof.to_bytes(config))
    jprof.reset_spans()
    return out


@pytest.mark.parametrize("path", list(PORT_SPANS))
def test_prove_records_the_jax_stage_spans(jax_spans, path):
    """A job's spans: filtered to the JAX package's ten, its counts, closing
    order and [texray] lines; the rest the port's own at the path's counts,
    each a leaf or outside stark/prove."""
    config_name = path.split()[0]
    assert dt_prover.eligible(_tiny("torch", config_name, "cpu")[0]) == (config_name == "goldilocks_blake3")
    dt.FALLBACKS.clear()
    data, lines = _run(tprof, _port_job(path), "stark/")
    assert not dt.FALLBACKS, dict(dt.FALLBACKS)
    counts, jlines, jbytes = jax_spans[config_name]
    got = tprof.span_counts()
    assert [(s, n) for s, n in got.items() if s in STAGES] == counts == [(s, 1) for s in STAGES]
    assert {s: n for s, n in got.items() if s not in STAGES} == PORT_SPANS[path]
    assert [line for line in lines if line[1] in STAGES] == jlines
    assert sorted(name for _, name in lines if name not in STAGES) == sorted(
        s for s, n in PORT_SPANS[path].items() for _ in range(n))
    for i, (_, name) in enumerate(lines):
        if name not in STAGES:
            assert _is_leaf(lines, i) or "stark/prove" not in _ancestors(lines, i), (name, _ancestors(lines, i))
    assert [s for s in tprof.span_memory() if s in STAGES] == STAGES
    assert set(tprof.span_memory()) == set(STAGES) | set(PORT_SPANS[path])
    assert tprof._STACK == []
    assert data == jbytes


@pytest.mark.parametrize("path", list(PORT_SPANS))
def test_default_spans_read_no_memory(path, monkeypatch):
    """With MULTISTARK_TEXRAY unset, neither a span nor a whole job reads
    /proc or calls getrusage; under a prefix that matches nothing, a span
    reads its memory and prints nothing."""
    calls = []
    pread, getrusage = os.pread, resource.getrusage
    monkeypatch.setattr(os, "pread", lambda *a: calls.append("pread") or pread(*a))
    monkeypatch.setattr(resource, "getrusage", lambda *a: calls.append("getrusage") or getrusage(*a))
    job = _port_job(path)

    def spans():
        with tprof.span("stark/one"):
            pass
        return job()

    _, lines = _run(tprof, spans, None)
    assert calls == [] and lines == []
    assert tprof.span_counts()["stark/prove"] == tprof.span_counts()["stark/one"] == 1
    assert tprof.span_memory() == {}
    _, lines = _run(tprof, spans, QUIET)
    assert "pread" in calls and lines == []
    assert set(tprof.span_memory()) == set(tprof.span_counts())
    tprof.reset_spans()


@pytest.mark.parametrize("path", ["goldilocks_blake3 device transcript", "goldilocks_blake3 host transcript"])
def test_witness_and_to_bytes_once_a_job_outside_the_prove(path):
    """Two jobs: `stark/witness` and `stark/to_bytes` close once a job, at
    the top level, the witness before the job's `stark/prove` and
    `to_bytes` after it."""
    job = _port_job(path)
    _, lines = _run(tprof, lambda: (job(), job()), "stark/")
    top = [name for depth, name in lines if depth == 0]
    assert top == ["stark/witness", "stark/prove", "stark/to_bytes"] * 2
    counts = tprof.span_counts()
    assert counts["stark/witness"] == counts["stark/to_bytes"] == counts["stark/prove"] == 2
    tprof.reset_spans()
