"""The port's stage spans (multistark_tpu_torch/profiling.py) against the JAX
package's (multistark_tpu/profiling.py) on the CPU: the same nested spans
give the same names, counts, nesting order and streamed `[texray]` lines,
and a prove records the JAX package's `stark/*` spans on both
GoldilocksBlake3 transcripts and on BabyBearPoseidon2.  Tolerance: exact
(times and memory are not compared, only their keys)."""

import contextlib
import io
import os
import re

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
    _, jlines = _run(jprof, lambda: _nested(jprof, fail), None)
    _, tlines = _run(tprof, lambda: _nested(tprof, fail), None)
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
def test_span_memory_follows_rss(prof):
    """64 MiB touched inside a span and kept past it: both modules count
    the RSS change and the RSS at exit; freed inside another, no change."""
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
    """(system, key, witness) of the tiny mul-circuit prove in either package."""
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
    return config, system, key, Wit.from_stage_1([trace], system, key)


@pytest.fixture(scope="module")
def jax_spans():
    """Each JAX prove once, streamed under MULTISTARK_TEXRAY=stark/: its span
    counts in closing order, its streamed lines and its proof bytes."""
    out = {}
    for name in PROVES:
        config, system, key, witness = _tiny("jax", name)
        proof, lines = _run(jprof, lambda: system.prove(key, witness), "stark/")
        out[name] = (list(jprof._COUNTS.items()), lines, proof.to_bytes(config))
    jprof.reset_spans()
    return out


@pytest.mark.parametrize("path", ["goldilocks_blake3 device transcript", "goldilocks_blake3 host transcript",
                                  "babybear_poseidon2"])
def test_prove_records_the_jax_stage_spans(jax_spans, path):
    config_name = path.split()[0]
    config, system, key, witness = _tiny("torch", config_name, "cpu")
    host = path.endswith("host transcript")
    assert dt_prover.eligible(config) == (config_name == "goldilocks_blake3")
    dt.FALLBACKS.clear()
    prove = prove_host_transcript if host else prove_multiple_claims
    proof, lines = _run(tprof, lambda: prove(system, key, witness, []), "stark/")
    assert not dt.FALLBACKS, dict(dt.FALLBACKS)
    counts, jlines, jbytes = jax_spans[config_name]
    assert list(tprof.span_counts().items()) == counts == [(s, 1) for s in STAGES]
    assert lines == jlines
    assert list(tprof.span_memory()) == STAGES
    assert tprof._STACK == []
    assert proof.to_bytes() == jbytes
