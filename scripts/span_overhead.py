"""What the provers' `stark/*` spans (multistark_tpu_torch/profiling.py) cost
a proof job on the card: the benchmark's jobs (bench_h100/run.py: a device
copy of the traces, SystemWitness.from_stage_1, prove_multiple_claims,
Proof.to_bytes, a synchronise) in three variants, in rounds within one
process, so that the card, its power limit and the host's load are the same
for all of them:

  on        the spans as they are (MULTISTARK_TEXRAY unset)
  off       every `span` the program opens replaced by a null context
  texray    MULTISTARK_TEXRAY set to a prefix that matches no span: each
            span also reads the host memory, and prints nothing

    python3 scripts/span_overhead.py [--workload CELL ...] [--rounds N] [--seed N]

Cells are BENCHMARK.json's (default: u32add_gl.rows2e20, blake3_gl.msg256k).
Each cell: the benchmark's set-up (its seeded pool on the card, a cold job
per input), then N rounds of one job per variant, the order rotating
between rounds.  Prints per cell and variant the median and quartiles of
the jobs' seconds and, against "off", the median of the rounds'
differences and how many rounds took longer; the spans a job opens; the
seconds a job spends in the memory reads under "texray" (each read timed);
and one empty span's enter and exit in each of "on" and "texray", and a
bare `torch.profiler.record_function`'s, a mean over 20000 with no job
running.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "bench_h100")
sys.path[:0] = [ROOT, BENCH]

import run as harness  # noqa: E402  (bench_h100/run.py)
from multistark_tpu_torch import dt_prover, merkle, pcs, profiling, prover, system, utils  # noqa: E402

SPANNED = (prover, pcs, dt_prover, system, utils, merkle)  # the modules that open stark/* spans
QUIET = "nothing/"  # a MULTISTARK_TEXRAY prefix that matches no span
EMPTY_SPANS = 20000


@contextlib.contextmanager
def patched(pairs):
    """Each (object, attribute) of `pairs` set to its stand-in, restored after."""
    saved = [getattr(obj, attr) for obj, attr, _ in pairs]
    for obj, attr, value in pairs:
        setattr(obj, attr, value)
    try:
        yield
    finally:
        for (obj, attr, _), value in zip(pairs, saved):
            setattr(obj, attr, value)


@contextlib.contextmanager
def texray(read_seconds: list):
    """MULTISTARK_TEXRAY at a prefix that matches nothing, each memory read timed."""
    memory = profiling._memory_mib

    def timed():
        t0 = time.perf_counter()
        try:
            return memory()
        finally:
            read_seconds.append(time.perf_counter() - t0)

    os.environ["MULTISTARK_TEXRAY"] = QUIET
    try:
        with patched([(profiling, "_memory_mib", timed)]):
            yield
    finally:
        del os.environ["MULTISTARK_TEXRAY"]


def variants(read_seconds: list) -> dict:
    return {
        "on": contextlib.nullcontext,
        "off": lambda: patched([(m, "span", lambda name: contextlib.nullcontext()) for m in SPANNED]),
        "texray": lambda: texray(read_seconds),
    }


def empty_span_us(span=profiling.span) -> float:
    """One empty span's enter and exit, a mean over EMPTY_SPANS."""
    profiling.reset_spans()
    t0 = time.perf_counter()
    for _ in range(EMPTY_SPANS):
        with span("stark/empty"):
            pass
    profiling.reset_spans()
    return (time.perf_counter() - t0) / EMPTY_SPANS * 1e6


def measure(name: str, program, pool: int, rounds: int) -> None:
    """N rounds of one job per variant on `program` (a harness.Program whose
    cold jobs have run), printed as the module docstring says."""
    reads: list = []
    var = variants(reads)
    names = list(var)
    secs = {v: [] for v in names}
    gc.collect()
    for i in range(rounds):
        for v in names[i % len(names):] + names[:i % len(names)]:
            with var[v]():
                t0 = time.perf_counter()
                program.job(i % pool)  # ends in a synchronise
                secs[v].append(time.perf_counter() - t0)
    profiling.reset_spans()
    program.job(0)
    opened = profiling.span_counts()
    profiling.reset_spans()
    print(f"[span_overhead] {name}: a job opens {sum(opened.values())} spans {opened}", flush=True)
    r = np.asarray(reads)
    print(f"[span_overhead] {name} texray: {len(r)} memory reads, {1e3 * r.sum() / rounds:.3f} ms a job, median "
          f"{1e6 * np.median(r):.1f} us, max {1e6 * r.max():.1f} us", flush=True)
    off = np.asarray(secs["off"])
    for v in names:
        a = np.asarray(secs[v])
        vs = "" if v == "off" else (f"; against off: median {1e3 * np.median(a - off):+.3f} ms, longer in "
                                    f"{int((a > off).sum())} of {rounds} rounds")
        print(f"[span_overhead] {name} {v}: median {np.median(a):.4f} s (quartiles {np.percentile(a, 25):.4f}-"
              f"{np.percentile(a, 75):.4f}){vs}", flush=True)
    with var["texray"]():
        quiet_us = empty_span_us()
    print(f"[span_overhead] {name}: one empty span {empty_span_us():.2f} us on, {quiet_us:.2f} us under texray, "
          f"a bare torch.profiler.record_function {empty_span_us(torch.profiler.record_function):.2f} us (mean of "
          f"{EMPTY_SPANS}, no job running)", flush=True)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", nargs="+", default=["u32add_gl.rows2e20", "blake3_gl.msg256k"])
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--seed", type=int, default=20261018)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("span_overhead: needs a CUDA device")
    print(f"[span_overhead] {harness.power_limit()}", flush=True)
    os.environ.pop("MULTISTARK_TEXRAY", None)
    torch.set_num_threads(1)  # as the benchmark runs
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    for name in args.workload:
        cell = harness.Cell.load(manifest, name, False)
        host_pool = harness.make_pool(cell, args.seed)
        program = harness.Program(cell, host_pool)
        for k in range(len(host_pool)):
            program.job(k)  # cold: programs, host tables
        measure(name, program, len(host_pool), args.rounds)
        del program
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
