"""Where a prove's time goes on the card: per-stage spans and the device's
busy share, for the bench workload under either config.

    python3 -m multistark_tpu_torch.spans [--config NAME ...] [--log-n N ...] [--proves K]

For each config and size it builds the system and witness, runs one cold
prove, then K warm proves with every stage below wrapped in a host-clock
span that synchronises the device on both sides (so device work lands in
the stage that queued it), and prints the last warm prove's spans.  Then
one more warm prove runs under `torch.profiler`, and the device's busy time
(the sum of the kernels' own device time) is printed beside the median wall
time of the warm proves.  Needs a CUDA device; the spans add a synchronise per stage,
so their sum exceeds an unwrapped prove by a little.

Spans nest: a commit contains its Merkle tree; the FRI commit phase
contains the level trees and the PoW grinds; "host duplex" is every
other challenger call (observe, sample), counted once where they nest.
"""

from __future__ import annotations

import argparse
import functools
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from . import lookup, prover
from .challenger import DuplexChallenger, SerializingChallenger64
from .config import CommitmentParameters, FriParameters
from .configs import BabyBearPoseidon2Config, GoldilocksBlake3Config
from .system import System, SystemWitness
from .test_circuits import u32_add_system_inputs, u32_add_witness

CONFIGS = {"goldilocks_blake3": GoldilocksBlake3Config, "babybear_poseidon2": BabyBearPoseidon2Config}
WITNESS_SEED = 0xDEADBEEF  # bench.py u32_add_case
_CHALLENGER_METHODS = ("observe_field", "observe_u64", "observe_ext", "observe_bytes", "observe_commitment",
                       "observe_claims", "sample_field", "sample_ext", "sample_bits", "grind")


class Spans:
    """Inclusive seconds per span name, with a synchronise on both sides."""

    def __init__(self):
        self.seconds = defaultdict(float)
        self._depth = defaultdict(int)

    def wrap(self, name: str, fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            if self._depth[name]:  # a nested call of the same span counts once
                return fn(*args, **kwargs)
            self._depth[name] += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                self.seconds[name] += time.perf_counter() - t0
                self._depth[name] -= 1
        return timed


def instrument(config, spans: Spans):
    """Wrap the prover's stages in spans (module functions, the config's PCS
    and Merkle instances, and the challenger classes)."""
    pcs = config.pcs
    prover._observe_claims = spans.wrap("observe claims (host)", prover._observe_claims)
    lookup.claims_accumulator = spans.wrap("claims accumulator (host)", lookup.claims_accumulator)
    lookup.stage_2_traces = spans.wrap("stage-2 traces", lookup.stage_2_traces)
    prover._quotient_chunk_coeffs = spans.wrap("quotient sweep + iDFT", prover._quotient_chunk_coeffs)
    for attr, name in (("commit", "stage commits (LDE + tree)"), ("commit_from_coeffs", "quotient commit"),
                       ("_claimed_evaluations", "claimed evaluations"), ("_reduced_openings", "reduced openings"),
                       ("_commit_phase", "FRI commit phase"), ("_query_phase", "query phase")):
        setattr(pcs, attr, spans.wrap(name, getattr(pcs, attr)))
    pcs.mmcs.commit = spans.wrap("Merkle trees", pcs.mmcs.commit)
    for cls in (DuplexChallenger, SerializingChallenger64):
        for meth in _CHALLENGER_METHODS:
            fn = getattr(cls, meth, None)
            if fn is not None and not hasattr(fn, "__wrapped__"):  # classes are wrapped once
                setattr(cls, meth, spans.wrap("PoW grinds (host)" if meth == "grind" else "host duplex", fn))


def bench_inputs(log_n: int, device):
    n = 1 << log_n
    rng = np.random.default_rng(WITNESS_SEED)
    xs = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    ys = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    from . import witness_from_numpy

    return witness_from_numpy(*u32_add_witness(list(zip(xs.tolist(), ys.tolist())), n), device)


def device_busy_seconds(run) -> float:
    """Sum of the kernels' own device time over `run()`, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    total_us = 0.0
    for evt in prof.key_averages():
        total_us += getattr(evt, "self_device_time_total", getattr(evt, "self_cuda_time_total", 0.0))
    return total_us / 1e6


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", nargs="+", default=list(CONFIGS), choices=list(CONFIGS))
    ap.add_argument("--log-n", nargs="+", type=int, default=[14, 18])
    ap.add_argument("--proves", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("spans: needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(f"[spans] {torch.cuda.get_device_name(0)}", flush=True)
    spans = Spans()  # one for every config: the challenger classes are wrapped once
    for name in args.config:
        config = CONFIGS[name](
            CommitmentParameters(log_blowup=2, cap_height=0),
            FriParameters(log_final_poly_len=0, max_log_arity=1, num_queries=100,
                          commit_proof_of_work_bits=10, query_proof_of_work_bits=10),
            device=dev,
        )
        instrument(config, spans)
        system, key = System.new(config, u32_add_system_inputs())
        for log_n in args.log_n:
            traces, claims = bench_inputs(log_n, dev)
            witness = SystemWitness.from_stage_1(traces, system, key)

            def run():
                return prover.prove_multiple_claims(system, key, witness, claims)

            run()  # cold: host tables
            walls = []
            for _ in range(args.proves):
                spans.seconds.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            for span, secs in sorted(spans.seconds.items(), key=lambda kv: -kv[1]):
                print(f"[spans] {name} log_n={log_n} {span}: {secs:.4f} s", flush=True)
            print(f"[spans] {name} log_n={log_n} warm prove with spans, {args.proves} runs: "
                  + ", ".join(f"{w:.4f}" for w in walls) + " s", flush=True)
            busy = device_busy_seconds(run)
            wall = float(np.median(walls))  # the profiler's own overhead would swamp its prove's wall time
            print(f"[spans] {name} log_n={log_n} profiled prove: device busy {busy:.4f} s against the "
                  f"median warm prove of {wall:.4f} s ({100 * (1 - busy / wall):.1f}% idle)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
