"""Where a prove's time goes on the card: per-stage spans and the device's
busy share, for the bench workload under either config, and for
GoldilocksBlake3 along both of its paths side by side.

    python3 -m multistark_tpu_torch.spans [--config NAME ...] [--log-n N ...] [--proves K]

Paths: GoldilocksBlake3 through `prove_multiple_claims` (the device
transcript, "dt") and through `prove_host_transcript` ("host");
BabyBearPoseidon2 through `prove_multiple_claims` (its host transcript).
First, for each path and size, it builds the system and witness, runs one
cold prove, then K warm proves with nothing wrapped, and prints their wall
times (host clock ending in a synchronise).  Then one more warm prove
runs under `torch.profiler` (its capture window open 20 ms on both sides,
and a kernel whose events fall short of its wrapper's launches says so):
the device's busy time (the events that ran
on the card, kernels and copies) is printed beside the median unwrapped
warm prove, and each kernel's device time and launches in that prove
(K1-K15 by their CUDA functions, `kernels.CudaKernel.functions`;
PyTorch's own kernels and copies together), each kernel's beside the least
time the card could take for its launches in that prove (the bytes and
operations each launch site states, `kernels.CudaKernel.bound_ms`).  Last,
it wraps every stage
below in a host-clock span that synchronises the device on both sides (so
device work lands in the stage that queued it; the spans therefore add
syncs the device transcript otherwise avoids), runs K warm proves again
and prints the last one's spans.  Needs a CUDA device.

Spans nest: a stage or quotient commit holds its LDEs and its whole tree
(K14 hashes and folds inside the LDE's last stages); the FRI commit phase
contains the first level's tree and the fold rounds (K10 writing each next
level, K15 its tree; "FRI round trees" in trees before the fold wrote the
next level) and the PoW grinds; "host
duplex" is every other host challenger call (observe, sample), counted
once where they nest, "device duplex" every DeviceDuplex call; the
device transcript's "global fetch + host replay" contains the replay's
host duplex calls.
"""

from __future__ import annotations

import argparse
import functools
import re
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from . import dt_prover, kernels, lookup, prover
from .challenger import DuplexChallenger, SerializingChallenger64
from .device_transcript import DeviceDuplex
from .config import CommitmentParameters, FriParameters
from .configs import BabyBearPoseidon2Config, GoldilocksBlake3Config
from .system import System, SystemWitness
from .test_circuits import u32_add_system_inputs, u32_add_witness

CONFIGS = {"goldilocks_blake3": GoldilocksBlake3Config, "babybear_poseidon2": BabyBearPoseidon2Config}
WITNESS_SEED = 0xDEADBEEF  # bench.py u32_add_case
# one H100 SXM's HBM rate (NVIDIA's data sheet); spans.py keeps its own copy
# because compare_trees.sh runs it in older trees too
HBM_BYTES_PER_S = 3.35e12
_CHALLENGER_METHODS = ("observe_field", "observe_u64", "observe_ext", "observe_bytes", "observe_commitment",
                       "observe_claims", "sample_field", "sample_ext", "sample_bits", "grind")
_DUPLEX_METHODS = ("observe_bytes", "observe_u64", "observe_words_device", "observe_cap_device",
                   "observe_ext_device", "sample_ext", "entry_words")
# (path name, config, prover entry point)
PATHS = (
    ("goldilocks_blake3 dt", "goldilocks_blake3", "prove_multiple_claims"),
    ("goldilocks_blake3 host", "goldilocks_blake3", "prove_host_transcript"),
    ("babybear_poseidon2", "babybear_poseidon2", "prove_multiple_claims"),
)


def _launches() -> int:
    return sum(kernels.launch_counts().values())


class Spans:
    """Inclusive seconds and kernel launches per span name, with a
    synchronise on both sides."""

    def __init__(self):
        self.seconds = defaultdict(float)
        self.launches = defaultdict(int)
        self._depth = defaultdict(int)

    def clear(self) -> None:
        self.seconds.clear()
        self.launches.clear()

    def wrap(self, name: str, fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            if self._depth[name]:  # a nested call of the same span counts once
                return fn(*args, **kwargs)
            self._depth[name] += 1
            torch.cuda.synchronize()
            t0, n0 = time.perf_counter(), _launches()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                self.seconds[name] += time.perf_counter() - t0
                self.launches[name] += _launches() - n0
                self._depth[name] -= 1
        return timed


def program_bytes(system, witness) -> dict:
    """The bytes each device program of the prove must move (each input read
    once, each output written once), from the system's shapes: the
    lookup-values sweep of the witness build, stage 2, the quotient sweep,
    the three commits (LDE and tree) and, of those, the LDE transforms and
    their bit reversals, the claimed evaluations, the reduced openings, the
    FRI rounds (the first level's matrix and tree; each fold reading its
    level and half an inverse-x table and writing the next level and its
    tree) and the query gathers (opened
    rows and Merkle paths).  A lower bound on their time is bytes / HBM
    rate."""
    config = system.config
    D, log_b = config.ext.D, config.commitment_parameters.log_blowup
    B = 1 << log_b
    out = defaultdict(int)
    n_max = max(witness.heights)
    depths = []  # (row width, tree depth) of each committed matrix
    for c, n in zip(system.circuits, witness.heights):
        if not n:
            continue
        pw = c.preprocessed_dims[1] if c.preprocessed_dims else 0
        lk_cols = sum(1 + len(args) for _, args in c.graph.lookups)  # multiplicity + arguments per slot
        m = n * c.quotient_degree
        out["lookup-values sweep (witness)"] += 8 * n * (c.main_width + pw + lk_cols)
        out["stage-2 traces"] += 8 * n * (lk_cols + c.stage2_width)
        out["quotient sweep"] += 8 * m * (c.main_width + c.stage2_width + pw + 4 + D)  # 4 selector columns
        widths = (c.main_width, c.stage2_width, c.quotient_degree * D)  # stage 1, stage 2, quotient chunks
        out["commits (LDE + tree)"] += sum(8 * w * n + 8 * w * B * n for w in widths)
        out["LDE transforms"] += sum(8 * w * n + 8 * w * B * n for w in widths)
        out["bit reversal"] += sum(16 * w * n for w in widths[:2])  # the iDFT outputs of the two trace commits
        out["claimed evaluations"] += 8 * n * (pw + sum(widths))
        out["reduced openings"] += 8 * B * n * (pw + sum(widths))
        depths += [(w, (n * B).bit_length() - 1) for w in (pw,) + widths if w]
    out["commits (LDE + tree)"] += 3 * 64 * B * n_max  # leaves and inner nodes of three trees
    out["reduced openings"] += 8 * D * B * n_max  # the output at the tallest height
    log_final = log_b + config.pcs.fri.log_final_poly_len
    log_top = (n_max * B).bit_length() - 1
    out["FRI rounds"] += 16 * D * (1 << log_top) + 64 * (1 << (log_top - 1))  # the first level: matrix, tree
    for k in range(log_top, log_final, -1):  # arity 2: fold 2^k -> 2^(k-1) into the next level, commit it
        out["FRI rounds"] += 8 * D * (1 << k) + 4 * (1 << k) + 8 * D * (1 << (k - 1))
        if k - 1 > log_final:
            out["FRI rounds"] += 64 * (1 << (k - 2))  # the next level's leaves and nodes
        depths.append((2 * D, k - 1))
    out["query gathers"] += config.pcs.fri.num_queries * sum(8 * w + 32 * depth for w, depth in depths)
    return dict(out)


def instrument(config, spans: Spans):
    """Wrap the prover's stages in spans (module functions, the config's PCS
    and Merkle instances, and the challenger and duplex classes)."""
    pcs = config.pcs
    for mod, attr, name in (
        (prover, "_observe_claims", "observe claims (host)"),
        (dt_prover, "_observe_claims_host", "observe claims (host)"),
        (lookup, "claims_accumulator_device", "claims accumulator"),
        (lookup, "stage_2_traces_device", "stage-2 traces"),
        (prover, "_quotient_chunk_coeffs", "quotient sweep + iDFT"),
        (dt_prover, "_fetch_and_replay", "global fetch + host replay"),
    ):
        setattr(mod, attr, spans.wrap(name, getattr(mod, attr)))
    for attr, name in (("commit_device", "stage commits (LDE + tree)"), ("commit", "stage commits (LDE + tree)"),
                       ("commit_from_coeffs_device", "quotient commit"), ("commit_from_coeffs", "quotient commit"),
                       ("_claimed_evaluations", "claimed evaluations"), ("_reduced_openings", "reduced openings"),
                       ("_commit_phase", "FRI commit phase"), ("_commit_phase_device_core", "FRI commit phase"),
                       ("_fri_level", "FRI first level (K3 + K15)"), ("_fri_round", "FRI fold rounds (K10 + K15)"),
                       ("_fri_tree", "FRI round trees"), ("_query_phase", "query phase")):
        if hasattr(pcs, attr):  # compare_trees.sh runs this file in trees with other stages too
            setattr(pcs, attr, spans.wrap(name, getattr(pcs, attr)))
    for cls, methods, name in ((DuplexChallenger, _CHALLENGER_METHODS, "host duplex"),
                               (SerializingChallenger64, _CHALLENGER_METHODS, "host duplex"),
                               (DeviceDuplex, _DUPLEX_METHODS, "device duplex")):
        for meth in methods:
            fn = getattr(cls, meth, None)
            if fn is not None and not hasattr(fn, "__wrapped__"):  # classes are wrapped once
                setattr(cls, meth, spans.wrap("PoW grinds (host)" if meth == "grind" else name, fn))


def bench_inputs(log_n: int, device):
    n = 1 << log_n
    rng = np.random.default_rng(WITNESS_SEED)
    xs = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    ys = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    from . import witness_from_numpy

    return witness_from_numpy(*u32_add_witness(list(zip(xs.tolist(), ys.tolist())), n), device)


def kernel_of(function: str) -> str:
    """The label a CUDA function the profiler names is counted under: "K<i>
    <name>" for the port's kernel i (kernels.KERNELS, by its `functions`),
    "PyTorch ops" for PyTorch's own kernels and copies, else the function's
    own name."""
    for i, k in enumerate(kernels.KERNELS, 1):
        # a tree from before CudaKernel.functions existed reports every function by its own name
        if any(f in function for f in getattr(k, "functions", ())):
            return f"K{i} {k.name}"
    if "at::native::" in function or function.lower().startswith(("memcpy", "memset")):
        return "PyTorch ops"
    m = re.search(r"([A-Za-z_]\w*)\s*(<.*>)?\s*\(", function.replace("(anonymous namespace)", ""))
    return m.group(1) if m else function


def _bounds() -> dict:
    """Each kernel's summed least time so far (kernels.CudaKernel.bound_ms;
    a tree from before it existed reports none)."""
    return {f"K{i} {k.name}": getattr(k, "bound_ms", None) for i, k in enumerate(kernels.KERNELS, 1)}


def device_profile(run):
    """Profile one run() with torch.profiler: (the device's busy seconds, the
    sum over the events that ran on it, kernels and copies; the old measure,
    the sum of every event's self device time, which also counts each
    PyTorch op's kernels once more under the op; {label: [seconds, events]}
    by `kernel_of`; {label: the least ms the card could take for the
    kernel's launches in the run}, from the bytes and operations each
    launch site states; {label: the CUDA functions its wrapper launched,
    its launches times the functions per launch}).  The capture window
    stays open 20 ms on both sides of the run: a session that closes right
    after its last kernels can lose their records."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    before, counts = _bounds(), kernels.launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.02)
        run()
        torch.cuda.synchronize()
        time.sleep(0.02)
    bounds = {label: ms - before[label] for label, ms in _bounds().items() if ms is not None}
    launched = {f"K{i} {k.name}": (k.launches - counts[k.name]) * getattr(k, "per_launch", 1)
                for i, k in enumerate(kernels.KERNELS, 1)}
    by_label = defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            cell = by_label[kernel_of(evt.name)]
            cell[0] += evt.time_range.elapsed_us() / 1e6
            cell[1] += 1
    all_events = sum(evt.self_device_time_total for evt in prof.key_averages()) / 1e6
    return sum(sec for sec, _ in by_label.values()), all_events, dict(by_label), bounds, launched


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
    cases = []  # (path, log_n, run, config)
    for path, cfg_name, entry in PATHS:
        if cfg_name not in args.config:
            continue
        config = CONFIGS[cfg_name](
            CommitmentParameters(log_blowup=2, cap_height=0),
            FriParameters(log_final_poly_len=0, max_log_arity=1, num_queries=100,
                          commit_proof_of_work_bits=10, query_proof_of_work_bits=10),
            device=dev,
        )
        system, key = System.new(config, u32_add_system_inputs())
        for log_n in args.log_n:
            traces, claims = bench_inputs(log_n, dev)
            n0 = _launches()
            witness = SystemWitness.from_stage_1(traces, system, key)
            print(f"[spans] {path} log_n={log_n} witness build: {_launches() - n0} launches", flush=True)
            for prog, nbytes in program_bytes(system, witness).items():
                print(f"[spans] {path} log_n={log_n} {prog} must move {nbytes} bytes: at least "
                      f"{1e3 * nbytes / HBM_BYTES_PER_S:.4f} ms", flush=True)
            run = functools.partial(getattr(prover, entry), system, key, witness, claims)
            run()  # cold: host tables
            cases.append((path, log_n, run, config))

    def wall(run) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    plain = {}
    for path, log_n, run, _ in cases:  # nothing wrapped yet
        plain[path, log_n] = [wall(run) for _ in range(args.proves)]
        print(f"[spans] {path} log_n={log_n} warm prove, {args.proves} runs: "
              + ", ".join(f"{w:.4f}" for w in plain[path, log_n]) + " s", flush=True)
    for path, log_n, run, _ in cases:
        busy, all_events, by_label, bounds, launched = device_profile(run)
        median = float(np.median(plain[path, log_n]))  # the profiler's own overhead would swamp its prove's wall time
        print(f"[spans] {path} log_n={log_n} profiled prove: device busy {busy:.4f} s against the "
              f"median warm prove of {median:.4f} s ({100 * (1 - busy / median):.1f}% idle); every profiler "
              f"event's self device time summed: {all_events:.4f} s", flush=True)
        for label, (sec, count) in sorted(by_label.items(), key=lambda kv: -kv[1][0]):
            least = f"; bound {bounds[label]:.4f} ms" if label in bounds else ""
            lost = f" (the wrapper launched {launched[label]})" if launched.get(label, count) != count else ""
            print(f"[spans] {path} log_n={log_n} device time of the profiled prove, {label}: "
                  f"{1e3 * sec:.4f} ms in {count} launches{lost}{least}", flush=True)
    spans = Spans()  # one for every path: the challenger and duplex classes are wrapped once
    for config in {id(c): c for *_, c in cases}.values():
        instrument(config, spans)
    for path, log_n, run, _ in cases:
        with_spans = []
        for _ in range(args.proves):
            spans.clear()
            with_spans.append(wall(run))
        for span, secs in sorted(spans.seconds.items(), key=lambda kv: -kv[1]):
            print(f"[spans] {path} log_n={log_n} {span}: {secs:.4f} s, {spans.launches[span]} launches", flush=True)
        print(f"[spans] {path} log_n={log_n} warm prove with spans, {args.proves} runs: "
              + ", ".join(f"{w:.4f}" for w in with_spans) + " s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
