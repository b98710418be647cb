"""What the provers' `stark/*` spans (multistark_tpu_torch/profiling.py) cost
a warm prove on the card, and which part of a span costs it: warm proves
in five variants, in rounds within one process, so that the card, its
power limit and the host's load are the same for all of them:

  on        the spans as they are
  off       the prover modules' `span` replaced by a null context
  no-proc   the spans without their memory reads (RSS and peak read as 0)
  statm     RSS read from /proc/self/statm, as the JAX module reads it
  timed     the spans as they are

    python3 scripts/span_overhead.py [--rounds N] [--log-n N ...] [--no-blake3]

Cases: the bench workload (U32Add + ByteTable, chip_smoke's bench
parameters and witness) along its three paths (GoldilocksBlake3 through
`prove_multiple_claims`, the device transcript, and
`prove_host_transcript`; BabyBearPoseidon2) at each `--log-n`, and the
BLAKE3 64 KiB workload on both GoldilocksBlake3 transcripts (the data of
scripts/torch_port_golden.py).  Each case: one cold prove, then N rounds
of one warm prove per variant, the order rotating between rounds; each
prove's host seconds end in `torch.cuda.synchronize()`.  Prints per case
and variant the median and quartiles, and against "off" the median of
the rounds' differences and how many rounds took longer; for "timed" and
"statm" the seconds a prove spent in the spans' memory reads; then one
empty span's enter and exit, a mean over 20000.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from multistark_tpu_torch import dt_prover, pcs, profiling, prover  # noqa: E402

SPANNED = (prover, pcs, dt_prover)  # the modules that open stark/* spans


@contextlib.contextmanager
def patched(pairs):
    """Each (object, attribute) of `pairs` set to a null stand-in, restored after."""
    saved = [getattr(obj, attr) for obj, attr, _ in pairs]
    for obj, attr, value in pairs:
        setattr(obj, attr, value)
    try:
        yield
    finally:
        for (obj, attr, _), value in zip(pairs, saved):
            setattr(obj, attr, value)


def null_context(name):
    return contextlib.nullcontext()


def statm_memory():
    """(RSS, peak RSS) in MiB the JAX module's way: RSS from /proc/self/statm
    (opened for each read), the peak from profiling's reader."""
    with open("/proc/self/statm", "rb") as f:
        rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**20
    return rss, MEMORY()[1]


def timed(fn, sink: list):
    def wrapper():
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            sink.append(time.perf_counter() - t0)
    return wrapper


MEMORY = profiling._memory_mib
READ_SECONDS = {"timed": [], "statm": []}  # each memory read's seconds, per variant
VARIANTS = {
    "on": lambda: contextlib.nullcontext(),
    "off": lambda: patched([(m, "span", null_context) for m in SPANNED]),
    "no-proc": lambda: patched([(profiling, "_memory_mib", lambda: (0.0, 0.0))]),
    "statm": lambda: patched([(profiling, "_memory_mib", timed(statm_memory, READ_SECONDS["statm"]))]),
    "timed": lambda: patched([(profiling, "_memory_mib", timed(MEMORY, READ_SECONDS["timed"]))]),
}


def wall(run) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def cases(dev, log_ns, blake3: bool):
    """(label, prove with no arguments) per case, each proved once cold."""
    import chip_smoke as cs

    import multistark_tpu_torch as mt
    from multistark_tpu_torch.system import System, SystemWitness
    from multistark_tpu_torch.test_circuits import u32_add_system_inputs, u32_add_witness

    out = []
    for path, (config_name, entry, _) in cs.PATHS.items():
        system, key = System.new(cs.bench_config(dev, config_name), u32_add_system_inputs())
        for log_n in log_ns:
            n = 1 << log_n
            rng = np.random.default_rng(cs.WITNESS_SEED)
            xs = rng.integers(0, 1 << 32, n, dtype=np.uint64)
            ys = rng.integers(0, 1 << 32, n, dtype=np.uint64)
            traces, claims = mt.witness_from_numpy(*u32_add_witness(list(zip(xs.tolist(), ys.tolist())), n), dev)
            witness = SystemWitness.from_stage_1(traces, system, key)
            out.append((f"{path} log_n={log_n}", lambda p=getattr(prover, entry), s=system, k=key, w=witness,
                        c=claims: p(s, k, w, c)))
    if blake3:
        G, _ = cs.golden_workloads()
        name = "blake3 64 KiB"
        inputs, traces, claims, _ = cs.workload_data(G, name)
        system, key = cs.workload_system(dev, G, name, inputs)
        traces, claims = mt.witness_from_numpy(traces, claims, dev)
        witness = SystemWitness.from_stage_1(traces, system, key)
        for entry in ("prove_multiple_claims", "prove_host_transcript"):
            out.append((f"{name} {entry}", lambda p=getattr(prover, entry), s=system, k=key, w=witness,
                        c=claims: p(s, k, w, c)))
    for _, run in out:
        wall(run)  # cold: host tables, K11 programs
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--log-n", nargs="+", type=int, default=[14, 18])
    ap.add_argument("--no-blake3", action="store_true", help="leave out the BLAKE3 64 KiB workload")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("span_overhead: needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(f"[span_overhead] {torch.cuda.get_device_name(0)}", flush=True)
    os.environ.pop("MULTISTARK_TEXRAY", None)
    names = list(VARIANTS)
    for label, run in cases(dev, args.log_n, not args.no_blake3):
        secs = {name: [] for name in names}
        for i in range(args.rounds):
            for name in names[i % len(names):] + names[:i % len(names)]:
                with VARIANTS[name]():
                    secs[name].append(wall(run))
        for name, sink in READ_SECONDS.items():
            reads = np.asarray(sink)
            print(f"[span_overhead] {label} {name}: {len(reads)} memory reads, {1e3 * reads.sum() / args.rounds:.3f} "
                  f"ms a prove, median {1e6 * np.median(reads):.1f} us, max {1e6 * reads.max():.1f} us", flush=True)
            sink.clear()
        off = np.asarray(secs["off"])
        for name in names:
            a = np.asarray(secs[name])
            vs = "" if name == "off" else (f"; against off: median {1e3 * np.median(a - off):+.2f} ms, longer in "
                                           f"{int((a > off).sum())} of {args.rounds} rounds")
            print(f"[span_overhead] {label} {name}: median {np.median(a):.4f} s (quartiles "
                  f"{np.percentile(a, 25):.4f}-{np.percentile(a, 75):.4f}){vs}", flush=True)
    profiling.reset_spans()
    t0 = time.perf_counter()
    for _ in range(20000):
        with profiling.span("stark/empty"):
            pass
    profiling.reset_spans()
    print(f"[span_overhead] one empty span: {(time.perf_counter() - t0) / 20000 * 1e6:.2f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
