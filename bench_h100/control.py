"""The control and the faults of a cell, read on the card at the cell's own
size: the reference's verdict (rejected of distinct proofs) on the proofs
of short windows of

  sound    the program as the configuration states it;
  control  the program without its proof-of-work grinds (0 + 0 bits where
           the configuration states more), judged at the stated parameters;
  altered  each proof with one byte flipped where the job produces it;
  half     the prover handed the first half of each job's claims.

    python3 bench_h100/control.py --workload <cell> --seeds 1,2,3 --seconds 3

One JSON line per variant and seed.  The benchmark's own runs never run
this; its CPU twin is tests/test_bench_h100_reference.py.
"""

import argparse
import json
import os
import sys

import run as harness


def variants(cell):
    weak_cfg = dict(cell.cfg, commit_proof_of_work_bits=0, query_proof_of_work_bits=0)
    weak = harness.Cell(cell.workload, weak_cfg, cell.traffic, cell.metrics)
    sound = harness.Program

    class Control(sound):
        def __init__(self, _cell, pool, device="cuda"):
            super().__init__(weak, pool, device)

    class Altered(sound):
        def job(self, k, witness_times=None):
            data = bytearray(super().job(k, witness_times))
            data[-9] ^= 1
            return bytes(data)

    class Half(sound):
        def __init__(self, c, pool, device="cuda"):
            super().__init__(c, pool, device)
            self.pool = [(traces, claims[: len(claims) // 2]) for traces, claims in self.pool]

    return {"sound": sound, "control": Control, "altered": Altered, "half": Half}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--variants", default="sound,control,altered,half")
    args = ap.parse_args(argv)
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        cell = harness.Cell.load(json.load(f), args.workload, False)
    table = variants(cell)
    for name in args.variants.split(","):
        harness.Program = table[name]
        for seed in (int(s) for s in args.seeds.split(",")):
            try:
                _, _, verdict, run, _ = harness.measure(cell, seed, args.seconds, False)
                line = {"variant": name, "seed": seed, "rejected": verdict["rejected"],
                        "distinct": verdict["distinct"], "jobs": len(run.latencies),
                        "reasons": [r[:160] for r in verdict["reasons"]]}
            except Exception as e:  # a variant whose program fails gives no proof: reported as such
                line = {"variant": name, "seed": seed, "error": f"{type(e).__name__}: {str(e)[:300]}"}
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[:0] = [p for p in (harness.HERE, harness.ROOT) if p not in sys.path]
    sys.exit(main())
