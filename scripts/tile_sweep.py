#!/usr/bin/env python3
"""K14 (lde_tile) and K2 (ntt_stage) alone at the bench's commit shapes on
one CUDA card: each kernel timed in place on a (cols, 2^20) batch with CUDA
events, over a sweep of K14's tile sizes and modes, beside K3 / K6 row
hashing and the K2 stages above a 2^8 tile.

    python3 scripts/tile_sweep.py [--tree DIR]

--tree points at a checkout of this repository whose multistark_tpu_torch
is measured (default: this one), so that two checkouts can be swept in one
call on one card; the K2 passes of a tree that has no `ntt.pass_plan` run
one launch per stage.  Needs a CUDA device.
"""

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS_LOG = 20  # the stage-1 and stage-2 LDEs of 2^18 rows at blowup 4
WIDTHS = (14, 26)  # U32Add's stage-1 and stage-2 columns (Goldilocks)
TILES = (6, 7, 8, 9, 10)
ABOVE = 8  # the K2 stages above a tile of 2^8


def ms(fn, iters=10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    import numpy as np
    import torch

    from multistark_tpu_torch import commit_tile as ct, kernels
    from multistark_tpu_torch.fields.device import BB_OPS, GL_OPS
    from multistark_tpu_torch.hash import blake3 as b3, poseidon2 as p2
    from multistark_tpu_torch.merkle import Blake3FieldHasher, Poseidon2FieldHasher
    from multistark_tpu_torch.ntt import ntt as nt

    if not torch.cuda.is_available():
        raise SystemExit("tile_sweep: needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[sweep] {kernels.__file__}; {smi}", flush=True)
    kernels.build()
    rng = np.random.default_rng(1)
    for F, hasher, mod in ((GL_OPS, Blake3FieldHasher(), b3), (BB_OPS, Poseidon2FieldHasher(), p2)):
        eng = nt.NttEngine(F, F.host, dev)
        for cols in WIDTHS:
            x = F.from_np(rng.integers(0, F.p, (cols, 1 << ROWS_LOG), dtype=np.uint64), dev)
            label = f"[sweep] {F.name} ({cols}, 2^{ROWS_LOG})"
            print(f"{label} row hashing (K3 / K6): {ms(lambda: mod.hash_rows([x])):.4f} ms", flush=True)
            for k in TILES:
                tw = eng.tail_table(k, False)
                try:
                    times = [ms(lambda: ct.lde_tile(F, None, x, k, tw, hashed=False))]
                    for levels in (0, max(k - 5, 0), k):
                        times.append(ms(lambda: ct.lde_tile(F, hasher, x, k, tw, levels, {}, True)))
                except RuntimeError as err:  # a tile over the block's shared memory
                    print(f"{label} K14 tile 2^{k}: {err}", flush=True)
                    continue
                print(f"{label} K14 tile 2^{k}: no hashing {times[0]:.4f} ms; hashed, 0 levels {times[1]:.4f}, "
                      f"{max(k - 5, 0)} levels {times[2]:.4f}, {k} levels {times[3]:.4f} ms", flush=True)
            if hasattr(nt, "pass_plan"):
                plan = nt.pass_plan(ROWS_LOG, ABOVE, nt.PASS_STAGES)
                tab = eng.tail_table(ROWS_LOG, False)

                def above():
                    for s_lo, r in plan:
                        nt.ntt_pass_(F, x, tab[(1 << (s_lo - 1)) - 1:], s_lo, r, True)
            else:
                plan = "one launch per stage"

                def above():
                    for s in range(ROWS_LOG, ABOVE, -1):
                        nt.ntt_stage_(F, x, eng.stage_table(s, False), True)
            print(f"{label} K2 stages {ROWS_LOG}..{ABOVE + 1} ({plan}): {ms(above):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
