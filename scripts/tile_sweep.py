#!/usr/bin/env python3
"""K14 (lde_tile) and K2 (ntt_stage) alone at the bench's commit shapes on
one CUDA card: each kernel timed in place on a (cols, 2^20) batch with CUDA
events, over a sweep of K14's tile sizes and modes, beside K3 / K6 row
hashing and the K2 stages above a 2^8 tile.  Then K15 (merkle_levels) on
the trees of a warm prove at 2^18 rows (the three stage trees above K14's
levels, 2^17 nodes, and the FRI rounds' trees of 2^19 down to 2^2 leaves)
and K13 (reduced_open) at the bench's two LDE heights; K12 (bary_eval) at
the bench's two trace heights and K8 (fri_grind) on one round and on 18
chained rounds; K6 (poseidon2_merkle) in both of its modes at every FRI
level of the BabyBear 2^18 prove and around its four-lane threshold; each
by CUDA events and by the profiler's device time of the kernel's
functions, with the device events the profiler reported and the launches
the wrapper counted meanwhile.

    python3 scripts/tile_sweep.py [--tree DIR] [--only tiles|trees|openings|rows]

--tree points at a checkout of this repository whose multistark_tpu_torch
is measured (default: this one), so that two checkouts can be swept in one
call on one card; the K2 passes of a tree that has no `ntt.pass_plan` run
one launch per stage, K13 in a tree without `pcs.reduced_open_height`
runs one `reduced_open` per matrix, and K12 in a tree without
`pcs.bary_eval_height` one `bary_eval` per matrix.  Needs a CUDA device.
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


def device_ms(fn, kernel, iters=5) -> str:
    """Mean device milliseconds per fn() of the CUDA functions of `kernel`
    (a kernels.CudaKernel), from torch.profiler's events, with the kernel
    events counted and the launches the wrapper counted meanwhile.  The
    capture window stays open 20 ms on both sides of the timed calls (a
    session that closes right after its last kernels can lose their
    records), and a session with fewer events than launches (times the
    kernels per launch, where the tree states it) is run again, up to three
    times."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, 4):
        fn()
        torch.cuda.synchronize()
        before = kernel.launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
        events = [evt for evt in prof.events()
                  if evt.device_type == DeviceType.CUDA and any(f in evt.name for f in kernel.functions)]
        launched = kernel.launches - before
        if len(events) >= launched * getattr(kernel, "per_launch", 1):
            break
    us = sum(evt.time_range.elapsed_us() for evt in events)
    return f"{us / 1e3 / iters:.4f} ({len(events)} events, {launched} launches, session {attempt})"


def trees_and_openings(dev) -> None:
    """K15 on a warm prove's trees and K13 at its two heights."""
    import numpy as np
    import torch

    from multistark_tpu_torch import commit_tile as ct, kernels, pcs
    from multistark_tpu_torch.fields.device import BB4_OPS, BB_OPS, GL2_OPS, GL_OPS
    from multistark_tpu_torch.merkle import Blake3FieldHasher, Poseidon2FieldHasher
    from multistark_tpu_torch.utils import ext_powers_device

    rng = np.random.default_rng(2)
    for F, E, hasher in ((GL_OPS, GL2_OPS, Blake3FieldHasher()), (BB_OPS, BB4_OPS, Poseidon2FieldHasher())):
        def digests(h):
            words = rng.integers(0, F.p if F is BB_OPS else 2 ** 32, (h, 8), dtype=np.uint64)
            return torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(dev)

        stage = digests(1 << 17), {7: digests(1 << 10)}  # ByteTable's 2^10 leaves 7 levels above K14's three
        fri = [digests(1 << k) for k in range(19, 1, -1)]

        def run_stage():
            ct.merkle_levels(hasher, stage[0], 17, stage[1])

        def run_fri19():
            ct.merkle_levels(hasher, fri[0], 19)

        def run_prove():  # the 3 stage trees and 18 FRI trees of one warm prove at 2^18
            for _ in range(3):
                run_stage()
            for leaves in fri:
                ct.merkle_levels(hasher, leaves, leaves.shape[0].bit_length() - 1)

        for label, fn in (("stage tree 2^17 nodes, 17 levels, 2^10 injected", run_stage),
                          ("FRI tree 2^19 leaves", run_fri19), ("a prove's 21 trees", run_prove)):
            kernels.reset_launch_counts()
            fn()
            n = kernels.MERKLE_LEVELS.launches
            print(f"[trees] {F.name} K15 {label}: {ms(fn, 5):.4f} ms, device {device_ms(fn, kernels.MERKLE_LEVELS)}"
                  f" ms, {n} launches", flush=True)
        if hasattr(ct, "levels_plan"):  # K15's first tier swept (each tree's other tiers as levels_plan splits them)
            for log_size in (19, 17, 14, 12, 10, 8):
                layer = digests(1 << log_size)
                row = []
                for s0 in range(4, min(log_size, ct.MAX_GROUP_LOG) + 1):
                    rest = log_size - s0
                    n = -(-rest // ct.MAX_GROUP_LOG)
                    tiers = (s0,) + tuple(rest // n + (i < rest % n) for i in range(n))
                    blocks = 1 << (log_size - s0)
                    counters = sum(blocks >> sum(tiers[1:t + 1]) for t in range(1, len(tiers)))
                    plan = ct.LevelsPlan(tiers, blocks, min(256, max(32, 1 << (max(tiers) - 1))), counters)
                    t = device_ms(lambda: ct.merkle_levels(hasher, layer, log_size, plan=plan), kernels.MERKLE_LEVELS)
                    row.append(f"{tiers}: {t}")
                print(f"[trees] {F.name} K15 2^{log_size}-node tree, device ms by plan (default "
                      f"{ct.levels_plan(log_size, log_size).tiers}): " + ", ".join(row), flush=True)
        D, P = E.D, 2

        def rnd(*shape):
            return F.from_np(rng.integers(0, F.p, shape, dtype=np.uint64), dev)

        # (log LDE height, [(width, points)]): U32Add's stage 1, 2 and quotient; ByteTable's preprocessed, 1, 2, quotient
        for log_lde, widths in ((20, [(14, 2), (13 * D, 2), (D, 1)]), (10, [(1, 2), (1, 2), (D, 2), (D, 1)])):
            N = 1 << log_lde
            mats = [rnd(w, N) for w, _ in widths]
            apows = ext_powers_device(E, rnd(D), sum(w * k for w, k in widths)).contiguous()
            invs = [rnd(D, N) for _ in range(P)]
            openings, off = [], 0
            for w, k in widths:
                openings.append([(p, off + p * w, rnd(D, w)) for p in range(k)])
                off += w * k

            def height():
                if hasattr(pcs, "reduced_open_height"):
                    return pcs.reduced_open_height(E, mats, apows, openings, invs)
                ro = None
                for mat, opened in zip(mats, openings):
                    ro = pcs.reduced_open(E, mat, apows, [v for _, _, v in opened], [invs[p] for p, _, _ in opened],
                                          [o for _, o, _ in opened], ro)
                return ro

            kernels.reset_launch_counts()
            height()
            n = kernels.REDUCED_OPEN.launches
            print(f"[openings] {F.name} K13 LDE height 2^{log_lde}, matrices {widths} (width, points): "
                  f"{ms(height, 5):.4f} ms, device {device_ms(height, kernels.REDUCED_OPEN)} ms, {n} launches",
                  flush=True)


def evaluations_and_grind(dev) -> None:
    """K12 at the bench's two trace heights (one launch per height, or in a
    tree without `pcs.bary_eval_height` one `bary_eval` per matrix on
    weights made beforehand), and K8 on one round and on 18 chained rounds
    at the bench's 10 bits over a 16-word chain ‖ cap."""
    import numpy as np
    import torch

    from multistark_tpu_torch import device_transcript as dt, kernels, pcs
    from multistark_tpu_torch.fields.device import BB4_OPS, BB_OPS, GL2_OPS, GL_OPS

    rng = np.random.default_rng(5)
    for F, E in ((GL_OPS, GL2_OPS), (BB_OPS, BB4_OPS)):
        D, hf = E.D, F.host

        def rnd(*shape):
            return F.from_np(rng.integers(0, F.p, shape, dtype=np.uint64), dev)

        # (log trace height, [(width, points)]): U32Add's stage 1, 2 and quotient; ByteTable's preprocessed, 1, 2,
        # quotient
        for log_n, widths in ((18, [(14, 2), (13 * D, 2), (D, 1)]), (8, [(1, 2), (1, 2), (D, 2), (D, 1)])):
            n, N, P = 1 << log_n, 1 << (log_n + 2), 2
            mats = [rnd(w, N) for w, _ in widths]
            zs, invs, x = [rnd(D) for _ in range(P)], [rnd(D, n) for _ in range(P)], rnd(n)
            s_n = hf.pow(hf.generator, n)
            inv_ns = hf.inv(hf.mul(n % hf.p, s_n))
            if hasattr(pcs, "bary_eval_height"):
                def height():
                    return pcs.bary_eval_height(E, mats, log_n, [list(range(k)) for _, k in widths], zs, invs, x,
                                                s_n, inv_ns)
            else:
                weights = [E.scale(i, x) for i in invs]

                def height():
                    return [pcs.bary_eval(E, m, log_n, weights[:k], zs[:k], s_n, inv_ns) for m, (_, k) in
                            zip(mats, widths)]

            kernels.reset_launch_counts()
            height()
            count = kernels.BARY_EVAL.launches
            print(f"[openings] {F.name} K12 trace height 2^{log_n}, matrices {widths} (width, points): "
                  f"{ms(height, 5):.4f} ms, device {device_ms(height, kernels.BARY_EVAL)} ms, {count} launches",
                  flush=True)
    inp = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, 16).astype(np.int32)).to(dev)

    def one():
        return dt.fri_grind(inp, 10, 2)

    def rounds():
        chain = inp[:8]
        for _ in range(18):
            chain = dt.fri_grind(torch.cat([chain, inp[8:]]), 10, 2)[3]
        return chain

    for label, fn in (("one round", one), ("18 chained rounds", rounds)):
        kernels.reset_launch_counts()
        fn()
        count = kernels.FRI_GRIND.launches
        print(f"[grind] K8 {label}, L = 16, 10 bits: {ms(fn, 5):.4f} ms, device {device_ms(fn, kernels.FRI_GRIND)} ms, "
              f"{count} launches", flush=True)


def poseidon2_rows(dev) -> None:
    """K6 (poseidon2_merkle) in both modes, each with its own grid
    (hash_rows_plan with the mode forced), at every FRI level of the
    BabyBear 2^18 prove ((8, 2^2) to (8, 2^19)) and at widths 14 and 52
    (two and seven chunks a row) around the four-lane threshold: the
    measurement LANE_ROWS_PER_SM is chosen from."""
    import numpy as np
    import torch

    from multistark_tpu_torch import kernels
    from multistark_tpu_torch.fields.device import BB_OPS
    from multistark_tpu_torch.hash import poseidon2 as p2

    if not hasattr(p2, "hash_rows_plan"):
        return
    rng = np.random.default_rng(4)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for cols, logs in ((8, range(2, 20)), (14, range(8, 17)), (52, range(8, 17))):
        for log_n in logs:
            x = BB_OPS.from_np(rng.integers(0, BB_OPS.p, (cols, 1 << log_n), dtype=np.uint64), dev)
            times = []
            for mode in (p2.MODE_THREAD, p2.MODE_LANES):
                plan = p2.hash_rows_plan(1 << log_n, sms, mode)
                times.append(f"{'thread' if mode == p2.MODE_THREAD else 'four-lane'} {plan.blocks}x{plan.threads} "
                             f"{device_ms(lambda: p2.hash_rows([x], plan=plan), kernels.POSEIDON2_MERKLE)} ms")
            chosen = "four-lane" if p2.hash_rows_plan(1 << log_n, sms).mode == p2.MODE_LANES else "thread"
            print(f"[rows] K6 ({cols}, 2^{log_n}): {'; '.join(times)}; the plan takes {chosen} "
                  f"(LANE_ROWS_PER_SM {p2.LANE_ROWS_PER_SM})", flush=True)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--only", choices=("tiles", "trees", "openings", "rows"))
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
    if args.only in (None, "rows"):
        poseidon2_rows(dev)
    if args.only in (None, "openings"):
        evaluations_and_grind(dev)
    if args.only in (None, "trees"):
        trees_and_openings(dev)
    if args.only is not None:
        return 0
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
