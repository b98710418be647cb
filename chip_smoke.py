#!/usr/bin/env python3
"""Drive the PyTorch port (multistark_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero
without printing a result:

  1. device  -- torch.cuda must be available; prints the card's name and
                its `nvidia-smi` name and power limit
  2. build   -- compiles the CUDA kernels from csrc/ (one nvcc per
                source, all at once, then one link; sm_90a): K1-K10 and
                K12-K15 into the library; then K11's kernels, one per
                recorded program of the bench proves (both configs, 2^14
                and 2^18), generated from the template csrc/expr_sweep.cu,
                one nvcc per program, all at once; prints each source's
                and each program's build seconds and the registers, stack
                frames and spills of K1's and K5's, K3's, K6's, K14's,
                gl_scan.cu's, K15's, K13's, K12's, K8's, K10's and K9's
                kernels
  3. kernels -- each kernel against its plain PyTorch version on the card,
                at the main paths' shapes, for Goldilocks and BabyBear
                (K1 / K5 every op at the shapes the prove broadcasts by
                period and the powers entry at counts 1 to 300, each
                launched twice, the powers timed beside the parent's
                doubling loop, and one extension product's latency; K3's
                FRI entry at every FRI level of the 2^18 prove, arity 2, 4
                and 16, each launched twice, timed beside the parent's
                layout copy and hash_rows, and hash_rows at rows of 14, 26
                and 520 elements; K6 at every FRI level of the BabyBear
                2^14 and 2^18 proves, (14, 2^20), two and sixteen
                matrices, a short last chunk, one row and both modes on
                both sides of its four-lane threshold, each launched twice,
                the 2^18 prove's levels in a row, and one permutation's
                latency on a thread and on four lanes; K2 one stage per launch and as multi-stage passes at every
                pass size, with the whole DIF and DIT through NttEngine; K4's
                entries (batch inverse, cumsum, sum, sum of inverses, the
                stage-2 chain) at the stage-2 shape and at edge cases around
                their tiles; K11 on U32Add's three recorded programs at 2^18
                rows and the quotient in the sharded natural mode, K12 at
                the bench's two trace heights (2^18: the (14, 2^20) stored
                LDE and two more matrices, 2^8: four) and below one tile,
                each launched twice (the per-matrix launch structure timed
                beside), K13 at the bench's two LDE heights (2^20: three
                matrices, 2^10: four; the parent's per-matrix composition
                timed beside), K14 at the tiles the
                commits pick: the stage-1 commit's tile, with and without
                an injection inside its levels, the stage-2 width, an
                iDFT's tail and its DIT head, the quotient iDFT's DIT head;
                K15 on every tree of 2^1 to 2^20 leaves at caps 2^0 and 2^4
                with injections at the first level, above the first tier
                and at the top, each launched twice, and on forced plans of
                many tiers, then above the stage-1 tile and on a FRI
                round's 2^19-leaf tree beside the parent's launch structure,
                and one compression's latency), K8 on duplex inputs of 8 to
                767 words around every edge of its prefix at 0, 1, 10 and
                16 bits and D = 1..3, each launched twice, and on an input
                whose least witness lies past the first wave, then 18
                chained rounds; K10 on a FRI round of 2^20 positions into
                the next level's matrix and leaves (arity 2 into 2, 4 into
                16, 16 into 4, with and without the absorb, the last round,
                from the level's matrix and from its vector, both fields,
                BabyBear's first-level layout; each launched twice), its
                18 chained rounds beside the parent's structure (the fold
                vector, then K3's FRI entry); K9 on row-major claims from 1
                to 2^21 + 5 (widths 0 to 4, a zero message, a view off 16
                bytes), one extension inversion's latency, and the
                accumulator from the host array beside the parent's
                transpose and upload; outputs must be bit-equal (all arithmetic
                is exact mod p, all hashing exact); warm CUDA-event times of
                both, and for K4, K7, K8, K9, K10, K11, K12, K13 and K15
                the device time (the calls queued behind a spin kernel, so that the
                host's launch path is hidden, between two CUDA events)
  4. prove   -- the bench workload (U32Add + preprocessed ByteTable,
                blowup 4, 100 queries, arity 2, PoW 10+10, bench.py's
                witness) at 2^14 and 2^18 rows on `cuda` along three paths:
                GoldilocksBlake3Config through `prove_multiple_claims` (the
                device transcript) and through `prove_host_transcript`,
                then BabyBearPoseidon2Config; proof bytes must match the
                JAX package's golden sha256 and length
                (fixtures/torch_port_golden.json); warm prove seconds, peak
                device memory and the launches of each warm prove.  The
                launch counts are set to 0 before each path and read right
                after its proves; every kernel of that path must have
                launched, K14 and K15 on every path, no kernel entry
                point compresses Merkle pairs outside K14 / K15, and no
                path makes a PyTorch layout copy of a FRI level
                (kernels.COPIES: K3's FRI entry or K10 writes the matrix).  After that
                read, the device transcript's path up to its one global
                fetch runs once more per size under
                torch.cuda.set_sync_debug_mode("error") (any op there that
                waits for the device raises), and the path must count no
                fallback
  5. sharded -- the row-sharded prove (parallel.py) on torch.distributed,
                ranks started with the spawn method from the package
                (spmd_cases.chip_rank): NCCL at world = the largest power of
                two <= the cards, one rank per card, both configs at 2^14
                and 2^18; gloo with four ranks on card 0 (its collectives
                staged through pinned host memory), GoldilocksBlake3 at
                2^18, plus distributed_dft (3, 2^10, 2^10) on the card
                against the same call on CPU tensors; gloo with two ranks
                on card 0, BabyBearPoseidon2 at 2^14; then the entry point
                parallel.dryrun_multichip(2) on the card (NCCL where two
                cards exist, else gloo on card 0), GoldilocksBlake3 at
                2^10.  One line per world:
                backend, world, ranks per card, cold and warm prove seconds
                and peak device memory per rank, collective and staged bytes,
                kernel launches and sharded calls per rank.  Every rank's
                proof must equal the golden sha256 and length, every sharded
                function of row 27 must be counted and every kernel of the
                config's path launched on every rank; the phase's launches
                join the kernels line

Then a check that no process the script started is still running (the
ranks, nvcc, and the resource tracker the spawn method starts beside the
ranks), a JSON line of per-kernel results (with each kernel's bound: the least
time the card could take for the same work), the nvidia-smi line, and as
the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SIZES = (14, 18)
WITNESS_SEED = 0xDEADBEEF  # bench.py u32_add_case
# each path: (config, prover entry point, the kernels it must launch)
PATHS = {
    "goldilocks_blake3 device transcript": (
        "goldilocks_blake3", "prove_multiple_claims",
        ("gl_arith", "ntt_stage", "blake3_merkle", "gl_scan", "dt_flush", "fri_grind", "claims_fp", "fri_fold",
         "expr_sweep", "bary_eval", "reduced_open", "lde_tile", "merkle_levels"),
    ),
    "goldilocks_blake3 host transcript": (
        "goldilocks_blake3", "prove_host_transcript",
        ("gl_arith", "ntt_stage", "blake3_merkle", "gl_scan", "fri_grind", "claims_fp", "fri_fold", "expr_sweep",
         "bary_eval", "reduced_open", "lde_tile", "merkle_levels"),
    ),
    "babybear_poseidon2": (
        "babybear_poseidon2", "prove_multiple_claims",
        ("bb_arith", "ntt_stage", "poseidon2_merkle", "gl_scan", "claims_fp", "fri_fold", "expr_sweep", "bary_eval",
         "reduced_open", "lde_tile", "merkle_levels"),
    ),
}
BENCH_COMMIT = dict(log_blowup=2, cap_height=0)
BENCH_FRI = dict(log_final_poly_len=0, max_log_arity=1, num_queries=100,
                 commit_proof_of_work_bits=10, query_proof_of_work_bits=10)
CLAIM_WIDTH = 4  # values per claim of the bench workload (u32_add: channel, x, y, x + y mod 2^32)
# One NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM bytes/s,
# and 32-bit operations/s on the CUDA cores (the float32 non-tensor rate;
# integer instructions run no faster, so this gives the least time)
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12
# 32-bit integer operations counted per modular multiplication (the 32x32
# partial products and the reduction's multiplies), per BLAKE3 compression
# (7 rounds x 8 G functions x 14 add/xor/rotate) and per Poseidon2
# permutation (772 BabyBear multiplications: 141 x^7 S-boxes of 4 and the
# 13 x 16 internal diagonal products)
OPS_PER_MUL = {"Goldilocks": 12, "BabyBear": 6}
OPS_PER_BLAKE3 = 7 * 8 * 14
OPS_PER_POSEIDON2 = 772 * OPS_PER_MUL["BabyBear"]
LATENCY_US = {}  # one compression's latency by field name (check_trees' node chain)
EXT_LATENCY_US = {}  # one extension product's latency by field name (check_arith's chain)
SPIN_CYCLES_PER_S = 2.0e9  # torch.cuda._sleep cycles per second, at least (an H100's SM clock is at most 1.98 GHz)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Warm mean milliseconds of fn() on the current stream (CUDA events)."""
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


def device_ms(fn, iters: int = 5) -> float:
    """Mean device milliseconds per fn(), without the host's launch path:
    the calls are queued behind a spin kernel that keeps the card busy
    while the host enqueues them, so they run back to back between two
    CUDA events.  The spin is long enough for the host's enqueueing, timed
    first, or the measurement is taken again with a longer one.  (Short
    torch.profiler sessions in this script lost 20-60% of the kernels'
    records, counted against the wrappers' launches: the profiler is left
    to spans.py and scripts/tile_sweep.py, which count theirs.)"""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    spin_s = 0.005
    for _ in range(4):
        torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_s = time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize()
        if host_s < 0.5 * spin_s:
            break
        spin_s = 4 * host_s
    return start.elapsed_time(end) / iters


def max_abs_err(a, b) -> float:
    """Largest |a - b| over u64 values held in int64 tensors (0 when the
    bit patterns agree everywhere)."""
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if torch.equal(a, b):
        return 0.0

    def u64(t):
        t = t.to(torch.int64)
        return t.double() + (t < 0).double() * 2.0 ** 64

    return float((u64(a) - u64(b)).abs().max().item())


def bound(n_bytes: float, ops: float):
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_kernels(dev):
    """Phase 3: every kernel against its plain version at main-path shapes.
    Returns {kernel name: row of the kernels line} for one representative
    call per kernel."""
    import numpy as np
    import torch

    from multistark_tpu_torch import commit_tile as ct, device_transcript as dt, utils
    from multistark_tpu_torch.fields.device import BB4_OPS, BB_OPS, GL2_OPS, GL_OPS
    from multistark_tpu_torch.hash import blake3 as b3, poseidon2 as p2
    from multistark_tpu_torch.merkle import Blake3FieldHasher, MerkleMmcs, Poseidon2FieldHasher
    from multistark_tpu_torch.ntt import ntt as nt

    rng = np.random.default_rng(1)

    def rnd(F, *shape):
        return F.from_np(rng.integers(0, F.p, shape, dtype=np.uint64), dev)

    rows = {}

    def compare(label, kernel_fn, plain_fn, cost, iters=5, plain_iters=1, name=None, time_fn=None, device=False):
        """cost: (bytes the function must move, 32-bit integer operations).
        time_fn, where given, is what the kernel's time is taken on: the
        kernel alone, in place on a scratch copy, without the copy and
        concatenation that kernel_fn adds for the comparison.  device adds
        its device time per call (`device_ms`)."""
        out, ref = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        err = max_abs_err(out, ref)
        ms, plain_ms = cuda_ms(time_fn or kernel_fn, iters), cuda_ms(plain_fn, plain_iters)
        bound_ms, bound_by = bound(*cost)
        dev = f" device_ms={device_ms(time_fn or kernel_fn, iters):.4f}" if device else ""
        say("kernels", f"{label}: max_abs_err={err} kernel_ms={ms:.4f}{dev} plain_ms={plain_ms:.4f} "
            f"bound_ms={bound_ms:.4g} ({bound_by})")
        if err != 0:
            raise AssertionError(f"{label}: kernel disagrees with its plain version")
        if name is not None:  # no single PyTorch call computes any of these mod p: library_ms is null
            rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by, "library_ms": None}

    m = 1 << 20
    lde_w, lde_log = 14, 20  # the stage-1 LDE of 2^18 rows at blowup 4
    for F, E, arith in ((GL_OPS, GL2_OPS, "gl_arith"), (BB_OPS, BB4_OPS, "bb_arith")):
        D, mul_ops = E.D, OPS_PER_MUL[F.name]
        inv_muls = (F.p - 2).bit_length() + bin(F.p - 2).count("1")  # Fermat square-and-multiply
        ext_muls = D * D + D * (D - 1) // 2  # schoolbook products and the X^D = W wraps
        ext_inv_muls = (3 if D == 2 else 2 * ext_muls + 4) + inv_muls  # the norm map, then one base inverse
        # K1 / K5: the quotient-domain and reduced-opening field ops at 2^18 rows
        a, b = rnd(F, m), rnd(F, m)
        ea, eb = rnd(F, D, m), rnd(F, D, m)
        k, k2 = 1 << 18, 1 << 16
        compare(f"{arith} mul (2^20,)", lambda: F.mul(a, b), lambda: F.mul_plain(a, b), (24 * m, mul_ops * m))
        compare(f"{arith} add (2^20,)", lambda: F.add(a, b), lambda: F.add_plain(a, b), (24 * m, 2 * m))
        compare(f"{arith} inv (2^18,)", lambda: F.inv(a[:k]), lambda: F.inv_plain(a[:k]),
                (16 * k, inv_muls * mul_ops * k))
        compare(f"{arith} ext_inv ({D}, 2^16)", lambda: E.inv(ea[:, :k2]), lambda: E.inv_plain(ea[:, :k2]),
                (16 * D * k2, ext_inv_muls * mul_ops * k2))
        compare(f"{arith} ext_mul ({D}, 2^20)", lambda: E.mul(ea, eb), lambda: E.mul_plain(ea, eb),
                (3 * 8 * D * m, ext_muls * mul_ops * m), name=arith)
        # a transcript scalar, (D,) or (D, 1), against a (D, n) vector on either side
        for shape in ((D,), (D, 1)):
            sc = rnd(F, D).reshape(shape)
            full = sc.reshape(D, 1).expand(D, m).contiguous()
            for op in (E.add, E.sub, E.mul):
                if not (torch.equal(op(ea, sc), op(ea, full)) and torch.equal(op(sc, ea), op(full, ea))):
                    raise AssertionError(f"{arith}: an ext scalar of shape {shape} broadcasts wrongly")
        say("kernels", f"{arith}: ext scalars of shape ({D},) and ({D}, 1) broadcast against ({D}, 2^20)")
        check_arith(F, E, arith, rnd, compare, mul_ops, ext_muls, first=F is GL_OPS)

        # K2: the (14, 2^20) stage-1 LDE's forward DIF, all 20 stages one
        # launch each (the r = 1 pass, as the sharded DIF's coarse stages run)
        lde = rnd(F, lde_w, 1 << lde_log)
        eng = nt.NttEngine(F, F.host, dev)
        tables = [eng.stage_table(s, False) for s in range(1, lde_log + 1)]

        def dif(stage, x=None):
            def run():
                y = lde.clone() if x is None else x
                for tw in reversed(tables):
                    stage(F, y, tw, True)
                return y
            return run

        n_lde, n18 = lde_w << lde_log, lde_w << 18
        dif_cost = (16 * n_lde + 8 * (1 << lde_log), mul_ops * lde_log * n_lde // 2)
        scratch = lde.clone()  # the in-place kernels' timing runs: the work does not depend on the values
        compare(f"ntt_stage {F.name} DIF (14, 2^20), one launch per stage", dif(nt.ntt_stage_), dif(nt._stage_plain_),
                dif_cost, time_fn=dif(nt.ntt_stage_, scratch))
        compare(f"ntt_stage {F.name} DIT (14, 2^18), one launch per stage",
                lambda: _dit(F, nt.ntt_stage_, lde[:, : 1 << 18].contiguous(), tables[:18]),
                lambda: _dit(F, nt._stage_plain_, lde[:, : 1 << 18].contiguous(), tables[:18]),
                (16 * n18 + 8 * (1 << 18), mul_ops * 18 * n18 // 2))
        check_passes(F, D, eng, lde, compare, mul_ops, first=F is GL_OPS)
        compare(f"ntt_stage + lde_tile {F.name} whole DIF (14, 2^20) through NttEngine._dif: K2 passes "
                f"{nt.pass_plan(lde_log, ct.tile_log_for(lde_w, lde_log, False), nt.PASS_STAGES)}, K14 tail",
                lambda: eng._dif(lde, lde_log, False), dif(nt._stage_plain_), dif_cost,
                time_fn=lambda: eng._dif_(scratch, lde_log, False))
        k_dit = ct.tile_log_for(lde_w, 18, False)
        compare(f"lde_tile + ntt_stage {F.name} whole DIT (14, 2^18) through NttEngine._dit: K14 head 2^{k_dit}, "
                f"K2 passes {nt.pass_plan(18, k_dit, nt.PASS_STAGES)[::-1]}",
                lambda: eng._dit(lde[:, : 1 << 18], 18, False),
                lambda: _dit(F, nt._stage_plain_, lde[:, : 1 << 18].contiguous(), tables[:18]),
                (16 * n18 + 8 * (1 << 18), mul_ops * 18 * n18 // 2))

        # K4: the stage-2 chain over 13 slots of 2^18 rows
        chain = rnd(F, D, 13 << 18)
        chain[:, 5] = 0  # zero maps to zero
        N = chain.shape[1]
        binv_ops = 3 * ext_muls * mul_ops * N
        compare(f"gl_scan {E.name} cumsum ({D}, 13·2^18)", lambda: utils.cumsum(chain, E),
                lambda: utils.cumsum_plain(chain, E), (16 * chain.numel(), 2 * chain.numel()), device=True)
        compare(f"gl_scan {F.name} field_sum (14, 2^18)", lambda: utils.field_sum(lde[:, : 1 << 18], F),
                lambda: utils.field_sum_plain(lde[:, : 1 << 18], F), (8 * n18 + 8 * lde_w, 2 * n18), device=True)
        compare(f"gl_scan {E.name} batch_inv ({D}, 13·2^18)", lambda: utils.batch_inv(chain, E),
                lambda: utils.batch_inv_plain(chain, E), (16 * chain.numel(), binv_ops), iters=3,
                name="gl_scan" if F is GL_OPS else None, device=True)
        # the two fused entries: the sum of inverses (the claims accumulator's)
        # and the stage-2 chain from K11's messages
        compare(f"gl_scan {E.name} inv_sum ({D}, 13·2^18)", lambda: utils.inv_sum(chain, E),
                lambda: utils.inv_sum_plain(chain, E), (8 * chain.numel() + 8 * D, binv_ops + 2 * D * N), device=True)
        msgs = torch.cat([chain, rnd(F, 1, N)])  # (D + 1, 13·2^18): messages, multiplicities
        acc = rnd(F, D)
        chain_ops = binv_ops + (D * mul_ops + 2 * 2 * D) * N  # inverses, terms, prefix sum, accumulator
        compare(f"gl_scan {E.name} stage2_chain (D + 1, 13·2^18), 13 slots",
                lambda: torch.cat([t.reshape(-1) for t in utils.stage2_chain(E, 13, msgs, acc)]),
                lambda: torch.cat([t.reshape(-1) for t in utils.stage2_chain_plain(E, 13, msgs, acc)]),
                (8 * msgs.numel() + 8 * D * N + 16 * D, chain_ops), iters=3,
                time_fn=lambda: utils.stage2_chain(E, 13, msgs, acc), device=True)
        unfused = cuda_ms(lambda: unfused_stage2_chain(E, 13, msgs, acc), 3)
        say("kernels", f"gl_scan {E.name} stage-2 chain as the parent composed it (K4 batch_inv, K1 scale, K4 "
            f"cumsum, cat, K1 add, permute): {unfused:.4f} ms")
        check_scan_edges(F, E, rnd)

        # K3 / K6: leaf hashing of the stage-1 LDE, a 2^20-leaf tree
        if F is GL_OPS:
            hasher, mod, hname, per_hash = Blake3FieldHasher(), b3, "blake3_merkle", OPS_PER_BLAKE3
            blocks = -(-(8 * lde_w) // 64)
        else:
            hasher, mod, hname, per_hash = Poseidon2FieldHasher(), p2, "poseidon2_merkle", OPS_PER_POSEIDON2
            blocks = -(-lde_w // 8)
        compare(f"{hname} hash_rows (14, 2^20)", lambda: mod.hash_rows([lde]), lambda: mod.hash_rows_plain([lde]),
                (8 * n_lde + 32 * (1 << lde_log), blocks * per_hash * (1 << lde_log)), name=hname, device=True)
        if F is GL_OPS:
            s2 = rnd(F, 26, 1 << 20)
            compare("blake3_merkle hash_rows (26, 2^20)", lambda: b3.hash_rows([s2]), lambda: b3.hash_rows_plain([s2]),
                    (8 * 26 * m + 32 * m, 4 * per_hash * m))
            wide = rnd(F, 520, 1 << 12)  # 4160-byte rows: five chunks, four parents
            compare("blake3_merkle hash_rows (520, 2^12), rows of 4160 bytes (the chunk tree)",
                    lambda: b3.hash_rows([wide]), lambda: b3.hash_rows_plain([wide]),
                    (8 * wide.numel() + 32 * (1 << 12), (65 + 4) * per_hash * (1 << 12)))
            check_fri_leaves(F, rnd, compare)
        else:
            check_poseidon2_rows(F, rnd, compare)
        leaves = mod.hash_rows([lde])
        mmcs = MerkleMmcs(hasher, 0)
        t0 = time.perf_counter()
        cap, _ = mmcs.commit([lde])
        torch.cuda.synchronize()
        say("kernels", f"{hname} 2^20-leaf tree commit (leaves, then K15 levels): "
            f"{1e3 * (time.perf_counter() - t0):.2f} ms")
        ref = leaves
        while ref.shape[0] > 1:
            ref = mod.compress_pairs_plain(ref[0::2], ref[1::2])
        if not np.array_equal(cap, ref.cpu().numpy().view(np.uint32)):
            raise AssertionError(f"{hname}: 2^20-leaf tree root disagrees with the plain version")

        # K14 and K15: the bench commits' tiles and tree levels
        check_commit_tiles(dev, F, hasher, rnd, compare, per_hash, mul_ops, first=F is GL_OPS)

        # K10: the FRI rounds' fold into the next level; K9: the claims accumulator
        check_fri_fold(F, E, rnd, compare, mul_ops, ext_muls, first=F is GL_OPS)
        check_claims_acc(F, E, rnd, compare, mul_ops, ext_muls, first=F is GL_OPS)

        # K11: the three programs of U32Add at 2^18 rows (the quotient on its
        # stored LDEs, the witness's lookup values, the stage-2 messages)
        check_programs(dev, F, E, rnd, compare, mul_ops, first=F is GL_OPS)

        # K12 and K13: the claimed evaluations and the reduced openings at
        # the bench's heights
        check_claimed_evaluations(dev, F, E, rnd, compare, mul_ops, lde, first=F is GL_OPS)
        check_reduced_openings(dev, F, E, rnd, compare, mul_ops, ext_muls, lde, first=F is GL_OPS)

    # K8: the FRI round's grind at every edge of its prefix, then at the
    # bench's 10 bits over chain ‖ cap
    check_grind(dev, rng, compare)

    # K7: the β/γ flush of a 2^18-row prove (random cap and claims)
    inputs = beta_gamma_flush(dev, 18, rng)
    plan = inputs.plan.tolist()
    T, S, n_ops = plan[1], plan[2], plan[3]
    compressions = sum(max(1, -(-plan[6 + 2 * t] // 64)) for t in range(T)) + n_ops
    say("kernels", f"dt_flush plan: {plan[0]} chunks, {T} on the device, {S} host siblings, {n_ops} parent ops")

    def flush(fn):
        return lambda: torch.cat([t.reshape(-1).to(torch.int64) for t in fn(*inputs[:4])])

    compare("dt_flush 2^18 beta/gamma flush", lambda: torch.cat([t.reshape(-1).to(torch.int64)
                                                                   for t in dt.dt_flush(*inputs)]),
            flush(dt.dt_flush_plain),
            (1024 * T + 32 * S + 4 * inputs.plan.numel() + 32 + 64, compressions * OPS_PER_BLAKE3), name="dt_flush",
            time_fn=lambda: dt.dt_flush(*inputs), device=True)
    say("kernels", f"dt_flush 2^18 beta/gamma flush: latency floor {inputs.chain} dependent compressions x "
        f"{LATENCY_US['Goldilocks']:.4f} us = {inputs.chain * LATENCY_US['Goldilocks'] / 1e3:.4f} ms")
    return rows


def parent_powers(E, alpha, count):
    """The α-power table as the parent built it: doubling, one ext product
    and one square per step, each followed by a concatenation."""
    import torch

    pows = torch.zeros((E.D, 1), dtype=torch.int64, device=alpha.device)
    pows[0] = 1
    step = alpha.reshape(E.D, 1)
    while pows.shape[1] < count:
        pows = torch.cat([pows, E.mul(pows, step)], dim=1)
        if pows.shape[1] < count:
            step = E.square(step)
    return pows[:, :count]


def check_arith(F, E, arith, rnd, compare, mul_ops, ext_muls, first: bool) -> None:
    """K1 / K5: every op against its plain version at the shapes the prove
    broadcasts by period (a (w, n) matrix times a row vector of n: the coset
    and scale tables; a scalar; two full operands; an extension scalar; rows
    of an extension matrix; an odd period; a view that does not lie on 16
    bytes; more than 65535 rows of a short period; a column, as the opening
    points against the coset's x), each launched twice;
    the coset product timed; then the powers entry at counts 1 to 300, each
    launched twice, timed at the prove's counts beside the parent's doubling
    loop, and one extension product's latency (a one-thread chain of
    squarings, the powers entry's floor per bit)."""
    import torch

    D = E.D
    k = 1 << 14
    big = rnd(F, 3, k + 1)
    base_cases = (("(14, 2^14) x (2^14,)", (14, k), (k,)), ("(2^14,) x ()", (k,), ()),
                  ("(14, 2^14) x (14, 2^14)", (14, k), (14, k)), ("(3, 7, 2^10) x (7, 2^10)", (3, 7, 1024), (7, 1024)),
                  ("(1001,) x (1001,)", (1001,), (1001,)), ("(70000, 2) x (2,)", (70000, 2), (2,)),
                  ("(2, 2^20) x (2, 1), a column", (2, 1 << 20), (2, 1)),
                  ("(70000, 2) x (70000, 1), a column", (70000, 2), (70000, 1)))
    cases = 0

    def check(label, got_fn, want):
        nonlocal cases
        for _ in range(2):
            got = got_fn()
            if max_abs_err(got, torch.broadcast_to(want, got.shape)) != 0:
                raise AssertionError(f"{arith} {label}: kernel disagrees with its plain version")
            cases += 1

    for name, sa, sb in base_cases:
        a, b = rnd(F, *sa), rnd(F, *sb)
        for op in ("add", "sub", "mul"):
            fn, plain = getattr(F, op), getattr(F, op + "_plain")
            check(f"{op} {name}", lambda: fn(a, b), plain(a, b))
            check(f"{op} {name} (operands swapped)", lambda: fn(b, a), plain(b, a))
        small = a.reshape(-1)[:4096].reshape(-1)
        check(f"neg {name}", lambda: F.neg(a), F.neg_plain(a))
        check(f"inv {name}", lambda: F.inv(small), F.inv_plain(small))
        check(f"pow {name}", lambda: F.pow(small, 0xDEADBEEF12345), F.pow_plain(small, 0xDEADBEEF12345))
        ea, eb = rnd(F, D, *sa), rnd(F, D, *sb)
        eb_al = eb.reshape((D,) + (1,) * (len(sa) - len(sb)) + tuple(sb))
        for op in ("add", "sub", "mul"):
            fn, plain = getattr(E, op), getattr(E, op + "_plain")
            check(f"ext {op} {name}", lambda: fn(ea, eb), plain(ea, eb_al))
        check(f"ext scale {name}", lambda: E.scale(ea, b), E.scale_plain(ea, b))
        esmall = ea.reshape(D, -1)[:, :2048]
        check(f"ext inv {name}", lambda: E.inv(esmall), E.inv_plain(esmall))
    odd = big[1, 1:]  # a view 8 bytes past a 16-byte boundary
    row = rnd(F, k)
    check("mul of a view off 16 bytes", lambda: F.mul(odd, row), F.mul_plain(odd, row))
    torch.cuda.synchronize()
    say("kernels", f"{arith}: {cases} cases (every op, each launched twice, at {len(base_cases)} period and column "
        "shapes and a view off 16 bytes) bit-equal to the plain versions")

    rows_w, n = 14, 1 << 18  # the coset product of the stage-1 trace: (14, 2^18) x its scale table
    mat, tab = rnd(F, rows_w, n), rnd(F, n)
    compare(f"{arith} coset product (14, 2^18) x (2^18,)", lambda: F.mul(mat, tab), lambda: F.mul_plain(mat, tab),
            (8 * (2 * rows_w * n + n), mul_ops * rows_w * n), device=True)

    for count in range(1, 301):
        alpha = rnd(F, D)
        want = E.powers_plain(alpha, count)
        for _ in range(2):
            if max_abs_err(E.powers(alpha, count), want) != 0:
                raise AssertionError(f"{arith} powers count={count}: kernel disagrees with the sequential product")
    say("kernels", f"{arith} powers: counts 1 to 300, each launched twice, bit-equal to the sequential product")

    x = rnd(F, D)
    if not torch.equal(E.chain(x, 64), E.chain(x.cpu(), 64).to(x.device)):
        raise AssertionError(f"{arith}: 64 chained squarings disagree with the plain version")
    t_n, t_0 = cuda_ms(lambda: E.chain(x, 4096), 3), cuda_ms(lambda: E.chain(x, 0), 3)
    lat_us = 1e3 * (t_n - t_0) / 4096
    EXT_LATENCY_US[F.name] = lat_us
    say("kernels", f"{arith} {E.name} product latency: {lat_us:.4f} us (a one-thread chain of 4096 squarings, "
        f"{t_n:.4f} ms, less an empty chain {t_0:.4f} ms; equal to the plain chain at 64)")
    for count in (28, 42, 100, 300):
        alpha = rnd(F, D)
        bits = (count - 1).bit_length()
        compare(f"{arith} powers count={count}: latency floor {bits} x {lat_us:.4f} us = {bits * lat_us / 1e3:.4f} ms",
                lambda: E.powers(alpha, count), lambda: E.powers_plain(alpha, count),
                (8 * D * (count + 1), count * (bits + 1) * ext_muls * mul_ops), device=True)
        say("kernels", f"{arith} powers count={count}: the parent's doubling loop ({2 * bits - 1} launches of "
            f"{arith}, {bits} concatenations): {cuda_ms(lambda: parent_powers(E, alpha, count), 5):.4f} ms, "
            f"device_ms={device_ms(lambda: parent_powers(E, alpha, count)):.4f}")


def check_fri_leaves(F, rnd, compare) -> None:
    """K3's FRI entry against its plain version (the PyTorch layout copy,
    then the rows' digests) at every FRI level of the 2^18 prove (2^20 down
    to 2^3 positions) for arity 2, 4 and 16, GL2 values, each launched
    twice; the 2^20-position round timed beside the parent's structure (the
    copy, then hash_rows), and the prove's 18 levels in a row both ways."""
    import torch

    from multistark_tpu_torch.hash import blake3 as b3
    from multistark_tpu_torch.utils import fold_rows

    cases = 0
    for log_n in range(20, 2, -1):
        vec = rnd(F, 2, 1 << log_n)
        for a_bits in (1, 2, 4):
            if a_bits > log_n:
                continue
            want = torch.cat([t.reshape(-1).to(torch.int64) for t in b3.fri_leaves_plain(vec, a_bits)])
            for _ in range(2):
                got = torch.cat([t.reshape(-1).to(torch.int64) for t in b3.fri_leaves(vec, a_bits)])
                if max_abs_err(got, want) != 0:
                    raise AssertionError(f"blake3_merkle fri_leaves 2^{log_n} positions a_bits={a_bits}: "
                                         "kernel disagrees with its plain version")
                cases += 1
    torch.cuda.synchronize()
    say("kernels", f"blake3_merkle fri_leaves: {cases} cases (2^20 down to 2^3 positions; arity 2, 4, 16; each "
        "launched twice) bit-equal to the plain version")

    def flat(fn):
        return lambda: torch.cat([t.reshape(-1).to(torch.int64) for t in fn()])

    N = 1 << 20
    vec = rnd(F, 2, N)
    M = N // 2
    compare("blake3_merkle fri_leaves (2, 2^20), arity 2: the first FRI level's matrix and 2^19 leaves",
            flat(lambda: b3.fri_leaves(vec, 1)), flat(lambda: b3.fri_leaves_plain(vec, 1)),
            (16 * 2 * N + 32 * M, M * OPS_PER_BLAKE3), name="blake3_merkle", time_fn=lambda: b3.fri_leaves(vec, 1),
            device=True)

    def pair():
        return b3.hash_rows([fold_rows(vec, 1)])

    say("kernels", f"blake3_merkle the parent's structure on the same level (PyTorch's layout copy, then hash_rows): "
        f"{cuda_ms(pair, 5):.4f} ms, device_ms={device_ms(pair):.4f}")
    levels = [rnd(F, 2, 1 << k) for k in range(20, 2, -1)]

    def rounds_new():
        return [b3.fri_leaves(v, 1) for v in levels]

    def rounds_parent():
        return [b3.hash_rows([fold_rows(v, 1)]) for v in levels]

    say("kernels", f"blake3_merkle the 2^18 prove's 18 FRI levels in a row (2^20 down to 2^3 positions): fri_leaves "
        f"{cuda_ms(rounds_new, 5):.4f} ms, device_ms={device_ms(rounds_new):.4f}; the parent's copy + hash_rows "
        f"pairs {cuda_ms(rounds_parent, 5):.4f} ms, device_ms={device_ms(rounds_parent):.4f}")


def check_poseidon2_rows(F, rnd, compare) -> None:
    """K6 against its plain version, each case launched twice: every FRI
    level of the BabyBear 2^14 and 2^18 proves ((8, 2^2) to (8, 2^19):
    arity 2, D = 4), the stage-1 LDE's width (14, 2^20), two and sixteen
    same-height matrices, a short last chunk, one row, and the rows on both
    sides of the four-lane threshold in both modes; then the 2^18 prove's 18
    levels in a row (device ms) and one permutation's latency in each mode
    (a chain of dependent permutations, as K15's node latency is taken)."""
    import torch

    from multistark_tpu_torch import kernels
    from multistark_tpu_torch.hash import poseidon2 as p2

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    edge = p2.LANE_ROWS_PER_SM * sms
    cases = [[(8, 1 << k)] for k in range(2, 20)] + [
        [(14, 1 << 20)], [(14, 1 << 12), (2, 1 << 12)], [(w, 1 << 10) for w in range(1, 17)], [(13, 1 << 16)],
        [(8, 1)], [(14, 1)], [(8, edge)], [(8, edge + 1)], [(14, edge - 1)], [(14, edge + 1)]]
    launches = 0
    for shapes in cases:
        mats = [rnd(F, w, n) for w, n in shapes]
        n = shapes[0][1]
        want = p2.hash_rows_plain(mats)
        plans = [p2.hash_rows_plan(n, sms)]
        if abs(n - edge) <= 1:  # both modes at the threshold
            plans.append(p2.hash_rows_plan(n, sms, 1 - plans[0].mode))
        for plan in plans:
            for _ in range(2):
                if max_abs_err(p2.hash_rows(mats, plan=plan), want) != 0:
                    raise AssertionError(f"poseidon2_merkle hash_rows {shapes}, plan {plan}: kernel disagrees with "
                                         "its plain version")
                launches += 1
    torch.cuda.synchronize()
    say("kernels", f"poseidon2_merkle: {len(cases)} cases, {launches} launches (FRI levels (8, 2^2) to (8, 2^19), "
        f"(14, 2^20), 2 and 16 matrices, a short last chunk, one row, both modes at the threshold {edge} rows) "
        "bit-equal to the plain version")
    levels = [rnd(F, 8, 1 << k) for k in range(19, 1, -1)]
    for mats in ([levels[0]], [levels[-6]]):  # the first FRI level and a short one
        n = mats[0].shape[1]
        compare(f"poseidon2_merkle hash_rows (8, 2^{n.bit_length() - 1}), plan {p2.hash_rows_plan(n, sms)}",
                lambda mats=mats: p2.hash_rows(mats), lambda mats=mats: p2.hash_rows_plain(mats),
                (8 * 8 * n + 32 * n, n * OPS_PER_POSEIDON2), device=True)
    say("kernels", f"poseidon2_merkle the 2^18 prove's 18 FRI levels in a row ((8, 2^19) down to (8, 2^2)): "
        f"device_ms={device_ms(lambda: [p2.hash_rows([m]) for m in levels]):.4f}; the 14 of the 2^14 prove: "
        f"device_ms={device_ms(lambda: [p2.hash_rows([m]) for m in levels[4:]]):.4f}")
    state = rnd(F, 1, 16).to(torch.int32)
    for mode, label in ((p2.MODE_THREAD, "a thread"), (p2.MODE_LANES, "a group of four lanes")):
        if not torch.equal(p2.permute_chain(state, 64, mode), p2.permute_chain_plain(state, 64)):
            raise AssertionError(f"poseidon2_merkle: 64 chained permutations on {label} disagree with the plain "
                                 "version")
        n = 4096
        t_n = cuda_ms(lambda: p2.permute_chain(state, n, mode), 3)
        t_0 = cuda_ms(lambda: p2.permute_chain(state, 0, mode), 3)
        say("kernels", f"poseidon2_merkle permutation latency on {label}: {1e3 * (t_n - t_0) / n:.4f} us (a chain "
            f"of {n}, {t_n:.4f} ms, less an empty chain {t_0:.4f} ms; equal to the plain chain at 64; "
            f"kernels.POSEIDON2_LATENCY_MS holds {1e3 * kernels.POSEIDON2_LATENCY_MS[mode]:.4f} us)")


def check_fri_fold(F, E, rnd, compare, mul_ops, ext_muls, first: bool) -> None:
    """K10 (`pcs.fri_fold_level`) against its plain version (the vector's
    fold, the next level's layout, the plain leaf hash) at the prove's shapes,
    each launched twice, from the level's matrix and from its vector: a round
    of 2^20 positions at arity 2 into a next level of arity 2 and at arity 4
    into arity 16, with and without the absorb, the last round (the final
    vector), arity 16 into 4, and small levels; GL2 with the BLAKE3 leaves,
    BB4 the matrix alone (K6 hashes it), and BabyBear's first-level layout
    (a = 0).  The 2^20-position round timed; for GoldilocksBlake3 the 2^18
    prove's 18 chained rounds (K3's first level, then 2^20 down to 2^2
    positions) beside the parent's structure on the same levels (the fold
    vector, then K3's FRI entry for each level)."""
    import torch

    from multistark_tpu_torch import pcs
    from multistark_tpu_torch.hash import blake3 as b3
    from multistark_tpu_torch.merkle import Blake3FieldHasher
    from multistark_tpu_torch.utils import fold_rows

    D, half = E.D, F.host.inv(2)
    hasher = Blake3FieldHasher() if first else None

    def flat(out):
        mat, leaves = out
        return torch.cat([mat.reshape(-1)] + ([] if leaves is None else [leaves.reshape(-1).to(torch.int64)]))

    N = 1 << 20
    vec, beta = rnd(F, D, N), rnd(F, D)
    cases = 0
    # (a_bits, next_a_bits, log2 positions, absorb)
    for a, na, log_n, absorb in ((1, 1, 20, False), (1, 1, 20, True), (2, 4, 20, False), (2, 4, 20, True),
                                 (4, 2, 14, True), (1, 0, 3, True), (1, 0, 3, False), (1, 1, 3, True),
                                 (3, 1, 9, False)):
        n = 1 << log_n
        v = vec[:, :n].contiguous()
        ix, ab = rnd(F, n // 2), (rnd(F, D, n >> a) if absorb else None)
        h = hasher if na else None
        for src in (fold_rows(v, a), v):
            want = flat(pcs.fri_fold_level_plain(E, src, beta, ix, half, a, na, ab, h))
            for _ in range(2):
                if max_abs_err(flat(pcs.fri_fold_level(E, src, beta, ix, half, a, na, ab, hasher=h)), want) != 0:
                    raise AssertionError(f"fri_fold {E.name} 2^{log_n} positions a_bits={a} next_a_bits={na} "
                                         f"absorb={absorb} from a {tuple(src.shape)} input: kernel disagrees with "
                                         "its plain version")
                cases += 1
    if not first:
        for na in (1, 2, 4):  # BabyBear's first level: the vector laid out as its matrix
            want = pcs.fri_fold_level_plain(E, vec, None, None, 0, 0, na)[0]
            for _ in range(2):
                if max_abs_err(pcs.fri_fold_level(E, vec, None, None, 0, 0, na)[0], want) != 0:
                    raise AssertionError(f"fri_fold {E.name} layout (a_bits=0) next_a_bits={na}: kernel disagrees")
                cases += 1
    torch.cuda.synchronize()
    say("kernels", f"fri_fold {E.name}: {cases} cases (2^20 down to 2^3 positions; arity 2 into 2, 4 into 16, 16 "
        "into 4, 8 into 2, the last round; with and without the absorb; from the level's matrix and from its "
        f"vector; {'the BLAKE3 leaves' if first else 'the matrix alone, and the first level laid out'}; each "
        "launched twice) bit-equal to the plain version")

    M, M2 = N // 2, N // 4
    level = fold_rows(vec, 1)  # the first level's (2D, 2^19) matrix
    ix = rnd(F, N // 2)
    leaf_ops = M2 * -(-(16 * D) // 64) * OPS_PER_BLAKE3 if first else 0
    compare(f"fri_fold {E.name} a round of 2^20 positions, arity 2, into the next level's ({2 * D}, 2^18) matrix"
            + (" and its 2^18 leaves" if first else ""),
            lambda: flat(pcs.fri_fold_level(E, level, beta, ix, half, 1, 1, hasher=hasher)),
            lambda: flat(pcs.fri_fold_level_plain(E, level, beta, ix, half, 1, 1, None, hasher)),
            (8 * D * N + 4 * N + 8 * D * M + (32 * M2 if first else 0), M * (1 + 2 * D + ext_muls) * mul_ops + leaf_ops),
            name="fri_fold" if first else None, time_fn=lambda: pcs.fri_fold_level(E, level, beta, ix, half, 1, 1,
                                                                                   hasher=hasher), device=True)
    if not first:
        return
    tables = [rnd(F, 1 << (19 - r)) for r in range(18)]  # round r folds 2^(20 - r) positions

    def rounds_new():
        lvl, _ = b3.fri_leaves(vec, 1)
        for r in range(18):
            lvl, _ = pcs.fri_fold_level(E, lvl, beta, tables[r], half, 1, int(r < 17), hasher=hasher)
        return lvl

    def rounds_parent():
        v = vec
        b3.fri_leaves(v, 1)
        for r in range(18):
            v = pcs.fri_fold(E, v, beta, tables[r], half, 1)
            if r < 17:
                b3.fri_leaves(v, 1)
        return v

    if max_abs_err(rounds_new(), rounds_parent()) != 0:
        raise AssertionError("fri_fold: the 18 chained rounds end in another final vector than the parent's structure")
    say("kernels", f"fri_fold the 2^18 prove's 18 chained rounds (K3's first level, then 2^20 down to 2^2 positions, "
        f"arity 2): K10 into each next level {cuda_ms(rounds_new, 5):.4f} ms, device_ms={device_ms(rounds_new):.4f}; "
        f"the parent's structure (K10's vector fold, then K3's FRI entry) {cuda_ms(rounds_parent, 5):.4f} ms, "
        f"device_ms={device_ms(rounds_parent):.4f}; the same final vector")


def check_claims_acc(F, E, rnd, compare, mul_ops, ext_muls, first: bool) -> None:
    """K9 (`lookup.claims_acc`) against its plain version (the messages by
    Horner, then the batch inverse's sum) on row-major claims, each launched
    twice: the bench's (2^18, 4), counts around the block (128 claims), the
    tile (512) and the grid's cap (4096 tiles, past which blocks loop),
    widths 0 to 4, a view off 16 bytes, and a zero message (β =
    -fingerprint(claim 3), which must contribute zero); then one extension
    inversion's latency (a one-thread chain) and K9's latency floor; the
    (2^18, 4) accumulator timed, and from the host array beside the
    parent's host transpose and upload and K4's sum of inverses."""
    import numpy as np
    import torch

    from multistark_tpu_torch import lookup as lk, utils

    D, he = E.D, E.host
    cases = 0
    shapes = [(n, CLAIM_WIDTH) for n in (1, 31, 127, 128, 129, 511, 512, 513, 1025, 4097, 1 << 18)]
    shapes += [(300, 0), (1000, 1), (777, 3), ((1 << 21) + 5, 1)]
    for n, L in shapes:
        claims, b, g = rnd(F, n, L), rnd(F, D), rnd(F, D)
        variants = [("", claims, b)]
        if n > 3:
            fp = lk.fingerprint(he, tuple(int(c) for c in F.to_np(g)), [int(v) for v in F.to_np(claims[3])])
            variants.append((" with claim 3's message zero", claims, E.const(he.neg(fp), claims.device)))
        if L % 2 == 0 and n < 5000:
            view = torch.empty(claims.numel() + 1, dtype=torch.int64, device=claims.device)
            view[1:] = claims.reshape(-1)
            variants.append((" as a view off 16 bytes", view[1:].reshape(n, L), b))
        for label, cl, bb in variants:
            want = lk.claims_acc_plain(E, cl, bb, g)
            for _ in range(2):
                if max_abs_err(lk.claims_acc(E, cl, bb, g), want) != 0:
                    raise AssertionError(f"claims_fp {E.name} claims_acc ({n}, {L}){label}: kernel disagrees with "
                                         "its plain version")
                cases += 1
    torch.cuda.synchronize()
    say("kernels", f"claims_fp {E.name} claims_acc: {cases} cases (n = 1 to 2^21 + 5, widths 0 to 4, a zero message, "
        "a view off 16 bytes; each launched twice) bit-equal to the plain version")

    x = rnd(F, D)
    if not torch.equal(lk.ext_inv_chain(E, x, 16), lk.ext_inv_chain(E, x.cpu(), 16).to(x.device)):
        raise AssertionError(f"claims_fp {E.name}: 16 chained inversions disagree with the plain version")
    t_n, t_0 = cuda_ms(lambda: lk.ext_inv_chain(E, x, 1024), 3), cuda_ms(lambda: lk.ext_inv_chain(E, x, 0), 3)
    inv_us = 1e3 * (t_n - t_0) / 1024
    n, L = 1 << 18, CLAIM_WIDTH
    floor_ms = inv_us / 1e3
    say("kernels", f"claims_fp {E.name} inversion latency: {inv_us:.4f} us (a one-thread chain of 1024 inversions, "
        f"{t_n:.4f} ms, less an empty chain {t_0:.4f} ms; equal to the plain chain at 16): K9's latency floor")

    claims, b, g = rnd(F, n, L), rnd(F, D), rnd(F, D)
    compare(f"claims_fp {E.name} claims_acc ({n}, {L}) row-major: the whole accumulator, latency floor "
            f"{floor_ms:.4f} ms", lambda: lk.claims_acc(E, claims, b, g), lambda: lk.claims_acc_plain(E, claims, b, g),
            (8 * claims.numel() + 24 * D, n * ((L - 1) * D + 2 * ext_muls) * mul_ops), name="claims_fp" if first else None,
            device=True)
    host = F.to_np(claims)
    msgs = rnd(F, D, n)

    def host_ms(fn, iters=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / iters

    new_ms = host_ms(lambda: lk.claims_accumulator_device(F, E, host, b, g))
    upload_ms = host_ms(lambda: F.from_np(np.ascontiguousarray(host.T), claims.device))
    say("kernels", f"claims_fp {E.name} from the host (n, {L}) array, synchronised: upload + claims_acc "
        f"{new_ms:.4f} ms; the parent's host transpose + upload of the columns {upload_ms:.4f} ms, then its K9 "
        f"messages (not in this tree) and K4's sum of inverses ({D}, 2^18) "
        f"device_ms={device_ms(lambda: utils.inv_sum(msgs, E)):.4f}")


def bench_opened(dev, first: bool, log_n: int = 18) -> dict:
    """The bench prove's opened matrices by trace height, in the prover's
    round order (preprocessed, stage 1 and stage 2 at ζ and ζg, the
    quotient at ζ): {log trace height: [(width, number of points)]}."""
    from multistark_tpu_torch import system as sm
    from multistark_tpu_torch.test_circuits import u32_add_system_inputs

    config = bench_config(dev, "goldilocks_blake3" if first else "babybear_poseidon2")
    system, _ = sm.System.new(config, u32_add_system_inputs())
    heights = {}
    for c in system.circuits:
        ln = log_n if c.preprocessed_dims is None else c.preprocessed_dims[0].bit_length() - 1
        if c.preprocessed_dims is not None:
            heights.setdefault(ln, []).append((c.preprocessed_dims[1], 2))
        heights.setdefault(ln, []).extend([(c.main_width, 2), (c.stage2_width, 2),
                                           (config.ext.D * c.quotient_degree, 1)])
    return heights


def check_claimed_evaluations(dev, F, E, rnd, compare, mul_ops, lde, first: bool) -> None:
    """K12 against its plain version at the bench's two trace heights, one
    launch each, with random points, inverses and coset points: 2^18
    (U32Add's stage-1 LDE, the (14, 2^20) of phase 3, its stage-2 and
    quotient LDEs) and 2^8 (ByteTable's four matrices), U32Add's at 2^14
    (tiles sized down so that every SM gets one), then heights of one tile
    and below one warp (2^5 and 2^3 rows); each launched twice in a row
    (the second launch finds the arrival counter the first reset); at 2^18
    also the parent's launch structure on this kernel (one launch per
    matrix) and the profiler's device time."""
    import torch

    from multistark_tpu_torch import pcs

    hf, D = F.host, E.D
    cases = (sorted(bench_opened(dev, first).items(), reverse=True) + [(14, bench_opened(dev, first, 14)[14])]
             + [(5, [(2, 1), (3, 2)]), (3, [(3, 2)])])
    for log_n, widths in cases:
        n, N = 1 << log_n, 1 << (log_n + BENCH_COMMIT["log_blowup"])
        mats = [lde[:w] if w <= lde.shape[0] and N == lde.shape[1] else rnd(F, w, N) for w, _ in widths]
        openings = [list(range(k)) for _, k in widths]
        P = max(k for _, k in widths)
        zs, invs, x = [rnd(F, D) for _ in range(P)], [rnd(F, D, n) for _ in range(P)], rnd(F, n)
        s_n = hf.pow(hf.generator, n)
        inv_ns = hf.inv(hf.mul(n % hf.p, s_n))

        def run(fn, mats=mats, openings=openings, log_n=log_n, zs=zs, invs=invs, x=x, s_n=s_n, inv_ns=inv_ns):
            return lambda: torch.cat([v.reshape(-1) for vals in fn(E, mats, log_n, openings, zs, invs, x, s_n, inv_ns)
                                      for v in vals])

        want = run(pcs.bary_eval_height_plain)()
        for _ in range(2):
            if max_abs_err(run(pcs.bary_eval_height)(), want) != 0:
                raise AssertionError(f"bary_eval {E.name} 2^{log_n} {widths}: kernel disagrees with its plain version")
        pairs = sum(w * k for w, k in widths)
        cost = (8 * (n * (sum(w for w, _ in widths) + P * D + 1) + D * pairs), n * D * (pairs + P) * mul_ops)
        label = f"bary_eval {E.name} trace height 2^{log_n}, {len(widths)} matrices {widths} (width, points)"
        compare(f"{label} (two launches in a row bit-equal before)", run(pcs.bary_eval_height),
                run(pcs.bary_eval_height_plain), cost, name="bary_eval" if first and log_n == 18 else None,
                time_fn=lambda: pcs.bary_eval_height(E, mats, log_n, openings, zs, invs, x, s_n, inv_ns), device=True)
        if log_n == 18:
            def per_matrix():
                return [pcs.bary_eval_height(E, [m], log_n, [o], zs, invs, x, s_n, inv_ns)
                        for m, o in zip(mats, openings)]

            say("kernels", f"{label}: the parent's launch structure on this kernel (one launch per matrix): "
                f"{cuda_ms(per_matrix, 5):.4f} ms, device_ms={device_ms(per_matrix):.4f}")


def check_grind(dev, rng, compare) -> None:
    """K8 against its plain version (grind_round and sample_ext_from_digest
    on the card): duplex inputs of L words around every edge of its prefix
    (w's low word at a block's start, middle and last word, the last block
    of a one-chunk message, a second chunk, w's high word alone in the next
    chunk, a third chunk), bits 0, 1, 10 and 16, β of D = 1..3, each
    launched twice in a row; then inputs at 16 bits until one's least
    witness lies past the first wave (a thread's second candidate); then
    the bench's round (L = 16, 10 bits) timed, with its least time from
    this run's witness and the latency floor beside."""
    import numpy as np
    import torch

    from multistark_tpu_torch import device_transcript as dt

    def words(L):
        return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, L).astype(np.int32)).to(dev)

    def flat(outs):
        return torch.cat([t.reshape(-1).to(torch.int64) for t in outs])

    def check(inp, bits, label):
        w, digest, found = dt.grind_round(inp, bits)
        for D in (1, 2, 3):
            beta, valid = dt.sample_ext_from_digest(digest, D)
            want = flat((w, (found & valid).to(torch.int64), beta, digest))
            for _ in range(2):
                if max_abs_err(flat(dt.fri_grind(inp, bits, D)), want) != 0:
                    raise AssertionError(f"fri_grind {label} bits={bits} D={D}: kernel disagrees with its plain "
                                         "version")
        return int(w)

    cases = 0
    for L in (8, 15, 16, 17, 254, 255, 256, 300, 767):
        inp = words(L)
        for bits in (0, 1, 10, 16):
            check(inp, bits, f"L={L}")
            cases += 6
    first_wave = min(1024 * 128, 16 << 16)  # GRIND_MAX_BLOCKS x GRIND_THREADS in csrc/dt_blake3.cu
    for tries in range(1, 201):
        inp = words(16)
        if int(dt.fri_grind(inp, 16, 2)[0]) >= first_wave:
            break
    else:
        raise AssertionError("fri_grind: no input in 200 had its least witness at 16 bits past the first wave")
    w = check(inp, 16, "past the first wave")
    torch.cuda.synchronize()
    say("kernels", f"fri_grind: {cases + 6} cases (L = 8, 15, 16, 17, 254, 255, 256, 300, 767 words; bits 0, 1, 10, "
        f"16; D = 1..3; each launched twice) bit-equal to the plain version, one of them (try {tries}) with its "
        f"least witness {w} past the first wave of {first_wave} candidates")

    bits, L = BENCH_FRI["commit_proof_of_work_bits"], 16
    inp = words(L)
    w = int(dt.fri_grind(inp, bits, 2)[0])
    prefix, per = dt.grind_compressions(L)
    ops = ((w + 1) * per + prefix + per) * OPS_PER_BLAKE3  # candidates 0..w, the prefix, the winner again

    def grind(fn):
        return lambda: flat(fn(inp, bits, 2))

    compare(f"fri_grind bench round: L = {L}, 2^{bits} bits, least witness {w}", grind(dt.fri_grind),
            grind(dt.fri_grind_plain), (4 * L + 8 * 8 + 32, ops), name="fri_grind",
            time_fn=lambda: dt.fri_grind(inp, bits, 2), device=True)
    lat = LATENCY_US["Goldilocks"]
    say("kernels", f"fri_grind bench round: latency floor {prefix + 2 * per} dependent compressions x {lat:.4f} us = "
        f"{(prefix + 2 * per) * lat / 1e3:.4f} ms; the old bound (every candidate hashed in full) "
        f"{1e3 * (64 << bits) * -(-(4 * L + 8) // 64) * OPS_PER_BLAKE3 / INT_OPS_PER_S:.4f} ms")

    def rounds(n_rounds=18):
        """A commit phase's grinds in a row: each round's digest is the next
        round's chain, beside 8 cap words."""
        chain = inp[:8]
        for _ in range(n_rounds):
            chain = dt.fri_grind(torch.cat([chain, inp[8:]]), bits, 2)[3]
        return chain

    say("kernels", f"fri_grind 18 chained rounds (L = {L}, 2^{bits} bits): {cuda_ms(rounds, 5):.4f} ms, "
        f"device_ms={device_ms(rounds):.4f}")


def check_reduced_openings(dev, F, E, rnd, compare, mul_ops, ext_muls, lde, first: bool) -> None:
    """K13 against its plain version at the bench's two LDE heights, with
    the prover's rounds (preprocessed, stage 1 and stage 2 at ζ and ζg, the
    quotient at ζ) and random claimed values, inverses and α: 2^20
    (U32Add's stage-1, stage-2 and quotient matrices) and 2^10 (ByteTable's
    four), one scalar and one row launch each; the parent's per-matrix
    composition (one call per matrix, adding into the sum) timed beside;
    the adding path against the plain version; profiler device time."""
    from multistark_tpu_torch import pcs, utils

    D, P, b = E.D, 2, BENCH_COMMIT["log_blowup"]
    heights = {log_n + b: widths for log_n, widths in bench_opened(dev, first).items()}
    for log_lde in sorted(heights, reverse=True):
        widths, N = heights[log_lde], 1 << log_lde
        count = sum(w * k for w, k in widths)
        mats = [lde[:w] if w <= lde.shape[0] and N == lde.shape[1] else rnd(F, w, N) for w, _ in widths]
        apows = utils.ext_powers_device(E, rnd(F, D), count).contiguous()  # α^0 .. α^(count - 1), as the prover
        invs = [rnd(F, D, N) for _ in range(P)]
        openings, off = [], 0
        for w, k in widths:
            openings.append([(p, off + p * w, rnd(F, D, w)) for p in range(k)])
            off += w * k
        cols, pairs = sum(w for w, _ in widths), sum(k for _, k in widths)
        cost = (8 * N * (cols + P * D + D), N * (cols * D + (pairs + P) * ext_muls) * mul_ops)
        label = f"reduced_open {E.name} LDE height 2^{log_lde}, {len(widths)} matrices {widths} (width, points)"
        compare(label, lambda: pcs.reduced_open_height(E, mats, apows, openings, invs),
                lambda: pcs.reduced_open_height_plain(E, mats, apows, openings, invs), cost,
                name="reduced_open" if first and log_lde == 20 else None, device=True)

        def per_matrix():
            ro = None
            for mat, opened in zip(mats, openings):
                ro = pcs.reduced_open_height(E, [mat], apows, [opened], invs, ro)
            return ro

        say("kernels", f"{label}: the parent's per-matrix composition (one K13 call per matrix, each adding into "
            f"the sum): {cuda_ms(per_matrix, 5):.4f} ms, device_ms={device_ms(per_matrix):.4f}")
        acc = rnd(F, D, N)
        compare(f"{label}, added into a running sum",
                lambda: pcs.reduced_open_height(E, mats, apows, openings, invs, acc.clone()),
                lambda: pcs.reduced_open_height_plain(E, mats, apows, openings, invs, acc),
                (cost[0] + 8 * D * N, cost[1]))


def unfused_stage2_chain(E, L, msgs, acc):
    """The stage-2 chain as the parent ran it on the card: K4's batch
    inverse and cumsum, K1/K5's scale and add, and PyTorch's concatenation
    and permute (timed beside the fused entry)."""
    import torch

    from multistark_tpu_torch import utils

    D = E.D
    incl = utils.cumsum(E.scale(utils.batch_inv(msgs[:D], E), msgs[D]), E)
    excl = torch.cat([torch.zeros_like(incl[:, :1]), incl[:, :-1]], dim=1)
    acc_flat = E.add(excl, acc.reshape(D, 1))
    n = acc_flat.shape[1] // L
    return acc_flat.reshape(D, n, L).permute(2, 0, 1).reshape(L * D, n).contiguous(), incl[:, -1]


def check_scan_edges(F, E, rnd) -> None:
    """K4's entries against their plain versions around their tile sizes: n =
    1, tile - 1, tile, tile + 1 and 300 tiles + 7, one and three rows, base
    and extension values, with a whole tile of zeros and zeros on every tile
    boundary; the stage-2 chain at chain lengths around its tile for 1 and
    13 slots, with a tile of zero messages."""
    import torch

    from multistark_tpu_torch import kernels, utils

    lib = kernels.library()

    def tile(ext, kind):  # elements per tile of an entry
        return (1 << 20) // lib.gls_tiles(F.field_id, int(ext), kind, 1 << 20)

    def zeros(v, T):  # v: (..., n) view; zero a whole tile and every tile's first and last element
        v[..., T:2 * T] = 0
        v[..., ::T] = 0
        v[..., T - 1::T] = 0

    cases = 0
    for ext, ops in ((False, F), (True, E)):
        D = E.D if ext else 0
        for kind, pairs in ((utils._BATCH, ((utils.batch_inv, utils.batch_inv_plain),
                                            (utils.inv_sum, utils.inv_sum_plain))),
                            (utils._SUM, ((utils.field_sum, utils.field_sum_plain),)),
                            (utils._SCAN, ((utils.cumsum, utils.cumsum_plain),))):
            T = tile(ext and kind == utils._BATCH, kind)
            for n in (1, T - 1, T, T + 1, 300 * T + 7):
                for rows in (1, 3):
                    x = rnd(F, *(((D,) if D else ()) + (rows, n)))
                    zeros(x.reshape(-1, rows, n)[:, 0], T)
                    for fn, plain in pairs:
                        if max_abs_err(fn(x, ops), plain(x, ops)) != 0:
                            raise AssertionError(f"gl_scan {fn.__name__} {ops.name} ({rows}, {n}): kernel disagrees "
                                                 "with its plain version")
                        cases += 1
    T = tile(True, utils._CHAIN)
    for L in (1, 13):
        for N in (1, T - 1, T, T + 1, 300 * T + 7):
            n = max(1, N // L)
            msgs, acc = rnd(F, E.D + 1, n * L), rnd(F, E.D)
            zeros(msgs[: E.D], T)
            got, want = utils.stage2_chain(E, L, msgs, acc), utils.stage2_chain_plain(E, L, msgs, acc)
            if max_abs_err(got[0], want[0]) != 0 or max_abs_err(got[1], want[1]) != 0:
                raise AssertionError(f"gl_scan stage2_chain {E.name} n={n} L={L}: kernel disagrees with its plain "
                                     "version")
            cases += 1
    torch.cuda.synchronize()
    say("kernels", f"gl_scan {F.name}: {cases} edge cases (sizes around the tiles, rows 1 and 3, base and "
        f"{E.name}, zero tiles and tile boundaries, the stage-2 chain at 1 and 13 slots) bit-equal to the plain "
        "versions")


def check_passes(F, D, eng, lde, compare, mul_ops, first: bool) -> None:
    """K2's multi-stage pass against its plain version at every r it takes
    (1..PASS_MAX), at the top of the stage-1 LDE's (14, 2^20) DIF and just
    above the quotient iDFT's DIT head, and over the passes the stage-1
    commit runs above its K14 tile.  Each compared call clones its input;
    the times are taken on the kernel alone, in place on a scratch copy."""
    from multistark_tpu_torch import commit_tile as ct
    from multistark_tpu_torch.ntt import ntt as nt

    w, log_n = lde.shape[0], lde.shape[1].bit_length() - 1

    def passes(fn, x, plan, dif, inverse=False, in_place=False):
        def run():
            y = x if in_place else x.clone()
            tab = eng.tail_table(log_n, inverse)
            for s_lo, r in plan:
                fn(F, y, tab[(1 << (s_lo - 1)) - 1:], s_lo, r, dif)
            return y
        return run

    def cost(x, stages):  # x read and written once, at most a twiddle per position
        return 16 * x.numel() + 8 * x.shape[1], mul_ops * stages * x.numel() // 2

    scratch = lde.clone()
    for r in range(1, nt.PASS_MAX + 1):
        plan = [(log_n - r + 1, r)]
        compare(f"ntt_stage {F.name} pass r={r} DIF (14, 2^20) stages {log_n}..{log_n - r + 1}",
                passes(nt.ntt_pass_, lde, plan, True), passes(nt._pass_plain_, lde, plan, True), cost(lde, r),
                time_fn=passes(nt.ntt_pass_, scratch, plan, True, in_place=True))
    q = lde[:D, : 1 << 18].contiguous()  # the quotient iDFT's shape at 2^18 rows (quotient degree 1): (D, 2^18)
    q_scratch = q.clone()
    k = ct.tile_log_for(D, 18, False)
    for r in range(1, min(nt.PASS_MAX, 18 - k) + 1):
        plan = [(k + 1, r)]
        compare(f"ntt_stage {F.name} pass r={r} DIT ({D}, 2^18) stages {k + 1}..{k + r}",
                passes(nt.ntt_pass_, q, plan, False, True), passes(nt._pass_plain_, q, plan, False, True),
                cost(q, r), time_fn=passes(nt.ntt_pass_, q_scratch, plan, False, True, in_place=True))
    tile = ct.tile_log_for(w, log_n, True)
    plan = nt.pass_plan(log_n, tile, nt.PASS_STAGES)
    compare(f"ntt_stage {F.name} the stage-1 commit's passes {plan} above its tile 2^{tile} (14, 2^20)",
            passes(nt.ntt_pass_, lde, plan, True), passes(nt._pass_plain_, lde, plan, True), cost(lde, log_n - tile),
            name="ntt_stage" if first else None, time_fn=passes(nt.ntt_pass_, scratch, plan, True, in_place=True))


def check_commit_tiles(dev, F, hasher, rnd, compare, per_hash, mul_ops, first: bool) -> None:
    """K14 and K15 against their plain versions at the bench's shapes, with
    the tiles and in-tile levels the commits pick (commit_tile.tile_log_for,
    pcs.commit_plan): the stage-1 commit at 2^18 rows (U32Add (14, 2^20)
    after the K2 passes above its tile), the same with a shorter group
    injected inside the tile's levels, the stage-2 commit's width, an iDFT's
    tail (no hashing) and its head in DIT mode, the quotient iDFT's DIT
    head; then K15 above the stage-1 tile (ByteTable's (1, 1024) leaves
    injected) and a FRI round's tree (2^19 leaves, two launches).  K14 works
    in place: each compared call clones its input; the times are taken on
    the kernels alone (K14 in place on a scratch copy)."""
    import torch

    from multistark_tpu_torch import commit_tile as ct, pcs, system as sm
    from multistark_tpu_torch.ntt import ntt as nt
    from multistark_tpu_torch.test_circuits import u32_add_system_inputs

    eng = nt.NttEngine(F, F.host, dev)
    system, _ = sm.System.new(bench_config(dev, "goldilocks_blake3" if first else "babybear_poseidon2"),
                              u32_add_system_inputs())
    s2_cols = system.circuits[0].stage2_width
    D = system.config.ext.D
    leaf_hashes = (lambda c: -(-(8 * c) // 64)) if first else (lambda c: -(-c // 8))

    def tile_case(label, cols, log_n, hashed, fold=True, inject_rows=None, inverse=False, dif=True, name=None):
        """K14 on a random (cols, 2^log_n) batch with the tile the commits
        pick, folding the tile's levels the commit plan folds if `fold` (the
        tallest group of a commit); returns its digest layers."""
        k = ct.tile_log_for(cols, log_n, hashed)
        levels = pcs.commit_plan([cols], [log_n], 0, 0)[0].levels if hashed and fold else 0
        x, tw = rnd(F, cols, 1 << log_n), eng.tail_table(k, inverse)
        inject = {} if inject_rows is None else {log_n - inject_rows.shape[0].bit_length() + 1: inject_rows}
        n = 1 << log_n

        def run(fn):
            def go():
                y = x.clone()
                layers = fn(F, hasher, y, k, tw, levels, inject, hashed, dif)
                return torch.cat([y.reshape(-1)] + [t.reshape(-1).to(torch.int64) for t in layers])
            return go

        injected = 0 if inject_rows is None else inject_rows.shape[0]
        nodes = n - (n >> levels) + injected  # compressions above the leaves
        # x read and written once; leaves and levels written, injected digests read
        n_bytes = 16 * cols * n + (32 * (n + n - (n >> levels) + injected) if hashed else 0)
        ops = mul_ops * k * cols * n // 2 + (per_hash * (n * leaf_hashes(cols) + nodes) if hashed else 0)
        mode = "hashed" if hashed else "DIF" if dif else "DIT"
        scratch = x.clone()
        compare(f"lde_tile {F.name} {label} ({cols}, 2^{log_n}), {mode}, tile 2^{k}, {levels} levels",
                run(ct.lde_tile), run(ct.lde_tile_plain), (n_bytes, ops), iters=3, name=name,
                time_fn=lambda: ct.lde_tile(F, hasher, scratch, k, tw, levels, inject, hashed, dif), device=hashed)
        return ct.lde_tile(F, hasher, x.clone(), k, tw, levels, inject, hashed, dif)

    byte_table = tile_case("ByteTable LDE", 1, 10, True, fold=False)[0]
    stage1 = tile_case("U32Add LDE", 14, 20, True, name="lde_tile" if first else None)
    short = tile_case("a (2, 2^18) group's LDE", 2, 18, True, fold=False)[0]
    tile_case("U32Add LDE, the (2, 2^18) group injected inside the tile's levels", 14, 20, True, inject_rows=short)
    tile_case("stage-2 LDE", s2_cols, 20, True)
    tile_case("iDFT tail", 14, 18, False, inverse=True)
    tile_case("iDFT head", 14, 18, False, inverse=True, dif=False)
    tile_case("quotient iDFT head", D, 18, False, inverse=True, dif=False)

    top, L = stage1[-1], 20 - (len(stage1) - 1)  # K15 above the stage-1 tile, up to the cap
    inject = {10 - (len(stage1) - 1): byte_table}
    check_trees(dev, F, hasher, rnd, compare, per_hash, top, inject, first)


def check_trees(dev, F, hasher, rnd, compare, per_hash, top, inject, first: bool) -> None:
    """K15 against its plain version: every tree of 2^1 to 2^20 leaves at
    cap heights 0 and 4, with injections at the first level, at the first
    level above the first tier's subtrees and at the top, each launched
    twice (the second launch finds the arrival counters the first left);
    forced plans of many small tiers; then the bench's stage-1 tree above
    its tile (ByteTable injected) and a FRI round's 2^19-leaf tree timed
    against the parent's launch structure on this kernel (one launch per
    10 levels, subtrees of 2^10 nodes), with the profiler's device time;
    last, one compression's latency (a one-thread chain, K15's floor per
    level) and the ptxas report of the tree kernel."""
    import numpy as np
    import torch

    from multistark_tpu_torch import commit_tile as ct

    rng = np.random.default_rng(3)

    def digests(h):  # canonical field elements for Poseidon2, any words for BLAKE3
        words = rng.integers(0, 2 ** 32 if first else F.p, (h, 8), dtype=np.uint64)
        return torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(dev)

    def flat(layers):
        return torch.cat([t.reshape(-1) for t in layers])

    cases = 0
    for log_size in range(1, 21):
        leaves = digests(1 << log_size)
        for cap in (0, 4):
            levels = log_size - cap
            if levels < 1:
                continue
            s0 = ct.levels_plan(log_size, levels).tiers[0]
            inj = {lv: digests(1 << (log_size - lv)) for lv in sorted({1, min(s0 + 1, levels), levels})}
            want = flat(ct.merkle_levels_plain(hasher, leaves, levels, inj))
            for _ in range(2):
                if max_abs_err(flat(ct.merkle_levels(hasher, leaves, levels, inj)), want) != 0:
                    raise AssertionError(f"merkle_levels {F.name} 2^{log_size} leaves, cap 2^{cap}, injections "
                                         f"{sorted(inj)}: kernel disagrees with its plain version")
                cases += 1
    for log_size, tiers in ((12, (2, 2, 2, 2, 2, 2)), (12, (1,) * 7 + (5,)), (16, (7, 5, 4)), (20, (10, 6, 4))):
        leaves = digests(1 << log_size)
        levels = sum(tiers)
        plan = ct.LevelsPlan(tiers, 1 << (log_size - tiers[0]), 256, 0)
        plan = ct.LevelsPlan(tiers, plan.blocks, 256, sum(plan.blocks >> sum(tiers[1:t + 1])
                                                         for t in range(1, len(tiers))))
        inj = {lv: digests(1 << (log_size - lv)) for lv in (1, tiers[0], tiers[0] + 1, levels)}
        want = flat(ct.merkle_levels_plain(hasher, leaves, levels, inj))
        for _ in range(2):
            if max_abs_err(flat(ct.merkle_levels(hasher, leaves, levels, inj, plan=plan)), want) != 0:
                raise AssertionError(f"merkle_levels {F.name} 2^{log_size} leaves, tiers {tiers}: kernel disagrees "
                                     "with its plain version")
            cases += 1
    torch.cuda.synchronize()
    say("kernels", f"merkle_levels {F.name}: {cases} trees (2^1 to 2^20 leaves, caps 2^0 and 2^4, injections at "
        "the first level, above the first tier and at the top, each launched twice; forced plans of up to 8 "
        "tiers) bit-equal to the plain version")

    def parent_structure(layer, levels, inj):
        """The parent's launches on this kernel: 10 levels per launch, one
        block per 2^10-node subtree."""
        out, done = [], 0
        while done < levels:
            fold = min(10, levels - done)
            size = layer.shape[0]
            plan = ct.LevelsPlan((fold,), size >> fold, 256, 0)
            sub = {lv - done: d for lv, d in inj.items() if done < lv <= done + fold}
            out += ct.merkle_levels(hasher, layer, fold, sub, plan=plan)
            layer, done = out[-1], done + fold
        return out

    S, L = top.shape[0], top.shape[0].bit_length() - 1
    injected = sum(d.shape[0] for d in inject.values())
    plan = ct.levels_plan(L, L)
    label = f"merkle_levels {F.name} stage-1 tree above the tile, 2^{L} nodes, {L} levels, ByteTable injected"
    compare(f"{label}, plan {plan.tiers} x {plan.blocks} blocks",
            lambda: flat(ct.merkle_levels(hasher, top, L, inject)),
            lambda: flat(ct.merkle_levels_plain(hasher, top, L, inject)),
            (32 * S + 32 * (S - 1) + 32 * injected, per_hash * (S - 1 + injected)),
            time_fn=lambda: ct.merkle_levels(hasher, top, L, inject), device=True)
    say("kernels", f"{label}, the parent's launch structure on this kernel (10 levels per launch): "
        f"{cuda_ms(lambda: parent_structure(top, L, inject), 5):.4f} ms, device_ms="
        f"{device_ms(lambda: parent_structure(top, L, inject)):.4f}")
    leaves = hasher.hash_matrices([rnd(F, 2 * (2 if first else 4), 1 << 19)])  # an arity-2 fold of (D, 2^20)
    S, L = leaves.shape[0], 19
    plan = ct.levels_plan(L, L)
    label = f"merkle_levels {F.name} FRI round tree, 2^19 leaves, {L} levels"
    compare(f"{label}, plan {plan.tiers} x {plan.blocks} blocks",
            lambda: flat(ct.merkle_levels(hasher, leaves, L)),
            lambda: flat(ct.merkle_levels_plain(hasher, leaves, L)),
            (32 * S + 32 * (S - 1), per_hash * (S - 1)), name="merkle_levels" if first else None,
            time_fn=lambda: ct.merkle_levels(hasher, leaves, L), device=True)
    say("kernels", f"{label}, the parent's launch structure on this kernel (10 levels per launch): "
        f"{cuda_ms(lambda: parent_structure(leaves, L, {}), 5):.4f} ms, device_ms="
        f"{device_ms(lambda: parent_structure(leaves, L, {})):.4f}")

    d0 = digests(1)
    if not torch.equal(ct.node_chain(hasher, d0, 64), ct.node_chain_plain(hasher, d0, 64)):
        raise AssertionError(f"node_chain {F.name}: 64 chained compressions disagree with the plain version")
    n = 4096
    t_n = cuda_ms(lambda: ct.node_chain(hasher, d0, n), 3)
    t_0 = cuda_ms(lambda: ct.node_chain(hasher, d0, 0), 3)
    lat_us = 1e3 * (t_n - t_0) / n
    LATENCY_US[F.name] = lat_us
    say("kernels", f"merkle_levels {F.name} node latency: {lat_us:.4f} us per compression (a one-thread chain of "
        f"{n}, {t_n:.4f} ms, less an empty chain {t_0:.4f} ms; equal to the plain chain at 64); depth x latency: "
        f"a 2^19-leaf tree {19 * lat_us:.2f} us")


def check_programs(dev, F, E, rnd, compare, mul_ops, first: bool) -> None:
    """K11 against its plain version on U32Add's three programs at 2^18 rows
    (blowup 4): the quotient composition over the stored stage-1 and stage-2
    LDEs (bit-reversed, next row q = 1 ahead), the lookup values over the
    trace, and the stage-2 messages over those values."""
    from multistark_tpu_torch import program, prover, system as sm
    from multistark_tpu_torch.test_circuits import u32_add_system_inputs

    name = "goldilocks_blake3" if first else "babybear_poseidon2"
    system, _ = sm.System.new(bench_config(dev, name), u32_add_system_inputs())
    c_idx, log_n, D = 0, 18, E.D
    circuit = system.circuits[c_idx]
    n = 1 << log_n
    lde = 1 << (log_n + BENCH_COMMIT["log_blowup"])
    q = circuit.quotient_degree
    m = n * q

    def cost(prog, rows, n_out):
        """(bytes: each column and selector the program reads and each output
        plane once; 32-bit operations of its arithmetic)"""
        code = prog.code
        cols = {(int(b) >> 1, int(a)) for op, _, a, b in code if op == program.VAR}
        sels = {int(a) for op, _, a, _ in code if op == program.SEL}
        muls = int((code[:, 0] == program.MUL).sum())
        adds = int(((code[:, 0] == program.ADD) | (code[:, 0] == program.SUB) | (code[:, 0] == program.NEG)).sum())
        return 8 * rows * (len(cols) + len(sels) + n_out), rows * (muls * mul_ops + adds * 2)

    # (a) the quotient
    qprog = system.quotient_program(c_idx, log_n)
    sels = prover._selectors_device(system, log_n, q)
    qops = program.Operands(
        sources=[None, rnd(F, circuit.main_width, lde), rnd(F, circuit.stage2_width, lde)], rows=m, step=q,
        brev_log=m.bit_length() - 1, selectors=[sels[s] for s in program.SELECTORS], pubs=rnd(F, 4 * D),
        apows=rnd(F, D, circuit.constraint_count),
    )
    say("kernels", f"expr_sweep programs: {qprog.name} {len(qprog.code)} instructions, {qprog.n_regs} registers")
    compare(f"expr_sweep {F.name} quotient of U32Add (2^18 rows)",
            lambda: program.expr_sweep(F, qprog, qops, (D, m), m, 1),
            lambda: program.expr_sweep_plain(F, qprog, qops, (D, m), m, 1), cost(qprog, m, D),
            name="expr_sweep" if first else None, device=True)
    # (a') the same program in natural mode on a rank's block of a four-rank
    # mesh plus the q rows after it, as the sharded quotient runs it
    b = m // 4
    nops = program.Operands(
        sources=[None, rnd(F, circuit.main_width, b + q), rnd(F, circuit.stage2_width, b + q)], rows=b + q, step=q,
        selectors=[rnd(F, b + q) for _ in program.SELECTORS], pubs=qops.pubs, apows=qops.apows,
    )
    compare(f"expr_sweep {F.name} quotient of U32Add, natural mode, a block of {b} rows + {q} halo",
            lambda: program.expr_sweep(F, qprog, nops, (D, b + q), b + q, 1),
            lambda: program.expr_sweep_plain(F, qprog, nops, (D, b + q), b + q, 1), cost(qprog, b + q, D), device=True)
    # (b) the lookup values
    lprog = system.lookup_values_program(c_idx)
    arities = tuple(len(a) for _, a in circuit.graph.lookups)
    n_out = sum(1 + a for a in arities)
    lops = program.Operands(sources=[None, rnd(F, circuit.main_width, n)], rows=n)
    compare(f"expr_sweep {F.name} lookup values of U32Add (2^18 rows)",
            lambda: program.expr_sweep(F, lprog, lops, (n_out, n), n, 1),
            lambda: program.expr_sweep_plain(F, lprog, lops, (n_out, n), n, 1), cost(lprog, n, n_out), device=True)
    # (c) the stage-2 messages
    L = len(arities)
    sprog = system.stage2_program(c_idx)
    sops = program.Operands(sources=[rnd(F, n_out, n)], rows=n, pubs=rnd(F, 2 * D))
    compare(f"expr_sweep {F.name} stage-2 messages of U32Add (2^18 rows, {L} slots)",
            lambda: program.expr_sweep(F, sprog, sops, (D + 1, n * L), n * L, L),
            lambda: program.expr_sweep_plain(F, sprog, sops, (D + 1, n * L), n * L, L), cost(sprog, n, L * (D + 1)), device=True)
    for prog in (qprog, lprog, sprog):
        report = [ln.split(":", 1)[-1].strip() for ln in program.ptxas_report(F, prog).splitlines()
                  if "registers" in ln or "spill" in ln]
        say("kernels", f"expr_sweep {F.name} {prog.name}: {len(prog.code)} instructions, staging "
            f"{program.staging(prog)}; ptxas: {'; '.join(report) or 'no report'}")


def ptxas_kernels(path: str, names) -> str:
    """Registers and spills of the kernels `names` in an `nvcc -Xptxas -v`
    report, each with the template arguments its mangled name carries."""
    import re

    out, label = [], None
    with open(path) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                mangled = m.group(1)
                name = next((n for n in names if n in mangled), None)
                args = re.findall(
                    r"(Goldilocks|BabyBear|Blake3Hasher|Poseidon2TreeHasher|Poseidon2Hasher)|Li(\d+)E|Lb(\d)E",
                    mangled[mangled.find(name) + len(name):] if name else "")
                label = (f"{name}<{','.join(a or b or ('true' if c == '1' else 'false') for a, b, c in args)}>"
                         if name else None)
            regs = re.search(r"Used (\d+) registers", line)
            spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if label and spill:
                out.append([label, f"stack {spill.group(1)} B, spills {spill.group(2)}/{spill.group(3)} B"])
            if label and regs and out and out[-1][0] == label:
                out[-1].append(f"{regs.group(1)} registers")
    return "; ".join(" ".join(o) for o in out) or "no report"


def build_programs(dev) -> None:
    """Phase 2, K11: every program of the bench proves (both configs, 2^14
    and 2^18 rows), built from the template anew, one nvcc per program, all
    started together per config; prints each one's seconds."""
    from multistark_tpu_torch import program, system as sm
    from multistark_tpu_torch.test_circuits import u32_add_system_inputs

    for name in ("goldilocks_blake3", "babybear_poseidon2"):
        system, _ = sm.System.new(bench_config(dev, name), u32_add_system_inputs())
        table = next(c.preprocessed_dims[0] for c in system.circuits if c.preprocessed_dims)
        progs = [p for log_n in SIZES for p in system.programs([1 << log_n, table])]
        t0 = time.perf_counter()
        secs = program.build(system.config.field, progs, force=True)
        sizes = {p.name: len(p.code) for p in progs}
        say("build", f"nvcc built {len(secs)} K11 programs of {name} in {time.perf_counter() - t0:.1f} s "
            "(all at once; each program's seconds from the start): "
            + ", ".join(f"{p} ({sizes[p]} instructions) {s:.1f} s" for p, s in secs.items()))


def bench_config(dev, config_name: str):
    from multistark_tpu_torch.config import CommitmentParameters, FriParameters
    from multistark_tpu_torch.configs import BabyBearPoseidon2Config, GoldilocksBlake3Config

    cls = {"goldilocks_blake3": GoldilocksBlake3Config, "babybear_poseidon2": BabyBearPoseidon2Config}[config_name]
    return cls(CommitmentParameters(**BENCH_COMMIT), FriParameters(**BENCH_FRI), device=dev)


def beta_gamma_flush(dev, log_n: int, rng):
    """K7's operands for the first flush of a device-transcript prove of the
    bench system at 2^log_n rows: the config seed, the shape, the activity
    bytes, the preprocessed cap, the stage-1 cap (random, on the device),
    the log degrees and 2^log_n random claims."""
    import numpy as np
    import torch

    from multistark_tpu_torch import device_transcript as dt, dt_prover
    from multistark_tpu_torch.system import System
    from multistark_tpu_torch.test_circuits import u32_add_system_inputs

    config = bench_config(dev, "goldilocks_blake3")
    system, _ = System.new(config, u32_add_system_inputs())
    dd = dt.DeviceDuplex(dev)
    dd.observe_bytes(bytes(config.initialise_challenger().inner.input_buffer))
    system.observe_shape(dd)
    dd.observe_bytes(b"\x01" * len(system.circuits))
    dd.observe_bytes(dt_prover._cap_bytes(system.preprocessed_commit))
    dd.observe_cap_device(torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (1, 8)).astype(np.int32)).to(dev))
    dd.observe_bytes(bytes([log_n, 8]))
    claims = rng.integers(0, 1 << 32, (1 << log_n, CLAIM_WIDTH), dtype=np.uint64)
    dt_prover._observe_claims_dd(dd, claims, config.host_field.p)
    return dd.flush_inputs()


def _dit(F, stage, x, tables):
    x = x.clone()
    for tw in tables:
        stage(F, x, tw, False)
    return x


def prove_sizes(dev, path: str):
    """Phase 4: the bench workload on the card along one path; returns the
    launch counts of that path (set to 0 just before it, read just after)."""
    import numpy as np
    import torch

    import multistark_tpu_torch as mt
    from multistark_tpu_torch import device_transcript as dt, dt_prover, kernels, prover
    from multistark_tpu_torch.system import System, SystemWitness
    from multistark_tpu_torch.test_circuits import u32_add_system_inputs, u32_add_witness

    config_name, entry, needed = PATHS[path]
    with open(os.path.join(ROOT, "fixtures", "torch_port_golden.json")) as f:
        golden = json.load(f)[config_name]
    prove = getattr(prover, entry)
    config = bench_config(dev, config_name)
    device_transcript = config_name == "goldilocks_blake3" and entry == "prove_multiple_claims"
    kernels.reset_launch_counts()  # phase 3's comparison launches and other paths do not count
    dt.FALLBACKS.clear()
    system, key = System.new(config, u32_add_system_inputs())
    sync_checks = []
    for log_n in SIZES:
        n = 1 << log_n
        rng = np.random.default_rng(WITNESS_SEED)
        xs = rng.integers(0, 1 << 32, n, dtype=np.uint64)
        ys = rng.integers(0, 1 << 32, n, dtype=np.uint64)
        traces, claims = u32_add_witness(list(zip(xs.tolist(), ys.tolist())), n)
        traces, claims = mt.witness_from_numpy(traces, claims, dev)
        t0 = time.perf_counter()
        witness = SystemWitness.from_stage_1(traces, system, key)
        torch.cuda.synchronize()
        t_wit = time.perf_counter() - t0
        t0 = time.perf_counter()
        proof = prove(system, key, witness, claims)
        torch.cuda.synchronize()
        t_cold = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        proof = prove(system, key, witness, claims)
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t0
        per_prove = {k: v - before[k] for k, v in kernels.launch_counts().items() if v - before[k]}
        peak = torch.cuda.max_memory_allocated()
        data = proof.to_bytes()
        got = {"sha256": hashlib.sha256(data).hexdigest(), "n_bytes": len(data)}
        say("prove", f"{path} log_n={log_n}: witness {t_wit:.3f} s, first prove {t_cold:.3f} s, "
            f"warm prove {t_warm:.4f} s, peak device memory {peak / 2**20:.1f} MiB, "
            f"proof {got['n_bytes']} bytes sha256 {got['sha256']}")
        say("prove", f"{path} log_n={log_n}: launches of the warm prove {per_prove}")
        if got != golden[str(log_n)]:
            raise AssertionError(f"{path} log_n={log_n}: proof {got} != JAX golden {golden[str(log_n)]}")
        if device_transcript:
            sync_checks.append((log_n, witness, claims))
    counts = kernels.launch_counts()  # the path's proves, and nothing else
    copies = dict(kernels.COPIES)
    say("prove", f"{path} kernel launches over the path: {counts}; fallbacks {dict(dt.FALLBACKS)}; layout copies "
        f"{copies}")
    if copies.get("fold_rows", 0):
        raise AssertionError(f"{path}: the FRI rounds made {copies['fold_rows']} PyTorch layout copies; K3's FRI "
                             "entry or K10 writes each level's matrix itself")
    for log_n, witness, claims in sync_checks:
        # the device transcript's path up to its global fetch once more, with
        # every op that waits for the device raising (after the read above:
        # these launches are not the path's)
        torch.cuda.set_sync_debug_mode("error")
        try:
            dt_prover._device_phase(system, key, witness, claims)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        say("prove", f"{path} log_n={log_n}: 0 syncs before the global fetch (sync debug mode \"error\")")
    if config_name == "goldilocks_blake3" and dt.FALLBACKS:
        raise AssertionError(f"{path}: device-transcript fallbacks {dict(dt.FALLBACKS)}")
    idle = [k for k in needed if counts[k] <= 0]
    if idle:
        raise AssertionError(f"{path}: kernels never launched on its path: {idle}")
    pairs = [e for e in kernels._SIGNATURES if "compress" in e]
    if pairs:
        raise AssertionError(f"entry points that compress Merkle pairs outside K14 / K15: {pairs}")
    say("prove", f"{path}: K14 lde_tile {counts['lde_tile']} and K15 merkle_levels {counts['merkle_levels']} "
        "launches; every tree's levels went through K15 (no compress_pairs entry point exists)")
    return counts


# phase 5: (backend, world, the ranks' device, [(config, sizes)], distributed_dft check or None)
MESH_PATHS = {"goldilocks_blake3": PATHS["goldilocks_blake3 host transcript"][2],  # a sharded prove takes the host
              "babybear_poseidon2": PATHS["babybear_poseidon2"][2]}               # transcript
DFT_CHECK = (10, 10, 3, 7)  # log_n1, log_n2, width, seed


def sharded_worlds(cards: int):
    nccl_world = 1 << (cards.bit_length() - 1)
    return [
        ("nccl", nccl_world, "cuda", [("goldilocks_blake3", SIZES), ("babybear_poseidon2", SIZES)], None),
        ("gloo", 4, "cuda:0", [("goldilocks_blake3", (18,))], DFT_CHECK),
        ("gloo", 2, "cuda:0", [("babybear_poseidon2", (14,))], None),
    ]


def sharded_phase() -> dict:
    """Phase 5: every world of `sharded_worlds`; returns the kernel launches
    of all ranks' proves, summed (each rank sets its counts to 0 before its
    proves and reads them right after)."""
    import torch

    from multistark_tpu_torch import parallel, spmd_cases
    from multistark_tpu_torch.examples.sharded_proof import world_bound_ms

    with open(os.path.join(ROOT, "fixtures", "torch_port_golden.json")) as f:
        golden = json.load(f)
    t_phase = time.perf_counter()
    launches: dict = {}
    for backend, world, device, cases, dft in sharded_worlds(torch.cuda.device_count()):
        t0 = time.perf_counter()
        reports = parallel.Ranks(spmd_cases.chip_rank, world, (cases, device, dft), backend=backend).results(600)
        label = f"{backend} world={world} ranks_per_card={1 if device == 'cuda' else world}"
        for config_name, sizes in cases:
            for log_n in sizes:
                key = f"{config_name}/{log_n}"
                per_rank = [(rep["proofs"][key]["cold_s"], rep["proofs"][key]["warm_s"],
                             rep["proofs"][key]["peak_bytes"] / 2**20) for rep in reports]
                say("sharded", f"{label} {key}: cold/warm prove s and peak MiB per rank "
                    + " ".join(f"[{c:.3f} {w:.4f} {m:.1f}]" for c, w, m in per_rank))
                for rep in reports:
                    lp = rep["proofs"][key]["last_prove"]
                    say("sharded", f"{label} {key} rank {rep['rank']} warm prove: collective bytes received "
                        f"{sum(lp['collective_bytes'].values())} {lp['collective_bytes']}, staged bytes "
                        f"{lp['staged_bytes']}, {sum(lp['launches'].values())} launches {lp['launches']}")
                ms, by, link, link_bytes = world_bound_ms(reports, config_name, log_n)
                say("sharded", f"{label} {key}: bound of one rank's warm prove {ms:.4f} ms by {by} "
                    f"({link or 'no'} link, {link_bytes} bytes on it)")
                for rep in reports:
                    got, want = rep["proofs"][key]["digest"], golden[config_name][str(log_n)]
                    if got != want:
                        raise AssertionError(f"{label} rank {rep['rank']} {key}: proof {got} != JAX golden {want}")
            for rep in reports:
                c = rep["counts"][config_name]
                say("sharded", f"{label} {config_name} rank {rep['rank']}: collective bytes {c['collective_bytes']} "
                    f"staged bytes {c['staged_bytes']} launches {c['launches']} sharded calls {c['sharded_calls']}")
                missing = [f for f in parallel.ROW27 if c["sharded_calls"].get(f, 0) <= 0]
                idle = [k for k in MESH_PATHS[config_name] if c["launches"].get(k, 0) <= 0]
                if missing or idle:
                    raise AssertionError(f"{label} rank {rep['rank']} {config_name}: sharded functions never "
                                         f"called {missing}, kernels never launched {idle}")
                for k, v in c["launches"].items():
                    launches[k] = launches.get(k, 0) + v
        if dft is not None:
            for rep in reports:
                d = rep["dft"]
                say("sharded", f"{label} rank {rep['rank']}: distributed_dft (3, 2^{dft[0]}, 2^{dft[1]}) block "
                    f"{d['shape']} equal to the plain version: {d['equal']}, {d['ms']:.3f} ms on the card, "
                    f"{d['plain_ms']:.1f} ms plain on the CPU")
                if not d["equal"]:
                    raise AssertionError(f"{label} rank {rep['rank']}: distributed_dft disagrees with its plain "
                                         "version")
        say("sharded", f"{label}: {len(reports)} ranks, every proof equals the golden digest "
            f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    reports = parallel.dryrun_multichip(2)  # the entry point, on the card
    for rep in reports:
        c = rep["counts"]["goldilocks_blake3"]
        got, want = rep["proofs"]["goldilocks_blake3/10"]["digest"], golden["goldilocks_blake3"]["10"]
        idle = [k for k in MESH_PATHS["goldilocks_blake3"] if c["launches"].get(k, 0) <= 0]
        if got != want or idle:
            raise AssertionError(f"dryrun_multichip(2) rank {rep['rank']}: proof {got} (JAX golden {want}), "
                                 f"kernels never launched {idle}")
        for k, v in c["launches"].items():
            launches[k] = launches.get(k, 0) + v
    say("sharded", f"dryrun_multichip(2): {reports[0]['backend']} on {reports[0]['device']}, every rank's "
        f"GoldilocksBlake3 2^10 proof equals the golden digest, staged bytes per rank "
        f"{[sum(r['counts']['goldilocks_blake3']['staged_bytes'].values()) for r in reports]} "
        f"({time.perf_counter() - t0:.1f} s)")
    say("sharded", f"phase 5 took {time.perf_counter() - t_phase:.1f} s")
    return launches


def running_children() -> list:
    """Command lines of the processes still running whose parent is this one
    (/proc), so the script can show that it stopped every process it started."""
    left = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:
            continue
        if int(ppid) == os.getpid() and state != "Z":
            left.append(f"{pid}: {cmd}")
    return left


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA GPU")
    sys.path.insert(0, ROOT)
    from multistark_tpu_torch import kernels

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    say("device", f"{kind}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    secs = kernels.build(force=True)
    kernels.library()
    say("build", f"nvcc built {len(kernels.sources())} sources in {secs:.1f} s (all at once; each source's seconds "
        "from the start: " + ", ".join(f"{s} {t:.1f} s" for s, t in sorted(kernels.BUILD_SECONDS.items())) + ")")
    for k, names in ((kernels.GL_ARITH, ("arith_kernel", "powers_kernel")),
                     (kernels.BB_ARITH, ("arith_kernel", "powers_kernel")),
                     (kernels.BLAKE3_MERKLE, kernels.BLAKE3_MERKLE.functions),
                     (kernels.POSEIDON2_MERKLE, kernels.POSEIDON2_MERKLE.functions + ("p2_chain_kernel",)),
                     (kernels.LDE_TILE, kernels.LDE_TILE.functions),
                     (kernels.GL_SCAN, ("batch_inv_kernel", "stage2_chain_kernel", "cumsum_kernel", "sum_kernel")),
                     (kernels.MERKLE_LEVELS, kernels.MERKLE_LEVELS.functions),
                     (kernels.REDUCED_OPEN, kernels.REDUCED_OPEN.functions),
                     (kernels.BARY_EVAL, kernels.BARY_EVAL.functions),
                     (kernels.FRI_GRIND, kernels.FRI_GRIND.functions),
                     (kernels.FRI_FOLD, kernels.FRI_FOLD.functions),
                     (kernels.CLAIMS_FP, kernels.CLAIMS_FP.functions)):
        say("build", f"{os.path.basename(k.source)} ptxas ({k.name}): {ptxas_kernels(kernels.ptxas_log(k.source), names)}")
    build_programs(dev)

    checked = check_kernels(dev)
    launches = {k.name: 0 for k in kernels.KERNELS}
    for path in PATHS:
        for name, count in prove_sizes(dev, path).items():
            launches[name] += count
    for name, count in sharded_phase().items():
        launches[name] += count

    rows = []
    for k in kernels.KERNELS:
        rows.append({"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
                     "launches": launches[k.name], **checked[k.name]})
    left = running_children()
    if left:
        raise AssertionError(f"processes started by chip_smoke still running: {left}")
    say("done", f"chip_smoke took {time.perf_counter() - t_start:.1f} s; no process it started is running")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
