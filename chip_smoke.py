#!/usr/bin/env python3
"""Drive the PyTorch port (multistark_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero
without printing a result:

  1. device  -- torch.cuda must be available; prints the card's name and
                its `nvidia-smi` name and power limit
  2. build   -- compiles the four CUDA kernels from csrc/ (nvcc, sm_90a)
  3. kernels -- each kernel against its plain PyTorch version on the card,
                at the main path's shapes; outputs must be bit-equal (all
                arithmetic is exact mod p); warm CUDA-event times of both
  4. prove   -- the bench workload (U32Add + preprocessed ByteTable,
                GoldilocksBlake3Config, blowup 4, 100 queries, arity 2,
                PoW 10+10, bench.py's witness) at 2^14 and 2^18 rows on
                `cuda`; proof bytes must match the JAX package's golden
                sha256 and length (fixtures/torch_port_golden.json); warm
                prove seconds and peak device memory; every kernel's launch
                count over the proves must be above zero

Then a JSON line of per-kernel results, the nvidia-smi line, and as the last
line {"ok": true, "device": {...}}.
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


def check_kernels(dev):
    """Phase 3: every kernel against its plain version at main-path shapes.
    Returns {kernel name: (max_abs_err, ms, plain_ms)}."""
    import numpy as np
    import torch

    from multistark_tpu_torch.fields import device as fd
    from multistark_tpu_torch.hash import blake3 as b3
    from multistark_tpu_torch.merkle import Blake3FieldHasher, MerkleMmcs
    from multistark_tpu_torch.ntt import ntt as nt
    from multistark_tpu_torch import utils

    rng = np.random.default_rng(1)

    def rnd(*shape):
        return fd.from_np(rng.integers(0, fd.P, shape, dtype=np.uint64), dev)

    results = {}

    def compare(label, kernel_fn, plain_fn, iters=5, plain_iters=1):
        out, ref = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        err = max_abs_err(out, ref)
        ms, plain_ms = cuda_ms(kernel_fn, iters), cuda_ms(plain_fn, plain_iters)
        say("kernels", f"{label}: max_abs_err={err} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
        if err != 0:
            raise AssertionError(f"{label}: kernel disagrees with its plain version")
        return err, ms, plain_ms

    # K1: the quotient-domain and reduced-opening field ops at 2^18 rows
    m = 1 << 20
    a, b = rnd(m), rnd(m)
    ea, eb = rnd(2, m), rnd(2, m)
    compare("gl_arith mul (2^20,)", lambda: fd.mul(a, b), lambda: fd.mul_plain(a, b))
    compare("gl_arith add (2^20,)", lambda: fd.add(a, b), lambda: fd.add_plain(a, b))
    compare("gl_arith inv (2^18,)", lambda: fd.inv(a[: 1 << 18]), lambda: fd.inv_plain(a[: 1 << 18]))
    compare("gl_arith ext_inv (2, 2^16)", lambda: fd.ext_inv(ea[:, : 1 << 16]),
            lambda: fd.ext_inv_plain(ea[:, : 1 << 16]))
    results["gl_arith"] = compare(
        "gl_arith ext_mul (2, 2^20)", lambda: fd.ext_mul(ea, eb), lambda: fd.ext_mul_plain(ea, eb)
    )

    # K2: the (14, 2^20) stage-1 LDE's forward DIF, all 20 stages
    lde = rnd(14, 1 << 20)
    tables = [nt.NttEngine(dev).stage_table(s, False) for s in range(1, 21)]

    def dif(stage):
        def run():
            x = lde.clone()
            for tw in reversed(tables):
                stage(x, tw, True)
            return x
        return run

    results["ntt_stage"] = compare("ntt_stage DIF (14, 2^20)", dif(nt.ntt_stage_), dif(nt._stage_plain_))
    compare("ntt_stage DIT (14, 2^18)",
            lambda: _dit(nt.ntt_stage_, lde[:, : 1 << 18].contiguous(), tables[:18]),
            lambda: _dit(nt._stage_plain_, lde[:, : 1 << 18].contiguous(), tables[:18]))

    # K3: leaf hashing of the stage-1 and stage-2 LDE widths, a 2^20-leaf tree
    s2 = rnd(26, 1 << 20)
    results["blake3_merkle"] = compare(
        "blake3_merkle hash_rows (14, 2^20)", lambda: b3.hash_rows([lde]), lambda: b3.hash_rows_plain([lde])
    )
    compare("blake3_merkle hash_rows (26, 2^20)", lambda: b3.hash_rows([s2]), lambda: b3.hash_rows_plain([s2]))
    leaves = b3.hash_rows([lde])
    compare("blake3_merkle compress_pairs 2^19 nodes",
            lambda: b3.compress_pairs(leaves[0::2], leaves[1::2]),
            lambda: b3.compress_pairs_plain(leaves[0::2], leaves[1::2]))
    mmcs = MerkleMmcs(Blake3FieldHasher(), 0)
    t0 = time.perf_counter()
    cap, _ = mmcs.commit([lde])
    torch.cuda.synchronize()
    say("kernels", f"blake3_merkle 2^20-leaf tree commit: {1e3 * (time.perf_counter() - t0):.2f} ms")
    ref = leaves
    while ref.shape[0] > 1:
        ref = b3.compress_pairs_plain(ref[0::2], ref[1::2])
    if not np.array_equal(cap, ref.cpu().numpy().view(np.uint32)):
        raise AssertionError("2^20-leaf tree root disagrees with the plain version")

    # K4: the stage-2 chain over n·13 ext values at 2^18 rows
    chain = rnd(2, 13 << 18)
    chain[:, 5] = 0  # zero maps to zero
    compare("gl_scan cumsum (2, 13·2^18)", lambda: utils.cumsum(chain), lambda: utils.cumsum_plain(chain))
    compare("gl_scan field_sum (14, 2^18)", lambda: utils.field_sum(lde[:, : 1 << 18]),
            lambda: utils.field_sum_plain(lde[:, : 1 << 18]))
    results["gl_scan"] = compare(
        "gl_scan batch_inv (2, 13·2^18)", lambda: utils.batch_inv(chain, ext=True),
        lambda: utils.batch_inv_plain(chain, True), iters=3,
    )
    return results


def _dit(stage, x, tables):
    x = x.clone()
    for tw in tables:
        stage(x, tw, False)
    return x


def prove_sizes(dev):
    """Phase 4: the bench workload on the card; returns the launch counts of
    the proves."""
    import numpy as np
    import torch

    import multistark_tpu_torch as mt
    from multistark_tpu_torch import kernels
    from multistark_tpu_torch.config import CommitmentParameters, FriParameters
    from multistark_tpu_torch.configs import GoldilocksBlake3Config
    from multistark_tpu_torch.prover import prove_multiple_claims
    from multistark_tpu_torch.system import System, SystemWitness
    from multistark_tpu_torch.test_circuits import u32_add_system_inputs, u32_add_witness

    with open(os.path.join(ROOT, "fixtures", "torch_port_golden.json")) as f:
        golden = json.load(f)
    config = GoldilocksBlake3Config(
        CommitmentParameters(log_blowup=2, cap_height=0),
        FriParameters(log_final_poly_len=0, max_log_arity=1, num_queries=100,
                      commit_proof_of_work_bits=10, query_proof_of_work_bits=10),
        device=dev,
    )
    kernels.reset_launch_counts()  # phase 3's comparison launches do not count
    system, key = System.new(config, u32_add_system_inputs())
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
        proof = prove_multiple_claims(system, key, witness, claims)
        torch.cuda.synchronize()
        t_cold = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        proof = prove_multiple_claims(system, key, witness, claims)
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        data = proof.to_bytes()
        got = {"sha256": hashlib.sha256(data).hexdigest(), "n_bytes": len(data)}
        say("prove", f"log_n={log_n}: witness {t_wit:.3f} s, first prove {t_cold:.3f} s, "
            f"warm prove {t_warm:.4f} s, peak device memory {peak / 2**20:.1f} MiB, "
            f"proof {got['n_bytes']} bytes sha256 {got['sha256']}")
        if got != golden[str(log_n)]:
            raise AssertionError(f"log_n={log_n}: proof {got} != JAX golden {golden[str(log_n)]}")
    counts = kernels.launch_counts()
    say("prove", f"kernel launches over the proves: {counts}")
    idle = [k for k, v in counts.items() if v <= 0]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: {idle}")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA GPU")
    sys.path.insert(0, ROOT)
    from multistark_tpu_torch import kernels

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
    say("build", f"nvcc built {len(kernels.sources())} sources in {secs:.1f} s")

    checked = check_kernels(dev)
    counts = prove_sizes(dev)

    rows = []
    for k in kernels.KERNELS:
        err, ms, plain_ms = checked[k.name]
        rows.append({
            "name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
            "launches": counts[k.name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        })
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
