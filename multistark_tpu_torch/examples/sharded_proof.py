"""Row-sharded proving over D ranks of torch.distributed, asserted against
a single-device prove.

    python3 -m multistark_tpu_torch.examples.sharded_proof --backend gloo --world 4 --log-n 18
    python3 -m multistark_tpu_torch.examples.sharded_proof --backend nccl --world 4 --log-n 18
    python3 -m multistark_tpu_torch.examples.sharded_proof --device cpu --world 2 --log-n 8 10 \
        --config goldilocks_blake3 babybear_poseidon2

The bench workload (U32Add + preprocessed ByteTable, the reference FRI
parameters: blowup 4, 100 queries, arity 2, PoW 10+10, bench.py's witness)
at each --log-n under each --config (goldilocks_blake3, the default, and
babybear_poseidon2).  The script starts --world ranks with the spawn
method, joined through a file:// store in a temporary directory; each rank
proves under parallel.use_mesh, twice per size, and returns its proofs'
sha256 and length, which must equal a single-device prove in this process
(on card 0).  Ranks take CUDA tensors unless --device cpu: --backend nccl
puts one rank on each card (--world at most the number of cards);
--backend gloo on a card puts every rank on card 0 and carries each
collective through pinned host memory ("staged"; the count of staged bytes
is printed; no speed is claimed for it).  Each rank prints its cold and
warm prove seconds, its peak device memory, and its warm prove's collective
and staged bytes, kernel launches and sharded calls; then the bound of one
rank's warm prove (`world_bound_ms`).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

BENCH_COMMIT = dict(log_blowup=2, cap_height=0)
BENCH_FRI = dict(log_final_poly_len=0, max_log_arity=1, num_queries=100,
                 commit_proof_of_work_bits=10, query_proof_of_work_bits=10)
WITNESS_SEED = 0xDEADBEEF  # bench.py u32_add_case


def bench_config(config_name: str, device, commit: dict = BENCH_COMMIT, fri: dict = BENCH_FRI):
    from ..config import CommitmentParameters, FriParameters
    from ..configs import BabyBearPoseidon2Config, GoldilocksBlake3Config

    cls = {"goldilocks_blake3": GoldilocksBlake3Config, "babybear_poseidon2": BabyBearPoseidon2Config}[config_name]
    return cls(CommitmentParameters(**commit), FriParameters(**fri), device=device)


def bench_witness(system, key, log_n: int, device, n_pairs: Optional[int] = None, seed: int = WITNESS_SEED):
    """bench.py's u32_add witness at 2^log_n rows (n_pairs seeded additions,
    default one per row): (SystemWitness, claims)."""
    from .. import witness_from_numpy
    from ..system import SystemWitness
    from ..test_circuits import u32_add_witness

    n = 1 << log_n
    n_pairs = n if n_pairs is None else n_pairs
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, 1 << 32, n_pairs, dtype=np.uint64)
    ys = rng.integers(0, 1 << 32, n_pairs, dtype=np.uint64)
    traces, claims = witness_from_numpy(*u32_add_witness(list(zip(xs.tolist(), ys.tolist())), n), device)
    return SystemWitness.from_stage_1(traces, system, key), claims


def digest(data: bytes) -> dict:
    return {"sha256": hashlib.sha256(data).hexdigest(), "n_bytes": len(data)}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rank_device(rank: int, device: str) -> torch.device:
    """"cuda": one card per rank (cuda:rank); "cuda:k" or "cpu": that device."""
    return torch.device("cuda", rank) if device == "cuda" else torch.device(device)


def prove_rank(rank: int, cases: Sequence[Tuple[str, Sequence[int]]], device: str) -> dict:
    """One rank's program (its process group already joined): for each
    (config, sizes) of cases, the bench system proved under
    parallel.use_mesh at each size, a cold prove and a warm one.
    Returns the rank's report: per "config/log_n" the proof digest, prove
    seconds, peak device memory and the counts of its last prove; per config
    the kernel launches, sharded calls, collective and staged bytes of its
    proves (counts set to 0 before them)."""
    from .. import kernels, parallel
    from ..prover import prove_multiple_claims
    from ..system import System
    from ..test_circuits import u32_add_system_inputs

    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    proofs, counts = {}, {}
    for config_name, sizes in cases:
        config = bench_config(config_name, dev)
        system, key = System.new(config, u32_add_system_inputs())
        kernels.reset_launch_counts()
        parallel.reset_counts()
        with parallel.use_mesh() as pm:
            for log_n in sizes:
                witness, claims = bench_witness(system, key, log_n, dev)
                if dev.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(dev)
                times = []
                for _ in range(2):
                    before = _counts()
                    _sync(dev)
                    t0 = time.perf_counter()
                    proof = prove_multiple_claims(system, key, witness, claims)
                    _sync(dev)
                    times.append(time.perf_counter() - t0)
                proofs[f"{config_name}/{log_n}"] = {
                    "digest": digest(proof.to_bytes()), "cold_s": times[0], "warm_s": times[1],
                    "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
                    "last_prove": _counts(before),
                }
        counts[config_name] = {
            "launches": {k: v for k, v in kernels.launch_counts().items() if v},
            "sharded_calls": dict(parallel.SHARDED_CALLS), "collective_bytes": dict(parallel.COLLECTIVE_BYTES),
            "staged_bytes": dict(parallel.STAGED_BYTES),
        }
    return {"rank": pm.rank, "world": pm.n, "backend": pm.backend, "device": str(dev), "proofs": proofs,
            "counts": counts}


def _counts(before=None) -> dict:
    """The launch, sharded-call, collective and staged counters now, or
    their growth since `before`."""
    from .. import kernels, parallel

    now = {"launches": kernels.launch_counts(), "sharded_calls": dict(parallel.SHARDED_CALLS),
           "collective_bytes": dict(parallel.COLLECTIVE_BYTES), "staged_bytes": dict(parallel.STAGED_BYTES)}
    if before is None:
        return now
    return {k: {n: v - before[k].get(n, 0) for n, v in now[k].items() if v - before[k].get(n, 0)} for k in now}


HBM_BYTES_PER_S = 3.35e12  # one H100 SXM (NVIDIA's data sheet)
LINK_BYTES_PER_S = {"pcie": 64e9, "nvlink": 450e9}  # PCIe 5.0 x16, NVLink 4 (18 links), per direction


def rank_bound_ms(config_name: str, log_n: int, world: int, link: str, link_bytes: float) -> tuple:
    """The least time one rank's prove could take on an H100: the larger of
    the bytes its device programs must move at the HBM rate (spans.
    program_bytes of the single-device prove, the sharded programs divided
    by the world; the claimed evaluations and the query gathers whole) and
    `link_bytes` (the bytes the busiest direction of `link` carries for the
    card) at the link's rate.  Returns (ms, "bytes" or "link")."""
    from ..spans import program_bytes
    from ..system import System
    from ..test_circuits import u32_add_system_inputs

    system, _ = System.new(bench_config(config_name, "cpu"), u32_add_system_inputs())
    heights = [c.preprocessed_dims[0] if c.preprocessed_dims else 1 << log_n for c in system.circuits]
    pb = program_bytes(system, type("Shape", (), {"heights": heights}))
    whole = pb["claimed evaluations"] + pb["query gathers"]
    sharded = sum(pb[k] for k in ("stage-2 traces", "quotient sweep", "commits (LDE + tree)", "reduced openings",
                                  "FRI rounds"))
    t_hbm, t_link = (sharded / world + whole) / HBM_BYTES_PER_S, link_bytes / LINK_BYTES_PER_S[link] if link else 0.0
    return 1e3 * max(t_hbm, t_link), ("bytes" if t_hbm >= t_link else "link")


def world_bound_ms(reports, config_name: str, log_n: int) -> tuple:
    """`rank_bound_ms` of the last prove at this size, from every rank's
    report: staged gloo (ranks sharing one card) over that card's PCIe link,
    the larger direction summed over its ranks; NCCL over NVLink, the
    largest bytes one rank received; a world of one rank over no link.
    Returns (ms, bound by, link, link bytes)."""
    last = [r["proofs"][f"{config_name}/{log_n}"]["last_prove"] for r in reports]
    if any(lp["staged_bytes"] for lp in last):
        link = "pcie"
        link_bytes = max(sum(lp["staged_bytes"].get(d, 0) for lp in last) for d in ("device_to_host", "host_to_device"))
    elif len(reports) > 1:
        link, link_bytes = "nvlink", max(sum(lp["collective_bytes"].values()) for lp in last)
    else:
        link, link_bytes = None, 0
    ms, by = rank_bound_ms(config_name, log_n, len(reports), link, link_bytes)
    return ms, by, link, link_bytes


def single_device_digest(config_name: str, log_n: int, device) -> dict:
    """The bench prove with no mesh, in this process."""
    from ..prover import prove_multiple_claims
    from ..system import System
    from ..test_circuits import u32_add_system_inputs

    config = bench_config(config_name, device)
    system, key = System.new(config, u32_add_system_inputs())
    witness, claims = bench_witness(system, key, log_n, torch.device(device))
    return digest(prove_multiple_claims(system, key, witness, claims).to_bytes())


def run_world(world: int, backend: str, device: str, cases: Sequence[Tuple[str, Sequence[int]]]) -> tuple:
    """Start `world` ranks of `backend` proving `cases` (prove_rank) on
    `device`: "cpu", or "cuda" with NCCL one rank per card and with gloo
    every rank on card 0.  While they run, this process proves each case
    with no mesh on the CPU or card 0.  Raises unless every rank's proof
    bytes equal the single-device ones.  Returns (the ranks' reports,
    {(config, log_n): single-device digest})."""
    from ..parallel import Ranks

    if backend == "nccl" and device == "cpu":
        raise ValueError("nccl takes CUDA tensors")
    if backend == "nccl" and world > torch.cuda.device_count():
        raise ValueError(f"nccl puts one rank on each card; {torch.cuda.device_count()} cards for {world} ranks")
    single = "cpu" if device == "cpu" else "cuda:0"
    if device != "cpu":
        from .. import kernels

        kernels.library()  # build once before the ranks load it
    ranks = Ranks(prove_rank, world, (cases, "cuda" if backend == "nccl" else single), backend=backend)
    want = {(c, ln): single_device_digest(c, ln, single) for c, sizes in cases for ln in sizes}
    reports = ranks.results()
    for (config_name, log_n), digest_1 in want.items():
        for rep in reports:
            got = rep["proofs"][f"{config_name}/{log_n}"]["digest"]
            if got != digest_1:
                raise AssertionError(f"rank {rep['rank']} {config_name}/{log_n}: sharded proof {got} != "
                                     f"single-device {digest_1}")
    return reports, want


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default: nccl on cuda, gloo on cpu")
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--log-n", type=int, nargs="+", default=[14])
    ap.add_argument("--config", choices=("goldilocks_blake3", "babybear_poseidon2"), nargs="+",
                    default=["goldilocks_blake3"])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    backend = args.backend or ("nccl" if args.device == "cuda" else "gloo")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("sharded_proof: no CUDA device (pass --device cpu)")
    reports, want = run_world(args.world, backend, args.device, [(c, tuple(args.log_n)) for c in args.config])
    for (config_name, log_n), digest_1 in want.items():
        for rep in reports:
            print(json.dumps({k: rep[k] for k in ("rank", "world", "backend", "device")}
                             | {"config": config_name, "log_n": log_n} | rep["proofs"][f"{config_name}/{log_n}"]))
        if args.device == "cuda":
            ms, by, link, link_bytes = world_bound_ms(reports, config_name, log_n)
            print(f"{config_name}/{log_n}: bound of one rank's warm prove {ms:.4f} ms by {by} "
                  f"({link or 'no'} link, {link_bytes} bytes on it)")
        print(f"{config_name}/{log_n}: {args.world} ranks ({backend}), every rank's proof equals the single-device "
              f"proof, {digest_1['n_bytes']} bytes sha256 {digest_1['sha256']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
