"""A rank's program for torchrun: the row-sharded prove with one process
per rank, every rank proving the bench workload under parallel.use_mesh.

    torchrun --nproc-per-node 4 -m multistark_tpu_torch.examples.multiprocess_proof --log-n 18
    torchrun --nproc-per-node 2 -m multistark_tpu_torch.examples.multiprocess_proof --device cpu --log-n 10

torchrun sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT;
`parallel.init_distributed` joins the group from them (NCCL with one card
per local rank on cuda, gloo on cpu).  Every rank prints its report; all
ranks' proof digests must be equal (checked with one all_gather_object).
"""

from __future__ import annotations

import argparse
import json
import os

import torch
import torch.distributed as dist


def main(argv=None) -> int:
    from .. import parallel
    from .sharded_proof import prove_rank

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log-n", type=int, default=14)
    ap.add_argument("--config", choices=("goldilocks_blake3", "babybear_poseidon2"), default="goldilocks_blake3")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}" if args.device == "cuda" else "cpu"
    if args.device == "cuda":
        torch.cuda.set_device(torch.device(device))
    pm = parallel.init_distributed(device=args.device)
    try:
        rep = prove_rank(pm.rank, [(args.config, (args.log_n,))], device)
        got = rep["proofs"][f"{args.config}/{args.log_n}"]
        print(json.dumps({k: rep[k] for k in ("rank", "world", "backend", "device")} | got), flush=True)
        digests = [None] * pm.n
        dist.all_gather_object(digests, got["digest"])
        if any(d != got["digest"] for d in digests):
            raise AssertionError(f"rank {pm.rank}: the ranks' proofs differ: {digests}")
        if pm.rank == 0:
            print(f"{pm.n} ranks: every rank's proof is {got['digest']['n_bytes']} bytes sha256 "
                  f"{got['digest']['sha256']}")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
