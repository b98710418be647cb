"""Golden proof digests for the PyTorch port, produced by the JAX package.

Runs `multistark_tpu` on the CPU over the bench workload (U32Add +
preprocessed ByteTable, the reference FRI parameters, the witness of
bench.py's `u32_add_case`) under one config and writes its entries into
`fixtures/torch_port_golden.json` as
`{config: {log_n: {"sha256": ..., "n_bytes": ...}}}`.
`chip_smoke.py` holds the port's proofs against this file, since the
machine with the GPU has no JAX.

    JAX_PLATFORMS=cpu python scripts/torch_port_golden.py [--config NAME] [log_n ...]

NAME is `goldilocks_blake3` (the default) or `babybear_poseidon2`.  With no
sizes it runs log_n 10, 14 and 18: about a minute and a half on an 8-core
CPU for goldilocks_blake3, and about half an hour for babybear_poseidon2,
whose host transcript is a Python Poseidon2 duplex.  Existing entries for
other configs and sizes are kept.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_PATH = os.path.join(ROOT, "fixtures", "torch_port_golden.json")
CONFIGS = ("goldilocks_blake3", "babybear_poseidon2")
DEFAULT_SIZES = (10, 14, 18)
WITNESS_SEED = 0xDEADBEEF
# bench.py reference_fri_params()
BENCH_COMMIT = dict(log_blowup=2, cap_height=0)
BENCH_FRI = dict(
    log_final_poly_len=0, max_log_arity=1, num_queries=100,
    commit_proof_of_work_bits=10, query_proof_of_work_bits=10,
)


def bench_witness(log_n: int):
    """(xs, ys) exactly as bench.py's u32_add_case draws them."""
    n = 1 << log_n
    rng = np.random.default_rng(WITNESS_SEED)
    xs = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    ys = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    return list(zip(xs.tolist(), ys.tolist()))


def jax_proof_bytes(log_n: int, config_name: str = "goldilocks_blake3") -> bytes:
    os.environ.setdefault("MULTISTARK_PLATFORM", "cpu")  # read when multistark_tpu is imported
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from multistark_tpu.config import CommitmentParameters, FriParameters
    from multistark_tpu.configs import BabyBearPoseidon2Config, GoldilocksBlake3Config
    from multistark_tpu.prover import prove_multiple_claims
    from multistark_tpu.system import System, SystemWitness
    from multistark_tpu.test_circuits import u32_add_system_inputs, u32_add_witness

    cls = {"goldilocks_blake3": GoldilocksBlake3Config,
           "babybear_poseidon2": BabyBearPoseidon2Config}[config_name]
    config = cls(CommitmentParameters(**BENCH_COMMIT), FriParameters(**BENCH_FRI))
    system, key = System.new(config, u32_add_system_inputs())
    traces, claims = u32_add_witness(bench_witness(log_n), 1 << log_n)
    witness = SystemWitness.from_stage_1(traces, system, key)
    proof = prove_multiple_claims(system, key, witness, claims)
    return proof.to_bytes(config)


def digest_entry(data: bytes) -> dict:
    return {"sha256": hashlib.sha256(data).hexdigest(), "n_bytes": len(data)}


def load_golden() -> dict:
    with open(GOLDEN_PATH) as f:
        return json.load(f)


def main(argv) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    config_name = "goldilocks_blake3"
    if argv[:1] == ["--config"]:
        config_name, argv = argv[1], argv[2:]
    if config_name not in CONFIGS:
        raise SystemExit(f"unknown config {config_name!r}; one of {CONFIGS}")
    sizes = [int(a) for a in argv] or list(DEFAULT_SIZES)
    golden = load_golden() if os.path.exists(GOLDEN_PATH) else {}
    for log_n in sizes:
        t0 = time.time()
        entry = digest_entry(jax_proof_bytes(log_n, config_name))
        print(f"{config_name} log_n={log_n}: {entry} in {time.time() - t0:.1f}s", flush=True)
        # re-read so that concurrent runs for other configs are kept
        golden = load_golden() if os.path.exists(GOLDEN_PATH) else {}
        golden.setdefault(config_name, {})[str(log_n)] = entry
        golden[config_name] = dict(sorted(golden[config_name].items(), key=lambda kv: int(kv[0])))
        with open(GOLDEN_PATH, "w") as f:
            json.dump({k: golden[k] for k in CONFIGS if k in golden}, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
