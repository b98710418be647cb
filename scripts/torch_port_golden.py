"""Golden proof digests for the PyTorch port, produced by the JAX package.

Runs `multistark_tpu` on the CPU over the bench workload (U32Add +
preprocessed ByteTable, the reference FRI parameters, the witness of
bench.py's `u32_add_case`) under one config and writes its entries into
`fixtures/torch_port_golden.json` as
`{config: {log_n: {"sha256": ..., "n_bytes": ...}}}`.
`chip_smoke.py` holds the port's proofs against this file, since the
machine with the GPU has no JAX.

    JAX_PLATFORMS=cpu python scripts/torch_port_golden.py [--config NAME] [log_n ...]
    JAX_PLATFORMS=cpu python scripts/torch_port_golden.py --workload [NAME ...]

NAME is `goldilocks_blake3` (the default) or `babybear_poseidon2`.  With no
sizes it runs log_n 10, 14 and 18: about a minute and a half on an 8-core
CPU for goldilocks_blake3, and about half an hour for babybear_poseidon2,
whose host transcript is a Python Poseidon2 duplex.  Existing entries for
other configs and sizes are kept.

`--workload` writes the GoldilocksBlake3 proofs of the other test circuits
into `fixtures/torch_port_golden_workloads.json` as `{name: {"sha256": ...,
"n_bytes": ...}}` (all of WORKLOADS when no NAME is given): the
10-circuit BLAKE3 family of bench.py's `blake3_case` over a 64 KiB and a
4 KiB message, byte_operations at 8 bits over 2^16 seeded claims, and the
small systems the CPU tests prove.  The 64 KiB entry takes the longest
(the JAX witness builder's per-row loops, then a prove with traces of
2^19 rows).  The data of each entry comes from the functions below, which
import neither JAX nor the JAX package, so that the port's tests and
chip_smoke.py build the same witnesses.
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
WORKLOADS_PATH = os.path.join(ROOT, "fixtures", "torch_port_golden_workloads.json")
CONFIGS = ("goldilocks_blake3", "babybear_poseidon2")
DEFAULT_SIZES = (10, 14, 18)
WITNESS_SEED = 0xDEADBEEF
# bench.py reference_fri_params()
BENCH_COMMIT = dict(log_blowup=2, cap_height=0)
BENCH_FRI = dict(
    log_final_poly_len=0, max_log_arity=1, num_queries=100,
    commit_proof_of_work_bits=10, query_proof_of_work_bits=10,
)


SMALL_FRI_4 = dict(log_final_poly_len=0, max_log_arity=1, num_queries=4,
                  commit_proof_of_work_bits=1, query_proof_of_work_bits=1)  # tests/test_blake3_circuit.py
SMALL_FRI_6 = dict(SMALL_FRI_4, num_queries=6)  # tests/test_byte_operations.py
# name: (kind, its data's parameters, FRI parameters); every entry has
# CommitmentParameters(log_blowup=2, cap_height=0)
WORKLOADS = {
    "blake3 64 KiB": ("blake3", dict(n_bytes=64 * 1024, limb_bits=8), BENCH_FRI),
    "blake3 4 KiB": ("blake3", dict(n_bytes=4 * 1024, limb_bits=8), BENCH_FRI),
    "byte_operations 8 bits": ("byte_operations", dict(n_claims=1 << 16, bits=8), BENCH_FRI),
    "blake3 2 blocks 4 bits": ("blake3", dict(n_bytes=0, limb_bits=4), SMALL_FRI_4),
    "byte_operations 4 bits ragged": ("byte_operations", dict(n_claims=0, bits=4), SMALL_FRI_6),
    "limb xor + U32Xor 4 bits": ("xor_subfamily", dict(limb_bits=4), SMALL_FRI_4),
}
# tests/test_blake3_circuit.py TestBlake3E2E's message (n_bytes=0 above)
TWO_BLOCKS = b"multi-compression flagship workload: two blocks of input!" * 2
# tests/test_byte_operations.py test_roundtrip's claims (n_claims=0 above):
# ragged, the RANGE claim has three values
RAGGED_BYTE_CLAIMS = [[10, 5, 9, 5 ^ 9], [11, 7, 12, 7 & 12], [12, 3, 8, 3 | 8], [13, 15, 0], [10, 5, 9, 5 ^ 9]]
# tests/test_blake3_subfamily.py's pairs
XOR_PAIRS = [(0x01234567, 0x89ABCDEF), (0xFFFFFFFF, 0x0F0F0F0F), (0xDEADBEEF, 0x13371337)]


def blake3_message(n_bytes: int) -> bytes:
    """bench.py `blake3_case`'s message of n_bytes (TWO_BLOCKS for 0)."""
    return bytes(i % 251 for i in range(n_bytes)) if n_bytes else TWO_BLOCKS


def byte_operations_claims(n_claims: int, bits: int, seed: int = WITNESS_SEED):
    """n_claims (channel, a, b, result) claims over XOR, AND and OR of
    `bits`-bit operands, drawn with np.random.default_rng(seed), as an
    (n_claims, 4) uint64 array; RAGGED_BYTE_CLAIMS for n_claims=0."""
    if not n_claims:
        return [list(c) for c in RAGGED_BYTE_CLAIMS]
    rng = np.random.default_rng(seed)
    chan = rng.integers(0, 3, n_claims, dtype=np.uint64)
    a = rng.integers(0, 1 << bits, n_claims, dtype=np.uint64)
    b = rng.integers(0, 1 << bits, n_claims, dtype=np.uint64)
    result = np.where(chan == 0, a ^ b, np.where(chan == 1, a & b, a | b))
    return np.stack([chan + np.uint64(10), a, b, result], axis=1)  # XOR_CHAN, AND_CHAN, OR_CHAN = 10, 11, 12


def xor_subfamily_witness(limb_bits: int, pairs=XOR_PAIRS):
    """(traces ordered as [limb_xor_table, u32_xor_circuit], claims) for the
    words x ^ y: tests/test_blake3_subfamily.py's `xor_witness`, in NumPy."""
    k, lmask = 32 // limb_bits, (1 << limb_bits) - 1
    xy = np.asarray(pairs, np.uint64)
    words = np.stack([xy[:, 0], xy[:, 1], xy[:, 0] ^ xy[:, 1]], axis=1)  # (n, 3)
    shifts = np.uint64(limb_bits) * np.arange(k, dtype=np.uint64)
    limbs = (words[:, :, None] >> shifts) & np.uint64(lmask)  # (n, 3, k)
    mult = np.zeros(1 << (2 * limb_bits), np.uint64)
    np.add.at(mult, ((limbs[:, 0] << np.uint64(limb_bits)) | limbs[:, 1]).reshape(-1).astype(np.int64), 1)
    n = len(pairs)
    trace = np.zeros((1 << max(0, (n - 1).bit_length()), 3 * k + 1), np.uint64)
    trace[:n, : 3 * k] = limbs.reshape(n, 3 * k)
    trace[:n, 3 * k] = 1
    claims = [[23, int(x), int(y), int(x) ^ int(y)] for x, y in pairs]  # XOR_CHAN of the BLAKE3 family
    return [mult.reshape(-1, 1), trace], claims


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


def workload_inputs(name: str, b3c, bo) -> list:
    """The circuits of WORKLOADS[name], from the circuit modules b3c
    (test_circuits/blake3_circuit.py) and bo (byte_operations.py) of either
    package."""
    kind, params, _ = WORKLOADS[name]
    if kind == "blake3":
        return b3c.blake3_system_inputs(params["limb_bits"])
    if kind == "byte_operations":
        return [bo.byte_operations_inputs(params["bits"])]
    return [b3c.limb_xor_table(params["limb_bits"]), b3c.u32_xor_circuit(params["limb_bits"])]


def workload_witness(name: str, b3c, bo):
    """(traces, claims) of WORKLOADS[name], built by the modules of either
    package (the xor subfamily's by xor_subfamily_witness)."""
    kind, params, _ = WORKLOADS[name]
    if kind == "blake3":
        _, traces, claims = b3c.blake3_hasher_witness(blake3_message(params["n_bytes"]), params["limb_bits"])
        return traces, claims
    if kind == "byte_operations":
        claims = byte_operations_claims(params["n_claims"], params["bits"])
        return [bo.byte_operations_witness(claims, params["bits"])], claims
    return xor_subfamily_witness(params["limb_bits"])


def jax_workload_bytes(name: str) -> bytes:
    """The JAX package's GoldilocksBlake3 proof of WORKLOADS[name]."""
    os.environ.setdefault("MULTISTARK_PLATFORM", "cpu")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from multistark_tpu.config import CommitmentParameters, FriParameters
    from multistark_tpu.configs import GoldilocksBlake3Config
    from multistark_tpu.prover import prove_multiple_claims
    from multistark_tpu.system import System, SystemWitness
    from multistark_tpu.test_circuits import blake3_circuit as b3c, byte_operations as bo

    config = GoldilocksBlake3Config(CommitmentParameters(**BENCH_COMMIT), FriParameters(**WORKLOADS[name][2]))
    system, key = System.new(config, workload_inputs(name, b3c, bo))
    traces, claims = workload_witness(name, b3c, bo)
    witness = SystemWitness.from_stage_1(traces, system, key)
    proof = prove_multiple_claims(system, key, witness, claims)
    return proof.to_bytes(config)


def digest_entry(data: bytes) -> dict:
    return {"sha256": hashlib.sha256(data).hexdigest(), "n_bytes": len(data)}


def load_golden(path: str = GOLDEN_PATH) -> dict:
    with open(path) as f:
        return json.load(f)


def main(argv) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    if argv[:1] == ["--workload"]:
        names = argv[1:] or list(WORKLOADS)
        unknown = [n for n in names if n not in WORKLOADS]
        if unknown:
            raise SystemExit(f"unknown workloads {unknown}; some of {list(WORKLOADS)}")
        for name in names:
            t0 = time.time()
            entry = digest_entry(jax_workload_bytes(name))
            print(f"workload {name!r}: {entry} in {time.time() - t0:.1f}s", flush=True)

            # re-read so that concurrent runs for other entries are kept
            golden = load_golden(WORKLOADS_PATH) if os.path.exists(WORKLOADS_PATH) else {}
            golden[name] = entry
            with open(WORKLOADS_PATH, "w") as f:
                json.dump({k: golden[k] for k in WORKLOADS if k in golden}, f, indent=1)
                f.write("\n")
        return 0
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
