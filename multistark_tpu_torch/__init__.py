"""multistark_tpu_torch — the multi-circuit STARK prover in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

A port of `multistark_tpu` (the JAX package, which stays the reference): the
same modules and layouts, the same transcript, the same proof bytes, for
both of its configs: GoldilocksBlake3Config (Goldilocks, GL2, BLAKE3) and
BabyBearPoseidon2Config (BabyBear, BB4, Poseidon2).  Field elements are
int64 tensors holding canonical values; on a CUDA device all field
arithmetic, NTT butterflies, Merkle hashing, scans, FRI folds and the
device transcript's duplex run in ten kernels built from csrc/ at first use
(kernels.py), and on the CPU in their plain PyTorch versions.  The configs
run on "cuda" unless asked for "cpu".  GoldilocksBlake3 proves through the
whole-prove device transcript (dt_prover.py), BabyBearPoseidon2 through the
host transcript.  This package never imports JAX.

    config = GoldilocksBlake3Config(commit_params, fri_params)  # device="cuda"
    system, key = System.new(config, u32_add_system_inputs())
    traces, claims = witness_from_numpy(traces_np, claims_np, config.device)
    witness = SystemWitness.from_stage_1(traces, system, key)
    proof = prove_multiple_claims(system, key, witness, claims)
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .config import CommitmentParameters, FriParameters  # noqa: F401


def witness_from_numpy(traces: Sequence[np.ndarray], claims, device) -> Tuple[List[torch.Tensor], np.ndarray]:
    """The JAX package's witness (per circuit a (height, width) uint64 trace,
    and the claims) as the port takes it: traces as int64 tensors on
    `device` holding the same u64 bit patterns (SystemWitness.from_stage_1
    makes them field elements), claims as an (n, L) uint64 numpy array (the
    transcript runs on the host)."""
    from .fields.device import from_u64

    out = [from_u64(np.asarray(t, np.uint64).reshape(np.shape(t)), device) for t in traces]
    claims_np = np.asarray(claims, np.uint64) if len(claims) else np.zeros((0, 0), np.uint64)
    return out, claims_np
