"""The second genericity axis: BabyBear + degree-4 extension (X^4 = 11),
Poseidon2-16 hashing, field-native duplex challenger, on one torch device.

TEST-ONLY, as in the JAX package: the Poseidon2 round constants are
self-derived (security-checked but not externally vetted; see
hash/poseidon2_host.py) -- do not use this config in production."""

from __future__ import annotations

import torch

from ..challenger import DuplexChallenger
from ..config import CommitmentParameters, FriParameters, StarkConfig
from ..fields.device import BB4_OPS, BB_OPS
from ..fields.host import BABYBEAR, BABYBEAR_EXT4, ExtensionParams
from ..merkle import Poseidon2FieldHasher
from ..pcs import TwoAdicFriPcs

DOMAIN_TAG = b"multi-stark/v0"


class BabyBearPoseidon2Config(StarkConfig):
    """`device` is where every tensor the prover makes lives: "cuda" (the
    default) runs the hand-written kernels, "cpu" their plain PyTorch
    versions."""

    def __init__(
        self,
        commitment_parameters: CommitmentParameters,
        fri_parameters: FriParameters,
        device="cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
        self.field = BB_OPS
        self.ext = BB4_OPS
        self.host_field = BABYBEAR
        self.host_ext = BABYBEAR_EXT4
        self.extension_params = ExtensionParams(degree=4, w=11, karatsuba=False)
        self.commitment_parameters = commitment_parameters
        self.fri_parameters = fri_parameters
        self.hasher = Poseidon2FieldHasher()
        self.pcs = TwoAdicFriPcs(
            BB_OPS, BB4_OPS, BABYBEAR, BABYBEAR_EXT4, self.hasher, commitment_parameters, fri_parameters,
            self.device,
        )

    def initialise_challenger(self) -> DuplexChallenger:
        """Field-element seeding: the domain tag one field element per byte,
        then all 7 parameters as u64s (two 32-bit limbs each), so any
        parameter change changes every transcript."""
        ch = DuplexChallenger(self.host_field, self.host_ext)
        ch.observe_bytes(DOMAIN_TAG)
        p = self.commitment_parameters
        f = self.fri_parameters
        for v in (
            p.log_blowup,
            p.cap_height,
            f.log_final_poly_len,
            f.max_log_arity,
            f.num_queries,
            f.commit_proof_of_work_bits,
            f.query_proof_of_work_bits,
        ):
            ch.observe_u64(v)
        return ch
