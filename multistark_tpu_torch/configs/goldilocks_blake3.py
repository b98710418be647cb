"""Production config: Goldilocks + degree-2 extension, BLAKE3 hashing,
byte-oriented serializing challenger, on one torch device."""

from __future__ import annotations

import torch

from ..challenger import SerializingChallenger64
from ..config import CommitmentParameters, FriParameters, StarkConfig
from ..fields.host import ExtensionParams, GOLDILOCKS, GOLDILOCKS_EXT2
from ..merkle import Blake3FieldHasher
from ..pcs import TwoAdicFriPcs

DOMAIN_TAG = b"multi-stark/v0"


class GoldilocksBlake3Config(StarkConfig):
    """`device` is where every tensor the prover makes lives: "cuda" runs
    the hand-written kernels, "cpu" their plain PyTorch versions."""

    def __init__(
        self,
        commitment_parameters: CommitmentParameters,
        fri_parameters: FriParameters,
        device="cpu",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
        self.host_field = GOLDILOCKS
        self.host_ext = GOLDILOCKS_EXT2
        self.extension_params = ExtensionParams(degree=2, w=7, karatsuba=True)
        self.commitment_parameters = commitment_parameters
        self.fri_parameters = fri_parameters
        self.hasher = Blake3FieldHasher()
        self.pcs = TwoAdicFriPcs(
            GOLDILOCKS, GOLDILOCKS_EXT2, self.hasher, commitment_parameters, fri_parameters, self.device,
        )

    def initialise_challenger(self) -> SerializingChallenger64:
        """Seed = domain-separation tag ‖ all 7 parameters as u64 LE, so any
        parameter change changes every transcript."""
        ch = SerializingChallenger64(self.host_field, self.host_ext)
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
