"""Generic STARK configuration (reference src/config.rs, src/types.rs:171-197).

A concrete config bundles: field ops (host + device), extension params, hash
kernels, challenger factory, and the PCS.  See configs/goldilocks_blake3.py
for the production instantiation and configs/babybear_poseidon2.py for the
second genericity axis (BabyBear, degree-4 extension, Poseidon2).
"""

from __future__ import annotations

from dataclasses import dataclass


class TranscriptProfile:
    """The transcript conventions the port follows, as constants: the JAX
    package's default TranscriptProfile values.  The port implements no
    other (tests/test_torch_system.py pins them to the JAX defaults).

    fri_observe_claims_before_alpha (pcs.open):
        observe ALL claimed opened values, then sample α, so an adversary
        cannot adapt claims to the batching challenge
    commit_pow_witness_placement (serialization.py FriProof layout):
        the Vec<u64> of commit-phase PoW witnesses sits directly after
        commit_phase_commits
    duplex_observe_bytes (challenger.DuplexChallenger.observe_bytes):
        a field-native duplex observes each byte as one field element
    poseidon2_constants (hash/poseidon2_host.py):
        None: the Poseidon2 round constants are the self-derived ones
    """

    fri_observe_claims_before_alpha = True
    commit_pow_witness_placement = "after_commits"
    duplex_observe_bytes = "field_per_byte"
    poseidon2_constants = None


@dataclass(frozen=True)
class CommitmentParameters:
    """Merkle commitment parameters (reference src/types.rs:171-177)."""

    log_blowup: int
    cap_height: int = 0


@dataclass(frozen=True)
class FriParameters:
    """FRI protocol parameters (reference src/types.rs:186-197)."""

    log_final_poly_len: int
    max_log_arity: int
    num_queries: int
    commit_proof_of_work_bits: int
    query_proof_of_work_bits: int

    @staticmethod
    def standard_fast() -> "FriParameters":
        return FriParameters(
            log_final_poly_len=0,
            max_log_arity=1,
            num_queries=100,
            commit_proof_of_work_bits=10,
            query_proof_of_work_bits=10,
        )

    def conjectured_fri_bits(self, log_blowup: int) -> float:
        """Conjectured FRI query-phase soundness in bits: each query catches
        a cheating prover w.p. ≈ 1 - ρ (ρ = 2^-log_blowup), so the error is
        ρ^num_queries ≈ 2^-(log_blowup·num_queries), plus the query-PoW
        grinding bits (reference src/verifier.rs:57-78)."""
        return log_blowup * self.num_queries + self.query_proof_of_work_bits

    def proven_fri_bits(self, log_blowup: int) -> float:
        """Johnson-bound (proven) query-phase soundness in bits: each query
        only provably catches w.p. ≈ 1 - √ρ, halving the per-query bits
        (reference src/verifier.rs:64-71)."""
        return 0.5 * log_blowup * self.num_queries + self.query_proof_of_work_bits


class StarkConfig:
    """Protocol surface every concrete config provides (reference
    src/config.rs:64-123).  Concrete configs are plain objects exposing:

      device       : the torch device every prover tensor lives on
      field, ext   : the tensor field ops F and E (fields/device.py)
      host_field   : HostField
      host_ext     : HostExtField
      pcs          : the PCS instance (commit/commit_from_coeffs/open)
      commitment_parameters, fri_parameters
      initialise_challenger() -> Challenger seeded with the domain-separation
                     tag and a digest of all parameters (src/types.rs:118-130)
      max_log_degree() = TWO_ADICITY - log_blowup  (src/config.rs:102-112)
      max_quotient_degree() = 2^log_blowup         (src/config.rs:114-118)
      log_blowup()
      extension_params : fields.host.ExtensionParams for the compiler
    """

    def max_log_degree(self) -> int:
        return self.host_field.two_adicity - self.log_blowup()

    def max_quotient_degree(self) -> int:
        return 1 << self.log_blowup()

    def log_blowup(self) -> int:
        return self.commitment_parameters.log_blowup

    def soundness_bits(
        self, constraint_count: int, log_quotient_degree_bound: int, lookup_rows: int,
        conjectured: bool = True,
    ) -> float:
        """Union-bound soundness estimate in bits (reference
        src/verifier.rs:119-133):  ε ≤ ε_FRI + (k - 1 + D + N) / |F_ext|
        with k constraints, D the quotient degree bound, N total lookup
        rows.  Returns -log2(ε); use it to sanity-check parameter choices
        (the production Goldilocks² config at B=4/100 queries/PoW 10+10
        gives ≈2^-100 conjectured)."""
        import math

        fri = self.fri_parameters
        lb = self.log_blowup()
        fri_bits = (
            fri.conjectured_fri_bits(lb) if conjectured else fri.proven_fri_bits(lb)
        )
        ext_bits = self.host_ext.D * self.host_field.p.bit_length()
        sz = max(constraint_count - 1 + (1 << log_quotient_degree_bound) + lookup_rows, 1)
        sz_bits = ext_bits - math.log2(sz)
        return min(fri_bits, sz_bits)
