"""Prove BLAKE3 hashing of a real message with the 10-circuit family —
the flagship multi-circuit workload (reference src/test_circuits/blake3.rs).

The hasher walks the chunk/parent tree, records every compression as a
claim, and the proof binds them all: chained block compressions, parent
nodes, and the root (whose output words ARE the digest).  Verifying the
proof against the claims therefore verifies the digest.

    python3 -m multistark_tpu_torch.examples.blake3_proof              # on the card
    python3 -m multistark_tpu_torch.examples.blake3_proof --device cpu

A 4 KiB message (4 chunks, 67 compressions), 8-bit limb tables,
GoldilocksBlake3 with FriParameters.standard_fast().
"""

from __future__ import annotations

import argparse
import time


def main(device: str = "cuda", message_len: int = 4096, limb_bits: int = 8) -> dict:
    from ..config import CommitmentParameters, FriParameters
    from ..configs import GoldilocksBlake3Config
    from ..errors import VerificationError
    from ..hash.blake3_host import blake3_hash
    from ..system import System, SystemWitness
    from ..test_circuits.blake3_circuit import blake3_hasher_witness, blake3_system_inputs

    message = bytes(i % 251 for i in range(message_len))  # 4 KiB, 4 chunks

    config = GoldilocksBlake3Config(CommitmentParameters(log_blowup=2, cap_height=0), FriParameters.standard_fast(),
                                    device=device)
    t0 = time.perf_counter()
    system, key = System.new(config, blake3_system_inputs(limb_bits=limb_bits))
    print(f"Setup (10 circuits, {limb_bits}-bit tables): {time.perf_counter() - t0:.1f}s")

    digest, traces, claims = blake3_hasher_witness(message, limb_bits=limb_bits)
    assert digest == blake3_hash(message)
    print(f"blake3({len(message)}B message) = {digest.hex()}")
    print(f"{len(claims)} compression claims "
          f"(trace heights {[t.shape[0] for t in traces]})")

    witness = SystemWitness.from_stage_1(traces, system, key)
    t0 = time.perf_counter()
    proof = system.prove_multiple_claims(key, witness, claims)
    prove_s = time.perf_counter() - t0
    print(f"Proved in {prove_s:.2f}s")

    t0 = time.perf_counter()
    system.verify_multiple_claims(claims, proof)
    verify_s = time.perf_counter() - t0
    print(f"Verified in {verify_s:.2f}s")

    # the digest is bound: tampering the root claim's output must fail
    bad = claims.copy()
    bad[-1, -9] ^= 1  # a digest word of the root compression
    try:
        system.verify_multiple_claims(bad, proof)
    except VerificationError as e:
        print(f"Tampered digest rejected ({e.kind})")
        rejected = e.kind
    else:
        raise AssertionError("tampered digest accepted")
    n_bytes = len(proof.to_bytes())
    print(f"Proof size: {n_bytes} bytes")
    return {"prove_s": prove_s, "verify_s": verify_s, "proof_bytes": n_bytes, "tampered_digest": rejected,
            "claims": len(claims)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(ap.parse_args().device)
