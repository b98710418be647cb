"""Minimal end-to-end proof: Pythagorean triples a^2 + b^2 = c^2, proved
and verified with the port.

    python3 -m multistark_tpu_torch.examples.simple_proof              # on the card
    python3 -m multistark_tpu_torch.examples.simple_proof --device cpu

One circuit, four rows, GoldilocksBlake3 with FriParameters.standard_fast()
(blowup 4, 100 queries, PoW 10+10).  Prints the prove and verify seconds and
the proof size.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(device: str = "cuda") -> dict:
    from ..air import Air, AirBuilder, LookupAir
    from ..config import CommitmentParameters, FriParameters
    from ..configs import GoldilocksBlake3Config
    from ..system import System, SystemWitness

    class PythagoreanAir(Air):
        width = 3

        def eval(self, builder: AirBuilder) -> None:
            a, b, c = builder.main().row(0)
            builder.assert_eq(a * a + b * b, c * c)

    config = GoldilocksBlake3Config(CommitmentParameters(log_blowup=2, cap_height=0), FriParameters.standard_fast(),
                                    device=device)
    system, key = System.new(config, [LookupAir(PythagoreanAir(), []).to_circuit_inputs()])
    trace = np.asarray([(3, 4, 5), (6, 8, 10), (5, 12, 13), (8, 15, 17)], np.uint64)
    witness = SystemWitness.from_stage_1([trace], system, key)

    t0 = time.perf_counter()
    proof = system.prove_multiple_claims(key, witness, [])
    prove_s = time.perf_counter() - t0
    print(f"Proved in {prove_s:.2f}s")
    t0 = time.perf_counter()
    system.verify_multiple_claims([], proof)
    verify_s = time.perf_counter() - t0
    print(f"Verified in {verify_s:.2f}s")
    n_bytes = len(proof.to_bytes())
    print(f"Proof size: {n_bytes} bytes")
    return {"prove_s": prove_s, "verify_s": verify_s, "proof_bytes": n_bytes}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(ap.parse_args().device)
