"""Mutually recursive Even/Odd parity circuits exchanging push/pull over two
channels; proves the claim is_even(4) = 1 with the port, verifies it, and
checks that the wrong claim is_even(4) = 0 is rejected.  Demonstrates
multiplicity-gated recursion with inverse-witnessed zero tests.

    python3 -m multistark_tpu_torch.examples.lookup_proof              # on the card
    python3 -m multistark_tpu_torch.examples.lookup_proof --device cpu

GoldilocksBlake3 with FriParameters.standard_fast().
"""

from __future__ import annotations

import argparse
import time

import numpy as np

EVEN_CHAN = 0
ODD_CHAN = 1


def parity_circuit(own_chan: int, other_chan: int, base_result: int):
    """Columns (n, r, active, nz, inv):
      - active rows PULL (own_chan, n, r), consuming a request;
      - if n > 0 (nz = 1) they PUSH (other_chan, n-1, r), delegating;
      - if n == 0 the result is pinned to `base_result`;
      - nz is inverse-witnessed: n·inv = nz, (1-nz)·n = 0."""
    from .. import expr as ex
    from ..system import CircuitInputs

    n, r, active, nz, inv = (ex.main(i) for i in range(5))
    constraints = [
        active * (active - 1),
        nz * (nz - 1),
        n * inv - nz,
        (1 - nz) * n,
        active * (1 - nz) * (r - base_result),
    ]
    lookups = [
        ex.Lookup.pull(active, [ex.Const(own_chan), n, r]),
        ex.Lookup.push(active * nz, [ex.Const(other_chan), n - 1, r]),
    ]
    return CircuitInputs(main_width=5, constraints=constraints, ext_constraints=[], lookups=lookups)


def parity_rows(ns_rs, height: int) -> np.ndarray:
    from ..fields.host import GOLDILOCKS

    rows = np.zeros((height, 5), np.uint64)
    for i, (n, r) in enumerate(ns_rs):
        rows[i] = (n, r, 1, 1 if n else 0, GOLDILOCKS.inv(n) if n else 0)
    return rows


def main(device: str = "cuda") -> dict:
    from ..config import CommitmentParameters, FriParameters
    from ..configs import GoldilocksBlake3Config
    from ..errors import VerificationError
    from ..system import System, SystemWitness

    config = GoldilocksBlake3Config(CommitmentParameters(log_blowup=2, cap_height=0), FriParameters.standard_fast(),
                                    device=device)
    system, key = System.new(config, [parity_circuit(EVEN_CHAN, ODD_CHAN, base_result=1),
                                      parity_circuit(ODD_CHAN, EVEN_CHAN, base_result=0)])
    # is_even(4): even sees 4, 2, 0; odd sees 3, 1
    even = parity_rows([(4, 1), (2, 1), (0, 1)], 4)
    odd = parity_rows([(3, 1), (1, 1)], 2)
    witness = SystemWitness.from_stage_1([even, odd], system, key)
    claims = np.asarray([[EVEN_CHAN, 4, 1]], np.uint64)

    t0 = time.perf_counter()
    proof = system.prove_multiple_claims(key, witness, claims)
    prove_s = time.perf_counter() - t0
    print(f"Proved is_even(4) = 1 in {prove_s:.2f}s")
    t0 = time.perf_counter()
    system.verify_multiple_claims(claims, proof)
    verify_s = time.perf_counter() - t0
    print(f"Verified in {verify_s:.2f}s")

    try:
        system.verify_multiple_claims(np.asarray([[EVEN_CHAN, 4, 0]], np.uint64), proof)
    except VerificationError as e:
        print(f"Wrong claim rejected ({e.kind})")
        rejected = e.kind
    else:
        raise AssertionError("the wrong claim is_even(4) = 0 was accepted")
    n_bytes = len(proof.to_bytes())
    print(f"Proof size: {n_bytes} bytes")
    return {"prove_s": prove_s, "verify_s": verify_s, "proof_bytes": n_bytes, "wrong_claim": rejected}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(ap.parse_args().device)
