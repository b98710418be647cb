"""The PCS on its own: commit one batch of polynomials, open it at a point,
verify, with the Fiat-Shamir transcript mirrored by hand on both sides.

    python3 -m multistark_tpu_torch.examples.pcs_example              # on the card
    python3 -m multistark_tpu_torch.examples.pcs_example --device cpu

Four random polynomials of degree < 2^8 (seed 0) on GoldilocksBlake3 with
FriParameters.standard_fast(): their evaluations by NttEngine.dft_natural,
the commit, the opening at ζ, the PCS's verify on a fresh challenger, and
the first opened value against its Horner evaluation at ζ.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(device: str = "cuda") -> dict:
    from ..config import CommitmentParameters, FriParameters
    from ..configs import GoldilocksBlake3Config
    from ..fields.host import GOLDILOCKS as F, GOLDILOCKS_EXT2 as E

    config = GoldilocksBlake3Config(CommitmentParameters(log_blowup=2, cap_height=0), FriParameters.standard_fast(),
                                    device=device)
    pcs = config.pcs

    rng = np.random.default_rng(0)
    log_n, width = 8, 4
    coeffs = rng.integers(0, F.p, size=(width, 1 << log_n), dtype=np.uint64)
    evals = pcs.engine.dft_natural(config.field.from_np(coeffs, config.device), log_n)
    domain = pcs.natural_domain_for_degree(1 << log_n)

    t0 = time.perf_counter()
    cap, data = pcs.commit([(domain, evals)])
    commit_s = time.perf_counter() - t0
    print(f"Committed {width} polynomials of degree <{1 << log_n} in {commit_s:.2f}s")

    ch = config.initialise_challenger()  # the prover's transcript
    ch.observe_commitment(cap)
    zeta = ch.sample_ext()
    t0 = time.perf_counter()
    opened, proof = pcs.open([(data, [[zeta]])], ch)
    open_s = time.perf_counter() - t0
    print(f"Opened at zeta in {open_s:.2f}s")

    vch = config.initialise_challenger()  # the verifier's, independent
    vch.observe_commitment(cap)
    zeta_v = vch.sample_ext()
    if zeta_v != zeta:
        raise AssertionError("the verifier's transcript drew another zeta")
    rounds = [(cap, [(log_n, width, [(zeta_v, opened[0][0][0])])])]
    t0 = time.perf_counter()
    pcs.verify(rounds, proof, vch)
    verify_s = time.perf_counter() - t0
    print(f"Verified in {verify_s:.2f}s")

    acc = E.zero  # the claimed value against a direct evaluation
    for c in reversed(coeffs[0]):
        acc = E.add(E.mul(acc, zeta), E.from_base(int(c)))
    if acc != opened[0][0][0][0]:
        raise AssertionError(f"opened value {opened[0][0][0][0]} != Horner evaluation {acc}")
    print("Opened value matches Horner evaluation")
    return {"commit_s": commit_s, "open_s": open_s, "verify_s": verify_s}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(ap.parse_args().device)
