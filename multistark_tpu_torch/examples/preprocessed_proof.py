"""A preprocessed byte range table and a Squares circuit whose result bytes
are range-checked through lookups, proved and verified with the port.

    python3 -m multistark_tpu_torch.examples.preprocessed_proof              # on the card
    python3 -m multistark_tpu_torch.examples.preprocessed_proof --device cpu

Two circuits (eight squares; the 256-row table, committed once at setup),
GoldilocksBlake3 with FriParameters.standard_fast().  Prints the prove and
verify seconds and the proof size.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

BYTE_CHAN = 0


def main(device: str = "cuda") -> dict:
    from .. import expr as ex
    from ..air import Air, AirBuilder, LookupAir
    from ..config import CommitmentParameters, FriParameters
    from ..configs import GoldilocksBlake3Config
    from ..system import System, SystemWitness

    class ByteTableAir(Air):
        width = 1

        def preprocessed_trace(self):
            return np.arange(256, dtype=np.uint64).reshape(256, 1)

        def eval(self, builder: AirBuilder) -> None:
            pass

    class SquaresAir(Air):
        """Columns (x, x^2, lo, hi, mult): x < 256, x^2 = lo + 256·hi with
        both result bytes pushed to the range table."""

        width = 5

        def eval(self, builder: AirBuilder) -> None:
            x, sq, lo, hi, mult = builder.main().row(0)
            builder.assert_eq(sq, x * x)
            builder.assert_eq(sq, lo + 256 * hi)
            builder.assert_bool(mult)

    config = GoldilocksBlake3Config(CommitmentParameters(log_blowup=2, cap_height=0), FriParameters.standard_fast(),
                                    device=device)
    squares_lookups = [
        ex.Lookup.push(ex.main(4), [ex.Const(BYTE_CHAN), ex.main(2)]),
        ex.Lookup.push(ex.main(4), [ex.Const(BYTE_CHAN), ex.main(3)]),
        ex.Lookup.push(ex.main(4), [ex.Const(BYTE_CHAN), ex.main(0)]),
    ]
    table_lookups = [ex.Lookup.pull(ex.main(0), [ex.Const(BYTE_CHAN), ex.preprocessed(0)])]
    system, key = System.new(config, [LookupAir(SquaresAir(), squares_lookups).to_circuit_inputs(),
                                      LookupAir(ByteTableAir(), table_lookups).to_circuit_inputs()])

    xs = [3, 7, 200, 255, 16, 99, 250, 1]
    rows = np.zeros((8, 5), np.uint64)
    mult = np.zeros(256, np.uint64)
    for r, x in enumerate(xs):
        sq = x * x
        rows[r] = (x, sq, sq & 0xFF, sq >> 8, 1)
        for v in (sq & 0xFF, sq >> 8, x):
            mult[v] += 1
    witness = SystemWitness.from_stage_1([rows, mult.reshape(256, 1)], system, key)

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
