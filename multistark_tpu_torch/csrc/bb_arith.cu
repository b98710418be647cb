// K5 bb_arith: elementwise BabyBear and BB4 (X^4 = 11) arithmetic, and the
// powers of a BB4 scalar.
//
// Replaces multistark_tpu/fields/device.py BabyBearOps.add/sub/neg/mul/_redc,
// inv/_pow_const, and ExtOps (BB4_OPS) add/sub/mul/square/scale/inv (schoolbook
// products, karatsuba=False; the conjugate-tower inverse): the jnp programs
// that carry the BabyBearPoseidon2 config's field arithmetic on the TPU; and
// the α-power tables.  The body is arith.cuh's, over the BabyBear trait, with
// K1's op codes and broadcast-by-period rule.
#include "arith.cuh"

extern "C" int bb_arith(int op, const uint64_t* a, int64_t na, int64_t ca, const uint64_t* b, int64_t nb, int64_t cb,
                        int columns, uint64_t* out, int64_t P, int64_t reps, uint64_t e, cudaStream_t stream) {
  return arith_launch<BabyBear>(op, a, na, ca, b, nb, cb, columns, out, P, reps, e, stream);
}

extern "C" int bb_powers(const uint64_t* alpha, uint64_t* out, int64_t count, cudaStream_t stream) {
  return powers_launch<BabyBear>(alpha, out, count, stream);
}

extern "C" int bb_ext_chain(uint64_t* io, int n, cudaStream_t stream) {
  return ext_chain_launch<BabyBear>(io, n, stream);
}
