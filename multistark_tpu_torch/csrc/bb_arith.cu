// K5 bb_arith: elementwise BabyBear and BB4 (X^4 = 11) arithmetic.
//
// Replaces multistark_tpu/fields/device.py BabyBearOps.add/sub/neg/mul/_redc,
// inv/_pow_const, and ExtOps (BB4_OPS) add/sub/mul/square/scale/inv (schoolbook
// products, karatsuba=False; the conjugate-tower inverse): the jnp programs
// that carry the BabyBearPoseidon2 config's field arithmetic on the TPU.  The
// body is arith.cuh's, over the BabyBear trait, with K1's op codes and
// broadcast-by-period rule.
#include "arith.cuh"

extern "C" int bb_arith(int op, const uint64_t* a, int64_t na, int64_t ca, const uint64_t* b,
                        int64_t nb, int64_t cb, uint64_t* out, int64_t n, uint64_t e,
                        cudaStream_t stream) {
  return arith_launch<BabyBear>(op, a, na, ca, b, nb, cb, out, n, e, stream);
}
