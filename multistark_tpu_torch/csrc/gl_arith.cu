// K1 gl_arith: elementwise Goldilocks and GL2 (X^2 = 7) arithmetic.
//
// Replaces multistark_tpu/fields/device.py GoldilocksOps.add/sub/neg/mul/
// _reduce128, inv/_pow_const, and ExtOps (GL2_OPS) add/sub/mul/square/scale/
// inv: the jnp programs that carry every prover stage's field arithmetic on
// the TPU.  The body is arith.cuh's, over the Goldilocks trait.
#include "arith.cuh"

extern "C" int gl_arith(int op, const uint64_t* a, int64_t na, int64_t ca, const uint64_t* b,
                        int64_t nb, int64_t cb, uint64_t* out, int64_t n, uint64_t e,
                        cudaStream_t stream) {
  return arith_launch<Goldilocks>(op, a, na, ca, b, nb, cb, out, n, e, stream);
}
