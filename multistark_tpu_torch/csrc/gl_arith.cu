// K1 gl_arith: elementwise Goldilocks and GL2 (X^2 = 7) arithmetic, and the
// powers of a GL2 scalar.
//
// Replaces multistark_tpu/fields/device.py GoldilocksOps.add/sub/neg/mul/
// _reduce128, inv/_pow_const, and ExtOps (GL2_OPS) add/sub/mul/square/scale/
// inv: the jnp programs that carry every prover stage's field arithmetic on
// the TPU; and the α-power tables (multistark_tpu/prover.py:456, the
// lax.scan of α's powers).  The body is arith.cuh's, over the Goldilocks
// trait.
#include "arith.cuh"

extern "C" int gl_arith(int op, const uint64_t* a, int64_t na, int64_t ca, const uint64_t* b, int64_t nb, int64_t cb,
                        int columns, uint64_t* out, int64_t P, int64_t reps, uint64_t e, cudaStream_t stream) {
  return arith_launch<Goldilocks>(op, a, na, ca, b, nb, cb, columns, out, P, reps, e, stream);
}

extern "C" int gl_powers(const uint64_t* alpha, uint64_t* out, int64_t count, cudaStream_t stream) {
  return powers_launch<Goldilocks>(alpha, out, count, stream);
}

extern "C" int gl_ext_chain(uint64_t* io, int n, cudaStream_t stream) {
  return ext_chain_launch<Goldilocks>(io, n, stream);
}
