// K1 gl_arith: elementwise Goldilocks and GL2 (X^2 = 7) arithmetic.
//
// Replaces multistark_tpu/fields/device.py GoldilocksOps.add/sub/neg/mul/
// _reduce128, inv/_pow_const, and ExtOps (GL2_OPS) add/sub/mul/square/scale/
// inv: the jnp programs that carry every prover stage's field arithmetic on
// the TPU.
//
// Bound on the card: memory.  A base mul reads 16 bytes and writes 8 for a
// few dozen integer instructions; even the Fermat inverse (~96 muls) stays
// far below the H100's integer rate per byte of HBM traffic.  Design: one
// thread per output element, 64-bit loads on neighbouring addresses, one
// launch per op (fusing ops across the constraint sweep is later work).
//
// Operands broadcast by period: element i of the output reads element
// (i mod na) of operand a, so a scalar (na = 1) and a row vector repeated
// over a (w, n) matrix (na = n) take the same path.  Extension values are
// coordinate-major: coordinate d of element i sits at d*ca + (i mod na).
#include "goldilocks.cuh"

namespace {

enum Op : int {
  ADD = 0,
  SUB = 1,
  NEG = 2,
  MUL = 3,
  POW = 4,
  INV = 5,
  EXT_ADD = 10,
  EXT_SUB = 11,
  EXT_MUL = 13,
  EXT_SCALE = 14,  // ext a times base b
  EXT_INV = 15,
};

__device__ __forceinline__ int64_t period_index(int64_t i, int64_t period, int64_t n) {
  return period == n ? i : (period == 1 ? 0 : i % period);
}

__global__ void gl_arith_kernel(int op, const uint64_t* __restrict__ a, int64_t na, int64_t ca,
                                const uint64_t* __restrict__ b, int64_t nb, int64_t cb,
                                uint64_t* __restrict__ out, int64_t n, uint64_t e) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int64_t ia = period_index(i, na, n);
    const int64_t ib = b ? period_index(i, nb, n) : 0;
    switch (op) {
      case ADD: out[i] = gl::add(a[ia], b[ib]); break;
      case SUB: out[i] = gl::sub(a[ia], b[ib]); break;
      case NEG: out[i] = gl::neg(a[ia]); break;
      case MUL: out[i] = gl::mul(a[ia], b[ib]); break;
      case POW: out[i] = gl::pow(a[ia], e); break;
      case INV: out[i] = gl::inv(a[ia]); break;
      default: {
        const gl::Ext2 x = {a[ia], a[ca + ia]};
        gl::Ext2 r;
        if (op == EXT_SCALE) {
          r = gl::ext_scale(x, b[ib]);
        } else if (op == EXT_INV) {
          r = gl::ext_inv(x);
        } else {
          const gl::Ext2 y = {b[ib], b[cb + ib]};
          r = op == EXT_ADD ? gl::ext_add(x, y) : op == EXT_SUB ? gl::ext_sub(x, y) : gl::ext_mul(x, y);
        }
        out[i] = r.c0;
        out[n + i] = r.c1;
      }
    }
  }
}

}  // namespace

extern "C" int gl_arith(int op, const uint64_t* a, int64_t na, int64_t ca, const uint64_t* b,
                        int64_t nb, int64_t cb, uint64_t* out, int64_t n, uint64_t e,
                        cudaStream_t stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride loop covers the rest
  gl_arith_kernel<<<(unsigned)blocks, threads, 0, stream>>>(op, a, na, ca, b, nb, cb, out, n, e);
  return (int)cudaGetLastError();
}
