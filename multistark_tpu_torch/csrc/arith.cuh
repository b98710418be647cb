// The elementwise field kernel body shared by K1 gl_arith (Goldilocks, GL2)
// and K5 bb_arith (BabyBear, BB4): one templated kernel over a field trait.
//
// Bound on the card: memory.  A base mul reads 16 bytes and writes 8 for a
// few dozen integer instructions; even the Fermat inverse (~96 muls for
// Goldilocks, ~45 for BabyBear) stays below the H100's integer rate per byte
// of HBM traffic.  Design: one thread per output element, 64-bit loads on
// neighbouring addresses, one launch per op (fusing ops across the
// constraint sweep is later work).
//
// Operands broadcast by period: element i of the output reads element
// (i mod na) of operand a, so a scalar (na = 1) and a row vector repeated
// over a (w, n) matrix (na = n) take the same path.  Extension values are
// coordinate-major: coordinate d of element i sits at d*ca + (i mod na), and
// coordinate d of output element i at d*n + i.
#pragma once

#include "field.cuh"

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

template <class F>
__device__ __forceinline__ Ext<F> load_ext(const uint64_t* p, int64_t i, int64_t cs) {
  Ext<F> x;
#pragma unroll
  for (int d = 0; d < F::D; d++) x.c[d] = p[d * cs + i];
  return x;
}

template <class F>
__global__ void arith_kernel(int op, const uint64_t* __restrict__ a, int64_t na, int64_t ca,
                             const uint64_t* __restrict__ b, int64_t nb, int64_t cb, uint64_t* __restrict__ out,
                             int64_t n, uint64_t e) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int64_t ia = period_index(i, na, n);
    const int64_t ib = b ? period_index(i, nb, n) : 0;
    switch (op) {
      case ADD: out[i] = F::add(a[ia], b[ib]); break;
      case SUB: out[i] = F::sub(a[ia], b[ib]); break;
      case NEG: out[i] = F::neg(a[ia]); break;
      case MUL: out[i] = F::mul(a[ia], b[ib]); break;
      case POW: out[i] = fpow<F>(a[ia], e); break;
      case INV: out[i] = finv<F>(a[ia]); break;
      default: {
        const Ext<F> x = load_ext<F>(a, ia, ca);
        Ext<F> r;
        if (op == EXT_SCALE) {
          r = ext_scale<F>(x, b[ib]);
        } else if (op == EXT_INV) {
          r = ext_inv<F>(x);
        } else {
          const Ext<F> y = load_ext<F>(b, ib, cb);
          r = op == EXT_ADD ? ext_add<F>(x, y) : op == EXT_SUB ? ext_sub<F>(x, y) : ext_mul<F>(x, y);
        }
#pragma unroll
        for (int d = 0; d < F::D; d++) out[d * n + i] = r.c[d];
      }
    }
  }
}

template <class F>
int arith_launch(int op, const uint64_t* a, int64_t na, int64_t ca, const uint64_t* b, int64_t nb, int64_t cb,
                 uint64_t* out, int64_t n, uint64_t e, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride loop covers the rest
  arith_kernel<F><<<(unsigned)blocks, threads, 0, stream>>>(op, a, na, ca, b, nb, cb, out, n, e);
  return (int)cudaGetLastError();
}

}  // namespace
