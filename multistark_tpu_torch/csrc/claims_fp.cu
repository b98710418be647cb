// K9 claims_fp: the logUp messages of the claims, β + fingerprint_γ(claim),
// for an (L, n) batch of claims over Goldilocks / GL2 or BabyBear / BB4.
//
// Replaces the message half of multistark_tpu/lookup.py
// claims_accumulator_device (:507-534: the Horner loop over claim positions
// and the β add, with β and γ device scalars).  The batch inverse and the sum
// that follow stay on K4 (gl_scan).  acc0 = Σ_i (β + Σ_j γ^j v_ij)^-1.
//
// Bound on the card: memory.  A claim reads L values and writes one
// extension element for L extension products, far below the integer rate
// per byte.  Design: one thread per claim, β and γ in registers; the claims
// are column-major (position j of every claim contiguous), so neighbouring
// threads read neighbouring addresses.  The output is coordinate-major (D, n).
#include "field.cuh"

namespace {

template <class F>
__global__ void claims_fp_kernel(const uint64_t* __restrict__ cols, int64_t L, int64_t n,
                                 const uint64_t* __restrict__ beta, const uint64_t* __restrict__ gamma,
                                 uint64_t* __restrict__ out) {
  Ext<F> b, g;
#pragma unroll
  for (int d = 0; d < F::D; d++) {
    b.c[d] = beta[d];
    g.c[d] = gamma[d];
  }
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (int64_t)gridDim.x * blockDim.x) {
    Ext<F> m;
#pragma unroll
    for (int d = 0; d < F::D; d++) m.c[d] = 0;
    for (int64_t j = L - 1; j >= 0; j--) {
      m = ext_mul<F>(m, g);
      m.c[0] = F::add(m.c[0], cols[j * n + i]);
    }
    m = ext_add<F>(m, b);
#pragma unroll
    for (int d = 0; d < F::D; d++) out[d * n + i] = m.c[d];
  }
}

}  // namespace

// cols: (L, n) canonical values; beta, gamma: D coordinates each; out: (D, n).
// field 0 Goldilocks (D = 2), 1 BabyBear (D = 4).
extern "C" int claims_fp(int field, const uint64_t* cols, int64_t L, int64_t n, const uint64_t* beta,
                         const uint64_t* gamma, uint64_t* out, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (L < 0 || (field != 0 && field != 1)) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  if (field == 0) claims_fp_kernel<Goldilocks><<<(unsigned)blocks, threads, 0, stream>>>(cols, L, n, beta, gamma, out);
  else claims_fp_kernel<BabyBear><<<(unsigned)blocks, threads, 0, stream>>>(cols, L, n, beta, gamma, out);
  return (int)cudaGetLastError();
}
