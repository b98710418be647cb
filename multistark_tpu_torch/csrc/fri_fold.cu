// K10 fri_fold: one FRI fold round of arity 2^a with a device β, and the
// reduced opening of the next height added when one is given, over
// Goldilocks / GL2 or BabyBear / BB4.
//
// Replaces multistark_tpu/pcs.py _fold_multi (:1393) and _fold_absorb
// (:1345), which fold as a chain of a pair steps with β, β², β⁴, ...:
//   v'_m = (v_2m + v_2m+1)/2 + β_s·(v_2m - v_2m+1)/(2·x_2m)
// with 1/x_2m read from the step's inverse-x table in storage (bit-reversed)
// order, the table pcs.x_table_storage builds.  β_s = β^(2^s) is squared
// inside the kernel, so β never leaves the device.
//
// Bound on the card: memory.  A round reads the N·D input values once and
// writes N/2^a·D (plus half of each step's table), for a few extension
// products per output.  Design: one thread per output element; fold
// partners are adjacent in storage, so a thread loads its 2^a inputs
// (contiguous, coordinate-major), runs all a steps in registers and writes
// one value: one pass over HBM per round instead of one per step.
#include "field.cuh"

namespace {

constexpr int MAX_LOG_ARITY = 4;

struct InvXTables {
  const uint64_t* t[MAX_LOG_ARITY];
};

template <class F>
__global__ void fri_fold_kernel(const uint64_t* __restrict__ cur, int64_t n_in, int log_arity, InvXTables inv_x,
                                const uint64_t* __restrict__ beta, uint64_t half_inv,
                                const uint64_t* __restrict__ absorb, uint64_t* __restrict__ out) {
  const int A = 1 << log_arity;
  const int64_t n_out = n_in >> log_arity;
  Ext<F> b0;
#pragma unroll
  for (int d = 0; d < F::D; d++) b0.c[d] = beta[d];
  for (int64_t o = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; o < n_out; o += (int64_t)gridDim.x * blockDim.x) {
    Ext<F> v[1 << MAX_LOG_ARITY];
    for (int k = 0; k < A; k++) {
#pragma unroll
      for (int d = 0; d < F::D; d++) v[k].c[d] = cur[d * n_in + o * A + k];
    }
    Ext<F> b = b0;
    for (int s = 0; s < log_arity; s++) {
      const int half = A >> (s + 1);
      for (int k = 0; k < half; k++) {
        // pair m = o·half + k of step s: elements 2m, 2m + 1 of the step's vector
        const uint64_t xi = F::mul(inv_x.t[s][2 * (o * half + k)], half_inv);
        const Ext<F> sm = ext_scale<F>(ext_add<F>(v[2 * k], v[2 * k + 1]), half_inv);
        const Ext<F> df = ext_scale<F>(ext_sub<F>(v[2 * k], v[2 * k + 1]), xi);
        v[k] = ext_add<F>(sm, ext_mul<F>(df, b));
      }
      b = ext_mul<F>(b, b);
    }
    if (absorb) {
#pragma unroll
      for (int d = 0; d < F::D; d++) v[0].c[d] = F::add(v[0].c[d], absorb[d * n_out + o]);
    }
#pragma unroll
    for (int d = 0; d < F::D; d++) out[d * n_out + o] = v[0].c[d];
  }
}

}  // namespace

// cur: (D, n_in) coordinate-major; inv_x: log_arity tables (step s of length
// n_in >> s); beta: D coordinates; absorb: (D, n_out) or null; out: (D, n_out)
// with n_out = n_in >> log_arity.  field 0 Goldilocks (D = 2), 1 BabyBear (D = 4).
extern "C" int fri_fold(int field, const uint64_t* cur, int64_t n_in, int log_arity, const uint64_t* const* inv_x,
                        const uint64_t* beta, uint64_t half_inv, const uint64_t* absorb, uint64_t* out,
                        cudaStream_t stream) {
  if (log_arity < 1 || log_arity > MAX_LOG_ARITY || (field != 0 && field != 1)) return (int)cudaErrorInvalidValue;
  const int64_t n_out = n_in >> log_arity;
  if (n_out <= 0) return (int)cudaErrorInvalidValue;
  InvXTables tabs;
  for (int s = 0; s < MAX_LOG_ARITY; s++) tabs.t[s] = s < log_arity ? inv_x[s] : nullptr;
  const int threads = 256;
  int64_t blocks = (n_out + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  if (field == 0)
    fri_fold_kernel<Goldilocks><<<(unsigned)blocks, threads, 0, stream>>>(cur, n_in, log_arity, tabs, beta, half_inv,
                                                                           absorb, out);
  else
    fri_fold_kernel<BabyBear><<<(unsigned)blocks, threads, 0, stream>>>(cur, n_in, log_arity, tabs, beta, half_inv,
                                                                         absorb, out);
  return (int)cudaGetLastError();
}
