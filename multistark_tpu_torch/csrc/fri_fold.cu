// K10 fri_fold: one FRI fold round of arity 2^a with a device β, written
// straight into the next level as it is committed: the (A2·D, M/A2) matrix
// of the folded values (A2 = 2^next_a) and, for the BLAKE3 hasher, that
// matrix's leaf digests; over Goldilocks / GL2 or BabyBear / BB4.
//
// Replaces multistark_tpu/pcs.py _fold_commit_kernel (:1379: the fold with
// β, the absorb of the next height's reduced opening, the slices of the next
// level's matrix and its leaves, one program per round), built on
// _fold_multi (:1393) and _fold_absorb (:1345), which fold as a chain of a
// pair steps with β, β², β⁴, ...:
//   v'_m = (v_2m + v_2m+1)/2 + β_s·(v_2m - v_2m+1)·(1/x_2m)/2
// with 1/x the step's inverse coset points in storage (bit-reversed) order.
// Only the even entries are read, and step s + 1's are the squares of step
// s's (x_{s+1}[i] = x_s[2i]²), so the kernel takes the even entries of step
// 0 alone (pcs.inv_x_even) and squares them in registers.  β_s = β^(2^s) is
// squared in the kernel too, so β never leaves the device.
//
// Layout.  Level r's committed matrix holds the fold's partners where the
// fold wants them: partner k of output o, coordinate d, at row k·D + d,
// column o.  The input is described by strides (coordinate, partner,
// output), so the same kernel reads a (D, N) vector (partner stride 1,
// output stride A) on the sharded path.  The output matrix row j·D + d holds
// coordinate d of folded[j::A2] (utils.fold_rows' layout); with next_a = 0
// it is the (D, M) folded vector itself.  With a = 0 nothing is folded: the
// entry lays a vector out as its level's matrix (BabyBear's first level,
// which K6 hashes).
//
// Bound on the card: memory.  A round reads its level once (N·D values) and
// half of step 0's inverse-x table, writes the next matrix (N/A·D values)
// and its leaves, for a few extension products per output and a BLAKE3
// compression per 16 words of a leaf.  A folded vector written by one launch
// and laid out and hashed by another would cross memory twice more, and a
// table read at stride 2 would pull in its odd half.  Design: one thread per leaf of
// the next level: it loads the A·A2 inputs of its A2 outputs (16-byte loads:
// pairs of outputs from a matrix, pairs of partners from a vector), folds
// them in registers, adds the absorb, stores the outputs row by row
// (coalesced across threads) and hashes its leaf as one chunk in
// straight-line code (blake3.cuh hash_chunk).  The folded vector is never
// written.  Arities of 2^a·2^next_a > 8 loop over one output's code rather
// than unroll every output, which keeps the instantiations' build short.
// Blocks of 32 to 128 threads, as few as give every SM a block, so the large
// first levels spread over every SM and the small ones take one block.
#include "blake3.cuh"
#include "field.cuh"

namespace {

constexpr int MAX_LOG_ARITY = 4;
constexpr int MAX_THREADS = 128;

// How a thread's inputs are loaded: two outputs' partners as 16-byte pairs
// (output stride 1: a matrix, or a vector laid out with a = 0), two
// partners of one output as 16-byte pairs (partner stride 1: a vector), or
// 8 bytes at a time.
enum Loads { PAIRS_OF_OUTPUTS = 0, PAIRS_OF_PARTNERS = 1, SINGLE = 2 };

struct Strides {
  int64_t d, k, o;  // element (k, d, o) -- partner k of output o, coordinate d -- at in[d·st.d + k·st.k + o·st.o]
};

__device__ __forceinline__ ulonglong2 ld16(const uint64_t* p) { return *reinterpret_cast<const ulonglong2*>(p); }

// The step-0 inverse-x entries one output folds with (A/2; one slot when
// nothing is folded).
__host__ __device__ constexpr int run_len(int a_bits) { return a_bits > 0 ? 1 << (a_bits - 1) : 1; }

// N consecutive table entries from p, as 16-byte pairs where `pairs` (p on
// 16 bytes) and N is even.
template <int N>
__device__ __forceinline__ void load_run(const uint64_t* __restrict__ p, bool pairs, uint64_t (&out)[N]) {
  if constexpr (N % 2 == 0) {
    if (pairs) {
#pragma unroll
      for (int i = 0; i < N; i += 2) {
        const ulonglong2 t = ld16(p + i);
        out[i] = t.x;
        out[i + 1] = t.y;
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; i++) out[i] = p[i];
}

// The a-step fold of one output from its A partners v, with w its step-0
// even inverse-x entries (both arrays are overwritten); a = 0 returns v[0].
template <class F, int A_BITS>
__device__ __forceinline__ Ext<F> fold(Ext<F> (&v)[1 << A_BITS], uint64_t (&w)[run_len(A_BITS)],
                                       const Ext<F>& beta, uint64_t half_inv) {
  constexpr int A = 1 << A_BITS;
  Ext<F> b = beta;
#pragma unroll
  for (int s = 0; s < A_BITS; s++) {
    const int half = A >> (s + 1);
#pragma unroll
    for (int k = 0; k < half; k++) {
      const uint64_t xi = F::mul(w[k], half_inv);
      const Ext<F> sm = ext_scale<F>(ext_add<F>(v[2 * k], v[2 * k + 1]), half_inv);
      const Ext<F> df = ext_scale<F>(ext_sub<F>(v[2 * k], v[2 * k + 1]), xi);
      v[k] = ext_add<F>(sm, ext_mul<F>(df, b));
    }
    if (s + 1 < A_BITS) {
      // step s + 1's even entries: w'[k] = e_{s+1}[o·half/2 + k] = e_s[o·half + 2k]²
#pragma unroll
      for (int k = 0; k < half / 2; k++) w[k] = F::mul(w[2 * k], w[2 * k]);
      b = ext_mul<F>(b, b);
    }
  }
  return v[0];
}

// Output o = q·A2 + j of leaf q: the absorb added, stored in its rows, staged
// in the leaf's message.
template <class F, int A2_BITS, bool HASH>
__device__ __forceinline__ void emit(int j, Ext<F> f, uint32_t q, uint32_t M2, const uint64_t* __restrict__ absorb,
                                     uint64_t* __restrict__ mat, uint32_t (&msg)[HASH ? 2 * F::D << A2_BITS : 1]) {
  constexpr int D = F::D;
  const uint64_t M = (uint64_t)M2 << A2_BITS;
  const uint64_t o = ((uint64_t)q << A2_BITS) + j;
#pragma unroll
  for (int d = 0; d < D; d++) {
    if (absorb) f.c[d] = F::add(f.c[d], absorb[d * M + o]);
    mat[(uint64_t)(j * D + d) * M2 + q] = f.c[d];
    if constexpr (HASH) {
      msg[2 * (j * D + d)] = (uint32_t)f.c[d];
      msg[2 * (j * D + d) + 1] = (uint32_t)(f.c[d] >> 32);
    }
  }
}

// One leaf q of the next level: its A2 outputs o = q·A2 + j.
template <class F, int A_BITS, int A2_BITS, bool HASH>
__global__ void __launch_bounds__(MAX_THREADS)
    fri_fold_level_kernel(const uint64_t* __restrict__ in, Strides st, int loads, const uint64_t* __restrict__ inv_x,
                          bool x_pairs, const uint64_t* __restrict__ beta, uint64_t half_inv,
                          const uint64_t* __restrict__ absorb, uint32_t M2, uint64_t* __restrict__ mat,
                          uint32_t* __restrict__ leaves) {
  constexpr int A = 1 << A_BITS, A2 = 1 << A2_BITS, D = F::D, R = run_len(A_BITS);
  // the outputs' loop unrolled for small arities (the leaf's message in registers); larger ones loop over
  // one output's code, which keeps the kernel and its build small
  constexpr int JU = A * A2 <= 8 ? A2 : 1;
  const uint32_t q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= M2) return;
  Ext<F> b;
#pragma unroll
  for (int d = 0; d < D; d++) b.c[d] = A_BITS > 0 ? beta[d] : 0;
  uint32_t msg[HASH ? 2 * D * A2 : 1];  // the leaf's elements in row order, each as (low word, high word)
  bool pairs_done = false;
  if constexpr (A2 >= 2 && A_BITS <= 2) {  // larger arities take 8-byte loads rather than hold two outputs
    if (loads == PAIRS_OF_OUTPUTS) {
#pragma unroll(JU)
      for (int j = 0; j < A2; j += 2) {
        const uint64_t o = ((uint64_t)q << A2_BITS) + j;  // even: the pairs lie on 16 bytes
        Ext<F> v0[A], v1[A];
#pragma unroll
        for (int k = 0; k < A; k++)
#pragma unroll
          for (int d = 0; d < D; d++) {
            const ulonglong2 t = ld16(in + d * st.d + k * st.k + o);
            v0[k].c[d] = t.x;
            v1[k].c[d] = t.y;
          }
        uint64_t w0[R], w1[R];
        if constexpr (A_BITS > 0) {
          uint64_t w[2 * R];
          load_run<2 * R>(inv_x + o * R, x_pairs, w);
#pragma unroll
          for (int k = 0; k < R; k++) {
            w0[k] = w[k];
            w1[k] = w[R + k];
          }
        }
        emit<F, A2_BITS, HASH>(j, fold<F, A_BITS>(v0, w0, b, half_inv), q, M2, absorb, mat, msg);
        emit<F, A2_BITS, HASH>(j + 1, fold<F, A_BITS>(v1, w1, b, half_inv), q, M2, absorb, mat, msg);
      }
      pairs_done = true;
    }
  }
  if (!pairs_done) {
#pragma unroll(JU)
    for (int j = 0; j < A2; j++) {
      const uint64_t o = ((uint64_t)q << A2_BITS) + j;
      Ext<F> v[A];
      bool loaded = false;
      if constexpr (A >= 2) {
        if (loads == PAIRS_OF_PARTNERS) {
#pragma unroll
          for (int d = 0; d < D; d++)
#pragma unroll
            for (int k = 0; k < A; k += 2) {
              const ulonglong2 t = ld16(in + d * st.d + o * st.o + k);
              v[k].c[d] = t.x;
              v[k + 1].c[d] = t.y;
            }
          loaded = true;
        }
      }
      if (!loaded) {
#pragma unroll
        for (int k = 0; k < A; k++)
#pragma unroll
          for (int d = 0; d < D; d++) v[k].c[d] = in[d * st.d + k * st.k + o * st.o];
      }
      uint64_t w[R];
      if constexpr (A_BITS > 0) load_run<R>(inv_x + o * R, x_pairs, w);
      emit<F, A2_BITS, HASH>(j, fold<F, A_BITS>(v, w, b, half_inv), q, M2, absorb, mat, msg);
    }
  }
  if constexpr (HASH) {
    uint32_t cv[8];
    b3::hash_chunk<2 * D * A2>(msg, cv);
    uint4* out = reinterpret_cast<uint4*>(leaves + (uint64_t)q * 8);
    out[0] = make_uint4(cv[0], cv[1], cv[2], cv[3]);
    out[1] = make_uint4(cv[4], cv[5], cv[6], cv[7]);
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

struct Args {
  const uint64_t* in;
  Strides st;
  int loads;
  const uint64_t* inv_x;
  bool x_pairs;
  const uint64_t* beta;
  uint64_t half_inv;
  const uint64_t* absorb;
  uint32_t M2;
  uint64_t* mat;
  uint32_t* leaves;
};

template <class F, int A_BITS, int A2_BITS, bool HASH>
int launch(const Args& a, cudaStream_t stream) {
  // 32 to 128 threads a block, as few as give every SM a block
  const int64_t per_sm = ((int64_t)a.M2 + sm_count() - 1) / sm_count();
  const int threads = per_sm >= MAX_THREADS ? MAX_THREADS : (int)((per_sm + 31) / 32 * 32);
  fri_fold_level_kernel<F, A_BITS, A2_BITS, HASH><<<(unsigned)((a.M2 + threads - 1) / threads), threads, 0, stream>>>(
      a.in, a.st, a.loads, a.inv_x, a.x_pairs, a.beta, a.half_inv, a.absorb, a.M2, a.mat, a.leaves);
  return (int)cudaGetLastError();
}

// HASH only where the next level has leaves (next_a >= 1)
template <class F, bool HASH, int A_BITS>
int launch_next(int next_a, const Args& a, cudaStream_t stream) {
  switch (next_a) {
    case 0: return launch<F, A_BITS, 0, false>(a, stream);
    case 1: return launch<F, A_BITS, 1, HASH>(a, stream);
    case 2: return launch<F, A_BITS, 2, HASH>(a, stream);
    case 3: return launch<F, A_BITS, 3, HASH>(a, stream);
    case 4: return launch<F, A_BITS, 4, HASH>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class F, bool HASH>
int launch_field(int a_bits, int next_a, const Args& a, cudaStream_t stream) {
  switch (a_bits) {
    case 0:
      if constexpr (HASH) return (int)cudaErrorInvalidValue;  // the BLAKE3 first level is K3's FRI entry
      else return launch_next<F, HASH, 0>(next_a, a, stream);
    case 1: return launch_next<F, HASH, 1>(next_a, a, stream);
    case 2: return launch_next<F, HASH, 2>(next_a, a, stream);
    case 3: return launch_next<F, HASH, 3>(next_a, a, stream);
    case 4: return launch_next<F, HASH, 4>(next_a, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool on16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// One fold round into the next level.  in: element (k, d, o) at
// in[d·sd + k·sk + o·so] for partner k < 2^a_bits of output o < M2·2^next_a,
// coordinate d < D; inv_x: the even entries of step 0's inverse-x table,
// entry o·2^(a_bits-1) + k for pair k of output o (null when a_bits = 0);
// beta: D coordinates; absorb: (D, M2·2^next_a) or null; mat: (2^next_a·D,
// M2); leaves: (M2, 8) u32 digests (BLAKE3, Goldilocks only, next_a >= 1)
// or null.  field 0 Goldilocks (D = 2): 1 <= a_bits <= 4, leaves given
// exactly when next_a >= 1; field 1 BabyBear (D = 4): 0 <= a_bits <= 4 but
// not both a_bits and next_a 0, no leaves.
extern "C" int fri_fold_level(int field, const uint64_t* in, int64_t sd, int64_t sk, int64_t so, int a_bits,
                              int next_a, int64_t M2, const uint64_t* inv_x, const uint64_t* beta, uint64_t half_inv,
                              const uint64_t* absorb, uint64_t* mat, uint32_t* leaves, cudaStream_t stream) {
  if (a_bits < 0 || a_bits > MAX_LOG_ARITY || next_a < 0 || next_a > MAX_LOG_ARITY || M2 <= 0 ||
      M2 >= ((int64_t)1 << 31) || (a_bits > 0 && (!inv_x || !beta)))
    return (int)cudaErrorInvalidValue;
  if (field == 0 ? (a_bits == 0 || (leaves != nullptr) != (next_a > 0))
                 : (field != 1 || leaves != nullptr || (a_bits == 0 && (next_a == 0 || absorb))))
    return (int)cudaErrorInvalidValue;
  Args a{in, {sd, sk, so}, SINGLE, inv_x, on16(inv_x), beta, half_inv, absorb, (uint32_t)M2, mat, leaves};
  const bool even = sd % 2 == 0 && (a_bits == 0 || sk % 2 == 0);
  if (so == 1 && next_a >= 1 && on16(in) && even)
    a.loads = PAIRS_OF_OUTPUTS;
  else if (sk == 1 && a_bits >= 1 && on16(in) && sd % 2 == 0 && so % 2 == 0)
    a.loads = PAIRS_OF_PARTNERS;
  return field == 0 ? launch_field<Goldilocks, true>(a_bits, next_a, a, stream)
                    : launch_field<BabyBear, false>(a_bits, next_a, a, stream);
}
