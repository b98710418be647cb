// K9 claims_fp: the device claims accumulator, acc0 = Σ_i (β +
// fingerprint_γ(claim_i))^-1, of an (n, L) batch of claims as uploaded
// (row-major), over Goldilocks / GL2 or BabyBear / BB4, in one launch.
//
// Replaces multistark_tpu/lookup.py claims_accumulator_device (:507-534:
// the Horner loop over claim positions and the β add, with β and γ device
// scalars, then the batch inverse of the messages and their sum).  A zero
// message contributes zero, as the JAX batch inverse maps 0 to 0.
//
// Bound on the card: the claims' bytes (8·L·n read once), the products
// (about L base scales and two extension products per claim), and a latency
// floor of one extension inversion.  The claims are read as uploaded (no
// host transpose), and the messages never reach memory (no second launch to
// batch-invert and sum them).  Design: a message is
// built from γ's powers (in shared memory, each position a base scale)
// rather than Horner's extension product per position; each thread keeps a
// fraction num/den of its claims' terms, reading its claims' words position
// by position (each load one contiguous span across a warp, 16-byte loads
// when L is even, the items' loads independent of each other) and summing
// the items' 1/m by a pairwise tree of fractions (a/b + c/d = (ad + cb)/bd),
// then inverts its den once: every thread's inversion runs in parallel, and
// what is left is a sum, by shuffles and shared memory in the block, then
// the last block to finish adds the blocks' sums.  A thread's path (its
// extension products and its inversion) bounds the launch, nearly
// independently of n: fewer claims a thread shorten it but add
// inversions, so threads take 4 (at 2^18 claims the fastest of 2, 4, 8 and
// 16 for BabyBear^4, within 1% of 8 for Goldilocks^2;
// scripts/variant_sweep.py); fractions combined across the warp and
// the block would put 8 + 8 levels of three products on that path, and the
// pairwise tree keeps each level's products independent.  Field arithmetic is
// exact, so acc0 equals the batch inverse's sum bit for bit.  The arrival
// counter is reset by that last block, so no launch ever resets it.
#include "field.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int ITEMS = 4;  // claims per thread per tile, striped THREADS apart
constexpr int MAX_POWERS = 32;  // claims up to this width take γ's powers from shared memory
constexpr int64_t TILE = (int64_t)THREADS * ITEMS;
constexpr int MAX_BLOCKS = 4096;

template <class F>
__device__ __forceinline__ Ext<F> ext_const(uint64_t c0) {
  Ext<F> r;
#pragma unroll
  for (int d = 0; d < F::D; d++) r.c[d] = d == 0 ? c0 : 0;
  return r;
}

// The block's sum, in thread 0 (all threads call it).
template <class F>
__device__ __forceinline__ Ext<F> block_sum(Ext<F> v, Ext<F>* shared) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int d = 0; d < F::D; d++)
      v.c[d] = F::add(v.c[d], __shfl_xor_sync(0xffffffffu, (unsigned long long)v.c[d], off));
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < THREADS / 32 ? shared[lane] : ext_const<F>(0);
#pragma unroll
    for (int off = THREADS / 64; off > 0; off >>= 1) {
#pragma unroll
      for (int d = 0; d < F::D; d++)
        v.c[d] = F::add(v.c[d], __shfl_xor_sync(0xffffffffu, (unsigned long long)v.c[d], off));
    }
  }
  return v;
}

template <class F>
__global__ void __launch_bounds__(THREADS)
    claims_acc_kernel(const uint64_t* __restrict__ claims, int64_t L, int64_t n, bool pairs,
                      const uint64_t* __restrict__ beta, const uint64_t* __restrict__ gamma,
                      unsigned long long* done, uint64_t* partials, uint64_t* __restrict__ out) {
  constexpr int D = F::D;
  __shared__ Ext<F> shared[THREADS / 32];
  __shared__ Ext<F> pw[MAX_POWERS];  // γ^j
  __shared__ int is_last;
  Ext<F> b, g;
#pragma unroll
  for (int d = 0; d < D; d++) {
    b.c[d] = beta[d];
    g.c[d] = gamma[d];
  }
  const bool powers = L <= MAX_POWERS;
  if (powers) {
    for (int t = threadIdx.x; t < L; t += THREADS) {  // γ^t by square-and-multiply
      Ext<F> r = ext_const<F>(1), a = g;
      for (int e = t; e; e >>= 1) {
        if (e & 1) r = ext_mul<F>(r, a);
        a = ext_mul<F>(a, a);
      }
      pw[t] = r;
    }
    __syncthreads();
  }
  // m += γ^j·v: a base scale of a power
  auto add_term = [&](Ext<F>& m, int64_t j, uint64_t v) {
    if (j == 0) {
      m.c[0] = F::add(m.c[0], v);
    } else {
#pragma unroll
      for (int d = 0; d < D; d++) m.c[d] = F::add(m.c[d], F::mul(pw[j].c[d], v));
    }
  };
  Ext<F> num = ext_const<F>(0), den = ext_const<F>(1);
  for (int64_t base = (int64_t)blockIdx.x * TILE + threadIdx.x; base < n; base += (int64_t)gridDim.x * TILE) {
    // the tile's ITEMS messages β + Σ_j γ^j·v_j, position by position: the items' loads are independent
    Ext<F> m[ITEMS];
#pragma unroll
    for (int it = 0; it < ITEMS; it++) m[it] = b;
    if (powers && pairs) {
      for (int64_t j = 0; j < L; j += 2) {
#pragma unroll
        for (int it = 0; it < ITEMS; it++) {
          const int64_t i = base + it * THREADS;
          if (i < n) {
            const ulonglong2 t = *reinterpret_cast<const ulonglong2*>(claims + i * L + j);
            add_term(m[it], j, t.x);
            add_term(m[it], j + 1, t.y);
          }
        }
      }
    } else if (powers) {
      for (int64_t j = 0; j < L; j++) {
#pragma unroll
        for (int it = 0; it < ITEMS; it++) {
          const int64_t i = base + it * THREADS;
          if (i < n) add_term(m[it], j, claims[i * L + j]);
        }
      }
    } else {  // wide claims: Horner over the positions, last first
#pragma unroll
      for (int it = 0; it < ITEMS; it++) {
        const int64_t i = base + it * THREADS;
        Ext<F> h = ext_const<F>(0);
        for (int64_t j = L - 1; i < n && j >= 0; j--) {
          h = ext_mul<F>(h, g);
          h.c[0] = F::add(h.c[0], claims[i * L + j]);
        }
        m[it] = ext_add<F>(m[it], h);
      }
    }
    // Σ 1/m over the tile's items as one fraction, by a pairwise tree (each level's products independent of
    // each other): an item past n or with a zero message is the fraction 0/1 (0 maps to 0)
    Ext<F> tn[ITEMS / 2], td[ITEMS / 2];
#pragma unroll
    for (int k = 0; k < ITEMS / 2; k++) {  // 1/a + 1/b = (a + b)/(a·b)
      const bool za = base + 2 * k * THREADS >= n || ext_is_zero<F>(m[2 * k]);
      const bool zb = base + (2 * k + 1) * THREADS >= n || ext_is_zero<F>(m[2 * k + 1]);
      const Ext<F> da = za ? ext_const<F>(1) : m[2 * k], db = zb ? ext_const<F>(1) : m[2 * k + 1];
      tn[k] = ext_add<F>(za ? ext_const<F>(0) : db, zb ? ext_const<F>(0) : da);
      td[k] = ext_mul<F>(da, db);
    }
#pragma unroll
    for (int w = 1; w < ITEMS / 2; w *= 2) {
#pragma unroll
      for (int k = 0; k + w < ITEMS / 2; k += 2 * w) {
        tn[k] = ext_add<F>(ext_mul<F>(tn[k], td[k + w]), ext_mul<F>(tn[k + w], td[k]));
        td[k] = ext_mul<F>(td[k], td[k + w]);
      }
    }
    if (base < (int64_t)(blockIdx.x + 1) * TILE) {  // the thread's first tile
      num = tn[0];
      den = td[0];
    } else {
      num = ext_add<F>(ext_mul<F>(num, td[0]), ext_mul<F>(tn[0], den));
      den = ext_mul<F>(den, td[0]);
    }
  }
  Ext<F> s = ext_is_zero<F>(num) ? num : ext_mul<F>(num, ext_inv<F>(den));
  s = block_sum<F>(s, shared);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int d = 0; d < D; d++) partials[(int64_t)blockIdx.x * D + d] = s.c[d];
    __threadfence();
    is_last = atomicAdd(done, 1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  // the last block: every other block's sum is written and fenced
  __threadfence();
  s = ext_const<F>(0);
  for (int64_t blk = threadIdx.x; blk < gridDim.x; blk += THREADS) {
#pragma unroll
    for (int d = 0; d < D; d++)
      s.c[d] = F::add(s.c[d], __ldcg(reinterpret_cast<const unsigned long long*>(partials + blk * D + d)));
  }
  __syncthreads();  // `shared` is taken again
  s = block_sum<F>(s, shared);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int d = 0; d < D; d++) out[d] = s.c[d];
    *done = 0;
  }
}

// One thread inverts x n times in a row: n dependent extension inversions'
// latency (the measurement behind K9's floor).
template <class F>
__global__ void ext_inv_chain_kernel(uint64_t* io, int n) {
  Ext<F> x;
#pragma unroll
  for (int d = 0; d < F::D; d++) x.c[d] = io[d];
  for (int i = 0; i < n; i++) x = ext_inv<F>(x);
#pragma unroll
  for (int d = 0; d < F::D; d++) io[d] = x.c[d];
}

}  // namespace

// The blocks claims_acc launches for n claims (its partials hold D words
// for each).
extern "C" int64_t claims_acc_blocks(int64_t n) {
  const int64_t tiles = (n + TILE - 1) / TILE;
  return tiles < 1 ? 1 : tiles > MAX_BLOCKS ? MAX_BLOCKS : tiles;
}

// claims: (n, L) canonical values, row-major; beta, gamma: D coordinates
// each; done: one counter word, 0 (the launch leaves it 0); partials: D
// words per block (claims_acc_blocks); out: D words.  field 0 Goldilocks
// (D = 2), 1 BabyBear (D = 4).
extern "C" int claims_acc(int field, const uint64_t* claims, int64_t L, int64_t n, const uint64_t* beta,
                          const uint64_t* gamma, uint64_t* done, uint64_t* partials, uint64_t* out,
                          cudaStream_t stream) {
  if (n <= 0 || L < 0 || (field != 0 && field != 1)) return (int)cudaErrorInvalidValue;
  const bool pairs = L % 2 == 0 && ((uintptr_t)claims & 15) == 0;
  const unsigned blocks = (unsigned)claims_acc_blocks(n);
  auto* counter = reinterpret_cast<unsigned long long*>(done);
  if (field == 0)
    claims_acc_kernel<Goldilocks><<<blocks, THREADS, 0, stream>>>(claims, L, n, pairs, beta, gamma, counter,
                                                                   partials, out);
  else
    claims_acc_kernel<BabyBear><<<blocks, THREADS, 0, stream>>>(claims, L, n, pairs, beta, gamma, counter,
                                                                 partials, out);
  return (int)cudaGetLastError();
}

// io: D coordinates, inverted n times in a row by one thread.
extern "C" int claims_inv_chain(int field, uint64_t* io, int n, cudaStream_t stream) {
  if (n < 0 || (field != 0 && field != 1)) return (int)cudaErrorInvalidValue;
  if (field == 0)
    ext_inv_chain_kernel<Goldilocks><<<1, 1, 0, stream>>>(io, n);
  else
    ext_inv_chain_kernel<BabyBear><<<1, 1, 0, stream>>>(io, n);
  return (int)cudaGetLastError();
}
