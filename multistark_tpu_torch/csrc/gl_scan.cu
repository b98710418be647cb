// K4 gl_scan: mod-p scans and reductions along the last axis of a
// (rows, n) batch of Goldilocks / GL2 or BabyBear / BB4 values, and the
// logUp stage-2 chain.
//
// Replaces multistark_tpu/utils.py _batch_inv_impl (Montgomery-trick batch
// inverse, zero -> zero), field_sum and cumsum (the logUp accumulator
// chain), and the two programs built on them: lookup.py _stage2_scan (terms
// mult/message, inclusive chain, exclusive shift plus the accumulator, the
// column layout) after the batch inverse of the messages, and the sum of
// inverses of lookup.py claims_accumulator_device.  One templated body
// serves both fields and both extension degrees (field.cuh).
//
// Bound on the card: memory for the scans and sums (an addition per
// element); the batch inverse (three field products per element and an
// inversion of about 100 base products per thread's run) and the stage-2
// chain by their products, 64-bit Goldilocks or Barrett-reduced BabyBear
// products on 32-bit integer units.  The first version ran a scan as a
// chain of launches (tile scan, a scan of the tile totals, add-back), a
// batch inverse as two such scans plus two more launches, and read each
// thread's run of consecutive elements straight from memory (a warp's
// loads 64 bytes apart).  The design here makes every entry one launch
// that reads each element once and writes each output once:
//   - batch inverse: products commute, so each block takes a tile of
//     THREADS·ITEMS elements in a striped order (thread t the elements t,
//     t + THREADS, ...: every load and store coalesced), each thread runs
//     the prefix products of its items in registers (0 read as 1), inverts
//     their product once and walks back through its items; zeros map to 0.
//     An inversion (about 100 base products) executed by a warp costs the
//     same instruction stream whether its lanes invert one value or 32, so
//     sharing one inversion across lanes (shuffle scans, or one warp for
//     the block) only adds work or idles warps: both were measured slower.
//     The items are read again for the walk back rather than held across
//     the inversion, BabyBear values are held in 32-bit words, and the
//     extension products are K4's own (below): registers and products are
//     what bound it.  No dependency between tiles remains.
//   - cumsum and the stage-2 chain: a single pass with decoupled look-back.
//     A block takes its tile index from an atomic ticket (blocks start in no
//     order, so an index from blockIdx could wait on a tile that has not
//     started), stages the tile through shared memory so that each thread
//     owns ITEMS consecutive elements while every global access stays
//     coalesced, scans it, publishes the tile's aggregate, and warp 0 looks
//     back 32 tiles at a time until it meets a tile that has published its
//     inclusive prefix.  A value of up to four words cannot be published
//     atomically with its flag, so the value is written first and the flag
//     released after it (st.release.gpu), and a reader acquires the flag
//     before it reads the value.  Each flag carries the launch's epoch in
//     its upper bits, so the status words never need a reset launch: a flag
//     from an earlier launch reads as "not yet".  The ticket counter is never
//     reset either: the wrapper knows how many tickets were issued before.
//   - field_sum and the sum of inverses: tile partial sums, then the last
//     block of each row (a counter per row, which that block sets back to
//     0) adds them.
//   - the stage-2 chain reads K11's (D+1, n·L) messages and multiplicities
//     once, inverts, scales, scans and adds the accumulator within the tile,
//     and writes the (L·D, n) stage-2 matrix through shared memory so that
//     each slot's row segment is stored coalesced.
// Exactness (add and mul mod p are associative and commutative) is what
// lets the tiles change the order of combination: every output equals the
// plain version's bit for bit.
//
// Extension values are coordinate-major: coordinate d of an element sits
// d * cs words after coordinate 0.
#include <type_traits>

#include "field.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr uint64_t AGGREGATE = 1, INCLUSIVE = 2;  // the low two bits of a status flag

// -- the status words' memory order ---------------------------------------------

__device__ __forceinline__ void st_release(uint64_t* p, uint64_t v) {
#ifdef __CUDA_ARCH__
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
#else
  __atomic_store_n(p, v, __ATOMIC_RELEASE);
#endif
}

__device__ __forceinline__ uint64_t ld_acquire(const uint64_t* p) {
#ifdef __CUDA_ARCH__
  uint64_t v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
#else
  return __atomic_load_n(p, __ATOMIC_ACQUIRE);
#endif
}

__device__ __forceinline__ uint64_t ld_relaxed(const uint64_t* p) {
#ifdef __CUDA_ARCH__
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
#else
  return __atomic_load_n(p, __ATOMIC_RELAXED);
#endif
}

// -- values of K words: a base element (K = 1) or an extension element ---------

// A BabyBear value fits 32 bits: held in 32-bit words, half the registers.
template <class Fld>
using Word = typename std::conditional<(Fld::P >> 32) == 0, uint32_t, uint64_t>::type;

template <class Fld, int K>
struct Val {
  Word<Fld> c[K];
};

template <class Fld, int K>
__device__ __forceinline__ Val<Fld, K> v_word(uint64_t c0) {
  Val<Fld, K> r;
  r.c[0] = static_cast<Word<Fld>>(c0);
  return r;
}

template <class Fld, int K>
__device__ __forceinline__ Val<Fld, K> v_const(uint64_t c0) {
  Val<Fld, K> r;
#pragma unroll
  for (int d = 0; d < K; d++) r.c[d] = 0;
  r.c[0] = c0;
  return r;
}

template <class Fld, int K>
__device__ __forceinline__ Val<Fld, K> v_add(const Val<Fld, K>& a, const Val<Fld, K>& b) {
  Val<Fld, K> r;
#pragma unroll
  for (int d = 0; d < K; d++) r.c[d] = Fld::add(a.c[d], b.c[d]);
  return r;
}

template <class Fld, int K>
__device__ __forceinline__ Ext<Fld> to_ext(const Val<Fld, K>& a) {
  Ext<Fld> e;
#pragma unroll
  for (int d = 0; d < Fld::D; d++) e.c[d] = a.c[d];
  return e;
}

template <class Fld, int K>
__device__ __forceinline__ Val<Fld, K> from_ext(const Ext<Fld>& e) {
  Val<Fld, K> r;
#pragma unroll
  for (int d = 0; d < K; d++) r.c[d] = e.c[d];
  return r;
}

// The product.  The batch inverse spends its time here, so the extension
// products are K4's own: Karatsuba for D = 2 (three base products and the
// one by W, against field.cuh's four and one), and for BabyBear's D = 4 the
// sixteen 32x32-bit products summed unreduced (each below 2^62, at most
// four to a sum, so below 2^64) with one Barrett reduction per coordinate
// and per wrap, against field.cuh's twenty-two reduced products.  All exact.
template <class Fld, int K>
__device__ __forceinline__ Val<Fld, K> v_mul(const Val<Fld, K>& a, const Val<Fld, K>& b) {
  static_assert(K == 1 || K == Fld::D, "an extension value has D words");
  if constexpr (K == 1) {
    return v_word<Fld, K>(Fld::mul(a.c[0], b.c[0]));
  } else if constexpr (K == 2) {
    const uint64_t t0 = Fld::mul(a.c[0], b.c[0]), t1 = Fld::mul(a.c[1], b.c[1]);
    const uint64_t t2 = Fld::mul(Fld::add(a.c[0], a.c[1]), Fld::add(b.c[0], b.c[1]));
    Val<Fld, K> r;
    r.c[0] = static_cast<Word<Fld>>(Fld::add(t0, Fld::mul(Fld::W, t1)));
    r.c[1] = static_cast<Word<Fld>>(Fld::sub(t2, Fld::add(t0, t1)));
    return r;
  } else if constexpr (std::is_same<Fld, BabyBear>::value && K == 4) {
    uint64_t lo[4] = {0, 0, 0, 0}, hi[3] = {0, 0, 0};  // coefficients of X^k and X^(k+4)
#pragma unroll
    for (int i = 0; i < 4; i++) {
#pragma unroll
      for (int j = 0; j < 4; j++) {
        const uint64_t p = (uint64_t)a.c[i] * b.c[j];
        if (i + j < 4) lo[i + j] += p;
        else hi[i + j - 4] += p;
      }
    }
    Val<Fld, K> r;
#pragma unroll
    for (int k = 0; k < 4; k++)
      r.c[k] = static_cast<Word<Fld>>(bb::reduce(k < 3 ? lo[k] + Fld::W * bb::reduce(hi[k]) : lo[k]));
    return r;
  } else {
    return from_ext<Fld, K>(ext_mul<Fld>(to_ext(a), to_ext(b)));
  }
}

template <class Fld, int K>
__device__ __forceinline__ Val<Fld, K> v_inv(const Val<Fld, K>& a) {
  if constexpr (K == 1) {
    return v_word<Fld, K>(finv<Fld>(a.c[0]));
  } else {
    return from_ext<Fld, K>(ext_inv<Fld>(to_ext(a)));
  }
}

template <class Fld, int K>
__device__ __forceinline__ Val<Fld, K> v_scale(const Val<Fld, K>& a, uint64_t s) {
  Val<Fld, K> r;
#pragma unroll
  for (int d = 0; d < K; d++) r.c[d] = Fld::mul(a.c[d], s);
  return r;
}

template <class Fld, int K>
__device__ __forceinline__ bool v_is_zero(const Val<Fld, K>& a) {
  uint64_t any = 0;
#pragma unroll
  for (int d = 0; d < K; d++) any |= a.c[d];
  return any == 0;
}

template <class Fld, int K>
__device__ __forceinline__ Val<Fld, K> v_load(const uint64_t* p, int64_t i, int64_t cs) {
  Val<Fld, K> r;
#pragma unroll
  for (int d = 0; d < K; d++) r.c[d] = p[d * cs + i];
  return r;
}

template <class Fld, int K>
__device__ __forceinline__ void v_store(uint64_t* p, int64_t i, int64_t cs, const Val<Fld, K>& v) {
#pragma unroll
  for (int d = 0; d < K; d++) p[d * cs + i] = v.c[d];
}

// shared memory laid out [K][THREADS]
template <class Fld, int K, int THREADS>
__device__ __forceinline__ Val<Fld, K> v_sload(uint64_t (*s)[THREADS], int i) {
  Val<Fld, K> r;
#pragma unroll
  for (int d = 0; d < K; d++) r.c[d] = s[d][i];
  return r;
}

template <class Fld, int K, int THREADS>
__device__ __forceinline__ void v_sstore(uint64_t (*s)[THREADS], int i, const Val<Fld, K>& v) {
#pragma unroll
  for (int d = 0; d < K; d++) s[d][i] = v.c[d];
}

enum Shfl { UP, XOR };

template <Shfl S, class Fld, int K>
__device__ __forceinline__ Val<Fld, K> v_shfl(const Val<Fld, K>& v, int arg) {
  Val<Fld, K> r;
#pragma unroll
  for (int d = 0; d < K; d++) {
    using W = typename std::conditional<sizeof(Word<Fld>) == 4, unsigned, unsigned long long>::type;
    const W w = v.c[d];
    if constexpr (S == UP) r.c[d] = __shfl_up_sync(FULL, w, arg);
    if constexpr (S == XOR) r.c[d] = __shfl_xor_sync(FULL, w, arg);
  }
  return r;
}

// -- block building blocks (every thread of the block calls them) ----------------

// Inverts a thread's ITEMS values, zeros mapping to zero: the prefix
// products, one inversion of their product, then the walk back.  load(j)
// gives item j (0 past the end: it inverts to 0) and is called twice, so
// the items need not stay in registers across the inversion (fewer
// registers, more warps per SM); put(j, v) takes item j's inverse, in the
// order j = ITEMS - 1 down to 0, after the last load(j).
template <class Fld, int K, int ITEMS, class Load, class Put>
__device__ __forceinline__ void batch_inverse(Load load, Put put) {
  using V = Val<Fld, K>;
  const V one = v_const<Fld, K>(1);
  unsigned zero = 0;
  V pre[ITEMS - 1];
  V run = one;
#pragma unroll
  for (int j = 0; j < ITEMS; j++) {
    V x = load(j);
    if (v_is_zero(x)) {
      zero |= 1u << j;
      x = one;
    }
    run = v_mul(run, x);
    if (j < ITEMS - 1) pre[j] = run;
  }
  V acc = v_inv(run);
#pragma unroll
  for (int j = ITEMS - 1; j >= 0; j--) {
    const bool z = (zero >> j) & 1;
    if (j > 0) {
      const V x = load(j);  // before put(j), which may overwrite it
      put(j, z ? v_const<Fld, K>(0) : v_mul(acc, pre[j - 1]));
      if (!z) acc = v_mul(acc, x);
    } else {
      put(j, z ? v_const<Fld, K>(0) : acc);
    }
  }
}

// Sum of the block's x, valid in thread 0.
template <class Fld, int K, int THREADS>
__device__ Val<Fld, K> block_sum(Val<Fld, K> x, uint64_t (*tot)[THREADS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = v_add(x, v_shfl<XOR>(x, off));
  if (lane == 0) v_sstore<Fld, K, THREADS>(tot, warp, x);
  __syncthreads();
  Val<Fld, K> s = v_const<Fld, K>(0);
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; w++) s = v_add(s, v_sload<Fld, K, THREADS>(tot, w));
  __syncthreads();
  return s;
}

// Exclusive prefix sum of x over the block's threads; *total gets the sum
// of all of them.
template <class Fld, int K, int THREADS>
__device__ Val<Fld, K> block_exclusive_sum(const Val<Fld, K>& x, Val<Fld, K>* total, uint64_t (*tot)[THREADS]) {
  using V = Val<Fld, K>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  V incl = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const V o = v_shfl<UP>(incl, off);
    if (lane >= off) incl = v_add(incl, o);
  }
  if (lane == 31) v_sstore<Fld, K, THREADS>(tot, warp, incl);
  __syncthreads();
  V before = v_const<Fld, K>(0), all = before;
#pragma unroll
  for (int w = 0; w < THREADS / 32; w++) {
    const V y = v_sload<Fld, K, THREADS>(tot, w);
    all = v_add(all, y);
    if (w < warp) before = v_add(before, y);
  }
  V ex = v_shfl<UP>(incl, 1);
  if (lane == 0) ex = v_const<Fld, K>(0);
  *total = all;
  __syncthreads();
  return v_add(before, ex);
}

// The status words of the single-pass kernels, in one scratch buffer of the
// wrapper: [0] the ticket counter, then a flag per tile slot, then K words
// of aggregate and K words of inclusive prefix per slot.
struct Status {
  unsigned long long* ticket;
  uint64_t ticket_base;
  uint64_t epoch;
  uint64_t* flags;
  uint64_t* agg;
  uint64_t* incl;
};

Status status_of(uint64_t* scratch, int64_t slots, int K, uint64_t ticket_base, uint64_t epoch) {
  Status st;
  st.ticket = reinterpret_cast<unsigned long long*>(scratch);
  st.ticket_base = ticket_base;
  st.epoch = epoch;
  st.flags = scratch + 1;
  st.agg = st.flags + slots;
  st.incl = st.agg + slots * K;
  return st;
}

// The block's tile index from the ticket (thread 0 takes it; all get it).
__device__ __forceinline__ int64_t take_ticket(const Status& st) {
  __shared__ int64_t id;
  if (threadIdx.x == 0) id = (int64_t)(atomicAdd(st.ticket, 1ull) - st.ticket_base);
  __syncthreads();
  const int64_t r = id;
  __syncthreads();
  return r;
}

// Decoupled look-back: the exclusive prefix of tile `tile` of the row whose
// slots start at slot0, given the tile's aggregate.  Publishes the tile's
// aggregate, then its inclusive prefix (and, for the row's last tile, writes
// that to `total` if given).  Every thread gets the result.
template <class Fld, int K, int THREADS>
__device__ Val<Fld, K> look_back(const Status& st, int64_t slot0, int64_t tile, const Val<Fld, K>& agg,
                                 uint64_t* total, bool last, uint64_t (*tot)[THREADS]) {
  using V = Val<Fld, K>;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int64_t slot = slot0 + tile;
    V excl = v_const<Fld, K>(0);
    if (tile > 0) {
      if (lane == 0) {
#pragma unroll
        for (int d = 0; d < K; d++) st.agg[slot * K + d] = agg.c[d];
        st_release(st.flags + slot, st.epoch << 2 | AGGREGATE);
      }
      for (int64_t look = tile - 1;; look -= 32) {
        const int64_t u = look - lane;
        uint64_t state = INCLUSIVE;  // before the row's first tile: an inclusive prefix of 0
        V val = v_const<Fld, K>(0);
        if (u >= 0) {
          uint64_t f;
          do {
            f = ld_acquire(st.flags + slot0 + u);
          } while ((f >> 2) != st.epoch);
          state = f & 3;
          const uint64_t* src = (state == INCLUSIVE ? st.incl : st.agg) + (slot0 + u) * K;
#pragma unroll
          for (int d = 0; d < K; d++) val.c[d] = ld_relaxed(src + d);
        }
        const unsigned inclusive = __ballot_sync(FULL, state == INCLUSIVE);
        // lanes up to the nearest inclusive prefix count (all 32 when there is none)
        if (inclusive && lane > __ffs(inclusive) - 1) val = v_const<Fld, K>(0);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) val = v_add(val, v_shfl<XOR>(val, off));
        excl = v_add(excl, val);
        if (inclusive) break;
      }
    }
    if (lane == 0) {
      const V inc = v_add(excl, agg);
#pragma unroll
      for (int d = 0; d < K; d++) st.incl[slot * K + d] = inc.c[d];
      st_release(st.flags + slot, st.epoch << 2 | INCLUSIVE);
      if (last && total) v_store(total, 0, 1, inc);
      v_sstore<Fld, K, THREADS>(tot, 0, excl);
    }
  }
  __syncthreads();
  const V r = v_sload<Fld, K, THREADS>(tot, 0);
  __syncthreads();
  return r;
}

// Last block done: thread 0 holds the block's partial sum for (row, tile);
// the last block of the row to finish adds the row's partials into
// out[row] and sets the row's counter back to 0 for the next launch (every
// other block of the row has counted by then).
template <class Fld, int K, int THREADS>
__device__ void row_total(const Val<Fld, K>& part, int64_t row, int64_t tile, int64_t tiles, uint64_t* done,
                          uint64_t* partials, uint64_t* out, int64_t cs_out, uint64_t (*tot)[THREADS]) {
  using V = Val<Fld, K>;
  __shared__ int is_last;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int d = 0; d < K; d++) partials[(row * tiles + tile) * K + d] = part.c[d];
    __threadfence();
    const unsigned long long before = atomicAdd(reinterpret_cast<unsigned long long*>(done + row), 1ull);
    is_last = (int64_t)before == tiles - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  V s = v_const<Fld, K>(0);
  for (int64_t i = threadIdx.x; i < tiles; i += THREADS) {
    V y;
#pragma unroll
    for (int d = 0; d < K; d++) y.c[d] = ld_relaxed(partials + (row * tiles + i) * K + d);
    s = v_add(s, y);
  }
  s = block_sum<Fld, K, THREADS>(s, tot);
  if (threadIdx.x == 0) {
    v_store(out, row, cs_out, s);
    done[row] = 0;
  }
}

// -- the kernels ------------------------------------------------------------------

constexpr int THREADS = 256;

template <int K>
struct Striped {  // batch inverse and sums: a thread's items THREADS apart
  static constexpr int ITEMS = K == 4 ? 4 : 8;
  static constexpr int64_t TILE = (int64_t)THREADS * ITEMS;
};

// The inverse of every element of row blockIdx.x / tiles, tile
// blockIdx.x % tiles (or, with `out` null, their sum into sums[row]).
template <class Fld, int K>
__global__ void __launch_bounds__(THREADS)
    batch_inv_kernel(const uint64_t* __restrict__ in, int64_t cs_in, uint64_t* __restrict__ out, int64_t cs_out,
                     int64_t n, int64_t tiles, uint64_t* done, uint64_t* partials, uint64_t* sums, int64_t cs_sums) {
  using V = Val<Fld, K>;
  constexpr int ITEMS = Striped<K>::ITEMS;
  __shared__ uint64_t tot[K][THREADS];
  const int64_t row = blockIdx.x / tiles, tile = blockIdx.x - row * tiles;
  const int64_t first = row * n + tile * Striped<K>::TILE + threadIdx.x;
  const int64_t lim = n - tile * Striped<K>::TILE;
  const auto load = [&](int j) {
    return (int64_t)j * THREADS + threadIdx.x < lim ? v_load<Fld, K>(in, first + (int64_t)j * THREADS, cs_in)
                                                    : v_const<Fld, K>(0);
  };
  if (out) {
    batch_inverse<Fld, K, ITEMS>(load, [&](int j, const V& v) {
      if ((int64_t)j * THREADS + threadIdx.x < lim) v_store(out, first + (int64_t)j * THREADS, cs_out, v);
    });
    return;
  }
  V s = v_const<Fld, K>(0);  // items past the row's end are 0 and invert to 0
  batch_inverse<Fld, K, ITEMS>(load, [&](int, const V& v) { s = v_add(s, v); });
  row_total<Fld, K, THREADS>(block_sum<Fld, K, THREADS>(s, tot), row, tile, tiles, done, partials, sums, cs_sums,
                             tot);
}

// Sum of each row (base values).
template <class Fld>
__global__ void __launch_bounds__(THREADS)
    sum_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out, int64_t n, int64_t tiles,
               uint64_t* done, uint64_t* partials) {
  using V = Val<Fld, 1>;
  constexpr int ITEMS = Striped<1>::ITEMS;
  __shared__ uint64_t tot[1][THREADS];
  const int64_t row = blockIdx.x / tiles, tile = blockIdx.x - row * tiles;
  const int64_t first = row * n + tile * Striped<1>::TILE + threadIdx.x;
  const int64_t lim = n - tile * Striped<1>::TILE;
  V s = v_const<Fld, 1>(0);
#pragma unroll
  for (int j = 0; j < ITEMS; j++)
    if ((int64_t)j * THREADS + threadIdx.x < lim) s = v_add(s, v_word<Fld, 1>(in[first + (int64_t)j * THREADS]));
  row_total<Fld, 1, THREADS>(block_sum<Fld, 1, THREADS>(s, tot), row, tile, tiles, done, partials, out, 1, tot);
}

// Blocked tiles of the single-pass scans: thread t owns ITEMS consecutive
// elements, staged through shared memory padded by one word per ITEMS (an
// odd word stride between threads: no bank conflicts).
template <int ITEMS>
__device__ __forceinline__ int pad(int i) {
  return i + i / ITEMS;
}

constexpr int SCAN_ITEMS = 8;
constexpr int SCAN_TILE = THREADS * SCAN_ITEMS;

// Inclusive prefix sum of each row (base values), one pass.
template <class Fld>
__global__ void __launch_bounds__(THREADS)
    cumsum_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out, int64_t n, int64_t tiles,
                  Status st) {
  using V = Val<Fld, 1>;
  __shared__ uint64_t buf[SCAN_TILE + SCAN_TILE / SCAN_ITEMS];
  __shared__ uint64_t tot[1][THREADS];
  const int64_t id = take_ticket(st);
  const int64_t row = id / tiles, tile = id - row * tiles;
  const int64_t off = row * n + tile * SCAN_TILE;
  const int lim = (int)(n - tile * SCAN_TILE < SCAN_TILE ? n - tile * SCAN_TILE : SCAN_TILE);
  for (int i = threadIdx.x; i < SCAN_TILE; i += THREADS) buf[pad<SCAN_ITEMS>(i)] = i < lim ? in[off + i] : 0;
  __syncthreads();
  V v[SCAN_ITEMS];
  V run = v_const<Fld, 1>(0);
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; j++) {
    run = v_add(run, v_word<Fld, 1>(buf[pad<SCAN_ITEMS>(threadIdx.x * SCAN_ITEMS + j)]));
    v[j] = run;
  }
  V agg;
  const V before = block_exclusive_sum<Fld, 1, THREADS>(run, &agg, tot);
  const V pre = v_add(look_back<Fld, 1, THREADS>(st, row * tiles, tile, agg, nullptr, false, tot), before);
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; j++) buf[pad<SCAN_ITEMS>(threadIdx.x * SCAN_ITEMS + j)] = v_add(pre, v[j]).c[0];
  __syncthreads();
  for (int i = threadIdx.x; i < lim; i += THREADS) out[off + i] = buf[pad<SCAN_ITEMS>(i)];
}

constexpr int CHAIN_THREADS = 128;

template <int K>
struct Chain {
  static constexpr int ITEMS = K == 4 ? 4 : 8;
  static constexpr int TILE = CHAIN_THREADS * ITEMS;
  static constexpr int PADDED = TILE + TILE / ITEMS;
};

// The logUp stage-2 chain of one circuit: msgs is K11's (D+1, N = n·L)
// output (planes 0..D-1 the slot messages in chain order, plane D the
// multiplicities); term_i = mult_i / msg_i (a zero message gives 0), the
// chain's exclusive prefix plus acc is written as mat (L·D, n), row j·D + d
// = coordinate d of slot j, and the chain's total to total (D words).
template <class Fld>
__global__ void __launch_bounds__(CHAIN_THREADS)
    stage2_chain_kernel(const uint64_t* __restrict__ msgs, int64_t N, int L, int64_t n,
                        const uint64_t* __restrict__ acc, uint64_t* __restrict__ mat, uint64_t* total,
                        int64_t tiles, Status st) {
  constexpr int K = Fld::D, ITEMS = Chain<K>::ITEMS, TILE = Chain<K>::TILE;
  using V = Val<Fld, K>;
  __shared__ uint64_t buf[K + 1][Chain<K>::PADDED];
  __shared__ uint64_t tot[K][CHAIN_THREADS];
  const int t = threadIdx.x;
  const int64_t tile = take_ticket(st);
  const int64_t i0 = tile * TILE;
  const int lim = (int)(N - i0 < TILE ? N - i0 : TILE);
#pragma unroll
  for (int p = 0; p <= K; p++)
    for (int i = t; i < TILE; i += CHAIN_THREADS) buf[p][pad<ITEMS>(i)] = i < lim ? msgs[p * N + i0 + i] : 0;
  __syncthreads();
  // the messages' inverses replace them in buf, then the thread's
  // exclusive prefix of the terms inverse · multiplicity replaces those
  const auto at = [&](int j) { return pad<ITEMS>(t * ITEMS + j); };
  batch_inverse<Fld, K, ITEMS>(
      [&](int j) {  // past the chain's end: 0 -> 0
        V x;
#pragma unroll
        for (int d = 0; d < K; d++) x.c[d] = buf[d][at(j)];
        return x;
      },
      [&](int j, const V& v) {
#pragma unroll
        for (int d = 0; d < K; d++) buf[d][at(j)] = v.c[d];
      });
  V run = v_const<Fld, K>(0);
#pragma unroll
  for (int j = 0; j < ITEMS; j++) {
    V inv;
#pragma unroll
    for (int d = 0; d < K; d++) inv.c[d] = buf[d][at(j)];
#pragma unroll
    for (int d = 0; d < K; d++) buf[d][at(j)] = run.c[d];
    run = v_add(run, v_scale(inv, buf[K][at(j)]));
  }
  V agg;
  const V before = block_exclusive_sum<Fld, K, CHAIN_THREADS>(run, &agg, tot);
  const V excl = look_back<Fld, K, CHAIN_THREADS>(st, 0, tile, agg, total, tile == tiles - 1, tot);
  const V base = v_add(v_add(excl, before), v_load<Fld, K>(acc, 0, 1));
#pragma unroll
  for (int j = 0; j < ITEMS; j++) {
#pragma unroll
    for (int d = 0; d < K; d++) buf[d][at(j)] = Fld::add(base.c[d], buf[d][at(j)]);
  }
  __syncthreads();
  // chain element r·L + s is slot s of row r: mat[(s·D + d)·n + r]; each
  // slot's rows of the tile are stored as one contiguous run (tile-local
  // indices fit 32 bits: no 64-bit division per element)
  const int64_t r_lo = i0 / L;
  const int nr = (int)((i0 + lim - 1) / L - r_lo + 1), first = (int)(r_lo * L - i0);
  for (int idx = t; idx < nr * L; idx += CHAIN_THREADS) {
    const int s = idx / nr, rr = idx - s * nr;
    const int i = rr * L + s + first;
    if (i >= 0 && i < lim) {
#pragma unroll
      for (int d = 0; d < K; d++) mat[((int64_t)s * K + d) * n + r_lo + rr] = buf[d][pad<ITEMS>(i)];
    }
  }
}

constexpr int64_t MAX_BLOCKS = 0x7fffffff;

unsigned blocks_of(int64_t rows, int64_t tiles) { return (unsigned)(rows * tiles); }

bool too_many(int64_t rows, int64_t tiles) { return rows * tiles > MAX_BLOCKS; }

// BabyBear's extension (4 words) runs fewer items per thread
int64_t striped_tile(int field, int ext) { return ext && field == 1 ? Striped<4>::TILE : Striped<1>::TILE; }

}  // namespace

// Launch KERNEL<T...> for (field, ext): field 0 Goldilocks, 1 BabyBear;
// ext 0 base, 1 extension.
#define GLS_DISPATCH(KERNEL, GRID, THR, ...)                                                        \
  do {                                                                                              \
    if (field == 0 && ext) KERNEL<Goldilocks, Goldilocks::D><<<GRID, THR, 0, stream>>>(__VA_ARGS__); \
    if (field == 0 && !ext) KERNEL<Goldilocks, 1><<<GRID, THR, 0, stream>>>(__VA_ARGS__);            \
    if (field == 1 && ext) KERNEL<BabyBear, BabyBear::D><<<GRID, THR, 0, stream>>>(__VA_ARGS__);     \
    if (field == 1 && !ext) KERNEL<BabyBear, 1><<<GRID, THR, 0, stream>>>(__VA_ARGS__);              \
    return (int)cudaGetLastError();                                                                 \
  } while (0)

extern "C" {

// Every element of a (rows, n) batch inverted (zero -> zero); coordinate
// stride rows·n for an extension.
int gls_batch_inv(int field, int ext, const uint64_t* x, uint64_t* out, int64_t rows, int64_t n,
                  cudaStream_t stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (field != 0 && field != 1) return (int)cudaErrorInvalidValue;
  const int64_t t = (n + striped_tile(field, ext) - 1) / striped_tile(field, ext);
  if (too_many(rows, t)) return (int)cudaErrorInvalidValue;
  const int64_t cs = rows * n;
  GLS_DISPATCH(batch_inv_kernel, blocks_of(rows, t), THREADS, x, cs, out, cs, n, t, nullptr, nullptr, nullptr, 0);
}

// Sum of the inverses of each row of a (rows, n) batch into sums (rows
// values; coordinate stride rows).  done: rows counters, 0 (as every launch
// leaves them); partials: rows·tiles·K words (gls_tiles gives tiles).
int gls_inv_sum(int field, int ext, const uint64_t* x, uint64_t* sums, int64_t rows, int64_t n, uint64_t* done,
                uint64_t* partials, cudaStream_t stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (field != 0 && field != 1) return (int)cudaErrorInvalidValue;
  const int64_t t = (n + striped_tile(field, ext) - 1) / striped_tile(field, ext);
  if (too_many(rows, t)) return (int)cudaErrorInvalidValue;
  GLS_DISPATCH(batch_inv_kernel, blocks_of(rows, t), THREADS, x, rows * n, nullptr, 0, n, t, done, partials, sums,
               rows);
}

// Sum of each row of a (rows, n) batch of base values.  done: rows
// counters, 0; partials: rows·tiles words.
int gls_sum(int field, const uint64_t* x, uint64_t* out, int64_t rows, int64_t n, uint64_t* done, uint64_t* partials,
            cudaStream_t stream) {
  if (rows <= 0 || n <= 0) return 0;
  const int64_t t = (n + Striped<1>::TILE - 1) / Striped<1>::TILE;
  if (too_many(rows, t)) return (int)cudaErrorInvalidValue;
  const unsigned grid = blocks_of(rows, t);
  if (field == 0) sum_kernel<Goldilocks><<<grid, THREADS, 0, stream>>>(x, out, n, t, done, partials);
  else if (field == 1) sum_kernel<BabyBear><<<grid, THREADS, 0, stream>>>(x, out, n, t, done, partials);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Inclusive prefix sum of each row of a (rows, n) batch of base values, one
// pass.  scratch: 1 + 3·rows·tiles words; ticket_base: the tickets issued on
// it before; epoch > the last one used on it.
int gls_cumsum(int field, const uint64_t* x, uint64_t* out, int64_t rows, int64_t n, uint64_t* scratch,
               uint64_t ticket_base, uint64_t epoch, cudaStream_t stream) {
  if (rows <= 0 || n <= 0) return 0;
  const int64_t t = (n + SCAN_TILE - 1) / SCAN_TILE;
  if (too_many(rows, t)) return (int)cudaErrorInvalidValue;
  const Status st = status_of(scratch, rows * t, 1, ticket_base, epoch);
  const unsigned grid = blocks_of(rows, t);
  if (field == 0) cumsum_kernel<Goldilocks><<<grid, THREADS, 0, stream>>>(x, out, n, t, st);
  else if (field == 1) cumsum_kernel<BabyBear><<<grid, THREADS, 0, stream>>>(x, out, n, t, st);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The stage-2 chain of one circuit (stage2_chain_kernel): msgs (D+1, n·L),
// acc (D,), mat (L·D, n), total (D,).  scratch: 1 + (1 + 2·D)·tiles words.
int gls_stage2_chain(int field, const uint64_t* msgs, int64_t n, int L, const uint64_t* acc, uint64_t* mat,
                     uint64_t* total, uint64_t* scratch, uint64_t ticket_base, uint64_t epoch, cudaStream_t stream) {
  if (n <= 0 || L <= 0) return 0;
  const int64_t N = n * L;
  if (field == 0) {
    const int64_t t = (N + Chain<Goldilocks::D>::TILE - 1) / Chain<Goldilocks::D>::TILE;
    if (too_many(1, t)) return (int)cudaErrorInvalidValue;
    stage2_chain_kernel<Goldilocks><<<(unsigned)t, CHAIN_THREADS, 0, stream>>>(
        msgs, N, L, n, acc, mat, total, t, status_of(scratch, t, Goldilocks::D, ticket_base, epoch));
  } else if (field == 1) {
    const int64_t t = (N + Chain<BabyBear::D>::TILE - 1) / Chain<BabyBear::D>::TILE;
    if (too_many(1, t)) return (int)cudaErrorInvalidValue;
    stage2_chain_kernel<BabyBear><<<(unsigned)t, CHAIN_THREADS, 0, stream>>>(
        msgs, N, L, n, acc, mat, total, t, status_of(scratch, t, BabyBear::D, ticket_base, epoch));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Tiles per row of each entry (the wrappers size the scratch from them):
// kind 0 batch inverse and sum of inverses, 1 sum, 2 cumsum, 3 stage-2
// chain (n = the chain's length n·L).
int64_t gls_tiles(int field, int ext, int kind, int64_t n) {
  int64_t tile = 0;
  if (kind == 0) tile = striped_tile(field, ext);
  if (kind == 1) tile = Striped<1>::TILE;
  if (kind == 2) tile = SCAN_TILE;
  if (kind == 3) tile = field == 1 ? Chain<BabyBear::D>::TILE : Chain<Goldilocks::D>::TILE;
  return tile ? (n + tile - 1) / tile : -1;
}

}  // extern "C"
