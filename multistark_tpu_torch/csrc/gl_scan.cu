// K4 gl_scan: mod-p scans and reductions along the last axis of a
// (rows, n) batch of Goldilocks / GL2 or BabyBear / BB4 values.
//
// Replaces multistark_tpu/utils.py _batch_inv_impl (Montgomery-trick batch
// inverse: prefix and suffix product scans plus one inversion, zero -> zero),
// cumsum (inclusive mod-p prefix sum: the logUp accumulator chain) and
// field_sum (mod-p sum), which the JAX package runs over GL_OPS/GL2_OPS and
// BB_OPS/BB4_OPS alike.  One templated body serves both fields and both
// extension degrees through the field traits (field.cuh).
//
// Bound on the card: memory, and for short rows launch count.  Design: a
// block scans or reduces a tile of TILE = THREADS * ITEMS elements (each
// thread runs ITEMS elements in sequence, then the block combines thread
// totals in shared memory); tile totals go to a (rows, tiles) array that the
// wrapper scans or reduces with the same kernels, and an add-back pass folds
// each tile's exclusive prefix into it.  That split is sound because add and
// mul are associative (and commutative, so the add-back may multiply on
// either side).  Elements are read ITEMS apart across a warp, which is not
// coalesced: a transposed tile load through shared memory is the first
// optimisation to make.
//
// Extension values are coordinate-major: coordinate d of an element sits
// d * cs words after coordinate 0.
#include "field.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int64_t TILE = (int64_t)THREADS * ITEMS;

template <class Fld>
struct Base {
  uint64_t v;
  static __device__ __forceinline__ Base load(const uint64_t* p, int64_t i, int64_t) { return {p[i]}; }
  __device__ __forceinline__ void store(uint64_t* p, int64_t i, int64_t) const { p[i] = v; }
  static __device__ __forceinline__ Base zero() { return {0}; }
  static __device__ __forceinline__ Base one() { return {1}; }
  __device__ __forceinline__ bool is_zero() const { return v == 0; }
  static __device__ __forceinline__ Base add(Base a, Base b) { return {Fld::add(a.v, b.v)}; }
  static __device__ __forceinline__ Base mul(Base a, Base b) { return {Fld::mul(a.v, b.v)}; }
  static __device__ __forceinline__ Base inv(Base a) { return {finv<Fld>(a.v)}; }
};

template <class Fld>
struct ExtV {
  Ext<Fld> v;
  static __device__ __forceinline__ ExtV load(const uint64_t* p, int64_t i, int64_t cs) {
    ExtV r;
#pragma unroll
    for (int d = 0; d < Fld::D; d++) r.v.c[d] = p[d * cs + i];
    return r;
  }
  __device__ __forceinline__ void store(uint64_t* p, int64_t i, int64_t cs) const {
#pragma unroll
    for (int d = 0; d < Fld::D; d++) p[d * cs + i] = v.c[d];
  }
  static __device__ __forceinline__ ExtV zero() {
    ExtV r;
#pragma unroll
    for (int d = 0; d < Fld::D; d++) r.v.c[d] = 0;
    return r;
  }
  static __device__ __forceinline__ ExtV one() {
    ExtV r = zero();
    r.v.c[0] = 1;
    return r;
  }
  __device__ __forceinline__ bool is_zero() const { return ext_is_zero<Fld>(v); }
  static __device__ __forceinline__ ExtV add(ExtV a, ExtV b) { return {ext_add<Fld>(a.v, b.v)}; }
  static __device__ __forceinline__ ExtV mul(ExtV a, ExtV b) { return {ext_mul<Fld>(a.v, b.v)}; }
  static __device__ __forceinline__ ExtV inv(ExtV a) { return {ext_inv<Fld>(a.v)}; }
};

enum Combine : int { ADD = 0, MUL = 1, MUL_NONZERO = 2 };  // MUL_NONZERO reads 0 as 1

template <class F>
__device__ __forceinline__ F combine(int c, F a, F b) {
  return c == ADD ? F::add(a, b) : F::mul(a, b);
}

template <class F>
__device__ __forceinline__ F identity(int c) {
  return c == ADD ? F::zero() : F::one();
}

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }

// Logical position k of a row of n elements -> storage offset (reverse scans
// run from the end).
__device__ __forceinline__ int64_t pos(int64_t k, int64_t n, int reverse) { return reverse ? n - 1 - k : k; }

// Inclusive scan of each tile; the tile's total goes to tot[row * tiles + tile].
template <class F>
__global__ void scan_tile_kernel(const uint64_t* __restrict__ in, int64_t cs_in, uint64_t* __restrict__ out,
                                 int64_t cs_out, uint64_t* __restrict__ tot, int64_t cs_tot, int64_t n,
                                 int c, int reverse) {
  __shared__ F partial[THREADS];
  const int64_t row = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
  const int64_t base = row * n;
  const int64_t k0 = tile * TILE + (int64_t)threadIdx.x * ITEMS;
  const int cop = c == MUL_NONZERO ? MUL : c;
  F vals[ITEMS];
  F run = identity<F>(cop);
#pragma unroll
  for (int j = 0; j < ITEMS; j++) {
    const int64_t k = k0 + j;
    F x = identity<F>(cop);
    if (k < n) {
      x = F::load(in, base + pos(k, n, reverse), cs_in);
      if (c == MUL_NONZERO && x.is_zero()) x = F::one();
    }
    run = combine<F>(cop, run, x);
    vals[j] = run;
  }
  partial[threadIdx.x] = run;
  __syncthreads();
  // Hillis-Steele over the thread totals
  for (unsigned off = 1; off < THREADS; off <<= 1) {
    F other = identity<F>(cop);
    if (threadIdx.x >= off) other = partial[threadIdx.x - off];
    __syncthreads();
    if (threadIdx.x >= off) partial[threadIdx.x] = combine<F>(cop, other, partial[threadIdx.x]);
    __syncthreads();
  }
  const F before = threadIdx.x == 0 ? identity<F>(cop) : partial[threadIdx.x - 1];
#pragma unroll
  for (int j = 0; j < ITEMS; j++) {
    const int64_t k = k0 + j;
    if (k < n) combine<F>(cop, before, vals[j]).store(out, base + pos(k, n, reverse), cs_out);
  }
  if (threadIdx.x == THREADS - 1) partial[THREADS - 1].store(tot, row * tiles + tile, cs_tot);
}

// Fold the inclusive scan of the tile totals into every tile but the first.
template <class F>
__global__ void scan_addback_kernel(uint64_t* __restrict__ out, int64_t cs_out, const uint64_t* __restrict__ tot,
                                    int64_t cs_tot, int64_t n, int c, int reverse) {
  const int64_t row = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
  if (tile == 0) return;
  const int cop = c == MUL_NONZERO ? MUL : c;
  const F before = F::load(tot, row * tiles + tile - 1, cs_tot);
  for (int64_t k = tile * TILE + threadIdx.x; k < imin(n, (tile + 1) * TILE); k += THREADS) {
    const int64_t i = row * n + pos(k, n, reverse);
    combine<F>(cop, before, F::load(out, i, cs_out)).store(out, i, cs_out);
  }
}

// Sum of each tile into tot[row * tiles + tile].
template <class F>
__global__ void sum_tile_kernel(const uint64_t* __restrict__ in, int64_t cs_in, uint64_t* __restrict__ tot,
                                int64_t cs_tot, int64_t n) {
  __shared__ F partial[THREADS];
  const int64_t row = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
  F run = F::zero();
  for (int64_t k = tile * TILE + threadIdx.x; k < imin(n, (tile + 1) * TILE); k += THREADS)
    run = F::add(run, F::load(in, row * n + k, cs_in));
  partial[threadIdx.x] = run;
  __syncthreads();
  for (unsigned off = THREADS / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) partial[threadIdx.x] = F::add(partial[threadIdx.x], partial[threadIdx.x + off]);
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[0].store(tot, row * tiles + tile, cs_tot);
}

// Batch inverse from the inclusive prefix (pre) and suffix (suf) products of
// the zero-masked input: x_i^-1 = pre_{i-1} * suf_{i+1} * (pre_{n-1})^-1,
// and 0 for x_i = 0.  tinv holds (pre_{n-1})^-1 per row.
template <class F>
__global__ void binv_finish_kernel(const uint64_t* __restrict__ x, int64_t cs_x, const uint64_t* __restrict__ pre,
                                   const uint64_t* __restrict__ suf, int64_t cs_ps, const uint64_t* __restrict__ tinv,
                                   int64_t cs_t, uint64_t* __restrict__ out, int64_t cs_out, int64_t rows, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < rows * n; i += stride) {
    const int64_t row = i / n, k = i - row * n;
    F r = F::zero();
    if (!F::load(x, i, cs_x).is_zero()) {
      r = F::load(tinv, row, cs_t);
      if (k > 0) r = F::mul(r, F::load(pre, i - 1, cs_ps));
      if (k + 1 < n) r = F::mul(r, F::load(suf, i + 1, cs_ps));
    }
    r.store(out, i, cs_out);
  }
}

template <class F>
__global__ void row_inv_kernel(const uint64_t* __restrict__ pre, int64_t cs_ps, uint64_t* __restrict__ tinv,
                               int64_t cs_t, int64_t rows, int64_t n) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row < rows) F::inv(F::load(pre, row * n + n - 1, cs_ps)).store(tinv, row, cs_t);
}

dim3 tile_grid(int64_t rows, int64_t n) { return dim3((unsigned)((n + TILE - 1) / TILE), (unsigned)rows); }

unsigned flat_blocks(int64_t count) {
  int64_t blocks = (count + THREADS - 1) / THREADS;
  return (unsigned)(blocks > (1 << 20) ? (1 << 20) : blocks);
}

}  // namespace

// Launch KERNEL<T> with T the element type of (field, ext): field 0
// Goldilocks, 1 BabyBear; ext 0 base, 1 extension.
#define GLS_DISPATCH(KERNEL, GRID, ...)                                                   \
  do {                                                                                    \
    if (field != 0 && field != 1) return (int)cudaErrorInvalidValue;                     \
    if (field == 0 && ext) KERNEL<ExtV<Goldilocks>><<<GRID, THREADS, 0, stream>>>(__VA_ARGS__); \
    if (field == 0 && !ext) KERNEL<Base<Goldilocks>><<<GRID, THREADS, 0, stream>>>(__VA_ARGS__); \
    if (field == 1 && ext) KERNEL<ExtV<BabyBear>><<<GRID, THREADS, 0, stream>>>(__VA_ARGS__);    \
    if (field == 1 && !ext) KERNEL<Base<BabyBear>><<<GRID, THREADS, 0, stream>>>(__VA_ARGS__);   \
    return (int)cudaGetLastError();                                                       \
  } while (0)

extern "C" {

// Tile-local inclusive scan with combine c (0 add, 1 mul, 2 mul reading 0
// as 1); writes tot as a (rows, ceil(n / TILE)) array.
int gls_scan_tile(int field, int ext, const uint64_t* in, int64_t cs_in, uint64_t* out, int64_t cs_out,
                  uint64_t* tot, int64_t cs_tot, int64_t rows, int64_t n, int c, int reverse, cudaStream_t stream) {
  if (rows <= 0 || n <= 0) return 0;
  GLS_DISPATCH(scan_tile_kernel, tile_grid(rows, n), in, cs_in, out, cs_out, tot, cs_tot, n, c, reverse);
}

int gls_scan_addback(int field, int ext, uint64_t* out, int64_t cs_out, const uint64_t* tot, int64_t cs_tot,
                     int64_t rows, int64_t n, int c, int reverse, cudaStream_t stream) {
  if (rows <= 0 || n <= TILE) return 0;
  GLS_DISPATCH(scan_addback_kernel, tile_grid(rows, n), out, cs_out, tot, cs_tot, n, c, reverse);
}

int gls_sum_tile(int field, int ext, const uint64_t* in, int64_t cs_in, uint64_t* tot, int64_t cs_tot,
                 int64_t rows, int64_t n, cudaStream_t stream) {
  if (rows <= 0 || n <= 0) return 0;
  GLS_DISPATCH(sum_tile_kernel, tile_grid(rows, n), in, cs_in, tot, cs_tot, n);
}

int gls_row_inv(int field, int ext, const uint64_t* pre, int64_t cs_ps, uint64_t* tinv, int64_t cs_t,
                int64_t rows, int64_t n, cudaStream_t stream) {
  if (rows <= 0 || n <= 0) return 0;
  GLS_DISPATCH(row_inv_kernel, flat_blocks(rows), pre, cs_ps, tinv, cs_t, rows, n);
}

int gls_binv_finish(int field, int ext, const uint64_t* x, int64_t cs_x, const uint64_t* pre, const uint64_t* suf,
                    int64_t cs_ps, const uint64_t* tinv, int64_t cs_t, uint64_t* out, int64_t cs_out, int64_t rows,
                    int64_t n, cudaStream_t stream) {
  if (rows <= 0 || n <= 0) return 0;
  GLS_DISPATCH(binv_finish_kernel, flat_blocks(rows * n), x, cs_x, pre, suf, cs_ps, tinv, cs_t, out, cs_out, rows, n);
}

}  // extern "C"
