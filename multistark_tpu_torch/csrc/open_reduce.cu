// K12 bary_eval and K13 reduced_open: the two reductions of the PCS opening
// over a stored (bit-reversed) LDE, over Goldilocks / GL2 or BabyBear / BB4.
//
// K12 replaces multistark_tpu/pcs.py:1256 _eval_kernel (called from :590):
// the claimed evaluations of one matrix at each of its points by the
// barycentric formula on the size-n same-shift sub-coset, a stored prefix,
//   p(z) = (z^n - s^n)/(n·s^n) · Σ_i e_i·w_i,   w_i = x_i/(z - x_i),
// per column.  The weights come in the prefix's storage order, so the sum
// reads the stored prefix as it lies.  Two launches: bary_partial sums a
// tile of rows per block (block reduction), bary_finish adds the tiles, raises
// z to the n-th power by squaring and applies the scale.
//
// K13 replaces multistark_tpu/pcs.py:1284 _ro_kernel (called from :605): one
// matrix's contribution to the reduced opening of its LDE height, for all of
// its points,
//   ro[x] += Σ_p (-α^{off_p})·(u(x) - S_p)·inv_diff_p[x],
//   u(x) = Σ_j α^j·mat[j, x],  S_p = Σ_j α^j·v_{p,j},
// accumulated in place (the matrices of one height run in stream order).
// Each block computes S_p and -α^{off_p} once, in shared memory.
//
// Bound on the card: memory for both.  K12 reads the (w, n) prefix and P·D
// weight rows once; K13 reads the (w, N) LDE, P·D inverse rows and the
// accumulator once and writes it once, with w base-by-extension products
// per element.  Design: one thread per row (K13) or ITEMS rows (K12);
// neighbouring threads read neighbouring addresses of each row.
#include "field.cuh"

namespace {

constexpr int MAX_POINTS = 4;
constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int64_t TILE = (int64_t)THREADS * ITEMS;

struct PointPtrs {
  const uint64_t* p[MAX_POINTS];
};

struct PointOffs {
  int64_t o[MAX_POINTS];
};

template <class F>
__device__ __forceinline__ uint64_t warp_sum(uint64_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = F::add(v, __shfl_down_sync(0xFFFFFFFFu, v, off));
  return v;
}

// grid (tiles, w): block (tile, c) sums rows [tile·TILE, (tile+1)·TILE) of
// column c against every point's weights; partials (P, D, w, tiles).
template <class F>
__global__ void __launch_bounds__(THREADS)
    bary_partial_kernel(const uint64_t* __restrict__ mat, int64_t row_stride, int64_t w, int64_t n, PointPtrs wts,
                        int P, uint64_t* __restrict__ partials) {
  constexpr int D = F::D;
  __shared__ uint64_t warp_part[THREADS / 32][MAX_POINTS * D];
  const int64_t tile = blockIdx.x, tiles = gridDim.x, c = blockIdx.y;
  uint64_t acc[MAX_POINTS][D];
#pragma unroll
  for (int p = 0; p < MAX_POINTS; p++)
#pragma unroll
    for (int d = 0; d < D; d++) acc[p][d] = 0;
  for (int j = 0; j < ITEMS; j++) {
    const int64_t t = tile * TILE + (int64_t)j * THREADS + threadIdx.x;
    if (t >= n) break;
    const uint64_t v = mat[c * row_stride + t];
#pragma unroll
    for (int p = 0; p < MAX_POINTS; p++) {
      if (p >= P) break;
#pragma unroll
      for (int d = 0; d < D; d++) acc[p][d] = F::add(acc[p][d], F::mul(v, wts.p[p][d * n + t]));
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int p = 0; p < MAX_POINTS; p++) {
#pragma unroll
    for (int d = 0; d < D; d++) {
      const uint64_t s = warp_sum<F>(acc[p][d]);
      if (lane == 0) warp_part[warp][p * D + d] = s;
    }
  }
  __syncthreads();
  if (threadIdx.x < P * D) {
    uint64_t s = 0;
    for (int k = 0; k < THREADS / 32; k++) s = F::add(s, warp_part[k][threadIdx.x]);
    const int p = threadIdx.x / D, d = threadIdx.x % D;
    partials[((p * D + d) * w + c) * tiles + tile] = s;
  }
}

// One thread per (point, column): the sum over tiles times the point's scale
// (z^n - s^n)·inv_ns; out (P, D, w).
template <class F>
__global__ void bary_finish_kernel(const uint64_t* __restrict__ partials, int64_t tiles, int P, int64_t w,
                                   PointPtrs zs, int log_n, uint64_t s_n, uint64_t inv_ns, uint64_t* __restrict__ out) {
  constexpr int D = F::D;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P * w) return;
  const int p = (int)(i / w);
  const int64_t c = i % w;
  Ext<F> acc;
#pragma unroll
  for (int d = 0; d < D; d++) {
    uint64_t s = 0;
    for (int64_t k = 0; k < tiles; k++) s = F::add(s, partials[((p * D + d) * w + c) * tiles + k]);
    acc.c[d] = s;
  }
  Ext<F> zn;
#pragma unroll
  for (int d = 0; d < D; d++) zn.c[d] = zs.p[p][d];
  for (int k = 0; k < log_n; k++) zn = ext_mul<F>(zn, zn);
  zn.c[0] = F::sub(zn.c[0], s_n);
  const Ext<F> r = ext_mul<F>(acc, ext_scale<F>(zn, inv_ns));
#pragma unroll
  for (int d = 0; d < D; d++) out[(p * D + d) * w + c] = r.c[d];
}

template <class F>
__global__ void __launch_bounds__(THREADS)
    reduced_open_kernel(const uint64_t* __restrict__ mat, int64_t w, int64_t N, const uint64_t* __restrict__ apows,
                        int64_t count, PointPtrs vals, PointPtrs invs, PointOffs offs, int P, int init,
                        uint64_t* __restrict__ ro) {
  constexpr int D = F::D;
  __shared__ Ext<F> s_p[MAX_POINTS], neg_aoff[MAX_POINTS];
  if (threadIdx.x < P) {
    const int p = threadIdx.x;
    Ext<F> s;
#pragma unroll
    for (int d = 0; d < D; d++) s.c[d] = 0;
    for (int64_t j = 0; j < w; j++) {
      Ext<F> a, v;
#pragma unroll
      for (int d = 0; d < D; d++) {
        a.c[d] = apows[d * count + j];
        v.c[d] = vals.p[p][d * w + j];
      }
      s = ext_add<F>(s, ext_mul<F>(a, v));
    }
    s_p[p] = s;
#pragma unroll
    for (int d = 0; d < D; d++) neg_aoff[p].c[d] = F::neg(apows[d * count + offs.o[p]]);
  }
  __syncthreads();
  for (int64_t x = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; x < N; x += (int64_t)gridDim.x * blockDim.x) {
    Ext<F> u;
#pragma unroll
    for (int d = 0; d < D; d++) u.c[d] = 0;
    for (int64_t j = 0; j < w; j++) {
      const uint64_t m = mat[j * N + x];
#pragma unroll
      for (int d = 0; d < D; d++) u.c[d] = F::add(u.c[d], F::mul(apows[d * count + j], m));
    }
    Ext<F> acc;
#pragma unroll
    for (int d = 0; d < D; d++) acc.c[d] = init ? 0 : ro[d * N + x];
    for (int p = 0; p < P; p++) {
      Ext<F> inv;
#pragma unroll
      for (int d = 0; d < D; d++) inv.c[d] = invs.p[p][d * N + x];
      acc = ext_add<F>(acc, ext_mul<F>(ext_mul<F>(ext_sub<F>(u, s_p[p]), inv), neg_aoff[p]));
    }
#pragma unroll
    for (int d = 0; d < D; d++) ro[d * N + x] = acc.c[d];
  }
}

PointPtrs point_ptrs(const uint64_t* const* ptrs, int P) {
  PointPtrs r;
  for (int p = 0; p < MAX_POINTS; p++) r.p[p] = p < P ? ptrs[p] : nullptr;
  return r;
}

bool bad(int field, int P) { return (field != 0 && field != 1) || P < 1 || P > MAX_POINTS; }

}  // namespace

// mat: a stored LDE, column c at mat + c·row_stride; wts: P host pointers to
// (D, n) weights in the prefix's storage order; partials: (P, D, w, tiles)
// with tiles = ceil(n / TILE).
extern "C" int bary_partial(int field, const uint64_t* mat, int64_t row_stride, int64_t w, int64_t n,
                            const uint64_t* const* wts, int P, uint64_t* partials, int64_t tiles,
                            cudaStream_t stream) {
  if (bad(field, P) || n <= 0 || w <= 0 || w > 65535 || tiles != (n + TILE - 1) / TILE) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)w);
  if (field == 0)
    bary_partial_kernel<Goldilocks><<<grid, THREADS, 0, stream>>>(mat, row_stride, w, n, point_ptrs(wts, P), P, partials);
  else
    bary_partial_kernel<BabyBear><<<grid, THREADS, 0, stream>>>(mat, row_stride, w, n, point_ptrs(wts, P), P, partials);
  return (int)cudaGetLastError();
}

// zs: P host pointers to (D,) points; out (P, D, w).
extern "C" int bary_finish(int field, const uint64_t* partials, int64_t tiles, int P, int64_t w,
                           const uint64_t* const* zs, int log_n, uint64_t s_n, uint64_t inv_ns, uint64_t* out,
                           cudaStream_t stream) {
  if (bad(field, P) || tiles <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const unsigned blocks = (unsigned)((P * w + threads - 1) / threads);
  if (field == 0)
    bary_finish_kernel<Goldilocks><<<blocks, threads, 0, stream>>>(partials, tiles, P, w, point_ptrs(zs, P), log_n,
                                                                  s_n, inv_ns, out);
  else
    bary_finish_kernel<BabyBear><<<blocks, threads, 0, stream>>>(partials, tiles, P, w, point_ptrs(zs, P), log_n,
                                                                s_n, inv_ns, out);
  return (int)cudaGetLastError();
}

// mat: (w, N) stored LDE; apows: (D, count) α powers; vals: P host pointers
// to (D, w) claimed values; invs: P host pointers to (D, N) inverses
// 1/(z_p - x); offs: P host offsets into apows; ro: (D, N), overwritten if
// init, else added to.
extern "C" int reduced_open(int field, const uint64_t* mat, int64_t w, int64_t N, const uint64_t* apows,
                            int64_t count, const uint64_t* const* vals, const uint64_t* const* invs,
                            const int64_t* offs, int P, int init, uint64_t* ro, cudaStream_t stream) {
  if (bad(field, P) || N <= 0 || w <= 0 || w > count) return (int)cudaErrorInvalidValue;
  PointOffs o;
  for (int p = 0; p < MAX_POINTS; p++) {
    o.o[p] = p < P ? offs[p] : 0;
    if (o.o[p] < 0 || o.o[p] >= count) return (int)cudaErrorInvalidValue;
  }
  int64_t blocks = (N + THREADS - 1) / THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (field == 0)
    reduced_open_kernel<Goldilocks><<<(unsigned)blocks, THREADS, 0, stream>>>(
        mat, w, N, apows, count, point_ptrs(vals, P), point_ptrs(invs, P), o, P, init, ro);
  else
    reduced_open_kernel<BabyBear><<<(unsigned)blocks, THREADS, 0, stream>>>(
        mat, w, N, apows, count, point_ptrs(vals, P), point_ptrs(invs, P), o, P, init, ro);
  return (int)cudaGetLastError();
}
