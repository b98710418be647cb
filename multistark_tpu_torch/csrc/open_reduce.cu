// K12 bary_eval and K13 reduced_open: the two reductions of the PCS opening
// over a stored (bit-reversed) LDE, over Goldilocks / GL2 or BabyBear / BB4.
//
// K12 replaces multistark_tpu/pcs.py:1256 _eval_kernel, merged per prove by
// :590 _eval_all_kern: the claimed evaluations of every matrix of one trace
// height n at each of its points by the barycentric formula on the size-n
// same-shift sub-coset, a stored prefix,
//   p(z) = (z^n - s^n)/(n·s^n) · Σ_i e_i·x_i/(z - x_i),
// per column.  One launch per height (bary_height) for all of its matrices
// and points.  A block owns a tile of rows: it makes the tile's weights
// x_i·inv_p[i] (inv_p = 1/(z_p - x), in the prefix's storage order) once per
// row and point into shared memory, then its warps walk every column of every
// matrix, lanes over the tile's rows (neighbouring lanes, neighbouring
// addresses), summing e·w for each of the matrix's points unreduced (delayed
// reduction, as ro_rows), one reduction per (column, point, coordinate), then
// a warp sum, whose low and high halves atomics add into the launch's sums.
// The last block to arrive (a counter it resets) forms each value from its
// two sums, applies its point's scale (z^n - s^n)·inv_ns and sets the sums
// back to 0.  Each matrix element and each weight word is read once.
//
// K13 replaces multistark_tpu/pcs.py:1284 _ro_kernel, merged per prove by
// :605 _ro_all_kern: the reduced opening of one LDE height over all of its
// matrices and points,
//   ro[x] = Σ_m Σ_{p of m} (-α^{off_{m,p}})·(u_m(x) - S_{m,p})·inv_p[x],
//   u_m(x) = Σ_j α^j·mat_m[j, x],  S_{m,p} = Σ_j α^j·v_{m,p,j},
// in two launches.  ro_scalars (one block) computes the scalars once: per
// (matrix, point) pair -α^{off} and, per point, C_p = Σ α^{off}·S over its
// pairs.  ro_rows regroups the sum, exact mod p, as
//   ro[x] = Σ_p inv_p[x]·(C_p + Σ_{m of p} (-α^{off_{m,p}})·u_m(x)),
// so a row costs Σ_m w_m·D base-by-extension products (delayed reduction:
// unreduced 128-bit Goldilocks or 62-bit BabyBear products summed, one
// reduction per coordinate), one extension product per pair and one per
// point; it reads each matrix once and each point's inverse row once and
// writes ro once (no read-modify-write unless asked to add).
//
// Bound on the card: K12 reads the height's prefixes (Σ w_m·n elements),
// P·D inverse rows and x once, with Σ_{pairs} w·D products per row: two to
// four Goldilocks 64-bit products per element on 32-bit integer units,
// which take longer than its bytes (about 3x the byte bound on the bench's
// 2^18 height).  K13 reads the matrices' Σw_m·N elements, P·D inverse rows
// and writes D rows, with about w·D products per row, near the memory
// time; it runs a thread per two rows (16-byte loads of each column,
// coalesced) where the layout allows, else one.
#include "field.cuh"

namespace {

constexpr int MAX_POINTS = 4;
constexpr int THREADS = 256;

struct PointPtrs {
  const uint64_t* p[MAX_POINTS];
};

template <class F>
__device__ __forceinline__ uint64_t warp_sum(uint64_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = F::add(v, __shfl_down_sync(0xFFFFFFFFu, v, off));
  return v;
}

// -- K13 ---------------------------------------------------------------------------

constexpr int MAX_MATS = 16;   // matrices per ro_rows launch
constexpr int MAX_PAIRS = 32;  // (matrix, point) pairs per launch

// A sum of unreduced products a·b of canonical values, reduced once: for
// Goldilocks a 128-bit sum and a carry word (2^128 = -2^32 mod p), for
// BabyBear a 64-bit sum of 62-bit products and a carry word (2^64 mod p).
template <class F>
struct Dot;

template <>
struct Dot<Goldilocks> {
  uint64_t lo = 0, hi = 0;
  uint32_t top = 0;
  __device__ __forceinline__ void mac(uint64_t a, uint64_t b) {
    const uint64_t pl = a * b, ph = __umul64hi(a, b);
#if defined(__CUDA_ARCH__)
    asm("add.cc.u64 %0, %0, %3;\n\taddc.cc.u64 %1, %1, %4;\n\taddc.u32 %2, %2, 0;"
        : "+l"(lo), "+l"(hi), "+r"(top)
        : "l"(pl), "l"(ph));
#else
    lo += pl;
    const uint64_t c = lo < pl, h = hi + ph;
    top += (h < ph) + (h + c < h);
    hi = h + c;
#endif
  }
  __device__ __forceinline__ uint64_t reduce() const {
    return gl::sub(gl::reduce128(lo, hi), (uint64_t)top << 32);
  }
};

template <>
struct Dot<BabyBear> {
  static constexpr uint64_t R64 = 0x45dddde3ull;  // 2^64 mod p
  uint64_t lo = 0;
  uint32_t top = 0;
  __device__ __forceinline__ void mac(uint64_t a, uint64_t b) {
    const uint64_t pr = (uint64_t)(uint32_t)a * (uint32_t)b;
#if defined(__CUDA_ARCH__)
    asm("add.cc.u64 %0, %0, %2;\n\taddc.u32 %1, %1, 0;" : "+l"(lo), "+r"(top) : "l"(pr));
#else
    lo += pr;
    top += lo < pr;
#endif
  }
  __device__ __forceinline__ uint64_t reduce() const { return bb::reduce(bb::reduce(lo) + top * R64); }
};

// A's Dot accumulators += a·b for extension values, unreduced: coordinate
// k gets Σ_{i+j=k} a_i·b_j + Σ_{i+j=k+D} (W·a_i)·b_j, with aw = W·a.
template <class F>
__device__ __forceinline__ void ext_mac(Dot<F> acc[F::D], const Ext<F>& a, const Ext<F>& aw, const Ext<F>& b) {
#pragma unroll
  for (int k = 0; k < F::D; k++)
#pragma unroll
    for (int i = 0; i < F::D; i++) acc[k].mac(i <= k ? a.c[i] : aw.c[i], b.c[i <= k ? k - i : k + F::D - i]);
}

template <class F>
__device__ __forceinline__ Ext<F> ext_times_w(const Ext<F>& a) {
  Ext<F> r;
#pragma unroll
  for (int d = 0; d < F::D; d++) r.c[d] = d ? F::mul(a.c[d], F::W) : a.c[d];  // coordinate 0 never wraps
  return r;
}

// One height's matrices (column j of matrix m at ptr[m] + j·stride[m]) and
// their (matrix, point) pairs, in matrix order and, within a matrix, by
// offset: matrix m's pairs end at pair_end[m], pair q opens point
// pair_point[q] at α offset off[q] with claimed values vals[q] ((D, width)).
struct RoMats {
  const uint64_t* ptr[MAX_MATS];
  int64_t stride[MAX_MATS];
  int width[MAX_MATS];
  int pair_end[MAX_MATS];
  int pair_point[MAX_PAIRS];
  int mats;
};

struct RoPairs {
  const uint64_t* vals[MAX_PAIRS];
  int64_t off[MAX_PAIRS];
};

template <class F>
__device__ __forceinline__ Ext<F> apow(const uint64_t* apows, int64_t count, int64_t j) {
  Ext<F> a;
#pragma unroll
  for (int d = 0; d < F::D; d++) a.c[d] = apows[d * count + j];
  return a;
}

// The table ro_rows reads, for cols = Σ widths columns, Q pairs, P points:
// [cols·D: column j of matrix m weighted by its first pair, -α^{off_q1}·α^j]
// [Q·2D: pair q's ratio to its matrix's first pair, α^{off_q - off_q1}, and
// that ratio times W] [P·D: C_p = Σ_{q at p} α^{off_q}·S_q].
__host__ __device__ __forceinline__ int64_t ratio_at(int64_t cols, int D) { return cols * D; }
__host__ __device__ __forceinline__ int64_t consts_at(int64_t cols, int Q, int D) { return (cols + 2 * (int64_t)Q) * D; }

// One block.  A warp per pair sums S_q over its columns (lanes strided,
// then a shuffle tree); a thread per column makes the weights.
template <class F>
__global__ void __launch_bounds__(THREADS) ro_scalars_kernel(RoMats mt, RoPairs pr, int Q, int P,
                                                             const uint64_t* __restrict__ apows, int64_t count,
                                                             uint64_t* __restrict__ table) {
  constexpr int D = F::D;
  __shared__ Ext<F> cs[MAX_PAIRS];
  __shared__ int64_t first_off[MAX_MATS], col_at[MAX_MATS + 1];
  __shared__ int mat_of[MAX_PAIRS];
  if (threadIdx.x == 0) {
    col_at[0] = 0;
    for (int m = 0, q = 0; m < mt.mats; m++) {
      first_off[m] = pr.off[q];
      col_at[m + 1] = col_at[m] + mt.width[m];
      for (; q < mt.pair_end[m]; q++) mat_of[q] = m;
    }
  }
  __syncthreads();
  const int64_t cols = col_at[mt.mats];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int q = warp; q < Q; q += THREADS / 32) {
    const int w = mt.width[mat_of[q]];
    Ext<F> s;
#pragma unroll
    for (int d = 0; d < D; d++) s.c[d] = 0;
    for (int j = lane; j < w; j += 32) {
      Ext<F> v;
#pragma unroll
      for (int d = 0; d < D; d++) v.c[d] = pr.vals[q][d * w + j];
      s = ext_add<F>(s, ext_mul<F>(apow<F>(apows, count, j), v));
    }
#pragma unroll
    for (int d = 0; d < D; d++) s.c[d] = warp_sum<F>(s.c[d]);
    if (lane == 0) {
      cs[q] = ext_mul<F>(apow<F>(apows, count, pr.off[q]), s);
      const Ext<F> r = apow<F>(apows, count, pr.off[q] - first_off[mat_of[q]]), rw = ext_times_w<F>(r);
#pragma unroll
      for (int d = 0; d < D; d++) {
        table[ratio_at(cols, D) + (2 * q) * D + d] = r.c[d];
        table[ratio_at(cols, D) + (2 * q + 1) * D + d] = rw.c[d];
      }
    }
  }
  for (int64_t c = threadIdx.x; c < cols; c += THREADS) {
    int m = 0;
    while (col_at[m + 1] <= c) m++;
    Ext<F> neg = apow<F>(apows, count, first_off[m]);
#pragma unroll
    for (int d = 0; d < D; d++) neg.c[d] = F::neg(neg.c[d]);
    const Ext<F> wt = ext_mul<F>(neg, apow<F>(apows, count, c - col_at[m]));
#pragma unroll
    for (int d = 0; d < D; d++) table[c * D + d] = wt.c[d];
  }
  __syncthreads();
  if ((int)threadIdx.x < P) {
    Ext<F> c;
#pragma unroll
    for (int d = 0; d < D; d++) c.c[d] = 0;
    for (int q = 0; q < Q; q++)
      if (mt.pair_point[q] == (int)threadIdx.x) c = ext_add<F>(c, cs[q]);
#pragma unroll
    for (int d = 0; d < D; d++) table[consts_at(cols, Q, D) + threadIdx.x * D + d] = c.c[d];
  }
}

// R rows x0 .. x0 + R - 1 of one value row, from p (16 bytes when R = 2).
template <int R>
__device__ __forceinline__ void load_rows(const uint64_t* p, uint64_t v[R]) {
  if constexpr (R == 2) {
    const ulonglong2 t = __ldg(reinterpret_cast<const ulonglong2*>(p));
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <class F>
__device__ __forceinline__ Ext<F> load_ext(const uint64_t* p) {
  Ext<F> a;
#pragma unroll
  for (int d = 0; d < F::D; d++) a.c[d] = p[d];
  return a;
}

// A thread per R rows.  Per matrix, v = Σ_j weight_j·mat[j] (= -α^{off_q1}·u_m)
// by delayed reduction; its first pair's point gets v, every other pair's
// point its ratio times v (an unreduced extension product); then Σ_p
// A_p·inv_p, unreduced, into ro (written, or added to it when `add`).
template <class F, int P, int R>
__global__ void __launch_bounds__(THREADS) ro_rows_kernel(RoMats mt, PointPtrs invs, int64_t N,
                                                          const uint64_t* __restrict__ table, int Q, int add,
                                                          uint64_t* ro) {
  constexpr int D = F::D;
  __shared__ uint64_t tab[(2 * MAX_PAIRS + MAX_POINTS) * D];
  int64_t cols = 0;
  for (int m = 0; m < mt.mats; m++) cols += mt.width[m];
  for (int i = threadIdx.x; i < (2 * Q + P) * D; i += blockDim.x) tab[i] = table[ratio_at(cols, D) + i];
  __syncthreads();
  const int64_t x0 = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * R;
  if (x0 >= N) return;
  Ext<F> acc[P][R];
#pragma unroll
  for (int p = 0; p < P; p++)
#pragma unroll
    for (int r = 0; r < R; r++) acc[p][r] = load_ext<F>(tab + (2 * Q + p) * D);
  const uint64_t* wt = table;
  int q = 0;
  for (int m = 0; m < mt.mats; m++) {
    Dot<F> u[D][R];
    const uint64_t* col = mt.ptr[m] + x0;
    const int64_t stride = mt.stride[m];
#pragma unroll 4
    for (int j = 0; j < mt.width[m]; j++) {
      uint64_t v[R];
      load_rows<R>(col + j * stride, v);
#pragma unroll
      for (int d = 0; d < D; d++) {
        const uint64_t a = __ldg(wt + j * D + d);
#pragma unroll
        for (int r = 0; r < R; r++) u[d][r].mac(a, v[r]);
      }
    }
    wt += mt.width[m] * D;
    Ext<F> v[R];
#pragma unroll
    for (int r = 0; r < R; r++)
#pragma unroll
      for (int d = 0; d < D; d++) v[r].c[d] = u[d][r].reduce();
    for (const int q1 = q; q < mt.pair_end[m]; q++) {
      const int pt = mt.pair_point[q];
#pragma unroll
      for (int r = 0; r < R; r++) {
        Ext<F> t = v[r];
        if (q != q1) {
          Dot<F> s[D];
          ext_mac<F>(s, load_ext<F>(tab + 2 * q * D), load_ext<F>(tab + (2 * q + 1) * D), v[r]);
#pragma unroll
          for (int d = 0; d < D; d++) t.c[d] = s[d].reduce();
        }
#pragma unroll
        for (int p = 0; p < P; p++)
          if (p == pt) acc[p][r] = ext_add<F>(acc[p][r], t);
      }
    }
  }
  Dot<F> out[R][D];
#pragma unroll
  for (int p = 0; p < P; p++) {
    uint64_t iv[D][R];
#pragma unroll
    for (int d = 0; d < D; d++) load_rows<R>(invs.p[p] + d * N + x0, iv[d]);
#pragma unroll
    for (int r = 0; r < R; r++) {
      Ext<F> inv;
#pragma unroll
      for (int d = 0; d < D; d++) inv.c[d] = iv[d][r];
      ext_mac<F>(out[r], acc[p][r], ext_times_w<F>(acc[p][r]), inv);
    }
  }
#pragma unroll
  for (int d = 0; d < D; d++) {
    uint64_t o[R];
    if (add) load_rows<R>(ro + d * N + x0, o);
#pragma unroll
    for (int r = 0; r < R; r++) o[r] = add ? F::add(o[r], out[r][d].reduce()) : out[r][d].reduce();
    if constexpr (R == 2)
      *reinterpret_cast<ulonglong2*>(ro + d * N + x0) = make_ulonglong2(o[0], o[1]);
    else
      ro[d * N + x0] = o[0];
  }
}

template <class F, int P>
int launch_ro_rows(const RoMats& mt, const PointPtrs& invs, int64_t N, const uint64_t* table, int Q, int add,
                   uint64_t* ro, bool vec, cudaStream_t stream) {
  const int R = vec ? 2 : 1;
  const unsigned blocks = (unsigned)((N / R + THREADS - 1) / THREADS);
  if (vec)
    ro_rows_kernel<F, P, 2><<<blocks, THREADS, 0, stream>>>(mt, invs, N, table, Q, add, ro);
  else
    ro_rows_kernel<F, P, 1><<<blocks, THREADS, 0, stream>>>(mt, invs, N, table, Q, add, ro);
  return (int)cudaGetLastError();
}

template <class F>
int launch_ro_rows_p(int P, const RoMats& mt, const PointPtrs& invs, int64_t N, const uint64_t* table, int Q, int add,
                     uint64_t* ro, bool vec, cudaStream_t stream) {
  switch (P) {
    case 1: return launch_ro_rows<F, 1>(mt, invs, N, table, Q, add, ro, vec, stream);
    case 2: return launch_ro_rows<F, 2>(mt, invs, N, table, Q, add, ro, vec, stream);
    case 3: return launch_ro_rows<F, 3>(mt, invs, N, table, Q, add, ro, vec, stream);
    default: return launch_ro_rows<F, 4>(mt, invs, N, table, Q, add, ro, vec, stream);
  }
}

// -- K12 ---------------------------------------------------------------------------

constexpr int BARY_WARPS = THREADS / 32;
constexpr int BARY_WEIGHTS = 4096;  // weight words of a tile in shared memory (32 KB): P·D·2^log_tile
constexpr int BARY_UNROLL = 16;     // loads in flight per lane (a lane has up to 64 rows of a column in a tile)

// One launch per trace height; grid: the height's tiles of 2^log_tile rows
// (as many rows as the weights' shared memory holds, fewer on a height too
// short to give every SM a tile).
// mt: the height's matrices (column j of matrix m at ptr[m] + j·stride[m],
// the prefix's first n entries read) and their (matrix, point) pairs, each
// matrix's in a run; invs `points` (D, n) 1/(z_p - x); xs (n,) the coset
// points; zs `points` (D,) points; out: per pair its (D, w) values, pairs in
// order.  words: [0] the arrival counter, then per output word its tiles'
// sums split into low and high 32-bit halves, each summed into a u64 by
// atomics (exact: below 2^56 for up to 2^24 tiles), all 0 on entry and set
// back to 0 by the last block.  P is the most points a matrix of the height has.
template <class F, int P>
__global__ void __launch_bounds__(THREADS, 2)
    bary_height_kernel(RoMats mt, int Q, int points, PointPtrs invs, const uint64_t* __restrict__ xs, PointPtrs zs,
                       int64_t n, int log_tile, int log_n, uint64_t s_n, uint64_t inv_ns,
                       unsigned long long* __restrict__ words, uint64_t* __restrict__ out) {
  constexpr int D = F::D;
  __shared__ uint64_t wts[BARY_WEIGHTS];
  __shared__ int64_t col_at[MAX_MATS + 1], pair_col[MAX_PAIRS + 1];
  __shared__ int mat_of[MAX_PAIRS];
  __shared__ Ext<F> scale[MAX_POINTS];
  __shared__ int last;
  const int64_t R = (int64_t)1 << log_tile, t0 = (int64_t)blockIdx.x << log_tile, tiles = gridDim.x;
  const int64_t rows = n - t0 < R ? n - t0 : R;
  unsigned long long* sums = words + 1;
  if (threadIdx.x == 0) {
    col_at[0] = pair_col[0] = 0;
    for (int m = 0, q = 0; m < mt.mats; m++) {
      col_at[m + 1] = col_at[m] + mt.width[m];
      for (; q < mt.pair_end[m]; q++) {
        mat_of[q] = m;
        pair_col[q + 1] = pair_col[q] + mt.width[m];
      }
    }
  }
  // the tile's weights x·inv_p, one product per row, point and coordinate
  for (int64_t r = threadIdx.x; r < rows; r += THREADS) {
    const uint64_t x = __ldg(xs + t0 + r);
    for (int p = 0; p < points; p++)
#pragma unroll
      for (int d = 0; d < D; d++) wts[(p * D + d) * R + r] = F::mul(__ldg(invs.p[p] + d * n + t0 + r), x);
  }
  __syncthreads();
  // a warp per column: lanes over the tile's rows, BARY_UNROLL of a lane's
  // rows loaded before their products (two blocks an SM: at most 128
  // registers; 8, 16 or 32 loads ahead, and loads one batch ahead, timed
  // within 2% of each other on the bench's heights)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int m = 0;
  for (int64_t c = warp; c < col_at[mt.mats]; c += BARY_WARPS) {
    while (col_at[m + 1] <= c) m++;
    const int64_t j = c - col_at[m];
    const int q0 = m ? mt.pair_end[m - 1] : 0, np = mt.pair_end[m] - q0;
    int pt[P];
#pragma unroll
    for (int k = 0; k < P; k++) pt[k] = k < np ? mt.pair_point[q0 + k] : 0;
    const unsigned long long* col = reinterpret_cast<const unsigned long long*>(mt.ptr[m] + j * mt.stride[m] + t0);
    Dot<F> acc[P][D];
    for (int64_t base = lane; base < rows; base += 32 * BARY_UNROLL) {
      uint64_t e[BARY_UNROLL];
#pragma unroll
      for (int u = 0; u < BARY_UNROLL; u++) e[u] = base + 32 * u < rows ? __ldcs(col + base + 32 * u) : 0;
#pragma unroll
      for (int u = 0; u < BARY_UNROLL; u++) {
        if (base + 32 * u >= rows) break;
#pragma unroll
        for (int k = 0; k < P; k++)
          if (k < np)
#pragma unroll
            for (int d = 0; d < D; d++) acc[k][d].mac(e[u], wts[(pt[k] * D + d) * R + base + 32 * u]);
      }
    }
#pragma unroll
    for (int k = 0; k < P; k++) {
      if (k >= np) break;
#pragma unroll
      for (int d = 0; d < D; d++) {
        const uint64_t v = warp_sum<F>(acc[k][d].reduce());
        if (lane == 0) {
          unsigned long long* s = sums + 2 * (pair_col[q0 + k] * D + d * mt.width[m] + j);
          atomicAdd(s, v & 0xFFFFFFFFull);
          atomicAdd(s + 1, v >> 32);
        }
      }
    }
  }
  __threadfence();  // this block's sums, before its arrival
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(words, 1ull) == (unsigned long long)tiles - 1;
    if (last) words[0] = 0;  // every tile has arrived
  }
  __syncthreads();
  if (!last) return;
  __threadfence();  // every tile's sums, before they are read
  if ((int)threadIdx.x < points) {
    Ext<F> zn;
#pragma unroll
    for (int d = 0; d < D; d++) zn.c[d] = zs.p[threadIdx.x][d];
    for (int k = 0; k < log_n; k++) zn = ext_mul<F>(zn, zn);
    zn.c[0] = F::sub(zn.c[0], s_n);
    scale[threadIdx.x] = ext_scale<F>(zn, inv_ns);
  }
  __syncthreads();
  // a thread per (pair, column): its D coordinates from the halves' sums,
  // times the point's scale; the sums set back to 0
  constexpr uint64_t TWO32 = (1ull << 32) % F::P;
  for (int64_t o = threadIdx.x; o < pair_col[Q]; o += THREADS) {
    int q = 0;
    while (pair_col[q + 1] <= o) q++;
    const int64_t w = mt.width[mat_of[q]], at = pair_col[q] * D + (o - pair_col[q]);
    Ext<F> v;
#pragma unroll
    for (int d = 0; d < D; d++) {
      unsigned long long* s = sums + 2 * (at + d * w);
      v.c[d] = F::add(__ldcg(s) % F::P, F::mul(__ldcg(s + 1) % F::P, TWO32));
      s[0] = s[1] = 0;
    }
    const Ext<F> r = ext_mul<F>(v, scale[mt.pair_point[q]]);
#pragma unroll
    for (int d = 0; d < D; d++) out[at + d * w] = r.c[d];
  }
}

template <class F>
int launch_bary_height(int P, const RoMats& mt, int Q, int points, const PointPtrs& invs, const uint64_t* xs,
                       const PointPtrs& zs, int64_t n, int log_tile, int log_n, uint64_t s_n, uint64_t inv_ns,
                       unsigned long long* words, uint64_t* out, cudaStream_t stream) {
  const unsigned tiles = (unsigned)((n + ((int64_t)1 << log_tile) - 1) >> log_tile);
#define BARY_LAUNCH(K)                                                                                          \
  bary_height_kernel<F, K><<<tiles, THREADS, 0, stream>>>(mt, Q, points, invs, xs, zs, n, log_tile, log_n, s_n, \
                                                          inv_ns, words, out)
  switch (P) {
    case 1: BARY_LAUNCH(1); break;
    case 2: BARY_LAUNCH(2); break;
    case 3: BARY_LAUNCH(3); break;
    default: BARY_LAUNCH(4); break;
  }
#undef BARY_LAUNCH
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

PointPtrs point_ptrs(const uint64_t* const* ptrs, int P) {
  PointPtrs r;
  for (int p = 0; p < MAX_POINTS; p++) r.p[p] = p < P ? ptrs[p] : nullptr;
  return r;
}

bool bad(int field, int P) { return (field != 0 && field != 1) || P < 1 || P > MAX_POINTS; }

}  // namespace

// Checks one height's matrices (widths, pair_end: M of them) and their Q
// (matrix, point) pairs (pair_point) and fills mt, pointers left null.
int fill_mats(RoMats& mt, const int* widths, const int* pair_end, int M, const int* pair_point, int Q, int P) {
  if (M < 1 || M > MAX_MATS || Q < 1 || Q > MAX_PAIRS || pair_end[M - 1] != Q) return (int)cudaErrorInvalidValue;
  for (int m = 0, q = 0; m < MAX_MATS; m++) {
    mt.ptr[m] = nullptr;
    mt.stride[m] = 0;
    mt.width[m] = m < M ? widths[m] : 0;
    mt.pair_end[m] = m < M ? pair_end[m] : Q;
    if (m >= M) continue;
    if (widths[m] < 1 || pair_end[m] <= q) return (int)cudaErrorInvalidValue;
    q = pair_end[m];
  }
  for (int q = 0; q < MAX_PAIRS; q++) {
    mt.pair_point[q] = q < Q ? pair_point[q] : -1;
    if (q < Q && (pair_point[q] < 0 || pair_point[q] >= P)) return (int)cudaErrorInvalidValue;
  }
  mt.mats = M;
  return 0;
}

// fill_mats for K13, whose pairs also carry α offsets (offs: each matrix's
// by offset, below count, widths at most count).
int ro_mats(RoMats& mt, const int* widths, const int* pair_end, int M, const int* pair_point, const int64_t* offs,
            int Q, int P, int64_t count) {
  const int rc = fill_mats(mt, widths, pair_end, M, pair_point, Q, P);
  if (rc != 0) return rc;
  for (int m = 0, q = 0; m < M; m++) {
    if (widths[m] > count) return (int)cudaErrorInvalidValue;
    for (const int q1 = q; q < pair_end[m]; q++)
      if (offs[q] < 0 || offs[q] >= count || offs[q] < offs[q1]) return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// K12 for one trace height n = 2^log_n: M matrices (mats, strides, widths:
// column j of matrix m at mats[m] + j·strides[m], its first n entries the
// stored prefix) and their Q (matrix, point) pairs, each matrix's in a run
// (pair_end, points: indices into the height's P points), invs P host
// pointers to (D, n) 1/(z_p - x), xs (n,) the coset points in the prefix's
// storage order, zs P host pointers to (D,) points, the scale s^n and
// inv_ns = 1/(n·s^n); tiles of 2^log_tile rows (P·D·2^log_tile <= 4096,
// 2^log_tile >= 32), at most 2^24 of them; words: 1 + 2·Σ_pairs D·w
// counter words, 0 on entry and on return; out: per pair its (D, w)
// values, pairs in order.  One launch.
extern "C" int bary_height(int field, const uint64_t* const* mats, const int64_t* strides, const int* widths,
                           const int* pair_end, int M, const int* points, int Q, const uint64_t* const* invs,
                           const uint64_t* xs, const uint64_t* const* zs, int P, int64_t n, int log_tile, int log_n,
                           uint64_t s_n, uint64_t inv_ns, unsigned long long* words, uint64_t* out,
                           cudaStream_t stream) {
  const int D = field == 0 ? Goldilocks::D : BabyBear::D;
  if (bad(field, P) || n <= 0 || n != (int64_t)1 << log_n || log_tile < 5 ||
      ((int64_t)P * D << log_tile) > BARY_WEIGHTS || log_n - log_tile > 24)
    return (int)cudaErrorInvalidValue;
  RoMats mt;
  const int rc = fill_mats(mt, widths, pair_end, M, points, Q, P);
  if (rc != 0) return rc;
  int most = 1;  // the most points one matrix has
  for (int m = 0, q = 0; m < M; q = pair_end[m++]) {
    most = pair_end[m] - q > most ? pair_end[m] - q : most;
    if (strides[m] < n) return (int)cudaErrorInvalidValue;
    mt.ptr[m] = mats[m];
    mt.stride[m] = strides[m];
  }
  if (most > MAX_POINTS) return (int)cudaErrorInvalidValue;
  const PointPtrs ip = point_ptrs(invs, P), zp = point_ptrs(zs, P);
  if (field == 0)
    return launch_bary_height<Goldilocks>(most, mt, Q, P, ip, xs, zp, n, log_tile, log_n, s_n, inv_ns, words, out,
                                          stream);
  return launch_bary_height<BabyBear>(most, mt, Q, P, ip, xs, zp, n, log_tile, log_n, s_n, inv_ns, words, out,
                                      stream);
}

// K13's scalars for one height: M matrices (widths, pair_end) and their Q
// (matrix, point) pairs in matrix order, each matrix's by offset (points,
// offs, vals: Q host pointers to (D, width) claimed values); apows (D,
// count) α powers; table: (Σ widths + 2Q + P)·D words, as ro_rows reads it.
// One block.
extern "C" int ro_scalars(int field, const int* widths, const int* pair_end, int M, const int* points,
                          const int64_t* offs, const uint64_t* const* vals, int Q, int P, const uint64_t* apows,
                          int64_t count, uint64_t* table, cudaStream_t stream) {
  if (bad(field, P)) return (int)cudaErrorInvalidValue;
  RoMats mt;
  const int rc = ro_mats(mt, widths, pair_end, M, points, offs, Q, P, count);
  if (rc != 0) return rc;
  RoPairs pr;
  for (int q = 0; q < MAX_PAIRS; q++) {
    pr.vals[q] = q < Q ? vals[q] : nullptr;
    pr.off[q] = q < Q ? offs[q] : 0;
  }
  if (field == 0)
    ro_scalars_kernel<Goldilocks><<<1, THREADS, 0, stream>>>(mt, pr, Q, P, apows, count, table);
  else
    ro_scalars_kernel<BabyBear><<<1, THREADS, 0, stream>>>(mt, pr, Q, P, apows, count, table);
  return (int)cudaGetLastError();
}

// K13's rows for one height: the matrices and pairs as ro_scalars took them,
// with mats and strides (column j of matrix m at mats[m] + j·strides[m], N
// rows); invs P host pointers to (D, N) 1/(z_p - x); table ro_scalars'; ro
// (D, N) written, or added to when add.
extern "C" int ro_rows(int field, const uint64_t* const* mats, const int64_t* strides, const int* widths,
                       const int* pair_end, int M, const int* points, const int64_t* offs, int Q, int64_t count,
                       const uint64_t* const* invs, int P, int64_t N, const uint64_t* table, int add, uint64_t* ro,
                       cudaStream_t stream) {
  if (bad(field, P) || N <= 0) return (int)cudaErrorInvalidValue;
  RoMats mt;
  const int rc = ro_mats(mt, widths, pair_end, M, points, offs, Q, P, count);
  if (rc != 0) return rc;
  bool vec = N % 2 == 0 && aligned16(ro);
  for (int m = 0; m < M; m++) {
    if (strides[m] < N) return (int)cudaErrorInvalidValue;
    mt.ptr[m] = mats[m];
    mt.stride[m] = strides[m];
    vec = vec && aligned16(mats[m]) && strides[m] % 2 == 0;
  }
  for (int p = 0; p < P; p++) vec = vec && aligned16(invs[p]);
  const PointPtrs ip = point_ptrs(invs, P);
  if (field == 0) return launch_ro_rows_p<Goldilocks>(P, mt, ip, N, table, Q, add, ro, vec, stream);
  return launch_ro_rows_p<BabyBear>(P, mt, ip, N, table, Q, add, ro, vec, stream);
}
