// K2 ntt_stage: a pass of r consecutive radix-2 butterfly stages (r = 1..6)
// of a DIF or a DIT over a (rows, n) batch of Goldilocks or BabyBear
// polynomials, in place.
//
// Replaces multistark_tpu/ntt/ntt.py _dif_stage1 / _dif_stage3 (DIF: natural
// input -> bit-reversed output) and _dit_stage / _dit_stage3 (DIT: the
// inverse-ordered counterpart), which the JAX package runs over GL_OPS and
// BB_OPS alike.  The TPU fused three stages as radix-8 to cut HBM passes;
// here one launch runs up to six.  One templated body serves both fields
// through their traits (field.cuh).
//
// Bound on the card: memory.  A stage reads and writes the whole batch once
// (16 bytes per butterfly each way: elements are int64 for both fields) for
// one field mul and two add/subs, so a transform of log n stages run one
// stage per launch costs log n full passes over HBM.  Design: stages
// s_lo .. s_lo + r - 1 touch, in one polynomial, the 2^r elements that differ
// only in bits s_lo - 1 .. s_lo + r - 2 of their position.  One thread loads
// such a group into registers (2^r elements at stride 2^(s_lo - 1)), runs
// the r stages there and stores it back: one HBM pass for r stages, no
// shared memory and no barrier.  Neighbouring threads take neighbouring
// positions below the group's bits, so each of a warp's loads and stores is
// one coalesced 256-byte segment once s_lo >= 6; the stages below that run
// in K14's tile (commit_tile.cu).  Twiddles come from the stages' tables
// concatenated, read through the read-only cache.
//
// Stage geometry (same as the JAX package's): stage s has blocks of 2^s
// elements; the butterfly pairs element i of the block's low half with
// element i of its high half, using twiddle tw_s[i] of the stage's table
// [w_s^0 .. w_s^(2^(s-1) - 1)].
//   DIF (stages top down):  (a, b) -> (a + b, (a - b) * tw[i])
//   DIT (stages bottom up): (a, b) -> (a + b * tw[i], a - b * tw[i])
#include "field.cuh"

namespace {

constexpr int PASS_THREADS = 256;
constexpr int MAX_PASS = 6;

// Thread t holds the group (row, high, low): its element u < 2^R sits at
// row * n + (high << (L + R)) + (u << L) + low, with L = s_lo - 1.  Stage
// s_lo - 1 + l (local level l = 1..R) pairs u and u + 2^(l-1) and takes
// twiddle ((u mod 2^(l-1)) << L) + low of its table, which starts at
// tw + 2^(s_lo - 1 + l - 1) - 2^L (tw points at stage s_lo's table).
template <class F, int R, bool DIF>
__global__ void __launch_bounds__(PASS_THREADS) ntt_pass_kernel(uint64_t* __restrict__ x, int64_t total, int log_n,
                                                                int L, const uint64_t* __restrict__ tw) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int row_log = log_n - R;
  const int64_t row = t >> row_log;
  const int64_t rem = t & (((int64_t)1 << row_log) - 1);
  const int64_t low = rem & (((int64_t)1 << L) - 1);
  uint64_t* p = x + (row << log_n) + ((rem >> L) << (L + R)) + low;
  constexpr int G = 1 << R;
  uint64_t v[G];
#pragma unroll
  for (int u = 0; u < G; u++) v[u] = p[(int64_t)u << L];
#pragma unroll
  for (int step = 0; step < R; step++) {
    const int l = DIF ? R - step : step + 1;
    const int h = 1 << (l - 1);
    const uint64_t* tws = tw + (((int64_t)1 << (L + l - 1)) - ((int64_t)1 << L)) + low;
#pragma unroll
    for (int u = 0; u < G; u++) {
      if (u & h) continue;
      const uint64_t w = __ldg(tws + ((int64_t)(u & (h - 1)) << L));
      const uint64_t a = v[u], b = v[u + h];
      if (DIF) {
        v[u] = F::add(a, b);
        v[u + h] = F::mul(F::sub(a, b), w);
      } else {
        const uint64_t m = F::mul(b, w);
        v[u] = F::add(a, m);
        v[u + h] = F::sub(a, m);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < G; u++) p[(int64_t)u << L] = v[u];
}

template <class F, int R>
void launch_pass(uint64_t* x, int64_t rows, int log_n, int s_lo, const uint64_t* tw, int dif, cudaStream_t stream) {
  const int64_t total = rows << (log_n - R);
  const unsigned blocks = (unsigned)((total + PASS_THREADS - 1) / PASS_THREADS);
  if (dif)
    ntt_pass_kernel<F, R, true><<<blocks, PASS_THREADS, 0, stream>>>(x, total, log_n, s_lo - 1, tw);
  else
    ntt_pass_kernel<F, R, false><<<blocks, PASS_THREADS, 0, stream>>>(x, total, log_n, s_lo - 1, tw);
}

template <class F>
void launch_field(uint64_t* x, int64_t rows, int log_n, int s_lo, int r, const uint64_t* tw, int dif,
                  cudaStream_t stream) {
  switch (r) {
    case 1: launch_pass<F, 1>(x, rows, log_n, s_lo, tw, dif, stream); break;
    case 2: launch_pass<F, 2>(x, rows, log_n, s_lo, tw, dif, stream); break;
    case 3: launch_pass<F, 3>(x, rows, log_n, s_lo, tw, dif, stream); break;
    case 4: launch_pass<F, 4>(x, rows, log_n, s_lo, tw, dif, stream); break;
    case 5: launch_pass<F, 5>(x, rows, log_n, s_lo, tw, dif, stream); break;
    default: launch_pass<F, 6>(x, rows, log_n, s_lo, tw, dif, stream); break;
  }
}

}  // namespace

// field: 0 Goldilocks, 1 BabyBear.  x: (rows, 2^log_n) contiguous.  Runs
// stages s_lo .. s_lo + r - 1 (DIF: top down; DIT: bottom up); tw points at
// stage s_lo's table, and stage t's table follows at tw + 2^(t-1) -
// 2^(s_lo-1) (the tables concatenated, as NttEngine.tail_table lays them
// out; for r = 1 any one stage's table).
extern "C" int ntt_pass(int field, uint64_t* x, int64_t rows, int log_n, int s_lo, int r, const uint64_t* tw, int dif,
                        cudaStream_t stream) {
  if (rows <= 0) return 0;
  if ((field != 0 && field != 1) || r < 1 || r > MAX_PASS || s_lo < 1 || s_lo + r - 1 > log_n || log_n >= 40)
    return (int)cudaErrorInvalidValue;
  if (field == 0)
    launch_field<Goldilocks>(x, rows, log_n, s_lo, r, tw, dif, stream);
  else
    launch_field<BabyBear>(x, rows, log_n, s_lo, r, tw, dif, stream);
  return (int)cudaGetLastError();
}
