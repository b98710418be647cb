// K2 ntt_stage: one radix-2 butterfly stage over a (rows, n) batch of
// Goldilocks or BabyBear polynomials, in place.
//
// Replaces multistark_tpu/ntt/ntt.py _dif_stage1 / _dif_stage3 (DIF: natural
// input -> bit-reversed output) and _dit_stage / _dit_stage3 (DIT: the
// inverse-ordered counterpart), which the JAX package runs over GL_OPS and
// BB_OPS alike.  The TPU fused three stages as radix-8 to cut HBM passes;
// this first kernel keeps one launch per stage.  One templated body serves
// both fields through their traits (field.cuh).
//
// Bound on the card: memory.  Each stage reads and writes the whole batch
// once (16 bytes per butterfly each way: elements are int64 for both fields)
// for one field mul and two add/subs, so a transform of log n stages costs
// log n full passes over HBM.  Design: one thread per butterfly; for the
// large stages neighbouring threads touch neighbouring addresses on both
// halves.  Fusing stages through shared memory (the radix-8 idea, done on
// chip) is the obvious next step.
//
// Stage geometry (same as the JAX package's): blocks of 2*half elements; the
// butterfly pairs element i of the block's low half with element i of its
// high half, using twiddle tw[i] of that stage's table [w_m^0 .. w_m^(half-1)].
//   DIF: (a, b) -> (a + b, (a - b) * tw[i])
//   DIT: (a, b) -> (a + b * tw[i], a - b * tw[i])
#include "field.cuh"

namespace {

template <class F>
__global__ void ntt_stage_kernel(uint64_t* __restrict__ x, int64_t total, int log_n, int log_half,
                                 const uint64_t* __restrict__ tw, int dif) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t half = (int64_t)1 << log_half;
  const int64_t per_row = (int64_t)1 << (log_n - 1);
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total; t += stride) {
    const int64_t row = t >> (log_n - 1);
    const int64_t j = t & (per_row - 1);
    const int64_t blk = j >> log_half;
    const int64_t i = j & (half - 1);
    uint64_t* pa = x + (row << log_n) + (blk << (log_half + 1)) + i;
    uint64_t* pb = pa + half;
    const uint64_t a = *pa, b = *pb, w = tw[i];
    if (dif) {
      *pa = F::add(a, b);
      *pb = F::mul(F::sub(a, b), w);
    } else {
      const uint64_t m = F::mul(b, w);
      *pa = F::add(a, m);
      *pb = F::sub(a, m);
    }
  }
}

}  // namespace

// field: 0 Goldilocks, 1 BabyBear.  x: (rows, 2^log_n) contiguous; tw: the
// stage's table of 2^log_half entries.
extern "C" int ntt_stage(int field, uint64_t* x, int64_t rows, int log_n, int log_half, const uint64_t* tw,
                         int dif, cudaStream_t stream) {
  if (log_n <= 0 || rows <= 0) return 0;
  if (field != 0 && field != 1) return (int)cudaErrorInvalidValue;
  const int64_t total = rows << (log_n - 1);
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  if (field == 0)
    ntt_stage_kernel<Goldilocks><<<(unsigned)blocks, threads, 0, stream>>>(x, total, log_n, log_half, tw, dif);
  else
    ntt_stage_kernel<BabyBear><<<(unsigned)blocks, threads, 0, stream>>>(x, total, log_n, log_half, tw, dif);
  return (int)cudaGetLastError();
}
