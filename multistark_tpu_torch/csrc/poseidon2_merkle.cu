// K6 poseidon2_merkle: Poseidon2 (BabyBear, width 16) leaf hashing of
// field-matrix rows.
//
// Replaces multistark_tpu/hash/poseidon2.py Poseidon2Device.permute and
// Poseidon2FieldHasher.hash_matrices (with the Montgomery conversions around
// them) for the trees that are not LDE commits (the FRI rounds' and any
// MerkleMmcs.commit); the Merkle 2-to-1 runs in K14 / K15 (commit_tile.cu).
// The permutation is poseidon2.cuh's Montgomery form, the one body that K6,
// K14 and K15 share.
//
// Leaf (padding-free sponge, rate 8, width 16): the state starts at zero;
// the row's values (the columns of every matrix of one height, in matrix
// order) are absorbed 8 at a time by OVERWRITING the first lanes, a short
// last chunk leaving the other lanes as they were, with one permutation per
// chunk; the digest is lanes 0..7, 8 canonical u32 words.  Values go in
// through to_mont and the digest comes out through from_mont.
//
// Bound on the card: integer ALU.  One permutation is 772 modular products
// (x^7 on 141 lanes, the 13 internal diagonals) for at most 64 bytes read;
// BabyBear's FRI levels hash 2^19 rows of one chunk down to 4 rows, so the
// short levels are bound by one permutation's latency.  Design, two modes
// chosen on the host by the row count and the SM count
// (hash/poseidon2.py hash_rows_plan):
// - thread mode, where rows are many: a thread per row with the 16-lane
//   state in registers, the round constants read from constant memory
//   (every thread of a warp reads the same one at the same point, so each is
//   an operand of the instruction that uses it; filled once per device,
//   p2_load_constants), the grid one wave of resident blocks that strides
//   over the rows, so every SM holds the same share to the end (rows too
//   few to fill it spread over every SM in smaller blocks);
// - four-lane mode, where rows are few: a group of four lanes per row (8
//   rows a warp, poseidon2.cuh permute4): lane k holds state words
//   4k..4k+3, lanes 0 and 1 absorb the chunk's 8 values and write the
//   digest; a quarter of the instructions per lane lie on a permutation's
//   latency chain.  Its constants are staged in shared memory (the lanes of
//   a group read different ones).
// Loads are coalesced across rows (element (col, row) at col·n + row).
#include "poseidon2.cuh"

namespace {

namespace mont = p2::mont;
using p2::N_CONST;
using p2::RATE;
using p2::WIDTH;

constexpr int MAX_MATS = 16;
constexpr int THREADS = 128;   // a block of either mode (hash/poseidon2.py THREADS)
constexpr int MIN_BLOCKS = 8;  // thread mode: resident blocks per SM its register cap keeps (RESIDENT)
constexpr int LANES = 4;       // four-lane mode: lanes per row
constexpr int WARP = 32;
constexpr int MODE_THREAD = 0, MODE_LANES = 1;  // hash/poseidon2.py MODE_*
__constant__ uint32_t MONT_CONSTS[N_CONST];

// Up to MAX_MATS same-height matrices, passed by value: matrix m holds the
// row's values start[m] .. start[m + 1] - 1.
struct MatList {
  const uint64_t* ptr[MAX_MATS];
  int64_t start[MAX_MATS + 1];
  int count;
};

// Value `col` of row `row`, in Montgomery form.
__device__ __forceinline__ uint32_t value(const MatList& mats, int64_t col, int64_t row, int64_t n) {
  int m = 0;
  while (m + 1 < mats.count && col >= mats.start[m + 1]) m++;
  return mont::to_mont((uint32_t)mats.ptr[m][(col - mats.start[m]) * n + row]);
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    p2_hash_rows_kernel(const __grid_constant__ MatList mats, int64_t n, uint32_t* __restrict__ out) {
  const uint32_t* c = MONT_CONSTS;
  const int64_t width = mats.start[mats.count];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; row < n; row += stride) {
    uint32_t s[WIDTH];
#pragma unroll
    for (int i = 0; i < WIDTH; i++) s[i] = 0;
    for (int64_t c0 = 0; c0 < width; c0 += RATE) {  // a short last chunk keeps lanes width - c0 .. 15
#pragma unroll
      for (int i = 0; i < RATE; i++)
        if (c0 + i < width) s[i] = value(mats, c0 + i, row, n);
      mont::permute(s, c);
    }
    uint4* o = reinterpret_cast<uint4*>(out + row * 8);
    o[0] = make_uint4(mont::from_mont(s[0]), mont::from_mont(s[1]), mont::from_mont(s[2]), mont::from_mont(s[3]));
    o[1] = make_uint4(mont::from_mont(s[4]), mont::from_mont(s[5]), mont::from_mont(s[6]), mont::from_mont(s[7]));
  }
}

// Every lane of a warp runs the row loop equally often (the groups shuffle
// across the whole warp): the warp's rows start together, and a lane past
// the last row permutes zeros and writes nothing.
__global__ void __launch_bounds__(THREADS)
    p2_hash_rows4_kernel(const __grid_constant__ MatList mats, int64_t n, const int64_t* __restrict__ consts,
                         uint32_t* __restrict__ out) {
  __shared__ uint32_t sc[N_CONST];
  mont::stage_constants(sc, consts);
  __syncthreads();
  const int k = threadIdx.x % LANES;
  const int64_t width = mats.start[mats.count];
  const int64_t stride = (int64_t)gridDim.x * (blockDim.x / LANES);
  for (int64_t base = ((int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~(WARP - 1))) / LANES; base < n;
       base += stride) {
    const int64_t row = base + (threadIdx.x & (WARP - 1)) / LANES;
    const bool io = row < n && k < 2;  // lanes 0 and 1 hold the rate's state words, then the digest's
    uint32_t x[4] = {0, 0, 0, 0};
    for (int64_t c0 = 0; c0 < width; c0 += RATE) {
      if (io) {
#pragma unroll
        for (int i = 0; i < 4; i++)
          if (c0 + 4 * k + i < width) x[i] = value(mats, c0 + 4 * k + i, row, n);
      }
      mont::permute4(x, sc, k);
    }
    if (io)
      reinterpret_cast<uint4*>(out + row * 8)[k] =
          make_uint4(mont::from_mont(x[0]), mont::from_mont(x[1]), mont::from_mont(x[2]), mont::from_mont(x[3]));
  }
}

// A canonical 16-word state permuted n times in a row by one thread (thread
// mode, its constants as p2_hash_rows_kernel reads them) or one group of
// four lanes (four-lane mode): one permutation's latency per step.
template <int L>
__global__ void p2_chain_kernel(uint32_t* io, int n, const int64_t* __restrict__ consts) {
  if constexpr (L == 1) {
    const uint32_t* c = MONT_CONSTS;
    if (threadIdx.x != 0) return;
    uint32_t s[WIDTH];
#pragma unroll
    for (int i = 0; i < WIDTH; i++) s[i] = mont::to_mont(io[i]);
    for (int i = 0; i < n; i++) mont::permute(s, c);
#pragma unroll
    for (int i = 0; i < WIDTH; i++) io[i] = mont::from_mont(s[i]);
  } else {
    __shared__ uint32_t sc[N_CONST];
    mont::stage_constants(sc, consts);
    __syncthreads();
    const int k = threadIdx.x % LANES;
    uint32_t x[4];
#pragma unroll
    for (int i = 0; i < 4; i++) x[i] = mont::to_mont(io[4 * k + i]);
    for (int i = 0; i < n; i++) mont::permute4(x, sc, k);
    if (threadIdx.x < LANES)
#pragma unroll
      for (int i = 0; i < 4; i++) io[4 * k + i] = mont::from_mont(x[i]);
  }
}

}  // namespace

// Row digests of the concatenation of `count` same-height (w_j, n) matrices
// of canonical BabyBear values: out is (n, 8) u32.  mode: MODE_THREAD or
// MODE_LANES, over `blocks` blocks of `threads` (whole warps, at most
// THREADS; hash/poseidon2.py hash_rows_plan); consts: the N_CONST round
// constants as int64 on the device (the four-lane mode stages them).
extern "C" int p2_hash_rows(const uint64_t* const* ptrs, const int64_t* widths, int count, int64_t n, int mode,
                            int64_t blocks, int threads, const int64_t* consts, uint32_t* out, cudaStream_t stream) {
  if (count <= 0 || count > MAX_MATS || n <= 0 || blocks <= 0 || blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (threads < WARP || threads > THREADS || threads % WARP) return (int)cudaErrorInvalidValue;
  MatList mats;
  mats.start[0] = 0;
  for (int j = 0; j < MAX_MATS; j++) {
    mats.ptr[j] = j < count ? ptrs[j] : nullptr;
    mats.start[j + 1] = mats.start[j] + (j < count ? widths[j] : 0);
  }
  mats.count = count;
  if (mode == MODE_THREAD)
    p2_hash_rows_kernel<<<(unsigned)blocks, threads, 0, stream>>>(mats, n, out);
  else if (mode == MODE_LANES)
    p2_hash_rows4_kernel<<<(unsigned)blocks, threads, 0, stream>>>(mats, n, consts, out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Thread mode's constants: the N_CONST round constants in Montgomery form
// (u32 on the device) into constant memory, queued on `stream` ahead of the
// launches that read them (no wait); once per device before its first
// p2_hash_rows.
extern "C" int p2_load_constants(const uint32_t* mont_consts, cudaStream_t stream) {
  return (int)cudaMemcpyToSymbolAsync(MONT_CONSTS, mont_consts, sizeof(MONT_CONSTS), 0, cudaMemcpyDeviceToDevice,
                                      stream);
}

// io ((16,) u32, canonical) permuted n times in a row, in place, by one
// thread (lanes 1) or one group of four lanes (lanes 4): `permute_chain` in
// hash/poseidon2.py, a latency measurement.
extern "C" int p2_chain(int lanes, uint32_t* io, int n, const int64_t* consts, cudaStream_t stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (lanes == 1)
    p2_chain_kernel<1><<<1, WARP, 0, stream>>>(io, n, consts);
  else if (lanes == LANES)
    p2_chain_kernel<LANES><<<1, WARP, 0, stream>>>(io, n, consts);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
