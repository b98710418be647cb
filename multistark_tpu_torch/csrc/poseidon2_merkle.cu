// K6 poseidon2_merkle: Poseidon2 (BabyBear, width 16) leaf hashing of
// field-matrix rows.
//
// Replaces multistark_tpu/hash/poseidon2.py Poseidon2Device.permute and
// Poseidon2FieldHasher.hash_matrices (with the Montgomery conversions around
// them) for the trees that are not LDE commits (the FRI rounds' and any
// MerkleMmcs.commit); the Merkle 2-to-1 runs in K14 / K15 (commit_tile.cu).
// The permutation is poseidon2.cuh's, which K14 and K15 share.
//
// Leaf (padding-free sponge, rate 8, width 16): the state starts at zero;
// the row's values (the columns of every matrix of one height, in matrix
// order) are absorbed 8 at a time by OVERWRITING the first lanes, a short
// last chunk leaving the other lanes as they were, with one permutation per
// chunk; the digest is lanes 0..7, 8 canonical u32 words.
//
// Bound on the card: integer ALU.  One permutation is ~570 modular
// multiplications (x^7 on 141 lanes, the 13 internal diagonals) for at most
// 64 bytes read.  Design: one thread per row with the 16-lane state in
// registers; the 157 round constants (canonical, from the caller) are
// staged in shared memory per block.
#include "poseidon2.cuh"

namespace {

using p2::N_CONST;
using p2::RATE;
using p2::WIDTH;
using p2::permute;
using p2::stage_constants;

constexpr int MAX_MATS = 16;

struct MatList {
  const uint64_t* ptr[MAX_MATS];
  int64_t width[MAX_MATS];
  int count;
};

__global__ void p2_hash_rows_kernel(MatList mats, int64_t n, const int64_t* __restrict__ consts,
                                 uint32_t* __restrict__ out) {
  __shared__ uint32_t sc[N_CONST];
  stage_constants(sc, consts);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; row < n; row += stride) {
    uint32_t s[WIDTH];
#pragma unroll
    for (int i = 0; i < WIDTH; i++) s[i] = 0;
    int lane = 0;
    for (int m = 0; m < mats.count; m++) {
      const uint64_t* p = mats.ptr[m] + row;
      for (int64_t col = 0; col < mats.width[m]; col++) {
        s[lane++] = (uint32_t)p[col * n];
        if (lane == RATE) {
          permute(s, sc);
          lane = 0;
        }
      }
    }
    if (lane) permute(s, sc);  // a short last chunk keeps lanes lane..15
#pragma unroll
    for (int i = 0; i < 8; i++) out[row * 8 + i] = s[i];
  }
}

int64_t grid_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  return blocks > (1 << 20) ? (1 << 20) : blocks;
}

}  // namespace

// Row digests of the concatenation of `count` same-height (w_j, n) matrices
// of canonical BabyBear values: out is (n, 8) u32.  consts: the N_CONST round
// constants as int64 on the device.
extern "C" int p2_hash_rows(const uint64_t* const* ptrs, const int64_t* widths, int count, int64_t n,
                            const int64_t* consts, uint32_t* out, cudaStream_t stream) {
  if (count <= 0 || count > MAX_MATS || n <= 0) return (int)cudaErrorInvalidValue;
  MatList mats;
  for (int j = 0; j < MAX_MATS; j++) {
    mats.ptr[j] = j < count ? ptrs[j] : nullptr;
    mats.width[j] = j < count ? widths[j] : 0;
  }
  mats.count = count;
  const int threads = 128;
  p2_hash_rows_kernel<<<(unsigned)grid_for(n, threads), threads, 0, stream>>>(mats, n, consts, out);
  return (int)cudaGetLastError();
}
