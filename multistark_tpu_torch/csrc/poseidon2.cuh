// The Poseidon2 permutation (BabyBear, width 16) as device functions: the
// body that K6 poseidon2_merkle (row hashing, Merkle nodes) and K14 / K15
// (commit_tile.cu) share.
//
// Permutation (the JAX package's, multistark_tpu/hash/poseidon2.py): the
// external linear layer, 4 full rounds, 13 partial rounds, 4 full rounds.  A
// full round adds the round's 16 constants, applies x^7 to every lane and
// the external layer circ(2*M4, M4, M4, M4) (each 4-lane block times M4,
// plus the four blocks' column sums); a partial round adds one constant to
// lane 0, applies x^7 to lane 0 and the internal layer
// y_i = d_i * x_i + sum(x).  Values stay canonical, reduced with
// babybear.cuh's Barrett step.  The 157 round constants (canonical, from the
// caller as int64) are staged in shared memory per block.
#pragma once

#include "babybear.cuh"

namespace p2 {
namespace {  // internal linkage: every source that includes this keeps its own copy

constexpr int WIDTH = 16;
constexpr int RATE = 8;
constexpr int ROUNDS_F = 8;
constexpr int ROUNDS_P = 13;
constexpr int N_CONST = ROUNDS_F * WIDTH + ROUNDS_P + WIDTH;  // external, internal, diagonal

__device__ __forceinline__ uint32_t sbox(uint32_t x) {
  const uint64_t x2 = bb::mul(x, x);
  const uint64_t x4 = bb::mul(x2, x2);
  return (uint32_t)bb::mul(bb::mul(x4, x2), x);
}

// circ(2*M4, M4, M4, M4) with M4 rows (2 3 1 1), (1 2 3 1), (1 1 2 3), (3 1 1 2).
__device__ __forceinline__ void external_linear(uint32_t* s) {
  uint64_t t[WIDTH];
#pragma unroll
  for (int b = 0; b < WIDTH; b += 4) {
    const uint64_t x0 = s[b], x1 = s[b + 1], x2 = s[b + 2], x3 = s[b + 3];
    t[b] = bb::reduce(2 * x0 + 3 * x1 + x2 + x3);
    t[b + 1] = bb::reduce(x0 + 2 * x1 + 3 * x2 + x3);
    t[b + 2] = bb::reduce(x0 + x1 + 2 * x2 + 3 * x3);
    t[b + 3] = bb::reduce(3 * x0 + x1 + x2 + 2 * x3);
  }
#pragma unroll
  for (int i = 0; i < 4; i++) {
    const uint64_t sum = t[i] + t[4 + i] + t[8 + i] + t[12 + i];
#pragma unroll
    for (int b = 0; b < WIDTH; b += 4) s[b + i] = (uint32_t)bb::reduce(t[b + i] + sum);
  }
}

__device__ __forceinline__ void internal_linear(uint32_t* s, const uint32_t* diag) {
  uint64_t tot = 0;
#pragma unroll
  for (int i = 0; i < WIDTH; i++) tot += s[i];
#pragma unroll
  for (int i = 0; i < WIDTH; i++) s[i] = (uint32_t)bb::reduce((uint64_t)diag[i] * s[i] + tot);
}

// c: external round constants [ROUNDS_F][WIDTH], internal [ROUNDS_P], diagonal [WIDTH].
__device__ void permute(uint32_t* s, const uint32_t* c) {
  const uint32_t* internal = c + ROUNDS_F * WIDTH;
  const uint32_t* diag = internal + ROUNDS_P;
  external_linear(s);
  for (int r = 0; r < ROUNDS_F; r++) {
    if (r == ROUNDS_F / 2) {
      for (int k = 0; k < ROUNDS_P; k++) {
        s[0] = sbox((uint32_t)bb::add(s[0], internal[k]));
        internal_linear(s, diag);
      }
    }
#pragma unroll
    for (int i = 0; i < WIDTH; i++) s[i] = sbox((uint32_t)bb::add(s[i], c[r * WIDTH + i]));
    external_linear(s);
  }
}

// The Merkle 2-to-1: the permutation of left || right truncated to 8 lanes.
__device__ __forceinline__ void compress(const uint32_t left[8], const uint32_t right[8], uint32_t out[8],
                                         const uint32_t* c) {
  uint32_t s[WIDTH];
#pragma unroll
  for (int k = 0; k < 8; k++) {
    s[k] = left[k];
    s[8 + k] = right[k];
  }
  permute(s, c);
#pragma unroll
  for (int k = 0; k < 8; k++) out[k] = s[k];
}

__device__ __forceinline__ void stage_constants(uint32_t* sc, const int64_t* consts) {
  for (int i = threadIdx.x; i < N_CONST; i += blockDim.x) sc[i] = (uint32_t)consts[i];
  __syncthreads();
}

}  // namespace
}  // namespace p2
