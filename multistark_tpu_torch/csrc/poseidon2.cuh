// The Poseidon2 permutation (BabyBear, width 16) as device functions: the
// one body that K6 poseidon2_merkle (row hashing), K14 lde_tile (a hashed
// tile's leaves and in-tile levels) and K15 merkle_levels (tree levels,
// commit_tile.cu) share.
//
// Permutation (the JAX package's, multistark_tpu/hash/poseidon2.py): the
// external linear layer, 4 full rounds, 13 partial rounds, 4 full rounds.  A
// full round adds the round's 16 constants, applies x^7 to every lane and
// the external layer circ(2*M4, M4, M4, M4) (each 4-lane block times M4,
// plus the four blocks' column sums); a partial round adds one constant to
// lane 0, applies x^7 to lane 0 and the internal layer
// y_i = d_i * x_i + sum(x).  It runs in Montgomery form (R = 2^32) on 32-bit
// words: a product is three 32-bit multiplies and a conditional add (no
// 64-bit Barrett step), a sum one add and a min, and every loop is unrolled,
// so the round constants are read at fixed offsets.  Callers convert values
// in with to_mont and digests out with from_mont; the 157 round constants
// (canonical, from the caller as int64) are converted as they are staged
// (stage_constants), or, in K6's thread mode, read from constant memory.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace p2 {
namespace {  // internal linkage: every source that includes this keeps its own copy

constexpr int WIDTH = 16;
constexpr int RATE = 8;
constexpr int ROUNDS_F = 8;
constexpr int ROUNDS_P = 13;
constexpr int N_CONST = ROUNDS_F * WIDTH + ROUNDS_P + WIDTH;  // external, internal, diagonal

// Values are in [0, p); p < 2^31, so a sum of two fits a word.
namespace mont {

constexpr uint32_t P = 0x78000001u;
constexpr uint32_t P_INV = 0x88000001u;  // p^-1 mod 2^32
constexpr uint32_t R2 = 0x45dddde3u;     // 2^64 mod p

// a·b·2^-32 mod p: with m = lo(a·b)·p^-1, a·b - m·p is a multiple of 2^32
// in (-2^32·p, 2^32·p), so its high word hi(a·b) - hi(m·p) is the result up
// to one added p.
__device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
  const uint32_t lo = a * b, hi = __umulhi(a, b);
  const uint32_t mh = __umulhi(lo * P_INV, P);
  const uint32_t r = hi - mh;
  return hi < mh ? r + P : r;
}

__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;
  return min(s, s - P);  // s - P wraps above s when s < P
}

__device__ __forceinline__ uint32_t to_mont(uint32_t x) { return mul(x, R2); }
__device__ __forceinline__ uint32_t from_mont(uint32_t x) { return mul(x, 1); }

// x^7 as x^4·x^3: three products deep.
__device__ __forceinline__ uint32_t sbox(uint32_t x) {
  const uint32_t x2 = mul(x, x);
  return mul(mul(x2, x2), mul(x2, x));
}

// M4 rows (2 3 1 1), (1 2 3 1), (1 1 2 3), (3 1 1 2) in ten sums.
__device__ __forceinline__ void mat4(uint32_t* x) {
  const uint32_t t01 = add(x[0], x[1]), t23 = add(x[2], x[3]);
  const uint32_t t0123 = add(t01, t23);
  const uint32_t t01123 = add(t0123, x[1]), t01233 = add(t0123, x[3]);
  const uint32_t y3 = add(t01233, add(x[0], x[0]));
  const uint32_t y1 = add(t01123, add(x[2], x[2]));
  x[0] = add(t01123, t01);
  x[2] = add(t01233, t23);
  x[1] = y1;
  x[3] = y3;
}

__device__ __forceinline__ void external_linear(uint32_t* s) {
#pragma unroll
  for (int b = 0; b < WIDTH; b += 4) mat4(s + b);
#pragma unroll
  for (int i = 0; i < 4; i++) {
    const uint32_t sum = add(add(s[i], s[4 + i]), add(s[8 + i], s[12 + i]));
#pragma unroll
    for (int b = 0; b < WIDTH; b += 4) s[b + i] = add(s[b + i], sum);
  }
}

// The sum of lanes 1..15 is a tree that does not wait for lane 0's S-box,
// which is the only new value of a partial round: lane 0 joins it last.
__device__ __forceinline__ void internal_linear(uint32_t* s, const uint32_t* diag) {
  uint32_t t[8];
  t[0] = s[1];
#pragma unroll
  for (int i = 1; i < 8; i++) t[i] = add(s[2 * i], s[2 * i + 1]);
#pragma unroll
  for (int w = 4; w >= 1; w >>= 1)
#pragma unroll
    for (int i = 0; i < w; i++) t[i] = add(t[i], t[i + w]);
  const uint32_t tot = add(t[0], s[0]);
#pragma unroll
  for (int i = 0; i < WIDTH; i++) s[i] = add(mul(diag[i], s[i]), tot);
}

__device__ __forceinline__ void partial_round(uint32_t* s, uint32_t rc, const uint32_t* diag) {
  s[0] = sbox(add(s[0], rc));
  internal_linear(s, diag);
}

// c: the constants in Montgomery form: external [ROUNDS_F][WIDTH], internal
// [ROUNDS_P], diagonal [WIDTH].  ROLLED keeps the 13 partial rounds a loop
// (a smaller body, each round's constant read at a run-time offset).
template <bool ROLLED = false>
__device__ __forceinline__ void permute(uint32_t* s, const uint32_t* c) {
  const uint32_t* internal = c + ROUNDS_F * WIDTH;
  const uint32_t* diag = internal + ROUNDS_P;
  external_linear(s);
#pragma unroll
  for (int r = 0; r < ROUNDS_F; r++) {
    if (r == ROUNDS_F / 2) {
      if constexpr (ROLLED) {
#pragma unroll 1
        for (int k = 0; k < ROUNDS_P; k++) partial_round(s, internal[k], diag);
      } else {
#pragma unroll
        for (int k = 0; k < ROUNDS_P; k++) partial_round(s, internal[k], diag);
      }
    }
#pragma unroll
    for (int i = 0; i < WIDTH; i++) s[i] = sbox(add(s[i], c[r * WIDTH + i]));
    external_linear(s);
  }
}

// The Merkle 2-to-1 on canonical digests: the permutation of left || right
// truncated to 8 lanes.
__device__ __forceinline__ void compress(const uint32_t left[8], const uint32_t right[8], uint32_t out[8],
                                         const uint32_t* c) {
  uint32_t s[WIDTH];
#pragma unroll
  for (int k = 0; k < 8; k++) {
    s[k] = to_mont(left[k]);
    s[8 + k] = to_mont(right[k]);
  }
  permute(s, c);
#pragma unroll
  for (int k = 0; k < 8; k++) out[k] = from_mont(s[k]);
}

// The same permutation on a group of four consecutive lanes (a quarter of
// the instructions per lane, for a node's latency): lane k holds state words
// 4k..4k+3, an M4 block, so M4 stays in the lane and only the sums across
// blocks cross lanes (two shuffles each).  Every lane of the warp calls it.
__device__ __forceinline__ uint32_t group_sum(uint32_t v) {
  v = add(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return add(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ void external_linear4(uint32_t* x) {
  mat4(x);
#pragma unroll
  for (int i = 0; i < 4; i++) x[i] = add(x[i], group_sum(x[i]));
}

__device__ __forceinline__ void internal_linear4(uint32_t* x, const uint32_t* diag) {
  const uint32_t tot = group_sum(add(add(x[0], x[1]), add(x[2], x[3])));
#pragma unroll
  for (int i = 0; i < 4; i++) x[i] = add(mul(diag[i], x[i]), tot);
}

// c: the Montgomery constants; k: the lane's place in its group.
__device__ __forceinline__ void permute4(uint32_t* x, const uint32_t* c, int k) {
  const uint32_t* internal = c + ROUNDS_F * WIDTH;
  const uint32_t* diag = internal + ROUNDS_P + 4 * k;
  external_linear4(x);
#pragma unroll
  for (int r = 0; r < ROUNDS_F; r++) {
    if (r == ROUNDS_F / 2) {
#pragma unroll
      for (int q = 0; q < ROUNDS_P; q++) {
        const uint32_t y = sbox(add(x[0], internal[q]));
        if (k == 0) x[0] = y;
        internal_linear4(x, diag);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; i++) x[i] = sbox(add(x[i], c[r * WIDTH + 4 * k + i]));
    external_linear4(x);
  }
}

// compress on a group: lanes 0, 1 hold the left digest's words 0-3, 4-7,
// lanes 2, 3 the right's (canonical); after it lanes 0, 1 hold the result's.
__device__ __forceinline__ void compress4(uint32_t* x, const uint32_t* c, int k) {
#pragma unroll
  for (int i = 0; i < 4; i++) x[i] = to_mont(x[i]);
  permute4(x, c, k);
#pragma unroll
  for (int i = 0; i < 4; i++) x[i] = from_mont(x[i]);
}

// The canonical constants (int64) in Montgomery form into shared sc; the
// caller synchronises.
__device__ __forceinline__ void stage_constants(uint32_t* sc, const int64_t* consts) {
  for (int i = threadIdx.x; i < N_CONST; i += blockDim.x) sc[i] = to_mont((uint32_t)consts[i]);
}

}  // namespace mont

}  // namespace
}  // namespace p2
