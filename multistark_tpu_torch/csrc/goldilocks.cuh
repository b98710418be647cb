// Goldilocks (p = 2^64 - 2^32 + 1) as device functions on native u64, and
// the field trait `Goldilocks` (degree-2 extension X^2 = 7) that the
// templated kernels take.
//
// Replaces the u32 limb-plane arithmetic of multistark_tpu/fields/device.py
// (_mul32, _add64, _sub64, _gl_canon, GoldilocksOps): the TPU has no 64-bit
// multiply, Hopper has __umul64hi, so an element is one uint64_t holding its
// canonical value.  Every function returns a canonical value in [0, p): the
// committed bytes are the canonical u64 patterns, so a non-canonical
// intermediate would change a hash.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 - p = 2^32 - 1

__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < a) s += EPS;  // carry: 2^64 = EPS (mod p); cannot carry again
  if (s >= P) s -= P;
  return s;
}

__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  if (a < b) d -= EPS;  // borrow: d + p = d - EPS (mod 2^64), lands in [0, p)
  return d;
}

__device__ __forceinline__ uint64_t neg(uint64_t a) { return a ? P - a : 0; }

// lo + 2^64·hi mod p, by 2^64 = EPS and 2^96 = -1 (mod p).
__device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
  const uint64_t x2 = hi & EPS, x3 = hi >> 32;
  uint64_t t0 = lo - x3;
  if (lo < x3) t0 -= EPS;
  const uint64_t t1 = x2 * EPS;  // < 2^64 exactly
  uint64_t r = t0 + t1;
  if (r < t0) r += EPS;
  if (r >= P) r -= P;
  return r;
}

// a·b mod p: the 128-bit product, reduced.
__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) { return reduce128(a * b, __umul64hi(a, b)); }

}  // namespace gl

struct Goldilocks {
  static constexpr uint64_t P = gl::P;
  static constexpr int D = 2;       // extension degree
  static constexpr uint64_t W = 7;  // X^D = W
  static __device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) { return gl::add(a, b); }
  static __device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) { return gl::sub(a, b); }
  static __device__ __forceinline__ uint64_t neg(uint64_t a) { return gl::neg(a); }
  static __device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) { return gl::mul(a, b); }
};
