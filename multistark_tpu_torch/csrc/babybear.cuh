// BabyBear (p = 2^31 - 2^27 + 1) as device functions on canonical values,
// and the field trait `BabyBear` (degree-4 extension X^4 = 11) that the
// templated kernels take.
//
// Replaces multistark_tpu/fields/device.py BabyBearOps (Montgomery u32 planes
// with a 16-bit-split REDC, because the TPU's vector unit has no 32x32->64
// multiply).  Hopper multiplies 32x32->64 natively, so an element here is its
// canonical value and a product is reduced by Barrett with a 64-bit
// reciprocal: q = hi64(x * MU) underestimates floor(x / p) by at most one for
// any x < 2^64, so r = x - q*p < 2p needs one conditional subtraction.  The
// kernels store elements as int64 (the same tensors as Goldilocks), so only
// canonical values cross their interface.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bb {

constexpr uint64_t P = 0x78000001ull;                  // 2013265921
constexpr uint64_t MU = 0xFFFFFFFFFFFFFFFFull / P;      // floor((2^64 - 1) / p)

// x mod p for any x < 2^64.
__device__ __forceinline__ uint64_t reduce(uint64_t x) {
  const uint64_t q = __umul64hi(x, MU);
  uint64_t r = x - q * P;
  if (r >= P) r -= P;
  return r;
}

__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
  const uint64_t s = a + b;
  return s >= P ? s - P : s;
}

__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) { return a >= b ? a - b : a + P - b; }

__device__ __forceinline__ uint64_t neg(uint64_t a) { return a ? P - a : 0; }

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) { return reduce(a * b); }

}  // namespace bb

struct BabyBear {
  static constexpr uint64_t P = bb::P;
  static constexpr int D = 4;        // extension degree
  static constexpr uint64_t W = 11;  // X^D = W
  static __device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) { return bb::add(a, b); }
  static __device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) { return bb::sub(a, b); }
  static __device__ __forceinline__ uint64_t neg(uint64_t a) { return bb::neg(a); }
  static __device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) { return bb::mul(a, b); }
};
