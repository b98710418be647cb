// Goldilocks (p = 2^64 - 2^32 + 1) and its degree-2 extension X^2 = 7 as
// device functions on native u64, shared by the four kernels of the port.
//
// Replaces the u32 limb-plane arithmetic of multistark_tpu/fields/device.py
// (_mul32, _add64, _sub64, _gl_canon, GoldilocksOps, ExtOps as GL2_OPS): the
// TPU has no 64-bit multiply, Hopper has __umul64hi, so an element is one
// uint64_t holding its canonical value.  Every function returns a canonical
// value in [0, p): the committed bytes are the canonical u64 patterns, so a
// non-canonical intermediate would change a hash.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 - p = 2^32 - 1
constexpr uint64_t W = 7;                // X^2 = W in the extension

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

// a·b mod p: 128-bit product, then 2^64 = EPS and 2^96 = -1 (mod p).
__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  const uint64_t lo = a * b;
  const uint64_t hi = __umul64hi(a, b);
  const uint64_t x2 = hi & EPS, x3 = hi >> 32;
  uint64_t t0 = lo - x3;
  if (lo < x3) t0 -= EPS;
  const uint64_t t1 = x2 * EPS;  // < 2^64 exactly
  uint64_t r = t0 + t1;
  if (r < t0) r += EPS;
  if (r >= P) r -= P;
  return r;
}

__device__ __forceinline__ uint64_t pow(uint64_t a, uint64_t e) {
  uint64_t r = 1;
  while (e) {
    if (e & 1) r = mul(r, a);
    a = mul(a, a);
    e >>= 1;
  }
  return r;
}

// Fermat inverse; 0 maps to 0, as in the JAX package.
__device__ __forceinline__ uint64_t inv(uint64_t a) { return pow(a, P - 2); }

struct Ext2 {
  uint64_t c0, c1;
};

__device__ __forceinline__ Ext2 ext_add(Ext2 a, Ext2 b) { return {add(a.c0, b.c0), add(a.c1, b.c1)}; }
__device__ __forceinline__ Ext2 ext_sub(Ext2 a, Ext2 b) { return {sub(a.c0, b.c0), sub(a.c1, b.c1)}; }
__device__ __forceinline__ Ext2 ext_scale(Ext2 a, uint64_t s) { return {mul(a.c0, s), mul(a.c1, s)}; }

__device__ __forceinline__ Ext2 ext_mul(Ext2 a, Ext2 b) {
  return {add(mul(a.c0, b.c0), mul(W, mul(a.c1, b.c1))), add(mul(a.c0, b.c1), mul(a.c1, b.c0))};
}

// (a0 + a1 X)^-1 = (a0 - a1 X) / (a0^2 - W a1^2); 0 maps to 0.
__device__ __forceinline__ Ext2 ext_inv(Ext2 a) {
  const uint64_t norm = sub(mul(a.c0, a.c0), mul(W, mul(a.c1, a.c1)));
  const uint64_t ninv = inv(norm);
  return {mul(a.c0, ninv), neg(mul(a.c1, ninv))};
}

__device__ __forceinline__ bool ext_is_zero(Ext2 a) { return (a.c0 | a.c1) == 0; }

}  // namespace gl
