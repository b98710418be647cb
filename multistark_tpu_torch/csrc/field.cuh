// Generic field and binomial-extension arithmetic over a field trait F
// (goldilocks.cuh `Goldilocks`, babybear.cuh `BabyBear`): the one body that
// the elementwise, NTT and scan kernels share for both fields.
//
// A trait gives P, the extension degree D and X^D = W, and canonical
// add/sub/neg/mul on uint64_t.  Extension products are schoolbook with the
// X^D = W wraparound; the inverse is the norm map: direct for D = 2, through
// the X -> -X conjugate tower for D = 4 (multistark_tpu/fields/device.py
// ExtOps.inv).  Zero maps to zero everywhere, as in the JAX package.
#pragma once

#include "babybear.cuh"
#include "goldilocks.cuh"

template <class F>
__device__ __forceinline__ uint64_t fpow(uint64_t a, uint64_t e) {
  uint64_t r = 1;
  while (e) {
    if (e & 1) r = F::mul(r, a);
    a = F::mul(a, a);
    e >>= 1;
  }
  return r;
}

// Fermat inverse; 0 maps to 0.
template <class F>
__device__ __forceinline__ uint64_t finv(uint64_t a) {
  return fpow<F>(a, F::P - 2);
}

template <class F>
struct Ext {
  uint64_t c[F::D];
};

template <class F>
__device__ __forceinline__ Ext<F> ext_add(const Ext<F>& a, const Ext<F>& b) {
  Ext<F> r;
#pragma unroll
  for (int d = 0; d < F::D; d++) r.c[d] = F::add(a.c[d], b.c[d]);
  return r;
}

template <class F>
__device__ __forceinline__ Ext<F> ext_sub(const Ext<F>& a, const Ext<F>& b) {
  Ext<F> r;
#pragma unroll
  for (int d = 0; d < F::D; d++) r.c[d] = F::sub(a.c[d], b.c[d]);
  return r;
}

template <class F>
__device__ __forceinline__ Ext<F> ext_scale(const Ext<F>& a, uint64_t s) {
  Ext<F> r;
#pragma unroll
  for (int d = 0; d < F::D; d++) r.c[d] = F::mul(a.c[d], s);
  return r;
}

template <class F>
__device__ __forceinline__ Ext<F> ext_mul(const Ext<F>& a, const Ext<F>& b) {
  Ext<F> r;
#pragma unroll
  for (int d = 0; d < F::D; d++) r.c[d] = 0;
#pragma unroll
  for (int i = 0; i < F::D; i++) {
#pragma unroll
    for (int j = 0; j < F::D; j++) {
      uint64_t t = F::mul(a.c[i], b.c[j]);
      int k = i + j;
      if (k >= F::D) {
        k -= F::D;
        t = F::mul(t, F::W);
      }
      r.c[k] = F::add(r.c[k], t);
    }
  }
  return r;
}

template <class F>
__device__ __forceinline__ bool ext_is_zero(const Ext<F>& a) {
  uint64_t any = 0;
#pragma unroll
  for (int d = 0; d < F::D; d++) any |= a.c[d];
  return any == 0;
}

template <class F>
__device__ __forceinline__ Ext<F> ext_inv(const Ext<F>& a) {
  static_assert(F::D == 2 || F::D == 4, "extension degree 2 or 4");
  Ext<F> r;
  if constexpr (F::D == 2) {
    // (a0 + a1 X)^-1 = (a0 - a1 X) / (a0^2 - W a1^2)
    const uint64_t norm = F::sub(F::mul(a.c[0], a.c[0]), F::mul(F::W, F::mul(a.c[1], a.c[1])));
    const uint64_t ninv = finv<F>(norm);
    r.c[0] = F::mul(a.c[0], ninv);
    r.c[1] = F::neg(F::mul(a.c[1], ninv));
  } else {
    // b = a * conj(a) has only even coordinates: c0 + c2 u with u = X^2,
    // u^2 = W; (c0 + c2 u)^-1 = (c0 - c2 u) / (c0^2 - W c2^2)
    Ext<F> conj;
    conj.c[0] = a.c[0];
    conj.c[1] = F::neg(a.c[1]);
    conj.c[2] = a.c[2];
    conj.c[3] = F::neg(a.c[3]);
    const Ext<F> b = ext_mul<F>(a, conj);
    const uint64_t norm = F::sub(F::mul(b.c[0], b.c[0]), F::mul(F::W, F::mul(b.c[2], b.c[2])));
    const uint64_t ninv = finv<F>(norm);
    Ext<F> d;
    d.c[0] = F::mul(b.c[0], ninv);
    d.c[1] = 0;
    d.c[2] = F::neg(F::mul(b.c[2], ninv));
    d.c[3] = 0;
    r = ext_mul<F>(conj, d);
  }
  return r;
}
