// The elementwise field kernel body shared by K1 gl_arith (Goldilocks, GL2)
// and K5 bb_arith (BabyBear, BB4): templated kernels over a field trait.
//
// Bound on the card: memory for the products and sums (a base mul reads 16
// bytes and writes 8 for a few dozen integer instructions), integer
// operations for the Fermat inverses.  Design:
// - one kernel per op, chosen when it is compiled (no switch on the op in
//   the loop);
// - operands broadcast by period without a 64-bit `%`: every period of an
//   operand divides the output's size, so the output is viewed as `reps`
//   rows of P elements (P the smallest period above 1, or the output's last
//   axis when an operand is a column), x over P and y over the rows on a
//   2-D grid; an operand of period P reads (x), one of the output's size
//   (y, x), a scalar element 0, any other period k·P row y mod k (a 32-bit
//   remainder once per thread and row), and a column of k elements (one per
//   row, as (k, 1) against (.., k, P)) element y mod k;
// - 32-bit index arithmetic (P and reps below 2^31; the row offset y·P is
//   one 32x32->64 product);
// - two elements per thread with 16-byte loads and stores when P is even
//   and every operand that is not a scalar lies on 16 bytes, else one.
// Extension values are coordinate-major: coordinate d of an operand sits at
// d·cs + index, coordinate d of output element i at d·n + i.
//
// The powers entry writes [α^0 .. α^(count-1)] of one extension scalar α
// that stays on the device: each thread raises α to its own index by
// square-and-multiply over the index's bits, right to left, so its longest
// chain of dependent products is the squarings of α (ceil(log2 count)).
// Field arithmetic is exact, so every power equals the sequential product's.
#pragma once

#include "field.cuh"

namespace {

enum Op : int {
  ADD = 0,
  SUB = 1,
  NEG = 2,
  MUL = 3,
  POW = 4,
  INV = 5,
  EXT_ADD = 10,
  EXT_SUB = 11,
  EXT_MUL = 13,
  EXT_SCALE = 14,  // ext a times base b
  EXT_INV = 15,
};

__host__ __device__ constexpr bool is_ext(int op) { return op >= EXT_ADD; }
__host__ __device__ constexpr bool is_unary(int op) { return op == NEG || op == POW || op == INV || op == EXT_INV; }

// One operand: coordinate 0 at p, coordinate d at p + d·cs.  py: 0 for a
// scalar; else the operand's period in rows of the output (1: a row vector
// of P, the output's rows: the whole output, k: repeats every k rows).
// column: one element per row (k elements, repeating every k rows).
struct Operand {
  const uint64_t* p;
  int64_t cs;
  uint32_t py;
  bool column;
};

// The index of output element (y, x) in the operand (not for a scalar).
__device__ __forceinline__ uint64_t operand_index(const Operand& o, uint32_t y, uint32_t x, uint32_t reps,
                                                  uint32_t P) {
  const uint32_t yy = o.py == reps ? y : (o.py == 1 ? 0u : y % o.py);
  return o.column ? yy : (uint64_t)yy * P + x;
}

// V consecutive elements from p + i, or element i broadcast to all V.
template <int V>
__device__ __forceinline__ void load(const uint64_t* p, bool broadcast, uint64_t i, uint64_t (&v)[V]) {
  if (broadcast) {
    const uint64_t s = p[i];
#pragma unroll
    for (int k = 0; k < V; k++) v[k] = s;
  } else if constexpr (V == 2) {
    const ulonglong2 t = *reinterpret_cast<const ulonglong2*>(p + i);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = p[i];
  }
}

template <int V>
__device__ __forceinline__ void store(uint64_t* p, uint64_t i, const uint64_t (&v)[V]) {
  if constexpr (V == 2) {
    *reinterpret_cast<ulonglong2*>(p + i) = make_ulonglong2(v[0], v[1]);
  } else {
    p[i] = v[0];
  }
}

template <class F, int OP>
__device__ __forceinline__ uint64_t base_op(uint64_t a, uint64_t b, uint64_t e) {
  if constexpr (OP == ADD) return F::add(a, b);
  if constexpr (OP == SUB) return F::sub(a, b);
  if constexpr (OP == NEG) return F::neg(a);
  if constexpr (OP == MUL) return F::mul(a, b);
  if constexpr (OP == POW) return fpow<F>(a, e);
  if constexpr (OP == INV) return finv<F>(a);
  return 0;
}

template <class F, int OP>
__device__ __forceinline__ Ext<F> ext_op(const Ext<F>& x, const Ext<F>& y, uint64_t s) {
  if constexpr (OP == EXT_ADD) return ext_add<F>(x, y);
  if constexpr (OP == EXT_SUB) return ext_sub<F>(x, y);
  if constexpr (OP == EXT_MUL) return ext_mul<F>(x, y);
  if constexpr (OP == EXT_SCALE) return ext_scale<F>(x, s);
  return ext_inv<F>(x);
}

// out (reps rows of P, V consecutive elements per thread) = OP(a, b).
template <class F, int OP, int V>
__global__ void arith_kernel(Operand a, Operand b, uint64_t* __restrict__ out, uint32_t P, uint32_t reps,
                             uint64_t e) {
  const uint32_t x = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (x >= P) return;
  const uint64_t n = (uint64_t)P * reps;
  constexpr int DA = is_ext(OP) ? F::D : 1;
  constexpr int DB = OP == EXT_SCALE ? 1 : DA;
  for (uint32_t y = blockIdx.y; y < reps; y += gridDim.y) {
    const uint64_t io = (uint64_t)y * P + x;
    const uint64_t ia = a.py ? operand_index(a, y, x, reps, P) : 0;
    uint64_t va[DA][V], vb[DB][V] = {};
#pragma unroll
    for (int d = 0; d < DA; d++) load<V>(a.p + d * a.cs, a.py == 0 || a.column, ia, va[d]);
    if constexpr (!is_unary(OP)) {
      const uint64_t ib = b.py ? operand_index(b, y, x, reps, P) : 0;
#pragma unroll
      for (int d = 0; d < DB; d++) load<V>(b.p + d * b.cs, b.py == 0 || b.column, ib, vb[d]);
    }
    uint64_t r[DA][V];
#pragma unroll
    for (int k = 0; k < V; k++) {
      if constexpr (is_ext(OP)) {
        Ext<F> xa, xb;
#pragma unroll
        for (int d = 0; d < DA; d++) {
          xa.c[d] = va[d][k];
          xb.c[d] = 0;
        }
        if constexpr (!is_unary(OP) && OP != EXT_SCALE) {
#pragma unroll
          for (int d = 0; d < DA; d++) xb.c[d] = vb[d][k];
        }
        const Ext<F> z = ext_op<F, OP>(xa, xb, OP == EXT_SCALE ? vb[0][k] : 0);
#pragma unroll
        for (int d = 0; d < DA; d++) r[d][k] = z.c[d];
      } else {
        r[0][k] = base_op<F, OP>(va[0][k], is_unary(OP) ? 0 : vb[0][k], e);
      }
    }
#pragma unroll
    for (int d = 0; d < DA; d++) store<V>(out + d * n, io, r[d]);
  }
}

template <class F, int OP>
int launch_op(const Operand& a, const Operand& b, uint64_t* out, uint32_t P, uint32_t reps, uint64_t e, bool vec,
              cudaStream_t stream) {
  const int V = vec ? 2 : 1;
  const uint32_t lanes = (P + V - 1) / V;
  const uint32_t threads = lanes >= 256 ? 256 : (lanes + 31) / 32 * 32;
  const dim3 grid((lanes + threads - 1) / threads, reps < 65535 ? reps : 65535);
  if (vec)
    arith_kernel<F, OP, 2><<<grid, threads, 0, stream>>>(a, b, out, P, reps, e);
  else
    arith_kernel<F, OP, 1><<<grid, threads, 0, stream>>>(a, b, out, P, reps, e);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// op on operands a (na elements per coordinate, coordinate stride ca) and b
// (nb, cb; null for a unary op) into out of P x reps elements per
// coordinate; na and nb are 1 or k·P with k dividing reps, or, where bit 0
// (a) or bit 1 (b) of columns is set, a column of k elements with k
// dividing reps.
template <class F>
int arith_launch(int op, const uint64_t* a, int64_t na, int64_t ca, const uint64_t* b, int64_t nb, int64_t cb,
                 int columns, uint64_t* out, int64_t P, int64_t reps, uint64_t e, cudaStream_t stream) {
  if (P <= 0 || reps <= 0) return 0;
  if (P >= ((int64_t)1 << 31) || reps >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  auto operand = [&](const uint64_t* p, int64_t m, int64_t cs, bool column, bool& ok) -> Operand {
    if (m == 1) return Operand{p, cs, 0u, false};
    const int64_t rows = column ? m : m / P;
    ok = ok && (column || m % P == 0) && rows > 0 && reps % rows == 0;
    return Operand{p, cs, (uint32_t)rows, column};
  };
  bool ok = true;
  const Operand A = operand(a, na, ca, columns & 1, ok);
  const Operand B = b ? operand(b, nb, cb, columns & 2, ok) : Operand{nullptr, 0, 0u, false};
  if (!ok) return (int)cudaErrorInvalidValue;
  const int D = op >= EXT_ADD ? F::D : 1;
  bool vec = P % 2 == 0 && aligned16(out) && (P * reps * 8) % 16 == 0;
  for (int d = 0; d < D; d++) {
    vec = vec && (A.py == 0 || A.column || aligned16(a + d * ca));
    if (b && B.py && !B.column && (d == 0 || op != EXT_SCALE)) vec = vec && aligned16(b + d * cb);
  }
  switch (op) {
    case ADD: return launch_op<F, ADD>(A, B, out, P, reps, e, vec, stream);
    case SUB: return launch_op<F, SUB>(A, B, out, P, reps, e, vec, stream);
    case NEG: return launch_op<F, NEG>(A, B, out, P, reps, e, vec, stream);
    case MUL: return launch_op<F, MUL>(A, B, out, P, reps, e, vec, stream);
    case POW: return launch_op<F, POW>(A, B, out, P, reps, e, vec, stream);
    case INV: return launch_op<F, INV>(A, B, out, P, reps, e, vec, stream);
    case EXT_ADD: return launch_op<F, EXT_ADD>(A, B, out, P, reps, e, vec, stream);
    case EXT_SUB: return launch_op<F, EXT_SUB>(A, B, out, P, reps, e, vec, stream);
    case EXT_MUL: return launch_op<F, EXT_MUL>(A, B, out, P, reps, e, vec, stream);
    case EXT_SCALE: return launch_op<F, EXT_SCALE>(A, B, out, P, reps, e, vec, stream);
    case EXT_INV: return launch_op<F, EXT_INV>(A, B, out, P, reps, e, vec, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out[d·count + i] = coordinate d of α^i, i < count; α: D coordinates.
template <class F>
__global__ void powers_kernel(const uint64_t* __restrict__ alpha, uint64_t* __restrict__ out, uint32_t count,
                              int bits) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  Ext<F> base, r;
#pragma unroll
  for (int d = 0; d < F::D; d++) {
    base.c[d] = alpha[d];
    r.c[d] = d == 0 ? 1 : 0;
  }
  for (int k = 0; k < bits; k++) {
    if ((i >> k) & 1) r = ext_mul<F>(r, base);
    if (k + 1 < bits) base = ext_mul<F>(base, base);
  }
#pragma unroll
  for (int d = 0; d < F::D; d++) out[(uint64_t)d * count + i] = r.c[d];
}

template <class F>
int powers_launch(const uint64_t* alpha, uint64_t* out, int64_t count, cudaStream_t stream) {
  if (count <= 0) return 0;
  if (count >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  int bits = 0;
  while (((int64_t)1 << bits) < count) bits++;
  const int threads = count >= 128 ? 128 : (int)((count + 31) / 32 * 32);
  powers_kernel<F><<<(unsigned)((count + threads - 1) / threads), threads, 0, stream>>>(alpha, out, (uint32_t)count,
                                                                                        bits);
  return (int)cudaGetLastError();
}

// io (D coordinates) squared n times in a row in one thread: n dependent
// extension products' latency (the powers entry's floor per bit).
template <class F>
__global__ void ext_chain_kernel(uint64_t* io, int n) {
  Ext<F> x;
#pragma unroll
  for (int d = 0; d < F::D; d++) x.c[d] = io[d];
  for (int i = 0; i < n; i++) x = ext_mul<F>(x, x);
#pragma unroll
  for (int d = 0; d < F::D; d++) io[d] = x.c[d];
}

template <class F>
int ext_chain_launch(uint64_t* io, int n, cudaStream_t stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  ext_chain_kernel<F><<<1, 1, 0, stream>>>(io, n);
  return (int)cudaGetLastError();
}

}  // namespace
