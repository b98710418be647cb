// K11 expr_sweep: the template of the kernel that runs one recorded
// base-field program (multistark_tpu_torch/program.py) over every row of a
// domain, one thread per row, over Goldilocks or BabyBear.  Not compiled on
// its own: program.py fills in the program's straight-line body and
// constants (the @...@ fields) and builds one shared library per program.
//
// Replaces three fused TPU programs of the JAX package, each a jitted sweep
// of the constraint graph with one whole-column op per node:
//   - multistark_tpu/prover.py:640 _quotient_sweep_only (with :369
//     _selectors_device, evaluator.py:121 and lookup.py:209): the constraints,
//     the logUp constraints, the α-fold and the division by Z_H on the
//     quotient domain;
//   - multistark_tpu/system.py:263 _lookup_values_kernel: the lookup prefix of
//     the graph over the witness;
//   - multistark_tpu/lookup.py:584 _stage2_msgs: the stage-2 slot messages
//     β + Σ_i arg_i·γ^i in the chain order.
//
// Bound on the card: memory.  A row reads each trace cell it needs once or
// twice (this row and the next) and the selectors, and writes D or a few
// values, for tens to hundreds of field operations.  The first version of
// this kernel interpreted the program: a broadcast load and a switch per instruction, a
// register file indexed at run time (so in local memory), every leaf
// reloaded at each use; tens of instructions per field operation, 3-28x the
// bound.  Here the program is the kernel's code: each SSA value of the
// program is a local uint64_t (nvcc allocates real registers), constants
// are literals, each distinct leaf (trace cell, selector, public, α power)
// is loaded once with __ldg, and the outputs are plain stores.  With
// brev_log set, thread t works on storage position t of a bit-reversed LDE
// prefix, so the reads of this row, the selectors (cached in the same order)
// and the output are coalesced; only the next-row reads scatter.  A program
// with several slots per row (the stage-2 messages, row stride = SLOTS)
// stages its outputs in shared memory and stores each plane's run of the
// block's rows contiguously.
//
// The generated body uses these macros over SSA names:
//   VAR(s, c, o)   source s, column c, this row (o = 0) or the next (o = 1)
//   PUB(i), SEL(s), APOW(k)   publics, selector s at this row, α powers
//   ADD, SUB, MUL (a, b), NEG (a)   the field's canonical ops
//   OUT(plane, slot, v)   out[plane·plane_stride + row·row_stride + slot] = v
#include "field.cuh"

namespace {

constexpr int MAX_SOURCES = 4;
constexpr int N_SELECTORS = 4;  // first, last, transition, inv_vanishing
constexpr int THREADS = @THREADS@;
#define SLOTS @SLOTS@  // output slots per row staged in shared memory (0: stored directly); a macro for #if
constexpr int PLANES = @PLANES@;
using F = @FIELD@;

struct Sources {
  const uint64_t* base[MAX_SOURCES];
  int64_t stride[MAX_SOURCES];  // words between two columns of a source
};

struct Selectors {
  const uint64_t* s[N_SELECTORS];
};

__device__ __forceinline__ int64_t bitrev(int64_t i, int bits) {
  return bits ? (int64_t)(__brevll((unsigned long long)i) >> (64 - bits)) : i;
}

#define ADD(a, b) F::add(a, b)
#define SUB(a, b) F::sub(a, b)
#define MUL(a, b) F::mul(a, b)
#define NEG(a) F::neg(a)
#define VAR(s, c, o) __ldg(src.base[s] + (int64_t)(c) * src.stride[s] + ((o) ? nxt : t))
#define PUB(i) __ldg(pubs + (i))
#define SEL(k) __ldg(sel.s[k] + t)
#define APOW(k) __ldg(apows + (k))
#if SLOTS
#define OUT(plane, slot, v) stage[plane][threadIdx.x * SLOTS + (slot)] = (v)
#else
#define OUT(plane, slot, v) out[(int64_t)(plane) * plane_stride + t * row_stride + (slot)] = (v)
#endif

__global__ void __launch_bounds__(THREADS)
    expr_sweep_kernel_@KEY@(Sources src, int64_t rows, int64_t step, int brev_log, Selectors sel,
                            const uint64_t* __restrict__ pubs, const uint64_t* __restrict__ apows,
                            uint64_t* __restrict__ out, int64_t plane_stride, int64_t row_stride) {
#if SLOTS
  __shared__ uint64_t stage[PLANES][THREADS * SLOTS];
#endif
  for (int64_t first = (int64_t)blockIdx.x * THREADS; first < rows; first += (int64_t)gridDim.x * THREADS) {
    const int64_t t = first + threadIdx.x;
    if (t < rows) {
      int64_t nxt = bitrev(t, brev_log) + step;
      if (nxt >= rows) nxt -= rows;
      nxt = bitrev(nxt, brev_log);
      (void)nxt;
@BODY@
    }
#if SLOTS
    __syncthreads();
    const int64_t valid = (rows - first < THREADS ? rows - first : THREADS) * SLOTS;
    for (int p = 0; p < PLANES; p++)
      for (int64_t i = threadIdx.x; i < valid; i += THREADS) out[p * plane_stride + first * SLOTS + i] = stage[p][i];
    __syncthreads();
#endif
  }
}

}  // namespace

// bases / strides: MAX_SOURCES host arrays (a source's column c starts at
// base + c·stride); sels: N_SELECTORS host array of (rows,) columns in the
// rows' order; pubs, apows: flat device arrays (null if the program reads
// none); out: written at plane·plane_stride + row·row_stride + slot.
extern "C" int expr_sweep_@KEY@(const uint64_t* const* bases, const int64_t* strides, int64_t rows, int64_t step,
                                 int brev_log, const uint64_t* const* sels, const uint64_t* pubs,
                                 const uint64_t* apows, uint64_t* out, int64_t plane_stride, int64_t row_stride,
                                 cudaStream_t stream) {
  if (rows <= 0) return 0;
  if (brev_log < 0 || brev_log > 40 || (SLOTS && row_stride != SLOTS)) return (int)cudaErrorInvalidValue;
  Sources src;
  for (int s = 0; s < MAX_SOURCES; s++) {
    src.base[s] = bases[s];
    src.stride[s] = strides[s];
  }
  Selectors sel;
  for (int s = 0; s < N_SELECTORS; s++) sel.s[s] = sels[s];
  int64_t blocks = (rows + THREADS - 1) / THREADS;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  expr_sweep_kernel_@KEY@<<<(unsigned)blocks, THREADS, 0, stream>>>(src, rows, step, brev_log, sel, pubs, apows,
                                                                     out, plane_stride, row_stride);
  return (int)cudaGetLastError();
}
