// K11 expr_sweep: one flat base-field program (multistark_tpu_torch/program.py)
// run over every row of a domain, one thread per row, over Goldilocks or
// BabyBear.
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
// The host records each as a program once per circuit (program.Recorder) and
// this kernel interprets it.
//
// Bound on the card: memory.  A row reads each trace cell it needs once or
// twice (this row and the next), the selectors and writes D or a few values,
// for tens to hundreds of field operations.  Design: the program is a
// sequence of int4 instructions in device memory that every thread of a warp
// reads at the same address (one broadcast load each); registers are a
// thread-local array of a compile-time size (16, 32, 64 or 128), picked as
// the smallest that holds the program's live set; leaves are reloaded at
// each use, which keeps that set small.  With brev_log set, thread t works
// on storage position t of a bit-reversed LDE prefix, so the reads of this
// row, the selectors (cached in the same order) and the output are
// coalesced; only the next-row reads scatter.
#include "field.cuh"

namespace {

enum Op : int { CONST = 0, VAR = 1, PUB = 2, SEL = 3, APOW = 4, ADD = 5, SUB = 6, MUL = 7, NEG = 8, OUT = 9 };
constexpr int MAX_SOURCES = 4;
constexpr int N_SELECTORS = 4;  // first, last, transition, inv_vanishing
constexpr int THREADS = 128;

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

template <class F, int NREG>
__global__ void __launch_bounds__(THREADS)
    expr_sweep_kernel(const int4* __restrict__ code, int n_instr, const uint64_t* __restrict__ consts, Sources src,
                      int64_t rows, int64_t step, int brev_log, Selectors sel, const uint64_t* __restrict__ pubs,
                      const uint64_t* __restrict__ apows, uint64_t* __restrict__ out, int64_t plane_stride,
                      int64_t row_stride) {
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < rows; t += (int64_t)gridDim.x * blockDim.x) {
    int64_t next = bitrev(t, brev_log) + step;
    if (next >= rows) next -= rows;
    next = bitrev(next, brev_log);
    uint64_t r[NREG];
    for (int k = 0; k < n_instr; k++) {
      const int4 in = __ldg(code + k);
      switch (in.x) {
        case CONST:
          r[in.y] = __ldg(consts + in.z);
          break;
        case VAR: {
          const int s = in.w >> 1;
          r[in.y] = src.base[s][(int64_t)in.z * src.stride[s] + ((in.w & 1) ? next : t)];
          break;
        }
        case PUB:
          r[in.y] = pubs[in.z];
          break;
        case SEL:
          r[in.y] = sel.s[in.z][t];
          break;
        case APOW:
          r[in.y] = apows[in.z];
          break;
        case ADD:
          r[in.y] = F::add(r[in.z], r[in.w]);
          break;
        case SUB:
          r[in.y] = F::sub(r[in.z], r[in.w]);
          break;
        case MUL:
          r[in.y] = F::mul(r[in.z], r[in.w]);
          break;
        case NEG:
          r[in.y] = F::neg(r[in.z]);
          break;
        default:  // OUT slot a plane
          out[in.w * plane_stride + t * row_stride + in.y] = r[in.z];
          break;
      }
    }
  }
}

template <class F, int NREG>
void launch(const int32_t* code, int n_instr, const uint64_t* consts, const Sources& src, int64_t rows, int64_t step,
            int brev_log, const Selectors& sel, const uint64_t* pubs, const uint64_t* apows, uint64_t* out,
            int64_t plane_stride, int64_t row_stride, cudaStream_t stream) {
  int64_t blocks = (rows + THREADS - 1) / THREADS;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  expr_sweep_kernel<F, NREG><<<(unsigned)blocks, THREADS, 0, stream>>>(
      reinterpret_cast<const int4*>(code), n_instr, consts, src, rows, step, brev_log, sel, pubs, apows, out,
      plane_stride, row_stride);
}

template <class F>
int dispatch(int n_regs, const int32_t* code, int n_instr, const uint64_t* consts, const Sources& src, int64_t rows,
             int64_t step, int brev_log, const Selectors& sel, const uint64_t* pubs, const uint64_t* apows,
             uint64_t* out, int64_t plane_stride, int64_t row_stride, cudaStream_t stream) {
  if (n_regs <= 16)
    launch<F, 16>(code, n_instr, consts, src, rows, step, brev_log, sel, pubs, apows, out, plane_stride, row_stride,
                  stream);
  else if (n_regs <= 32)
    launch<F, 32>(code, n_instr, consts, src, rows, step, brev_log, sel, pubs, apows, out, plane_stride, row_stride,
                  stream);
  else if (n_regs <= 64)
    launch<F, 64>(code, n_instr, consts, src, rows, step, brev_log, sel, pubs, apows, out, plane_stride, row_stride,
                  stream);
  else if (n_regs <= 128)
    launch<F, 128>(code, n_instr, consts, src, rows, step, brev_log, sel, pubs, apows, out, plane_stride, row_stride,
                   stream);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// code: (n_instr, 4) int32; consts: the program's constants; bases / strides:
// MAX_SOURCES host arrays (a source's column c starts at base + c·stride);
// sels: N_SELECTORS host array of (rows,) columns in the rows' order; pubs,
// apows: flat device arrays (null if the program reads none); out: written at
// plane·plane_stride + row·row_stride + slot.  field 0 Goldilocks, 1 BabyBear.
extern "C" int expr_sweep(int field, const int32_t* code, int n_instr, int n_regs, const uint64_t* consts,
                          const uint64_t* const* bases, const int64_t* strides, int64_t rows, int64_t step,
                          int brev_log, const uint64_t* const* sels, const uint64_t* pubs, const uint64_t* apows,
                          uint64_t* out, int64_t plane_stride, int64_t row_stride, cudaStream_t stream) {
  if (rows <= 0 || n_instr <= 0) return 0;
  if ((field != 0 && field != 1) || n_regs < 0 || brev_log < 0 || brev_log > 40) return (int)cudaErrorInvalidValue;
  Sources src;
  for (int s = 0; s < MAX_SOURCES; s++) {
    src.base[s] = bases[s];
    src.stride[s] = strides[s];
  }
  Selectors sel;
  for (int s = 0; s < N_SELECTORS; s++) sel.s[s] = sels[s];
  if (field == 0)
    return dispatch<Goldilocks>(n_regs, code, n_instr, consts, src, rows, step, brev_log, sel, pubs, apows, out,
                                plane_stride, row_stride, stream);
  return dispatch<BabyBear>(n_regs, code, n_instr, consts, src, rows, step, brev_log, sel, pubs, apows, out,
                            plane_stride, row_stride, stream);
}
