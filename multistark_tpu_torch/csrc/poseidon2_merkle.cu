// K6 poseidon2_merkle: Poseidon2 (BabyBear, width 16) leaf hashing of
// field-matrix rows and the Merkle 2-to-1 compression.
//
// Replaces multistark_tpu/hash/poseidon2.py Poseidon2Device.permute and
// Poseidon2FieldHasher.hash_matrices / compress (with the Montgomery
// conversions around them): the jnp programs that hash the BabyBearPoseidon2
// config's Merkle trees on the TPU.
//
// Permutation (the JAX package's): the external linear layer, 4 full rounds,
// 13 partial rounds, 4 full rounds.  A full round adds the round's 16
// constants, applies x^7 to every lane and the external layer
// circ(2*M4, M4, M4, M4) (each 4-lane block times M4, plus the four blocks'
// column sums); a partial round adds one constant to lane 0, applies x^7 to
// lane 0 and the internal layer y_i = d_i * x_i + sum(x).
//
// Leaf (padding-free sponge, rate 8, width 16): the state starts at zero;
// the row's values (the columns of every matrix of one height, in matrix
// order) are absorbed 8 at a time by OVERWRITING the first lanes, a short
// last chunk leaving the other lanes as they were, with one permutation per
// chunk; the digest is lanes 0..7.  A Merkle node is the permutation of
// left || right truncated to lanes 0..7.  Digests are 8 canonical u32 words.
//
// Bound on the card: integer ALU.  One permutation is ~570 modular
// multiplications (x^7 on 141 lanes, the 13 internal diagonals) for at most
// 64 bytes read.  Design: one thread per row or node with the 16-lane state
// in registers; the 157 round constants (canonical, from the caller) are
// staged in shared memory per block.  Values stay canonical, reduced with
// babybear.cuh's Barrett step.
#include "babybear.cuh"

namespace {

constexpr int WIDTH = 16;
constexpr int RATE = 8;
constexpr int ROUNDS_F = 8;
constexpr int ROUNDS_P = 13;
constexpr int N_CONST = ROUNDS_F * WIDTH + ROUNDS_P + WIDTH;  // external, internal, diagonal
constexpr int MAX_MATS = 16;

struct MatList {
  const uint64_t* ptr[MAX_MATS];
  int64_t width[MAX_MATS];
  int count;
};

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

__device__ __forceinline__ void stage_constants(uint32_t* sc, const int64_t* consts) {
  for (int i = threadIdx.x; i < N_CONST; i += blockDim.x) sc[i] = (uint32_t)consts[i];
  __syncthreads();
}

__global__ void hash_rows_kernel(MatList mats, int64_t n, const int64_t* __restrict__ consts,
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

__global__ void compress_pairs_kernel(const uint32_t* __restrict__ left, int64_t lstride,
                                      const uint32_t* __restrict__ right, int64_t rstride,
                                      const int64_t* __restrict__ consts, uint32_t* __restrict__ out, int64_t n) {
  __shared__ uint32_t sc[N_CONST];
  stage_constants(sc, consts);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    uint32_t s[WIDTH];
#pragma unroll
    for (int k = 0; k < 8; k++) {
      s[k] = left[i * lstride + k];
      s[8 + k] = right[i * rstride + k];
    }
    permute(s, sc);
#pragma unroll
    for (int k = 0; k < 8; k++) out[i * 8 + k] = s[k];
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
  hash_rows_kernel<<<(unsigned)grid_for(n, threads), threads, 0, stream>>>(mats, n, consts, out);
  return (int)cudaGetLastError();
}

// out[i] = Poseidon2(left[i] || right[i])[0..8] for n digest pairs; left/right
// rows are 8 u32 words, `lstride`/`rstride` words apart.
extern "C" int p2_compress_pairs(const uint32_t* left, int64_t lstride, const uint32_t* right, int64_t rstride,
                                 const int64_t* consts, uint32_t* out, int64_t n, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  compress_pairs_kernel<<<(unsigned)grid_for(n, threads), threads, 0, stream>>>(left, lstride, right, rstride,
                                                                                consts, out, n);
  return (int)cudaGetLastError();
}
