// K3 blake3_merkle: BLAKE3 leaf hashing of field-matrix rows, and a FRI
// round's committed matrix with its leaves.
//
// Replaces multistark_tpu/hash/blake3.py compress_batch, hash_word_cols,
// _chunk_cv_cols and _tree, and the leaf hashing inside
// multistark_tpu/merkle.py Blake3FieldHasher.hash_matrices for the trees
// that are not LDE commits (the FRI rounds' and any MerkleMmcs.commit); the
// Merkle 2-to-1 runs in K14 / K15 (commit_tile.cu).
//
// Leaf convention (merkle.py:44-55): a leaf hashes the rows of every matrix
// of one height, concatenated in matrix order, each element as its u64
// little-endian bytes (two u32 words, low word first), with the full BLAKE3
// algorithm: rows longer than 1024 bytes go through the chunk tree.  Digests
// are 8 u32 words, little-endian.
//
// Bound on the card: integer ALU.  One compression is ~7 rounds x 8 G
// functions (~700 32-bit ops) per 64 bytes read, well above the HBM line.
// Design: one thread per row, the whole 16-word state in registers; each
// thread reads column-major matrix elements, so neighbouring threads
// (neighbouring rows) read neighbouring addresses.  A row of at most one
// chunk (1024 bytes) hashes without the chunk-tree stack; wider rows take
// the streaming hash.  The compression and the streaming hash are
// blake3.cuh's, which K7 and K8 (dt_blake3.cu) and K14 / K15 share.
//
// The FRI entry (b3_fri_leaves) replaces the layout copy and the leaf hash
// of a FRI round's tree (multistark_tpu/pcs.py:1336 _ext_slices_matrix, then
// merkle.py:44 hash_matrices): from the round's coordinate-major (D, N) fold
// vector it writes the committed (A·D, N/A) matrix, row j·D + d = coordinate
// d of vec[j::A], and its N/A leaf digests in one launch.  A thread per
// leaf: its A·D values with 16-byte loads (thread n reads vec[d][n·A ..
// n·A + A - 1], neighbours on neighbouring addresses), the matrix stored row
// by row (coalesced across threads), the leaf hashed as one chunk in
// straight-line code with the message in registers, the digest stored as two
// 16-byte words.  Blocks of 32 to 128 threads, as few as spread the leaves
// over every SM.
#include "blake3.cuh"

namespace {

using b3::CHUNK_WORDS;
using b3::MAX_STACK;

// Up to MAX_MATS same-height matrices, passed by value.
constexpr int MAX_MATS = 16;
struct MatList {
  const uint64_t* ptr[MAX_MATS];
  int64_t width[MAX_MATS];
  int count;
};

// Streams the u32 words of one row: matrix by matrix, column by column,
// each u64 element as (low word, high word).
struct RowWords {
  const MatList* mats;
  int64_t n, row;
  int mat;
  int64_t col;
  int half;
  uint64_t cur;

  __device__ __forceinline__ uint32_t next() {
    if (half == 0) {
      while (col >= mats->width[mat]) {
        mat++;
        col = 0;
      }
      cur = mats->ptr[mat][col * n + row];
      half = 1;
      return (uint32_t)cur;
    }
    half = 0;
    col++;
    return (uint32_t)(cur >> 32);
  }
};

// MULTI: rows longer than one chunk (the chunk tree); else one chunk, no stack.
template <bool MULTI>
__global__ void b3_hash_rows_kernel(MatList mats, int64_t n, int64_t total_words, uint32_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; row < n; row += stride) {
    RowWords words{&mats, n, row, 0, 0, 0, 0};
    uint32_t cv[8];
    if constexpr (MULTI)
      b3::hash_words(words, total_words, cv);
    else
      b3::chunk_cv(words, total_words, 0, true, cv);
    uint4* o = reinterpret_cast<uint4*>(out + row * 8);
    o[0] = make_uint4(cv[0], cv[1], cv[2], cv[3]);
    o[1] = make_uint4(cv[4], cv[5], cv[6], cv[7]);
  }
}

int64_t grid_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  return blocks > (1 << 20) ? (1 << 20) : blocks;
}

// One leaf per thread: A values of each of D coordinates (A = 2^A_BITS).
template <int A_BITS, int D>
__global__ void b3_fri_leaves_kernel(const uint64_t* __restrict__ vec, uint32_t M, uint64_t* __restrict__ mat,
                                     uint32_t* __restrict__ leaves) {
  constexpr int A = 1 << A_BITS;
  const uint32_t n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= M) return;
  const uint64_t N = (uint64_t)M * A;
  uint64_t v[A][D];  // v[j][d] = vec[d][n·A + j]
#pragma unroll
  for (int d = 0; d < D; d++) {
    const ulonglong2* src = reinterpret_cast<const ulonglong2*>(vec + d * N + (uint64_t)n * A);
#pragma unroll
    for (int j = 0; j < A; j += 2) {
      const ulonglong2 t = src[j / 2];
      v[j][d] = t.x;
      v[j + 1][d] = t.y;
    }
  }
#pragma unroll
  for (int j = 0; j < A; j++)
#pragma unroll
    for (int d = 0; d < D; d++) mat[(uint64_t)(j * D + d) * M + n] = v[j][d];
  uint32_t m[2 * A * D];  // the row's elements in order, each as (low word, high word)
#pragma unroll
  for (int j = 0; j < A; j++)
#pragma unroll
    for (int d = 0; d < D; d++) {
      m[2 * (j * D + d)] = (uint32_t)v[j][d];
      m[2 * (j * D + d) + 1] = (uint32_t)(v[j][d] >> 32);
    }
  uint32_t cv[8];
  b3::hash_chunk<2 * A * D>(m, cv);
  uint4* o = reinterpret_cast<uint4*>(leaves + (uint64_t)n * 8);
  o[0] = make_uint4(cv[0], cv[1], cv[2], cv[3]);
  o[1] = make_uint4(cv[4], cv[5], cv[6], cv[7]);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

template <int A_BITS, int D>
int fri_leaves_launch(const uint64_t* vec, uint32_t M, uint64_t* mat, uint32_t* leaves, cudaStream_t stream) {
  // 32 to 128 threads a block, as few as give every SM a block
  const int64_t per_sm = ((int64_t)M + sm_count() - 1) / sm_count();
  const int threads = per_sm >= 128 ? 128 : (int)((per_sm + 31) / 32 * 32);
  b3_fri_leaves_kernel<A_BITS, D><<<(unsigned)((M + threads - 1) / threads), threads, 0, stream>>>(vec, M, mat,
                                                                                                   leaves);
  return (int)cudaGetLastError();
}

}  // namespace

// Row digests of the concatenation of `count` same-height (w_j, n) matrices:
// out is (n, 8) u32.
extern "C" int b3_hash_rows(const uint64_t* const* ptrs, const int64_t* widths, int count, int64_t n,
                            uint32_t* out, cudaStream_t stream) {
  if (count <= 0 || count > MAX_MATS || n <= 0) return (int)cudaErrorInvalidValue;
  MatList mats;
  int64_t total_words = 0;
  for (int j = 0; j < MAX_MATS; j++) {
    mats.ptr[j] = j < count ? ptrs[j] : nullptr;
    mats.width[j] = j < count ? widths[j] : 0;
    total_words += 2 * mats.width[j];
  }
  mats.count = count;
  if (total_words <= 0 || (total_words + CHUNK_WORDS - 1) / CHUNK_WORDS > ((int64_t)1 << (MAX_STACK - 1)))
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  if (total_words <= CHUNK_WORDS)
    b3_hash_rows_kernel<false><<<(unsigned)grid_for(n, threads), threads, 0, stream>>>(mats, n, total_words, out);
  else
    b3_hash_rows_kernel<true><<<(unsigned)grid_for(n, threads), threads, 0, stream>>>(mats, n, total_words, out);
  return (int)cudaGetLastError();
}

// A FRI round's level: vec is the (D, M·2^a_bits) coordinate-major fold
// vector (16-byte aligned; D = 2, GoldilocksBlake3's GL2); writes mat
// (2^a_bits·D, M) and leaves (M, 8) u32.
extern "C" int b3_fri_leaves(const uint64_t* vec, int D, int a_bits, int64_t M, uint64_t* mat, uint32_t* leaves,
                             cudaStream_t stream) {
  if (D != 2 || M <= 0 || M >= ((int64_t)1 << 31) || ((uintptr_t)vec & 15)) return (int)cudaErrorInvalidValue;
  const uint32_t m = (uint32_t)M;
  switch (a_bits) {
    case 1: return fri_leaves_launch<1, 2>(vec, m, mat, leaves, stream);
    case 2: return fri_leaves_launch<2, 2>(vec, m, mat, leaves, stream);
    case 3: return fri_leaves_launch<3, 2>(vec, m, mat, leaves, stream);
    case 4: return fri_leaves_launch<4, 2>(vec, m, mat, leaves, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
