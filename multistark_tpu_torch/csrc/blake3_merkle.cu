// K3 blake3_merkle: BLAKE3 leaf hashing of field-matrix rows.
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
// (neighbouring rows) read neighbouring addresses.  The compression and the
// streaming hash are blake3.cuh's, which K7 and K8 (dt_blake3.cu) and K14 /
// K15 share.
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

__global__ void b3_hash_rows_kernel(MatList mats, int64_t n, int64_t total_words, uint32_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; row < n; row += stride) {
    RowWords words{&mats, n, row, 0, 0, 0, 0};
    uint32_t cv[8];
    b3::hash_words(words, total_words, cv);
#pragma unroll
    for (int i = 0; i < 8; i++) out[row * 8 + i] = cv[i];
  }
}

int64_t grid_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  return blocks > (1 << 20) ? (1 << 20) : blocks;
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
  b3_hash_rows_kernel<<<(unsigned)grid_for(n, threads), threads, 0, stream>>>(mats, n, total_words, out);
  return (int)cudaGetLastError();
}
