// K3 blake3_merkle: BLAKE3 leaf hashing of field-matrix rows and the Merkle
// 2-to-1 compression.
//
// Replaces multistark_tpu/hash/blake3.py compress_batch, hash_word_cols,
// _chunk_cv_cols, _tree and compress_planes, and the hashing inside
// multistark_tpu/merkle.py Blake3FieldHasher.hash_matrices / compress /
// MerkleMmcs._commit_impl.
//
// Leaf convention (merkle.py:44-55): a leaf hashes the rows of every matrix
// of one height, concatenated in matrix order, each element as its u64
// little-endian bytes (two u32 words, low word first), with the full BLAKE3
// algorithm: rows longer than 1024 bytes go through the chunk tree.  A Merkle
// node is blake3(left || right) over 64 bytes: one compression with
// CHUNK_START | CHUNK_END | ROOT.  Digests are 8 u32 words, little-endian.
//
// Bound on the card: integer ALU.  One compression is ~7 rounds x 8 G
// functions (~700 32-bit ops) per 64 bytes read, well above the HBM line.
// Design: one thread per row (hash_rows) or per node (compress_pairs), the
// whole 16-word state in registers; each thread reads column-major matrix
// elements, so neighbouring threads (neighbouring rows) read neighbouring
// addresses.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__constant__ uint32_t IV[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
                            0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u};
constexpr uint32_t CHUNK_START = 1, CHUNK_END = 2, PARENT = 4, ROOT = 8;
constexpr int64_t CHUNK_WORDS = 256;  // 1024 bytes
constexpr int MAX_STACK = 24;         // chunk-tree depth: rows up to 2^24 chunks

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

__device__ __forceinline__ void g(uint32_t* s, int a, int b, int c, int d, uint32_t mx, uint32_t my) {
  s[a] = s[a] + s[b] + mx;
  s[d] = rotr(s[d] ^ s[a], 16);
  s[c] = s[c] + s[d];
  s[b] = rotr(s[b] ^ s[c], 12);
  s[a] = s[a] + s[b] + my;
  s[d] = rotr(s[d] ^ s[a], 8);
  s[c] = s[c] + s[d];
  s[b] = rotr(s[b] ^ s[c], 7);
}

// One BLAKE3 compression; cv is replaced by the first 8 output words.
__device__ __forceinline__ void compress(uint32_t cv[8], const uint32_t block[16], uint64_t counter,
                                         uint32_t block_len, uint32_t flags) {
  uint32_t s[16], m[16];
#pragma unroll
  for (int i = 0; i < 8; i++) s[i] = cv[i];
  s[8] = IV[0];
  s[9] = IV[1];
  s[10] = IV[2];
  s[11] = IV[3];
  s[12] = (uint32_t)counter;
  s[13] = (uint32_t)(counter >> 32);
  s[14] = block_len;
  s[15] = flags;
#pragma unroll
  for (int i = 0; i < 16; i++) m[i] = block[i];
#pragma unroll
  for (int r = 0; r < 7; r++) {
    g(s, 0, 4, 8, 12, m[0], m[1]);
    g(s, 1, 5, 9, 13, m[2], m[3]);
    g(s, 2, 6, 10, 14, m[4], m[5]);
    g(s, 3, 7, 11, 15, m[6], m[7]);
    g(s, 0, 5, 10, 15, m[8], m[9]);
    g(s, 1, 6, 11, 12, m[10], m[11]);
    g(s, 2, 7, 8, 13, m[12], m[13]);
    g(s, 3, 4, 9, 14, m[14], m[15]);
    if (r < 6) {  // message permutation (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)
      const uint32_t t[16] = {m[2], m[6], m[3], m[10], m[7], m[0], m[4], m[13],
                              m[1], m[11], m[12], m[5], m[9], m[14], m[15], m[8]};
#pragma unroll
      for (int i = 0; i < 16; i++) m[i] = t[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 8; i++) cv[i] = s[i] ^ s[i + 8];
}

__device__ __forceinline__ void parent(uint32_t out[8], const uint32_t left[8], uint32_t flags) {
  uint32_t block[16];
#pragma unroll
  for (int i = 0; i < 8; i++) {
    block[i] = left[i];
    block[8 + i] = out[i];
  }
#pragma unroll
  for (int i = 0; i < 8; i++) out[i] = IV[i];
  compress(out, block, 0, 64, PARENT | flags);
}

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

__global__ void hash_rows_kernel(MatList mats, int64_t n, int64_t total_words, uint32_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t n_chunks = total_words <= CHUNK_WORDS ? 1 : (total_words + CHUNK_WORDS - 1) / CHUNK_WORDS;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; row < n; row += stride) {
    RowWords words{&mats, n, row, 0, 0, 0, 0};
    uint32_t stack[MAX_STACK][8];
    int depth = 0;
    uint32_t cv[8];
    for (int64_t chunk = 0; chunk < n_chunks; chunk++) {
      const int64_t chunk_words = imin(CHUNK_WORDS, total_words - chunk * CHUNK_WORDS);
      const int64_t n_blocks = (chunk_words + 15) / 16;
#pragma unroll
      for (int i = 0; i < 8; i++) cv[i] = IV[i];
      for (int64_t b = 0; b < n_blocks; b++) {
        const int64_t block_words = imin(16, chunk_words - b * 16);
        uint32_t block[16];
#pragma unroll
        for (int i = 0; i < 16; i++) block[i] = i < block_words ? words.next() : 0u;
        uint32_t flags = b == 0 ? CHUNK_START : 0u;
        if (b == n_blocks - 1) flags |= CHUNK_END | (n_chunks == 1 ? ROOT : 0u);
        compress(cv, block, (uint64_t)chunk, (uint32_t)(block_words * 4), flags);
      }
      if (chunk + 1 < n_chunks) {
        // merge completed subtrees: the BLAKE3 spec's left-largest-power-of-
        // two tree, built incrementally from the chunk count
        for (int64_t t = chunk + 1; (t & 1) == 0; t >>= 1) parent(cv, stack[--depth], 0);
#pragma unroll
        for (int i = 0; i < 8; i++) stack[depth][i] = cv[i];
        depth++;
      }
    }
    while (depth > 0) {
      depth--;
      parent(cv, stack[depth], depth == 0 ? ROOT : 0u);
    }
#pragma unroll
    for (int i = 0; i < 8; i++) out[row * 8 + i] = cv[i];
  }
}

__global__ void compress_pairs_kernel(const uint32_t* __restrict__ left, int64_t lstride,
                                      const uint32_t* __restrict__ right, int64_t rstride,
                                      uint32_t* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    uint32_t block[16], cv[8];
#pragma unroll
    for (int k = 0; k < 8; k++) {
      block[k] = left[i * lstride + k];
      block[8 + k] = right[i * rstride + k];
      cv[k] = IV[k];
    }
    compress(cv, block, 0, 64, CHUNK_START | CHUNK_END | ROOT);
#pragma unroll
    for (int k = 0; k < 8; k++) out[i * 8 + k] = cv[k];
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
  hash_rows_kernel<<<(unsigned)grid_for(n, threads), threads, 0, stream>>>(mats, n, total_words, out);
  return (int)cudaGetLastError();
}

// out[i] = blake3(left[i] || right[i]) for n digest pairs; left/right rows
// are 8 u32 words, `lstride`/`rstride` words apart.
extern "C" int b3_compress_pairs(const uint32_t* left, int64_t lstride, const uint32_t* right, int64_t rstride,
                                 uint32_t* out, int64_t n, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  compress_pairs_kernel<<<(unsigned)grid_for(n, threads), threads, 0, stream>>>(left, lstride, right, rstride, out, n);
  return (int)cudaGetLastError();
}
