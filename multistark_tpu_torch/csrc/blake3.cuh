// The BLAKE3 compression and the streaming hash of a word message, as device
// functions: the body that K3 blake3_merkle (row hashing, Merkle nodes) and
// K7 dt_flush / K8 fri_grind (the Fiat-Shamir duplex) share.
//
// Digests and message words are u32, little-endian; a message is a whole
// number of words (every caller hashes u64 field elements or u32 digest
// words).  Messages longer than one 1024-byte chunk go through the chunk
// tree (the BLAKE3 spec's left-largest-power-of-two tree, built
// incrementally from the chunk count).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace b3 {
namespace {  // internal linkage: every source that includes this keeps its own copy

__constant__ uint32_t IV[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
                               0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u};
constexpr uint32_t CHUNK_START = 1, CHUNK_END = 2, PARENT = 4, ROOT = 8;
constexpr int64_t CHUNK_WORDS = 256;  // 1024 bytes
constexpr int MAX_STACK = 24;         // chunk-tree depth: messages up to 2^24 chunks

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

// out = parent(left, out): the parent node over two chaining values.
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

// The chaining value of one chunk of `chunk_words` words (at most 256) pulled
// from src, with the chunk counter `counter`; ROOT on its last block when the
// chunk is the whole message.
template <class Src>
__device__ __forceinline__ void chunk_cv(Src& src, int64_t chunk_words, uint64_t counter, bool root,
                                         uint32_t cv[8]) {
  const int64_t n_blocks = chunk_words == 0 ? 1 : (chunk_words + 15) / 16;
#pragma unroll
  for (int i = 0; i < 8; i++) cv[i] = IV[i];
  for (int64_t b = 0; b < n_blocks; b++) {
    const int64_t block_words = imin(16, chunk_words - b * 16);
    uint32_t block[16];
#pragma unroll
    for (int i = 0; i < 16; i++) block[i] = i < block_words ? src.next() : 0u;
    uint32_t flags = b == 0 ? CHUNK_START : 0u;
    if (b == n_blocks - 1) flags |= CHUNK_END | (root ? ROOT : 0u);
    compress(cv, block, counter, (uint32_t)(block_words * 4), flags);
  }
}

// Full BLAKE3 of a message of WORDS u32 words (at most one 1024-byte chunk)
// held in registers: straight-line compressions, no chunk-tree stack.
template <int WORDS>
__device__ __forceinline__ void hash_chunk(const uint32_t (&m)[WORDS], uint32_t out[8]) {
  static_assert(WORDS > 0 && WORDS <= CHUNK_WORDS, "one chunk");
  constexpr int BLOCKS = (WORDS + 15) / 16;
#pragma unroll
  for (int i = 0; i < 8; i++) out[i] = IV[i];
#pragma unroll
  for (int b = 0; b < BLOCKS; b++) {
    constexpr int LAST = WORDS - 16 * (BLOCKS - 1);
    uint32_t block[16];
#pragma unroll
    for (int i = 0; i < 16; i++) block[i] = 16 * b + i < WORDS ? m[16 * b + i < WORDS ? 16 * b + i : 0] : 0u;
    const uint32_t flags = (b == 0 ? CHUNK_START : 0u) | (b == BLOCKS - 1 ? CHUNK_END | ROOT : 0u);
    compress(out, block, 0, b == BLOCKS - 1 ? 4 * LAST : 64, flags);
  }
}

// Full BLAKE3 of a message of `total_words` u32 words pulled in order from
// src.next().
template <class Src>
__device__ __forceinline__ void hash_words(Src& src, int64_t total_words, uint32_t out[8]) {
  const int64_t n_chunks = total_words <= CHUNK_WORDS ? 1 : (total_words + CHUNK_WORDS - 1) / CHUNK_WORDS;
  uint32_t stack[MAX_STACK][8];
  int depth = 0;
  for (int64_t chunk = 0; chunk < n_chunks; chunk++) {
    chunk_cv(src, imin(CHUNK_WORDS, total_words - chunk * CHUNK_WORDS), (uint64_t)chunk, n_chunks == 1, out);
    if (chunk + 1 < n_chunks) {
      // merge completed subtrees: the left-largest-power-of-two tree, built
      // incrementally from the chunk count
      for (int64_t t = chunk + 1; (t & 1) == 0; t >>= 1) parent(out, stack[--depth], 0);
#pragma unroll
      for (int i = 0; i < 8; i++) stack[depth][i] = out[i];
      depth++;
    }
  }
  while (depth > 0) {
    depth--;
    parent(out, stack[depth], depth == 0 ? ROOT : 0u);
  }
}

}  // namespace
}  // namespace b3
