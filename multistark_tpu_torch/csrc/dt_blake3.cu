// K7 dt_flush and K8 fri_grind: the Fiat-Shamir BLAKE3 duplex on the device.
//
// K7 replaces multistark_tpu/device_transcript.py DeviceDuplex._flush (the
// per-layout program built at :451-523: device chunk CVs, the root path over
// host sibling CVs, the four draws and their `< p` flags).  The byte splicing
// of device words into the chunk templates happens before the launch, as
// tensor indexing (device_transcript.py in this package); the host
// precomputes every other chunk's CV and the parent levels.  K7 hashes the
// 1-3 chunks that hold device bytes (one thread each), then one thread walks
// the parent plan to the root and writes the digest and the draws.  Bound on
// the card: latency.  About 50 serial compressions and two launches; neither
// the bytes nor the operations come near a microsecond.
//
// K8 replaces multistark_tpu/device_transcript.py grind_round and
// sample_ext_from_digest (:74-118), the per-round grind of pcs.py
// _device_round_kernel (:1183): the least w < 64·2^bits whose BLAKE3 digest
// of chain ‖ cap ‖ w_le8 has a canonical draw 0 with `bits` low zero bits,
// then from that digest β = draws 1..D and the found & valid flag, in one
// launch per round.  Every block hashes once what comes before the block
// that holds w (the chunks before w's chunk and that chunk's earlier
// blocks), so a candidate costs the compressions from w's block on (one on
// the bench's chain ‖ cap of 16 words); threads take their candidates in
// increasing order and stop once a smaller one has passed; the last block to
// arrive hashes the winner again and resets the round's words.  Bound on the
// card: latency, the round's dependent compressions (the prefix, a
// candidate, the winner) and the memory round trips between them (the
// input, the least witness, the arrival counter); the about 2^bits
// candidates a round needs are far fewer operations than that.
//
// Draw k of a digest d (the challenger pops bytes from the digest's end) is
// the u64 with low word bswap(d[7 - 2k]) and high word bswap(d[6 - 2k]); it is
// canonical, < p = 2^64 - 2^32 + 1, iff hi != 0xFFFFFFFF or lo == 0.
#include "blake3.cuh"

namespace {

__device__ __forceinline__ uint32_t bswap32(uint32_t x) { return __byte_perm(x, 0, 0x0123); }

__device__ __forceinline__ uint64_t draw(const uint32_t d[8], int k, bool* ok) {
  const uint32_t lo = bswap32(d[7 - 2 * k]), hi = bswap32(d[6 - 2 * k]);
  *ok = hi != 0xFFFFFFFFu || lo == 0;
  return (uint64_t)lo | ((uint64_t)hi << 32);
}

// ---- K7 -------------------------------------------------------------------

// The chaining value of one chunk of `nbytes` bytes (at most 1024), its words
// zero-padded past nbytes.
__device__ void chunk_cv_bytes(const uint32_t* words, int64_t nbytes, uint64_t counter, bool root, uint32_t cv[8]) {
  const int64_t n_blocks = nbytes == 0 ? 1 : (nbytes + 63) / 64;
#pragma unroll
  for (int i = 0; i < 8; i++) cv[i] = b3::IV[i];
  for (int64_t b = 0; b < n_blocks; b++) {
    uint32_t block[16];
#pragma unroll
    for (int i = 0; i < 16; i++) block[i] = words[16 * b + i];
    uint32_t flags = b == 0 ? b3::CHUNK_START : 0u;
    if (b == n_blocks - 1) flags |= b3::CHUNK_END | (root ? b3::ROOT : 0u);
    b3::compress(cv, block, counter, (uint32_t)b3::imin(64, nbytes - 64 * b), flags);
  }
}

// Plan (int32): [n_chunks, T, S, n_ops, root_src, T x (counter, nbytes),
// n_ops x (left_src, right_src, flags)].  A source s names a chaining value:
// s < T device chunk s, T <= s < T + S host sibling s - T, else the result of
// parent op s - T - S.  Chunk CVs and op results go to scratch rows 0..T-1
// and T..T + n_ops - 1.
constexpr int PLAN_HEAD = 5;

__global__ void flush_chunks_kernel(const uint32_t* __restrict__ chunks, const int32_t* __restrict__ plan,
                                    uint32_t* __restrict__ scratch) {
  const int64_t T = plan[1];
  const bool single = plan[0] == 1;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < T; t += (int64_t)gridDim.x * blockDim.x) {
    uint32_t cv[8];
    chunk_cv_bytes(chunks + 256 * t, plan[PLAN_HEAD + 2 * t + 1], (uint64_t)(uint32_t)plan[PLAN_HEAD + 2 * t],
                   single, cv);
#pragma unroll
    for (int i = 0; i < 8; i++) scratch[8 * t + i] = cv[i];
  }
}

__device__ __forceinline__ const uint32_t* cv_at(int32_t s, int64_t T, int64_t S, const uint32_t* sibs,
                                                 const uint32_t* scratch) {
  if (s < T) return scratch + 8 * (int64_t)s;
  if (s < T + S) return sibs + 8 * ((int64_t)s - T);
  return scratch + 8 * ((int64_t)s - S);
}

__global__ void flush_root_kernel(const int32_t* __restrict__ plan, const uint32_t* __restrict__ sibs,
                                  uint32_t* __restrict__ scratch, uint32_t* __restrict__ digest,
                                  uint64_t* __restrict__ draws) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  const int64_t T = plan[1], S = plan[2], n_ops = plan[3];
  const int32_t* ops = plan + PLAN_HEAD + 2 * T;
  for (int64_t j = 0; j < n_ops; j++) {
    const uint32_t* l = cv_at(ops[3 * j], T, S, sibs, scratch);
    const uint32_t* r = cv_at(ops[3 * j + 1], T, S, sibs, scratch);
    uint32_t block[16], cv[8];
#pragma unroll
    for (int i = 0; i < 8; i++) {
      block[i] = l[i];
      block[8 + i] = r[i];
      cv[i] = b3::IV[i];
    }
    b3::compress(cv, block, 0, 64, b3::PARENT | (uint32_t)ops[3 * j + 2]);
#pragma unroll
    for (int i = 0; i < 8; i++) scratch[8 * (T + j) + i] = cv[i];
  }
  const uint32_t* root = cv_at(plan[4], T, S, sibs, scratch);
  uint32_t d[8];
#pragma unroll
  for (int i = 0; i < 8; i++) d[i] = digest[i] = root[i];
  for (int k = 0; k < 4; k++) {
    bool ok;
    draws[k] = draw(d, k, &ok);
    draws[4 + k] = ok ? 1 : 0;
  }
}

// ---- K8 -------------------------------------------------------------------

constexpr int GRIND_THREADS = 128;
constexpr int GRIND_MAX_BLOCKS = 1024;

// Where w's low word (message word L of chain ‖ cap ‖ w_le8, T = L + 2
// words) falls: chunk c, block b of that chunk, word pos of that block.
struct GrindShape {
  int64_t L, T, c, chunk_words, n_chunks;
  int b, pos, extra;  // extra: a second block in chunk c (w's high word alone, when pos = 15)
  bool single, tail;  // one chunk in all; chunk c + 1 exists (w's high word alone, when L % 256 = 255)

  __device__ explicit GrindShape(int64_t L_) : L(L_), T(L_ + 2) {
    c = L / b3::CHUNK_WORDS;
    n_chunks = (T + b3::CHUNK_WORDS - 1) / b3::CHUNK_WORDS;
    chunk_words = b3::imin(b3::CHUNK_WORDS, T - c * b3::CHUNK_WORDS);
    b = (int)((L % b3::CHUNK_WORDS) / 16);
    pos = (int)(L % 16);
    extra = (int)((chunk_words + 15) / 16) - b - 1;
    single = n_chunks == 1;
    tail = c + 1 < n_chunks;
  }
};

// The part of every candidate's hash that does not depend on w, made once
// per block: the chunk-tree stack of the chunks before c, the chaining value
// entering block b of chunk c, that block's other words, and the chaining
// value of chunk c + 1 when it exists.
struct GrindPrefix {
  uint32_t stack[b3::MAX_STACK][8];
  uint32_t mid[8], fixed[16], tail[8];
  int depth;
};

// Warp 0 makes the prefix: lanes hash the whole chunks before c 32 at a time,
// lane 0 merges them into the stack and hashes the blocks of chunk c before b.
__device__ void grind_prefix(const uint32_t* __restrict__ inp, const GrindShape& sh, GrindPrefix& g,
                             uint32_t (*cvs)[8]) {
  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= 32) return;
  if (lane == 0) g.depth = 0;
  for (int64_t base = 0; base < sh.c; base += 32) {
    if (base + lane < sh.c)
      chunk_cv_bytes(inp + b3::CHUNK_WORDS * (base + lane), 4 * b3::CHUNK_WORDS, (uint64_t)(base + lane), false,
                     cvs[lane]);
    __syncwarp();
    if (lane == 0) {
      for (int64_t k = base; k < sh.c && k < base + 32; k++) {
        uint32_t out[8];
#pragma unroll
        for (int i = 0; i < 8; i++) out[i] = cvs[k - base][i];
        for (int64_t t = k + 1; (t & 1) == 0; t >>= 1) b3::parent(out, g.stack[--g.depth], 0);
#pragma unroll
        for (int i = 0; i < 8; i++) g.stack[g.depth][i] = out[i];
        g.depth++;
      }
    }
    __syncwarp();
  }
  if (lane != 0) return;
  const uint32_t* chunk = inp + b3::CHUNK_WORDS * sh.c;
#pragma unroll
  for (int i = 0; i < 8; i++) g.mid[i] = b3::IV[i];
  for (int blk = 0; blk < sh.b; blk++)
    b3::compress(g.mid, chunk + 16 * blk, (uint64_t)sh.c, 64, blk == 0 ? b3::CHUNK_START : 0u);
  for (int i = 0; i < 16; i++) {
    const int64_t k = b3::CHUNK_WORDS * sh.c + 16 * sh.b + i;
    g.fixed[i] = k < sh.L ? inp[k] : 0u;
  }
  if (sh.tail) {
    const uint32_t zero[16] = {};
    chunk_cv_bytes(zero, 4, (uint64_t)(sh.c + 1), false, g.tail);
  }
}

// The digest of chain ‖ cap ‖ w_le8 from the prefix: the block that holds w
// (its other words `fixed`, in registers), the block after it when w's high
// word spills into it, then the merges up the chunk tree.
__device__ __forceinline__ void grind_digest(const GrindShape& sh, const GrindPrefix& g, const uint32_t fixed[16],
                                             uint32_t w, uint32_t d[8]) {
  uint32_t block[16];
#pragma unroll
  for (int i = 0; i < 16; i++) block[i] = i == sh.pos ? w : fixed[i];
#pragma unroll
  for (int i = 0; i < 8; i++) d[i] = g.mid[i];
  const uint32_t end = b3::CHUNK_END | (sh.single ? b3::ROOT : 0u);
  b3::compress(d, block, (uint64_t)sh.c, (uint32_t)(4 * b3::imin(16, sh.chunk_words - 16 * sh.b)),
               (sh.b == 0 ? b3::CHUNK_START : 0u) | (sh.extra ? 0u : end));
  if (sh.extra) {
    const uint32_t zero[16] = {};
    b3::compress(d, zero, (uint64_t)sh.c, (uint32_t)(4 * (sh.chunk_words - 16 * (sh.b + 1))), end);
  }
  if (sh.single) return;
  int depth = g.depth;
  if (sh.tail) {
    for (int64_t t = sh.c + 1; (t & 1) == 0; t >>= 1) b3::parent(d, g.stack[--depth], 0);
    uint32_t r[8];
#pragma unroll
    for (int i = 0; i < 8; i++) r[i] = g.tail[i];
    b3::parent(r, d, depth == 0 ? b3::ROOT : 0u);
#pragma unroll
    for (int i = 0; i < 8; i++) d[i] = r[i];
  }
  while (depth > 0) {
    depth--;
    b3::parent(d, g.stack[depth], depth == 0 ? b3::ROOT : 0u);
  }
}

// One launch per round.  Each thread takes its candidates in increasing
// order and stops once a smaller passing one is known: the least passing
// candidate m is never skipped (the least known is >= m whenever its thread
// looks), so the result is the full search's, a miss included.  The least
// is kept complemented (atomicMax of ~w), so that 0 means none.  The last
// block to arrive hashes the winner again from the prefix, writes w, the
// flag and β, and sets both words back to 0.
__global__ void __launch_bounds__(GRIND_THREADS)
    fri_grind_kernel(const uint32_t* __restrict__ inp, int64_t L, uint32_t n, uint32_t mask, int D,
                     unsigned int* __restrict__ inv_best, unsigned int* __restrict__ arrived,
                     uint64_t* __restrict__ out, uint32_t* __restrict__ digest) {
  __shared__ GrindPrefix g;
  __shared__ uint32_t cvs[32][8];
  __shared__ bool last;
  const GrindShape sh(L);
  grind_prefix(inp, sh, g, cvs);
  __syncthreads();
  uint32_t fixed[16];
#pragma unroll
  for (int i = 0; i < 16; i++) fixed[i] = g.fixed[i];
  const volatile unsigned int* least = inv_best;
  const uint32_t first = blockIdx.x * blockDim.x + threadIdx.x;
  for (uint32_t w = first; w < n; w += gridDim.x * blockDim.x) {
    if (w != first && ~*least < w) break;  // a smaller candidate passed (the first is hashed regardless)
    uint32_t d[8];
    grind_digest(sh, g, fixed, w, d);
    bool canonical;
    const uint64_t v = draw(d, 0, &canonical);
    if (canonical && ((uint32_t)v & mask) == 0) atomicMax(inv_best, ~w);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(arrived, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || threadIdx.x != 0) return;
  __threadfence();
  const unsigned int inv = *least;
  const uint32_t w = ~inv;
  uint32_t d[8];
  grind_digest(sh, g, fixed, inv ? w : 0u, d);
  bool valid = true;
  for (int k = 0; k < D; k++) {
    bool ok;
    out[2 + k] = draw(d, k + 1, &ok);
    valid = valid && ok;
  }
  out[0] = inv ? w : 0u;
  out[1] = (inv && valid) ? 1 : 0;
#pragma unroll
  for (int i = 0; i < 8; i++) digest[i] = d[i];
  *inv_best = 0;
  *arrived = 0;
}

unsigned blocks_for(int64_t n, int threads) {
  const int64_t blocks = (n + threads - 1) / threads;
  return (unsigned)(blocks < 1 ? 1 : (blocks > (1 << 16) ? (1 << 16) : blocks));
}

}  // namespace

extern "C" {

// One duplex flush: chunk CVs of the T spliced chunks (256 words each), then
// the plan's parent ops to the root.  scratch holds (T + n_ops) x 8 words;
// digest receives 8 words, draws the four draws then their four `< p` flags.
int dt_flush(const uint32_t* chunks, const int32_t* plan, const uint32_t* sibs, uint32_t* scratch, int64_t T,
             uint32_t* digest, uint64_t* draws, cudaStream_t stream) {
  if (T <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 32;
  flush_chunks_kernel<<<blocks_for(T, threads), threads, 0, stream>>>(chunks, plan, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flush_root_kernel<<<1, 1, 0, stream>>>(plan, sibs, scratch, digest, draws);
  return (int)cudaGetLastError();
}

// The FRI commit-phase grind: out (8 u64) gets [w, ok, β_0 .. β_{D-1}];
// digest (8 u32) becomes the next round's chain; words: two words of a
// counter buffer, 0 on entry and on return.  One launch, sized so that its
// first wave covers 16·2^bits candidates.
int fri_grind(const uint32_t* inp, int64_t L, int bits, int D, uint64_t* out, uint32_t* digest,
              unsigned long long* words, cudaStream_t stream) {
  if (L <= 0 || bits < 0 || bits > 24 || D < 1 || D > 3) return (int)cudaErrorInvalidValue;
  const uint32_t n = 64u << bits, mask = bits == 0 ? 0u : (uint32_t)((1u << bits) - 1u);
  const int64_t first = (int64_t)16 << bits < n ? (int64_t)16 << bits : n;
  const int64_t want = (first + GRIND_THREADS - 1) / GRIND_THREADS;
  const unsigned blocks = (unsigned)(want < GRIND_MAX_BLOCKS ? want : GRIND_MAX_BLOCKS);
  unsigned int* w32 = reinterpret_cast<unsigned int*>(words);
  fri_grind_kernel<<<blocks, GRIND_THREADS, 0, stream>>>(inp, L, n, mask, D, w32, w32 + 2, out, digest);
  return (int)cudaGetLastError();
}

}  // extern "C"
