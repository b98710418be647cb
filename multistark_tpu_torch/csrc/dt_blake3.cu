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
// _device_round_kernel (:1183): hash chain ‖ cap ‖ w_le8 for every candidate
// w < 64·2^bits in parallel, keep the least w whose draw 0 is canonical with
// `bits` low zero bits (atomicMin), then from the winning digest take β =
// draws 1..D and the found & valid flag.  Bound on the card: integer ALU,
// 65,536 candidates of two compressions each at 10 bits.
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

// The words of chain ‖ cap ‖ w_le8: L input words, then w's low and high word.
struct GrindWords {
  const uint32_t* inp;
  int64_t L;
  uint32_t w;
  int64_t i;

  __device__ __forceinline__ uint32_t next() {
    const int64_t k = i++;
    return k < L ? inp[k] : (k == L ? w : 0u);
  }
};

__device__ __forceinline__ void grind_digest(const uint32_t* inp, int64_t L, uint32_t w, uint32_t d[8]) {
  GrindWords src{inp, L, w, 0};
  b3::hash_words(src, L + 2, d);
}

__global__ void grind_search_kernel(const uint32_t* __restrict__ inp, int64_t L, int64_t n, uint32_t mask,
                                    unsigned int* __restrict__ best) {
  for (int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; c < n; c += (int64_t)gridDim.x * blockDim.x) {
    uint32_t d[8];
    grind_digest(inp, L, (uint32_t)c, d);
    bool canonical;
    const uint64_t v = draw(d, 0, &canonical);
    if (canonical && ((uint32_t)v & mask) == 0) atomicMin(best, (unsigned int)c);
  }
}

// out: [w, found & valid, β_0 .. β_{D-1}, ..., scratch]; digest: the winning
// candidate's digest (candidate 0's when none passed).
__global__ void grind_finish_kernel(const uint32_t* __restrict__ inp, int64_t L, int D,
                                    const unsigned int* __restrict__ best, uint64_t* __restrict__ out,
                                    uint32_t* __restrict__ digest) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  const bool found = *best != 0xFFFFFFFFu;
  const uint32_t w = found ? *best : 0u;
  uint32_t d[8];
  grind_digest(inp, L, w, d);
  bool valid = true;
  for (int k = 0; k < D; k++) {
    bool ok;
    out[2 + k] = draw(d, k + 1, &ok);
    valid = valid && ok;
  }
  out[0] = w;
  out[1] = (found && valid) ? 1 : 0;
#pragma unroll
  for (int i = 0; i < 8; i++) digest[i] = d[i];
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

// The FRI commit-phase grind: out (8 u64) gets [w, ok, β_0 .. β_{D-1}] and
// uses out[7] as scratch; digest (8 u32) becomes the next round's chain.
int fri_grind(const uint32_t* inp, int64_t L, int bits, int D, uint64_t* out, uint32_t* digest,
              cudaStream_t stream) {
  if (L <= 0 || bits < 0 || bits > 24 || D < 1 || D > 3) return (int)cudaErrorInvalidValue;
  unsigned int* best = reinterpret_cast<unsigned int*>(out + 7);
  cudaError_t err = cudaMemsetAsync(best, 0xFF, sizeof(unsigned int), stream);
  if (err != cudaSuccess) return (int)err;
  const int64_t n = (int64_t)64 << bits;
  const uint32_t mask = bits == 0 ? 0u : (uint32_t)((1u << bits) - 1u);
  const int threads = 128;
  grind_search_kernel<<<blocks_for(n, threads), threads, 0, stream>>>(inp, L, n, mask, best);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  grind_finish_kernel<<<1, 1, 0, stream>>>(inp, L, D, best, out, digest);
  return (int)cudaGetLastError();
}

}  // extern "C"
