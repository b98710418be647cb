// K14 lde_tile and K15 merkle_levels: the stage and quotient commit (a coset
// LDE stored bit-reversed, then its mixed-height Merkle tree up to the cap)
// in two kernels of its own.
//
// Replaces multistark_tpu/pcs.py _fused_stage_commit (one jitted program per
// commit: ntt/ntt.py coset_lde_bitrev or lde_bitrev_from_coeffs for every
// matrix, then merkle.py _commit_impl), and the compress loop of
// merkle.py _commit_impl for every other tree (the FRI rounds').
//
// K14 lde_tile.  A DIF from natural order writes bit-reversed storage, and
// its last k stages touch only blocks of 2^k contiguous storage positions;
// Merkle leaf pairs (2i, 2i+1) are adjacent storage positions too.  So one
// block owns a tile of T = 2^k contiguous positions of every column of a
// (cols, n) column-major batch (the same-height matrices of a commit,
// stacked): it loads the tile into dynamic shared memory (cols coalesced
// strips, 16-byte cp.async copies), runs stages k..1, writes the finished
// LDE tile back, hashes each row from shared memory (one thread per row;
// BLAKE3 over each u64 as low word then high word, column by column, as K3
// does; or the Poseidon2 rate-8 sponge, as K6 does), and compresses the
// tile's digests upward `levels` levels, writing every digest layer.  At a
// level where a shorter group's rows are injected, a node is
// compress(compress(left, right), leaf digest of the shorter rows), as
// merkle.py _commit_impl does.  With hashing off the same body is the
// small-span tail of any DIF, and in DIT mode the first k stages of a DIT
// (bit-reversed input: its low stages touch the same contiguous blocks).
// The stages above the tile run in K2 passes (ntt_stage.cu).
//
// K15 merkle_levels.  One block loads 2^fold nodes (fold <= 10) of a digest
// layer into shared memory and folds them through `fold` levels, writing
// every layer and applying the injections of those levels; the host loops
// launches until the layer has 2^cap_height nodes.
//
// Bound on the card: integer ALU for the hashing (a BLAKE3 compression is
// ~780 32-bit operations per 64 bytes, a Poseidon2 permutation ~4600 per 32
// to 64 bytes); the tile's k stages add k field products per element while
// reading and writing each element once, instead of k HBM passes; both are
// Goldilocks or BabyBear integer work, as in K2.  Design: the host sizes
// the tile (commit_tile.tile_log_for) so that at least three blocks share
// an SM, with at most a row per thread when hashing (the GoldilocksBlake3
// stage-1 tile, 2^8 rows of 14 columns, takes 37 KB), so one block's copies
// overlap another's stages and hashing, and folds inside the tile only the
// levels that keep a warp busy (K15 folds the rest).  The tile's stages run
// in phases of up to four, each thread holding 2^4 elements of a column in
// registers (as K2 does), with a barrier between phases; the tile's
// shared-memory layout is swizzled (`swz`) so that the bottom phase, whose
// threads each walk 16 contiguous positions, meets at most 2-way bank
// conflicts.  A level's node i is written
// into the slot of its left child (position i << level), which no other
// thread reads at that level, so the levels need no second buffer.  Digests
// move through shared and global memory as 16-byte vectors.
#include "blake3.cuh"
#include "field.cuh"
#include "poseidon2.cuh"

namespace {

constexpr int TILE_THREADS = 256;
constexpr int MAX_TILE_LOG = 16;
constexpr int LEVEL_THREADS = 512;
constexpr int MAX_FOLD_LOG = 10;
// K14's modes (commit_tile.py MODE_*): a DIF's last k stages; the same,
// then the leaf hash and the fold; a DIT's first k stages.
constexpr int MODE_DIF = 0, MODE_HASHED = 1, MODE_DIT = 2;
constexpr int PHASE_LOG = 4;  // the tile's stages run in phases of up to four, from bits 0, 4, 8, ...

// The digest layers a launch writes and the digests injected into them:
// out[l] is level l counted from the launch's input (out[0] the leaves, for
// K14), inj[l] the leaf digests of the rows injected at level l or nullptr.
struct Levels {
  uint32_t* out[MAX_TILE_LOG + 1];
  const uint32_t* inj[MAX_TILE_LOG + 1];
  int levels;
};

__device__ __forceinline__ void load8(const uint32_t* p, uint32_t d[8]) {
  const uint4 a = reinterpret_cast<const uint4*>(p)[0], b = reinterpret_cast<const uint4*>(p)[1];
  d[0] = a.x, d[1] = a.y, d[2] = a.z, d[3] = a.w, d[4] = b.x, d[5] = b.y, d[6] = b.z, d[7] = b.w;
}

__device__ __forceinline__ void store8(uint32_t* p, const uint32_t d[8]) {
  reinterpret_cast<uint4*>(p)[0] = make_uint4(d[0], d[1], d[2], d[3]);
  reinterpret_cast<uint4*>(p)[1] = make_uint4(d[4], d[5], d[6], d[7]);
}

// 16 bytes from global to shared memory without a register round trip; the
// copies of a thread complete at cp_async_wait_all.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
#else
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
#endif
}

__device__ __forceinline__ void cp_async_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
#endif
}

// The tile's shared-memory layout: element e (column e >> k, position
// e & (T - 1)) sits at swz(e), which permutes each aligned run of 16
// elements (bits 1-3 XORed with bits 4-6) and keeps 16-byte pairs whole: a
// thread that walks 16 contiguous positions (the bottom stage phase) meets
// at most a 2-way bank conflict, and neighbouring threads on neighbouring
// positions none.
__device__ __forceinline__ int swz(int e) { return e ^ (((e >> 4) & 7) << 1); }

// The tile's slots: its elements rounded up to whole runs of 16, which swz
// maps onto themselves.
__host__ __device__ __forceinline__ int tile_slots(int cells) { return (cells + 15) & ~15; }

// The u32 words of tile row j: column by column, each u64 element as (low
// word, high word): K3's RowWords order over the stacked columns.
struct TileWords {
  const uint64_t* tile;
  int e;       // the row's element in the current column
  int stride;  // elements between columns (the tile size)
  int half;
  uint64_t cur;

  __device__ __forceinline__ uint32_t next() {
    if (half == 0) {
      cur = tile[swz(e)];
      half = 1;
      return (uint32_t)cur;
    }
    half = 0;
    e += stride;
    return (uint32_t)(cur >> 32);
  }
};

struct Blake3Hasher {
  static constexpr int CONSTS = 0;
  static __device__ __forceinline__ void leaf(const uint64_t* tile, int j, int T, int cols, uint32_t out[8],
                                              const uint32_t*) {
    TileWords words{tile, j, T, 0, 0};
    b3::hash_words(words, 2 * (int64_t)cols, out);
  }
  static __device__ __forceinline__ void node(const uint32_t l[8], const uint32_t r[8], uint32_t out[8],
                                              const uint32_t*) {
    uint32_t block[16];
#pragma unroll
    for (int k = 0; k < 8; k++) {
      block[k] = l[k];
      block[8 + k] = r[k];
      out[k] = b3::IV[k];
    }
    b3::compress(out, block, 0, 64, b3::CHUNK_START | b3::CHUNK_END | b3::ROOT);
  }
};

struct Poseidon2Hasher {
  static constexpr int CONSTS = p2::N_CONST;
  static __device__ __forceinline__ void leaf(const uint64_t* tile, int j, int T, int cols, uint32_t out[8],
                                              const uint32_t* sc) {
    uint32_t s[p2::WIDTH];
#pragma unroll
    for (int i = 0; i < p2::WIDTH; i++) s[i] = 0;
    for (int c0 = 0; c0 < cols; c0 += p2::RATE) {  // a short last chunk keeps lanes cols - c0 .. 15
#pragma unroll
      for (int i = 0; i < p2::RATE; i++)
        if (c0 + i < cols) s[i] = (uint32_t)tile[swz((c0 + i) * T + j)];
      p2::permute(s, sc);
    }
#pragma unroll
    for (int i = 0; i < 8; i++) out[i] = s[i];
  }
  static __device__ __forceinline__ void node(const uint32_t l[8], const uint32_t r[8], uint32_t out[8],
                                              const uint32_t* sc) {
    p2::compress(l, r, out, sc);
  }
};

// Folds `levels` levels over the digests in shared memory `dig` (node j of
// the input level at dig + 8j); `gbase` is the first input node's index in
// its layer.  Every thread of the block calls it.
template <class H>
__device__ __forceinline__ void fold_levels(uint32_t* dig, int m0, int64_t gbase, const Levels& lv, int first,
                                            const uint32_t* sc) {
  for (int l = 1; l <= lv.levels; l++) {
    const int m = m0 >> l;
    const int64_t g = gbase >> l;
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      uint32_t a[8], b[8], d[8];
      load8(dig + ((int64_t)i << l) * 8, a);
      load8(dig + (((int64_t)i << l) + (1 << (l - 1))) * 8, b);
      H::node(a, b, d, sc);
      if (lv.inj[first + l - 1] != nullptr) {
        load8(lv.inj[first + l - 1] + (g + i) * 8, a);
        H::node(d, a, b, sc);
#pragma unroll
        for (int q = 0; q < 8; q++) d[q] = b[q];
      }
      store8(dig + ((int64_t)i << l) * 8, d);
      store8(lv.out[first + l - 1] + (g + i) * 8, d);
    }
    __syncthreads();
  }
}

// Levels b+1 .. b+M of the tile's transform (stages b+1 .. b+M: DIF top
// down, DIT bottom up) in registers: one thread per group of 2^M elements
// of a column at stride 2^b, neighbouring threads on neighbouring positions
// below bit b (in the bottom phase, b = 0, on neighbouring groups).  Stage
// s pairs positions i and i + 2^(s-1) with twiddle i mod 2^(s-1) of its
// table at tw + 2^(s-1) - 1.
template <class F, int M, bool DIT>
__device__ __forceinline__ void tile_phase(uint64_t* tile, int cols, int k, int b, const uint64_t* __restrict__ tw) {
  const int groups = cols << (k - M);
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int rest = g & ((1 << (k - M)) - 1);
    const int low = rest & ((1 << b) - 1);
    const int e0 = ((g >> (k - M)) << k) + (((rest >> b) << (b + M)) | low);
    uint64_t v[1 << M];
#pragma unroll
    for (int x = 0; x < (1 << M); x++) v[x] = tile[swz(e0 + (x << b))];
#pragma unroll
    for (int step = 0; step < M; step++) {
      const int l = DIT ? step + 1 : M - step;
      const int h = 1 << (l - 1);
      const uint64_t* tws = tw + ((1 << (b + l - 1)) - 1) + low;
#pragma unroll
      for (int x = 0; x < (1 << M); x++) {
        if (x & h) continue;
        const uint64_t w = __ldg(tws + ((x & (h - 1)) << b));
        const uint64_t u = v[x], t = v[x + h];
        if (DIT) {
          const uint64_t m = F::mul(t, w);
          v[x] = F::add(u, m);
          v[x + h] = F::sub(u, m);
        } else {
          v[x] = F::add(u, t);
          v[x + h] = F::mul(F::sub(u, t), w);
        }
      }
    }
#pragma unroll
    for (int x = 0; x < (1 << M); x++) tile[swz(e0 + (x << b))] = v[x];
  }
}

template <class F, bool DIT>
__device__ __forceinline__ void tile_phase_of(uint64_t* tile, int cols, int k, int b, int m, const uint64_t* tw) {
  switch (m) {
    case 1: tile_phase<F, 1, DIT>(tile, cols, k, b, tw); break;
    case 2: tile_phase<F, 2, DIT>(tile, cols, k, b, tw); break;
    case 3: tile_phase<F, 3, DIT>(tile, cols, k, b, tw); break;
    default: tile_phase<F, PHASE_LOG, DIT>(tile, cols, k, b, tw); break;
  }
}

// Dynamic shared memory: [digests: T * 8 words, if hashing][tile:
// tile_slots(cols * T) elements][round constants: H::CONSTS words, if
// hashing].
template <class F, class H>
__global__ void __launch_bounds__(TILE_THREADS) lde_tile_kernel(uint64_t* __restrict__ x, int cols, int log_n, int k,
                                                                const uint64_t* __restrict__ tw, int mode, Levels lv,
                                                                const int64_t* __restrict__ consts) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool hash = mode == MODE_HASHED, dit = mode == MODE_DIT;
  const int T = 1 << k;
  const int64_t n = (int64_t)1 << log_n;
  const int64_t base = (int64_t)blockIdx.x << k;
  const int cells = cols << k;
  uint32_t* dig = reinterpret_cast<uint32_t*>(smem);
  uint64_t* tile = reinterpret_cast<uint64_t*>(smem + (hash ? (size_t)T * 32 : 0));
  uint32_t* sc = reinterpret_cast<uint32_t*>(tile + tile_slots(cells));
  if (hash)
    for (int i = threadIdx.x; i < H::CONSTS; i += blockDim.x) sc[i] = (uint32_t)consts[i];
  // element e of the tile is column e >> k, position base + (e & (T - 1)),
  // at swz(e); two neighbours share a 16-byte copy when the strips are
  // 16-byte aligned
  const bool vec = k >= 1 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  if (vec) {
    for (int e = 2 * threadIdx.x; e < cells; e += 2 * blockDim.x)
      cp_async16(tile + swz(e), x + (int64_t)(e >> k) * n + base + (e & (T - 1)));
    cp_async_wait_all();
  } else {
    for (int e = threadIdx.x; e < cells; e += blockDim.x)
      tile[swz(e)] = x[(int64_t)(e >> k) * n + base + (e & (T - 1))];
  }
  __syncthreads();
  const int phases = (k + PHASE_LOG - 1) / PHASE_LOG;  // bits [PHASE_LOG * p, PHASE_LOG * (p + 1)) of the position
  for (int i = 0; i < phases; i++) {
    const int p = dit ? i : phases - 1 - i;
    const int b = PHASE_LOG * p, m = k - b < PHASE_LOG ? k - b : PHASE_LOG;
    if (dit)
      tile_phase_of<F, true>(tile, cols, k, b, m, tw);
    else
      tile_phase_of<F, false>(tile, cols, k, b, m, tw);
    __syncthreads();
  }
  if (vec) {
    for (int e = 2 * threadIdx.x; e < cells; e += 2 * blockDim.x)
      *reinterpret_cast<uint4*>(x + (int64_t)(e >> k) * n + base + (e & (T - 1))) =
          *reinterpret_cast<const uint4*>(tile + swz(e));
  } else {
    for (int e = threadIdx.x; e < cells; e += blockDim.x)
      x[(int64_t)(e >> k) * n + base + (e & (T - 1))] = tile[swz(e)];
  }
  if (!hash) return;
  for (int j = threadIdx.x; j < T; j += blockDim.x) {
    uint32_t d[8];
    H::leaf(tile, j, T, cols, d, sc);
    store8(dig + (int64_t)j * 8, d);
    store8(lv.out[0] + (base + j) * 8, d);
  }
  __syncthreads();
  fold_levels<H>(dig, T, base, lv, 1, sc);
}

template <class H>
__global__ void __launch_bounds__(LEVEL_THREADS) merkle_levels_kernel(const uint32_t* __restrict__ in, int fold,
                                                                      Levels lv, const int64_t* __restrict__ consts) {
  __shared__ __align__(16) uint32_t nodes[(1 << MAX_FOLD_LOG) * 8];
  __shared__ uint32_t sc[H::CONSTS > 0 ? H::CONSTS : 1];
  const int m0 = 1 << fold;
  const int64_t base = (int64_t)blockIdx.x << fold;
  for (int i = threadIdx.x; i < H::CONSTS; i += blockDim.x) sc[i] = (uint32_t)consts[i];
  for (int i = threadIdx.x; i < m0; i += blockDim.x) {
    uint32_t d[8];
    load8(in + (base + i) * 8, d);
    store8(nodes + i * 8, d);
  }
  __syncthreads();
  fold_levels<H>(nodes, m0, base, lv, 0, sc);
}

// Raises `kernel`'s dynamic shared memory limit to the device's opt-in limit
// the first time (`optin` < 0: the caller keeps one per kernel instance),
// then checks that `bytes` fit under it.
int allow_smem(const void* kernel, int& optin, size_t bytes) {
  if (optin < 0) {
    int dev = 0, v = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (rc == cudaSuccess) rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, v);
    if (rc == cudaSuccess)  // the SM's L1 / shared split favours shared memory, so that several tiles fit
      rc = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (rc != cudaSuccess) return (int)rc;
    optin = v;
  }
  return bytes <= (size_t)optin ? 0 : (int)cudaErrorInvalidValue;
}

Levels levels_of(uint32_t* const* outs, const uint32_t* const* injs, int n_out, int levels) {
  Levels lv;
  for (int l = 0; l <= MAX_TILE_LOG; l++) {
    lv.out[l] = l < n_out ? outs[l] : nullptr;
    lv.inj[l] = l < n_out ? injs[l] : nullptr;
  }
  lv.levels = levels;
  return lv;
}

template <class F, class H>
int launch_lde_tile(uint64_t* x, int cols, int log_n, int k, const uint64_t* tw, int mode, const Levels& lv,
                    const int64_t* consts, cudaStream_t stream) {
  static int optin = -1;  // one per template instance
  const size_t tile = (size_t)1 << k;
  const size_t bytes =
      8 * (size_t)tile_slots(cols << k) + (mode == MODE_HASHED ? 32 * tile + 4 * (size_t)H::CONSTS : 0);
  const int rc = allow_smem(reinterpret_cast<const void*>(lde_tile_kernel<F, H>), optin, bytes);
  if (rc != 0) return rc;
  // a hashed tile hashes one row per thread: as many threads as rows (at least two warps)
  const int threads = mode == MODE_HASHED ? (k >= 8 ? TILE_THREADS : k <= 6 ? 64 : 1 << k)
                      : ((int64_t)cols << k) >= 2 * TILE_THREADS ? TILE_THREADS : 128;
  const unsigned blocks = (unsigned)((int64_t)1 << (log_n - k));
  lde_tile_kernel<F, H><<<blocks, threads, bytes, stream>>>(x, cols, log_n, k, tw, mode, lv, consts);
  return (int)cudaGetLastError();
}

}  // namespace

// K14 on x, a contiguous (cols, 2^log_n) batch of canonical field elements,
// in place: DIF stages k..1, or DIT stages 1..k in mode MODE_DIT (tw: the
// stages' twiddle tables 1..k concatenated, stage s at offset 2^(s-1) - 1).
// In mode MODE_HASHED it also writes the leaf digests to outs[0] ((2^log_n, 8) u32) and folds `levels`
// levels into outs[1..levels], injecting injs[l] (nullptr: none) at level l;
// outs and injs are host arrays of levels + 1 device pointers.  field: 0
// Goldilocks, 1 BabyBear; hasher: 0 BLAKE3 (Goldilocks), 1 Poseidon2
// (BabyBear); consts: Poseidon2's round constants as int64.
extern "C" int lde_tile(int field, int hasher, uint64_t* x, int cols, int log_n, int k, const uint64_t* tw, int mode,
                        uint32_t* const* outs, const uint32_t* const* injs, int levels, const int64_t* consts,
                        cudaStream_t stream) {
  if (cols <= 0 || k < 0 || k > log_n || k > MAX_TILE_LOG || log_n >= 40) return (int)cudaErrorInvalidValue;
  if (mode != MODE_DIF && mode != MODE_HASHED && mode != MODE_DIT) return (int)cudaErrorInvalidValue;
  const bool hash = mode == MODE_HASHED;
  if (hash && (levels < 0 || levels > k || outs == nullptr || injs == nullptr)) return (int)cudaErrorInvalidValue;
  const int64_t chunks = (2 * (int64_t)cols + b3::CHUNK_WORDS - 1) / b3::CHUNK_WORDS;
  if (hash && hasher == 0 && chunks > ((int64_t)1 << (b3::MAX_STACK - 1))) return (int)cudaErrorInvalidValue;
  const Levels lv = hash ? levels_of(outs, injs, levels + 1, levels) : levels_of(nullptr, nullptr, 0, 0);
  if (field == 0 && hasher == 0)
    return launch_lde_tile<Goldilocks, Blake3Hasher>(x, cols, log_n, k, tw, mode, lv, consts, stream);
  if (field == 1 && hasher == 1)
    return launch_lde_tile<BabyBear, Poseidon2Hasher>(x, cols, log_n, k, tw, mode, lv, consts, stream);
  return (int)cudaErrorInvalidValue;
}

// K15 over `in`, a contiguous (2^log_size, 8) u32 digest layer: folds
// `fold` levels (1..10) into outs[0..fold-1] (level l + 1 has 2^(log_size -
// l - 1) nodes), injecting injs[l] (nullptr: none) into level l + 1; one
// block per 2^fold input nodes.  hasher: 0 BLAKE3, 1 Poseidon2 (consts: its
// round constants as int64).
extern "C" int merkle_levels(int hasher, const uint32_t* in, int log_size, int fold, uint32_t* const* outs,
                             const uint32_t* const* injs, const int64_t* consts, cudaStream_t stream) {
  if (fold < 1 || fold > MAX_FOLD_LOG || fold > log_size || log_size >= 40) return (int)cudaErrorInvalidValue;
  const Levels lv = levels_of(outs, injs, fold, fold);
  const unsigned blocks = (unsigned)((int64_t)1 << (log_size - fold));
  if (hasher == 0)
    merkle_levels_kernel<Blake3Hasher><<<blocks, LEVEL_THREADS, 0, stream>>>(in, fold, lv, consts);
  else if (hasher == 1)
    merkle_levels_kernel<Poseidon2Hasher><<<blocks, LEVEL_THREADS, 0, stream>>>(in, fold, lv, consts);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
