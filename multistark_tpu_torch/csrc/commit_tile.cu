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
// K15 merkle_levels.  The levels of a tree above a digest layer, up to the
// cap, in one launch (merkle.py _commit_impl's compress loop).  Tier 0:
// each block folds its own subtree of 2^s0 nodes; the plan
// (commit_tile.levels_plan) sizes s0 so that the first level spreads over
// all 132 SMs (256 or more blocks from 2^16 input nodes up).  Then each
// block arrives on a counter; the last of a group of 2^s1 blocks folds the
// group's roots s1 levels higher, and so on up to the top: no host loop and
// no second launch.  Inside a block, levels of more than a warp of nodes run
// block-wide through shared memory, the rest in one warp with the digests
// in registers and the children taken by shuffle, so a narrow level costs
// about one compression's latency and no barrier.  Injections keep
// merkle.py's semantics at any level: compress(compress(l, r), leaf digest).
//
// Bound on the card: integer ALU for the hashing (a BLAKE3 compression is
// ~780 32-bit operations per 64 bytes, a Poseidon2 permutation ~4600 per 32
// to 64 bytes); the tile's k stages add k field products per element while
// reading and writing each element once, instead of k HBM passes; both are
// Goldilocks or BabyBear integer work, as in K2.  K15's trees add their
// depth: every level waits for the one below, so a tree costs at least its
// levels times one compression's latency (about 240 levels per
// GoldilocksBlake3 prove at 2^18), which tier 0's spread, the warp-level
// narrow levels and the single launch attack.  Poseidon2 (K14's BabyBear
// leaves and nodes, K15's nodes) runs poseidon2.cuh's one permutation, in
// Montgomery form (32-bit products, unrolled rounds), which K6 runs too.
// K14's design: the host sizes
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
// K15: a block's most threads, the most levels one block folds in a tier
// (2^10 input nodes), levels per tree and tiers per launch
// (commit_tile.levels_plan makes the plan)
constexpr int TREE_THREADS = 256;
constexpr int MAX_GROUP_LOG = 10;
constexpr int MAX_TREE_LEVELS = 40;
constexpr int MAX_TIERS = 8;
constexpr int WARP = 32;
constexpr unsigned FULL_MASK = 0xffffffffu;
// K14's modes (commit_tile.py MODE_*): a DIF's last k stages; the same,
// then the leaf hash and the fold; a DIT's first k stages.
constexpr int MODE_DIF = 0, MODE_HASHED = 1, MODE_DIT = 2;
constexpr int PHASE_LOG = 4;  // the tile's stages run in phases of up to four, from bits 0, 4, 8, ...
// K14's Poseidon2 leaf keeps its 13 partial rounds a loop (true) or unrolls
// them as K6 and K15 do (false).  Rolled builds in 25.6 s against 34.0 s
// for commit_tile.cu; scripts/variant_sweep.py timed it 0-4% faster on
// BabyBear's stage tiles in most turns but not in every one (H100 80GB HBM3,
// 700 W); neither spills.
constexpr bool LEAF_ROLLED = true;

// The digest layers a launch writes and the digests injected into them:
// out[l] is level l counted from the launch's input (out[0] the leaves, for
// K14), inj[l] the leaf digests of the rows injected at level l or nullptr.
struct Levels {
  uint32_t* out[MAX_TILE_LOG + 1];
  const uint32_t* inj[MAX_TILE_LOG + 1];
  int levels;
};

// K15's tree: out[l] is level l + 1 above the input layer, inj[l] the leaf
// digests injected into it or nullptr; tier t folds tier_log[t] levels per
// block, and (t >= 1) its groups' arrival counters start at counter[t].
struct Tree {
  uint32_t* out[MAX_TREE_LEVELS];
  const uint32_t* inj[MAX_TREE_LEVELS];
  int64_t counter[MAX_TIERS];
  int tier_log[MAX_TIERS];
  int tiers;
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
  static constexpr int LANES = 1;  // K15: lanes per node at the narrow levels
  static __device__ __forceinline__ void stage(uint32_t*, const int64_t*) {}
  static __device__ __forceinline__ uint32_t constant(int64_t c) { return (uint32_t)c; }
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

// Poseidon2 in Montgomery form (poseidon2.cuh, the body K6 runs too): K14's
// leaf absorbs each tile value through to_mont; nodes, in K14's tile levels
// and K15's wide levels a thread each and at K15's narrow levels a group of
// four lanes each, convert their canonical digests in and out.  The
// constants are converted as they are staged.
struct Poseidon2Hasher {
  static constexpr int CONSTS = p2::N_CONST;
  static constexpr int LANES = 4;  // K15: lanes per node at the narrow levels
  static __device__ __forceinline__ void stage(uint32_t* sc, const int64_t* consts) {
    p2::mont::stage_constants(sc, consts);
  }
  // K14's staging loop converts one constant at a time (the loop as
  // stage_constants runs it; BLAKE3's instance keeps its code unchanged)
  static __device__ __forceinline__ uint32_t constant(int64_t c) { return p2::mont::to_mont((uint32_t)c); }
  static __device__ __forceinline__ void leaf(const uint64_t* tile, int j, int T, int cols, uint32_t out[8],
                                              const uint32_t* sc) {
    uint32_t s[p2::WIDTH];
#pragma unroll
    for (int i = 0; i < p2::WIDTH; i++) s[i] = 0;
    for (int c0 = 0; c0 < cols; c0 += p2::RATE) {  // a short last chunk keeps lanes cols - c0 .. 15
#pragma unroll
      for (int i = 0; i < p2::RATE; i++)
        if (c0 + i < cols) s[i] = p2::mont::to_mont((uint32_t)tile[swz((c0 + i) * T + j)]);
      p2::mont::permute<LEAF_ROLLED>(s, sc);
    }
#pragma unroll
    for (int i = 0; i < 8; i++) out[i] = p2::mont::from_mont(s[i]);
  }
  static __device__ __forceinline__ void node(const uint32_t l[8], const uint32_t r[8], uint32_t out[8],
                                              const uint32_t* sc) {
    p2::mont::compress(l, r, out, sc);
  }
  static __device__ __forceinline__ void node4(uint32_t x[4], const uint32_t* sc, int k) {
    p2::mont::compress4(x, sc, k);
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
  if (hash)  // read after the tile's first barrier
    for (int i = threadIdx.x; i < H::CONSTS; i += blockDim.x) sc[i] = H::constant(consts[i]);
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

// -- K15 merkle_levels ---------------------------------------------------------

// 16 bytes at a time through L2 only: digests another block of this launch
// wrote (after its fence) are never served from a stale L1 line.
__device__ __forceinline__ void load8_cg(const uint32_t* p, uint32_t d[8]) {
  const uint4 a = __ldcg(reinterpret_cast<const uint4*>(p)), b = __ldcg(reinterpret_cast<const uint4*>(p) + 1);
  d[0] = a.x, d[1] = a.y, d[2] = a.z, d[3] = a.w, d[4] = b.x, d[5] = b.y, d[6] = b.z, d[7] = b.w;
}

// A node with its injection, if any: compress(compress(a, b), inj[i]).
template <class H>
__device__ __forceinline__ void tree_node(const uint32_t a[8], const uint32_t b[8], uint32_t d[8],
                                          const uint32_t* inj, int64_t i, const uint32_t* sc) {
  H::node(a, b, d, sc);
  if (inj != nullptr) {
    uint32_t c[8], e[8];
    load8(inj + i * 8, c);
    H::node(d, c, e, sc);
#pragma unroll
    for (int q = 0; q < 8; q++) d[q] = e[q];
  }
}

// One level of m nodes with a thread per node (each thread a node at a
// time): children from the shared layer `prev`, or from src (global, from
// node `base` on) when prev is nullptr; results to global `out` (node g
// first) and to the shared layer dst.
template <class H>
__device__ __forceinline__ void block_level(const uint32_t* prev, const uint32_t* src, int64_t base, int m, int64_t g,
                                            uint32_t* out, const uint32_t* inj, uint32_t* dst, const uint32_t* sc) {
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    uint32_t a[8], b[8], d[8];
    if (prev != nullptr) {
      load8(prev + 16 * i, a);
      load8(prev + 16 * i + 8, b);
    } else {
      load8_cg(src + (base + 2 * i) * 8, a);
      load8_cg(src + (base + 2 * i + 1) * 8, b);
    }
    tree_node<H>(a, b, d, inj, g + i, sc);
    store8(out + (g + i) * 8, d);
    store8(dst + 8 * i, d);
  }
}

// Folds the 2^s nodes of the layer `src` at tree level l0 (first node
// `base`) up s levels into one node, writing level l0 + l's nodes
// base >> l ... into tr.out[l0 + l - 1].  Levels of more than a warp of
// nodes run block-wide, each thread a node at a time, the layer kept in
// shared memory (`buf`: level l in half (l & 1) of a ping-pong pair, so no
// level overwrites what it reads); the rest in warp 0, lane j holding node
// j in registers and taking its children from lanes 2j and 2j + 1 by
// shuffle, with no barrier between levels.  Every thread calls it.
template <class H>
__device__ void fold_group(const uint32_t* src, int64_t base, int s, int l0, const Tree& tr, uint32_t* buf,
                           const uint32_t* sc) {
  const uint32_t* prev = nullptr;  // the block-wide layer below, in shared memory (nullptr: src)
  int l = 1;
  for (; (1 << (s - l)) > WARP; l++) {
    uint32_t* dst = buf + ((l & 1) ? 0 : (8 << (s - 1)));
    block_level<H>(prev, src, base, 1 << (s - l), base >> l, tr.out[l0 + l - 1], tr.inj[l0 + l - 1], dst, sc);
    __syncthreads();
    prev = dst;
  }
  if (threadIdx.x >= WARP) return;
  const int j = threadIdx.x;
  int m = 1 << (s - l);
  uint32_t d[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (j < m) {
    uint32_t a[8], b[8];
    if (prev != nullptr) {
      load8(prev + 16 * j, a);
      load8(prev + 16 * j + 8, b);
    } else {
      load8_cg(src + (base + 2 * j) * 8, a);
      load8_cg(src + (base + 2 * j + 1) * 8, b);
    }
    tree_node<H>(a, b, d, tr.inj[l0 + l - 1], (base >> l) + j, sc);
    store8(tr.out[l0 + l - 1] + ((base >> l) + j) * 8, d);
  }
  for (l++; l <= s; l++) {
    m >>= 1;
    uint32_t a[8], b[8];
#pragma unroll
    for (int q = 0; q < 8; q++) {
      a[q] = __shfl_sync(FULL_MASK, d[q], (2 * j) & (WARP - 1));
      b[q] = __shfl_sync(FULL_MASK, d[q], (2 * j + 1) & (WARP - 1));
    }
    if (j < m) {
      tree_node<H>(a, b, d, tr.inj[l0 + l - 1], (base >> l) + j, sc);
      store8(tr.out[l0 + l - 1] + ((base >> l) + j) * 8, d);
    }
  }
}

__device__ __forceinline__ void load4(const uint32_t* p, uint32_t d[4]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  d[0] = a.x, d[1] = a.y, d[2] = a.z, d[3] = a.w;
}

__device__ __forceinline__ void store4(uint32_t* p, const uint32_t d[4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(d[0], d[1], d[2], d[3]);
}

// fold_group for a hasher whose node runs on a group of H::LANES lanes
// (Poseidon2): a level whose nodes' groups fit the block in LANE_ROUNDS
// passes runs a group per node (lane k of node j takes words 4k..4k+3 of
// its two children, its result's words 4k..4k+3 if k < 2), a wider level a
// thread per node (fewer instructions per node: throughput); every level
// goes through shared memory with a barrier after it.
constexpr int LANE_ROUNDS = 2;

template <class H>
__device__ void fold_group_lanes(const uint32_t* src, int64_t base, int s, int l0, const Tree& tr, uint32_t* buf,
                                 const uint32_t* sc) {
  constexpr int L = H::LANES;
  const uint32_t* prev = nullptr;  // the layer below, in shared memory (nullptr: src)
  for (int l = 1; l <= s; l++) {
    const int m = 1 << (s - l);
    uint32_t* dst = buf + ((l & 1) ? 0 : (8 << (s - 1)));
    const int64_t g = base >> l;
    uint32_t* out = tr.out[l0 + l - 1];
    const uint32_t* inj = tr.inj[l0 + l - 1];
    if (m * L > LANE_ROUNDS * (int)blockDim.x) {
      block_level<H>(prev, src, base, m, g, out, inj, dst, sc);
    } else {
      // whole warps (the groups shuffle): every pass but a lone one fills the block
      for (int t = threadIdx.x; t < ((m * L + WARP - 1) & ~(WARP - 1)); t += blockDim.x) {
        const int j = t / L, k = t % L;
        const bool live = j < m;
        uint32_t x[4] = {0, 0, 0, 0};
        if (live) {
          const int64_t child = 2 * j + (k >> 1);
          if (prev != nullptr) {
            load4(prev + 8 * child + 4 * (k & 1), x);
          } else {
            const uint4 a = __ldcg(reinterpret_cast<const uint4*>(src + (base + child) * 8 + 4 * (k & 1)));
            x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
          }
        }
        H::node4(x, sc, k);
        if (inj != nullptr) {
          if (live && k >= 2) load4(inj + (g + j) * 8 + 4 * (k - 2), x);
          H::node4(x, sc, k);
        }
        if (live && k < 2) {
          store4(out + (g + j) * 8 + 4 * k, x);
          store4(dst + 8 * j + 4 * k, x);
        }
      }
    }
    __syncthreads();
    prev = dst;
  }
}

// One launch per tree.  Tier 0: block b folds input nodes b·2^s0 ..
// (b + 1)·2^s0 - 1 up s0 levels.  Then it arrives on its tier-1 group's
// counter (2^s1 blocks per group); the last to arrive folds the group's
// 2^s1 roots up s1 levels, arrives on its tier-2 group's counter, and so on
// up to the top layer.  A counter is set back to 0 by the block that
// arrives last, so every launch finds its counters at 0.
template <class H>
__global__ void __launch_bounds__(TREE_THREADS) merkle_tree_kernel(const uint32_t* __restrict__ in, Tree tr,
                                                                   unsigned long long* __restrict__ counters,
                                                                   const int64_t* __restrict__ consts) {
  __shared__ __align__(16) uint32_t buf[(3 << (MAX_GROUP_LOG - 2)) * 8];
  __shared__ uint32_t sc[H::CONSTS > 0 ? H::CONSTS : 1];
  __shared__ int last;
  H::stage(sc, consts);
  __syncthreads();
  int64_t g = blockIdx.x;
  int l0 = 0;
  for (int t = 0;; t++) {
    const int s = tr.tier_log[t];
    if constexpr (H::LANES > 1)
      fold_group_lanes<H>(l0 == 0 ? in : tr.out[l0 - 1], g << s, s, l0, tr, buf, sc);
    else
      fold_group<H>(l0 == 0 ? in : tr.out[l0 - 1], g << s, s, l0, tr, buf, sc);
    l0 += s;
    if (t + 1 == tr.tiers) return;
    const int s1 = tr.tier_log[t + 1];
    __threadfence();  // this block's digests, before its arrival
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long* c = counters + tr.counter[t + 1] + (g >> s1);
      last = atomicAdd(c, 1ull) == (1ull << s1) - 1;
      if (last) *c = 0;  // every block of the group has arrived
    }
    __syncthreads();
    if (!last) return;
    __threadfence();  // the group's digests, before they are read
    g >>= s1;
  }
}

// A digest compressed with itself n times in a row by one thread (BLAKE3)
// or one group of four lanes (Poseidon2), as K15's narrow levels run a
// node: one compression's latency per step (K15's floor per level).
template <class H>
__global__ void node_chain_kernel(uint32_t* io, int n, const int64_t* __restrict__ consts) {
  __shared__ uint32_t sc[H::CONSTS > 0 ? H::CONSTS : 1];
  H::stage(sc, consts);
  __syncthreads();
  if constexpr (H::LANES > 1) {  // lanes 0-3 of warp 0: a node on a group, as at the narrow levels
    const int k = threadIdx.x % 4;
    uint32_t x[4];
    load4(io + 4 * (k & 1), x);
    for (int i = 0; i < n; i++) {
      H::node4(x, sc, k);
#pragma unroll
      for (int q = 0; q < 4; q++) {  // the next node's right child is its left: lanes 2, 3 copy lanes 0, 1
        const uint32_t t = __shfl_sync(FULL_MASK, x[q], (threadIdx.x & ~3) + (k & 1));
        if (k >= 2) x[q] = t;
      }
    }
    if (threadIdx.x < 2) store4(io + 4 * k, x);
  } else {
    if (threadIdx.x != 0) return;
    uint32_t d[8], e[8];
    load8(io, d);
    for (int i = 0; i < n; i++) {
      H::node(d, d, e, sc);
#pragma unroll
      for (int q = 0; q < 8; q++) d[q] = e[q];
    }
    store8(io, d);
  }
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

// K15 over `in`, a contiguous (2^log_size, 8) u32 digest layer: the
// `levels` layers above it into outs[0..levels-1] (level l + 1 has
// 2^(log_size - l - 1) nodes), injecting injs[l] (nullptr: none) into level
// l + 1, in one launch by the plan tier_log[0..tiers-1] (levels per block and
// tier, summing to `levels`; commit_tile.levels_plan) with `threads` per
// block; counters: `words` zeros (the tiers' arrival counters, left at 0).
// hasher: 0 BLAKE3, 1 Poseidon2 (consts: its round constants as int64).
extern "C" int merkle_levels(int hasher, const uint32_t* in, int log_size, int levels, uint32_t* const* outs,
                             const uint32_t* const* injs, const int* tier_log, int tiers, int threads,
                             unsigned long long* counters, int64_t words, const int64_t* consts,
                             cudaStream_t stream) {
  if (levels < 1 || levels > log_size || levels > MAX_TREE_LEVELS || log_size >= 40) return (int)cudaErrorInvalidValue;
  if (tiers < 1 || tiers > MAX_TIERS || threads < WARP || threads > TREE_THREADS || threads % WARP)
    return (int)cudaErrorInvalidValue;
  Tree tr;
  for (int l = 0; l < MAX_TREE_LEVELS; l++) {
    tr.out[l] = l < levels ? outs[l] : nullptr;
    tr.inj[l] = l < levels ? injs[l] : nullptr;
  }
  int sum = 0;
  for (int t = 0; t < MAX_TIERS; t++) {
    tr.tier_log[t] = t < tiers ? tier_log[t] : 0;
    if (t < tiers && (tier_log[t] < 1 || tier_log[t] > MAX_GROUP_LOG)) return (int)cudaErrorInvalidValue;
    sum += tr.tier_log[t];
  }
  if (sum != levels) return (int)cudaErrorInvalidValue;
  tr.tiers = tiers;
  const int64_t blocks = (int64_t)1 << (log_size - tier_log[0]);
  int64_t need = 0, groups = blocks;
  for (int t = 0; t < MAX_TIERS; t++) {
    tr.counter[t] = need;
    if (t >= 1 && t < tiers) {
      groups >>= tier_log[t];
      need += groups;
    }
  }
  if (blocks > 0x7fffffff || (need > 0 && (counters == nullptr || words < need))) return (int)cudaErrorInvalidValue;
  if (hasher == 0)
    merkle_tree_kernel<Blake3Hasher><<<(unsigned)blocks, threads, 0, stream>>>(in, tr, counters, consts);
  else if (hasher == 1)
    merkle_tree_kernel<Poseidon2Hasher><<<(unsigned)blocks, threads, 0, stream>>>(in, tr, counters, consts);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// K15's node, n times in a row in one thread on the digest io ((8,) u32, in
// place): the latency of one compression (`node_chain` in
// commit_tile.py).
extern "C" int node_chain(int hasher, uint32_t* io, int n, const int64_t* consts, cudaStream_t stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (hasher == 0)
    node_chain_kernel<Blake3Hasher><<<1, WARP, 0, stream>>>(io, n, consts);
  else if (hasher == 1)
    node_chain_kernel<Poseidon2Hasher><<<1, WARP, 0, stream>>>(io, n, consts);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
