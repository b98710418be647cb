/* Portable BLAKE3 (hash + 2-to-1 compress): the host C helper of the
 * PyTorch port's GoldilocksBlake3 config.
 *
 * The GPU does the batched hashing (kernel K3, csrc/blake3_merkle.cu); this
 * covers the host-side serial uses: challenger flushes, the commit- and
 * query-phase grinds and the host half of a device-duplex flush (the chunk
 * chaining values of its host parts, msb3_parts).  It began as the port's
 * own copy of the BLAKE3 part of the JAX package's csrc/b3.c, so that the
 * port builds nothing from outside its package.
 *
 * Built with poseidon2.c into build/torch_kernels/libmshost.so by
 * multistark_tpu_torch/native.py.
 *
 * Every message is hashed as a stream of parts (msb3_parts; msb3_hash is one
 * part of host bytes): whole groups of 16 chunks in lock-step, one chunk per
 * lane of GCC vector extensions (a transcript that holds the claims, 40 MiB
 * at 2^20 claims, is nearly all such groups), the rest one chunk at a time.
 * The lane code is cloned for AVX-512F, AVX2 and the baseline ISA and the
 * loader picks the clone the CPU runs (target_clones; msb3_lanes names it),
 * so the library never depends on the CPU it was built on.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static const uint32_t IV[8] = {
    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u,
};
static const uint8_t MSG_PERM[16] = {2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8};

enum {
    CHUNK_START = 1,
    CHUNK_END = 2,
    PARENT = 4,
    ROOT = 8,
    CHUNK_LEN = 1024,
    BLOCK_LEN = 64,
};

static inline uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

static inline void g(uint32_t *st, int a, int b, int c, int d, uint32_t mx, uint32_t my) {
    st[a] = st[a] + st[b] + mx;
    st[d] = rotr(st[d] ^ st[a], 16);
    st[c] = st[c] + st[d];
    st[b] = rotr(st[b] ^ st[c], 12);
    st[a] = st[a] + st[b] + my;
    st[d] = rotr(st[d] ^ st[a], 8);
    st[c] = st[c] + st[d];
    st[b] = rotr(st[b] ^ st[c], 7);
}

static void compress(const uint32_t cv[8], const uint32_t block[16], uint64_t counter,
                     uint32_t block_len, uint32_t flags, uint32_t out16[16]) {
    uint32_t st[16];
    uint32_t m[16], t[16];
    memcpy(st, cv, 32);
    st[8] = IV[0]; st[9] = IV[1]; st[10] = IV[2]; st[11] = IV[3];
    st[12] = (uint32_t)counter;
    st[13] = (uint32_t)(counter >> 32);
    st[14] = block_len;
    st[15] = flags;
    memcpy(m, block, 64);
    for (int r = 0; r < 7; r++) {
        g(st, 0, 4, 8, 12, m[0], m[1]);
        g(st, 1, 5, 9, 13, m[2], m[3]);
        g(st, 2, 6, 10, 14, m[4], m[5]);
        g(st, 3, 7, 11, 15, m[6], m[7]);
        g(st, 0, 5, 10, 15, m[8], m[9]);
        g(st, 1, 6, 11, 12, m[10], m[11]);
        g(st, 2, 7, 8, 13, m[12], m[13]);
        g(st, 3, 4, 9, 14, m[14], m[15]);
        if (r < 6) {
            for (int i = 0; i < 16; i++) t[i] = m[MSG_PERM[i]];
            memcpy(m, t, 64);
        }
    }
    for (int i = 0; i < 8; i++) out16[i] = st[i] ^ st[i + 8];
    for (int i = 0; i < 8; i++) out16[i + 8] = st[i + 8] ^ cv[i];
}

static void load_block(const uint8_t *data, uint32_t len, uint32_t block[16]) {
    uint8_t buf[64];
    memset(buf, 0, 64);
    memcpy(buf, data, len);
    for (int i = 0; i < 16; i++)
        block[i] = (uint32_t)buf[4 * i] | ((uint32_t)buf[4 * i + 1] << 8) |
                   ((uint32_t)buf[4 * i + 2] << 16) | ((uint32_t)buf[4 * i + 3] << 24);
}

static void chunk_cv(const uint8_t *data, uint64_t len, uint64_t counter, int root,
                     uint32_t out8[8]) {
    uint32_t cv[8], block[16], out16[16];
    memcpy(cv, IV, 32);
    uint64_t nblocks = len == 0 ? 1 : (len + BLOCK_LEN - 1) / BLOCK_LEN;
    for (uint64_t b = 0; b < nblocks; b++) {
        uint32_t blen = (uint32_t)((b == nblocks - 1) ? len - b * BLOCK_LEN : BLOCK_LEN);
        load_block(data + b * BLOCK_LEN, blen, block);
        uint32_t flags = 0;
        if (b == 0) flags |= CHUNK_START;
        if (b == nblocks - 1) {
            flags |= CHUNK_END;
            if (root) flags |= ROOT;
        }
        compress(cv, block, counter, blen, flags, out16);
        memcpy(cv, out16, 32);
    }
    memcpy(out8, cv, 32);
}

/* --- 16 chunks in lock-step ---------------------------------------------- */

enum { LANES = 16 };

#if defined(__x86_64__) && defined(__has_attribute)
#if __has_attribute(target_clones)
#define LANE_CLONES __attribute__((target_clones("avx512f", "avx2", "default")))
#define HAVE_LANE_CLONES 1
#endif
#endif
#ifndef LANE_CLONES
#define LANE_CLONES
#endif
#define ALWAYS_INLINE static inline __attribute__((always_inline))

typedef uint32_t lanes_t __attribute__((vector_size(4 * LANES)));

/* The message word order of each round (MSG_PERM applied r times). */
static const uint8_t SCHEDULE[7][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8},
    {3, 4, 10, 12, 13, 2, 7, 14, 6, 5, 9, 0, 11, 15, 8, 1},
    {10, 7, 12, 9, 14, 3, 13, 15, 4, 0, 11, 2, 5, 8, 1, 6},
    {12, 13, 9, 11, 15, 10, 14, 8, 7, 2, 5, 3, 0, 1, 6, 4},
    {9, 14, 11, 5, 8, 12, 15, 1, 13, 3, 0, 10, 2, 6, 4, 7},
    {11, 15, 5, 0, 1, 9, 8, 6, 14, 10, 2, 12, 3, 4, 7, 13},
};

#define VROTR(x, n) (((x) >> (n)) | ((x) << (32 - (n))))

#define VG(a, b, c, d, mx, my)                \
    st[a] = st[a] + st[b] + (mx);             \
    st[d] = VROTR(st[d] ^ st[a], 16);         \
    st[c] = st[c] + st[d];                    \
    st[b] = VROTR(st[b] ^ st[c], 12);         \
    st[a] = st[a] + st[b] + (my);             \
    st[d] = VROTR(st[d] ^ st[a], 8);          \
    st[c] = st[c] + st[d];                    \
    st[b] = VROTR(st[b] ^ st[c], 7);

/* `compress` in every lane at once, keeping only the chaining value. */
ALWAYS_INLINE void compress_lanes(lanes_t cv[8], const lanes_t m[16], const lanes_t counter[2], uint32_t block_len,
                                  uint32_t flags) {
    lanes_t st[16];
    for (int i = 0; i < 8; i++) st[i] = cv[i];
    for (int i = 0; i < 4; i++) st[8 + i] = (lanes_t){0} + IV[i];
    st[12] = counter[0];
    st[13] = counter[1];
    st[14] = (lanes_t){0} + block_len;
    st[15] = (lanes_t){0} + flags;
#pragma GCC unroll 7
    for (int r = 0; r < 7; r++) {
        const uint8_t *s = SCHEDULE[r];
        VG(0, 4, 8, 12, m[s[0]], m[s[1]]);
        VG(1, 5, 9, 13, m[s[2]], m[s[3]]);
        VG(2, 6, 10, 14, m[s[4]], m[s[5]]);
        VG(3, 7, 11, 15, m[s[6]], m[s[7]]);
        VG(0, 5, 10, 15, m[s[8]], m[s[9]]);
        VG(1, 6, 11, 12, m[s[10]], m[s[11]]);
        VG(2, 7, 8, 13, m[s[12]], m[s[13]]);
        VG(3, 4, 9, 14, m[s[14]], m[s[15]]);
    }
    for (int i = 0; i < 8; i++) cv[i] = st[i] ^ st[i + 8];
}

ALWAYS_INLINE uint32_t load32(const uint8_t *p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
}

/* Non-root chaining values of 16 whole chunks (LANES x 1024 bytes at data,
 * chunk j with counter counter0 + j); out receives 16 x 8 words. */
LANE_CLONES static void chunk_cvs_x16(const uint8_t *data, uint64_t counter0, uint32_t *out) {
    lanes_t cv[8], m[16], counter[2];
    uint32_t words[16][LANES] __attribute__((aligned(64)));
    for (int i = 0; i < 8; i++) cv[i] = (lanes_t){0} + IV[i];
    for (int j = 0; j < LANES; j++) {
        counter[0][j] = (uint32_t)(counter0 + j);
        counter[1][j] = (uint32_t)((counter0 + j) >> 32);
    }
    for (int b = 0; b < CHUNK_LEN / BLOCK_LEN; b++) {
        for (int j = 0; j < LANES; j++)
            for (int i = 0; i < 16; i++) words[i][j] = load32(data + j * CHUNK_LEN + b * BLOCK_LEN + 4 * i);
        memcpy(m, words, sizeof m);
        compress_lanes(cv, m, counter, BLOCK_LEN,
                       (b == 0 ? CHUNK_START : 0) | (b == CHUNK_LEN / BLOCK_LEN - 1 ? CHUNK_END : 0));
    }
    for (int j = 0; j < LANES; j++)
        for (int i = 0; i < 8; i++) out[8 * j + i] = cv[i][j];
}

/* 16 non-root parents: pairs holds 16 x (left 8 ‖ right 8) words, out
 * receives 16 x 8 words and may overlap pairs (every word is read first). */
LANE_CLONES static void parents_x16(const uint32_t *pairs, uint32_t *out) {
    lanes_t cv[8], m[16], zero[2] = {{0}, {0}};
    uint32_t words[16][LANES] __attribute__((aligned(64)));
    for (int j = 0; j < LANES; j++)
        for (int i = 0; i < 16; i++) words[i][j] = pairs[16 * j + i];
    memcpy(m, words, sizeof m);
    for (int i = 0; i < 8; i++) cv[i] = zero[0] + IV[i];
    compress_lanes(cv, m, zero, BLOCK_LEN, PARENT);
    for (int j = 0; j < LANES; j++)
        for (int i = 0; i < 8; i++) out[8 * j + i] = cv[i][j];
}

/* The clone of the lane code the loader chose for this CPU. */
const char *msb3_lanes(void) {
#ifdef HAVE_LANE_CLONES
    __builtin_cpu_init();
    if (__builtin_cpu_supports("avx512f")) return "avx512f";
    if (__builtin_cpu_supports("avx2")) return "avx2";
#endif
    return "default";
}

/* Merkle 2-to-1 compress batched over n digest pairs: left/right are n×8
 * u32 word rows, out receives n×8 word digests.  Matches the single-block
 * convention of np_compress_pairs (cv=IV, counter 0, blen 64,
 * CHUNK_START|CHUNK_END|ROOT — a 64-byte single-chunk message). */
void msb3_compress_pairs(const uint32_t *left, const uint32_t *right,
                         uint64_t n, uint32_t *out) {
    uint32_t block[16], out16[16];
    for (uint64_t i = 0; i < n; i++) {
        memcpy(block, left + 8 * i, 32);
        memcpy(block + 8, right + 8 * i, 32);
        compress(IV, block, 0, BLOCK_LEN, CHUNK_START | CHUNK_END | ROOT, out16);
        memcpy(out + 8 * i, out16, 32);
    }
}

int msb3_hash(const uint8_t *data, uint64_t len, uint8_t out[32]);

/* Full BLAKE3 over n equal-length messages laid out contiguously (stride
 * bytes apart, len <= stride bytes each); out receives n×8 u32-LE digest
 * words.  Returns 0, or -1 as msb3_hash does. */
int msb3_hash_batch(const uint8_t *data, uint64_t stride, uint64_t len,
                    uint64_t n, uint32_t *out) {
    uint8_t d[32];
    for (uint64_t i = 0; i < n; i++) {
        if (msb3_hash(data + i * stride, len, d)) return -1;
        for (int w = 0; w < 8; w++)
            out[8 * i + w] = (uint32_t)d[4 * w] | ((uint32_t)d[4 * w + 1] << 8) |
                             ((uint32_t)d[4 * w + 2] << 16) |
                             ((uint32_t)d[4 * w + 3] << 24);
    }
    return 0;
}

/* Grind helper: hash (prefix ‖ witness_le8) for witness in [start, start+count)
 * and return the first witness whose top-8 digest bytes, read as the
 * challenger's popped-byte u64, are < p and have the low `bits` bits zero.
 * Returns (uint64_t)-1 if none found.  The messages, at most 4 KiB, keep
 * their chaining values on the stack. */
uint64_t msb3_grind(const uint8_t *prefix, uint64_t prefix_len, uint64_t start,
                    uint64_t count, uint32_t bits, uint64_t p) {
    uint8_t msg[4096];
    uint8_t out[32];
    if (prefix_len + 8 > sizeof(msg)) return (uint64_t)-1;
    memcpy(msg, prefix, prefix_len);
    uint64_t mask = (bits >= 64) ? ~0ull : ((1ull << bits) - 1ull);
    for (uint64_t w = start; w < start + count; w++) {
        for (int i = 0; i < 8; i++) msg[prefix_len + i] = (uint8_t)(w >> (8 * i));
        msb3_hash(msg, prefix_len + 8, out);
        uint64_t v = 0;
        for (int i = 0; i < 8; i++) v |= (uint64_t)out[31 - i] << (8 * i);
        if (v < p && (v & mask) == 0) return w;
    }
    return (uint64_t)-1;
}

/* Non-root chaining values of every 1024-byte chunk of a message (chunk i
 * with counter i; the last chunk may be short), one chunk at a time: the
 * scalar reference of msb3_parts's chaining values.  out receives
 * n_chunks x 8 words. */
void msb3_chunk_cvs(const uint8_t *data, uint64_t len, uint32_t *out) {
    uint64_t n_chunks = len == 0 ? 1 : (len + CHUNK_LEN - 1) / CHUNK_LEN;
    for (uint64_t c = 0; c < n_chunks; c++) {
        uint64_t take = len - c * CHUNK_LEN < CHUNK_LEN ? len - c * CHUNK_LEN : CHUNK_LEN;
        chunk_cv(data + c * CHUNK_LEN, take, c, 0, out + 8 * c);
    }
}

/* One level of the chunk tree: adjacent pairs of n chaining values combine
 * into non-root parents, and an odd last value carries up unchanged (the
 * level-wise form of BLAKE3's left-largest-power-of-two tree).  out receives
 * (n + 1) / 2 x 8 words; it may be cvs itself. */
void msb3_parent_level(const uint32_t *cvs, uint64_t n, uint32_t *out) {
    uint32_t block[16], out16[16];
    uint64_t p = 0;
    for (; p + LANES <= n / 2; p += LANES) parents_x16(cvs + 16 * p, out + 8 * p);
    for (; p < n / 2; p++) {
        memcpy(block, cvs + 16 * p, 64);
        compress(IV, block, 0, BLOCK_LEN, PARENT, out16);
        memcpy(out + 8 * p, out16, 32);
    }
    if (n % 2) memmove(out + 8 * (n / 2), cvs + 8 * (n - 1), 32);
}

/* --- a transcript buffer as parts ------------------------------------------ */

/* A part is four u64 (kind, address, a, b):
 *   PART_BYTES   a bytes at address;
 *   PART_ZEROS   a zero bytes (the places of device words in a duplex);
 *   PART_CLAIMS  a claims segment: the (a, b) row-major u64 array at
 *                address, observed row by row as u64(b) then the b values
 *                mod p, all little-endian: a x 8 x (b + 1) bytes. */
enum { PART_BYTES = 0, PART_ZEROS = 1, PART_CLAIMS = 2 };

typedef struct {
    const uint64_t *parts;
    uint64_t n_parts, p;
    uint64_t part, off; /* the read position: a part and a byte in it */
} stream_t;

static uint64_t part_len(const uint64_t *d) { return d[0] == PART_CLAIMS ? 8 * d[2] * (d[3] + 1) : d[2]; }

static uint64_t stream_len(const stream_t *s) {
    uint64_t total = 0;
    for (uint64_t i = 0; i < s->n_parts; i++) total += part_len(s->parts + 4 * i);
    return total;
}

ALWAYS_INLINE void store64(uint8_t *dst, uint64_t v) {
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
    memcpy(dst, &v, 8);
#else
    for (int i = 0; i < 8; i++) dst[i] = (uint8_t)(v >> (8 * i));
#endif
}

/* Bytes [off, off + len) of a claims segment's byte stream: whole rows in
 * a loop of their own, a row's ends word by word. */
static void claims_bytes(const uint64_t *arr, uint64_t L, uint64_t p, uint64_t off, uint64_t len, uint8_t *dst) {
    uint64_t w = off / 8, row = w / (L + 1), col = w % (L + 1), skip = off % 8;
    while (len) {
        if (col == 0 && skip == 0 && len >= 8 * (L + 1)) {
            const uint64_t *vals = arr + row * L;
            store64(dst, L);
            for (uint64_t i = 0; i < L; i++) {
                uint64_t v = vals[i];
                store64(dst + 8 + 8 * i, v >= p ? v % p : v);
            }
            dst += 8 * (L + 1);
            len -= 8 * (L + 1);
            row++;
            continue;
        }
        uint64_t v = col == 0 ? L : arr[row * L + col - 1];
        if (v >= p) v %= p;
        if (skip == 0 && len >= 8) {
            store64(dst, v);
            dst += 8;
            len -= 8;
        } else {
            uint8_t word[8];
            uint64_t take = 8 - skip < len ? 8 - skip : len;
            store64(word, v);
            memcpy(dst, word + skip, take);
            dst += take;
            len -= take;
            skip = 0;
        }
        if (++col == L + 1) {
            col = 0;
            row++;
        }
    }
}

/* The next len bytes of the stream into dst (dst NULL: skip them), as far
 * as the stream goes. */
static void stream_read(stream_t *s, uint8_t *dst, uint64_t len) {
    while (len && s->part < s->n_parts) {
        const uint64_t *d = s->parts + 4 * s->part;
        uint64_t plen = part_len(d), take = plen - s->off < len ? plen - s->off : len;
        if (dst) {
            if (d[0] == PART_BYTES)
                memcpy(dst, (const uint8_t *)(uintptr_t)d[1] + s->off, take);
            else if (d[0] == PART_ZEROS)
                memset(dst, 0, take);
            else
                claims_bytes((const uint64_t *)(uintptr_t)d[1], d[3], s->p, s->off, take, dst);
            dst += take;
        }
        len -= take;
        s->off += take;
        if (s->off == plen) {
            s->part++;
            s->off = 0;
        }
    }
}

/* The next len bytes in place, where they lie inside one part of host
 * bytes (the stream moves past them); else NULL, and the caller copies. */
static const uint8_t *stream_direct(stream_t *s, uint64_t len) {
    if (s->part >= s->n_parts) return NULL;
    const uint64_t *d = s->parts + 4 * s->part;
    if (d[0] != PART_BYTES || d[2] - s->off < len) return NULL;
    const uint8_t *at = (const uint8_t *)(uintptr_t)d[1] + s->off;
    stream_read(s, NULL, len);
    return at;
}

/* Non-root chaining values of every chunk of a stream of `total` bytes, as
 * msb3_chunk_cvs gives them: whole groups of 16 chunks in lanes, the rest
 * one by one. */
static void stream_chunk_cvs(stream_t *s, uint64_t total, uint32_t *out) {
    uint64_t n_chunks = total == 0 ? 1 : (total + CHUNK_LEN - 1) / CHUNK_LEN, c = 0;
    uint8_t group[LANES * CHUNK_LEN] __attribute__((aligned(64)));
    for (; c + LANES <= total / CHUNK_LEN; c += LANES) {
        const uint8_t *src = stream_direct(s, sizeof group);
        if (!src) stream_read(s, group, sizeof group);
        chunk_cvs_x16(src ? src : group, c, out + 8 * c);
    }
    for (; c < n_chunks; c++) {
        uint64_t take = total - c * CHUNK_LEN < CHUNK_LEN ? total - c * CHUNK_LEN : CHUNK_LEN;
        const uint8_t *src = stream_direct(s, take);
        if (!src) stream_read(s, group, take);
        chunk_cv(src ? src : group, take, c, 0, out + 8 * c);
    }
}

/* The root digest of a stream: its chunks' chaining values, then the tree
 * level by level in place (msb3_parent_level), the last parent as root; one
 * chunk is the root itself.  The chaining values of up to 16 chunks live on
 * the stack.  Returns -1 if those of more find no memory. */
static int stream_hash(stream_t *s, uint8_t out[32]) {
    uint64_t total = stream_len(s), n = total == 0 ? 1 : (total + CHUNK_LEN - 1) / CHUNK_LEN;
    uint32_t cv[8], block[16], out16[16], few[LANES * 8];
    if (n == 1) {
        uint8_t chunk[CHUNK_LEN];
        const uint8_t *src = stream_direct(s, total);
        if (!src) stream_read(s, chunk, total);
        chunk_cv(src ? src : chunk, total, 0, 1, cv);
    } else {
        uint32_t *cvs = n <= LANES ? few : malloc(32 * n);
        if (!cvs) return -1;
        stream_chunk_cvs(s, total, cvs);
        for (; n > 2; n = (n + 1) / 2) msb3_parent_level(cvs, n, cvs);
        memcpy(block, cvs, 64);
        if (cvs != few) free(cvs);
        compress(IV, block, 0, BLOCK_LEN, PARENT | ROOT, out16);
        memcpy(cv, out16, 32);
    }
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 4; j++) out[4 * i + j] = (uint8_t)(cv[i] >> (8 * j));
    return 0;
}

/* BLAKE3 of a message, through the same stream as the parts (one part of
 * host bytes).  Returns 0, or -1 if a message of more than 16 chunks finds
 * no memory for its chaining values. */
int msb3_hash(const uint8_t *data, uint64_t len, uint8_t out[32]) {
    uint64_t part[4] = {PART_BYTES, (uint64_t)(uintptr_t)data, len, 0};
    stream_t s = {part, 1, 0, 0, 0};
    return stream_hash(&s, out);
}

/* BLAKE3 over the concatenated parts (n_parts x 4 u64, kinds above; claims
 * values reduced mod p), straight from the parts: no byte image of the whole
 * is made.  With cvs, the non-root chaining value of every chunk (as
 * msb3_chunk_cvs gives them); else the root digest into digest.  Returns 0,
 * or -1 if the digest's chaining values find no memory. */
int msb3_parts(const uint64_t *parts, uint64_t n_parts, uint64_t p, uint32_t *cvs, uint8_t *digest) {
    stream_t s = {parts, n_parts, p, 0, 0};
    if (cvs) {
        stream_chunk_cvs(&s, stream_len(&s), cvs);
        return 0;
    }
    return stream_hash(&s, digest);
}

/* Bytes [start, start + len) of the concatenated parts into out. */
void msb3_parts_bytes(const uint64_t *parts, uint64_t n_parts, uint64_t p, uint64_t start, uint64_t len,
                      uint8_t *out) {
    stream_t s = {parts, n_parts, p, 0, 0};
    stream_read(&s, NULL, start);
    stream_read(&s, out, len);
}
