/* Portable BLAKE3 (hash + 2-to-1 compress): the host C helper of the
 * PyTorch port's GoldilocksBlake3 config.
 *
 * The GPU does the batched hashing (kernel K3, csrc/blake3_merkle.cu); this
 * covers the host-side serial uses: challenger flushes, the commit- and
 * query-phase grinds and the host half of a device-duplex flush.  It is the
 * port's own copy of the BLAKE3 part of the JAX package's csrc/b3.c, so
 * that the port builds nothing from outside its package.
 *
 * Built with poseidon2.c into build/torch_kernels/libmshost.so by
 * multistark_tpu_torch/native.py.
 */

#include <stdint.h>
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

static uint64_t left_len_chunks(uint64_t n_chunks) {
    uint64_t p = 1;
    while (p * 2 < n_chunks) p *= 2;
    return p;
}

static void subtree_cv(const uint8_t *data, uint64_t len, uint64_t counter0, uint32_t out8[8]) {
    uint64_t n_chunks = (len + CHUNK_LEN - 1) / CHUNK_LEN;
    if (n_chunks <= 1) {
        chunk_cv(data, len, counter0, 0, out8);
        return;
    }
    uint64_t split = left_len_chunks(n_chunks) * CHUNK_LEN;
    uint32_t l[8], r[8], block[16], out16[16];
    subtree_cv(data, split, counter0, l);
    subtree_cv(data + split, len - split, counter0 + split / CHUNK_LEN, r);
    memcpy(block, l, 32);
    memcpy(block + 8, r, 32);
    compress(IV, block, 0, BLOCK_LEN, PARENT, out16);
    memcpy(out8, out16, 32);
}

void msb3_hash(const uint8_t *data, uint64_t len, uint8_t out[32]) {
    uint32_t cv[8];
    uint64_t n_chunks = len == 0 ? 1 : (len + CHUNK_LEN - 1) / CHUNK_LEN;
    if (n_chunks == 1) {
        chunk_cv(data, len, 0, 1, cv);
    } else {
        uint64_t split = left_len_chunks(n_chunks) * CHUNK_LEN;
        uint32_t l[8], r[8], block[16], out16[16];
        subtree_cv(data, split, 0, l);
        subtree_cv(data + split, len - split, split / CHUNK_LEN, r);
        memcpy(block, l, 32);
        memcpy(block + 8, r, 32);
        compress(IV, block, 0, BLOCK_LEN, PARENT | ROOT, out16);
        memcpy(cv, out16, 32);
    }
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 4; j++) out[4 * i + j] = (uint8_t)(cv[i] >> (8 * j));
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

/* Full BLAKE3 over n equal-length messages laid out contiguously (stride
 * bytes apart, len <= stride bytes each); out receives n×8 u32-LE digest
 * words. */
void msb3_hash_batch(const uint8_t *data, uint64_t stride, uint64_t len,
                     uint64_t n, uint32_t *out) {
    uint8_t d[32];
    for (uint64_t i = 0; i < n; i++) {
        msb3_hash(data + i * stride, len, d);
        for (int w = 0; w < 8; w++)
            out[8 * i + w] = (uint32_t)d[4 * w] | ((uint32_t)d[4 * w + 1] << 8) |
                             ((uint32_t)d[4 * w + 2] << 16) |
                             ((uint32_t)d[4 * w + 3] << 24);
    }
}

/* Grind helper: hash (prefix ‖ witness_le8) for witness in [start, start+count)
 * and return the first witness whose top-8 digest bytes, read as the
 * challenger's popped-byte u64, are < p and have the low `bits` bits zero.
 * Returns (uint64_t)-1 if none found. */
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
 * with counter i; the last chunk may be short): the host half of the device
 * duplex flush, which hashes on the device only the chunks that hold device
 * bytes.  out receives n_chunks x 8 words. */
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
 * (n + 1) / 2 x 8 words. */
void msb3_parent_level(const uint32_t *cvs, uint64_t n, uint32_t *out) {
    uint32_t block[16], out16[16];
    for (uint64_t p = 0; p < n / 2; p++) {
        memcpy(block, cvs + 16 * p, 64);
        compress(IV, block, 0, BLOCK_LEN, PARENT, out16);
        memcpy(out + 8 * p, out16, 32);
    }
    if (n % 2) memcpy(out + 8 * (n / 2), cvs + 8 * (n - 1), 32);
}
