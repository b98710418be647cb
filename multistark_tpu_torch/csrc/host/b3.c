/* Portable BLAKE3 (hash + 2-to-1 compress) and the Goldilocks^2 claims
 * accumulator: the host C helper of the PyTorch port's GoldilocksBlake3
 * config.
 *
 * The GPU does the batched hashing (kernel K3, csrc/blake3_merkle.cu); this
 * covers the host-side serial uses: challenger flushes, the commit- and
 * query-phase grinds and the claims accumulator.  It is the port's own copy
 * of the JAX package's csrc/b3.c, so that the port builds nothing from
 * outside its package.
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

/* ---- Goldilocks F_p[X]/(X^2 - 7) claims accumulator -----------------------
 * acc = sum_i (beta + sum_j gamma^j * v_ij)^-1 over n claims of L base
 * values each (reference src/prover.rs:381-387).  Host-linear transcript
 * work that must run at native speed at 2^20 claims; pinned against the
 * Python host field in tests/test_lookup.py. */

#define GLP 0xFFFFFFFF00000001ull
#define GLW 7ull /* X^2 = 7 */

static inline uint64_t gla(uint64_t a, uint64_t b) {
    uint64_t s = a + b;
    if (s < a) s += 0xFFFFFFFFull; /* wrap: +2^64 ≡ +(2^32-1) */
    if (s >= GLP) s -= GLP;
    return s;
}

static inline uint64_t gls(uint64_t a, uint64_t b) {
    uint64_t d = a - b;
    if (a < b) d -= 0xFFFFFFFFull; /* borrow: -2^64 ≡ -(2^32-1) */
    return d;
}

static inline uint64_t glm(uint64_t a, uint64_t b) {
    unsigned __int128 x = (unsigned __int128)a * b;
    uint64_t lo = (uint64_t)x, hi = (uint64_t)(x >> 64);
    uint64_t x2 = hi & 0xFFFFFFFFull, x3 = hi >> 32;
    uint64_t l = lo >= GLP ? lo - GLP : lo;
    uint64_t m = x2 * 0xFFFFFFFFull; /* exact, < 2^64 */
    if (m >= GLP) m -= GLP;
    return gls(gla(l, m), x3); /* x3 < 2^32 < p */
}

static inline uint64_t glinv(uint64_t a) { /* Fermat: a^(p-2) */
    uint64_t r = 1, e = GLP - 2;
    while (e) {
        if (e & 1) r = glm(r, a);
        a = glm(a, a);
        e >>= 1;
    }
    return r;
}

typedef struct { uint64_t c0, c1; } gl2;

static inline gl2 gl2_add(gl2 a, gl2 b) { return (gl2){gla(a.c0, b.c0), gla(a.c1, b.c1)}; }

static inline gl2 gl2_mul(gl2 a, gl2 b) {
    return (gl2){gla(glm(a.c0, b.c0), glm(GLW, glm(a.c1, b.c1))),
                 gla(glm(a.c0, b.c1), glm(a.c1, b.c0))};
}

static inline uint64_t glneg(uint64_t a) { return a ? GLP - a : 0; }

static inline gl2 gl2_inv(gl2 a) { /* (c0 - c1 X)/(c0^2 - W c1^2) */
    uint64_t d = gls(glm(a.c0, a.c0), glm(GLW, glm(a.c1, a.c1)));
    uint64_t di = glinv(d);
    return (gl2){glm(a.c0, di), glneg(glm(a.c1, di))};
}

/* vals: n*L row-major canonical base values; gamma/beta: 2 coords each;
 * scratch: caller-provided n*2 u64 buffer; out: 2 coords.
 * Returns 0 on success, 1 if some denominator was zero. */
int msgl_claims_acc2(const uint64_t *vals, uint64_t n, uint64_t L,
                     const uint64_t *gamma, const uint64_t *beta,
                     uint64_t *scratch, uint64_t *out) {
    gl2 g = {gamma[0], gamma[1]}, b = {beta[0], beta[1]};
    gl2 *d = (gl2 *)scratch;
    for (uint64_t i = 0; i < n; i++) {
        gl2 f = {0, 0};
        const uint64_t *row = vals + i * L;
        for (uint64_t j = L; j-- > 0;) {
            f = gl2_mul(f, g);
            f.c0 = gla(f.c0, row[j]);
        }
        d[i] = gl2_add(f, b);
    }
    /* Montgomery batch inverse: forward prefix products in place, one
     * inversion, backward sweep. */
    gl2 run = {1, 0};
    for (uint64_t i = 0; i < n; i++) {
        gl2 di = d[i];
        if ((di.c0 | di.c1) == 0) return 1;
        d[i] = run;          /* prefix product BEFORE element i */
        run = gl2_mul(run, di);
    }
    gl2 tinv = gl2_inv(run);
    /* walk back: inv_i = prefix_i * suffix_inv; suffix_inv *= d_i.
     * d_i was overwritten, so recompute fingerprints in reverse. */
    gl2 acc = {0, 0};
    for (uint64_t i = n; i-- > 0;) {
        gl2 f = {0, 0};
        const uint64_t *row = vals + i * L;
        for (uint64_t j = L; j-- > 0;) {
            f = gl2_mul(f, g);
            f.c0 = gla(f.c0, row[j]);
        }
        gl2 di = gl2_add(f, b);
        acc = gl2_add(acc, gl2_mul(d[i], tinv));
        tinv = gl2_mul(tinv, di);
    }
    out[0] = acc.c0;
    out[1] = acc.c1;
    return 0;
}

/* ---- Goldilocks radix-2 butterfly passes (host NTT accelerator) -----------
 * In-place DIF/DIT over a row-major (w, n) u64 matrix, mirroring
 * ntt.py _dif_np/_dit_np exactly (same stage order and butterfly algebra).
 * tw = concatenated per-stage twiddle tables in INCREASING stage order
 * (lengths 1, 2, 4, ..., n/2 — ntt.py _np_twiddles layout); DIF applies
 * them in reverse, DIT forward.  OpenMP-parallel over rows. */

#ifdef _OPENMP
#include <omp.h>
#endif

static void gl_dif_row(uint64_t *x, uint64_t n, uint64_t log_n, const uint64_t *tw) {
    for (uint64_t s = log_n; s >= 1; s--) {
        uint64_t half = 1ull << (s - 1);
        const uint64_t *t = tw + (half - 1); /* offset of stage s table */
        for (uint64_t blk = 0; blk < n; blk += 2 * half) {
            uint64_t *a = x + blk, *b = x + blk + half;
            for (uint64_t i = 0; i < half; i++) {
                uint64_t lo = gla(a[i], b[i]);
                uint64_t hi = glm(gls(a[i], b[i]), t[i]);
                a[i] = lo;
                b[i] = hi;
            }
        }
    }
}

static void gl_dit_row(uint64_t *x, uint64_t n, uint64_t log_n, const uint64_t *tw) {
    for (uint64_t s = 1; s <= log_n; s++) {
        uint64_t half = 1ull << (s - 1);
        const uint64_t *t = tw + (half - 1);
        for (uint64_t blk = 0; blk < n; blk += 2 * half) {
            uint64_t *a = x + blk, *b = x + blk + half;
            for (uint64_t i = 0; i < half; i++) {
                uint64_t m = glm(b[i], t[i]);
                uint64_t lo = gla(a[i], m);
                uint64_t hi = gls(a[i], m);
                a[i] = lo;
                b[i] = hi;
            }
        }
    }
}

/* But the Python mirrors interleave ACROSS the whole array (the stage's
 * butterfly pairs elements blk+i and blk+half+i within each 2*half block),
 * exactly as above.  DIF stage order: largest half first == reversed
 * increasing-stage tables; here s runs log_n..1 with table offset half-1,
 * matching _np_twiddles (stage s table starts at half-1 = 2^(s-1)-1). */

void msgl_dif(uint64_t *x, uint64_t w, uint64_t log_n, const uint64_t *tw) {
    uint64_t n = 1ull << log_n;
#pragma omp parallel for schedule(static)
    for (uint64_t r = 0; r < w; r++) gl_dif_row(x + r * n, n, log_n, tw);
}

void msgl_dit(uint64_t *x, uint64_t w, uint64_t log_n, const uint64_t *tw) {
    uint64_t n = 1ull << log_n;
#pragma omp parallel for schedule(static)
    for (uint64_t r = 0; r < w; r++) gl_dit_row(x + r * n, n, log_n, tw);
}

/* Batch inverse over n Goldilocks^2 elements (rows of 2 u64 coords), zeros
 * mapping to zero (p3 batch_multiplicative_inverse semantics).  Montgomery
 * trick with caller scratch (n*2 u64).  Returns 0. */
int msgl_batch_inv2(const uint64_t *in, uint64_t n, uint64_t *scratch, uint64_t *out) {
    gl2 *pre = (gl2 *)scratch;
    gl2 run = {1, 0};
    for (uint64_t i = 0; i < n; i++) {
        pre[i] = run; /* product of nonzero elements BEFORE i */
        gl2 v = {in[2 * i], in[2 * i + 1]};
        if ((v.c0 | v.c1) != 0) run = gl2_mul(run, v);
    }
    gl2 tinv = ((run.c0 | run.c1) != 0) ? gl2_inv(run) : (gl2){0, 0};
    for (uint64_t i = n; i-- > 0;) {
        gl2 v = {in[2 * i], in[2 * i + 1]};
        if ((v.c0 | v.c1) == 0) {
            out[2 * i] = 0;
            out[2 * i + 1] = 0;
        } else {
            gl2 r = gl2_mul(pre[i], tinv);
            out[2 * i] = r.c0;
            out[2 * i + 1] = r.c1;
            tinv = gl2_mul(tinv, v);
        }
    }
    return 0;
}

/* In-place inclusive prefix sum of n Goldilocks^2 elements. */
void msgl_prefix_sum2(uint64_t *x, uint64_t n) {
    uint64_t a = 0, b = 0;
    for (uint64_t i = 0; i < n; i++) {
        a = gla(a, x[2 * i]);
        b = gla(b, x[2 * i + 1]);
        x[2 * i] = a;
        x[2 * i + 1] = b;
    }
}
