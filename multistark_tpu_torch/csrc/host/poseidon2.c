/* Poseidon2 (BabyBear, width 16) on the host: the permutation, the duplex
 * challenger's bulk absorb and its proof-of-work grind, for the PyTorch
 * port's BabyBearPoseidon2 config.
 *
 * The same permutation as multistark_tpu_torch/hash/poseidon2_host.py
 * `permute` (and the JAX package's hash/poseidon2.py): the external linear
 * layer, 4 full rounds, 13 partial rounds, 4 full rounds; x^7 S-box; the
 * external layer circ(2*M4, M4, M4, M4); the internal layer
 * y_i = d_i * x_i + sum(x).  Pinned to the Python permutation in
 * tests/test_torch_babybear.py.  The round constants come from the caller
 * (`consts`: external[8][16], internal[13], diagonal[16], canonical).
 *
 * Duplex semantics (multistark_tpu_torch/challenger.py DuplexChallenger):
 * observing a value appends it to the input buffer; a full buffer of 8
 * overwrites lanes 0..7 of the state and permutes.  A sample after an
 * observe permutes any pending input the same way and pops lane 7.
 *
 * Built with b3.c into build/torch_kernels/libmshost.so by
 * multistark_tpu_torch/native.py.
 */

#include <stdint.h>
#include <string.h>

enum { WIDTH = 16, RATE = 8, ROUNDS_F = 8, ROUNDS_P = 13 };

static const uint64_t P = 2013265921u; /* 2^31 - 2^27 + 1 */

static inline uint32_t sbox(uint32_t x) {
    uint64_t x2 = (uint64_t)x * x % P;
    uint64_t x4 = x2 * x2 % P;
    return (uint32_t)(x4 * x2 % P * x % P);
}

static void external_linear(uint32_t *s) {
    uint64_t t[WIDTH];
    for (int b = 0; b < WIDTH; b += 4) {
        uint64_t x0 = s[b], x1 = s[b + 1], x2 = s[b + 2], x3 = s[b + 3];
        t[b] = (2 * x0 + 3 * x1 + x2 + x3) % P;
        t[b + 1] = (x0 + 2 * x1 + 3 * x2 + x3) % P;
        t[b + 2] = (x0 + x1 + 2 * x2 + 3 * x3) % P;
        t[b + 3] = (3 * x0 + x1 + x2 + 2 * x3) % P;
    }
    for (int i = 0; i < 4; i++) {
        uint64_t sum = t[i] + t[4 + i] + t[8 + i] + t[12 + i];
        for (int b = 0; b < WIDTH; b += 4) s[b + i] = (uint32_t)((t[b + i] + sum) % P);
    }
}

static void internal_linear(uint32_t *s, const uint32_t *diag) {
    uint64_t tot = 0;
    for (int i = 0; i < WIDTH; i++) tot += s[i];
    for (int i = 0; i < WIDTH; i++) s[i] = (uint32_t)(((uint64_t)diag[i] * s[i] + tot) % P);
}

void msp2_permute(uint32_t *s, const uint32_t *consts) {
    const uint32_t *internal = consts + ROUNDS_F * WIDTH;
    const uint32_t *diag = internal + ROUNDS_P;
    external_linear(s);
    for (int r = 0; r < ROUNDS_F; r++) {
        if (r == ROUNDS_F / 2) {
            for (int k = 0; k < ROUNDS_P; k++) {
                s[0] = sbox((uint32_t)((s[0] + (uint64_t)internal[k]) % P));
                internal_linear(s, diag);
            }
        }
        for (int i = 0; i < WIDTH; i++) s[i] = sbox((uint32_t)((s[i] + (uint64_t)consts[r * WIDTH + i]) % P));
        external_linear(s);
    }
}

/* Observe n canonical values in order.  `state` (16 lanes), `in_buf` and
 * `*in_len` are the challenger's; returns 1 if the last value filled the
 * buffer (the output buffer is then lanes 0..7), else 0 (it is empty). */
int msp2_absorb(uint32_t *state, uint32_t *in_buf, uint32_t *in_len, const uint32_t *vals, uint64_t n,
                const uint32_t *consts) {
    int duplexed = 0;
    for (uint64_t i = 0; i < n; i++) {
        in_buf[(*in_len)++] = vals[i];
        duplexed = 0;
        if (*in_len == RATE) {
            memcpy(state, in_buf, RATE * sizeof(uint32_t));
            msp2_permute(state, consts);
            *in_len = 0;
            duplexed = 1;
        }
    }
    return duplexed;
}

/* The smallest witness w < count such that observing w (as w mod p) and
 * sampling one value gives a value whose low `bits` bits are zero; the
 * challenger's state is not changed.  Returns (uint64_t)-1 if none. */
uint64_t msp2_grind(const uint32_t *state, const uint32_t *in_buf, uint32_t in_len, uint32_t bits, uint64_t count,
                    const uint32_t *consts) {
    const uint32_t mask = bits >= 32 ? 0xFFFFFFFFu : ((1u << bits) - 1u);
    if (in_len >= RATE) return (uint64_t)-1;
    for (uint64_t w = 0; w < count; w++) {
        uint32_t s[WIDTH];
        memcpy(s, state, sizeof(s));
        memcpy(s, in_buf, in_len * sizeof(uint32_t));
        s[in_len] = (uint32_t)(w % P);
        msp2_permute(s, consts);
        if ((s[RATE - 1] & mask) == 0) return w;
    }
    return (uint64_t)-1;
}

/* The Merkle leaf hash of n rows of `width` canonical values each (row i at
 * vals + i * width): the padding-free sponge (width 16, rate 8), each chunk
 * of up to 8 values overwriting the first lanes before a permutation; out
 * receives the first 8 lanes per row (an empty row hashes to zeros).  The
 * verifier's batched Merkle walk (merkle.Poseidon2FieldHasher). */
void msp2_hash_rows(const uint32_t *vals, uint64_t width, uint64_t n, uint32_t *out, const uint32_t *consts) {
    for (uint64_t i = 0; i < n; i++) {
        uint32_t s[WIDTH] = {0};
        const uint32_t *row = vals + i * width;
        for (uint64_t c = 0; c < width; c += RATE) {
            uint64_t k = width - c < RATE ? width - c : RATE;
            memcpy(s, row + c, k * sizeof(uint32_t));
            msp2_permute(s, consts);
        }
        memcpy(out + 8 * i, s, 8 * sizeof(uint32_t));
    }
}

/* The Merkle 2-to-1 compression of n digest pairs (left/right: n x 8
 * canonical values): the truncated permutation of left || right. */
void msp2_compress_pairs(const uint32_t *left, const uint32_t *right, uint64_t n, uint32_t *out,
                         const uint32_t *consts) {
    for (uint64_t i = 0; i < n; i++) {
        uint32_t s[WIDTH];
        memcpy(s, left + 8 * i, 8 * sizeof(uint32_t));
        memcpy(s + 8, right + 8 * i, 8 * sizeof(uint32_t));
        msp2_permute(s, consts);
        memcpy(out + 8 * i, s, 8 * sizeof(uint32_t));
    }
}
