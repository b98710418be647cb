/* The host C counterpart of csrc/expr_sweep.cu: the same generated program
 * body (program.py fills in the @...@ fields) over the same macros, with the
 * field's canonical ops written in C, run over the rows in a loop.  It
 * exists so that the generated code itself runs in the CPU tests (built with
 * `cc`, loaded with ctypes); the card runs the CUDA template. */
#include <stdint.h>

#define FIELD @FIELD_ID@ /* 0 Goldilocks, 1 BabyBear */

#if FIELD == 0
static const uint64_t P = 0xFFFFFFFF00000001ull;
static inline uint64_t f_add(uint64_t a, uint64_t b) {
  unsigned __int128 s = (unsigned __int128)a + b;
  return (uint64_t)(s % P);
}
static inline uint64_t f_mul(uint64_t a, uint64_t b) { return (uint64_t)(((unsigned __int128)a * b) % P); }
#else
static const uint64_t P = 0x78000001ull;
static inline uint64_t f_add(uint64_t a, uint64_t b) { return (a + b) % P; }
static inline uint64_t f_mul(uint64_t a, uint64_t b) { return (a * b) % P; }
#endif
static inline uint64_t f_neg(uint64_t a) { return a ? P - a : 0; }
static inline uint64_t f_sub(uint64_t a, uint64_t b) { return f_add(a, f_neg(b)); }

static inline int64_t bitrev(int64_t i, int bits) {
  uint64_t r = 0;
  for (int b = 0; b < bits; b++) r |= (((uint64_t)i >> b) & 1u) << (bits - 1 - b);
  return bits ? (int64_t)r : i;
}

#define ADD(a, b) f_add(a, b)
#define SUB(a, b) f_sub(a, b)
#define MUL(a, b) f_mul(a, b)
#define NEG(a) f_neg(a)
#define VAR(s, c, o) bases[s][(int64_t)(c) * strides[s] + ((o) ? nxt : t)]
#define PUB(i) pubs[i]
#define SEL(s) sels[s][t]
#define APOW(k) apows[k]
#define OUT(plane, slot, v) out[(int64_t)(plane) * plane_stride + t * row_stride + (slot)] = (v)

/* The arguments of the CUDA entry, on host arrays. */
int expr_sweep_host(const uint64_t* const* bases, const int64_t* strides, int64_t rows, int64_t step, int brev_log,
                    const uint64_t* const* sels, const uint64_t* pubs, const uint64_t* apows, uint64_t* out,
                    int64_t plane_stride, int64_t row_stride) {
  (void)bases, (void)strides, (void)sels, (void)pubs, (void)apows;
  for (int64_t t = 0; t < rows; t++) {
    int64_t nxt = bitrev(t, brev_log) + step;
    if (nxt >= rows) nxt -= rows;
    nxt = bitrev(nxt, brev_log);
    (void)nxt;
@BODY@
  }
  return 0;
}
