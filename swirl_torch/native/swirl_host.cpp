// Native host kernels for swirl: Poseidon2-BabyBear-16 permutation, sponge
// row hashing, 2-to-1 compression, and Fiat-Shamir PoW grinding.
//
// The host-side peer of the reference's native (Rust) transcript/hasher hot
// loops (crates/stark-backend/src/hasher.rs, transcript/duplex_sponge.rs and
// the SIMD DuplexChallenger in stark-sdk). Device-side hashing stays in
// JAX/Pallas; this library accelerates the *host* verifier, keygen and
// transcript, which would otherwise be Python-bound.
//
// Round constants are injected from Python at init time (generated by the
// documented Grain-LFSR procedure in swirl/hash/grain.py) so the native and
// numpy implementations can never drift.
//
// All values are canonical (< P) uint64 lanes. Arithmetic uses 64-bit
// products reduced mod P; the compiler lowers `% P` to a multiply-high
// sequence for the constant modulus.

#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr uint64_t P = 2013265921ULL;  // BabyBear: 2^31 - 2^27 + 1
constexpr int WIDTH = 16;
constexpr int RATE = 8;
constexpr int DIGEST = 8;
constexpr int MAX_HALF_FULL = 8;
constexpr int MAX_PARTIAL = 64;

uint64_t EXT_INIT[MAX_HALF_FULL][WIDTH];
uint64_t EXT_FINAL[MAX_HALF_FULL][WIDTH];
uint64_t INT_RC[MAX_PARTIAL];
uint64_t DIAG[WIDTH];
int N_HALF_FULL = 0;
int N_PARTIAL = 0;

inline uint64_t addm(uint64_t a, uint64_t b) {
  uint64_t c = a + b;
  return c >= P ? c - P : c;
}

inline uint64_t mulm(uint64_t a, uint64_t b) { return (a * b) % P; }

inline uint64_t sbox7(uint64_t x) {
  uint64_t x2 = mulm(x, x);
  uint64_t x4 = mulm(x2, x2);
  return mulm(mulm(x4, x2), x);
}

inline void m4(uint64_t* s) {
  uint64_t x0 = s[0], x1 = s[1], x2 = s[2], x3 = s[3];
  uint64_t t01 = addm(x0, x1);
  uint64_t t23 = addm(x2, x3);
  uint64_t t0123 = addm(t01, t23);
  uint64_t t01123 = addm(t0123, x1);
  uint64_t t01233 = addm(t0123, x3);
  s[0] = addm(t01123, t01);
  s[1] = addm(t01123, addm(x2, x2));
  s[2] = addm(t01233, t23);
  s[3] = addm(t01233, addm(x0, x0));
}

inline void external_layer(uint64_t* s) {
  for (int c = 0; c < 4; ++c) m4(s + 4 * c);
  uint64_t sums[4];
  for (int i = 0; i < 4; ++i)
    sums[i] = addm(addm(s[i], s[4 + i]), addm(s[8 + i], s[12 + i]));
  for (int c = 0; c < 4; ++c)
    for (int i = 0; i < 4; ++i) s[4 * c + i] = addm(s[4 * c + i], sums[i]);
}

inline void internal_layer(uint64_t* s) {
  uint64_t total = 0;
  for (int i = 0; i < WIDTH; ++i) total = addm(total, s[i]);
  for (int i = 0; i < WIDTH; ++i) s[i] = addm(mulm(s[i], DIAG[i]), total);
}

void permute(uint64_t* s) {
  external_layer(s);
  for (int r = 0; r < N_HALF_FULL; ++r) {
    for (int i = 0; i < WIDTH; ++i) s[i] = sbox7(addm(s[i], EXT_INIT[r][i]));
    external_layer(s);
  }
  for (int r = 0; r < N_PARTIAL; ++r) {
    s[0] = sbox7(addm(s[0], INT_RC[r]));
    internal_layer(s);
  }
  for (int r = 0; r < N_HALF_FULL; ++r) {
    for (int i = 0; i < WIDTH; ++i) s[i] = sbox7(addm(s[i], EXT_FINAL[r][i]));
    external_layer(s);
  }
}

}  // namespace

extern "C" {

void swirl_p2_set_constants(const uint64_t* ext_init, const uint64_t* int_rc,
                            const uint64_t* ext_final, const uint64_t* diag,
                            int n_half_full, int n_partial) {
  N_HALF_FULL = n_half_full;
  N_PARTIAL = n_partial;
  for (int r = 0; r < n_half_full; ++r)
    for (int i = 0; i < WIDTH; ++i) {
      EXT_INIT[r][i] = ext_init[r * WIDTH + i];
      EXT_FINAL[r][i] = ext_final[r * WIDTH + i];
    }
  for (int r = 0; r < n_partial; ++r) INT_RC[r] = int_rc[r];
  for (int i = 0; i < WIDTH; ++i) DIAG[i] = diag[i];
}

// In-place permutation of n contiguous width-16 states.
void swirl_p2_permute_batch(uint64_t* states, int64_t n) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n > 64)
#endif
  for (int64_t i = 0; i < n; ++i) permute(states + WIDTH * i);
}

// Padding-free sponge over each row of an (n, w) matrix -> (n, 8) digests.
void swirl_p2_hash_rows(const uint64_t* mat, int64_t n, int64_t w,
                        uint64_t* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n > 16)
#endif
  for (int64_t r = 0; r < n; ++r) {
    uint64_t s[WIDTH] = {0};
    const uint64_t* row = mat + r * w;
    if (w == 0) {
      // p3 PaddingFreeSponge on empty input: no permutation, zero digest.
    } else {
      for (int64_t i = 0; i < w; i += RATE) {
        int64_t k = w - i < RATE ? w - i : RATE;
        for (int64_t j = 0; j < k; ++j) s[j] = row[i + j];
        permute(s);
      }
    }
    std::memcpy(out + r * DIGEST, s, DIGEST * sizeof(uint64_t));
  }
}

// 2-to-1 compression of n digest pairs: (n, 16) -> (n, 8).
void swirl_p2_compress_rows(const uint64_t* pairs, int64_t n, uint64_t* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n > 16)
#endif
  for (int64_t r = 0; r < n; ++r) {
    uint64_t s[WIDTH];
    std::memcpy(s, pairs + r * WIDTH, sizeof(s));
    permute(s);
    std::memcpy(out + r * DIGEST, s, DIGEST * sizeof(uint64_t));
  }
}

// Whether witness w, observed into the sponge snapshot (state, absorb_idx,
// sample_idx), makes the next sample's low bits under `mask` zero.
static inline bool grind_hit(const uint64_t* state, int absorb_idx,
                             int sample_idx, uint64_t mask, uint64_t w) {
  uint64_t s[WIDTH];
  std::memcpy(s, state, sizeof(s));
  s[absorb_idx] = w;
  int a = absorb_idx + 1, si = sample_idx;
  if (a == RATE) {
    permute(s);
    a = 0;
    si = RATE;
  }
  if (a != 0 || si == 0) {
    permute(s);
    si = RATE;
  }
  --si;
  return (s[si] & mask) == 0;
}

// Fiat-Shamir PoW grind: find the smallest witness w such that observing w
// into the sponge snapshot and sampling yields `bits` low zero bits.
// Mirrors Transcript.grind (swirl_torch/transcript.py). Returns -1 if none.
// Up to 12 bits a hit comes within a few thousand candidates: one thread
// checks them in index order and returns the first, which is the smallest.
// Above, threads check blocks of 2^16 candidates and take each block's least.
int64_t swirl_p2_grind(const uint64_t* state, int absorb_idx, int sample_idx,
                       int bits) {
  const uint64_t mask = (1ULL << bits) - 1;
  if (bits <= 12) {
    for (uint64_t w = 0; w < P; ++w)
      if (grind_hit(state, absorb_idx, sample_idx, mask, w)) return (int64_t)w;
    return -1;
  }
  const uint64_t BLOCK = 1 << 16;
  constexpr int64_t NONE = INT64_MAX;
  for (uint64_t base = 0; base < P; base += BLOCK) {
    uint64_t hi = base + BLOCK < P ? base + BLOCK : P;
    int64_t found = NONE;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) reduction(min : found)
#endif
    for (int64_t w = (int64_t)base; w < (int64_t)hi; ++w)
      if (grind_hit(state, absorb_idx, sample_idx, mask, (uint64_t)w) && w < found)
        found = w;
    if (found != NONE) return found;
  }
  return -1;
}

}  // extern "C"
