// The BN254 scalar field and its Poseidon2 permutations (widths 2 and 3)
// on the card, for the outer hash scheme's kernels G-J (bn254.cu).
//
// In memory an element is 8 little-endian 32-bit words (Fe), canonical or
// in Montgomery form with R = 2^256 (the JAX package's radix). Inside a
// kernel a value is 5 limbs of radix 2^52 (F5, 64-bit integers) in R' =
// 2^260 form, and products run on the FP64 pipe (Emmart, Zheng and Weems,
// "Faster Modular Exponentiation Using Double Precision Floating Point
// Arithmetic on the GPU", ARITH 2018): an operand's limbs are exact doubles
// below 2^52 (D5), and each partial product a * b takes
//
//     hi = fma_rz(a, b, 2^104)                 = 2^104 + (a b >> 52) 2^52
//     lo = fma_rz(a, b, (2^104 + 2^52) - hi)   = 2^52 + (a b mod 2^52)
//
// whose bit patterns, read as 64-bit integers, are the two halves plus the
// exponent's bits. Ten 64-bit column sums take them as they are, each
// starting from minus the exponent bits it will take (offset()). The
// Montgomery quotient m = (c_s mod 2^52) (-P^-1) mod 2^52 of each of the 5
// steps is one 64-bit integer product, and m P_0's low half is never made:
// c_s plus it is c_s rounded up to a multiple of 2^52.
//
// Bounds (fields/bn254.py f64_* and hash/bn254_poseidon2.py f64_* repeat
// every operation on Python ints and assert them): a product of values
// below a and b (normalized limbs, below 2^260) is below a b / 2^260 + P,
// so nothing is reduced before a digest leaves, except the partial
// rounds' lanes that no S-box takes (reduce()); adds are limb by limb with
// no carry, and the carries run (norm()) only before a product's operand.
#pragma once

#include <cstdint>

namespace bn254 {

constexpr int L = 8;

// P = 0x30644e72e131a029b85045b68181585d2833e84879b9709143e1f593f0000001
#define BN254_P_WORDS \
  0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u, 0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u

struct Fe {
  uint32_t w[L];
};

// r = t - P if t + top * 2^256 >= P, else t (the value is below 2P).
__device__ __forceinline__ Fe cond_sub_p(const uint32_t t[L], uint32_t top) {
  const uint32_t p[L] = {BN254_P_WORDS};
  Fe d;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const uint64_t s = (uint64_t)t[i] - p[i] - borrow;
    d.w[i] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const bool ge = top != 0 || borrow == 0;
  Fe r;
#pragma unroll
  for (int i = 0; i < L; ++i) r.w[i] = ge ? d.w[i] : t[i];
  return r;
}

// Kernel G's add, sub and dbl, on words.
__device__ __forceinline__ Fe add(const Fe& a, const Fe& b) {
  uint32_t t[L];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    c += (uint64_t)a.w[i] + b.w[i];
    t[i] = (uint32_t)c;
    c >>= 32;
  }
  return cond_sub_p(t, (uint32_t)c);
}

// a - b, plus P where that borrows: the JAX package's (a + P - b) with one
// conditional subtract, for any a, b below 2^256 with a + P below it.
__device__ __forceinline__ Fe sub(const Fe& a, const Fe& b) {
  const uint32_t p[L] = {BN254_P_WORDS};
  Fe d;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const uint64_t s = (uint64_t)a.w[i] - b.w[i] - borrow;
    d.w[i] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const uint32_t mask = 0u - borrow;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    c += (uint64_t)d.w[i] + (p[i] & mask);
    d.w[i] = (uint32_t)c;
    c >>= 32;
  }
  return d;
}

// ---------------------------------------------------------------------------
// 5 limbs of radix 2^52, products on the FP64 pipe
// ---------------------------------------------------------------------------

constexpr int NL = 5;
constexpr int RADIX = 52;
constexpr uint64_t M52 = (1ull << RADIX) - 1;
constexpr uint64_t LO_BITS = 0x4330000000000000ull;  // the bits of 2^52
constexpr uint64_t HI_BITS = 0x4670000000000000ull;  // the bits of 2^104
constexpr uint64_t NP52 = 0x1f593efffffffull;        // -P^-1 mod 2^52
constexpr double TWO52 = 0x1p52;
constexpr double C1 = 0x1p104;
constexpr double C2 = 0x1.0000000000001p104;  // 2^104 + 2^52
// q of reduce(): 32 / (P >> 208 + 1), rounded toward zero
constexpr double INV_P4 = 0x1.5291d18988e57p-41;

// P in limbs; x 2^(e - 260) is one product by K_e: K_520 takes a canonical
// value to R' form, K_516 to R form (2^256), K_264 an R-form value to R'
// form, K_256 an R'-form value to R form
#define BN254_P_LIMBS 0x1f593f0000001ull, 0x4879b9709143eull, 0x181585d2833e8ull, 0xa029b85045b68ull, 0x030644e72e131ull
#define BN254_K256_LIMBS 0x6341c4ffffffbull, 0x959f60cd29ac9ull, 0x879462e36fc76ull, 0xdf2f666ea36f7ull, 0x00e0a77c19a07ull
#define BN254_K264_LIMBS 0x31f8c9ffffab6ull, 0xac31329faef6eull, 0x9e2a3495d7570ull, 0xe357276f48b70ull, 0x00d791464ef86ull
#define BN254_K516_LIMBS 0xe645ae216da70ull, 0x1e35c59e31bb8ull, 0xbb808553fe3abull, 0x4a58c49833d53ull, 0x0216d0b17f4e4ull
#define BN254_K520_LIMBS 0x0b852d16da6f5ull, 0xc621620cddce3ull, 0xaf1b95343ffb6ull, 0xc3c15e103e7c2ull, 0x00281528fa122ull

struct F5 {
  uint64_t l[NL];
};
struct D5 {
  double d[NL];
};

__device__ __forceinline__ uint64_t bits(double x) { return (uint64_t)__double_as_longlong(x); }

// a limb below 2^52 as an exact double: its bits under 2^52's exponent, less 2^52
__device__ __forceinline__ double to_double(uint64_t x) {
  return __dsub_rn(__longlong_as_double((long long)(x | LO_BITS)), TWO52);
}

__device__ __forceinline__ D5 to_d5(const F5& x) {  // x normalized
  D5 r;
#pragma unroll
  for (int k = 0; k < NL; ++k) r.d[k] = to_double(x.l[k]);
  return r;
}

template <uint64_t L0, uint64_t L1, uint64_t L2, uint64_t L3, uint64_t L4>
__device__ __forceinline__ D5 const_d5() {
  return {{(double)L0, (double)L1, (double)L2, (double)L3, (double)L4}};
}

// Column k's start: minus the exponent bits of the halves it takes. Products
// a_i b_j put the low half at i + j and the high half at i + j + 1 (a square
// the same count: its cross products twice); quotient step s puts m_s P_t's
// low half at s + t (t >= 1) and its high half at s + t + 1.
__host__ __device__ constexpr int pairs(int k) {
  int n = 0;
  for (int i = 0; i < NL; ++i) n += k - i >= 0 && k - i < NL;
  return n;
}
__host__ __device__ constexpr int red_lo(int k) {
  int n = 0;
  for (int s = 0; s < NL; ++s) n += k - s >= 1 && k - s < NL;
  return n;
}
__host__ __device__ constexpr uint64_t offset(int k, bool ab) {
  return 0ull - ((uint64_t)((ab ? pairs(k) : 0) + red_lo(k)) * LO_BITS +
                 (uint64_t)((ab ? pairs(k - 1) : 0) + pairs(k - 1)) * HI_BITS);
}

// the two halves of a * b (exact limbs below 2^52) into columns k, k + 1,
// `times` times
__device__ __forceinline__ void mac(uint64_t c[2 * NL], int k, double a, double b, int times) {
  const double hi = __fma_rz(a, b, C1);
  const double lo = __fma_rz(a, b, __dsub_rz(C2, hi));
  c[k] += times == 2 ? bits(lo) + bits(lo) : bits(lo);
  c[k + 1] += times == 2 ? bits(hi) + bits(hi) : bits(hi);
}

// The 5 quotient steps and the carries: columns 5-9, normalized (c / 2^260
// mod P, below c / 2^260 + P).
__device__ __forceinline__ F5 redc(uint64_t c[2 * NL]) {
  const D5 p = const_d5<BN254_P_LIMBS>();
#pragma unroll
  for (int s = 0; s < NL; ++s) {
    const uint64_t m = ((c[s] & M52) * NP52) & M52;
    const double md = to_double(m);
    c[s + 1] += bits(__fma_rz(md, p.d[0], C1)) + ((c[s] + M52) >> RADIX);
#pragma unroll
    for (int t = 1; t < NL; ++t) mac(c, s + t, md, p.d[t], 1);
  }
  F5 r;
#pragma unroll
  for (int k = NL; k < 2 * NL - 1; ++k) {
    c[k + 1] += c[k] >> RADIX;
    r.l[k - NL] = c[k] & M52;
  }
  r.l[NL - 1] = c[2 * NL - 1];
  return r;
}

// a b / 2^260 mod P, below a b / 2^260 + P: 25 partial products (a square
// 15, its cross products added twice), then redc.
template <bool SQUARE>
__device__ __forceinline__ F5 mont(const D5& a, const D5& b) {
  uint64_t c[2 * NL];
#pragma unroll
  for (int k = 0; k < 2 * NL; ++k) c[k] = offset(k, true);
#pragma unroll
  for (int i = 0; i < NL; ++i)
#pragma unroll
    for (int j = SQUARE ? i : 0; j < NL; ++j) mac(c, i + j, a.d[i], b.d[j], SQUARE && i != j ? 2 : 1);
  return redc(c);
}

__device__ __forceinline__ F5 mul(const D5& a, const D5& b) { return mont<false>(a, b); }
__device__ __forceinline__ F5 sqr(const D5& a) { return mont<true>(a, a); }

// x / 2^260 mod P, below x / 2^260 + P: the quotient steps alone (x's limbs
// below 2^57)
__device__ __forceinline__ F5 redc_only(const F5& x) {
  uint64_t c[2 * NL];
#pragma unroll
  for (int k = 0; k < 2 * NL; ++k) c[k] = offset(k, false) + (k < NL ? x.l[k] : 0);
  return redc(c);
}

__device__ __forceinline__ F5 add5(const F5& a, const F5& b) {
  F5 r;
#pragma unroll
  for (int k = 0; k < NL; ++k) r.l[k] = a.l[k] + b.l[k];
  return r;
}

// the carries: limbs below 2^52 (the value below 2^260)
__device__ __forceinline__ F5 norm(F5 x) {
#pragma unroll
  for (int k = 0; k < NL - 1; ++k) {
    x.l[k + 1] += x.l[k] >> RADIX;
    x.l[k] &= M52;
  }
  return x;
}

// x mod P below 3P, x's limbs below 2^56: q = floor((top >> 5) 32 / (P >> 208
// + 1)) with top = x_4 + (x_3 >> 52) <= x / 2^208, so q P <= x (and q is at
// most 2 below floor(x / P)); then x - q P limb by limb, signed carries.
__device__ __forceinline__ F5 reduce(const F5& x) {
  const uint64_t p[NL] = {BN254_P_LIMBS};
  const uint64_t top = x.l[4] + (x.l[3] >> RADIX);
  const uint32_t q = (uint32_t)(bits(__fma_rz(to_double(top >> 5), INV_P4, TWO52)) - LO_BITS);
  int64_t y[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) y[k] = (int64_t)(x.l[k] - (uint64_t)q * p[k]);
  F5 r;
#pragma unroll
  for (int k = 0; k < NL - 1; ++k) {
    y[k + 1] += y[k] >> RADIX;  // arithmetic: a negative limb borrows
    r.l[k] = (uint64_t)y[k] & M52;
  }
  r.l[NL - 1] = (uint64_t)y[NL - 1];
  return r;
}

// the canonical value of normalized limbs below 2P: x - P unless that borrows
__device__ __forceinline__ F5 canon(const F5& x) {
  const uint64_t p[NL] = {BN254_P_LIMBS};
  int64_t d[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) d[k] = (int64_t)(x.l[k] - p[k]);
#pragma unroll
  for (int k = 0; k < NL - 1; ++k) {
    d[k + 1] += d[k] >> RADIX;
    d[k] &= (int64_t)M52;
  }
  F5 r;
  const bool neg = d[NL - 1] < 0;
#pragma unroll
  for (int k = 0; k < NL; ++k) r.l[k] = neg ? x.l[k] : (uint64_t)d[k];
  return r;
}

// words (a value below 2^256) <-> limbs; limbs(a, shift) gives a 2^shift's (shift < 5)
__device__ __forceinline__ F5 limbs(const Fe& a, int shift = 0) {
  uint64_t v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = (uint64_t)a.w[2 * i] | (uint64_t)a.w[2 * i + 1] << 32;
  const uint64_t top = shift ? v[3] >> (64 - shift) : 0;
#pragma unroll
  for (int i = 3; i > 0; --i) v[i] = shift ? v[i] << shift | v[i - 1] >> (64 - shift) : v[i];
  v[0] <<= shift;
  F5 r;
  r.l[0] = v[0] & M52;
  r.l[1] = (v[0] >> 52 | v[1] << 12) & M52;
  r.l[2] = (v[1] >> 40 | v[2] << 24) & M52;
  r.l[3] = (v[2] >> 28 | v[3] << 36) & M52;
  r.l[4] = v[3] >> 16 | top << 48;
  return r;
}

__device__ __forceinline__ Fe words(const F5& x) {  // normalized, below 2^256
  const uint64_t v[4] = {x.l[0] | x.l[1] << 52, x.l[1] >> 12 | x.l[2] << 40, x.l[2] >> 24 | x.l[3] << 28,
                         x.l[3] >> 36 | x.l[4] << 16};
  Fe r;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r.w[2 * i] = (uint32_t)v[i];
    r.w[2 * i + 1] = (uint32_t)(v[i] >> 32);
  }
  return r;
}

// a canonical value (below 2^256) -> R' form, below 2P
__device__ __forceinline__ F5 to_mont(const Fe& a) { return mul(to_d5(limbs(a)), const_d5<BN254_K520_LIMBS>()); }

// an R'-form lane (limbs below 2^57) -> its canonical words
__device__ __forceinline__ Fe to_canonical(const F5& x) { return words(canon(redc_only(x))); }

__device__ __forceinline__ F5 sbox(const F5& x) {  // x^5, x normalized
  const D5 xd = to_d5(x);
  const F5 x2 = sqr(xd);
  const F5 x4 = sqr(to_d5(x2));
  return mul(to_d5(x4), xd);
}

// The Poseidon2 instances (swirl_torch/hash/bn254_poseidon2.py _PARAMS):
// width 3 rF 8, rP 56, internal diagonal (1, 1, 2); width 2 rF 6, rP 50,
// diagonal (1, 2). The round constants (R' form, limbs) live in __constant__
// memory, set once per device by swirl_bn254_set_constants.
template <int T>
struct Shape;
template <>
struct Shape<3> {
  static constexpr int HALF = 4, PARTIAL = 56;
};
template <>
struct Shape<2> {
  static constexpr int HALF = 3, PARTIAL = 50;
};

template <int T>
struct RoundConstants {
  F5 ext_init[Shape<T>::HALF][T];
  F5 internal[Shape<T>::PARTIAL];
  F5 ext_final[Shape<T>::HALF][T];
};

__constant__ RoundConstants<3> c_rc3;
__constant__ RoundConstants<2> c_rc2;

template <int T>
__device__ __forceinline__ const RoundConstants<T>& rc() {
  if constexpr (T == 3) return c_rc3; else return c_rc2;
}

// M_E = J + I: every lane adds the sum of the lanes (no carries).
template <int T>
__device__ __forceinline__ void external_layer(F5 s[T]) {
  F5 total = s[0];
#pragma unroll
  for (int i = 1; i < T; ++i) total = add5(total, s[i]);
#pragma unroll
  for (int i = 0; i < T; ++i) s[i] = add5(total, s[i]);
}

template <int T>
__device__ __forceinline__ void full_round(F5 s[T], const F5 (&c)[T]) {
#pragma unroll
  for (int i = 0; i < T; ++i) s[i] = sbox(norm(add5(s[i], c[i])));
  external_layer<T>(s);
}

// The round loops are not unrolled: one round's code, its constants the
// same __constant__ words for every thread of a warp. A partial round: lane
// 0's S-box, M_I = J + diag(1, ..., 1, 2), then the other lanes below 3P.
template <int T>
__device__ __forceinline__ void permute(F5 s[T]) {
  external_layer<T>(s);
#pragma unroll 1
  for (int r = 0; r < Shape<T>::HALF; ++r) full_round<T>(s, rc<T>().ext_init[r]);
#pragma unroll 1
  for (int r = 0; r < Shape<T>::PARTIAL; ++r) {
    s[0] = sbox(norm(add5(s[0], rc<T>().internal[r])));
    F5 total = s[0];
#pragma unroll
    for (int i = 1; i < T; ++i) total = add5(total, s[i]);
    s[T - 1] = add5(s[T - 1], s[T - 1]);
    s[0] = add5(total, s[0]);
#pragma unroll
    for (int i = 1; i < T; ++i) s[i] = reduce(add5(total, s[i]));
  }
#pragma unroll 1
  for (int r = 0; r < Shape<T>::HALF; ++r) full_round<T>(s, rc<T>().ext_final[r]);
}

}  // namespace bn254
