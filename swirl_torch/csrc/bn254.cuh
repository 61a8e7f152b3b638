// The BN254 scalar field and its Poseidon2 permutations (widths 2 and 3)
// on the card, for the outer hash scheme's kernels G-J (bn254.cu).
//
// An element is 8 little-endian 32-bit words, in Montgomery form with R =
// 2^256 (the JAX package's radix: swirl/fields/jbn254.py keeps the same
// values in 16 x 16-bit limbs). Products are word-serial Montgomery (CIOS)
// over the 8 words, every partial product a 32 x 32 -> 64-bit multiply-add
// (IMAD.WIDE), and every operation leaves its result fully reduced, below
// P. Nothing here assumes more of an input than that it is below 2^256
// and, for a product, that a * b / 2^256 + P fits (true for inputs below
// P, and for P itself).
#pragma once

#include <cstdint>

namespace bn254 {

constexpr int L = 8;

// P = 0x30644e72e131a029b85045b68181585d2833e84879b9709143e1f593f0000001
#define BN254_P_WORDS \
  0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u, 0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u
// R^2 mod P, R = 2^256: a product by it takes a canonical value to Monty form
#define BN254_R2_WORDS \
  0xae216da7u, 0x1bb8e645u, 0xe35c59e3u, 0x53fe3ab1u, 0x53bb8085u, 0x8c49833du, 0x7f4e44a5u, 0x0216d0b1u
constexpr uint32_t NP0 = 0xefffffffu;  // -P^-1 mod 2^32

struct Fe {
  uint32_t w[L];
};

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int i = 0; i < L; ++i) r.w[i] = 0;
  return r;
}

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

// a * b / 2^256 mod P: CIOS. Step i adds a * b_i into t (9 words and a
// carry word), then m * P with m = t_0 * (-P^-1) mod 2^32, which clears
// word 0, and shifts one word down. Every a_j * b_i + t_j + carry is at
// most (2^32 - 1)^2 + 2 (2^32 - 1) = 2^64 - 1: no 64-bit overflow.
__device__ __forceinline__ Fe mont_mul(const Fe& a, const Fe& b) {
  const uint32_t p[L] = {BN254_P_WORDS};
  uint32_t t[L + 2];
#pragma unroll
  for (int j = 0; j < L + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      c += (uint64_t)a.w[j] * b.w[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[L];
    t[L] = (uint32_t)c;
    t[L + 1] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * NP0;
    c = ((uint64_t)m * p[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < L; ++j) {
      c += (uint64_t)m * p[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[L];
    t[L - 1] = (uint32_t)c;
    t[L] = t[L + 1] + (uint32_t)(c >> 32);
  }
  return cond_sub_p(t, t[L]);
}

__device__ __forceinline__ Fe to_mont(const Fe& a) {
  const Fe r2 = {{BN254_R2_WORDS}};
  return mont_mul(a, r2);
}

__device__ __forceinline__ Fe from_mont(const Fe& a) {
  Fe one = fe_zero();
  one.w[0] = 1;
  return mont_mul(a, one);
}

__device__ __forceinline__ Fe sbox(const Fe& x) {  // x^5
  const Fe x2 = mont_mul(x, x);
  const Fe x4 = mont_mul(x2, x2);
  return mont_mul(x4, x);
}

// The Poseidon2 instances (swirl_torch/hash/bn254_poseidon2.py _PARAMS):
// width 3 rF 8, rP 56, internal diagonal (1, 1, 2); width 2 rF 6, rP 50,
// diagonal (1, 2). The round constants (Monty) live in __constant__
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
  Fe ext_init[Shape<T>::HALF][T];
  Fe internal[Shape<T>::PARTIAL];
  Fe ext_final[Shape<T>::HALF][T];
};

__constant__ RoundConstants<3> c_rc3;
__constant__ RoundConstants<2> c_rc2;

// the constants read straight from the symbols (LDC), lane i of round r
template <int T>
__device__ __forceinline__ Fe rc_init(int r, int i) {
  if constexpr (T == 3) return c_rc3.ext_init[r][i]; else return c_rc2.ext_init[r][i];
}
template <int T>
__device__ __forceinline__ Fe rc_internal(int r) {
  if constexpr (T == 3) return c_rc3.internal[r]; else return c_rc2.internal[r];
}
template <int T>
__device__ __forceinline__ Fe rc_final(int r, int i) {
  if constexpr (T == 3) return c_rc3.ext_final[r][i]; else return c_rc2.ext_final[r][i];
}

// M_E = J + I: every lane adds the sum of the lanes.
template <int T>
__device__ __forceinline__ void external_layer(Fe s[T]) {
  Fe total = s[0];
#pragma unroll
  for (int i = 1; i < T; ++i) total = add(total, s[i]);
#pragma unroll
  for (int i = 0; i < T; ++i) s[i] = add(total, s[i]);
}

// M_I = J + diag(d) with d = (1, ..., 1, 2): the last lane doubles.
template <int T>
__device__ __forceinline__ void internal_layer(Fe s[T]) {
  Fe total = s[0];
#pragma unroll
  for (int i = 1; i < T; ++i) total = add(total, s[i]);
  s[T - 1] = add(s[T - 1], s[T - 1]);
#pragma unroll
  for (int i = 0; i < T; ++i) s[i] = add(total, s[i]);
}

// One full round; `final` picks the external final constants.
template <int T>
__device__ __forceinline__ void full_round(Fe s[T], int r, bool final) {
#pragma unroll
  for (int i = 0; i < T; ++i) s[i] = sbox(add(s[i], final ? rc_final<T>(r, i) : rc_init<T>(r, i)));
  external_layer<T>(s);
}

// The rounds loops (not unrolled: one round's code, its constants indexed
// by the round, the same word for every thread of a warp).
template <int T>
__device__ __forceinline__ void permute(Fe s[T]) {
  external_layer<T>(s);
#pragma unroll 1
  for (int r = 0; r < Shape<T>::HALF; ++r) full_round<T>(s, r, false);
#pragma unroll 1
  for (int r = 0; r < Shape<T>::PARTIAL; ++r) {
    s[0] = sbox(add(s[0], rc_internal<T>(r)));
    internal_layer<T>(s);
  }
#pragma unroll 1
  for (int r = 0; r < Shape<T>::HALF; ++r) full_round<T>(s, r, true);
}

}  // namespace bn254
