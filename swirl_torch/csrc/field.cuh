// BabyBear arithmetic for the port's kernels (P = 2^31 - 2^27 + 1).
//
// Tensors hold canonical values in [0, P) as int64. The kernels compute
// in 32 bits: a Montgomery product (R = 2^32) of a canonical value and a
// Montgomery-form constant is canonical again, so twiddles are stored in
// Montgomery form and data stays canonical; Poseidon2 converts its state
// in and out once per permutation chain.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bb {

constexpr uint32_t P = 0x78000001u;
constexpr uint32_t NPRIME = 0x77ffffffu;  // -P^-1 mod 2^32
constexpr uint32_t R2 = 0x45dddde3u;      // 2^64 mod P

__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b) {
  // a, b < P: t < P^2 < P * 2^32, so the REDC result is below 2P.
  uint64_t t = (uint64_t)a * b;
  uint32_t m = (uint32_t)t * NPRIME;
  uint32_t u = (uint32_t)((t + (uint64_t)m * P) >> 32);
  return u >= P ? u - P : u;
}

__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  uint32_t s = a + b;  // < 2^32 since a, b < 2^31
  return s >= P ? s - P : s;
}

__device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) {
  return a >= b ? a - b : a + P - b;
}

__device__ __forceinline__ uint32_t to_mont(uint32_t a) { return mont_mul(a, R2); }
__device__ __forceinline__ uint32_t from_mont(uint32_t a) { return mont_mul(a, 1u); }

// The forms the hot loops of the Poseidon2 kernels and of the four-step NTT
// use: each reduction is an unsigned min, which sm_90a fuses with the add
// before it (VIADDMNMX), and the Montgomery product works against P^-1.
namespace fast {

constexpr uint32_t MU = 0x88000001u;  // P^-1 mod 2^32 (= 1 + 2^27 + 2^31)

// a + b mod P for a, b < P: s < 2P < 2^32, and the unsigned min of s and
// s - P (which wraps above 2^32 - P when s < P) is s mod P.
__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;
  return min(s, s - P);
}

// a - b mod P for a, b < P: d = a - b wraps above 2^32 - P when a < b,
// and then d + P < P is the smaller.
__device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) {
  const uint32_t d = a - b;
  return min(d, d + P);
}

// Montgomery product a * b / 2^32 mod P, left in (0, 2P), for a * b <
// P * 2^32 (a < 2^32 and b < P suffice). q = lo(t) * P^-1 makes t and q * P
// agree in their low words, so (t - q * P) / 2^32 = hi(t) - hi(q * P)
// exactly, with hi(t) < P (t < P * 2^32) and hi(q * P) < P (q < 2^32): in
// (-P, P), and + P puts it in (0, 2P).
__device__ __forceinline__ uint32_t mont_lazy(uint32_t a, uint32_t b) {
  const uint64_t t = (uint64_t)a * b;
  const uint32_t h = __umulhi((uint32_t)t * MU, P);
  return (uint32_t)(t >> 32) - h + P;
}

// The same, reduced: r < 2P, so min(r, r - P) is r mod P.
__device__ __forceinline__ uint32_t mont(uint32_t a, uint32_t b) {
  const uint32_t r = mont_lazy(a, b);
  return min(r, r - P);
}

}  // namespace fast
}  // namespace bb
