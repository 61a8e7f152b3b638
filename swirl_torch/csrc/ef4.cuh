// EF4 = F_p[x]/(x^4 - 11) arithmetic for the port's kernels K (gkr.cu) and
// L (ef4.cu).
//
// A value is four 32-bit canonical words, read from and written to the
// tensors' canonical int64 storage as two 16-byte words (so an element's
// address is a multiple of 16 bytes). A constant factor b is turned into
// Montgomery form once (Factor: b R, and 11 b R for the x^4 = 11 terms),
// so a product by it is exact and canonical; a product of two data values
// is a Montgomery product without conversion (a b / R).
#pragma once

#include "field.cuh"

namespace ef4 {

constexpr uint64_t R_MOD = (1ull << 32) % bb::P;
constexpr uint32_t W11 = (uint32_t)(11 * R_MOD % bb::P);  // a Montgomery product by it: times 11

struct Ef {
  uint32_t v[4];
};

// A factor b in the form its products take: m = b R, w = 11 b R (w[0] unused).
struct Factor {
  uint32_t m[4];
  uint32_t w[4];
};

__device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) { return bb::fast::mont(a, b); }
__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) { return bb::fast::add(a, b); }
__device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) { return bb::fast::sub(a, b); }

__device__ __forceinline__ Ef eadd(const Ef& a, const Ef& b) {
  return Ef{{add(a.v[0], b.v[0]), add(a.v[1], b.v[1]), add(a.v[2], b.v[2]), add(a.v[3], b.v[3])}};
}

__device__ __forceinline__ Ef esub(const Ef& a, const Ef& b) {
  return Ef{{sub(a.v[0], b.v[0]), sub(a.v[1], b.v[1]), sub(a.v[2], b.v[2]), sub(a.v[3], b.v[3])}};
}

__device__ __forceinline__ Factor factor(const Ef& b) {
  Factor f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f.m[j] = mul(b.v[j], bb::R2);
    f.w[j] = mul(f.m[j], W11);
  }
  return f;
}

// a b for a factor b, at a's scale
__device__ __forceinline__ Ef fmul(const Ef& a, const Factor& b) {
  const uint32_t* x = a.v;
  return Ef{{
      add(add(mul(x[0], b.m[0]), mul(x[1], b.w[3])), add(mul(x[2], b.w[2]), mul(x[3], b.w[1]))),
      add(add(mul(x[0], b.m[1]), mul(x[1], b.m[0])), add(mul(x[2], b.w[3]), mul(x[3], b.w[2]))),
      add(add(mul(x[0], b.m[2]), mul(x[1], b.m[1])), add(mul(x[2], b.m[0]), mul(x[3], b.w[3]))),
      add(add(mul(x[0], b.m[3]), mul(x[1], b.m[2])), add(mul(x[2], b.m[1]), mul(x[3], b.m[0]))),
  }};
}

// a b / R for two values
__device__ __forceinline__ Ef rmul(const Ef& a, const Ef& b) {
  const uint32_t* x = a.v;
  const uint32_t* y = b.v;
  const uint32_t h0 = add(add(mul(x[1], y[3]), mul(x[2], y[2])), mul(x[3], y[1]));
  const uint32_t h1 = add(mul(x[2], y[3]), mul(x[3], y[2]));
  const uint32_t h2 = mul(x[3], y[3]);
  return Ef{{
      add(mul(x[0], y[0]), mul(h0, W11)),
      add(add(mul(x[0], y[1]), mul(x[1], y[0])), mul(h1, W11)),
      add(add(mul(x[0], y[2]), mul(x[1], y[1])), add(mul(x[2], y[0]), mul(h2, W11))),
      add(add(mul(x[0], y[3]), mul(x[1], y[2])), add(mul(x[2], y[1]), mul(x[3], y[0]))),
  }};
}

__device__ __forceinline__ Ef load(const int64_t* p) {
  const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(p));
  const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(p) + 1);
  return Ef{{(uint32_t)a.x, (uint32_t)a.y, (uint32_t)b.x, (uint32_t)b.y}};
}

__device__ __forceinline__ void store(int64_t* p, const Ef& e) {
  reinterpret_cast<longlong2*>(p)[0] = make_longlong2(e.v[0], e.v[1]);
  reinterpret_cast<longlong2*>(p)[1] = make_longlong2(e.v[2], e.v[3]);
}

}  // namespace ef4
