// Kernels B, C, D: Poseidon2-BabyBear-16 for Merkle trees.
//
// B  hash_cols    replaces swirl/tpu/poseidon2_pallas.py _hash_kernel (:143)
//                 via _hash_cols_fn (:189) / hash_cols (:247): padding-free
//                 sponge leaf hash, one column of a (w, n) or (w, n, d)
//                 matrix per leaf, its rows read where they lie.
// C  compress     replaces _compress_kernel (:259) via compress_cols (:318):
//                 one permutation of concat(left, right) per pair, truncated;
//                 the pairs are read in place from a digest layer.
// D  tower        replaces _tower_kernel (:327) via compress_tower (:408):
//                 every level from <= 8192 digests to the root in one launch.
//
// What bounds it on the H100: the multiply pipe. A Montgomery product
// needs the high halves of two 32x32-bit products (IMAD.WIDE, IMAD.HI),
// which the card issues at about a third of the rate of a plain IMAD, and
// one permutation has 564 products in its 141 S-boxes; the data movement
// is small. Design: one thread per permutation with the 16-word state in
// registers; every round unrolled, so the round constants (in __constant__
// memory, the same word for every thread of a warp) are operands of the
// adds. The partial rounds' diagonal (Plonky3's [-2, 1, 2, 1/2, 3, 4, -1/2,
// -3, -4, 2^-8, 1/4, 1/8, 2^-27, -2^-8, -1/16, -2^-27]) takes no product:
// Montgomery form is linear, so it is adds, halvings and the shift form of
// 2^-k below, and the sum of lanes 1..15 is a tree that runs beside lane
// 0's S-box. Adds reduce with the unsigned min of s and s - P (no
// predicate). The TPU kernel carried the sponge state across grid steps
// of its absorb axis; here the absorb is a loop inside the thread. Inputs
// and outputs are the port's canonical int64 tensors; the state runs in
// Montgomery form between the conversion at load and at store. The tower
// is one block that walks the levels in shared memory (ping-pong buffers)
// and writes every level out, because query proofs open all of them; the
// first level is read from global memory, so 8192 input digests need only
// 24 * 8192 bytes of shared memory.
#include "field.cuh"

namespace {

constexpr int WIDTH = 16;
constexpr int DIGEST = 8;
constexpr int RATE = 8;
constexpr int HALF_FULL = 4;
constexpr int PARTIAL = 13;
constexpr int TOWER_MAX = 8192;

constexpr uint32_t P = bb::P;
constexpr uint32_t MU = bb::fast::MU;

__constant__ uint32_t c_ext_init[HALF_FULL][WIDTH];
__constant__ uint32_t c_internal[PARTIAL];
__constant__ uint32_t c_ext_final[HALF_FULL][WIDTH];

using bb::fast::add;
using bb::fast::mont;
using bb::fast::mont_lazy;
using bb::fast::sub;

__device__ __forceinline__ uint32_t to_mont(uint32_t a) { return mont(a, bb::R2); }

// x / 2^32 mod P for x < P: t = x has hi(t) = 0, so the product is
// -hi(q * P) mod P; for h = 0 the min picks 0 - h = 0, else P - h.
__device__ __forceinline__ uint32_t from_mont(uint32_t x) {
  const uint32_t h = __umulhi(x * MU, P);
  return min(0u - h, P - h);
}

// x / 2 mod P for x < P: x + P < 2^32 is even when x is odd; the result
// is at most (2P - 2) / 2 = P - 1.
__device__ __forceinline__ uint32_t halve(uint32_t x) { return (x + (x & 1u) * P) >> 1; }

// x * 2^-K mod P for x < P, 2 <= K <= 27, with no Montgomery product:
// x = hi * 2^K + lo gives x * 2^-K = hi + lo * 2^-K, and 2^-K = -15 *
// 2^(27-K) mod P because 15 * 2^27 = P - 1. With lo <= 2^K - 1 the value
// v = hi + P - 15 * 2^(27-K) * lo lies in [1, P + 2^(31-K)), below 2P;
// w = v - P (mod 2^32) and min(w + P, w) is v mod P.
template <int K>
__device__ __forceinline__ uint32_t div2k(uint32_t x) {
  const uint32_t w = (x >> K) - (x & ((1u << K) - 1u)) * (15u << (27 - K));
  return min(w + P, w);
}

// x^7 for x < P. x2 and x4 are reduced (x2 is squared); x3 is left in
// (0, 2P): x3 * x4 < 2P * P < P * 2^32, as mont_lazy asks.
__device__ __forceinline__ uint32_t sbox(uint32_t x) {
  const uint32_t x2 = mont(x, x);
  const uint32_t x3 = mont_lazy(x2, x);
  const uint32_t x4 = mont(x2, x2);
  return mont(x3, x4);
}

// M4 = [[2,3,1,1],[1,2,3,1],[1,1,2,3],[3,1,1,2]] by the add chain of
// swirl/hash/poseidon2.py _m4_np
__device__ __forceinline__ void m4(uint32_t* x) {
  const uint32_t t01 = add(x[0], x[1]);
  const uint32_t t23 = add(x[2], x[3]);
  const uint32_t t0123 = add(t01, t23);
  const uint32_t t01123 = add(t0123, x[1]);
  const uint32_t t01233 = add(t0123, x[3]);
  const uint32_t y1 = add(t01123, add(x[2], x[2]));
  const uint32_t y3 = add(t01233, add(x[0], x[0]));
  x[0] = add(t01123, t01);
  x[1] = y1;
  x[2] = add(t01233, t23);
  x[3] = y3;
}

__device__ __forceinline__ void external_layer(uint32_t* s) {
#pragma unroll
  for (int c = 0; c < 4; ++c) m4(s + 4 * c);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t sum = add(add(s[j], s[4 + j]), add(s[8 + j], s[12 + j]));
#pragma unroll
    for (int c = 0; c < 4; ++c) s[4 * c + j] = add(s[4 * c + j], sum);
  }
}

__device__ __forceinline__ void full_round(uint32_t* s, const uint32_t* rc) {
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = sbox(add(s[i], rc[i]));
  external_layer(s);
}

// s_i <- d_i * s_i + sum(s) after lane 0's S-box, with Plonky3's diagonal:
// d_0 = -2 makes lane 0 part - s_0, where part is the sum of lanes 1..15.
__device__ __forceinline__ void partial_round(uint32_t* s, uint32_t rc) {
  uint32_t a[8];
#pragma unroll
  for (int i = 0; i < 7; ++i) a[i] = add(s[1 + 2 * i], s[2 + 2 * i]);
  a[7] = s[15];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = add(a[2 * i], a[2 * i + 1]);
  const uint32_t part = add(add(a[0], a[1]), add(a[2], a[3]));
  const uint32_t x = sbox(add(s[0], rc));
  const uint32_t full = add(part, x);
  s[0] = sub(part, x);
  s[1] = add(s[1], full);
  s[2] = add(add(s[2], s[2]), full);
  s[3] = add(halve(s[3]), full);
  s[4] = add(add(add(s[4], s[4]), s[4]), full);
  const uint32_t s5 = add(s[5], s[5]);
  s[5] = add(add(s5, s5), full);
  s[6] = sub(full, halve(s[6]));
  s[7] = sub(full, add(add(s[7], s[7]), s[7]));
  const uint32_t s8 = add(s[8], s[8]);
  s[8] = sub(full, add(s8, s8));
  s[9] = add(div2k<8>(s[9]), full);
  s[10] = add(div2k<2>(s[10]), full);
  s[11] = add(div2k<3>(s[11]), full);
  s[12] = add(div2k<27>(s[12]), full);
  s[13] = sub(full, div2k<8>(s[13]));
  s[14] = sub(full, div2k<4>(s[14]));
  s[15] = sub(full, div2k<27>(s[15]));
}

// state in Montgomery form
__device__ __forceinline__ void permute(uint32_t* s) {
  external_layer(s);
#pragma unroll
  for (int r = 0; r < HALF_FULL; ++r) full_round(s, c_ext_init[r]);
#pragma unroll
  for (int r = 0; r < PARTIAL; ++r) partial_round(s, c_internal[r]);
#pragma unroll
  for (int r = 0; r < HALF_FULL; ++r) full_round(s, c_ext_final[r]);
}

// Row r (of w) of column col lies at in[(r >> log_d) * (n << log_d) +
// (col << log_d) + (r & (2^log_d - 1))]: log_d = 0 for a (w, n) matrix,
// 2 for the (w / 4, n, 4) extension-field codeword read in place.
__global__ void __launch_bounds__(128) hash_cols_kernel(const int64_t* __restrict__ in,
                                                        int64_t* __restrict__ out, int w,
                                                        long long n, int log_d) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  const int64_t* src = in + (col << log_d);
  const long long row_stride = n << log_d;
  const int dmask = (1 << log_d) - 1;
  uint32_t s[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = 0;
  for (int base = 0; base < w; base += RATE) {
    const int len = w - base < RATE ? w - base : RATE;
#pragma unroll
    for (int j = 0; j < RATE; ++j) {  // static indices keep s in registers
      const int r = base + j;
      if (j < len) s[j] = to_mont((uint32_t)src[(r >> log_d) * row_stride + (r & dmask)]);
    }
    permute(s);
  }
#pragma unroll
  for (int j = 0; j < DIGEST; ++j) out[j * n + col] = from_mont(s[j]);
}

// Output column o < m compresses the digest at column L = 2s * (o / s) +
// o % s (s = 2^log_s) of an (8, ld) layer, lanes at stride ld, with the
// one at L + off: off = s pairs a layer in place; log_s = 62 (L = o) with
// off = 8 * ld reads a (16, ld) pairs tensor.
__global__ void __launch_bounds__(128) compress_kernel(const int64_t* __restrict__ in,
                                                       int64_t* __restrict__ out, long long m,
                                                       long long ld, int log_s, long long off) {
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= m) return;
  const long long left = ((o >> log_s) << (log_s + 1)) + (o & ((1LL << log_s) - 1));
  uint32_t s[WIDTH];
#pragma unroll
  for (int j = 0; j < DIGEST; ++j) {
    s[j] = to_mont((uint32_t)in[j * ld + left]);
    s[DIGEST + j] = to_mont((uint32_t)in[j * ld + left + off]);
  }
  permute(s);
#pragma unroll
  for (int j = 0; j < DIGEST; ++j) out[j * m + o] = from_mont(s[j]);
}

// in: (8, n) digests, n a power of two in [2, TOWER_MAX]. out: level l
// (n >> l digests, l = 1..log n) as an (8, n >> l) block at offset
// 8 * (n - 2 * (n >> l)). Shared: two Montgomery ping-pong buffers of
// n/2 and n/4 digests, lane-major.
__global__ void tower_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out, int n) {
  extern __shared__ uint32_t smem[];
  uint32_t* buf[2] = {smem, smem + DIGEST * (n / 2)};
  const uint32_t* prev = nullptr;
  int level = 0;
  for (int m = n / 2; m >= 1; m /= 2, ++level) {
    uint32_t* dst = buf[level & 1];
    int64_t* gout = out + (long long)DIGEST * (n - 2 * m);
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      uint32_t s[WIDTH];
#pragma unroll
      for (int j = 0; j < DIGEST; ++j) {
        if (prev == nullptr) {
          s[j] = to_mont((uint32_t)in[j * n + 2 * i]);
          s[DIGEST + j] = to_mont((uint32_t)in[j * n + 2 * i + 1]);
        } else {
          s[j] = prev[j * (2 * m) + 2 * i];
          s[DIGEST + j] = prev[j * (2 * m) + 2 * i + 1];
        }
      }
      permute(s);
#pragma unroll
      for (int j = 0; j < DIGEST; ++j) {
        dst[j * m + i] = s[j];
        gout[j * m + i] = from_mont(s[j]);
      }
    }
    __syncthreads();
    prev = dst;
  }
}

}  // namespace

// Round constants in Montgomery form: ext_init/ext_final (4, 16) and
// internal (13,), as uint32 host arrays. The diagonal is in the code.
extern "C" int swirl_p2_set_constants(const uint32_t* ext_init, const uint32_t* internal,
                                      const uint32_t* ext_final) {
  cudaMemcpyToSymbol(c_ext_init, ext_init, sizeof(c_ext_init));
  cudaMemcpyToSymbol(c_internal, internal, sizeof(c_internal));
  cudaMemcpyToSymbol(c_ext_final, ext_final, sizeof(c_ext_final));
  return (int)cudaGetLastError();
}

extern "C" int swirl_p2_hash_cols(const int64_t* in, int64_t* out, int w, long long n, int log_d,
                                  void* stream) {
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  hash_cols_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(in, out, w, n, log_d);
  return (int)cudaGetLastError();
}

extern "C" int swirl_p2_compress(const int64_t* in, int64_t* out, long long m, long long ld,
                                 int log_s, long long off, void* stream) {
  if (log_s < 0 || log_s > 62) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const long long blocks = (m + threads - 1) / threads;
  compress_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(in, out, m, ld, log_s,
                                                                          off);
  return (int)cudaGetLastError();
}

extern "C" int swirl_p2_tower(const int64_t* in, int64_t* out, int n, void* stream) {
  if (n < 2 || n > TOWER_MAX || (n & (n - 1)) != 0) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(uint32_t) * DIGEST * (n / 2 + n / 4);
  cudaFuncSetAttribute(tower_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int threads = n / 2 < 1024 ? n / 2 : 1024;
  tower_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(in, out, n);
  return (int)cudaGetLastError();
}
