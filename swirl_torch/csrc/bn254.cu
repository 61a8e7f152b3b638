// Kernels G-J: the BN254 outer hash scheme on the card (the field and the
// permutations are in bn254.cuh).
//
// None of them replaces a Pallas kernel: the JAX package runs its BN254
// device library under XLA.
// G  op          swirl/fields/jbn254.py add :110, sub :117, mont_mul :134,
//                from_canonical :168, to_canonical :174, dbl :179: one
//                elementwise operation, one thread an element.
// H  permute     swirl/hash/jbn254_poseidon2.py permute_dev :74 and
//                compress2_dev :97: one thread a width-2 or width-3 state;
//    compress    merkle_layers_dev :168 (and the outer tree's strided
//                levels, swirl/hash/scheme.py build_host_tree :76): one
//                thread an output digest, its pair read in place from a
//                layer of canonical digests at a pairing stride.
// I  hash_rows   pack_felts_dev :104 + hash_rows_dev :137: one thread a
//                leaf; consecutive threads read consecutive leaves of the
//                column-major (w, h) or (w, h, d) int64 codeword, so the
//                loads coalesce; per 16-felt block the two packed scalars
//                overwrite lanes 0 and 1 (lane 0 only for a last block of
//                at most 8 felts), then one width-3 permutation.
// J  grind       swirl/hash/multi_field.py grind :210 (a host loop there):
//                one thread a candidate in grid-stride sweeps, the least
//                hit by atomicMin, as kernel F.
//
// What bounds them on the H100: the arithmetic of the BN254 products. A
// width-3 permutation has 80 S-boxes (240 products, 160 of them squares), a
// width-2 one 62 (186, 124); a leaf of 32 felts reads 256 B and takes two
// width-3 permutations, far above what its bytes cost. An 8-word CIOS
// product issues 128 IMAD.WIDE (a 32 x 32 -> 64-bit product each), which
// the card runs at about a third of IMAD's rate (tools/isa.py's pipe
// bench), plus two ALU adds for each one's carry: the wide multiplies bound
// it. Design: the products run on the FP64 pipe, which nothing else here
// uses (bn254.cuh: 5 limbs of 2^52, three double operations a partial
// product, 25 of them a product, 15 a square, 20 for the quotients), and
// the integer pipes only add the halves into 64-bit column sums; the
// quotients are 5 integer products a Montgomery product. Values stay
// unreduced in 2^260-form limbs between products (a product's bound
// absorbs its operands'), so only the partial rounds' unsboxed lanes are
// brought below 3P, and a digest is reduced once, by the quotient steps
// alone and one conditional subtract. One thread a permutation, its state
// in registers (15 or 10 64-bit limbs), the round loops not unrolled (one
// round's code; the constants are the same __constant__ words for every
// thread of a warp). Digests are 32 B rows, loaded and stored as two
// 16-byte vectors.
#include <cuda_runtime.h>

#include "bn254.cuh"

namespace {

using namespace bn254;

constexpr uint32_t BB_P = 2013265921u;  // BabyBear
constexpr int FELT_BITS = 31;
constexpr int FELTS = 8;   // felts a scalar
constexpr int BLOCK = 16;  // felts a permutation absorbs

__device__ __forceinline__ Fe load_fe(const uint32_t* p) {
  const uint4 x = reinterpret_cast<const uint4*>(p)[0];
  const uint4 y = reinterpret_cast<const uint4*>(p)[1];
  return {{x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w}};
}

__device__ __forceinline__ void store_fe(uint32_t* p, const Fe& v) {
  reinterpret_cast<uint4*>(p)[0] = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
  reinterpret_cast<uint4*>(p)[1] = make_uint4(v.w[4], v.w[5], v.w[6], v.w[7]);
}

// 8 canonical felts -> one canonical scalar: felt j at bits [31j, 31j + 31),
// so word i takes a piece of at most two felts; the pieces never overlap.
__device__ __forceinline__ Fe pack8(const uint32_t f[FELTS]) {
  Fe v;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    uint32_t acc = 0;
#pragma unroll
    for (int j = 0; j < FELTS; ++j) {
      const int off = FELT_BITS * j - 32 * i;
      if (off >= 32 || off + FELT_BITS <= 0) continue;
      acc |= off >= 0 ? f[j] << off : f[j] >> -off;
    }
    v.w[i] = acc;
  }
  return v;
}

enum Op { ADD = 0, SUB = 1, MONT_MUL = 2, FROM_CANONICAL = 3, TO_CANONICAL = 4, DBL = 5 };

__global__ void __launch_bounds__(128) op_kernel(int op, const uint32_t* __restrict__ a,
                                                 const uint32_t* __restrict__ b,
                                                 uint32_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fe x = load_fe(a + 8 * i);
  const Fe y = load_fe(b + 8 * i);
  // R = 2^256 against the core's R' = 2^260: x y / 2^256 = x (16 y) / 2^260,
  // x 2^256 = x K_516 / 2^260 and x / 2^256 = (16 x) / 2^260
  Fe r;
  switch (op) {
    case ADD: r = add(x, y); break;
    case SUB: r = sub(x, y); break;
    case MONT_MUL: r = words(canon(mul(to_d5(limbs(x)), to_d5(limbs(y, 4))))); break;
    case FROM_CANONICAL: r = words(canon(mul(to_d5(limbs(x)), const_d5<BN254_K516_LIMBS>()))); break;
    case TO_CANONICAL: r = words(canon(redc_only(limbs(x, 4)))); break;
    default: r = add(x, x); break;
  }
  store_fe(out + 8 * i, r);
}

template <int T>
__global__ void __launch_bounds__(128) permute_kernel(const uint32_t* __restrict__ in,
                                                      uint32_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // R-form lanes into R' form (a product by K_264) and back (by K_256)
  F5 s[T];
#pragma unroll
  for (int k = 0; k < T; ++k) s[k] = mul(to_d5(limbs(load_fe(in + (i * T + k) * 8))), const_d5<BN254_K264_LIMBS>());
  permute<T>(s);
#pragma unroll
  for (int k = 0; k < T; ++k)
    store_fe(out + (i * T + k) * 8, words(canon(mul(to_d5(norm(s[k])), const_d5<BN254_K256_LIMBS>()))));
}

// Output o < m compresses digest l = 2s (o / s) + o % s (s = 2^log_s) with
// digest l + s, both canonical, R' form inside.
__global__ void __launch_bounds__(128) compress_kernel(const uint32_t* __restrict__ in,
                                                       uint32_t* __restrict__ out, long long m,
                                                       int log_s) {
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= m) return;
  const long long left = ((o >> log_s) << (log_s + 1)) + (o & ((1LL << log_s) - 1));
  F5 s[2] = {to_mont(load_fe(in + 8 * left)), to_mont(load_fe(in + 8 * (left + (1LL << log_s))))};
  permute<2>(s);
  store_fe(out + 8 * o, to_canonical(s[0]));
}

// Value r (of w) of leaf col lies at in[(r >> log_d) * (n << log_d) +
// (col << log_d) + (r & (2^log_d - 1))]: log_d = 0 for a (w, n) codeword,
// 2 for the (w / 4, n, 4) extension-field codeword read in place.
__global__ void __launch_bounds__(128) hash_rows_kernel(const int64_t* __restrict__ in,
                                                        uint32_t* __restrict__ out, int w,
                                                        long long n, int log_d) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  const int64_t* src = in + (col << log_d);
  const long long row_stride = n << log_d;
  const int dmask = (1 << log_d) - 1;
  F5 s[3] = {};
  for (int base = 0; base < w; base += BLOCK) {
    const int len = w - base < BLOCK ? w - base : BLOCK;
    uint32_t f[BLOCK];
#pragma unroll
    for (int j = 0; j < BLOCK; ++j) {  // static indices keep f in registers
      const int r = base + j;
      f[j] = j < len ? (uint32_t)src[(r >> log_d) * row_stride + (r & dmask)] : 0u;
    }
    s[0] = to_mont(pack8(f));
    if (len > FELTS) s[1] = to_mont(pack8(f + FELTS));
    permute<3>(s);
  }
  store_fe(out + 8 * col, to_canonical(s[0]));
}

// Kernel J: the smallest w in [0, end) whose observe + sample_bits gives 0
// under `mask`: st holds the sponge's three lanes and the pending felts'
// packed scalar (below 2^shift), all canonical. Lane a takes that scalar
// plus w << shift, one permutation, and the sample is lane 1 mod BB_P.
// Threads take the candidates of a sweep of gridDim * blockDim in index
// order and keep the least hit with atomicMin; a thread leaves once the
// least hit so far lies below its sweep, so every candidate below the
// final minimum was tried. `found` starts above BB_P (the wrapper fills
// its bytes with 0x7f); end <= BB_P.
__global__ void __launch_bounds__(128) grind_kernel(const uint32_t* __restrict__ st, int a, int shift,
                                                    uint32_t mask, unsigned long long end,
                                                    unsigned long long* found) {
  F5 s0[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) s0[k] = to_mont(load_fe(st + 8 * k));
  const Fe prefix = load_fe(st + 24);
  const int q = shift >> 5, rbit = shift & 31;
  const unsigned long long sweep = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long base = 0; base < end; base += sweep) {
    if (*(volatile unsigned long long*)found < base) return;
    const unsigned long long w = base + (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (w >= end) return;
    Fe v = prefix;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      if (i == q) v.w[i] |= (uint32_t)(w << rbit);
      if (i == q + 1 && rbit != 0) v.w[i] |= (uint32_t)(w >> (32 - rbit));
    }
    const F5 vm = to_mont(v);
    F5 s[3] = {a == 0 ? vm : s0[0], a == 1 ? vm : s0[1], s0[2]};
    permute<3>(s);
    const Fe x = to_canonical(s[1]);
    unsigned long long r = 0;
#pragma unroll
    for (int i = L - 1; i >= 0; --i) r = ((r << 32) | x.w[i]) % BB_P;
    if ((r & mask) == 0) atomicMin(found, w);
  }
}

unsigned blocks_for(long long n, int threads) { return (unsigned)((n + threads - 1) / threads); }

}  // namespace

// Round constants in R' form (c 2^260 mod P), 5 limbs of 2^52 each, flat in
// the order external initial (4, 3), internal (56), external final (4, 3)
// for width 3 and (3, 2), (50), (3, 2) for width 2.
extern "C" int swirl_bn254_set_constants(const uint64_t* c3, const uint64_t* c2) {
  cudaMemcpyToSymbol(c_rc3, c3, sizeof(c_rc3));
  cudaMemcpyToSymbol(c_rc2, c2, sizeof(c_rc2));
  return (int)cudaGetLastError();
}

extern "C" int swirl_bn254_op(int op, const uint32_t* a, const uint32_t* b, uint32_t* out, long long n,
                              void* stream) {
  if (op < ADD || op > DBL || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  op_kernel<<<blocks_for(n, 128), 128, 0, (cudaStream_t)stream>>>(op, a, b, out, n);
  return (int)cudaGetLastError();
}

extern "C" int swirl_bn254_permute(const uint32_t* in, uint32_t* out, long long n, int t, void* stream) {
  if ((t != 2 && t != 3) || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (t == 3)
    permute_kernel<3><<<blocks_for(n, 128), 128, 0, st>>>(in, out, n);
  else
    permute_kernel<2><<<blocks_for(n, 128), 128, 0, st>>>(in, out, n);
  return (int)cudaGetLastError();
}

extern "C" int swirl_bn254_compress(const uint32_t* in, uint32_t* out, long long m, int log_s, void* stream) {
  if (m < 1 || log_s < 0 || log_s > 40) return (int)cudaErrorInvalidValue;
  compress_kernel<<<blocks_for(m, 128), 128, 0, (cudaStream_t)stream>>>(in, out, m, log_s);
  return (int)cudaGetLastError();
}

extern "C" int swirl_bn254_hash_rows(const int64_t* in, uint32_t* out, int w, long long n, int log_d,
                                     void* stream) {
  if (w < 0 || n < 1 || log_d < 0 || log_d > 4) return (int)cudaErrorInvalidValue;
  hash_rows_kernel<<<blocks_for(n, 128), 128, 0, (cudaStream_t)stream>>>(in, out, w, n, log_d);
  return (int)cudaGetLastError();
}

// The search sweeps twice the expected 2^bits candidates at once, at most
// as many blocks as the card holds, over [0, end) (end <= BB_P). witness:
// one int64, left above BB_P if no candidate there passes.
extern "C" int swirl_bn254_grind(const uint32_t* st, int a, int shift, int bits, long long end,
                                 int64_t* witness, void* stream) {
  if (a < 0 || a > 1 || shift < 0 || shift > FELT_BITS * (FELTS - 1) || shift % FELT_BITS || bits < 1 ||
      bits > 30 || end < 0 || end > (long long)BB_P)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grind_kernel, 128, 0);
  const long long want = ((2LL << bits) + 127) / 128;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = (unsigned)(want < most ? want : most);
  unsigned long long* found = reinterpret_cast<unsigned long long*>(witness);
  cudaMemsetAsync(found, 0x7f, sizeof(*found), s);
  grind_kernel<<<blocks, 128, 0, s>>>(st, a, shift, (1u << bits) - 1u, (unsigned long long)end, found);
  return (int)cudaGetLastError();
}
