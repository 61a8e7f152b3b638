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
//                hit by atomicMin, as kernel F; its operands by value.
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

// At most 40 registers (12 blocks an SM): the operation moves its 96 bytes
// an element at the memory's rate only with enough loads in flight.
__global__ void __launch_bounds__(128, 12) op_kernel(int op, const uint32_t* __restrict__ a,
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
// under `mask`: lane a of the sponge takes the pending felts' packed scalar
// plus w << shift, one width-3 permutation, and the sample is lane 1 mod
// BB_P. Its operands come by value (the card serves kernel parameters from
// its constant bank, so none holds a register across the loop): the lanes,
// and the candidate's lane in R' form as base + w step with step = 2^shift
// R' (mod P). A thread starts at w = its index by one product (mont(w,
// step R') = w step) and moves to w + n (n the threads of the launch) by one
// add of n step (one more product, once) and one conditional subtract: no
// product and no word placement a candidate. Threads take the candidates
// of a sweep of n in index order and keep the least hit with atomicMin; a
// thread leaves once the least hit so far lies below its next candidate,
// so every candidate below the final minimum was tried. `found` starts
// above BB_P (the wrapper fills its bytes with 0x7f); end <= BB_P.
struct GrindArgs {
  F5 lanes[3];  // R' form (v 2^260 mod P, canonical limbs); lane a's unused
  F5 base;      // the pending scalar, R' form
  F5 step;      // 2^shift 2^520 mod P: mont(w, step) = w 2^shift in R' form
  unsigned long long end;
  uint32_t mask;
  int a;
};

// 2^(26 j) mod BB_P, j = 0 .. 9: the weights of a canonical value's 26-bit
// limb halves
#define BB_HALF_WEIGHTS \
  0x1u, 0x4000000u, 0xfdddddeu, 0xf789abdu, 0x337bfad8u, 0x2648aad7u, 0x3ab94fa4u, 0x160ae3bfu, 0x3b43e758u, 0x26064517u

// x mod BB_P for an R'-form lane (limbs below 2^57): its canonical limbs
// (below 2^52) as 10 halves below 2^26, each times its weight (below 2^31):
// 10 independent products below 2^57, summed below 2^61, one remainder.
__device__ __forceinline__ uint32_t sample(const F5& x) {
  const uint32_t weight[2 * NL] = {BB_HALF_WEIGHTS};
  const F5 c = canon(redc_only(x));
  uint64_t acc = 0;
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    acc += (uint64_t)(uint32_t)(c.l[k] & ((1u << 26) - 1)) * weight[2 * k];
    acc += (uint64_t)(uint32_t)(c.l[k] >> 26) * weight[2 * k + 1];
  }
  return (uint32_t)(acc % BB_P);
}

// a + b for canonical limbs: below 2P, then below P
__device__ __forceinline__ F5 add_mod(const F5& a, const F5& b) { return canon(norm(add5(a, b))); }

// k step (k below 2^31) in R' form: k step / 2^260 < 2^31 P / 2^260 + P,
// below 2P, canonical after canon
__device__ __forceinline__ F5 times_step(unsigned long long k, const F5& step) {
  return canon(mul(D5{{(double)k, 0.0, 0.0, 0.0, 0.0}}, to_d5(step)));
}

// Two blocks an SM (swirl_bn254_grind sweeps at most the blocks the card
// holds; more resident warps only slow each sweep), so a thread may take
// every register its permutation's schedule wants.
__global__ void __launch_bounds__(128, 2) grind_kernel(const GrindArgs g, unsigned long long* found) {
  const unsigned long long n = (unsigned long long)gridDim.x * blockDim.x;
  unsigned long long w = (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
  const F5 stride = times_step(n, g.step);
  F5 v = add_mod(g.base, times_step(w, g.step));
  for (; w < g.end; w += n) {
    if (*(volatile unsigned long long*)found < w) return;
    F5 s[3] = {g.a == 0 ? v : g.lanes[0], g.a == 1 ? v : g.lanes[1], g.lanes[2]};
    permute<3>(s);
    if ((sample(s[1]) & g.mask) == 0) atomicMin(found, w);
    v = add_mod(v, stride);
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

// The search sweeps four expected counts of candidates at once (one block
// at least), at most as many blocks as the card holds. args: one GrindArgs
// (host memory). witness: one int64, left above BB_P if no candidate in
// [0, end) passes.
extern "C" int swirl_bn254_grind(const void* args, int64_t* witness, void* stream) {
  const GrindArgs g = *static_cast<const GrindArgs*>(args);
  if (g.a < 0 || g.a > 1 || g.end > BB_P || g.mask == 0 || (g.mask & (g.mask + 1)) || g.mask >= BB_P)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grind_kernel, 128, 0);
  const long long want = (4LL * ((long long)g.mask + 1) + 127) / 128;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = (unsigned)(want < most ? want : most);
  unsigned long long* found = reinterpret_cast<unsigned long long*>(witness);
  cudaMemsetAsync(found, 0x7f, sizeof(*found), s);
  grind_kernel<<<blocks, 128, 0, s>>>(g, found);
  return (int)cudaGetLastError();
}
