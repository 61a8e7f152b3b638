// Kernels B, C, D: Poseidon2-BabyBear-16 for Merkle trees; E, F: for the
// Fiat-Shamir transcript.
//
// B  hash_cols    replaces swirl/tpu/poseidon2_pallas.py _hash_kernel (:143)
//                 via _hash_cols_fn (:189) / hash_cols (:247): padding-free
//                 sponge leaf hash, one column of a (w, n) or (w, n, d)
//                 matrix per leaf, its rows read where they lie.
// C  compress     replaces _compress_kernel (:259) via compress_cols (:318):
//                 one permutation of concat(left, right) per pair, truncated;
//                 the pairs are read in place from a digest layer.
// D  tower        replaces _tower_kernel (:327) via _tower_fn (:365) /
//                 compress_tower (:408): every level from <= 8192 digests
//                 to the root in one launch, subtrees spread over the SMs.
// E  duplex       the transcript's sponge on the card (no Pallas kernel: the
//                 JAX package runs its device transcript,
//                 swirl/prover/device_transcript.py, as jitted permutations):
//                 a run of absorbs and squeezes in one launch, one state word
//                 a lane (`permute_row`, below).
// F  grind        the transcript's proof-of-work search and its state
//                 advance, on the card (device_transcript.py grind :290).
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
// Montgomery form between the conversion at load and at store.
//
// D is a chain: its log2(n) levels depend on each other, so one
// permutation's latency, not the card's rate, bounds each level. A lone
// warp running one permutation a thread issues 6,031 instructions with
// little to overlap them (one thread a permutation measured about 9.7 µs a
// level on the H100, whatever the level's width). So D splits each
// permutation over a quad of 4 lanes (`permute_quad`): lane q holds state
// words 4q .. 4q + 3, one M4 group; the external layer's column sums and
// the partial rounds' sum are two __shfl_xor_sync each within the quad, and
// the partial S-box of word 0 reaches the other lanes by one __shfl_sync.
// The diagonal there is a Montgomery product by each lane's own d_i
// (uploaded with the round constants), so the quad runs one instruction
// stream. B and C keep `permute` as it is. The TPU kernel walked every
// level on one core; here G = n / 128 blocks (64 at n = 8192) each fold a
// subtree of 128 digests in shared memory (256 threads: level 1's 64
// permutations are 2 warps on each SM sub-partition, the levels above 1
// or less), writing every level's slice out as they go, and the block that
// draws the last ticket folds the G roots down to the root ("last block
// done": the root's lanes are fenced before a ticket is taken with
// atomicAdd on a counter that the wrapper allocates once per device and
// stream; the last block resets it). A cluster would need no counter, but
// holds at most 16 SMs: level 1's 4096 permutations at n = 8192 would put
// 8 warps on each sub-partition. In shared memory a level keeps lane row r
// of digest k at word r * 68 + k: a warp's pair reads (16 digests, rows r
// and r + 4) fall on 32 distinct banks, and its stores (8 digests, rows r
// and r + 4) on 16.
#include "field.cuh"

namespace {

constexpr int WIDTH = 16;
constexpr int DIGEST = 8;
constexpr int RATE = 8;
constexpr int HALF_FULL = 4;
constexpr int PARTIAL = 13;
constexpr int TOWER_MAX = 8192;
constexpr int TOWER_BLOCK = 128;                // digests a block folds
constexpr int TOWER_ROW = TOWER_BLOCK / 2 + 4;  // a level's lane row: 4 rows span 16 banks
constexpr int QUAD = 4;                         // lanes of one of kernel D's permutations

constexpr uint32_t P = bb::P;
constexpr uint32_t MU = bb::fast::MU;

__constant__ uint32_t c_ext_init[HALF_FULL][WIDTH];
__constant__ uint32_t c_internal[PARTIAL];
__constant__ uint32_t c_ext_final[HALF_FULL][WIDTH];
__constant__ uint32_t c_diag[WIDTH];  // the internal diagonal, for kernel D only
// kernel E's constants that differ from lane to lane, in global memory: one
// coalesced load a row (a __constant__ read at 16 addresses would serialize)
constexpr int ROW_RC_ROWS = 2 * HALF_FULL + 1;  // ext_init, ext_final, the diagonal
__device__ uint32_t g_row_rc[ROW_RC_ROWS][WIDTH];

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

// Kernel D's permutation split over a quad of lanes (see the note at the
// top). Each lane's round constants and diagonal, in registers.
struct QuadRc {
  uint32_t init[HALF_FULL][4], fin[HALF_FULL][4], diag[4];
};

__device__ __forceinline__ QuadRc quad_rc(int q) {
  QuadRc c;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int r = 0; r < HALF_FULL; ++r) {
      c.init[r][i] = c_ext_init[r][4 * q + i];
      c.fin[r][i] = c_ext_final[r][4 * q + i];
    }
    c.diag[i] = c_diag[4 * q + i];
  }
  return c;
}

__device__ __forceinline__ uint32_t quad_xor(uint32_t v, int mask) {
  return __shfl_xor_sync(0xffffffffu, v, mask, QUAD);
}

// M_E: M4 on the lane's own group, then the sum over the 4 groups of each
// word position, by two shuffles.
__device__ __forceinline__ void quad_external(uint32_t* x) {
  m4(x);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t t = add(x[j], quad_xor(x[j], 1));
    x[j] = add(x[j], add(t, quad_xor(t, 2)));
  }
}

__device__ __forceinline__ void quad_full_round(uint32_t* x, const uint32_t* rc) {
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = sbox(add(x[i], rc[i]));
  quad_external(x);
}

// The partial round, s_i <- d_i * s_i + sum(s) after word 0's S-box: every
// lane takes the S-box of its word 0 (lane 0's is the one used) while the
// quad sums words 1..15; state in Montgomery form, all lanes of the warp
// in step (the shuffles name the whole warp).
__device__ __forceinline__ void permute_quad(uint32_t* x, const QuadRc& c, int q) {
  quad_external(x);
#pragma unroll
  for (int r = 0; r < HALF_FULL; ++r) quad_full_round(x, c.init[r]);
#pragma unroll
  for (int r = 0; r < PARTIAL; ++r) {
    const uint32_t y = sbox(add(x[0], c_internal[r]));
    const uint32_t own = add(add(q == 0 ? 0u : x[0], x[1]), add(x[2], x[3]));
    const uint32_t t = add(own, quad_xor(own, 1));
    const uint32_t full = add(add(t, quad_xor(t, 2)), __shfl_sync(0xffffffffu, y, 0, QUAD));
    if (q == 0) x[0] = y;
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = add(mont(x[i], c.diag[i]), full);
  }
#pragma unroll
  for (int r = 0; r < HALF_FULL; ++r) quad_full_round(x, c.fin[r]);
}

// Folds `count` digests (a power of two, 2 to TOWER_BLOCK) of an (8, width)
// canonical layer, from column part * count, down to one. Level l of the
// fold has m = count >> l pairs: quad p (threads 4p .. 4p + 3) compresses
// pair p, lane q loading lane rows 4 (q & 1) .. + 3 of digest 2p + q / 2;
// lanes 0 and 1 then hold the digest, which is written out as column
// part * m + p of the tower's level of width >> l (flat offset
// 8 * (n - 2 * (width >> l))) and to shared memory. A warp with a pair
// runs whole (its idle quads repeat the last pair and store nothing). The
// layer is read through L2 (ld.global.cg): the top fold reads roots that
// other blocks wrote.
__device__ __forceinline__ void tower_fold(const int64_t* src, int width, int part, int count,
                                           int64_t* out, int n,
                                           uint32_t (*buf)[DIGEST][TOWER_ROW], const QuadRc& c) {
  const int q = threadIdx.x & (QUAD - 1);
  const int r0 = DIGEST / 2 * (q & 1);
  for (int l = 1, m = count / 2; m >= 1; ++l, m /= 2) {
    if ((int)(threadIdx.x & ~31u) < QUAD * m) {
      const int p = min((int)threadIdx.x / QUAD, m - 1);
      const int k = 2 * p + (q >> 1);
      uint32_t x[4];
      if (l == 1) {
        const long long* g = reinterpret_cast<const long long*>(src) + (long long)part * count + k;
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j] = to_mont((uint32_t)__ldcg(g + (long long)(r0 + j) * width));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j] = buf[(l - 1) & 1][r0 + j][k];
      }
      permute_quad(x, c, q);
      if (q < 2 && (int)threadIdx.x / QUAD < m) {
        const int w = width >> l;
        int64_t* g = out + (long long)DIGEST * (n - 2 * w) + (long long)part * m + p;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          buf[l & 1][4 * q + j][p] = x[j];
          g[(long long)(4 * q + j) * w] = from_mont(x[j]);
        }
      }
    }
    __syncthreads();
  }
}

// in: (8, n) digests, n a power of two in [2, TOWER_MAX]. out: level l
// (n >> l digests, l = 1..log n) as an (8, n >> l) block at offset
// 8 * (n - 2 * (n >> l)). Grid: n / count blocks of 2 * count threads (at
// least a warp), count = min(n, TOWER_BLOCK). tickets: a zero counter, left
// zero.
__global__ void __launch_bounds__(2 * TOWER_BLOCK) tower_kernel(const int64_t* in, int64_t* out, int n,
                                                                 unsigned* tickets) {
  __shared__ uint32_t buf[2][DIGEST][TOWER_ROW];
  __shared__ bool last;
  const QuadRc c = quad_rc(threadIdx.x & (QUAD - 1));
  const int g = gridDim.x;
  const int64_t* src = in;
  int width = n, part = blockIdx.x, count = n / g;
  // two trips through one copy of the fold: a lone warp fetches its code,
  // and a second copy for the top fold would start cold
#pragma unroll 1
  for (int top = 0;; ++top) {
    tower_fold(src, width, part, count, out, n, buf, c);
    if (top || g == 1) return;
    if (threadIdx.x < 2) __threadfence();  // the root's lanes, visible before the ticket
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(tickets, 1u) == (unsigned)g - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    if (threadIdx.x == 0) *tickets = 0;
    src = out + (long long)DIGEST * (n - 2 * g);
    width = g, part = 0, count = g;
  }
}

// Kernel E's permutation, one state word a lane (lane l < 16 of its
// half-warp holds word l; the two halves run the same permutation). The
// quad of kernel D issues 4 S-boxes a full round and 4 diagonal products a
// partial round on every lane, so a lone warp waits on its multiply pipe;
// here a lane issues one S-box a full round and, in a partial round, the
// S-box of word 0 (every lane the same), its own diagonal product and one
// constant product. The external layer M_E y = M4(x_g) + sum_h M4(x_h) =
// M4(x_g + S) (S the column sums over the 4 groups) takes two shuffle
// stages: the column sums from lanes l ^ 4, l ^ 8, l ^ 12, then M4's row
// (2, 3, 1, 1) rotated from the group's other three lanes, with the next
// round's constant added in the same add tree. A partial round keeps word
// 0 (x0) and the sum of words 1..15 (part) in every lane:
//     y = (x0 + c)^7, full = part + y, x_i <- d_i x_i + full (i >= 1),
//     x0 <- part - y (d_0 = -2), part <- sum_{i>=1} d_i x_i + 15 full,
// so the lane sum of d_i x_i (a butterfly of 4 shuffles) runs beside the
// next S-box instead of before it. The state is in Montgomery form.
constexpr int ROW = 16;
constexpr uint32_t MONT15 = 0x77ffffe1u;  // 15 * 2^32 mod P

__device__ __forceinline__ uint32_t row_xor(uint32_t v, int mask) {
  return __shfl_xor_sync(0xffffffffu, v, mask, ROW);
}

// a lane's constants and the lanes its M4 row reads
struct RowRc {
  uint32_t init[HALF_FULL], fin[HALF_FULL], diag;
  int n1, n2, n3;  // the lanes of words 4g + (i + k) % 4, k = 1, 2, 3
};

__device__ __forceinline__ RowRc row_rc(int l) {
  RowRc c;
#pragma unroll
  for (int r = 0; r < HALF_FULL; ++r) {
    c.init[r] = __ldg(&g_row_rc[r][l]);
    c.fin[r] = __ldg(&g_row_rc[HALF_FULL + r][l]);
  }
  c.diag = __ldg(&g_row_rc[2 * HALF_FULL][l]);
  c.n1 = (l & ~3) | ((l + 1) & 3);
  c.n2 = (l & ~3) | ((l + 2) & 3);
  c.n3 = (l & ~3) | ((l + 3) & 3);
  return c;
}

// M_E on word l, then + rc (the next round's constant of this lane)
__device__ __forceinline__ uint32_t row_external(uint32_t x, const RowRc& c, uint32_t rc) {
  const uint32_t a = row_xor(x, 4), b = row_xor(x, 8), d = row_xor(x, 12);
  const uint32_t z = add(add(add(x, x), d), add(a, b));  // x_g + S
  const uint32_t z1 = __shfl_sync(0xffffffffu, z, c.n1, ROW);
  const uint32_t z2 = __shfl_sync(0xffffffffu, z, c.n2, ROW);
  const uint32_t z3 = __shfl_sync(0xffffffffu, z, c.n3, ROW);
  // 2 z + 3 z1 + z2 + z3 + rc
  return add(add(add(z, z1), add(z2, z3)), add(add(z, rc), add(z1, z1)));
}

__device__ __forceinline__ uint32_t row_sum(uint32_t v) {
#pragma unroll
  for (int m = 1; m < ROW; m <<= 1) v = add(v, row_xor(v, m));
  return v;
}

// all 32 lanes in step (the shuffles name the whole warp); l = lane & 15
__device__ __forceinline__ uint32_t permute_row(uint32_t x, const RowRc& c, int l) {
  x = row_external(x, c, c.init[0]);
#pragma unroll
  for (int r = 0; r < HALF_FULL; ++r) x = row_external(sbox(x), c, r + 1 < HALF_FULL ? c.init[r + 1] : 0u);
  uint32_t x0 = __shfl_sync(0xffffffffu, x, 0, ROW);
  uint32_t part = row_sum(l == 0 ? 0u : x);
  uint32_t y = sbox(add(x0, c_internal[0]));
#pragma unroll
  for (int r = 0; r < PARTIAL; ++r) {
    const uint32_t q = mont(x, c.diag);
    const uint32_t full = add(part, y);
    x = add(q, full);
    if (r + 1 == PARTIAL) {
      x0 = sub(part, y);
      break;
    }
    // word 0 of the next round, its constant added beside the S-box's input
    const uint32_t x0c = sub(add(part, c_internal[r + 1]), y);
    part = add(row_sum(l == 0 ? 0u : q), mont(full, MONT15));
    y = sbox(x0c);
  }
  x = add(l == 0 ? x0 : x, c.fin[0]);
#pragma unroll
  for (int r = 0; r < HALF_FULL; ++r) x = row_external(sbox(x), c, r + 1 < HALF_FULL ? c.fin[r + 1] : 0u);
  return x;
}

// Kernel E (duplex): one run of the transcript's duplex-sponge events from
// cursors the host knows (the event schedule is static): absorb the k felts
// of `absorb` and then the n_host felts of `host` (overwrite mode: word a
// takes the felt, a full rate permutes and resets the squeeze cursor),
// then squeeze n_squeeze values (permute when an absorb is pending or the
// rate is drained; take word --s), each masked with `mask`. One warp, word
// l on lanes l and l + 16 (`permute_row`); a chain of p dependent
// permutations takes p times one row permutation: the launch is latency-
// bound, and a GKR sub-round or a WHIR fold's absorb is one launch. The
// felt a lane takes in the next rate block is loaded before the current
// block's permutation, so the load waits beside it.
constexpr int HOST_MAX = 32;  // host felts a launch takes by value
struct HostFelts {
  uint32_t v[HOST_MAX];
};

__device__ __forceinline__ uint32_t duplex_felt(const int64_t* absorb, long long k, const HostFelts& host,
                                                long long j, long long total) {
  return j < 0 || j >= total ? 0u : j < k ? (uint32_t)absorb[j] : host.v[j - k];
}

__global__ void __launch_bounds__(32) duplex_kernel(int64_t* state, const int64_t* absorb, long long k,
                                                    const HostFelts host, int n_host, int a, int s,
                                                    int n_squeeze, uint32_t mask, int64_t* out) {
  const int l = threadIdx.x & (ROW - 1);
  const RowRc c = row_rc(l);
  uint32_t x = to_mont((uint32_t)state[l]);
  const long long total = k + n_host;
  // the block from cursor a takes felts off .. off + len - 1 into words a ..
  uint32_t v = duplex_felt(absorb, k, host, l - a, total);
  for (long long off = 0; off < total;) {
    const long long len = min((long long)(RATE - a), total - off);
    if (l >= a && l < a + len) x = to_mont(v);
    off += len;
    a += (int)len;
    if (a == RATE) {
      v = duplex_felt(absorb, k, host, off + l, total);  // word l of the next block
      x = permute_row(x, c, l);
      a = 0;
      s = RATE;
    }
  }
  for (int t = 0; t < n_squeeze; ++t) {
    if (a != 0 || s == 0) {
      x = permute_row(x, c, l);
      a = 0;
      s = RATE;
    }
    --s;
    if ((int)threadIdx.x == s) out[t] = from_mont(x) & mask;
  }
  if (threadIdx.x < ROW) state[l] = from_mont(x);
}

// Kernel F (grind), the search: the smallest w in [0, P) such that
// observe(w) at absorb cursor a, then sample_bits, gives 0 under `mask`.
// Whatever the cursors, that is one permutation of the state with word a
// set to w (a full rate permutes at the observe, else the sample does),
// and the sample is word RATE - 1. Threads take the candidates of a sweep
// of gridDim * blockDim in index order and keep the least hit with
// atomicMin; a thread leaves once the least hit so far lies below its
// sweep, so every candidate below the final minimum was tried and the
// minimum is the host scan's witness. `found` starts above P (the wrapper
// fills its bytes with 0x7f). Bound: the multiply pipe, one permutation a
// candidate (the scalar `permute` of B and C).
__global__ void __launch_bounds__(128) grind_kernel(const int64_t* __restrict__ state, int a,
                                                    uint32_t mask, unsigned long long* found) {
  uint32_t s0[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s0[i] = to_mont((uint32_t)state[i]);
  const unsigned long long sweep = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long base = 0; base < P; base += sweep) {
    if (*(volatile unsigned long long*)found < base) return;
    const unsigned long long w = base + (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (w >= P) return;
    const uint32_t wm = to_mont((uint32_t)w);
    uint32_t s[WIDTH];
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) s[i] = i == a ? wm : s0[i];
    permute(s);
    if ((from_mont(s[RATE - 1]) & mask) == 0) atomicMin(found, w);
  }
}

// Kernel F, the state advance of check_witness: observe the witness, sample
// once (one permutation, as above). With no witness in [0, P) the state is
// left as it is and the witness reads -1, which the prover refuses when it
// fetches the proof.
__global__ void __launch_bounds__(32) grind_advance_kernel(int64_t* state, int a,
                                                           unsigned long long* found) {
  const unsigned long long w = *(volatile unsigned long long*)found;
  __syncwarp();
  if (w >= P) {
    if (threadIdx.x == 0) *found = ~0ull;
    return;
  }
  const int q = threadIdx.x & (QUAD - 1);
  const QuadRc c = quad_rc(q);
  uint32_t x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = 4 * q + i == a ? to_mont((uint32_t)w) : to_mont((uint32_t)state[4 * q + i]);
  permute_quad(x, c, q);
  if (threadIdx.x < QUAD) {
#pragma unroll
    for (int i = 0; i < 4; ++i) state[4 * q + i] = from_mont(x[i]);
  }
}

}  // namespace

// Round constants in Montgomery form: ext_init/ext_final (4, 16) and
// internal (13,), and the internal diagonal (16,), as uint32 host arrays.
// B and C hold the diagonal in their code; D's quads read it.
extern "C" int swirl_p2_set_constants(const uint32_t* ext_init, const uint32_t* internal,
                                      const uint32_t* ext_final, const uint32_t* diag) {
  cudaMemcpyToSymbol(c_ext_init, ext_init, sizeof(c_ext_init));
  cudaMemcpyToSymbol(c_internal, internal, sizeof(c_internal));
  cudaMemcpyToSymbol(c_ext_final, ext_final, sizeof(c_ext_final));
  cudaMemcpyToSymbol(c_diag, diag, sizeof(c_diag));
  cudaMemcpyToSymbol(g_row_rc, ext_init, sizeof(c_ext_init));
  cudaMemcpyToSymbol(g_row_rc, ext_final, sizeof(c_ext_final), sizeof(c_ext_init));
  cudaMemcpyToSymbol(g_row_rc, diag, sizeof(c_diag), sizeof(c_ext_init) + sizeof(c_ext_final));
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

extern "C" int swirl_p2_tower(const int64_t* in, int64_t* out, int n, unsigned* tickets,
                              void* stream) {
  if (n < 2 || n > TOWER_MAX || (n & (n - 1)) != 0) return (int)cudaErrorInvalidValue;
  const int count = n < TOWER_BLOCK ? n : TOWER_BLOCK;
  const int threads = 2 * count < 32 ? 32 : 2 * count;  // whole warps: the shuffles name all 32 lanes
  tower_kernel<<<n / count, threads, 0, (cudaStream_t)stream>>>(in, out, n, tickets);
  return (int)cudaGetLastError();
}

// a: absorb cursor in [0, 8); s: squeeze cursor in [0, 8]; bits in [0, 30],
// or -1 for unmasked squeezes; out: n_squeeze int64 values.
extern "C" int swirl_p2_duplex(int64_t* state, const int64_t* absorb, long long k, const uint32_t* host,
                               int n_host, int a, int s, int n_squeeze, int bits, int64_t* out,
                               void* stream) {
  if (a < 0 || a >= RATE || s < 0 || s > RATE || k < 0 || n_host < 0 || n_host > HOST_MAX ||
      n_squeeze < 0 || bits < -1 || bits > 30)
    return (int)cudaErrorInvalidValue;
  HostFelts h = {};
  for (int i = 0; i < n_host; ++i) h.v[i] = host[i];
  const uint32_t mask = bits < 0 ? ~0u : (1u << bits) - 1u;
  duplex_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(state, absorb, k, h, n_host, a, s, n_squeeze, mask,
                                                    out);
  return (int)cudaGetLastError();
}

// The search sweeps twice the expected 2^bits candidates at once, at most
// as many blocks as the card holds; then the advance. witness: one int64.
extern "C" int swirl_p2_grind(int64_t* state, int a, int bits, int64_t* witness, void* stream) {
  if (a < 0 || a >= RATE || bits < 1 || bits > 30) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grind_kernel, 128, 0);
  const long long want = ((2LL << bits) + 127) / 128;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = (unsigned)(want < most ? want : most);
  unsigned long long* found = reinterpret_cast<unsigned long long*>(witness);
  cudaMemsetAsync(found, 0x7f, sizeof(*found), st);
  grind_kernel<<<blocks, 128, 0, st>>>(state, a, (1u << bits) - 1u, found);
  grind_advance_kernel<<<1, 32, 0, st>>>(state, a, found);
  return (int)cudaGetLastError();
}
