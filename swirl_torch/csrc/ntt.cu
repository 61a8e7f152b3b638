// Kernels A and A′: natural-order NTT over BabyBear, batched over rows.
//
// A replaces swirl/tpu/ntt_pallas.py: _kernel1 (:147) and _kernel2 (:156),
// launched by _ntt_fn (:164) behind the public ntt (:288) / ntt_ext (:315)
// for N <= 2^26. A′ replaces _kernel1_only (:249), the first four-step
// level of the recursive branch of ntt (:300-312) that the TPU takes above
// 2^26. out[k] = sum_j in[j] * w^(jk) with w the 2^log_n-th root (or its
// inverse), unscaled, natural order in and out; EF4 transforms arrive as
// four base planes, so only the base field is handled here. BabyBear's
// two-adicity is 27, so 2^27 is the longest transform that exists (the
// TPU code's 2^28 ceiling has no root of unity to run with).
//
// What bounds it on the H100: memory passes and the stages in shared
// memory. The least bytes are one int64 read and one int64 write per
// element (the leaf encode (2, 2^27): 4.29 GB, 1.28 ms at 3.35 TB/s).
// Design:
// - log_n <= 13 (the path's (2^22, 16) and (196608, 16) chunk transforms
//   and the small golden sizes): one pass. A block loads whole rows
//   (several rows per block below 1024 points) into 32 KB of static shared
//   memory in bit-reversed order, runs every radix-2 DIT stage there, and
//   stores natural order.
// - 13 < log_n <= 27: the four-step split N = n1 * n2 (n1 = 2^l1,
//   l1 = log_n/2, n2 = 2^l2 >= n1) in two passes through device memory, as
//   the TPU's _kernel1 and _kernel2 are: pass 1 reads int64 (8 B) and
//   writes the u32 scratch A_T (4 B), pass 2 reads A_T (4 B) and writes
//   int64 (8 B): 24 B an element. A block of 512 threads holds a strip of
//   adjacent columns in dynamic shared memory (C columns of n1 points in
//   pass 1, 2 of n2 in pass 2; 2^14 words at most) with the stage twiddles
//   beside it, runs the strip's stages there (radix-4, two stages a
//   barrier), and writes the strip out. Blocks run in clusters of 2
//   (distributed shared memory), so that one instruction moves whole
//   32-byte sectors where a block's own columns are narrower: each block
//   loads half the rows of both blocks' columns and stores each value into
//   its block's strip, and in pass 2 writes half the output rows for both
//   blocks' columns, reading the other block's strip (clusters of 8, which
//   read and write 128-byte rows, ran slower on the H100; PERF.md). Two
//   blocks share an SM, so one block's loads can run beside the other's
//   stages (one at 2^27's pass 2, whose strip and twiddles take 192 KB;
//   one column a block there, in clusters of 4 at two blocks an SM, ran
//   slower: PERF.md).
//
//   | log_n, path shape | l1/l2 | C | shared, pass 1 / 2 | blocks an SM, 1 / 2 |
//   | 21, (4, 2^21)     | 10/11 | 2 | 12 KB / 24 KB      | 2 / 2               |
//   | 22, (4, 2^22)     | 11/11 | 8 | 72 KB / 24 KB      | 2 / 2               |
//   | 23, (16, 2^23)    | 11/12 | 8 | 72 KB / 48 KB      | 2 / 2               |
//   | 24, (4, 2^24)     | 12/12 | 4 | 80 KB / 48 KB      | 2 / 2               |
//   | 25, (4, 2^25)     | 12/13 | 4 | 80 KB / 96 KB      | 2 / 2               |
//   | 26, (4, 2^26)     | 13/13 | 2 | 96 KB / 96 KB      | 2 / 2               |
//   | 27, (2, 2^27), A′ | 13/14 | 2 | 96 KB / 192 KB     | 2 / 1               |
//
//   The scratch is tiled, A_T[b, k1 >> 2, j2, k1 & 3], so that the 4
//   columns k1 of a pass-2 cluster are one contiguous run of n2 * 16 bytes
//   (device memory moves whole runs far faster than short ones at a long
//   stride: PERF.md). Sector efficiency (bytes used of each 32-byte sector
//   a warp request touches): pass 1 reads a cluster's rows of 16 C bytes
//   (32 to 128: 100%) and writes runs of 16 C bytes a tile (100%); pass 2
//   reads contiguous 16-byte vectors (100%) and writes 32-byte rows
//   (100%). A′ (2^27: n2 = 2^14, a row the TPU could not hold and split
//   once more) is the same two passes.
// - Shared memory is free of bank conflicts in every access (swz below;
//   prover/ntt.py's two_pass_plan checks each warp access of both passes,
//   at every path split in tests/test_torch_ntt.py): the bit-reversed
//   loads that were 32-way conflicts in the five-pass design, the stages,
//   the natural-order reads and the stage twiddles, which a block copies
//   once from the table into shared memory in stage-major order so that a
//   stage reads them side by side.
// Twiddles come from a two-level table of n2 + n1 Montgomery values:
// hi[e] = w^(n1*e) (the n2-th root's powers, which also serve every row
// sub-NTT by stride) and lo[e] = w^e for e < n1; the four-step twiddle is
// w^(r*c) = hi[(r*c) >> l1] * lo[(r*c) & (n1-1)], one more Montgomery
// product than a full table of w^e would need, and 2^27 x 4 B less memory.
// A Montgomery product of two Montgomery values is a Montgomery value, and
// that of a canonical value and a Montgomery constant is canonical, so the
// data never changes representation.
#include <cooperative_groups.h>

#include "field.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TWO_ADICITY = 27;
constexpr int SMALL_LOG_MAX = 13;  // 8192 points = 32 KB of static shared memory
constexpr int TILE_MIN = 1024;     // points per block for short rows
constexpr int ROW_THREADS = 512;

// Row NTTs of 2^log_n points, log_n <= 13, in static shared memory (tile
// points a block); table holds the powers of the 2^log_n-th root.
__global__ void ntt_rows_kernel(const int64_t* in, int64_t* out, long long n_rows, int log_n,
                                const uint32_t* __restrict__ table) {
  __shared__ uint32_t s[1 << SMALL_LOG_MAX];
  const int n = 1 << log_n;
  const int tile = n > TILE_MIN ? n : TILE_MIN;
  const long long row0 = (long long)blockIdx.x * (tile >> log_n);
  const int shift = 32 - log_n;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int r = i >> log_n, j = i & (n - 1);
    const long long g = row0 + r;
    const uint32_t v = g < n_rows ? (uint32_t)in[g * n + j] : 0u;
    s[(r << log_n) + (__brev(j) >> shift)] = v;
  }
  __syncthreads();
  // stage lg merges blocks of 2^(lg-1); w_len^pos = w^(pos << (log_n - lg))
  for (int lg = 1; lg <= log_n; ++lg) {
    const int half = 1 << (lg - 1);
    const int tshift = log_n - lg;
    for (int k = threadIdx.x; k < tile / 2; k += blockDim.x) {
      const int r = k >> (log_n - 1);
      const int kk = k & ((n >> 1) - 1);
      const int pos = kk & (half - 1);
      const int i0 = (r << log_n) + ((kk >> (lg - 1)) << lg) + pos;
      const uint32_t u = s[i0];
      const uint32_t v = bb::mont_mul(s[i0 + half], table[pos << tshift]);
      s[i0] = bb::add(u, v);
      s[i0 + half] = bb::sub(u, v);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const long long g = row0 + (i >> log_n);
    if (g < n_rows) out[g * n + (i & (n - 1))] = (int64_t)s[i];
  }
}

int launch_rows(const int64_t* in, int64_t* out, long long n_rows, int log_n,
                const uint32_t* table, cudaStream_t st) {
  const long long tile = (1 << log_n) > TILE_MIN ? (1 << log_n) : TILE_MIN;
  const long long blocks = (n_rows * (1LL << log_n) + tile - 1) / tile;
  ntt_rows_kernel<<<(unsigned)blocks, ROW_THREADS, 0, st>>>(in, out, n_rows, log_n, table);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The four-step passes (14 <= log_n <= 27).

constexpr int FS_THREADS = 512;
constexpr int STRIP_LOG_WORDS = 14;  // a block's strip: at most 2^14 words, 64 KB
constexpr int LOAD_BATCH = 8;        // 16-byte loads a thread keeps in flight
constexpr int LOG_CLUSTER = 1;       // 2 blocks a cluster: they move whole sectors together
constexpr int CLUSTER = 1 << LOG_CLUSTER;
constexpr int LOG_TILE = 2;  // the scratch's tiles: the TILE columns of a pass-2 cluster
constexpr int TILE = 1 << LOG_TILE;
static_assert(TILE == 2 * CLUSTER, "a row of a tile is one 16-byte vector, two columns a block");

// log2 of the columns of a pass-1 strip of 2^l-point columns: 2^14 words
// from 2^11 points up, else 2 columns (wider strips of shorter columns
// would meet bank conflicts in the loads; see swz)
__host__ __device__ constexpr int strip_log(int l) { return l >= 11 ? STRIP_LOG_WORDS - l : 1; }

// Shared-memory word of flat strip index f = c * 2^l + i (column c, point
// i) in a strip of 2^lc columns: bits 0-4 of f XOR the bits of i from
// hs = max(7, l - 5) up XOR 31 times bit 5 of f XOR 21 times bit 6 XOR
// (c >> 1) ^ (c << cs) mod 32, cs = max(2, 5 - lc). The terms depend on
// bits >= 5 only, so the map is a bijection on every run of 64 words. In
// one warp access:
// - 32 consecutive points of one column (natural-order reads, stages with
//   a half of 32 or more): the terms are one constant, the banks distinct;
// - 32 bit-reversed points (the loads): they differ in the top 5 bits of
//   i, which the first term maps onto the bank bits one to one (bit 6 of
//   i at l = 11 through the bit-6 term, which sets bank bit 4);
// - a radix-2 stage of half 1: the lanes cover bits 1-5; the bit-5 term
//   sets bank bit 0;
// - a radix-4 round on halves h = 2^k < 32: the lanes cover bits 0-6 but
//   bits k and k + 1; the bit-5 and bit-6 terms (31 and 21) are independent
//   on bank bits k, k + 1 for every k < 4 and 21 sets bank bit 4 for k = 4;
// - the loads into one block's strip: the 16 lanes of a warp that hold
//   its columns (32/C rows, C/2 column pairs) fall on distinct banks
//   through the row term and the c >> 1 of the column term;
// - pass 1's store in tile order: 32/C consecutive points of each of the
//   C columns, which c << cs puts on distinct bank bits;
// - pass 2's output: the 16 lanes of a warp that read one block's strip
//   read 16 consecutive points.
struct Swz {
  int l, hs, hmask, cs;
};

__device__ __forceinline__ Swz make_swz(int l, int lc) {
  const int hs = l - 5 > 7 ? l - 5 : 7;
  return {l, hs, (((1 << l) - 1) >> hs) & 31, 5 - lc > 2 ? 5 - lc : 2};
}

__device__ __forceinline__ int col_term(int c, const Swz& z) {
  return ((c >> 1) ^ (c << z.cs)) & 31;
}

// Every term is linear over GF(2) in the bits of f, so for f, g with no
// bit in common swz(f | g) = swz(f) ^ swz(g): the stages and the loads take
// one full swz a quartet or a row and XOR constants for the rest.
__device__ __forceinline__ int swz(int f, const Swz& z) {
  return f ^ ((f >> z.hs) & z.hmask) ^ (-((f >> 5) & 1) & 31) ^ (-((f >> 6) & 1) & 21) ^
         col_term(f >> z.l, z);
}

// swz(c << l) for a column c: only the column term reads bits >= l.
__device__ __forceinline__ int swz_col(int c, const Swz& z) { return (c << z.l) ^ col_term(c, z); }

// tw[2^(lg-1) + pos] = w_{2^lg}^pos for 1 <= lg <= l, from table, the
// powers of the 2^table_log-th root: a stage's twiddles lie side by side.
__device__ __forceinline__ void copy_twiddles(uint32_t* tw, int l,
                                              const uint32_t* __restrict__ table,
                                              int table_log) {
  for (int t0 = 1 + threadIdx.x; t0 < (1 << l); t0 += 4 * FS_THREADS) {
    uint32_t v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = t0 + u * FS_THREADS, lg = 32 - __clz(t);
      if (t < (1 << l)) v[u] = table[(t - (1 << (lg - 1))) << (table_log - lg)];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (t0 + u * FS_THREADS < (1 << l)) tw[t0 + u * FS_THREADS] = v[u];
  }
}

// The l DIT stages of the 2^log_cols columns of 2^l points in s,
// bit-reversed order in, natural order out: a radix-2 stage of half 1 when
// l is odd, then rounds of two stages (lg, lg + 1) on quartets, one barrier
// a round. Quartet q with h = 2^(lg-1): flat i0 + m h, m < 4, with
// i0 = 4q - 3 (q mod h).
// Quartet q's first point: q with two zero bits inserted at lg - 1 (h =
// 2^(lg-1)), linear in the bits of q like swz, so for q = q0 | t (q0 a
// multiple of the block's threads, t the thread) swz(ins(q)) =
// swz(ins(q0)) ^ swz(ins(t)): a thread swizzles its own part once a round,
// and the part of q0 is the same in every thread.
__device__ __forceinline__ int ins2(int q, int h) { return ((q & ~(h - 1)) << 2) | (q & (h - 1)); }

__device__ __forceinline__ void strip_stages(uint32_t* s, const uint32_t* tw, int l,
                                             int log_cols, const Swz& z) {
  int lg = 1;
  if (l & 1) {  // half 1: the twiddle is 1; swz(2k + 1) = swz(2k) ^ 1
    const int pairs = 1 << (l - 1 + log_cols), at = swz(2 * threadIdx.x, z);
#pragma unroll 4
    for (int k0 = 0; k0 < pairs; k0 += FS_THREADS) {
      if (k0 + (int)threadIdx.x >= pairs) break;  // fewer pairs than threads
      const int a0 = at ^ swz(2 * k0, z), a1 = a0 ^ 1;
      const uint32_t u = s[a0], v = s[a1];
      s[a0] = bb::fast::add(u, v);
      s[a1] = bb::fast::sub(u, v);
    }
    __syncthreads();
    lg = 2;
  }
  const int quartets = 1 << (l - 2 + log_cols);
  for (; lg < l; lg += 2) {
    const int h = 1 << (lg - 1);
    const int d1 = swz(h, z), d2 = swz(2 * h, z), d3 = swz(3 * h, z);
    const int at = swz(ins2(threadIdx.x, h), z), pt = threadIdx.x & (h - 1);
#pragma unroll 2
    for (int q0 = 0; q0 < quartets; q0 += FS_THREADS) {
      if (q0 + (int)threadIdx.x >= quartets) break;  // fewer quartets than threads
      const int pos = (q0 & (h - 1)) | pt;
      const int a0 = at ^ swz(ins2(q0, h), z), a1 = a0 ^ d1, a2 = a0 ^ d2, a3 = a0 ^ d3;
      const uint32_t t1 = tw[h + pos], t2 = tw[2 * h + pos], t3 = tw[3 * h + pos];
      const uint32_t x0 = s[a0], x1 = bb::fast::mont(s[a1], t1);
      const uint32_t x2 = s[a2], x3 = bb::fast::mont(s[a3], t1);
      const uint32_t y0 = bb::fast::add(x0, x1), y1 = bb::fast::sub(x0, x1);
      const uint32_t u2 = bb::fast::mont(bb::fast::add(x2, x3), t2);
      const uint32_t u3 = bb::fast::mont(bb::fast::sub(x2, x3), t3);
      s[a0] = bb::fast::add(y0, u2);
      s[a2] = bb::fast::sub(y0, u2);
      s[a1] = bb::fast::add(y1, u3);
      s[a3] = bb::fast::sub(y1, u3);
    }
    __syncthreads();
  }
}

// Pass 1: a cluster of CLUSTER blocks takes CLUSTER * C adjacent columns
// j2 of the (n1, n2) view of in[b]; block rank holds j2 = j2_0 + c, c < C.
// Block rank loads rows [rank * n1/CLUSTER, ...) of all the cluster's
// columns, 16 bytes (two columns of one block) a lane, a row's lanes side
// by side, so that one instruction reads whole rows of 16 C CLUSTER bytes,
// and stores each value into its block's strip through distributed shared
// memory. Then the block's n1-point NTTs, the product by w^(j2*k1) =
// hi[e >> l1] * lo[e & (n1-1)], and the tiled A_T[b, k1 >> 2, j2, k1 & 3]
// (u32): a run of 4 C words a tile, thread g taking tile g >> (lc + 2),
// column (g >> 2) mod C and k1 & 3 = g & 3.
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(FS_THREADS, 2)
    ntt_pass1_kernel(const int64_t* __restrict__ in, uint32_t* __restrict__ a_t, int l1, int l2,
                     const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo) {
  extern __shared__ uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int lc = strip_log(l1), n1 = 1 << l1;
  const Swz z = make_swz(l1, lc);
  const long long b = blockIdx.x >> (l2 - lc);
  const int j2_0 = (int)(blockIdx.x & ((1u << (l2 - lc)) - 1)) << lc;
  const int rank = (int)cluster.block_rank();
  const int lv = lc - 1 + LOG_CLUSTER;  // 16-byte vectors a row, log2
  uint32_t* tw = smem + (n1 << lc);
  copy_twiddles(tw, l1, hi, l2);
  const int row_0 = rank << (l1 - LOG_CLUSTER);
  const int64_t* src = in + (b << (l1 + l2)) + (j2_0 - (rank << lc)) + ((long long)row_0 << l2);
  const int total = 1 << (l1 - 1 + lc);  // 16-byte vectors this block loads
  cluster.sync();  // every block runs: its shared memory takes stores
  for (int v0 = threadIdx.x; v0 < total; v0 += LOAD_BATCH * FS_THREADS) {
    longlong2 buf[LOAD_BATCH];
#pragma unroll
    for (int u = 0; u < LOAD_BATCH; ++u) {
      const int v = v0 + u * FS_THREADS;
      if (v < total)
        buf[u] = reinterpret_cast<const longlong2*>(src + ((long long)(v >> lv) << l2))
            [v & ((1 << lv) - 1)];
    }
#pragma unroll
    for (int u = 0; u < LOAD_BATCH; ++u) {
      const int v = v0 + u * FS_THREADS;
      if (v < total) {
        const int i = (int)(__brev((unsigned)(row_0 + (v >> lv))) >> (32 - l1));
        const int w = v & ((1 << lv) - 1), c = (w << 1) & ((1 << lc) - 1);
        uint32_t* sq = cluster.map_shared_rank(smem, w >> (lc - 1));
        const int a = swz(i, z) ^ swz_col(c, z);
        sq[a] = (uint32_t)buf[u].x;
        sq[a ^ swz_col(1, z)] = (uint32_t)buf[u].y;  // column c + 1: c is even
      }
    }
  }
  cluster.sync();  // every strip loaded
  strip_stages(smem, tw, l1, lc, z);
  uint32_t* dst = a_t + (b << (l1 + l2)) + ((long long)j2_0 << LOG_TILE);
#pragma unroll 4
  for (int g = threadIdx.x; g < (n1 << lc); g += FS_THREADS) {
    const int t = g >> (lc + LOG_TILE), c = (g >> LOG_TILE) & ((1 << lc) - 1);
    const int k1 = (t << LOG_TILE) | (g & (TILE - 1));
    const int e = (j2_0 + c) * k1;  // < N <= 2^27
    const uint32_t w = bb::mont_mul(hi[e >> l1], lo[e & (n1 - 1)]);
    dst[((long long)t << (l2 + LOG_TILE)) + (g & ((TILE << lc) - 1))] =
        bb::mont_mul(smem[swz(k1, z) ^ swz_col(c, z)], w);
  }
}

// Pass 2: a cluster of CLUSTER blocks takes the TILE adjacent columns k1
// of one tile of A_T[b] (n2 rows of TILE, contiguous); block rank holds
// k1 = k1_0 + 2 rank, k1_0 + 2 rank + 1. Block rank loads rows
// [rank * n2/CLUSTER, ...) of the tile, 16 bytes (a row: four u32, two
// blocks' columns) a lane, into the blocks' strips.
// n2-point NTTs. Then block rank writes the same rows of out[b, k2*n1 + k1]
// for all the cluster's columns, 16 bytes (one block's two columns) a
// lane, so that one instruction writes whole rows of 16 CLUSTER bytes.
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(FS_THREADS, 2)
    ntt_pass2_kernel(const uint32_t* __restrict__ a_t, int64_t* __restrict__ out, int l1, int l2,
                     const uint32_t* __restrict__ hi) {
  extern __shared__ uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n2 = 1 << l2, rows = n2 >> LOG_CLUSTER;
  const Swz z = make_swz(l2, 1);
  const long long b = blockIdx.x >> (l1 - 1);
  const int rank = (int)cluster.block_rank();
  // the cluster's first column
  const int k1_0 = ((int)(blockIdx.x & ((1u << (l1 - 1)) - 1)) << 1) - 2 * rank;
  const int k2_0 = rank * rows;
  uint32_t* tw = smem + (n2 << 1);
  copy_twiddles(tw, l2, hi, l2);
  const uint4* src = reinterpret_cast<const uint4*>(
      a_t + (b << (l1 + l2)) + ((long long)(k1_0 >> LOG_TILE) << (l2 + LOG_TILE))) + k2_0;
  const int c1 = swz_col(1, z);
  cluster.sync();  // every block runs: its shared memory takes stores
  for (int v0 = threadIdx.x; v0 < rows; v0 += LOAD_BATCH * FS_THREADS) {
    uint4 buf[LOAD_BATCH];
#pragma unroll
    for (int u = 0; u < LOAD_BATCH; ++u) {
      const int v = v0 + u * FS_THREADS;
      if (v < rows) buf[u] = src[v];
    }
#pragma unroll
    for (int u = 0; u < LOAD_BATCH; ++u) {
      const int v = v0 + u * FS_THREADS;
      if (v < rows) {
        const int a = swz((int)(__brev((unsigned)(k2_0 + v)) >> (32 - l2)), z);
        uint32_t* s0 = cluster.map_shared_rank(smem, 0);
        uint32_t* s1 = cluster.map_shared_rank(smem, 1);
        s0[a] = buf[u].x;
        s0[a ^ c1] = buf[u].y;
        s1[a] = buf[u].z;
        s1[a ^ c1] = buf[u].w;
      }
    }
  }
  cluster.sync();  // every strip loaded
  strip_stages(smem, tw, l2, 1, z);
  cluster.sync();  // every strip transformed
  int64_t* dst = out + (b << (l1 + l2)) + k1_0 + ((long long)k2_0 << l1);
#pragma unroll 4
  for (int v = threadIdx.x; v < n2; v += FS_THREADS) {
    const int q = v & (CLUSTER - 1), k2 = k2_0 + (v >> LOG_CLUSTER);
    const uint32_t* sq = cluster.map_shared_rank(smem, q);
    const int a = swz(k2, z);
    longlong2 w;
    w.x = sq[a];
    w.y = sq[a ^ c1];
    reinterpret_cast<longlong2*>(dst + ((long long)(v >> LOG_CLUSTER) << l1))[q] = w;
  }
  cluster.sync();  // the other blocks are done reading this block's strip
}

int launch_four_step(const int64_t* in, int64_t* out, uint32_t* scratch, long long batch,
                     int l1, int l2, const uint32_t* hi, const uint32_t* lo, cudaStream_t st) {
  if ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out) |
       reinterpret_cast<uintptr_t>(scratch)) & 15)
    return (int)cudaErrorMisalignedAddress;
  const int lc = strip_log(l1);
  const int smem1 = (int)sizeof(uint32_t) * (((1 << lc) + 1) << l1);  // strip + twiddles
  const int smem2 = (int)sizeof(uint32_t) * (3 << l2);
  cudaError_t e = cudaFuncSetAttribute(ntt_pass1_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ntt_pass2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem2);
  if (e != cudaSuccess) return (int)e;
  ntt_pass1_kernel<<<(unsigned)(batch << (l2 - lc)), FS_THREADS, smem1, st>>>(in, scratch, l1,
                                                                              l2, hi, lo);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ntt_pass2_kernel<<<(unsigned)(batch << (l1 - 1)), FS_THREADS, smem2, st>>>(scratch, out, l1,
                                                                             l2, hi);
  return (int)cudaGetLastError();
}

}  // namespace

// in/out: (batch, 2^log_n) int64 canonical, 16-byte aligned. table: n2 + n1
// Montgomery values, hi then lo (see the note above; n1 = 1 and n2 = N for
// log_n <= 13, else n1 = 2^(log_n/2)). scratch: batch * 2^log_n uint32,
// used only when log_n > 13. Returns the first CUDA error, or 0.
extern "C" int swirl_ntt(const int64_t* in, int64_t* out, uint32_t* scratch, long long batch,
                         int log_n, const uint32_t* table, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (log_n < 1 || log_n > TWO_ADICITY) return (int)cudaErrorInvalidValue;
  if (log_n <= SMALL_LOG_MAX) {
    return launch_rows(in, out, batch, log_n, table, st);
  }
  const int l1 = log_n / 2, l2 = log_n - l1;  // x[j1 * n2 + j2], j1 < n1 = 2^l1
  const uint32_t* hi = table;                 // w^(n1*e) = w_n2^e, e < n2
  const uint32_t* lo = table + (1LL << l2);   // w^e, e < n1
  return launch_four_step(in, out, scratch, batch, l1, l2, hi, lo, st);
}

extern "C" const char* swirl_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The number of nodes of a CUDA graph, a cudaGraph_t handle (what
// torch.cuda.CUDAGraph.raw_cuda_graph() gives for a graph kept after its
// instantiation).
extern "C" int swirl_graph_nodes(void* graph, unsigned long long* count) {
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes((cudaGraph_t)graph, nullptr, &n);
  *count = n;
  return (int)e;
}
