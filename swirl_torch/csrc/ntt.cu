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
// What bounds it on the H100: memory passes. A butterfly costs one
// Montgomery product and two adds; the least bytes are one int64 read and
// one int64 write per element (for the leaf encode (2, 2^27): 4.29 GB,
// 1.28 ms at 3.35 TB/s), and the integer work of N/2 log N butterflies is
// of the same order at the int32 rate, so the time is set by the number of
// trips through device memory. Design:
// - log_n <= 13 (the path's (2^22, 16) and (2^18, 16) chunk transforms and
//   the small golden sizes): one pass. A block loads whole rows (several
//   rows per block below 1024 points) into 32 KB of static shared memory
//   in bit-reversed order, runs every radix-2 DIT stage there, and stores
//   natural order.
// - 13 < log_n <= 27: the four-step split N = n1 * n2 (n1 = 2^(log_n/2)
//   <= n2) as five passes through global memory: transpose, n1-point row
//   NTTs, transpose fused with the w^(j2*k1) twiddle, n2-point row NTTs,
//   transpose. A TPU grid step carried state to the next one; here every
//   block is independent, and the transposes move data between the two
//   sub-transforms. At 2^27 (A′) n2 = 2^14: a 64 KB row, which the TPU
//   could not hold in one block and so split once more (a second four-step
//   level through HBM). A Hopper block takes up to 227 KB of dynamic shared
//   memory, so the 2^14-point rows run in the same one-pass row kernel
//   with 64 KB of dynamic shared memory, and A′ keeps today's five passes.
//   Rows of 2^13 or fewer keep the static 32 KB kernel and its occupancy.
//   The five passes move 48 B per element (int64 in, three uint32 round
//   trips, int64 out) against the bound's 16 B: expect A′ at (2, 2^27) to
//   take 3x to 8x its 1.28 ms bound.
// Twiddles come from a two-level table of n2 + n1 Montgomery values:
// hi[e] = w^(n1*e) (the n2-th root's powers, which also serve every row
// sub-NTT by stride) and lo[e] = w^e for e < n1; the four-step twiddle is
// w^(r*c) = hi[(r*c) >> l1] * lo[(r*c) & (n1-1)], one more Montgomery
// product than a full table of w^e would need, and 2^27 x 4 B less memory.
// A Montgomery product of two Montgomery values is a Montgomery value, and
// that of a canonical value and a Montgomery constant is canonical, so the
// data never changes representation.
#include "field.cuh"

namespace {

constexpr int TWO_ADICITY = 27;
constexpr int SMALL_LOG_MAX = 13;  // 8192 points = 32 KB of static shared memory
constexpr int ROW_LOG_MAX = 14;    // 16384 points = 64 KB of dynamic shared memory
constexpr int TILE_MIN = 1024;     // points per block for short rows
constexpr int ROW_THREADS = 512;

// Row NTTs of 2^log_n points in the shared buffer s (tile points).
// table holds the powers of the 2^table_log-th root, table_log >= log_n.
template <typename TIn, typename TOut>
__device__ __forceinline__ void ntt_rows_body(uint32_t* s, const TIn* in, TOut* out,
                                              long long n_rows, int log_n,
                                              const uint32_t* __restrict__ table,
                                              int table_log) {
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
  // stage lg merges blocks of 2^(lg-1); w_len^pos = w^(pos << (table_log - lg))
  for (int lg = 1; lg <= log_n; ++lg) {
    const int half = 1 << (lg - 1);
    const int tshift = table_log - lg;
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
    if (g < n_rows) out[g * n + (i & (n - 1))] = (TOut)s[i];
  }
}

template <typename TIn, typename TOut>
__global__ void ntt_rows_kernel(const TIn* in, TOut* out, long long n_rows, int log_n,
                                const uint32_t* __restrict__ table, int table_log) {
  __shared__ uint32_t s[1 << SMALL_LOG_MAX];
  ntt_rows_body<TIn, TOut>(s, in, out, n_rows, log_n, table, table_log);
}

// A′'s row kernel: one 2^14-point row per block in dynamic shared memory.
__global__ void ntt_rows_wide_kernel(const uint32_t* in, uint32_t* out, long long n_rows,
                                     int log_n, const uint32_t* __restrict__ table,
                                     int table_log) {
  extern __shared__ uint32_t s_dyn[];
  ntt_rows_body<uint32_t, uint32_t>(s_dyn, in, out, n_rows, log_n, table, table_log);
}

// (batch, rows, cols) -> (batch, cols, rows); with tables, element (r, c)
// is multiplied by w^(r*c) = hi[(r*c) >> log_lo] * lo[(r*c) & (2^log_lo - 1)]
// on the way (the four-step twiddle).
template <typename TIn, typename TOut>
__global__ void transpose_kernel(const TIn* __restrict__ in, TOut* __restrict__ out,
                                 int log_rows, int log_cols,
                                 const uint32_t* __restrict__ hi,
                                 const uint32_t* __restrict__ lo, int log_lo) {
  __shared__ uint32_t tile[32][33];
  const int tiles_c = 1 << (log_cols - 5);
  const int tiles_r = 1 << (log_rows - 5);
  long long bid = blockIdx.x;
  const int tc = (int)(bid % tiles_c);
  bid /= tiles_c;
  const int tr = (int)(bid % tiles_r);
  const long long b = bid / tiles_r;
  const long long base = b << (log_rows + log_cols);
  const int c = tc * 32 + threadIdx.x;
  for (int y = threadIdx.y; y < 32; y += blockDim.y) {
    const int r = tr * 32 + y;
    uint32_t v = (uint32_t)in[base + ((long long)r << log_cols) + c];
    if (hi != nullptr) {
      const long long e = (long long)r * c;  // < N <= 2^27
      const uint32_t w = bb::mont_mul(hi[e >> log_lo], lo[e & ((1LL << log_lo) - 1)]);
      v = bb::mont_mul(v, w);
    }
    tile[y][threadIdx.x] = v;
  }
  __syncthreads();
  const int r_out = tr * 32 + threadIdx.x;
  for (int y = threadIdx.y; y < 32; y += blockDim.y) {
    const int c_out = tc * 32 + y;
    out[base + ((long long)c_out << log_rows) + r_out] = (TOut)tile[threadIdx.x][y];
  }
}

template <typename TIn, typename TOut>
int launch_rows(const TIn* in, TOut* out, long long n_rows, int log_n,
                const uint32_t* table, int table_log, cudaStream_t st) {
  const long long tile = (1 << log_n) > TILE_MIN ? (1 << log_n) : TILE_MIN;
  const long long blocks = (n_rows * (1LL << log_n) + tile - 1) / tile;
  ntt_rows_kernel<TIn, TOut><<<(unsigned)blocks, ROW_THREADS, 0, st>>>(
      in, out, n_rows, log_n, table, table_log);
  return (int)cudaGetLastError();
}

int launch_rows_wide(const uint32_t* in, uint32_t* out, long long n_rows, int log_n,
                     const uint32_t* table, int table_log, cudaStream_t st) {
  const int smem = (int)sizeof(uint32_t) << log_n;
  cudaError_t e = cudaFuncSetAttribute(ntt_rows_wide_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  ntt_rows_wide_kernel<<<(unsigned)n_rows, ROW_THREADS, smem, st>>>(
      in, out, n_rows, log_n, table, table_log);
  return (int)cudaGetLastError();
}

int launch_rows_u32(const uint32_t* in, uint32_t* out, long long n_rows, int log_n,
                    const uint32_t* table, int table_log, cudaStream_t st) {
  if (log_n > SMALL_LOG_MAX) return launch_rows_wide(in, out, n_rows, log_n, table, table_log, st);
  return launch_rows<uint32_t, uint32_t>(in, out, n_rows, log_n, table, table_log, st);
}

template <typename TIn, typename TOut>
int launch_transpose(const TIn* in, TOut* out, long long batch, int log_rows, int log_cols,
                     const uint32_t* hi, const uint32_t* lo, int log_lo, cudaStream_t st) {
  const long long blocks = batch << (log_rows - 5 + log_cols - 5);
  transpose_kernel<TIn, TOut><<<(unsigned)blocks, dim3(32, 8), 0, st>>>(
      in, out, log_rows, log_cols, hi, lo, log_lo);
  return (int)cudaGetLastError();
}

}  // namespace

// in/out: (batch, 2^log_n) int64 canonical. table: n2 + n1 Montgomery
// values, hi then lo (see the note above; n1 = 1 and n2 = N for
// log_n <= 13, else n1 = 2^(log_n/2)). scratch0/1: batch * 2^log_n uint32
// each, used only when log_n > 13. Returns the first CUDA error, or 0.
extern "C" int swirl_ntt(const int64_t* in, int64_t* out, uint32_t* scratch0,
                         uint32_t* scratch1, long long batch, int log_n,
                         const uint32_t* table, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (log_n < 1 || log_n > TWO_ADICITY) return (int)cudaErrorInvalidValue;
  if (log_n <= SMALL_LOG_MAX) {
    return launch_rows<int64_t, int64_t>(in, out, batch, log_n, table, log_n, st);
  }
  const int l1 = log_n / 2, l2 = log_n - l1;  // x[j1 * n2 + j2], j1 < n1 = 2^l1
  if (l2 > ROW_LOG_MAX) return (int)cudaErrorInvalidValue;
  const uint32_t* hi = table;               // w^(n1*e) = w_n2^e, e < n2
  const uint32_t* lo = table + (1LL << l2);  // w^e, e < n1
  int rc;
  if ((rc = launch_transpose<int64_t, uint32_t>(in, scratch0, batch, l1, l2, nullptr,
                                                nullptr, 0, st)))
    return rc;
  if ((rc = launch_rows_u32(scratch0, scratch1, batch << l2, l1, hi, l2, st))) return rc;
  if ((rc = launch_transpose<uint32_t, uint32_t>(scratch1, scratch0, batch, l2, l1, hi, lo,
                                                 l1, st)))
    return rc;
  if ((rc = launch_rows_u32(scratch0, scratch1, batch << l1, l2, hi, l2, st))) return rc;
  return launch_transpose<uint32_t, int64_t>(scratch1, out, batch, l1, l2, nullptr, nullptr,
                                             0, st);
}

extern "C" const char* swirl_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
