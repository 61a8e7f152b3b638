// Kernel L: the batch sumcheck's EF4 products (swirl_torch/fields/ef4.py).
//
// L  ef4_mul      c = a b of two EF4 tensors, equal shapes or one operand
//                 broadcast, each read in place through its strides.
//    ef4_mul_sum  sum_i w_i v_(index_i) over v's leading axis, v EF4 or base
//                 field, w (k, 4) EF4 weights, index an optional gather.
//
// Replaces no Pallas kernel: the JAX package runs these as XLA ops
// (swirl/fields/jfield.py ext_mul :256, ext_sum :311), and the port ran an
// EF4 product as about fifty aten operations (fields/field.py ext_mul: 16
// products and remainders, the x^4 = 11 terms, a stack), a weighted sum
// as a gather, that product and a sum.
//
// What bounds it on the H100: at the path's large shapes the bytes (a
// product reads 64 B and writes 32 B for 23 Montgomery products; a term of
// a sum reads 32 B, or 8 B of a base value, for 19 or 4), far below the
// multiply pipe's rate; at its many small shapes (the rounds' tables shrink
// to a few rows) one launch's latency. Design: one launch for either, no
// intermediate in device memory, the result canonical and bit-equal to the
// plain path's.
//
// ef4_mul: a thread an output element, the batch index split by the
// output's (coalesced, at most MUL_DIMS) dims into each operand's offset,
// two 16-byte loads an operand, c = (a b / R) R by one fix-up product a
// coefficient.
//
// ef4_mul_sum: the block is tj x (THREADS / tj) threads: tj consecutive
// output columns j (coalesced loads of v's rows), the other THREADS / tj
// lanes splitting the terms i (lane t of a block takes its terms t, t +
// lanes, ...; a weight and a row index are read by every column's thread,
// one broadcast load a warp). A term is w_i v / R, its sums at R^-1 until
// one fix-up product a word as the output is written. The lanes' sums meet
// in shared memory. With gy > 1 (few columns, many terms: gx is then 1)
// block y takes terms [y per_block, (y + 1) per_block), writes its partial
// sums, and the block that draws the last ticket sums the partials into the
// output and resets the ticket (the counter the wrapper keeps per stream, or
// the capture's own, as kernels D, F and K do). A launch makes no host
// read.
#include "ef4.cuh"

namespace {

using namespace ef4;

constexpr int THREADS = 256;
constexpr int MUL_DIMS = 3;

// The output's batch dims (innermost last) and each operand's strides in
// int64 words.
struct MulShape {
  unsigned size[MUL_DIMS];
  long long sa[MUL_DIMS];
  long long sb[MUL_DIMS];
};

// c R: the canonical value of a Montgomery product's c = a b / R
__device__ __forceinline__ Ef fix(const Ef& c) {
  return Ef{{mul(c.v[0], bb::R2), mul(c.v[1], bb::R2), mul(c.v[2], bb::R2), mul(c.v[3], bb::R2)}};
}

template <int DIMS>
__global__ void __launch_bounds__(THREADS) mul_kernel(const int64_t* a, const int64_t* b, int64_t* out,
                                                      unsigned n, MulShape s) {
  for (unsigned e = blockIdx.x * THREADS + threadIdx.x; e < n; e += gridDim.x * THREADS) {
    long long oa = 0, ob = 0;
    unsigned rest = e;
#pragma unroll
    for (int d = DIMS - 1; d >= 0; --d) {
      const unsigned i = d ? rest % s.size[d] : rest;
      rest = d ? rest / s.size[d] : 0;
      oa += i * s.sa[d];
      ob += i * s.sb[d];
    }
    store(out + 4 * (long long)e, fix(rmul(load(a + oa), load(b + ob))));
  }
}

// out[j] = sum_i w_i v[row_i][j], row_i = index ? index[i] : i, for j < m.
// EXT: v's rows hold m EF4 values, else m base values. A term is a
// Montgomery product (w_i v / R), so the sums carry R^-1 until the output
// is written (one fix-up product a word). partials: 4 m words a block of
// the y axis; ticket: zero, left zero.
template <bool EXT>
__global__ void __launch_bounds__(THREADS) mul_sum_kernel(const int64_t* v, long long row_stride,
                                                          const int64_t* index, const int64_t* w, int k,
                                                          int per_block, unsigned m, int tj, int64_t* out,
                                                          uint32_t* partials, unsigned* ticket) {
  __shared__ uint32_t s_red[4][THREADS];
  __shared__ bool last;
  const int tx = threadIdx.x % tj, ty = threadIdx.x / tj, lanes = THREADS / tj;
  const unsigned j = blockIdx.x * tj + tx;
  const int i0 = blockIdx.y * per_block, i1 = min(k, i0 + per_block);
  Ef acc = {{0u, 0u, 0u, 0u}};
  if (j < m) {
#pragma unroll 4
    for (int i = i0 + ty; i < i1; i += lanes) {
      const int64_t* row = v + (index ? __ldg(reinterpret_cast<const long long*>(index) + i) : i) * row_stride;
      const Ef wi = load(w + 4 * (long long)i);
      if (EXT) {
        acc = eadd(acc, rmul(load(row + 4 * (long long)j), wi));
      } else {
        const uint32_t x = (uint32_t)__ldg(reinterpret_cast<const long long*>(row) + j);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc.v[q] = add(acc.v[q], mul(x, wi.v[q]));
      }
    }
  }
  if (lanes > 1) {  // a tree over the lanes (a power of two)
#pragma unroll
    for (int q = 0; q < 4; ++q) s_red[q][threadIdx.x] = acc.v[q];
    __syncthreads();
    for (int h = lanes / 2; h > 0; h >>= 1) {
      if (ty < h) {
#pragma unroll
        for (int q = 0; q < 4; ++q) s_red[q][threadIdx.x] = add(s_red[q][threadIdx.x], s_red[q][threadIdx.x + h * tj]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) acc.v[q] = s_red[q][tx];
  }
  const bool owner = ty == 0 && j < m;
  if (gridDim.y == 1) {
    if (owner) store(out + 4 * (long long)j, fix(acc));
    return;
  }
  if (owner) {
#pragma unroll
    for (int q = 0; q < 4; ++q) partials[(blockIdx.y * m + j) * 4 + q] = acc.v[q];
    __threadfence();  // the partials, visible before the ticket
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: word q of column j summed over the blocks, then times R;
  // below THREADS words, split lanes of threads split the blocks (four loads
  // in flight a thread) and meet in shared memory
  const unsigned words = 4 * m;
  if (words < THREADS) {
    const unsigned split = THREADS / words, wd = threadIdx.x % words, lane = threadIdx.x / words;
    uint32_t s[4] = {0u, 0u, 0u, 0u};
    if (lane < split) {
      unsigned b = lane;
      for (; b + 3 * split < gridDim.y; b += 4 * split) {
#pragma unroll
        for (int u = 0; u < 4; ++u) s[u] = add(s[u], __ldcg(partials + (b + u * split) * words + wd));
      }
      for (; b < gridDim.y; b += split) s[0] = add(s[0], __ldcg(partials + b * words + wd));
    }
    s_red[0][threadIdx.x] = add(add(s[0], s[1]), add(s[2], s[3]));
    __syncthreads();
    for (unsigned h = split; h > 1;) {  // a tree over the split lanes
      const unsigned half = (h + 1) / 2;
      if (lane + half < h) s_red[0][threadIdx.x] = add(s_red[0][threadIdx.x], s_red[0][threadIdx.x + half * words]);
      __syncthreads();
      h = half;
    }
    if (threadIdx.x < words) out[threadIdx.x] = mul(s_red[0][threadIdx.x], bb::R2);
  } else {
    for (unsigned x = threadIdx.x; x < words; x += THREADS) {
      uint32_t t = 0u;
      for (unsigned b = 0; b < gridDim.y; ++b) t = add(t, __ldcg(partials + b * words + x));
      out[x] = mul(t, bb::R2);
    }
  }
  if (threadIdx.x == 0) *ticket = 0;
}

}  // namespace

// shape: [dims, size[MUL_DIMS], sa[MUL_DIMS], sb[MUL_DIMS]] on the host, the
// output's coalesced batch dims (1 <= dims <= MUL_DIMS, innermost last) and
// each operand's strides in int64 words; n = the product of the sizes < 2^31;
// out contiguous (n, 4). blocks: from the wrapper.
extern "C" int swirl_ef4_mul(const int64_t* a, const int64_t* b, int64_t* out, long long n, const long long* shape,
                             int blocks, void* stream) {
  const int dims = (int)shape[0];
  if (dims < 1 || dims > MUL_DIMS || n < 1 || n >= (1LL << 31) || blocks < 1) return (int)cudaErrorInvalidValue;
  MulShape s;
  long long count = 1;
  for (int d = 0; d < MUL_DIMS; ++d) {
    const bool on = d < dims;
    s.size[d] = on ? (unsigned)shape[1 + d] : 1u;
    s.sa[d] = on ? shape[1 + MUL_DIMS + d] : 0;
    s.sb[d] = on ? shape[1 + 2 * MUL_DIMS + d] : 0;
    count *= s.size[d];
  }
  if (count != n) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned un = (unsigned)n;
  if (dims == 1) {
    mul_kernel<1><<<blocks, THREADS, 0, st>>>(a, b, out, un, s);
  } else if (dims == 2) {
    mul_kernel<2><<<blocks, THREADS, 0, st>>>(a, b, out, un, s);
  } else {
    mul_kernel<3><<<blocks, THREADS, 0, st>>>(a, b, out, un, s);
  }
  return (int)cudaGetLastError();
}

// v: row i at v + row_i * row_stride words, m EF4 (ext) or base values;
// index: k int64 rows, or null for rows 0..k-1; w: (k, 4) EF4; out: (m, 4).
// tj: a power of two <= 256; gy blocks split the terms (gy > 1 only when
// m <= tj), with partials (gy, m, 4) uint32 words and a zero ticket.
extern "C" int swirl_ef4_mul_sum(const int64_t* v, long long row_stride, const int64_t* index, const int64_t* w,
                                 int k, long long m, int ext, int tj, int gy, int64_t* out, uint32_t* partials,
                                 unsigned* ticket, void* stream) {
  if (k < 1 || m < 1 || m >= (1LL << 31) || tj < 1 || tj > THREADS || (tj & (tj - 1)) || gy < 1 || gy > 65535)
    return (int)cudaErrorInvalidValue;
  const long long gx = (m + tj - 1) / tj;
  if (gy > 1 && (gx != 1 || !partials || !ticket)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  const int per_block = (k + gy - 1) / gy;
  const cudaStream_t st = (cudaStream_t)stream;
  if (ext) {
    mul_sum_kernel<true><<<grid, THREADS, 0, st>>>(v, row_stride, index, w, k, per_block, (unsigned)m, tj, out,
                                                   partials, ticket);
  } else {
    mul_sum_kernel<false><<<grid, THREADS, 0, st>>>(v, row_stride, index, w, k, per_block, (unsigned)m, tj, out,
                                                    partials, ticket);
  }
  return (int)cudaGetLastError();
}
