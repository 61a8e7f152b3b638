// Kernel K: one pass of a GKR layer's sumcheck (the LogUp fractional
// sumcheck, swirl_torch/prover/gkr.py), and the layer's eq table.
//
// K  gkr_round   replaces no Pallas kernel: the JAX package runs a
//                sub-round as XLA ops (swirl/prover/gkr.py:58
//                _gkr_round_evals, :82 _gkr_fold), and the port ran them
//                as about 1,400 aten operations a sub-round.
//    gkr_eq      the layer's eq(xi, y) table over H_n (the doubling table
//                of swirl_torch/prover/sumcheck.py eq_hypercube), one
//                launch a layer.
//
// A layer's sumcheck holds five EF4 MLEs [eq, p0, q0, p1, q1] of m entries.
// Sub-round j evaluates its round polynomial at X = 1, 2, 3,
//   s(X) = sum_i eq_X (p0_X q1_X + p1_X q0_X + lambda q0_X q1_X),
//   c_X = c[2i] + X (c[2i+1] - c[2i]),
// and then folds each column at the challenge r_j sampled from s:
// c'[i] = c[2i] + r_j (c[2i+1] - c[2i]). Since r_j comes after s_j, one pass
// folds at r_j and evaluates sub-round j + 1: a thread reads four entries
// 4k .. 4k + 3 of each column, folds them into the pair (2k, 2k + 1),
// writes the pair and evaluates it from its registers. A layer's first
// pass (EVAL) only evaluates, reading p0, q0, p1, q1 where they lie in the
// layer's (2m, 4) p and q (the stride-2 pairs); its last (FOLD) only folds
// the pair that is left into the four claims. r and lambda are read from
// device memory, so a captured pass replays with the sponge's new values.
//
// What bounds it on the H100: at large m the bytes (a pair reads 20 EF4
// values and writes 10: 240 B a source entry, against about 25 EF4
// products, 450 Montgomery products, a pair), with the multiply pipe close
// behind; at small m (most of the 276 passes of the app cell's 2^24
// fractions have m under 2^16) one launch's latency and one thread's chain
// of products.
// Design: one pass a sub-round, no intermediate in device memory, one
// launch; the grid comes from m alone: up to GKR_THREADS pairs one block,
// above it enough blocks to fill the SMs at GKR_MIN_BLOCKS an SM, each
// thread taking several pairs. Each block sums its threads' values (warp
// shuffles, then shared memory) and writes its partial sums; the block
// that draws the last ticket sums the partials into the (3, 4) output and
// resets the ticket (the counter the wrapper keeps per stream, or the
// capture's own, as kernels D and F do). A launch makes no host read.
//
// Arithmetic: tensors hold canonical int64; a value is a 32-bit word here.
// A challenge (r, lambda, the eq table's factors) is turned into Montgomery
// form once a block (b R, and 11 b R for the x^4 = 11 terms), so a product
// by it is exact: the folds and the eq table are canonical as written. A
// product of two data values is a Montgomery product without conversion
// (a b / R), so each value of s carries a factor R^-2 until the last block
// multiplies the three sums by R^3 (one Montgomery product each). Every
// value written out is the canonical one, bit-equal to the plain path's.
#include "field.cuh"

namespace {

constexpr int GKR_THREADS = 256;
constexpr int GKR_MIN_BLOCKS = 2;  // blocks an SM: at most 128 registers a thread
constexpr int GKR_EQ_MAX = 30;     // variables of an eq table
constexpr int COLS = 5;            // eq, p0, q0, p1, q1
constexpr int EVALS = 12;          // s(1), s(2), s(3), four coefficients each

constexpr uint64_t R_MOD = (1ull << 32) % bb::P;
constexpr uint32_t W11 = (uint32_t)(11 * R_MOD % bb::P);              // a Montgomery product by it: times 11
constexpr uint32_t R3 = (uint32_t)(R_MOD * R_MOD % bb::P * R_MOD % bb::P);  // by it: times R^2

enum Mode { EVAL = 0, FOLD_EVAL = 1, FOLD = 2 };

struct Ef {
  uint32_t v[4];
};

// A factor b in the form its products take: m = b R, w = 11 b R (w[0] unused).
struct Factor {
  uint32_t m[4];
  uint32_t w[4];
};

// Column c's entry i at col[c] + 4 * i * (c ? stride : 1).
struct Source {
  const int64_t* col[COLS];
  long long stride;
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

// t0 + r (t1 - t0)
__device__ __forceinline__ Ef fold(const Ef& t0, const Ef& t1, const Factor& r) {
  return eadd(t0, fmul(esub(t1, t0), r));
}

// s(1), s(2), s(3) of the pair (t0, t1) of the five columns, at R^-2, added to acc
__device__ __forceinline__ void evaluate(const Ef (&t0)[COLS], const Ef (&t1)[COLS], const Factor& lam,
                                         uint32_t (&acc)[EVALS]) {
  Ef d[COLS], v[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    d[c] = esub(t1[c], t0[c]);
    v[c] = t1[c];
  }
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    if (x) {
#pragma unroll
      for (int c = 0; c < COLS; ++c) v[c] = eadd(v[c], d[c]);
    }
    // v: eq, p0, q0, p1, q1 at X = x + 1
    const Ef pq = eadd(rmul(v[1], v[4]), rmul(v[3], v[2]));
    const Ef val = rmul(v[0], eadd(pq, fmul(rmul(v[2], v[4]), lam)));
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[4 * x + j] = add(acc[4 * x + j], val.v[j]);
  }
}

// The block's sums of acc, in thread 0 (whole warps).
__device__ __forceinline__ void block_sum(uint32_t (&acc)[EVALS], uint32_t (*red)[EVALS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
#pragma unroll
  for (int off = 16; off; off >>= 1) {
#pragma unroll
    for (int j = 0; j < EVALS; ++j) acc[j] = add(acc[j], __shfl_down_sync(~0u, acc[j], off));
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < EVALS; ++j) red[warp][j] = acc[j];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < EVALS; ++j) acc[j] = lane < warps ? red[lane][j] : 0u;
#pragma unroll
    for (int off = 16; off; off >>= 1) {
#pragma unroll
      for (int j = 0; j < EVALS; ++j) acc[j] = add(acc[j], __shfl_down_sync(~0u, acc[j], off));
    }
  }
}

// The sums at R^-2 times R^2: canonical s(1), s(2), s(3).
__device__ __forceinline__ void write_evals(int64_t* evals, const uint32_t (&acc)[EVALS]) {
#pragma unroll
  for (int j = 0; j < EVALS; ++j) evals[j] = mul(acc[j], R3);
}

// EVAL: pairs = n / 2, evaluates the pairs (2k, 2k + 1) of the source.
// FOLD_EVAL: pairs = n / 4, folds the source's entries 4k .. 4k + 3 at r
// into entries 2k, 2k + 1 of the (5, m_out, 4) out, and evaluates them.
// FOLD: n = 2, threads 0-3 fold p0, q0, p1, q1 at r into the (4, 4) out.
// evals: (3, 4); partials: 12 words a block; tickets: zero, left zero.
template <int MODE>
__global__ void __launch_bounds__(GKR_THREADS, GKR_MIN_BLOCKS)
    gkr_round_kernel(Source src, long long pairs, long long m_out, const int64_t* r, const int64_t* lam,
                     int64_t* out, int64_t* evals, uint32_t* partials, unsigned* tickets) {
  __shared__ Factor s_f[2];  // r, lambda
  __shared__ uint32_t s_red[GKR_THREADS / 32][EVALS];
  __shared__ bool last;
  if (threadIdx.x < 2) {
    const int64_t* x = threadIdx.x ? lam : r;
    if (x) s_f[threadIdx.x] = factor(Ef{{(uint32_t)x[0], (uint32_t)x[1], (uint32_t)x[2], (uint32_t)x[3]}});
  }
  __syncthreads();
  if (MODE == FOLD) {
    if (threadIdx.x < 4) {
      const int64_t* c = src.col[threadIdx.x + 1];
      store(out + 4 * threadIdx.x, fold(load(c), load(c + 4 * src.stride), s_f[0]));
    }
    return;
  }
  uint32_t acc[EVALS] = {};
  for (long long k = blockIdx.x * (long long)GKR_THREADS + threadIdx.x; k < pairs;
       k += (long long)gridDim.x * GKR_THREADS) {
    Ef t0[COLS], t1[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const long long s = 4 * (c ? src.stride : 1);
      const int64_t* base = src.col[c];
      if (MODE == EVAL) {
        t0[c] = load(base + s * (2 * k));
        t1[c] = load(base + s * (2 * k + 1));
      } else {
        const int64_t* e = base + s * (4 * k);
        t0[c] = fold(load(e), load(e + s), s_f[0]);
        t1[c] = fold(load(e + 2 * s), load(e + 3 * s), s_f[0]);
        int64_t* o = out + 4 * (c * m_out + 2 * k);
        store(o, t0[c]);
        store(o + 4, t1[c]);
      }
    }
    evaluate(t0, t1, s_f[1], acc);
  }
  block_sum(acc, s_red);
  if (gridDim.x == 1) {
    if (threadIdx.x == 0) write_evals(evals, acc);
    return;
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < EVALS; ++j) partials[blockIdx.x * EVALS + j] = acc[j];
    __threadfence();  // the partials, visible before the ticket
    last = atomicAdd(tickets, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int j = 0; j < EVALS; ++j) acc[j] = 0u;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += blockDim.x) {
#pragma unroll
    for (int j = 0; j < EVALS; ++j) acc[j] = add(acc[j], __ldcg(partials + b * EVALS + j));
  }
  block_sum(acc, s_red);
  if (threadIdx.x == 0) {
    write_evals(evals, acc);
    *tickets = 0;
  }
}

// out: (2^n, 4), entry y = prod_i (bit i of y ? xi_i : 1 - xi_i). Thread g
// writes the 2^low entries g 2^low + b (low = min(n, 2)): the product over
// the bits above, then the low bits by doubling.
__global__ void __launch_bounds__(GKR_THREADS) gkr_eq_kernel(const int64_t* xi, int n, long long groups,
                                                             int64_t* out) {
  __shared__ Factor s_w[2][GKR_EQ_MAX];  // 1 - xi_i, xi_i
  if (threadIdx.x < 2 * n) {
    const int i = threadIdx.x >> 1, b = threadIdx.x & 1;
    Ef x = load(xi + 4 * i);
    if (!b) x = esub(Ef{{1u, 0u, 0u, 0u}}, x);
    s_w[b][i] = factor(x);
  }
  __syncthreads();
  const int low = n < 2 ? n : 2;
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x; g < groups;
       g += (long long)gridDim.x * blockDim.x) {
    Ef hi = {{1u, 0u, 0u, 0u}};
    for (int i = low; i < n; ++i) hi = fmul(hi, s_w[(g >> (i - low)) & 1][i]);
    int64_t* o = out + 4 * (g << low);
    if (low == 2) {
#pragma unroll
      for (int b1 = 0; b1 < 2; ++b1) {
        const Ef v = fmul(hi, s_w[b1][1]);
        store(o + 8 * b1, fmul(v, s_w[0][0]));
        store(o + 8 * b1 + 4, fmul(v, s_w[1][0]));
      }
    } else {
      store(o, fmul(hi, s_w[0][0]));
      store(o + 4, fmul(hi, s_w[1][0]));
    }
  }
}

}  // namespace

// xi: (n, 4), 1 <= n <= GKR_EQ_MAX; out: (2^n, 4); blocks from the wrapper.
extern "C" int swirl_gkr_eq(const int64_t* xi, int n, int64_t* out, int blocks, void* stream) {
  if (n < 1 || n > GKR_EQ_MAX || blocks < 1) return (int)cudaErrorInvalidValue;
  const long long groups = 1LL << (n - (n < 2 ? n : 2));
  gkr_eq_kernel<<<blocks, GKR_THREADS, 0, (cudaStream_t)stream>>>(xi, n, groups, out);
  return (int)cudaGetLastError();
}

// The five columns' first entries; entry i of p0, q0, p1, q1 at 4 i stride
// words, of eq at 4 i; n entries each. r null: a layer's first pass
// (EVAL); lam null: its last (FOLD, n = 2, out (4, 4)); else FOLD_EVAL
// (out (5, n / 2, 4)). evals: (3, 4); partials: 12 words a block; tickets:
// a zero counter. blocks: from the wrapper's plan (1 for FOLD).
extern "C" int swirl_gkr_round(const int64_t* eq, const int64_t* p0, const int64_t* q0, const int64_t* p1,
                               const int64_t* q1, long long stride, long long n, const int64_t* r,
                               const int64_t* lam, int64_t* out, int64_t* evals, uint32_t* partials,
                               unsigned* tickets, int blocks, void* stream) {
  const Source src = {{eq, p0, q0, p1, q1}, stride};
  const cudaStream_t s = (cudaStream_t)stream;
  if (blocks < 1 || stride < 1 || n < 2 || (n & (n - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (!r) {
    if (!lam) return (int)cudaErrorInvalidValue;
    gkr_round_kernel<EVAL><<<blocks, GKR_THREADS, 0, s>>>(src, n / 2, 0, r, lam, out, evals, partials, tickets);
  } else if (!lam) {
    if (n != 2) return (int)cudaErrorInvalidValue;
    gkr_round_kernel<FOLD><<<1, 32, 0, s>>>(src, 1, 1, r, lam, out, evals, partials, tickets);
  } else {
    if (n < 4) return (int)cudaErrorInvalidValue;
    gkr_round_kernel<FOLD_EVAL><<<blocks, GKR_THREADS, 0, s>>>(src, n / 4, n / 2, r, lam, out, evals, partials,
                                                               tickets);
  }
  return (int)cudaGetLastError();
}
