"""What the card issues for the port's Poseidon2 and BN254 kernels: a
census of their SASS by instruction class, and the throughput of each integer instruction
class on the card. Run on a machine with the card and the CUDA toolkit:

    python -m swirl_torch.tools.isa

The census builds the port's kernel library (``swirl_torch/csrc``) as the
wrappers do and lists, for each Poseidon2 kernel (B, C, D) and BN254
kernel (G-J), the static count of each
instruction class outside loops and inside each loop (a loop is the range
of a backward branch). A kernel whose rounds are all unrolled has no loop:
its count outside loops is one pass, loads, conversions to and from
Montgomery form and stores included. A loop's count is that of one trip.

The pipe bench times one PTX operation (or one field operation of
``csrc/field.cuh`` or ``csrc/poseidon2.cu``) in 8 independent chains a
thread over enough blocks to fill every SM, reads the SM clock with
``clock64`` against ``%globaltimer``, and prints lane operations a clock
per SM next to the SASS classes the bench's loop compiled to, so a rate is
read against what was issued.

The latency bench times one field operation of ``csrc/field.cuh`` (and a
quad's shuffle) in one dependent chain a lane on one warp, in SM clocks.
The longest dependent chain of kernel D's quad permutation
(:data:`QUAD_PERM_CHAIN`) and of kernel E's row permutation
(:data:`ROW_PERM_CHAIN`) at those latencies is the least time one
permutation can take: the floor of a launch that runs a chain of
dependent permutations.
"""

from __future__ import annotations

import collections
import ctypes
import os
import re
import shutil
import subprocess
import sys

from .. import kernels as K

WIDE = ("IMAD.WIDE", "IMAD.HI")  # the high half of a 32 x 32 product: a third of IMAD's rate
FMA_PIPE = ("IMAD",)
FP64_PIPE = ("DFMA", "DADD", "DMUL", "DSETP", "DMNMX")
ALU_PIPE = ("IADD3", "ISETP", "SEL", "VIMNMX", "IMNMX", "LOP3", "SHF", "LEA", "MOV", "PRMT", "PLOP3", "IABS")
CLASSES = ("IMAD.WIDE", "IMAD.HI", "IMAD.MOV", "IMAD.IADD", "IMAD.SHL", "IMAD")
# the kernels the census lists, by source file (the tag in a mangled name)
KERNEL_NAMES = {
    "poseidon2_cu": ("hash_cols_kernel", "compress_kernel", "tower_kernel", "duplex_kernel", "grind_kernel"),
    "bn254_cu": ("op_kernel", "permute_kernel", "compress_kernel", "hash_rows_kernel", "grind_kernel"),
}

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_FUNC = re.compile(r"Function : (\S+)")
_TARGET = re.compile(r"0x([0-9a-f]+)")


def _tool(name: str) -> str:
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not os.path.exists(path):
        raise SystemExit(f"{name} not found: the CUDA toolkit is required")
    return path


def sass_functions(lib: str) -> dict:
    """{mangled name: [(address, opcode, operands)]} from cuobjdump -sass."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(3), m.group(4)))
    return funcs


def klass(opcode: str) -> str:
    for c in CLASSES:
        if opcode == c or opcode.startswith(c + "."):
            return c
    return opcode.split(".")[0]


def pipe(c: str) -> str:
    if c in WIDE:
        return "wide"
    if c.startswith(FMA_PIPE):
        return "fma"
    if c in ALU_PIPE:
        return "alu"
    if c in FP64_PIPE:
        return "fp64"
    return "other"


PIPES = ("wide", "fma", "alu", "fp64", "other")


def census(insns) -> tuple:
    """(class counts outside loops, [((start, end), class counts of one
    trip)] for each range closed by a backward branch)."""
    ranges = []
    for addr, op, args in insns:
        m = _TARGET.search(args)
        # a branch to itself closes the function (the trap after EXIT), no loop
        if op.split(".")[0] == "BRA" and m and int(m.group(1), 16) < addr:
            ranges.append((int(m.group(1), 16), addr))
    outside = collections.Counter()
    inside = [collections.Counter() for _ in ranges]
    for addr, op, _ in insns:
        hits = [i for i, (a, b) in enumerate(ranges) if a <= addr <= b]
        for i in hits:
            inside[i][klass(op)] += 1
        if not hits:
            outside[klass(op)] += 1
    return outside, list(zip(ranges, inside))


def _by_pipe(counter) -> str:
    tot = collections.Counter()
    for c, n in counter.items():
        tot[pipe(c)] += n
    return " ".join(f"{p} {tot[p]}" for p in PIPES) + f" total {sum(counter.values())}"


def _fmt(counter, top: int = 0) -> str:
    items = sorted(counter.items(), key=lambda kv: -kv[1])
    return " ".join(f"{c}={n}" for c, n in (items[:top] if top else items))


def kernel_label(name: str):
    """``poseidon2.compress_kernel``, ``bn254.permute_kernel<3>`` ... for a
    mangled kernel name the census lists, else None."""
    for src, names in KERNEL_NAMES.items():
        if src not in name:
            continue
        short = next((k for k in names if k in name), None)
        if short is None:
            return None
        tmpl = re.search(r"ILi(\d+)E", name)
        return f"{src[:-3]}.{short}" + (f"<{tmpl.group(1)}>" if tmpl else "")
    return None


def pipe_counts(counter) -> tuple:
    """(wide, FMA-pipe, ALU-pipe, FP64-pipe) instructions of a class counter:
    ``wide`` is IMAD.WIDE and IMAD.HI, ``fma`` the FMA pipe's other
    instructions."""
    return tuple(sum(n for c, n in counter.items() if pipe(c) == p) for p in PIPES[:4])


def report_census(only: str = "") -> dict:
    """Prints each listed kernel's census (those whose label starts with
    ``only``); returns them."""
    lib = K.LIB.build()
    for line in K.ptxas_summary(K.LIB.build_log):
        print(f"ptxas {line}")
    found = {}
    for name, insns in sass_functions(lib).items():
        label = kernel_label(name)
        if label is not None and label.startswith(only):
            found[label] = census(insns)
    found = dict(sorted(found.items()))
    for label, (outside, loops) in found.items():
        print(f"sass {label}: outside loops {_by_pipe(outside)}: {_fmt(outside)}")
        for (a, b), body in loops:
            print(f"sass {label}: loop {a:#x}-{b:#x}, one trip {_by_pipe(body)}: {_fmt(body)}")
    return found


# the published rates of an H100 SM, lane operations a clock: 64 on each of
# the FP64, ALU and FMA pipes (the CUDA C++ Programming Guide's throughput
# table, compute capability 9.0), 128 issued (4 schedulers of a warp each)
PIPE_RATES = {"fp64": 64, "alu": 64, "fma": 64}
ISSUE_RATE = 128
# the rounds of csrc/bn254.cuh's permute<t>: (full rounds a loop, partial rounds)
BN254_ROUNDS = {3: (4, 56), 2: (3, 50)}


def bn254_perm_floor(found: dict) -> dict:
    """{t: (SM-clocks, pipe)}: the least SM-clocks one lane's width-t
    permutation of csrc/bn254.cuh can take on an H100 by its own SASS
    census (``report_census("bn254")``'s ``bn254.permute_kernel<t>``): its two
    full-round loops' trips times the full rounds of each, its partial-round
    loop (the smallest of the three) times the partial rounds, each pipe's
    count at :data:`PIPE_RATES` (IMAD.WIDE on the FMA pipe) and all of them
    at :data:`ISSUE_RATE`; the largest of those, and what sets it. Raises
    ValueError when a width's kernel is missing or has not three loops."""
    out = {}
    for t, (half, partial) in BN254_ROUNDS.items():
        label = f"bn254.permute_kernel<{t}>"
        if label not in found:
            raise ValueError(f"census floor: not read ({label} not in the census)")
        loops = sorted((body for _, body in found[label][1]), key=lambda b: sum(b.values()))
        if len(loops) != 3:
            raise ValueError(f"census floor: not read ({len(loops)} loops in {label}, not 3)")
        total = collections.Counter()
        for body, n in zip(loops, (partial, half, half)):
            for c, k in body.items():
                total[c] += k * n
        wide, fma, alu, fp64 = pipe_counts(total)
        clocks = {"fp64": fp64 / PIPE_RATES["fp64"], "alu": alu / PIPE_RATES["alu"],
                  "fma": (wide + fma) / PIPE_RATES["fma"], "issue": sum(total.values()) / ISSUE_RATE}
        pipe_name = max(clocks, key=clocks.get)
        out[t] = (clocks[pipe_name], pipe_name)
    return out


# ---------------------------------------------------------------------------
# pipe bench
# ---------------------------------------------------------------------------

# (name, lane operations a chain's step counts): PTX operations, then field
# operations of csrc/field.cuh, csrc/poseidon2.cu and csrc/bn254.cuh (a
# BN254 product counts one)
OPS = (
    ("mul.lo.u32", 1), ("mul.hi.u32", 1), ("mul.wide.u32", 1), ("add.u32", 1), ("min.u32", 1),
    ("xor.b32", 1), ("shf.l.wrap.b32", 1), ("field.cuh mont_mul", 1), ("field.cuh add", 1),
    ("poseidon2.cu mont", 1), ("poseidon2.cu add", 1), ("fma.rz.f64", 1), ("add.rz.f64", 1),
    ("mad.lo.cc.u32 + madc.hi.u32", 2), ("bn254.cuh product", 1), ("bn254.cuh square", 1),
)
CHAINS = 8

BENCH_CU = r"""
#include <cstdint>
#include "poseidon2_copy.cuh"  // csrc/poseidon2.cu, for its device functions
#include "bn254.cuh"

template <int OP>
__global__ void bench_kernel(uint32_t* out, long long* clocks, int iters, uint32_t seed) {
  uint32_t a[%(chains)d];
  uint64_t w[%(chains)d];
  double d[%(chains)d];
  const uint32_t tid = blockIdx.x * blockDim.x + threadIdx.x;
#pragma unroll
  for (int c = 0; c < %(chains)d; ++c) {
    a[c] = (seed * (tid + 7 * c + 1)) %% bb::P; w[c] = a[c]; d[c] = (double)a[c];
  }
  const uint32_t y = (seed ^ tid) %% bb::P | 1u;
  const double yd = 0.5 + 1e-9 * (double)(tid & 1023), zd = 1.0 + (double)y;
  long long t0 = clock64(), g0;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(g0));
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < %(chains)d; ++c) {
      const uint32_t b = a[(c + 1) %% %(chains)d];
      if (OP == 0) asm volatile("mad.lo.u32 %%0, %%0, %%1, %%2;" : "+r"(a[c]) : "r"(y), "r"(b));
      if (OP == 1) asm volatile("mad.hi.u32 %%0, %%0, %%1, %%2;" : "+r"(a[c]) : "r"(y), "r"(b));
      if (OP == 2) asm volatile("{.reg .u32 t; cvt.u32.u64 t, %%0; mad.wide.u32 %%0, t, %%1, %%0;}" : "+l"(w[c]) : "r"(y));
      if (OP == 3) asm volatile("add.u32 %%0, %%0, %%1;" : "+r"(a[c]) : "r"(b));
      if (OP == 4) asm volatile("min.u32 %%0, %%0, %%1;" : "+r"(a[c]) : "r"(b));
      if (OP == 5) asm volatile("xor.b32 %%0, %%0, %%1;" : "+r"(a[c]) : "r"(b));
      if (OP == 6) asm volatile("shf.l.wrap.b32 %%0, %%0, %%1, 5;" : "+r"(a[c]) : "r"(b));
      if (OP == 7) a[c] = bb::mont_mul(a[c], y %% bb::P);
      if (OP == 8) a[c] = bb::add(a[c], b);
      if (OP == 9) a[c] = mont(a[c], y %% bb::P);
      if (OP == 10) a[c] = add(a[c], b);
      if (OP == 11) asm volatile("fma.rz.f64 %%0, %%0, %%1, %%2;" : "+d"(d[c]) : "d"(yd), "d"(zd));
      if (OP == 12) asm volatile("add.rz.f64 %%0, %%0, %%1;" : "+d"(d[c]) : "d"(yd));
      if (OP == 13) {
        uint32_t lo = (uint32_t)w[c], hi = (uint32_t)(w[c] >> 32);
        asm volatile("mad.lo.cc.u32 %%0, %%0, %%2, %%3; madc.hi.u32 %%1, %%0, %%2, %%1;"
                     : "+r"(lo), "+r"(hi) : "r"(y), "r"(b));
        w[c] = ((uint64_t)hi << 32) | lo;
      }
    }
  }
  long long g1;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(g1));
  const long long t1 = clock64();
  uint32_t acc = 0;
#pragma unroll
  for (int c = 0; c < %(chains)d; ++c)
    acc ^= a[c] ^ (uint32_t)w[c] ^ (uint32_t)(w[c] >> 32) ^ (uint32_t)__double2loint(d[c]);
  out[tid] = acc;
  if (threadIdx.x == 0) { clocks[2 * blockIdx.x] = t1 - t0; clocks[2 * blockIdx.x + 1] = g1 - g0; }
}

// the BN254 product (OP 14) and square (OP 15) of csrc/bn254.cuh, one
// chain a lane op, 4 chains a thread
%(bn254_bench)s

#define CASE(k) case k: bench_kernel<k><<<blocks, threads, 0, (cudaStream_t)stream>>>(out, clocks, iters, 12345u); break;
#define BN_CASE(k) case k: bn_bench_kernel<k><<<blocks, threads, 0, (cudaStream_t)stream>>>(out, clocks, iters, 12345u); break;
extern "C" int isa_bench(int op, int blocks, int threads, int iters, uint32_t* out, long long* clocks, void* stream) {
  switch (op) {
    CASE(0) CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(9) CASE(10) CASE(11) CASE(12)
    CASE(13) BN_CASE(14) BN_CASE(15)
    default: return -1;
  }
  return (int)cudaGetLastError();
}
"""
BN_CHAINS = 4
# the BN254 bench kernel: the product (OP 14) and the square (OP 15) of the
# core in csrc/bn254.cuh, on BN_CHAINS independent chains a thread
BN254_BENCH = r"""
template <int OP>
__global__ void bn_bench_kernel(uint32_t* out, long long* clocks, int iters, uint32_t seed) {
  using namespace bn254;
  const uint32_t tid = blockIdx.x * blockDim.x + threadIdx.x;
  F5 x[%(bn_chains)d];
  Fe y;
#pragma unroll
  for (int i = 0; i < L; ++i) y.w[i] = (seed ^ tid) * (2 * i + 1) & (i == L - 1 ? 0x0fffffffu : ~0u);
  const D5 yd = to_d5(limbs(y));
#pragma unroll
  for (int c = 0; c < %(bn_chains)d; ++c) {
    Fe v;
#pragma unroll
    for (int i = 0; i < L; ++i) v.w[i] = seed * (tid + 7 * c + i + 1) & (i == L - 1 ? 0x0fffffffu : ~0u);
    x[c] = limbs(v);
  }
  long long t0 = clock64(), g0;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(g0));
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < %(bn_chains)d; ++c) x[c] = OP == 14 ? mul(to_d5(x[c]), yd) : sqr(to_d5(x[c]));
  }
  long long g1;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(g1));
  const long long t1 = clock64();
  uint32_t acc = 0;
#pragma unroll
  for (int c = 0; c < %(bn_chains)d; ++c)
#pragma unroll
    for (int i = 0; i < NL; ++i) acc ^= (uint32_t)x[c].l[i];
  out[tid] = acc;
  if (threadIdx.x == 0) { clocks[2 * blockIdx.x] = t1 - t0; clocks[2 * blockIdx.x + 1] = g1 - g0; }
}
"""


def _build_bench(name: str, source: str) -> str:
    """Builds ``source`` beside copies of csrc/field.cuh, csrc/bn254.cuh and csrc/poseidon2.cu
    into ``build/<name>/bench.so``; returns its path."""
    src_dir = os.path.join(K.BUILD_DIR, name)
    os.makedirs(src_dir, exist_ok=True)
    with open(os.path.join(src_dir, "bench.cu"), "w") as f:
        f.write(source)
    shutil.copy(os.path.join(K.CSRC, "field.cuh"), src_dir)
    shutil.copy(os.path.join(K.CSRC, "bn254.cuh"), src_dir)
    shutil.copy(os.path.join(K.CSRC, "poseidon2.cu"), os.path.join(src_dir, "poseidon2_copy.cuh"))
    out = os.path.join(src_dir, "bench.so")
    cmd = [_tool("nvcc"), *K.NVCC_FLAGS, "-I", src_dir, "-o", out, os.path.join(src_dir, "bench.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise SystemExit(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    return out


def pipe_bench(iters: int = 2048) -> None:
    import torch

    bn = BN254_BENCH % {"bn_chains": BN_CHAINS}
    lib_path = _build_bench("isa_bench", BENCH_CU % {"chains": CHAINS, "bn254_bench": bn})
    lib = ctypes.CDLL(lib_path)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.isa_bench.argtypes = [i32, i32, i32, i32, vp, vp, vp]
    lib.isa_bench.restype = i32
    funcs = {int(m.group(1)): insns for name, insns in sass_functions(lib_path).items()
             if (m := re.search(r"bench_kernelILi(\d+)E", name))}
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    threads, blocks = 256, sms * 32
    out = torch.empty(blocks * threads, dtype=torch.int32, device=dev)
    clocks = torch.empty(2 * blocks, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for op, (name, per_step) in enumerate(OPS):
        def run():
            rc = lib.isa_bench(op, blocks, threads, iters, out.data_ptr(), clocks.data_ptr(), stream)
            if rc != 0:
                raise SystemExit(f"isa_bench {name}: CUDA error {rc}")
        run()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        c = clocks.view(-1, 2).double()
        ghz = float((c[:, 0] / c[:, 1]).median())
        chains = BN_CHAINS if name.startswith("bn254") else CHAINS
        lane_ops = blocks * threads * iters * chains * per_step
        rate = lane_ops / (ms * 1e-3 * ghz * 1e9 * sms)
        body = max(census(funcs[op])[1], key=lambda lp: sum(lp[1].values()), default=None)
        classes = _fmt(body[1], 6) if body else "no loop"
        print(f"pipe {name}: {rate:.2f} lane ops a clock per SM at {ghz:.3f} GHz "
              f"({ms:.3f} ms; loop of {iters} x {chains} chains: {classes})")


# ---------------------------------------------------------------------------
# latency bench: the floor of a chain of quad permutations
# ---------------------------------------------------------------------------

# The longest dependent chain of ``permute_quad`` (csrc/poseidon2.cu), in
# field operations, from its source. M_E (``quad_external``): m4's 4
# dependent adds, then shuffle, add, shuffle, add, add: 7 adds, 2 shuffles.
# A full round: the constant's add, the S-box's 3 dependent products (x^2,
# x^4, x^3 * x^4), M_E: 8 adds, 3 products, 2 shuffles. A partial round,
# through word 0: the constant's add, the S-box's 3 products, the shuffle
# that broadcasts it, its add into the sum and the add onto the diagonal's
# product (taken beside the shuffle): 3 adds, 3 products, 1 shuffle. The
# permutation: M_E, 8 full rounds, 13 partial rounds.
QUAD_PERM_CHAIN = {"add": 7 + 8 * 8 + 13 * 3, "mont": 8 * 3 + 13 * 3, "shfl": 2 + 8 * 2 + 13}
# The same for kernel E's ``permute_row`` (a word a lane). M_E
# (``row_external``): a shuffle (l ^ 4, 8, 12), 2 adds to z, a shuffle (the
# M4 row's lanes), 3 adds (the next constant in the tree): 5 adds, 2
# shuffles. A full round: the S-box's 3 products, then M_E. Into the partial
# rounds: the sum of words 1..15 by 4 shuffles and 4 adds (longer than word
# 0's broadcast, its constant and S-box), its next constant and the
# subtract of y: 4 shuffles, 6 adds, 3 products to the second S-box; each
# later partial round the subtract and the S-box (the lane sum of d_i x_i
# runs beside it): 1 add, 3 products, 11 times; out of them full, the
# diagonal's add and the final constant: 3 adds. The permutation: M_E, 4
# full rounds, the partial rounds, 4 full rounds.
ROW_PERM_CHAIN = {"add": 5 + 4 * 5 + 6 + 11 + 3 + 4 * 5, "mont": 4 * 3 + 3 + 11 * 3 + 4 * 3,
                  "shfl": 2 + 4 * 2 + 4 + 4 * 2}
LATENCY_OPS = ("add", "mont", "shfl", "bn254")
LATENCY_STEPS = 16  # dependent operations a loop trip
LATENCY_ITERS = 4096  # loop trips: 65,536 dependent operations, 0.7-2 M clocks

LATENCY_CU = r"""
#include <cstdint>
#include "field.cuh"
#include "bn254.cuh"

// one warp, one dependent chain a lane: OP 0 bb::fast::add, 1 bb::fast::mont,
// 2 a quad's __shfl_xor_sync, the operations of permute_quad; 3 the BN254
// product of bn254.cuh
template <int OP>
__global__ void latency_kernel(uint32_t* out, long long* clocks, int iters, uint32_t seed) {
  uint32_t a = (seed * (threadIdx.x + 1)) % bb::P;
  const uint32_t y = (seed ^ threadIdx.x) % bb::P | 1u;
  bn254::Fe xw, zw;
#pragma unroll
  for (int i = 0; i < bn254::L; ++i) {
    xw.w[i] = seed * (threadIdx.x + i + 1) & (i == bn254::L - 1 ? 0x0fffffffu : ~0u);
    zw.w[i] = (seed ^ threadIdx.x) * (2 * i + 1) & (i == bn254::L - 1 ? 0x0fffffffu : ~0u);
  }
  bn254::F5 x = bn254::limbs(xw);
  const bn254::D5 z = bn254::to_d5(bn254::limbs(zw));
  long long g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (OP == 0) a = bb::fast::add(a, y);
      if (OP == 1) a = bb::fast::mont(a, y);
      if (OP == 2) a = __shfl_xor_sync(0xffffffffu, a, 1 + (j & 1), 4);
      if (OP == 3) x = bn254::mul(bn254::to_d5(x), z);
    }
  }
  const long long t1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
#pragma unroll
  for (int i = 0; i < bn254::NL; ++i) a ^= (uint32_t)x.l[i];
  out[threadIdx.x] = a;
  if (threadIdx.x == 0) { clocks[0] = t1 - t0; clocks[1] = g1 - g0; }
}

#define CASE(k) case k: latency_kernel<k><<<1, 32, 0, (cudaStream_t)stream>>>(out, clocks, iters, 12345u); break;
extern "C" int isa_latency(int op, int iters, uint32_t* out, long long* clocks, void* stream) {
  switch (op) { CASE(0) CASE(1) CASE(2) CASE(3) default: return -1; }
  return (int)cudaGetLastError();
}
"""


def latency_bench() -> tuple:
    """({op: SM clocks of one dependent op}, the SM clock in GHz while the
    chains ran), each op timed on one warp after a warm-up run."""
    import torch

    lib = ctypes.CDLL(_build_bench("isa_latency", LATENCY_CU))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.isa_latency.argtypes = [i32, i32, vp, vp, vp]
    lib.isa_latency.restype = i32
    dev = torch.device("cuda", 0)
    out = torch.empty(32, dtype=torch.int32, device=dev)
    clocks = torch.empty(2, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cycles, ghz = {}, []
    for op, name in enumerate(LATENCY_OPS):
        for _ in range(2):
            rc = lib.isa_latency(op, LATENCY_ITERS, out.data_ptr(), clocks.data_ptr(), stream)
            if rc != 0:
                raise SystemExit(f"isa_latency {name}: CUDA error {rc}")
        clk, ns = (int(v) for v in clocks.cpu())
        cycles[name] = clk / (LATENCY_ITERS * LATENCY_STEPS)
        ghz.append(clk / ns)
    return cycles, sorted(ghz)[len(ghz) // 2]


def perm_clocks(chain: dict, cycles: dict) -> float:
    """SM clocks of a permutation's chain (:data:`QUAD_PERM_CHAIN`,
    :data:`ROW_PERM_CHAIN`) at the latencies ``cycles``."""
    return sum(n * cycles[op] for op, n in chain.items())


def main() -> int:
    report_census()
    pipe_bench()
    cycles, ghz = latency_bench()
    lat = " ".join(f"{op} {c:.2f}" for op, c in cycles.items())
    print(f"latency (SM clocks a dependent operation, at {ghz:.3f} GHz): {lat}")
    for name, chain in (("quad (kernel D)", QUAD_PERM_CHAIN), ("row (kernel E)", ROW_PERM_CHAIN)):
        clocks = perm_clocks(chain, cycles)
        print(f"latency: one {name} permutation's chain {chain}: {clocks:.0f} clocks, {clocks / ghz / 1e3:.3f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
