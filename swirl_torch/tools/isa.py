"""What the card issues for the port's Poseidon2 kernels: a census of their
SASS by instruction class, and the throughput of each integer instruction
class on the card. Run on a machine with the card and the CUDA toolkit:

    python -m swirl_torch.tools.isa

The census builds the port's kernel library (``swirl_torch/csrc``) as the
wrappers do and lists, for each Poseidon2 kernel, the static count of each
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
The longest dependent chain of kernel D's and E's quad permutation
(:data:`QUAD_PERM_CHAIN`) at those latencies is the least time one
permutation can take on one quad: the floor of a launch that runs a chain
of dependent permutations.
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

FMA_PIPE = ("IMAD",)
ALU_PIPE = ("IADD3", "ISETP", "SEL", "VIMNMX", "IMNMX", "LOP3", "SHF", "LEA", "MOV", "PRMT", "PLOP3", "IABS")
CLASSES = ("IMAD.WIDE", "IMAD.HI", "IMAD.MOV", "IMAD.IADD", "IMAD.SHL", "IMAD")
KERNEL_NAMES = ("hash_cols_kernel", "compress_kernel", "tower_kernel")

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
    if c.startswith(FMA_PIPE):
        return "fma"
    if c in ALU_PIPE:
        return "alu"
    return "other"


def census(insns) -> tuple:
    """(class counts outside loops, [((start, end), class counts of one
    trip)] for each range closed by a backward branch)."""
    ranges = []
    for addr, op, args in insns:
        m = _TARGET.search(args)
        if op.split(".")[0] == "BRA" and m and int(m.group(1), 16) <= addr:
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
    return f"fma {tot['fma']} alu {tot['alu']} other {tot['other']} total {sum(counter.values())}"


def _fmt(counter, top: int = 0) -> str:
    items = sorted(counter.items(), key=lambda kv: -kv[1])
    return " ".join(f"{c}={n}" for c, n in (items[:top] if top else items))


def report_census() -> None:
    lib = K.LIB.build()
    for line in K.ptxas_summary(K.LIB.build_log):
        print(f"ptxas {line}")
    for name, insns in sorted(sass_functions(lib).items()):
        short = next((k for k in KERNEL_NAMES if k in name), None)
        if short is None:
            continue
        outside, loops = census(insns)
        print(f"sass {short}: outside loops {_by_pipe(outside)}: {_fmt(outside)}")
        for (a, b), body in loops:
            print(f"sass {short}: loop {a:#x}-{b:#x}, one trip {_by_pipe(body)}: {_fmt(body)}")


# ---------------------------------------------------------------------------
# pipe bench
# ---------------------------------------------------------------------------

OPS = (
    "mul.lo.u32", "mul.hi.u32", "mul.wide.u32", "add.u32", "min.u32", "xor.b32",
    "shf.l.wrap.b32", "field.cuh mont_mul", "field.cuh add", "poseidon2.cu mont",
    "poseidon2.cu add",
)
CHAINS = 8

BENCH_CU = r"""
#include <cstdint>
#include "poseidon2_copy.cuh"  // csrc/poseidon2.cu, for its device functions

template <int OP>
__global__ void bench_kernel(uint32_t* out, long long* clocks, int iters, uint32_t seed) {
  uint32_t a[%(chains)d];
  uint64_t w[%(chains)d];
  const uint32_t tid = blockIdx.x * blockDim.x + threadIdx.x;
#pragma unroll
  for (int c = 0; c < %(chains)d; ++c) { a[c] = (seed * (tid + 7 * c + 1)) %% bb::P; w[c] = a[c]; }
  const uint32_t y = (seed ^ tid) %% bb::P | 1u;
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
    }
  }
  long long g1;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(g1));
  const long long t1 = clock64();
  uint32_t acc = 0;
#pragma unroll
  for (int c = 0; c < %(chains)d; ++c) acc ^= a[c] ^ (uint32_t)w[c] ^ (uint32_t)(w[c] >> 32);
  out[tid] = acc;
  if (threadIdx.x == 0) { clocks[2 * blockIdx.x] = t1 - t0; clocks[2 * blockIdx.x + 1] = g1 - g0; }
}

#define CASE(k) case k: bench_kernel<k><<<blocks, threads, 0, (cudaStream_t)stream>>>(out, clocks, iters, 12345u); break;
extern "C" int isa_bench(int op, int blocks, int threads, int iters, uint32_t* out, long long* clocks, void* stream) {
  switch (op) { CASE(0) CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(9) CASE(10) default: return -1; }
  return (int)cudaGetLastError();
}
"""


def _build_bench(name: str, source: str) -> str:
    """Builds ``source`` beside copies of csrc/field.cuh and csrc/poseidon2.cu
    into ``build/<name>/bench.so``; returns its path."""
    src_dir = os.path.join(K.BUILD_DIR, name)
    os.makedirs(src_dir, exist_ok=True)
    with open(os.path.join(src_dir, "bench.cu"), "w") as f:
        f.write(source)
    shutil.copy(os.path.join(K.CSRC, "field.cuh"), src_dir)
    shutil.copy(os.path.join(K.CSRC, "poseidon2.cu"), os.path.join(src_dir, "poseidon2_copy.cuh"))
    out = os.path.join(src_dir, "bench.so")
    cmd = [_tool("nvcc"), *K.NVCC_FLAGS, "-I", src_dir, "-o", out, os.path.join(src_dir, "bench.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise SystemExit(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    return out


def pipe_bench(iters: int = 2048) -> None:
    import torch

    lib_path = _build_bench("isa_bench", BENCH_CU % {"chains": CHAINS})
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
    for op, name in enumerate(OPS):
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
        lane_ops = blocks * threads * iters * CHAINS
        rate = lane_ops / (ms * 1e-3 * ghz * 1e9 * sms)
        body = max(census(funcs[op])[1], key=lambda lp: sum(lp[1].values()), default=None)
        classes = _fmt(body[1], 6) if body else "no loop"
        print(f"pipe {name}: {rate:.2f} lane ops a clock per SM at {ghz:.3f} GHz "
              f"({ms:.3f} ms; loop of {iters} x {CHAINS} chains: {classes})")


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
LATENCY_OPS = ("add", "mont", "shfl")
LATENCY_STEPS = 16  # dependent operations a loop trip
LATENCY_ITERS = 4096  # loop trips: 65,536 dependent operations, 0.7-2 M clocks

LATENCY_CU = r"""
#include <cstdint>
#include "field.cuh"

// one warp, one dependent chain a lane: OP 0 bb::fast::add, 1 bb::fast::mont,
// 2 a quad's __shfl_xor_sync, the operations of permute_quad
template <int OP>
__global__ void latency_kernel(uint32_t* out, long long* clocks, int iters, uint32_t seed) {
  uint32_t a = (seed * (threadIdx.x + 1)) % bb::P;
  const uint32_t y = (seed ^ threadIdx.x) % bb::P | 1u;
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
    }
  }
  const long long t1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  out[threadIdx.x] = a;
  if (threadIdx.x == 0) { clocks[0] = t1 - t0; clocks[1] = g1 - g0; }
}

#define CASE(k) case k: latency_kernel<k><<<1, 32, 0, (cudaStream_t)stream>>>(out, clocks, iters, 12345u); break;
extern "C" int isa_latency(int op, int iters, uint32_t* out, long long* clocks, void* stream) {
  switch (op) { CASE(0) CASE(1) CASE(2) default: return -1; }
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


def quad_perm_clocks(cycles: dict) -> float:
    """SM clocks of :data:`QUAD_PERM_CHAIN` at the latencies ``cycles``."""
    return sum(n * cycles[op] for op, n in QUAD_PERM_CHAIN.items())


def main() -> int:
    report_census()
    pipe_bench()
    cycles, ghz = latency_bench()
    lat = " ".join(f"{op} {c:.2f}" for op, c in cycles.items())
    clocks = quad_perm_clocks(cycles)
    print(f"latency (SM clocks a dependent operation, at {ghz:.3f} GHz): {lat}; one quad permutation's "
          f"chain {QUAD_PERM_CHAIN}: {clocks:.0f} clocks, {clocks / ghz / 1e3:.3f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
