"""Where the time of kernels A and A′ goes: each device kernel of one
four-step NTT, by name, with its launches and its total time, at the
four-step shapes of the app and leaf paths. Run on a machine with the card:

    python -m swirl_torch.tools.ntt_passes

Each shape is transformed once to build the library and the twiddle table,
then once under ``torch.profiler`` (CUDA activity: CUPTI sees the kernels
that the ctypes library launches), then timed by CUDA events over a few
transforms for comparison with the profiler's sum. It fails if the
profiler records no device kernel of the transform.
"""

from __future__ import annotations

import re
import sys

SHAPES = ((4, 1 << 26), (2, 1 << 27), (4, 1 << 25), (4, 1 << 24), (16, 1 << 23), (4, 1 << 22), (4, 1 << 21))
REPS = 5


def short_name(name: str) -> str:
    """``(anonymous namespace)::f<long, unsigned int>(args)`` -> ``f<long, unsigned int>``."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            return name[:i]
    return name


def device_kernels(prof) -> dict:
    """{short kernel name: [launches, total µs]} of the CUDA events of a
    finished profile."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        k = out.setdefault(short_name(e.name), [0, 0.0])
        k[0] += 1
        k[1] += e.time_range.elapsed_us()
    return out


def profile_shape(shape, rng) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..fields.babybear import P
    from ..prover import ntt

    x = torch.randint(0, P, shape, generator=rng, device="cuda", dtype=torch.int64)
    ntt.ntt_rows(x)  # build, twiddle table
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ntt.ntt_rows(x)
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    label = f"({shape[0]}, 2^{shape[1].bit_length() - 1})"
    if not kernels:
        raise SystemExit(f"ntt_passes {label}: the profiler recorded no device kernel")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        ntt.ntt_rows(x)
    end.record()
    torch.cuda.synchronize()
    total = sum(us for _, us in kernels.values())
    for name, (n, us) in sorted(kernels.items(), key=lambda kv: -kv[1][1]):
        print(f"pass {label} {name}: launches {n}, {us:.1f} us ({100 * us / total:.1f}%)")
    print(f"total {label}: profiler {total:.1f} us, CUDA events {1e3 * start.elapsed_time(end) / REPS:.1f} us "
          f"(mean of {REPS})")
    del x
    torch.cuda.empty_cache()


def main() -> int:
    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("ntt_passes: no CUDA device; this tool runs only on the card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    rng = torch.Generator(device="cuda")
    rng.manual_seed(0)
    for shape in SHAPES:
        profile_shape(shape, rng)
    from .. import kernels as K

    for line in K.ptxas_summary(K.LIB.build_log):  # empty when the library was already built
        if "ntt_cu" in line:  # every kernel of ntt.cu: its mangled names hold the file's
            print(f"ptxas {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
