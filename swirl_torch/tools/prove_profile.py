"""Where a prove's time goes, stage span by stage span: host wall time, the
card's busy time, kernel launches and host syncs. Run on a machine with the
card:

    python -m swirl_torch.tools.prove_profile

It proves two workloads, each once to warm up (kernel build, tables) and
once under ``torch.profiler`` (CPU and CUDA activity):

- app: the 2^20 x 64 SyntheticAir (degree 3, 16 constraints, 8
  interactions) under ``app_params_with_100_bits_security(22)``;
- keccak: 2^10 keccak-f permutations (the reference keccakf example's
  inputs, a 2^15 x 2633 trace) under ``app_params_with_100_bits_security(17)``.

Each stage span of ``swirl_torch.metrics`` is marked in the trace with
``record_function``. For each span the tool prints its host wall ms; the
device-busy ms (the union of the card's kernel, copy and fill intervals
inside the span's window) and its share; the host's ms blocked in
synchronize calls; the kernel launches, synchronize calls and
device-to-host and host-to-device copies the host issued inside it. The
host's remaining time (wall minus blocked) is Python dispatch and host
work. It fails if the profiler recorded no device activity.
"""

from __future__ import annotations

import bisect
import contextlib
import time

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
SPAN = "span:"


@contextlib.contextmanager
def annotated_spans():
    """Marks every ``metrics.span`` in the profiler's trace while active."""
    from torch.profiler import record_function

    from .. import metrics

    plain = metrics.span

    @contextlib.contextmanager
    def span(name):
        with record_function(SPAN + name), plain(name):
            yield

    metrics.span = span
    try:
        yield
    finally:
        metrics.span = plain


class _Union:
    """Disjoint union of intervals, with the covered length in a window."""

    def __init__(self, intervals):
        merged = []
        for s, e in sorted(intervals):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.starts = [s for s, _ in merged]
        self.ends = [e for _, e in merged]
        self.prefix = [0]
        for s, e in merged:
            self.prefix.append(self.prefix[-1] + e - s)

    def covered(self, lo, hi) -> int:
        i = bisect.bisect_right(self.ends, lo)  # first interval ending after lo
        j = bisect.bisect_left(self.starts, hi)  # intervals starting before hi
        if i >= j:
            return 0
        total = self.prefix[j] - self.prefix[i]
        total -= max(0, lo - self.starts[i])
        total -= max(0, self.ends[j - 1] - hi)
        return total


def _count(sorted_times, lo, hi) -> int:
    return bisect.bisect_left(sorted_times, hi) - bisect.bisect_left(sorted_times, lo)


def span_table(prof) -> list:
    """[(span name, occurrences, wall ms, busy ms, blocked ms, launches,
    syncs, d2h, h2d)] from a finished profile, in order of first start."""
    from torch.autograd import DeviceType

    spans = {}
    launches, syncs, d2h, h2d, device = [], [], [], [], []
    blocked = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() != DeviceType.CPU:
            if name.startswith(SPAN):
                continue  # a span's own range, mirrored on the device's timeline
            device.append((e.start_ns(), e.end_ns()))
            if "DtoH" in name:
                d2h.append(e.start_ns())
            elif "HtoD" in name:
                h2d.append(e.start_ns())
        elif name.startswith(SPAN):
            spans.setdefault(name[len(SPAN):], []).append((e.start_ns(), e.end_ns()))
        elif name in LAUNCH_CALLS:
            launches.append(e.start_ns())
        elif name in SYNC_CALLS:
            syncs.append(e.start_ns())
            blocked.append((e.start_ns(), e.end_ns()))
    if not device:
        raise SystemExit("prove_profile: the profiler recorded no device activity")
    for times in (launches, syncs, d2h, h2d):
        times.sort()
    busy, waits = _Union(device), _Union(blocked)
    rows = []
    for name, windows in sorted(spans.items(), key=lambda kv: kv[1][0][0]):
        row = [name, len(windows)] + [0] * 7
        for lo, hi in windows:
            row[2] += (hi - lo) / 1e6
            row[3] += busy.covered(lo, hi) / 1e6
            row[4] += waits.covered(lo, hi) / 1e6
            for k, times in enumerate((launches, syncs, d2h, h2d)):
                row[5 + k] += _count(times, lo, hi)
        rows.append(tuple(row))
    return rows


def app_workload():
    import numpy as np

    from ..fields.babybear import P
    from ..params import app_params_with_100_bits_security
    from ..testing.synthetic import SyntheticAir, uniform_shape

    air = SyntheticAir(uniform_shape(20, 64, num_constraints=16, num_interactions=8, degree=3))
    trace = np.random.default_rng(0).integers(0, P, (1 << 20, air.common_main_width()), dtype=np.uint64)
    trace[:, 0] = 0
    return app_params_with_100_bits_security(22), air, trace


def keccak_workload():
    import numpy as np

    from ..models.keccak import KeccakAir
    from ..params import app_params_with_100_bits_security

    air = KeccakAir()
    inputs = np.random.default_rng(0).integers(0, 1 << 63, (1 << 10, 5, 5), dtype=np.uint64)
    trace = air.generate_trace(inputs)
    log_height = trace.shape[0].bit_length() - 1
    return app_params_with_100_bits_security(max(log_height + 2, 16)), air, trace


def profile_workload(tag: str, params, air, trace) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..engine import StarkEngine
    from ..prover.backend import ProvingContext

    eng = StarkEngine(params, "cuda")
    pk, _ = eng.keygen([air])
    dpk = eng.transport_pk(pk)
    ctx = ProvingContext([eng.context_for(0, trace, [], [])])
    t0 = time.perf_counter()
    eng.prove(dpk, ctx)
    torch.cuda.synchronize()
    print(f"{tag}: warm-up prove {time.perf_counter() - t0:.3f} s (not profiled)", flush=True)
    torch.cuda.empty_cache()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, annotated_spans():
        t0 = time.perf_counter()
        eng.prove(dpk, ctx)
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = span_table(prof)
    print(f"{tag}: profiled prove {prove_s:.3f} s; trace read in {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"{tag}: span | n | wall ms | device busy ms (share) | blocked in syncs ms | "
          "launches | syncs | DtoH | HtoD")
    for name, n, wall, busy, blocked, launches, syncs, d2h, h2d in rows:
        print(f"{tag}: {name} | {n} | {wall:.1f} | {busy:.1f} ({100 * busy / wall:.1f}%) | {blocked:.1f} | "
              f"{launches} | {syncs} | {d2h} | {h2d}", flush=True)


def main() -> int:
    import subprocess

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("prove_profile: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for tag, workload in (("app", app_workload), ("keccak", keccak_workload)):
        profile_workload(tag, *workload())
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
