"""Where a prove's time goes, stage span by stage span: host wall time, the
card's busy time, kernel launches and host syncs. Run on a machine with the
card:

    python -m swirl_torch.tools.prove_profile [--workloads app,keccak,reth204,reth13]

It proves each workload (by default app and keccak) on both transcripts
(the host ``Transcript`` and the ``DeviceTranscript``), each once to warm
up (kernel build, tables) and once under ``torch.profiler`` (CPU and CUDA
activity):

- app: the 2^20 x 64 SyntheticAir (degree 3, 16 constraints, 8
  interactions) under ``app_params_with_100_bits_security(22)``;
- keccak: 2^10 keccak-f permutations (the reference keccakf example's
  inputs, a 2^15 x 2633 trace) under ``app_params_with_100_bits_security(17)``;
- reth<N>: segment N of ``benchmarks/reth-block-23992138-atlas.json`` at
  the 2^22 clamp, every AIR in one proof, traces from
  ``segment_fit.seeded_traces``, under ``segment_fit.runner_params`` (the
  synthetic runner's parameters).

``swirl_torch.metrics.span`` marks each span in the trace itself while the
profiler runs (a ``span:<name>`` range); the tool reads those ranges. For
each span it prints its host wall ms; the
device-busy ms (the union of the card's kernel, copy and fill intervals
inside the span's window) and its share; the host's ms blocked in
synchronize calls; the host's ms in the native proof-of-work grind
(``native.grind``, the host transcript's); the kernel launches, synchronize calls and
device-to-host and host-to-device copies the host issued inside it. The
host's remaining time (wall minus blocked) is Python dispatch and host
work. Each span prints a row per transcript, one under the other, so the
two are read from one run. Each prove also prints every hand-written
kernel's launches and device ms (by its device events, under its CUDA
name: ``duplex_kernel`` is E, ``grind_sweep_kernel`` and
``grind_rows_kernel`` F on the device transcript), and F's device ms by
bit width: each call of ``DeviceTranscript.grind`` is marked with its bits,
and the grind kernels' device events, in launch order, are dealt to the
calls in order (one search launch a grind; the kernels before, a search
and an advance). It fails if the profiler recorded no device activity, or
if the two transcripts' proofs differ.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import time

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
HOST_GRIND = "native.grind"


@contextlib.contextmanager
def annotated_grinds():
    """Marks every call of the native grind in the profiler's trace while
    active; yields the bits of each call of ``DeviceTranscript.grind`` made
    meanwhile, in order."""
    from torch.profiler import record_function

    from .. import native
    from ..prover.device_transcript import DeviceTranscript

    grind, device_grind = native.grind, DeviceTranscript.grind
    device_bits = []

    def marked_grind(*args):
        with record_function(HOST_GRIND):
            return grind(*args)

    def marked_device_grind(self, bits):
        device_bits.append(bits)
        return device_grind(self, bits)

    native.grind, DeviceTranscript.grind = marked_grind, marked_device_grind
    try:
        yield device_bits
    finally:
        native.grind, DeviceTranscript.grind = grind, device_grind


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
    """[(span name, occurrences, wall ms, busy ms, blocked ms, host grind
    ms, launches, syncs, d2h, h2d)] from a finished profile, in order of
    first start."""
    from torch.autograd import DeviceType

    from ..metrics import SPAN_RANGE

    spans = {}
    launches, syncs, d2h, h2d, device = [], [], [], [], []
    blocked, grinds = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() != DeviceType.CPU:
            device.append((e.start_ns(), e.end_ns()))
            if "DtoH" in name:
                d2h.append(e.start_ns())
            elif "HtoD" in name:
                h2d.append(e.start_ns())
        elif name.startswith(SPAN_RANGE):
            spans.setdefault(name[len(SPAN_RANGE):], []).append((e.start_ns(), e.end_ns()))
        elif name in LAUNCH_CALLS:
            launches.append(e.start_ns())
        elif name in SYNC_CALLS:
            syncs.append(e.start_ns())
            blocked.append((e.start_ns(), e.end_ns()))
        elif name == HOST_GRIND:
            grinds.append((e.start_ns(), e.end_ns()))
    if not device:
        raise SystemExit("prove_profile: the profiler recorded no device activity")
    for times in (launches, syncs, d2h, h2d):
        times.sort()
    busy, waits, ground = _Union(device), _Union(blocked), _Union(grinds)
    rows = []
    for name, windows in sorted(spans.items(), key=lambda kv: kv[1][0][0]):
        row = [name, len(windows)] + [0] * 8
        for lo, hi in windows:
            row[2] += (hi - lo) / 1e6
            row[3] += busy.covered(lo, hi) / 1e6
            row[4] += waits.covered(lo, hi) / 1e6
            row[5] += ground.covered(lo, hi) / 1e6
            for k, times in enumerate((launches, syncs, d2h, h2d)):
                row[6 + k] += _count(times, lo, hi)
        rows.append(tuple(row))
    return rows


def kernel_table(prof) -> dict:
    """{kernel: (launches, device ms)} of the port's hand-written kernels
    (csrc/*.cu: ``..._kernel`` in an anonymous namespace) in a finished
    profile, by their device events."""
    import re

    from torch.autograd import DeviceType

    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            continue
        m = re.search(r"anonymous namespace\)::(\w+_kernel)\b", e.name())
        if m:
            n, ms = out.get(m.group(1), (0, 0.0))
            out[m.group(1)] = (n + 1, ms + (e.end_ns() - e.start_ns()) / 1e6)
    return out


GRIND_KERNEL = re.compile(r"anonymous namespace\)::(grind\w*_kernel)\b")


def grind_widths(prof, bits: list) -> dict:
    """{bits: (searches, device ms)} of kernel F in a finished profile: its
    kernels' device events (``grind..._kernel``, BabyBear's: the device
    transcript's) in start order, one a grind in ``bits`` order. Raises
    when their count is not the grinds'."""
    from torch.autograd import DeviceType

    events = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                    if e.device_type() != DeviceType.CPU and GRIND_KERNEL.search(e.name()))
    if len(events) != len(bits):
        raise SystemExit(f"prove_profile: {len(events)} grind kernel events for {len(bits)} grinds")
    out = {}
    for b, (s, e) in zip(bits, events):
        n, ms = out.get(b, (0, 0.0))
        out[b] = (n + 1, ms + (e - s) / 1e6)
    return out


def app_workload():
    import numpy as np

    from ..fields.babybear import P
    from ..params import app_params_with_100_bits_security
    from ..testing.synthetic import SyntheticAir, uniform_shape

    air = SyntheticAir(uniform_shape(20, 64, num_constraints=16, num_interactions=8, degree=3))
    trace = np.random.default_rng(0).integers(0, P, (1 << 20, air.common_main_width()), dtype=np.uint64)
    trace[:, 0] = 0
    return app_params_with_100_bits_security(22), [air], [trace]


def keccak_workload():
    import numpy as np

    from ..models.keccak import KeccakAir
    from ..params import app_params_with_100_bits_security

    air = KeccakAir()
    inputs = np.random.default_rng(0).integers(0, 1 << 63, (1 << 10, 5, 5), dtype=np.uint64)
    trace = air.generate_trace(inputs)
    log_height = trace.shape[0].bit_length() - 1
    return app_params_with_100_bits_security(max(log_height + 2, 16)), [air], [trace]


def reth_workload(segment_idx: int):
    import os

    from ..testing.synthetic import SyntheticAir, load_segment_atlas
    from .segment_fit import ATLAS, runner_params, seeded_traces

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    seg = next(s for s in load_segment_atlas(os.path.join(root, ATLAS), 22) if s["segment_idx"] == segment_idx)
    airs = [SyntheticAir(shape) for shape in seg["shapes"]]
    return runner_params(22, seg["max_constraint_degree"]), airs, seeded_traces(airs)


def profile_prove(tag: str, eng, dpk, ctx, transcript) -> tuple:
    """A warm-up prove, then one under the profiler, on a fresh transcript of
    the kind ``transcript`` makes; returns (span rows, proof bytes)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..codec import encode_proof

    t0 = time.perf_counter()
    eng.prove(dpk, ctx, transcript())
    torch.cuda.synchronize()
    print(f"{tag}: warm-up prove {time.perf_counter() - t0:.3f} s (not profiled)", flush=True)
    torch.cuda.empty_cache()
    fresh = transcript()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, annotated_grinds() as bits:
        t0 = time.perf_counter()
        proof = eng.prove(dpk, ctx, fresh)
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = span_table(prof)
    print(f"{tag}: profiled prove {prove_s:.3f} s; trace read in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, (n, ms) in sorted(kernel_table(prof).items(), key=lambda kv: -kv[1][1]):
        print(f"{tag}: kernel {name} | {n} launches | {ms:.3f} device ms a prove", flush=True)
    for b, (n, ms) in sorted(grind_widths(prof, bits).items(), reverse=True):
        print(f"{tag}: kernel F at {b} bits | {n} searches | {ms:.3f} device ms a prove", flush=True)
    torch.cuda.empty_cache()
    return rows, encode_proof(proof)


def profile_workload(tag: str, params, airs, traces, transcripts) -> None:
    from ..engine import StarkEngine
    from ..prover.backend import ProvingContext

    eng = StarkEngine(params, device="cuda")
    pk, _ = eng.keygen(airs)
    dpk = eng.transport_pk(pk)
    ctx = ProvingContext([eng.context_for(i, trace, [], []) for i, trace in enumerate(traces)])
    tables, proofs = {}, set()
    for kind, make in transcripts:
        tables[kind], data = profile_prove(f"{tag} {kind}", eng, dpk, ctx, make)
        proofs.add(data)
    if len(proofs) != 1:
        raise SystemExit(f"prove_profile: {tag}: the transcripts' proofs differ")
    print(f"{tag}: span | transcript | n | wall ms | device busy ms (share) | blocked in syncs ms | "
          "host grind ms | launches | syncs | DtoH | HtoD")
    names = []
    for rows in tables.values():
        names += [r[0] for r in rows if r[0] not in names]
    for name in names:
        for kind, rows in tables.items():
            for _, n, wall, busy, blocked, grind, launches, syncs, d2h, h2d in (r for r in rows if r[0] == name):
                print(f"{tag}: {name} | {kind} | {n} | {wall:.1f} | {busy:.1f} ({100 * busy / wall:.1f}%) | "
                      f"{blocked:.1f} | {grind:.1f} | {launches} | {syncs} | {d2h} | {h2d}", flush=True)


def main(argv=None) -> int:
    import argparse
    import subprocess

    import torch

    from ..prover.device_transcript import DeviceTranscript
    from ..transcript import Transcript

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workloads", default="app,keccak", help="comma-separated: app, keccak, reth<segment>")
    names = ap.parse_args(argv).workloads.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("prove_profile: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    transcripts = [("host", Transcript), ("device", lambda: DeviceTranscript("cuda"))]
    for tag in names:
        if tag.startswith("reth"):
            workload = reth_workload(int(tag[len("reth"):]))
        else:
            workload = {"app": app_workload, "keccak": keccak_workload}[tag]()
        profile_workload(tag, *workload, transcripts)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
