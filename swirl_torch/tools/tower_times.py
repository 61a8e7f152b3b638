"""Kernel D's device time at every layer width: ``compress_tower`` on a
random (8, n) layer for n = 2, 4, ..., 8192, each width called REPS times
under ``torch.profiler`` (CUDA activity: CUPTI sees the kernels that the
ctypes library launches), the mean of the tower kernel's own durations.
Run on a machine with the card:

    python -m swirl_torch.tools.tower_times

It checks each width against the plain tower first, and fails if the
profiler records no tower kernel. The time at n = 2 is one permutation's
(t_perm); the steps between widths are the cost of one more level. To read
a parent commit, copy this file into a ``git archive`` copy of it
(``build/parent/swirl_torch/tools/``) and run it there.
"""

from __future__ import annotations

import subprocess
import sys

import torch

from ..fields.babybear import P
from ..hash import poseidon2 as p2

REPS = 10
LOG_MAX = 13  # log2 of p2.TOWER_MAX


def main() -> int:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    xs = {k: torch.randint(0, P, (8, 1 << k), generator=gen, device="cuda", dtype=torch.int64)
          for k in range(1, LOG_MAX + 1)}
    for k, x in xs.items():
        if not all(torch.equal(a, b) for a, b in zip(p2.compress_tower(x), p2.merkle_tower_plain(x))):
            raise SystemExit(f"tower_times: the tower differs from the plain one at n = 2^{k}")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for x in xs.values():
            for _ in range(REPS):
                p2.compress_tower(x)
            torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and "tower_kernel" in e.name]
    if len(us) != REPS * len(xs):
        raise SystemExit(f"tower_times: the profiler recorded {len(us)} tower kernels, not {REPS * len(xs)}")
    print("tower device us by n: " + " ".join(
        f"2^{k}={sum(us[REPS * i : REPS * (i + 1)]) / REPS:.2f}" for i, k in enumerate(xs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
