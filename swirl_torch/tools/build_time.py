"""The kernel library's build time, two ways, each from nothing into its own
directory under ``build/build_time/``: one ``nvcc`` per ``csrc/*.cu``, all
started together, then a link (``kernels._Library.build``, what the port
runs), and one ``nvcc`` over every source. Runs each twice, in the order
parallel, one call, one call, parallel. Needs the CUDA toolkit:

    python -m swirl_torch.tools.build_time
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time

from .. import kernels as K


def _parallel(root: str) -> float:
    saved = K.BUILD_DIR
    K.BUILD_DIR = root
    try:
        t0 = time.perf_counter()
        K._Library().build()
        return time.perf_counter() - t0
    finally:
        K.BUILD_DIR = saved


def _one_call(root: str) -> float:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    cus = [s for s in K.LIB._sources() if s.endswith(".cu")]
    os.makedirs(root)
    t0 = time.perf_counter()
    r = subprocess.run([nvcc, *K.NVCC_FLAGS, "-o", os.path.join(root, "lib.so"), *cus],
                       capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise K.KernelError(f"nvcc failed:\n{r.stdout}{r.stderr}")
    return time.perf_counter() - t0


def main() -> int:
    root = os.path.join(K.BUILD_DIR, "build_time")
    shutil.rmtree(root, ignore_errors=True)
    cus = [os.path.basename(s) for s in K.LIB._sources() if s.endswith(".cu")]
    print(f"sources {cus}, {os.cpu_count()} CPUs")
    times = {"parallel": [], "one call": []}
    for i, how in enumerate(("parallel", "one call", "one call", "parallel")):
        d = os.path.join(root, f"{i}")
        times[how].append(_parallel(d) if how == "parallel" else _one_call(d))
        print(f"build {i + 1} ({how}): {times[how][-1]:.1f} s")
    shutil.rmtree(root, ignore_errors=True)
    print(f"parallel {times['parallel']} s, one call {times['one call']} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
