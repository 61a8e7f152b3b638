#!/usr/bin/env python3
"""Run one cell of the benchmark of ``swirl_torch`` on this machine's CUDA
card, from the root of a checkout:

    python3 provebench/run.py --workload app-synthetic.replay --seed 7 --seconds 30 --trace 0

It prints what set-up does on earlier lines, the numbers the check compares
beside their limits on standard error, and as the last line of standard
output one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``; with ``--trace 1`` also ``breakdown``; last ``checks``). Without
a CUDA card it exits with 2 and prints no result. See ``harness.py``.
"""

import time

T0 = time.perf_counter()  # set-up runs from here to the first timed proof

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every build and kernel cache of the run stays in fixed directories of the
# checkout (the program builds its kernels into build/ there)
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
os.environ.setdefault("USE_FLAX", "0")
# one process with few threads: the host's part of a proof is Python and small
# copies, and the card paces the rest
for name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(name, "2")
sys.path[:0] = [HERE, ROOT]

import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t0=T0))
