"""Seconds from the process's start (``run.py``'s first statement) to the
first timed proof: imports, the kernel library's load (its build on a
checkout's first run), keygen, the inputs and the first ``prove_fused``
call (eager warm-up, capture, instantiation)."""

UNIT = "s"
SOURCE = "host_clock"


def read(run):
    return run.setup_s
