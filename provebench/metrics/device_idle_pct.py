"""The share of the traced stretch, in %, in which no kernel, copy or fill
ran on the card: the union of the card's intervals under ``torch.profiler``
(``yardstick/busy.py``) against the stretch's length. The idle time that
falls inside the profiler's own host events (its buffer flushes and
requests) is the trace's cost, not the program's: it leaves both the idle
time and the stretch."""

from harness import busy_ns, profiler_idle_ns

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "prove_s"


def read(run):
    p = run.profile
    if p is None or p.hi <= p.lo or not p.device:
        return None
    own = profiler_idle_ns(p)
    window = p.hi - p.lo - own
    return 100.0 * (1.0 - busy_ns(p) / window) if window > 0 else None
