"""Kernels A, A′, B, C and D's share of their roofline, in %: the least time
the card could take for the launches one proof makes (their input shapes
recorded in set-up's first call, each launch's bytes and operations by the
frozen yardstick, ``yardstick/roofline.py``), over those kernels' device time
a proof in the traced stretch (``torch.profiler``). Nothing when the trace
holds none of their time or set-up recorded no launches."""

from harness import kernel_function

from yardstick.roofline import DEVICE_FUNCTIONS, bound, launch_work

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "prove_s"


def read(run):
    if run.profile is None or not run.launches:
        return None
    least_ms = 0.0
    for (kernel, shape), n in run.launches.items():
        work = launch_work(kernel, shape)
        if work is not None:
            least_ms += n * bound(work)[0]
    device_ns = sum(e - s for name, s, e in run.profile.device if kernel_function(name) in DEVICE_FUNCTIONS)
    if device_ns <= 0 or least_ms <= 0:
        return None
    return 100.0 * least_ms / (device_ns / 1e6 / run.profile.proofs)
