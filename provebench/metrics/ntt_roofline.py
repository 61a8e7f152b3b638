"""Kernels A and A′'s share of their roofline, in %: the least time the card
could take for the NTT launches one proof makes (the ``ntt`` and
``ntt_recursive`` launches recorded in set-up's first call, each costed from
its input shape by the frozen yardstick, ``yardstick/roofline.py``), over
the device time a proof of the NTT's own CUDA functions in the traced
stretch (``torch.profiler``). Nothing when the trace holds none of their
time or set-up recorded no NTT launch."""

from harness import kernel_function

from yardstick.roofline import bound, launch_work

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "prove_s"
# the launch counters of A and A′ (``swirl_torch/kernels``) and the CUDA
# functions they launch (``csrc/ntt.cu``)
LAUNCHES = ("ntt", "ntt_recursive")
FUNCTIONS = ("ntt_pass1_kernel", "ntt_pass2_kernel", "ntt_rows_kernel")


def read(run):
    if run.profile is None or not run.launches:
        return None
    least_ms = sum(n * bound(launch_work(kernel, shape))[0]
                   for (kernel, shape), n in run.launches.items() if kernel in LAUNCHES)
    device_ns = sum(e - s for name, s, e in run.profile.device if kernel_function(name) in FUNCTIONS)
    if device_ns <= 0 or least_ms <= 0:
        return None
    return 100.0 * least_ms / (device_ns / 1e6 / run.profile.proofs)
