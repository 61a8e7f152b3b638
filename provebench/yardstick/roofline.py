"""The yardstick of kernels A, A′, B, C and D: the least time the card could
take for one launch, from its input shape.

Frozen copies, so that a later change to the program cannot move them:

- the H100 constants and the per-operation model of
  ``swirl_torch/roofline.py`` (commit 484cae3);
- the work of a launch from ``chip_smoke.py``'s ``ntt_work``,
  ``hash_work``, ``compress_work``, ``layer_work`` and ``tower_work``
  (commit 484cae3): bytes at 8 a stored element (the port keeps every
  element in int64) and field work as (multiplies, other operations).

The card: H100 SXM 80GB HBM3 (NVIDIA's data sheet), 700 W power limit.
Bytes move at 3.35 TB/s. The operations are 32-bit integer instructions: a
Hopper SM issues 64 integer multiplies or multiply-adds a clock (its FMA
pipe) and 64 other 32-bit integer operations a clock (add, subtract,
compare, min and max: its ALU pipe), by the arithmetic throughput table of
the CUDA C++ Programming Guide for compute capability 9.0. The two pipes run
side by side and the FMA pipe can also add, so m multiplies and a other
operations take at least max(m, (m + a) / 2) clocks of 64 lanes. 132 SMs at
the 1.98 GHz boost clock give 64 x 132 x 1.98e9 = 16.7e12 lane operations a
second for each pipe. A bound is

    max(bytes / 3.35e12, max(m, (m + a) / 2) / (64 * 132 * 1.98e9)) seconds.

A field operation counts the fewest instructions that sm_90a issues for it
(the SASS of ``swirl_torch/csrc/poseidon2.cu``, by
``swirl_torch/tools/isa.py``): a Montgomery product 3 multiplies (the wide
a*b, q = lo*P^-1, the high half of q*P) and 2 other operations
(hi(a*b) - hi(q*P) + P in one IADD3, then min(r, r - P) in one VIADDMNMX);
a product left in (0, 2P) 1 other; an add or a subtract 2 other operations
(IADD3, VIADDMNMX); a halving 1 multiply-add and 2 others; a product by
2^-k without a Montgomery product 1 multiply-add (hi - 15 * 2^(27-k) * lo)
and 3 others. Work is a pair (multiplies, other operations).
"""

from __future__ import annotations

from typing import Tuple

CARD = "NVIDIA H100 80GB HBM3"
POWER_LIMIT_W = 700.0
HBM_BYTES_PER_S = 3.35e12
BOOST_HZ = 1.98e9
SMS, THREADS_PER_SM = 132, 2048  # the H100 SXM's SMs and resident threads an SM
INT32_LANE_OPS_PER_S = 64 * SMS * BOOST_HZ

MONT_MUL, ADD = (3, 2), (0, 2)  # (multiplies, other operations)
SBOX = (12, 7)  # x^7: x^2, x^4 and x^3 * x^4 reduced, x^3 left in (0, 2P)
HALVE, DIV2K = (1, 2), (1, 3)
# one Poseidon2-16 permutation: 141 S-boxes (16 in each of 8 full rounds,
# 1 in each of 13 partial rounds); 1309 adds (9 M_E layers of 72, 128 + 13
# round constants, 41 in each partial round's tree sum and diagonal); the
# diagonal's 2 halvings and 7 products by 2^-k in each partial round
PERM = tuple(141 * s + 1309 * a + 26 * h + 91 * d for s, a, h, d in zip(SBOX, ADD, HALVE, DIV2K))
# one radix-2 butterfly: a product, an add and a subtract
BUTTERFLY = (MONT_MUL[0], MONT_MUL[1] + 2 * ADD[1])


def times(ops, k):
    """``k`` times the work ``ops``."""
    return ops[0] * k, ops[1] * k


def plus(*ops):
    """The sum of works."""
    return tuple(sum(x) for x in zip(*ops))


def bound(work) -> Tuple[float, str]:
    """(bound_ms, bound_by) of (bytes, (multiplies, others)): "bytes" or
    "operations", whichever takes longer."""
    nbytes, (muls, others) = work
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = max(muls, (muls + others) / 2) / INT32_LANE_OPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def ntt_work(shape):
    """(bytes, (multiplies, others)) of a (batch, N) int64 NTT: one read and
    one write per element, N/2 log N butterflies per row."""
    batch, n = shape
    butterflies = batch * (n // 2) * (n.bit_length() - 1)
    return 2 * batch * n * 8, times(BUTTERFLY, butterflies)


def hash_work(shape):
    """hash_cols on (w, H) or (w, H, d): w*d*H words in, 8*H out; one
    permutation per 8 absorbed words of each row."""
    w, h = shape[0] * (shape[2] if len(shape) == 3 else 1), shape[1]
    return (w + 8) * h * 8, times(PERM, h * -(-w // 8))


def compress_work(shape):
    """compress_cols on (16, n): 16n words in, 8n out, n permutations."""
    _, n = shape
    return 24 * n * 8, times(PERM, n)


def layer_work(shape):
    """compress_layer on an (8, n) layer: the work of (16, n/2) pairs."""
    return compress_work((16, shape[1] // 2))


def tower_work(shape):
    """The tower on (8, n): 8n words in, every level out."""
    _, n = shape
    return (8 * n + 8 * (n - 1)) * 8, times(PERM, n - 1)


# the program's launch counters (``swirl_torch/kernels``), by the name each
# wrapper counts under, and the work of a launch on an input of that shape
def launch_work(kernel: str, shape: Tuple[int, ...]):
    """(bytes, (multiplies, others)) of one launch of ``kernel`` (a launch
    counter's name: ``ntt``, ``ntt_recursive``, ``hash_cols``,
    ``compress_cols``, ``merkle_tower``) on an input of ``shape``; None for
    another kernel. Kernel C takes (16, n) digest pairs or an (8, n) layer
    read in place."""
    if kernel in ("ntt", "ntt_recursive"):
        return ntt_work(shape)
    if kernel == "hash_cols":
        return hash_work(shape)
    if kernel == "compress_cols":
        return compress_work(shape) if shape[0] == 16 else layer_work(shape)
    if kernel == "merkle_tower":
        return tower_work(shape)
    return None


# the device names of those kernels' CUDA functions (csrc/ntt.cu,
# csrc/poseidon2.cu), as the profiler records them
DEVICE_FUNCTIONS = ("ntt_pass1_kernel", "ntt_pass2_kernel", "ntt_rows_kernel", "hash_cols_kernel",
                    "compress_kernel", "tower_kernel")
