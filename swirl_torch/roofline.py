"""Analytic roofline of the prover's stages on one NVIDIA H100, and the
per-operation model that every kernel bound of ``chip_smoke.py`` uses.

Peer of ``swirl/roofline.py``. For each stage of a proof it counts the
device-memory bytes that the stage must move and its field work, and turns
them into the least time the card could take. The stage keys are the
prover's metric span names, so a span's measured time joins its bound.

The work model is the reference's, unchanged, so that a bound reads the same
work whatever implements it: 4 B a base-field element, 16 B an EF element,
each stage's passes over the data as ``swirl/roofline.py`` counts them
(perfect fusion: each input read once, each output written once, padding
ignored). The port stores every element in int64, twice those bytes; that
shows up as a lower share of the roofline, not as a larger bound.

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

from dataclasses import dataclass
from typing import Dict, Tuple

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

# the reference's work model (swirl/roofline.py)
F_BYTES = 4  # a base-field element
EF_BYTES = 16  # an EF4 element


def times(ops, k):
    """``k`` times the work ``ops``."""
    return ops[0] * k, ops[1] * k


def plus(*ops):
    """The sum of works."""
    return tuple(sum(x) for x in zip(*ops))


# one candidate of kernel F's sweep route: a permutation less its first
# M_E (72 adds) and first round constants (16), which the launch applies once
# to the words that do not depend on the candidate, plus the 20 adds of the
# first S-box inputs c_i + k_i w (16, and 2w, 3w = 2w + w, 4w, 6w), less the
# 44 adds of the last M_E that the sampled word 7 does not need (it takes
# each group's row 3 of M4, 6 adds a group, column 3's sum, 3, and its own
# add: 28 of 72)
GRIND_CANDIDATE = plus(PERM, times(ADD, 20 - 72 - 16 - (72 - 28)))


def bound(work) -> Tuple[float, str]:
    """(bound_ms, bound_by) of (bytes, (multiplies, others)): "bytes" or
    "operations", whichever takes longer."""
    nbytes, (muls, others) = work
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = max(muls, (muls + others) / 2) / INT32_LANE_OPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


@dataclass
class StageBound:
    hbm_bytes: float
    muls: float
    others: float

    @property
    def min_ms(self) -> float:
        return bound((self.hbm_bytes, (self.muls, self.others)))[0]

    @property
    def bound(self) -> str:
        return bound((self.hbm_bytes, (self.muls, self.others)))[1]


def _stage(hbm_bytes, *work) -> StageBound:
    m, a = plus(*work) if work else (0, 0)
    return StageBound(float(hbm_bytes), float(m), float(a))


def prove_bounds(params, log_rows: int, width: int,
                 num_interactions: int) -> Dict[str, StageBound]:
    """Per-stage lower bounds for one uniform trace of 2^log_rows x width,
    with the reference's bytes and passes (``swirl/roofline.py:63``); its
    field multiplies count as Montgomery products, its butterflies and
    permutations as this module's."""
    rows = 1 << log_rows
    cells = rows * width
    log_stacked = params.log_stacked_height
    stacked_rows = 1 << log_stacked
    stacked_w = max(cells // stacked_rows, 1)
    blowup = 1 << params.log_blowup
    rs_cells = cells * blowup
    k = params.k_whir

    # -- main_trace_commit: read trace + write stacked gather, eval->coeff
    # iDFT pass + coset-DFT blowup pass (two passes over the RS matrix, a
    # butterfly a cell a pass), leaf hashing reads the RS matrix once, the
    # digest tower is geometric (~2x leaf digests).
    n_leaves = (stacked_rows * blowup) >> k
    perms = rs_cells / 8.0 + 2.0 * n_leaves  # rate-8 absorbs + tower
    commit = _stage(
        2 * cells * F_BYTES  # stacking gather r+w
        + 2 * 2 * rs_cells * F_BYTES  # NTT: 2 passes r+w over RS matrix
        + rs_cells * F_BYTES  # leaf hash read
        + 2 * n_leaves * 8 * F_BYTES,  # digest layers w+r
        times(BUTTERFLY, 2 * rs_cells),
        times(PERM, perms),
    )

    # -- GKR fractional sumcheck: the fraction tree over the lifted
    # interaction leaves (layer sizes sum to ~2x leaves, EF values, a
    # projective add ~54 base products), then per-layer fold+eval passes
    # (~3x tree bytes).
    n_frac = rows * max(num_interactions, 1)
    gkr = _stage(5.0 * 2 * n_frac * 2 * EF_BYTES, times(MONT_MUL, 2 * n_frac * 54))

    # -- batch constraints: round-0 coset grids read the trace per coset
    # (deg+1 cosets), MLE rounds halve each round => ~2x more passes; three
    # products a cell a coset.
    s_deg = params.max_constraint_degree + 1
    batch = _stage((s_deg + 2.0) * cells * F_BYTES, times(MONT_MUL, s_deg * cells * 3))

    # -- stacked reduction: one PLE-fold pass + n_stack halving rounds over
    # the stacked matrix in EF (~2x total), four products a cell a pass.
    stacking = _stage(3.0 * stacked_rows * stacked_w * EF_BYTES,
                      times(MONT_MUL, 2.0 * stacked_rows * stacked_w * 4))

    # -- WHIR: mu-batch read of the RS matrix (a product a cell), then per
    # round the codeword folds (geometric, ~2x first codeword in EF).
    whir = _stage(rs_cells * F_BYTES + 2.0 * stacked_rows * blowup * EF_BYTES,
                  times(MONT_MUL, rs_cells + 2.0 * stacked_rows * blowup * 54 / 4))

    # prove_rap_constraints wraps GKR and the batched constraint sumcheck
    return {
        "prover.main_trace_commit": commit,
        "fractional_sumcheck": gkr,
        "prove_rap_constraints": StageBound(gkr.hbm_bytes + batch.hbm_bytes,
                                            gkr.muls + batch.muls, gkr.others + batch.others),
        "prove_stacked_reduction": stacking,
        "prove_whir": whir,
    }


def report(params, log_rows: int, width: int, num_interactions: int,
           spans_ms: Dict[str, float]) -> Dict[str, dict]:
    """Join measured span times with the model; returns a JSON-able dict
    (``roofline_frac`` = bound / measured, at most 1)."""
    out = {}
    for name, b in prove_bounds(params, log_rows, width, num_interactions).items():
        entry = {
            "hbm_mb": round(b.hbm_bytes / 1e6, 1),
            "mul_gops": round(b.muls / 1e9, 2),
            "other_gops": round(b.others / 1e9, 2),
            "bound": b.bound,
            "min_ms": round(b.min_ms, 3),
        }
        measured = spans_ms.get(name)
        if measured is not None:
            entry["measured_ms"] = round(measured, 1)
            entry["roofline_frac"] = round(b.min_ms / max(measured, 1e-9), 4)
        out[name] = entry
    return out
