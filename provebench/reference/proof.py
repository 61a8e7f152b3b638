"""Proof containers (host-side, canonical numpy values).

Field layout mirrors the reference proof struct
(``crates/stark-backend/src/proof.rs``): commitment + per-AIR trace vdata +
public values + the four protocol sub-proofs. EF values are (4,) uint64
arrays; digests are (8,) uint64 arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

EFVal = np.ndarray  # (4,)
Digest = np.ndarray  # (8,)


@dataclass
class TraceVData:
    log_height: int
    cached_commitments: List[Digest]


@dataclass
class GkrLayerClaims:
    p_xi_0: EFVal
    p_xi_1: EFVal
    q_xi_0: EFVal
    q_xi_1: EFVal


@dataclass
class GkrProof:
    logup_pow_witness: int
    q0_claim: EFVal
    claims_per_layer: List[GkrLayerClaims]
    # per layer > 1, per sumcheck round: evals at {1, 2, 3}
    sumcheck_polys: List[List[List[EFVal]]]


@dataclass
class BatchConstraintProof:
    numerator_term_per_air: List[EFVal]
    denominator_term_per_air: List[EFVal]
    univariate_round_coeffs: List[EFVal]  # len (d+1)(2^l_skip - 1) + 1
    sumcheck_round_polys: List[List[EFVal]]  # n_max rounds, evals at 1..=d+1
    # per present AIR, per part [common, prep?, cached...], flat col openings
    column_openings: List[List[List[EFVal]]]


@dataclass
class StackingProof:
    univariate_round_coeffs: List[EFVal]  # len 2(2^l_skip - 1) + 1
    sumcheck_round_polys: List[List[EFVal]]  # n_stack rounds, evals at {1,2}
    stacking_openings: List[List[EFVal]]  # per commit, per stacked column


@dataclass
class WhirProof:
    mu_pow_witness: int
    whir_sumcheck_polys: List[List[EFVal]]  # flattened rounds, evals at {1,2}
    codeword_commits: List[Digest]
    ood_values: List[EFVal]
    folding_pow_witnesses: List[int]
    query_phase_pow_witnesses: List[int]
    # initial round: per commit, per query, (2^k rows) x width base values
    initial_round_opened_rows: List[List[np.ndarray]]
    initial_round_merkle_proofs: List[List[List[Digest]]]
    # later rounds: per round, per query, (2^k,) EF values
    codeword_opened_values: List[List[np.ndarray]]
    codeword_merkle_proofs: List[List[List[Digest]]]
    final_poly: List[EFVal]


@dataclass
class Proof:
    common_main_commit: Digest
    trace_vdata: List[Optional[TraceVData]]
    public_values: List[List[int]]
    gkr_proof: GkrProof
    batch_constraint_proof: BatchConstraintProof
    stacking_proof: StackingProof
    whir_proof: WhirProof


def column_openings_by_rot(openings: List[EFVal], need_rot: bool):
    """Yield (claim, rot_claim) pairs; rot is zero when absent."""
    if need_rot:
        for i in range(0, len(openings), 2):
            yield openings[i], openings[i + 1]
    else:
        zero = np.zeros(4, dtype=np.uint64)
        for op in openings:
            yield op, zero
