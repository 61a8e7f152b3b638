"""Standalone "plain" sumcheck provers over a single multilinear /
prismalinear polynomial (cf. reference ``prover/sumcheck.rs:431,510``).

Peer of ``swirl/prover/plain_sumcheck.py``. ``sumcheck_multilinear`` proves
sum_{x in H_n} f(x) given hypercube evaluations; ``sumcheck_prismalinear``
applies Gruen's univariate skip for the first l_skip variables. The provers
fold (2^n, 4) EF tensors on their device and read each round's value back
to the host transcript once a round; the verifiers are host numpy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from .. import poly as hpoly
from .. import tpoly
from ..fields import ext as hext
from ..fields import field as F
from ..transcript import Transcript
from .errors import SumcheckError
from .sumcheck import fold_mle, fold_ple


@dataclass
class SumcheckCubeProof:
    sum_claim: np.ndarray
    round_polys_eval: List[List[np.ndarray]]  # per round, evals at {1}
    eval_claim: np.ndarray


@dataclass
class SumcheckPrismProof:
    sum_claim: np.ndarray
    s0_coeffs: List[np.ndarray]
    round_polys_eval: List[List[np.ndarray]]
    eval_claim: np.ndarray


def _mle_rounds(transcript: Transcript, cur, n: int, r: List[np.ndarray]):
    """The n multilinear rounds on ``cur``: observe s(1), the sum of the
    odd entries (s(0) the verifier infers), sample r_i and fold."""
    round_polys = []
    for _ in range(n):
        s1 = F.to_host(F.ext_sum(cur[1::2], axis=0))
        transcript.observe_ext(s1)
        round_polys.append([s1])
        r_i = transcript.sample_ext()
        r.append(r_i)
        cur = fold_mle(cur, F.const_arr(r_i, cur.device))
    eval_claim = F.to_host(cur[0])
    transcript.observe_ext(eval_claim)
    return round_polys, eval_claim


def sumcheck_multilinear(
    transcript: Transcript, evals
) -> Tuple[SumcheckCubeProof, List[np.ndarray]]:
    """evals: (2^n, 4) EF hypercube evaluations on their device."""
    n = int(evals.shape[0]).bit_length() - 1
    sum_claim = F.to_host(F.ext_sum(evals, axis=0))
    transcript.observe_ext(sum_claim)
    r: List[np.ndarray] = []
    round_polys, eval_claim = _mle_rounds(transcript, evals, n, r)
    return SumcheckCubeProof(sum_claim, round_polys, eval_claim), r


def verify_sumcheck_multilinear(
    transcript: Transcript, proof: SumcheckCubeProof, n: int
) -> List[np.ndarray]:
    """Replays the transcript and checks round consistency; returns r."""
    transcript.observe_ext(proof.sum_claim)
    claim = proof.sum_claim
    r = []
    for rnd in range(n):
        (s1,) = proof.round_polys_eval[rnd]
        transcript.observe_ext(s1)
        r_i = transcript.sample_ext()
        r.append(r_i)
        s0 = hext.esub(claim, s1)
        claim = hpoly.interpolate_linear_at_01([s0, s1], r_i)
    if not hext.eeq(claim, proof.eval_claim):
        raise SumcheckError("sumcheck final claim mismatch")
    transcript.observe_ext(proof.eval_claim)
    return r


def sumcheck_prismalinear(
    transcript: Transcript, l_skip: int, evals
) -> Tuple[SumcheckPrismProof, List[np.ndarray]]:
    """evals: (2^{l_skip+n}, 4) EF prism evaluations on their device."""
    total = int(evals.shape[0]).bit_length() - 1
    n = total - l_skip
    sum_claim = F.to_host(F.ext_sum(evals, axis=0))
    transcript.observe_ext(sum_claim)

    # univariate round 0: s0(Z) = sum_x f(Z, x); for a prismalinear f this is
    # degree < 2^l_skip, recoverable by iDFT of the per-z sums over x.
    per_z = F.ext_sum(evals.reshape(-1, 1 << l_skip, 4), axis=0)  # (2^l, 4)
    s0_coeffs = hpoly.idft_ef(F.to_host(per_z))
    for c in s0_coeffs:
        transcript.observe_ext(c)
    r0 = transcript.sample_ext()
    r = [r0]
    weights = tpoly.barycentric_weights(l_skip, F.const_arr(r0, evals.device))
    cur = fold_ple(evals.reshape(1, -1, 4), l_skip, False, weights)[0]
    round_polys, eval_claim = _mle_rounds(transcript, cur, n, r)
    return (
        SumcheckPrismProof(sum_claim, [c for c in s0_coeffs], round_polys, eval_claim),
        r,
    )


def verify_sumcheck_prismalinear(
    transcript: Transcript, proof: SumcheckPrismProof, l_skip: int, n: int
) -> List[np.ndarray]:
    transcript.observe_ext(proof.sum_claim)
    s0 = np.stack(proof.s0_coeffs)
    total = hpoly.sum_over_subgroup_from_coeffs(s0, l_skip)
    if not hext.eeq(total, proof.sum_claim):
        raise SumcheckError("prism sumcheck s0 sum mismatch")
    for c in proof.s0_coeffs:
        transcript.observe_ext(c)
    r0 = transcript.sample_ext()
    r = [r0]
    claim = hpoly.horner_eval(s0, r0)
    for rnd in range(n):
        (s1,) = proof.round_polys_eval[rnd]
        transcript.observe_ext(s1)
        r_i = transcript.sample_ext()
        r.append(r_i)
        s_at_0 = hext.esub(claim, s1)
        claim = hpoly.interpolate_linear_at_01([s_at_0, s1], r_i)
    if not hext.eeq(claim, proof.eval_claim):
        raise SumcheckError("prism sumcheck final claim mismatch")
    transcript.observe_ext(proof.eval_claim)
    return r
