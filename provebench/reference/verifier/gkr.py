"""GKR fractional-sumcheck verifier (host).

Cf. reference ``crates/stark-backend/src/verifier/fractional_sumcheck_gkr.rs``.
Reduces sum p/q = 0 over the hypercube to input-layer claims p(xi), q(xi).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..fields import ext
from ..proof import GkrProof
from ..transcript import Transcript
from ..poly import interpolate_cubic_at_0123, interpolate_linear_at_01
from .errors import (
    GkrError,
    GkrIncorrectLayerCount,
    GkrIncorrectSubroundCount,
    GkrIncorrectSumcheckPolyCount,
    GkrLayerConsistencyFailed,
    GkrRootConsistencyFailed,
    GkrZeroCheckFailed,
)

__all__ = ["GkrError", "verify_gkr"]


def verify_gkr(
    proof: GkrProof, transcript: Transcript, total_rounds: int
) -> Tuple[np.ndarray, np.ndarray, List[np.ndarray]]:
    assert total_rounds > 0
    if len(proof.claims_per_layer) != total_rounds:
        raise GkrIncorrectLayerCount(
            expected=total_rounds, actual=len(proof.claims_per_layer)
        )
    if len(proof.sumcheck_polys) != total_rounds - 1:
        raise GkrIncorrectSumcheckPolyCount(
            expected=total_rounds - 1, actual=len(proof.sumcheck_polys)
        )

    transcript.observe_ext(proof.q0_claim)

    claims = proof.claims_per_layer[0]
    for v in (claims.p_xi_0, claims.q_xi_0, claims.p_xi_1, claims.q_xi_1):
        transcript.observe_ext(v)

    p_cross = ext.eadd(
        ext.emul(claims.p_xi_0, claims.q_xi_1), ext.emul(claims.p_xi_1, claims.q_xi_0)
    )
    q_cross = ext.emul(claims.q_xi_0, claims.q_xi_1)
    if not ext.is_zero(p_cross):
        raise GkrZeroCheckFailed()
    if not ext.eeq(q_cross, proof.q0_claim):
        raise GkrRootConsistencyFailed()

    mu = transcript.sample_ext()
    numer_claim = interpolate_linear_at_01([claims.p_xi_0, claims.p_xi_1], mu)
    denom_claim = interpolate_linear_at_01([claims.q_xi_0, claims.q_xi_1], mu)
    gkr_r = [mu]

    for rnd in range(1, total_rounds):
        lam = transcript.sample_ext()
        claim = ext.eadd(numer_claim, ext.emul(lam, denom_claim))

        polys = proof.sumcheck_polys[rnd - 1]
        if len(polys) != rnd:
            raise GkrIncorrectSubroundCount(
                round=rnd, expected=rnd, actual=len(polys)
            )
        r_prime: List[np.ndarray] = []
        eq = ext.eone()
        for sub, evals in enumerate(polys):
            for e in evals:
                transcript.observe_ext(e)
            ri = transcript.sample_ext()
            r_prime.append(ri)
            ev0 = ext.esub(claim, evals[0])
            claim = interpolate_cubic_at_0123(
                [ev0, evals[0], evals[1], evals[2]], ri
            )
            xi = gkr_r[sub]
            eq = ext.emul(
                eq,
                ext.eadd(
                    ext.emul(xi, ri),
                    ext.emul(ext.esub(ext.eone(), xi), ext.esub(ext.eone(), ri)),
                ),
            )

        claims = proof.claims_per_layer[rnd]
        for v in (claims.p_xi_0, claims.q_xi_0, claims.p_xi_1, claims.q_xi_1):
            transcript.observe_ext(v)
        p_cross = ext.eadd(
            ext.emul(claims.p_xi_0, claims.q_xi_1),
            ext.emul(claims.p_xi_1, claims.q_xi_0),
        )
        q_cross = ext.emul(claims.q_xi_0, claims.q_xi_1)
        expected = ext.emul(ext.eadd(p_cross, ext.emul(lam, q_cross)), eq)
        if not ext.eeq(expected, claim):
            raise GkrLayerConsistencyFailed(round=rnd)

        mu = transcript.sample_ext()
        numer_claim = interpolate_linear_at_01([claims.p_xi_0, claims.p_xi_1], mu)
        denom_claim = interpolate_linear_at_01([claims.q_xi_0, claims.q_xi_1], mu)
        gkr_r = [mu] + r_prime

    return numer_claim, denom_claim, gkr_r
