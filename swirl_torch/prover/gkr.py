"""LogUp fractional sumcheck via a GKR layered circuit, on torch tensors.

Peer of the host-transcript path of ``swirl/prover/gkr.py``
(``fractional_sumcheck`` :480): the fraction segment tree (projective
fraction addition of pairs, ``_combine_layer_impl`` :418), then per layer a
degree-3 sumcheck over eq(xi, Y) * (p0*q1 + p1*q0 + lambda*q0*q1) with
round evaluations at X in {1, 2, 3} (``_gkr_round_evals`` :58) and folds
(``_gkr_fold`` :82). All MLEs stay in natural index order: the logical pair
(2i, 2i+1) is a stride-2 split.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from ..fields import ext as hext
from ..proof import GkrLayerClaims
from ..transcript import Transcript

from ..fields import field as F
from .sumcheck import ef_dev, eq_hypercube, fold_mle, interp_mle_at_int


def _pairs(col):
    return col[0::2], col[1::2]


def _round_evals(cols, lam):
    """Degree-3 round polynomial at X in {1, 2, 3}: cols are the five (m, 4)
    MLEs [eq, p0, q0, p1, q1]; returns three host EF values."""
    out = []
    for x in (1, 2, 3):
        e, a0, b0, a1, b1 = (interp_mle_at_int(c, x) for c in cols)
        p_prev = F.add(F.ext_mul(a0, b1), F.ext_mul(a1, b0))
        q_prev = F.ext_mul(b0, b1)
        val = F.ext_mul(e, F.add(p_prev, F.ext_mul(lam, q_prev)))
        out.append(F.ext_sum(val, axis=0))
    return list(F.to_host(torch.stack(out)))


def _combine_layer(p, q):
    """(2^t, 4) -> (2^(t-1), 4): p0*q1 + p1*q0 over q0*q1 for each pair."""
    p0, p1 = _pairs(p)
    q0, q1 = _pairs(q)
    return F.add(F.ext_mul(p0, q1), F.ext_mul(p1, q0)), F.ext_mul(q0, q1)


@dataclass
class FracSumcheckResult:
    fractional_sum: Tuple[np.ndarray, np.ndarray]  # (p, q) host EF
    claims_per_layer: List[GkrLayerClaims]
    sumcheck_polys: List[List[List[np.ndarray]]]
    xi: List[np.ndarray]


def fractional_sumcheck(
    transcript: Transcript, p_evals, q_evals, assert_zero: bool = True
) -> FracSumcheckResult:
    """p_evals, q_evals: (2^t, 4) EF tensors, or None when there are no
    interactions."""
    if p_evals is None:
        return FracSumcheckResult((hext.ezero(), hext.eone()), [], [], [])
    total_rounds = int(p_evals.shape[0]).bit_length() - 1
    assert p_evals.shape[0] == 1 << total_rounds
    device = p_evals.device

    layers = [(p_evals, q_evals)]  # layers[total] = input ... layers[0] = root
    while layers[-1][0].shape[0] > 1:
        layers.append(_combine_layer(*layers[-1]))
    layers.reverse()

    root_p, root_q = (F.to_host(x[0]) for x in layers[0])
    if assert_zero:
        if not hext.is_zero(root_p):
            raise ValueError("LogUp fractional sum is non-zero")
    else:
        transcript.observe_ext(root_p)
    transcript.observe_ext(root_q)

    p1, q1 = (F.to_host(x[:2]) for x in layers[1])
    cl = GkrLayerClaims(p_xi_0=p1[0], p_xi_1=p1[1], q_xi_0=q1[0], q_xi_1=q1[1])
    claims = [cl]
    for c in (cl.p_xi_0, cl.q_xi_0, cl.p_xi_1, cl.q_xi_1):
        transcript.observe_ext(c)
    xi_prev = [transcript.sample_ext()]

    sumcheck_polys: List[List[List[np.ndarray]]] = []
    for rnd in range(1, total_rounds):
        lam = ef_dev(transcript.sample_ext(), device)
        p_next, q_next = layers[rnd + 1]
        p0, p1v = _pairs(p_next)
        q0, q1v = _pairs(q_next)
        cols = [eq_hypercube(np.stack(xi_prev), device), p0, q0, p1v, q1v]
        round_polys = []
        rho = []
        for _ in range(rnd):
            evals_at = _round_evals(cols, lam)
            for c in evals_at:
                transcript.observe_ext(c)
            round_polys.append(evals_at)
            r_sub = transcript.sample_ext()
            rho.append(r_sub)
            r_dev = ef_dev(r_sub, device)
            cols = [fold_mle(c, r_dev) for c in cols]
        last = F.to_host(torch.stack([c[0] for c in cols[1:]]))
        cl = GkrLayerClaims(p_xi_0=last[0], q_xi_0=last[1], p_xi_1=last[2], q_xi_1=last[3])
        claims.append(cl)
        for c in (cl.p_xi_0, cl.q_xi_0, cl.p_xi_1, cl.q_xi_1):
            transcript.observe_ext(c)
        xi_prev = [transcript.sample_ext()] + rho
        sumcheck_polys.append(round_polys)

    return FracSumcheckResult(
        fractional_sum=(root_p, root_q),
        claims_per_layer=claims,
        sumcheck_polys=sumcheck_polys,
        xi=xi_prev,
    )
