"""LogUp fractional sumcheck via a GKR layered circuit, on torch tensors.

Peer of ``swirl/prover/gkr.py`` (``fractional_sumcheck`` :480): the
fraction segment tree (projective fraction addition of pairs,
``_combine_layer_impl`` :418), then per layer a degree-3 sumcheck over
eq(xi, Y) * (p0*q1 + p1*q0 + lambda*q0*q1) with round evaluations at X in
{1, 2, 3} (``_gkr_round_evals`` :58) and folds (``_gkr_fold`` :82). All
MLEs stay in natural index order: the logical pair (2i, 2i+1) is a
stride-2 split.

Every value stays on the device: the round evaluations, the challenges and
the layer claims. On a :class:`~.device_transcript.DeviceTranscript` (the
device path, ``gkr.py:531-680``) a sub-round is one sponge launch between
its evaluation and its fold, and the stage reads the host twice: the
root's zero check, and one copy of every round polynomial, claim and the
challenge point at the end. :func:`fractional_sumcheck_deferred` leaves
both to its caller: the fused prover reads them with the whole proof. On a
host transcript each observe reads its value first.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..fields import ext as hext
from ..proof import GkrLayerClaims
from ..fields import field as F
from .deferred import Deferred
from .device_transcript import device_view
from .sumcheck import eq_hypercube, fold_mle, interp_mle_at_int


def _pairs(col):
    return col[0::2], col[1::2]


def _round_evals(cols, lam):
    """Degree-3 round polynomial at X in {1, 2, 3}: cols are the five (m, 4)
    MLEs [eq, p0, q0, p1, q1]; returns a (3, 4) tensor."""
    out = []
    for x in (1, 2, 3):
        e, a0, b0, a1, b1 = (interp_mle_at_int(c, x) for c in cols)
        p_prev = F.add(F.ext_mul(a0, b1), F.ext_mul(a1, b0))
        q_prev = F.ext_mul(b0, b1)
        val = F.ext_mul(e, F.add(p_prev, F.ext_mul(lam, q_prev)))
        out.append(F.ext_sum(val, axis=0))
    return torch.stack(out)


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
    xi: Optional[torch.Tensor]  # (t, 4) on the input's device; None without input


def _claims(c) -> GkrLayerClaims:
    """A layer's claims from their (4, 4) observe order p0, q0, p1, q1."""
    return GkrLayerClaims(p_xi_0=c[0], q_xi_0=c[1], p_xi_1=c[2], q_xi_1=c[3])


def fractional_sumcheck(
    transcript, p_evals, q_evals, assert_zero: bool = True
) -> FracSumcheckResult:
    """p_evals, q_evals: (2^t, 4) EF tensors, or None when there are no
    interactions. ``transcript``: a host :class:`Transcript` or a
    :class:`~.device_transcript.DeviceTranscript` on their device. Reads the
    root's numerator for the zero check first, then the proof values once."""
    pending, xi = fractional_sumcheck_deferred(transcript, p_evals, q_evals, assert_zero, check_now=True)
    result = pending.fetch()
    result.xi = xi
    return result


def fractional_sumcheck_deferred(
    transcript, p_evals, q_evals, assert_zero: bool = True, check_now: bool = False
) -> Tuple[Deferred, Optional[torch.Tensor]]:
    """The sumcheck with its proof values left on the device: (a
    :class:`~.deferred.Deferred` of the result without ``xi``, xi). With
    ``assert_zero`` the root's numerator is not observed but checked: read
    at once with ``check_now``, else in the build, after the fetch (the
    fused prover's one copy)."""
    if p_evals is None:
        return Deferred([], lambda host: FracSumcheckResult((hext.ezero(), hext.eone()), [], [], None)), None
    total_rounds = int(p_evals.shape[0]).bit_length() - 1
    assert p_evals.shape[0] == 1 << total_rounds
    device = p_evals.device
    tr = device_view(transcript, device)

    layers = [(p_evals, q_evals)]  # layers[total] = input ... layers[0] = root
    while layers[-1][0].shape[0] > 1:
        layers.append(_combine_layer(*layers[-1]))
    layers.reverse()

    # what is observed is kept for the proof: on the device, or the host
    # copy that a host transcript read to observe it
    root_p, root_q = (x[0] for x in layers[0])
    if assert_zero:
        if check_now:
            root_p = F.to_host(root_p)
            if root_p.any():
                raise ValueError("LogUp fractional sum is non-zero")
    else:
        root_p = tr.observe_ext(root_p)
    root_q = tr.observe_ext(root_q)

    p1, q1 = layers[1]
    claims = [tr.observe_slice(torch.stack([p1[0], q1[0], p1[1], q1[1]]))]
    xi = tr.sample_ext()[None]

    polys = []  # (3, 4) per sub-round, layer after layer
    for rnd in range(1, total_rounds):
        lam = tr.sample_ext()
        p0, p1v = _pairs(layers[rnd + 1][0])
        q0, q1v = _pairs(layers[rnd + 1][1])
        cols = [eq_hypercube(xi, device), p0, q0, p1v, q1v]
        del xi  # in the eq table now; not live at the layer's peak
        rho = []
        for _ in range(rnd):
            polys.append(tr.observe_slice(_round_evals(cols, lam)))
            r = tr.sample_ext()
            rho.append(r)
            cols = [fold_mle(c, r) for c in cols]
        claims.append(tr.observe_slice(torch.stack([c[0] for c in cols[1:]])))
        xi = torch.cat([tr.sample_ext()[None], torch.stack(rho)])

    n_claims = len(claims)

    def build(host):
        root_p, root_q, *rest = host
        if assert_zero and np.asarray(root_p).any():
            raise ValueError("LogUp fractional sum is non-zero")
        claims_h, polys_h = rest[:n_claims], rest[n_claims:]
        sumcheck_polys, off = [], 0
        for rnd in range(1, total_rounds):
            sumcheck_polys.append([list(e) for e in polys_h[off : off + rnd]])
            off += rnd
        return FracSumcheckResult(
            fractional_sum=(np.asarray(root_p), root_q),
            claims_per_layer=[_claims(c) for c in claims_h],
            sumcheck_polys=sumcheck_polys,
            xi=None,
        )

    return Deferred([root_p, root_q, *claims, *polys], build), xi
