"""Zerocheck + LogUp batch-constraint verifier (host).

Cf. reference ``crates/stark-backend/src/verifier/batch_constraints.rs``:
replays the GKR reduction, the univariate-skip round and the multilinear
sumcheck rounds, then evaluates every AIR's symbolic DAG at the claimed
column openings and checks the final batched claim.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..fields import ext
from ..fields.babybear import P, U64, finv, two_adic_generator
from ..params import calculate_n_logup
from ..proof import BatchConstraintProof, GkrProof, column_openings_by_rot
from ..symbolic import ConstraintsDag
from ..transcript import Transcript
from .. import poly as hpoly
from ..prover.dag_eval import HostEvaluator, eval_nodes
from .gkr import GkrError, verify_gkr
from .errors import (
    BatchConstraintError,
    GkrDenominatorMismatch,
    GkrNumeratorMismatch,
    GkrQ0NotOne,
    InconsistentClaims,
    InvalidLogupPowWitness,
    RoundPolyEvalCountMismatch,
    SumClaimMismatch,
    UnivariateCoeffCountMismatch,
)

__all__ = ["BatchConstraintError", "verify_zerocheck_and_logup"]


def _progression_exp_2(m: np.ndarray, l: int) -> np.ndarray:
    """1 + m + m^2 + ... + m^{2^l - 1} via (1+m)(1+m^2)(1+m^4)..."""
    acc = ext.eone()
    pw = m
    for _ in range(l):
        acc = ext.emul(acc, ext.eadd(ext.eone(), pw))
        pw = ext.emul(pw, pw)
    return acc


def verifier_selectors(rs: List[np.ndarray], l_skip: int):
    """(is_first, is_last) at the opening point (cf. reference
    ``verifier/evaluator.rs:37``)."""
    omega = two_adic_generator(l_skip)
    inv = finv(pow(2, l_skip, P))
    prod0 = ext.eone()
    prod1 = ext.eone()
    for x in rs[1:]:
        prod0 = ext.emul(prod0, ext.esub(ext.eone(), x))
        prod1 = ext.emul(prod1, x)
    is_first = ext.escale(
        ext.emul(_progression_exp_2(rs[0], l_skip), prod0), inv
    )
    is_last = ext.escale(
        ext.emul(_progression_exp_2(ext.escale(rs[0], omega), l_skip), prod1), inv
    )
    return is_first, is_last


def verify_zerocheck_and_logup(
    transcript: Transcript,
    params,
    per_air_vks,
    public_values: List[List[int]],
    gkr_proof: GkrProof,
    batch_proof: BatchConstraintProof,
    trace_id_to_air_id: List[int],
    n_per_trace: List[int],
) -> List[np.ndarray]:
    l_skip = params.l_skip
    num_traces = len(trace_id_to_air_id)
    ONE = ext.eone()
    ZERO = ext.ezero()

    if not transcript.check_witness(
        params.logup.pow_bits, gkr_proof.logup_pow_witness
    ):
        raise InvalidLogupPowWitness()

    alpha = transcript.sample_ext()
    beta = transcript.sample_ext()

    total_interactions = 0
    for t_idx, air_id in enumerate(trace_id_to_air_id):
        n_lift = max(n_per_trace[t_idx], 0)
        num_int = len(per_air_vks[air_id].symbolic_constraints.interactions)
        total_interactions += num_int << (l_skip + n_lift)
    n_logup = calculate_n_logup(l_skip, total_interactions)

    xi: List[np.ndarray] = []
    p_xi_claim = ZERO
    q_xi_claim = alpha
    if total_interactions > 0:
        p_xi_claim, q_xi_claim, xi = verify_gkr(
            gkr_proof, transcript, l_skip + n_logup
        )
    elif not ext.eeq(gkr_proof.q0_claim, ONE):
        raise GkrQ0NotOne()

    n_max = max(max(n_per_trace), 0)
    n_global = max(n_max, n_logup)
    while len(xi) != l_skip + n_global:
        xi.append(transcript.sample_ext())

    lam = transcript.sample_ext()

    for p_term, q_term in zip(
        batch_proof.numerator_term_per_air, batch_proof.denominator_term_per_air
    ):
        p_xi_claim = ext.esub(p_xi_claim, p_term)
        q_xi_claim = ext.esub(q_xi_claim, q_term)
        transcript.observe_ext(p_term)
        transcript.observe_ext(q_term)
    if not ext.is_zero(p_xi_claim):
        raise GkrNumeratorMismatch()
    if not ext.eeq(q_xi_claim, alpha):
        raise GkrDenominatorMismatch()

    mu = transcript.sample_ext()
    sum_claim = ZERO
    cur = ONE
    for p_term, q_term in zip(
        batch_proof.numerator_term_per_air, batch_proof.denominator_term_per_air
    ):
        sum_claim = ext.eadd(sum_claim, ext.emul(p_term, cur))
        cur = ext.emul(cur, mu)
        sum_claim = ext.eadd(sum_claim, ext.emul(q_term, cur))
        cur = ext.emul(cur, mu)

    for c in batch_proof.univariate_round_coeffs:
        transcript.observe_ext(c)

    d_global = params.max_constraint_degree
    s_deg = d_global + 1
    expected_len = s_deg * ((1 << l_skip) - 1) + 1
    if len(batch_proof.univariate_round_coeffs) != expected_len:
        raise UnivariateCoeffCountMismatch(
            expected=expected_len, actual=len(batch_proof.univariate_round_coeffs)
        )
    r0 = transcript.sample_ext()
    s0 = np.stack(batch_proof.univariate_round_coeffs)
    sum_check = hpoly.sum_over_subgroup_from_coeffs(s0, l_skip)
    if not ext.eeq(sum_claim, sum_check):
        raise SumClaimMismatch(round=0)
    cur_sum = hpoly.horner_eval(s0, r0)
    rs = [r0]

    for rnd in range(n_max):
        evals = batch_proof.sumcheck_round_polys[rnd]
        if len(evals) != s_deg:
            raise RoundPolyEvalCountMismatch(round=rnd, expected=s_deg, actual=len(evals))
        for e in evals:
            transcript.observe_ext(e)
        s_at_0 = ext.esub(cur_sum, evals[0])
        all_evals = np.stack([s_at_0] + list(evals))
        r = transcript.sample_ext()
        cur_sum = hpoly.lagrange_interpolate_at_integers(all_evals, r)
        rs.append(r)

    # eq_3b per trace
    stacked_idx = 0
    eq_3b_per_trace: List[np.ndarray] = []
    for t_idx, air_id in enumerate(trace_id_to_air_id):
        interactions = per_air_vks[air_id].symbolic_constraints.interactions
        if not interactions:
            eq_3b_per_trace.append(np.zeros((0, 4), dtype=U64))
            continue
        n_lift = max(n_per_trace[t_idx], 0)
        rows = []
        for _ in interactions:
            b_int = stacked_idx >> (l_skip + n_lift)
            bits = (
                np.stack(
                    [
                        ext.from_base((b_int >> j) & 1)
                        for j in range(n_logup - n_lift)
                    ]
                )
                if n_logup > n_lift
                else np.zeros((0, 4), dtype=U64)
            )
            xi_seg = (
                np.stack(xi[l_skip + n_lift : l_skip + n_logup])
                if n_logup > n_lift
                else np.zeros((0, 4), dtype=U64)
            )
            stacked_idx += 1 << (l_skip + n_lift)
            rows.append(hpoly.eval_eq_mle(xi_seg, bits))
        eq_3b_per_trace.append(np.stack(rows))

    # eq_ns, eq_sharp_ns with front-loaded-batching r products
    eq_ns = [ONE] * (n_max + 1)
    eq_sharp_ns = [ONE] * (n_max + 1)
    eq_ns[0] = hpoly.eval_eq_uni(l_skip, xi[0], r0)
    eq_sharp_ns[0] = hpoly.eval_eq_sharp_uni(l_skip, np.stack(xi[:l_skip]), r0)
    for i in range(1, n_max + 1):
        eq_mle = hpoly.eval_eq_mle(
            xi[l_skip + i - 1].reshape(1, 4), rs[i].reshape(1, 4)
        )
        eq_ns[i] = ext.emul(eq_ns[i - 1], eq_mle)
        eq_sharp_ns[i] = ext.emul(eq_sharp_ns[i - 1], eq_mle)
    r_rev = rs[n_max]
    for i in range(n_max - 1, -1, -1):
        eq_ns[i] = ext.emul(eq_ns[i], r_rev)
        eq_sharp_ns[i] = ext.emul(eq_sharp_ns[i], r_rev)
        r_rev = ext.emul(r_rev, rs[i])

    # observe openings: common-main parts first
    need_rot_per_trace = [
        per_air_vks[air_id].params.need_rot for air_id in trace_id_to_air_id
    ]
    for t_idx, air_openings in enumerate(batch_proof.column_openings):
        for claim, claim_rot in column_openings_by_rot(
            air_openings[0], need_rot_per_trace[t_idx]
        ):
            transcript.observe_ext(claim)
            transcript.observe_ext(claim_rot)

    interactions_evals: List[np.ndarray] = []
    constraints_evals: List[np.ndarray] = []
    for t_idx, air_openings in enumerate(batch_proof.column_openings):
        air_id = trace_id_to_air_id[t_idx]
        vk = per_air_vks[air_id]
        n = n_per_trace[t_idx]
        n_lift = max(n, 0)
        need_rot = need_rot_per_trace[t_idx]

        for claims in air_openings[1:]:
            for claim, claim_rot in column_openings_by_rot(claims, need_rot):
                transcript.observe_ext(claim)
                transcript.observe_ext(claim_rot)

        has_prep = vk.preprocessed_data is not None
        common = list(column_openings_by_rot(air_openings[0], need_rot))
        prep = (
            list(column_openings_by_rot(air_openings[1], need_rot))
            if has_prep
            else None
        )
        cached_start = 1 + (1 if has_prep else 0)
        partitioned = [
            list(column_openings_by_rot(op, need_rot))
            for op in air_openings[cached_start:]
        ]
        partitioned.append(common)

        if n < 0:
            l_eff = l_skip + n
            rs_n = [ext.epow(rs[0], 1 << (-n))]
            norm = finv(1 << (-n))
        else:
            l_eff = l_skip
            rs_n = rs[: n + 1]
            norm = 1

        is_first, is_last = verifier_selectors(rs_n, l_eff)
        is_transition = ext.esub(ONE, is_last)
        hev = HostEvaluator(
            (is_first, is_transition, is_last),
            prep,
            partitioned,
            public_values[air_id],
        )
        dag: ConstraintsDag = vk.symbolic_constraints
        nodes = eval_nodes(dag, hev)
        expr = ZERO
        lam_pow = ONE
        for idx in dag.constraint_idx:
            expr = ext.eadd(expr, ext.emul(nodes[idx], lam_pow))
            lam_pow = ext.emul(lam_pow, lam)
        constraints_evals.append(ext.emul(eq_ns[n_lift], expr))

        num = ZERO
        den = ZERO
        beta_pows = ext.epowers(
            beta,
            max((len(it.message) for it in dag.interactions), default=0) + 1,
        )
        for s_idx, it in enumerate(dag.interactions):
            count = nodes[it.count]
            h_beta = ext.escale(
                beta_pows[len(it.message)], (it.bus_index + 1) % P
            )
            for j, m_idx in enumerate(it.message):
                h_beta = ext.eadd(h_beta, ext.emul(beta_pows[j], nodes[m_idx]))
            eq3b = eq_3b_per_trace[t_idx][s_idx]
            num = ext.eadd(num, ext.emul(eq3b, count))
            den = ext.eadd(den, ext.emul(eq3b, h_beta))
        interactions_evals.append(
            ext.escale(ext.emul(num, eq_sharp_ns[n_lift]), norm)
        )
        interactions_evals.append(ext.emul(den, eq_sharp_ns[n_lift]))

    evaluated = ZERO
    cur = ONE
    for v in interactions_evals + constraints_evals:
        evaluated = ext.eadd(evaluated, ext.emul(v, cur))
        cur = ext.emul(cur, mu)
    if not ext.eeq(cur_sum, evaluated):
        raise InconsistentClaims()

    return rs
