"""Stacked-reduction verifier (host).

Cf. reference ``crates/stark-backend/src/verifier/stacked_reduction.rs``:
re-batches the column opening claims with lambda, replays the univariate +
multilinear sumcheck rounds, and checks the final claim against the stacked
openings weighted by the prism eq/rotation kernels and layout bits.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..fields import ext
from ..fields.babybear import P, U64, finv
from ..proof import StackingProof, column_openings_by_rot
from ..transcript import Transcript
from .. import poly as hpoly


from .errors import FinalSumMismatch, S0Mismatch, StackedReductionError

__all__ = ["StackedReductionError", "verify_stacked_reduction"]


def verify_stacked_reduction(
    transcript: Transcript,
    proof: StackingProof,
    layouts,  # per commit StackedLayout
    need_rot_per_commit: List[List[bool]],
    l_skip: int,
    n_stack: int,
    column_openings,
    r: List[np.ndarray],
) -> List[np.ndarray]:
    ONE = ext.eone()
    ZERO = ext.ezero()
    omega_order = 1 << l_skip

    # lambda slot indices in layout order
    lambda_indices_per_layout = []
    lam_idx = 0
    for commit_idx, layout in enumerate(layouts):
        need_rot = need_rot_per_commit[commit_idx]
        rows = []
        for mat_idx, _c, _s in layout.sorted_cols:
            rows.append((lam_idx, need_rot[mat_idx]))
            lam_idx += 1
        lambda_indices_per_layout.append(rows)
    t_claims_len = lam_idx

    # flatten opening claims in the same order the prover batches them
    t_claims = []
    for t_idx, parts in enumerate(column_openings):
        need_rot = need_rot_per_commit[0][t_idx]
        t_claims.extend(column_openings_by_rot(parts[0], need_rot))
    commit_idx = 1
    for parts in column_openings:
        for cols in parts[1:]:
            need_rot = need_rot_per_commit[commit_idx][0]
            t_claims.extend(column_openings_by_rot(cols, need_rot))
            commit_idx += 1
    assert len(t_claims) == t_claims_len

    lam = transcript.sample_ext()
    lam_sqr = ext.emul(lam, lam)
    lam_sqr_pows = ext.epowers(lam_sqr, max(t_claims_len, 1))

    s_0 = ZERO
    for (t_i, t_rot), lp in zip(t_claims, lam_sqr_pows):
        s_0 = ext.eadd(s_0, ext.emul(ext.eadd(t_i, ext.emul(t_rot, lam)), lp))

    coeffs = np.stack(proof.univariate_round_coeffs)
    s_0_sum = hpoly.sum_over_subgroup_from_coeffs(coeffs, l_skip)
    if not ext.eeq(s_0, s_0_sum):
        raise S0Mismatch()

    for c in proof.univariate_round_coeffs:
        transcript.observe_ext(c)

    u: List[np.ndarray] = [transcript.sample_ext()]
    claim = hpoly.horner_eval(coeffs, u[0])

    for j in range(1, n_stack + 1):
        s_j_1, s_j_2 = proof.sumcheck_round_polys[j - 1]
        transcript.observe_ext(s_j_1)
        transcript.observe_ext(s_j_2)
        u_j = transcript.sample_ext()
        s_j_0 = ext.esub(claim, s_j_1)
        claim = hpoly.interpolate_quadratic_at_012([s_j_0, s_j_1, s_j_2], u_j)
        u.append(u_j)

    # final check: claim == sum over stacked columns of q * kernel coeffs.
    # The lift indicator and the prism kernels depend on a column's height
    # alone, so each height computes them once (a trace of 2,633 columns
    # would otherwise repeat them 2,633 times).
    by_height = {}

    def prism_kernels(n: int):
        if n not in by_height:
            n_lift = max(n, 0)
            if n < 0:
                l_eff = l_skip + n
                rs_n = [ext.epow(r[0], 1 << (-n))]
            else:
                l_eff = l_skip
                rs_n = r[: n_lift + 1]
            by_height[n] = (
                hpoly.eval_in_uni(l_skip, n, u[0]),
                hpoly.eval_eq_prism(l_eff, u[: n_lift + 1], rs_n),
                hpoly.eval_rot_kernel_prism(l_eff, u[: n_lift + 1], rs_n),
            )
        return by_height[n]

    q_coeffs = [
        [ZERO] * len(openings) for openings in proof.stacking_openings
    ]
    for commit_idx, layout in enumerate(layouts):
        lambda_indices = list(lambda_indices_per_layout[commit_idx])
        for col_pos, (_m, _c, s) in enumerate(layout.sorted_cols):
            lam_i, need_rot = lambda_indices[col_pos]
            n = s.log_height - l_skip
            n_lift = max(n, 0)
            bits = [
                ext.from_base((s.row_idx >> j) & 1)
                for j in range(l_skip + n_lift, l_skip + n_stack)
            ]
            eq_mle = (
                hpoly.eval_eq_mle(np.stack(u[n_lift + 1 :]), np.stack(bits))
                if bits
                else ONE
            )
            ind, eq_prism, rot_k = prism_kernels(n)
            batched = ext.emul(lam_sqr_pows[lam_i], eq_prism)
            if need_rot:
                batched = ext.eadd(
                    batched,
                    ext.emul(ext.emul(lam_sqr_pows[lam_i], lam), rot_k),
                )
            q_coeffs[commit_idx][s.col_idx] = ext.eadd(
                q_coeffs[commit_idx][s.col_idx],
                ext.emul(ext.emul(eq_mle, batched), ind),
            )

    final_sum = ZERO
    for coeff_vec, q_vec in zip(q_coeffs, proof.stacking_openings):
        for qc, qv in zip(coeff_vec, q_vec):
            transcript.observe_ext(qv)
            final_sum = ext.eadd(final_sum, ext.emul(qc, qv))

    if not ext.eeq(claim, final_sum):
        raise FinalSumMismatch()
    return u
