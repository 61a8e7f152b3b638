"""Proof shape verification: recomputes the expected stacking layouts and
checks structural sizes before any indexing (cf. reference
``crates/stark-backend/src/verifier/proof_shape.rs``).

Every failure raises a TYPED variant from :mod:`swirl_torch.verifier.errors`
(the peer of the reference's ``ProofShapeError`` enum tree,
``proof_shape.rs:12-190``) carrying the expected/actual values.

Returns the per-commitment stacking layouts (commit order: common main, then
per sorted trace its preprocessed and cached commitments).
"""

from __future__ import annotations

from typing import List

from ..keygen import MultiStarkVerifyingKey
from ..proof import Proof
from ..prover.stacked_pcs import StackedLayout
from .errors import (
    BatchShapeMismatch,
    CachedCommitmentsMismatch,
    ColumnOpeningsMismatch,
    ElementShapeMismatch,
    EmptyTraces,
    GkrShapeMismatch,
    LogHeightOutOfBounds,
    NonCanonicalElement,
    ProofShapeError,
    PublicValuesCountMismatch,
    PublicValuesLengthMismatch,
    PublicValuesNoVData,
    RequiredAirNoVData,
    StackingLayoutInvalid,
    StackingShapeMismatch,
    TotalStackedWidthOutOfBounds,
    VDataLengthMismatch,
    WhirShapeMismatch,
)

__all__ = ["ProofShapeError", "verify_proof_shape"]


def _ensure_canonical(v, context: str):
    import numpy as np

    from ..fields.babybear import P

    if getattr(v, "dtype", None) != np.uint64:
        raise NonCanonicalElement(context=context)
    if not bool((np.asarray(v) < P).all()):
        raise NonCanonicalElement(context=context)


def _ensure_ef(v, context: str):
    if getattr(v, "shape", None) != (4,):
        raise ElementShapeMismatch(
            context=context, expected=(4,), actual=getattr(v, "shape", None)
        )
    _ensure_canonical(v, context)


def _ensure_digest(v, context: str):
    if getattr(v, "shape", None) != (8,):
        raise ElementShapeMismatch(
            context=context, expected=(8,), actual=getattr(v, "shape", None)
        )
    _ensure_canonical(v, context)


def _check_len(err_cls, what, actual_seq, expected, **extra):
    actual = len(actual_seq)
    if actual != expected:
        raise err_cls(what=what, expected=expected, actual=actual, **extra)


def verify_proof_shape(
    mvk: MultiStarkVerifyingKey, proof: Proof, scheme=None
) -> List[StackedLayout]:
    """``scheme`` (swirl_torch/hash/scheme.py) selects the digest validity check;
    None = inner (8,) BabyBear digests."""
    _digest = _ensure_digest if scheme is None else scheme.check_digest
    params = mvk.params
    l_skip = params.l_skip
    num_airs = len(mvk.per_air)
    if len(proof.trace_vdata) != num_airs:
        raise VDataLengthMismatch(len=len(proof.trace_vdata), num_airs=num_airs)
    if len(proof.public_values) != num_airs:
        raise PublicValuesLengthMismatch(
            len=len(proof.public_values), num_airs=num_airs
        )

    for air_id, avk in enumerate(mvk.per_air):
        vdata = proof.trace_vdata[air_id]
        pvs = proof.public_values[air_id]
        if vdata is None:
            if avk.is_required:
                raise RequiredAirNoVData(air_idx=air_id)
            if len(pvs) != 0:
                raise PublicValuesNoVData(air_idx=air_id)
        else:
            if len(vdata.cached_commitments) != len(avk.params.width.cached_mains):
                raise CachedCommitmentsMismatch(
                    air_idx=air_id,
                    expected=len(avk.params.width.cached_mains),
                    actual=len(vdata.cached_commitments),
                )
            if not (0 <= vdata.log_height <= params.log_stacked_height):
                raise LogHeightOutOfBounds(
                    air_idx=air_id,
                    bound=params.log_stacked_height,
                    actual=vdata.log_height,
                )
            if len(pvs) != avk.params.num_public_values:
                raise PublicValuesCountMismatch(
                    air_idx=air_id,
                    expected=avk.params.num_public_values,
                    actual=len(pvs),
                )

    num_traces = sum(1 for v in proof.trace_vdata if v is not None)
    if num_traces == 0:
        raise EmptyTraces()

    trace_id_to_air_id = sorted(
        (a for a in range(num_airs) if proof.trace_vdata[a] is not None),
        key=lambda a: (-proof.trace_vdata[a].log_height, a),
    )

    # layouts
    common_dims = []
    for a in trace_id_to_air_id:
        w = mvk.per_air[a].params.width.common_main
        common_dims.append((w, proof.trace_vdata[a].log_height))
    try:
        layouts = [StackedLayout.new(l_skip, params.log_stacked_height, common_dims)]
        for a in trace_id_to_air_id:
            avk = mvk.per_air[a]
            lh = proof.trace_vdata[a].log_height
            if avk.preprocessed_data is not None:
                pw = avk.params.width.preprocessed
                layouts.append(
                    StackedLayout.new(l_skip, params.log_stacked_height, [(pw, lh)])
                )
            for cw in avk.params.width.cached_mains:
                layouts.append(
                    StackedLayout.new(l_skip, params.log_stacked_height, [(cw, lh)])
                )
    except ValueError as e:
        raise StackingLayoutInvalid(reason=str(e))
    total_stacked_width = sum(l.width for l in layouts)
    if total_stacked_width > params.w_stack:
        raise TotalStackedWidthOutOfBounds(
            actual=total_stacked_width, w_stack=params.w_stack
        )

    # GKR proof shape (proof_shape.rs:381-414): the round count is derived
    # from the total lifted interaction count, and layer j's sumcheck has
    # exactly j round polys of 3 evaluations each.
    from ..params import calculate_n_logup

    total_interactions = sum(
        len(mvk.per_air[a].symbolic_constraints.interactions)
        << max(proof.trace_vdata[a].log_height, l_skip)
        for a in trace_id_to_air_id
    )
    n_logup = calculate_n_logup(l_skip, total_interactions)
    num_gkr_rounds = 0 if total_interactions == 0 else l_skip + n_logup
    gp = proof.gkr_proof
    _check_len(GkrShapeMismatch, "claims_per_layer", gp.claims_per_layer, num_gkr_rounds)
    _check_len(
        GkrShapeMismatch,
        "sumcheck_polys",
        gp.sumcheck_polys,
        max(num_gkr_rounds - 1, 0),
    )
    for i, layer in enumerate(gp.sumcheck_polys):
        _check_len(GkrShapeMismatch, f"sumcheck_polys[{i}] sub-rounds", layer, i + 1)
        for poly in layer:
            _check_len(GkrShapeMismatch, f"layer {i + 1} round poly evals", poly, 3)
            for ev in poly:
                _ensure_ef(ev, "gkr round poly eval")
    _ensure_ef(gp.q0_claim, "gkr q0 claim")
    for cl in gp.claims_per_layer:
        for v in (cl.p_xi_0, cl.p_xi_1, cl.q_xi_0, cl.q_xi_1):
            _ensure_ef(v, "gkr layer claim")

    bp = proof.batch_constraint_proof
    _check_len(
        BatchShapeMismatch, "numerator_term_per_air", bp.numerator_term_per_air, num_traces
    )
    _check_len(
        BatchShapeMismatch,
        "denominator_term_per_air",
        bp.denominator_term_per_air,
        num_traces,
    )
    n_max = max(
        max(proof.trace_vdata[a].log_height - l_skip for a in trace_id_to_air_id), 0
    )
    _check_len(BatchShapeMismatch, "sumcheck_round_polys", bp.sumcheck_round_polys, n_max)
    s_deg = params.max_constraint_degree + 1
    for rnd, evals in enumerate(bp.sumcheck_round_polys):
        _check_len(BatchShapeMismatch, f"sumcheck_round_polys[{rnd}] evals", evals, s_deg)
        for ev in evals:
            _ensure_ef(ev, "batch round poly eval")
    _check_len(
        BatchShapeMismatch,
        "univariate_round_coeffs",
        bp.univariate_round_coeffs,
        s_deg * ((1 << l_skip) - 1) + 1,
    )
    for c in bp.univariate_round_coeffs:
        _ensure_ef(c, "univariate round coeff")
    for v in list(bp.numerator_term_per_air) + list(bp.denominator_term_per_air):
        _ensure_ef(v, "per-air logup term")
    _check_len(BatchShapeMismatch, "column_openings", bp.column_openings, num_traces)
    for t_idx, a in enumerate(trace_id_to_air_id):
        avk = mvk.per_air[a]
        parts = bp.column_openings[t_idx]
        num_parts = (
            1
            + (1 if avk.preprocessed_data is not None else 0)
            + len(avk.params.width.cached_mains)
        )
        _check_len(
            ColumnOpeningsMismatch, "parts", parts, num_parts, trace_idx=t_idx
        )
        mult = 2 if avk.params.need_rot else 1
        widths = (
            [avk.params.width.common_main]
            + ([avk.params.width.preprocessed] if avk.preprocessed_data else [])
            + list(avk.params.width.cached_mains)
        )
        for p_idx, (part, w) in enumerate(zip(parts, widths)):
            _check_len(
                ColumnOpeningsMismatch,
                f"part {p_idx} openings",
                part,
                w * mult,
                trace_idx=t_idx,
            )
            for op in part:
                _ensure_ef(op, "column opening")

    sp = proof.stacking_proof
    _check_len(
        StackingShapeMismatch,
        "univariate_round_coeffs",
        sp.univariate_round_coeffs,
        2 * ((1 << l_skip) - 1) + 1,
    )
    _check_len(
        StackingShapeMismatch,
        "sumcheck_round_polys",
        sp.sumcheck_round_polys,
        params.n_stack,
    )
    for rnd, ev in enumerate(sp.sumcheck_round_polys):
        _check_len(StackingShapeMismatch, f"sumcheck_round_polys[{rnd}] evals", ev, 2)
        for v in ev:
            _ensure_ef(v, "stacking round poly eval")
    for c in sp.univariate_round_coeffs:
        _ensure_ef(c, "stacking univariate coeff")
    _check_len(
        StackingShapeMismatch, "stacking_openings", sp.stacking_openings, len(layouts)
    )
    for c_idx, (opens, layout) in enumerate(zip(sp.stacking_openings, layouts)):
        _check_len(
            StackingShapeMismatch,
            f"stacking_openings[{c_idx}]",
            opens,
            layout.width,
        )
        for op in opens:
            _ensure_ef(op, "stacking opening")

    wp = proof.whir_proof
    num_rounds = params.num_whir_rounds()
    k = params.k_whir
    _check_len(
        WhirShapeMismatch, "whir_sumcheck_polys", wp.whir_sumcheck_polys, num_rounds * k
    )
    for poly in wp.whir_sumcheck_polys:
        _check_len(WhirShapeMismatch, "whir sumcheck poly evals", poly, 2)
        for ev in poly:
            _ensure_ef(ev, "whir sumcheck eval")
    _check_len(WhirShapeMismatch, "codeword_commits", wp.codeword_commits, num_rounds - 1)
    for d in wp.codeword_commits:
        _digest(d, "codeword commit")
    _check_len(WhirShapeMismatch, "ood_values", wp.ood_values, num_rounds - 1)
    for v in wp.ood_values:
        _ensure_ef(v, "ood value")
    _check_len(
        WhirShapeMismatch,
        "folding_pow_witnesses",
        wp.folding_pow_witnesses,
        num_rounds * k,
    )
    _check_len(
        WhirShapeMismatch,
        "query_phase_pow_witnesses",
        wp.query_phase_pow_witnesses,
        num_rounds,
    )
    _check_len(
        WhirShapeMismatch,
        "initial_round_opened_rows",
        wp.initial_round_opened_rows,
        len(layouts),
    )
    _check_len(
        WhirShapeMismatch,
        "initial_round_merkle_proofs",
        wp.initial_round_merkle_proofs,
        len(layouts),
    )
    nq0 = params.whir.rounds[0].num_queries
    depth0 = params.log_stacked_height + params.log_blowup - k
    for c_idx, layout in enumerate(layouts):
        rows_per_q = wp.initial_round_opened_rows[c_idx]
        proofs_per_q = wp.initial_round_merkle_proofs[c_idx]
        _check_len(
            WhirShapeMismatch,
            f"initial_round_opened_rows[{c_idx}] queries",
            rows_per_q,
            nq0,
        )
        _check_len(
            WhirShapeMismatch,
            f"initial_round_merkle_proofs[{c_idx}] queries",
            proofs_per_q,
            nq0,
        )
        for rows in rows_per_q:
            if rows.shape != (1 << k, layout.width):
                raise ElementShapeMismatch(
                    context=f"opened row (commit {c_idx})",
                    expected=(1 << k, layout.width),
                    actual=rows.shape,
                )
            _ensure_canonical(rows, f"opened row (commit {c_idx})")
        for pf in proofs_per_q:
            _check_len(
                WhirShapeMismatch,
                f"initial merkle proof depth (commit {c_idx})",
                pf,
                depth0,
            )
            for sib in pf:
                _digest(sib, "initial merkle sibling")
    _check_len(
        WhirShapeMismatch,
        "codeword_opened_values rounds",
        wp.codeword_opened_values,
        num_rounds - 1,
    )
    _check_len(
        WhirShapeMismatch,
        "codeword_merkle_proofs rounds",
        wp.codeword_merkle_proofs,
        num_rounds - 1,
    )
    for rnd in range(1, num_rounds):
        nq = params.whir.rounds[rnd].num_queries
        depth = depth0 - rnd
        opened = wp.codeword_opened_values[rnd - 1]
        proofs = wp.codeword_merkle_proofs[rnd - 1]
        _check_len(
            WhirShapeMismatch, f"codeword_opened_values[{rnd - 1}] queries", opened, nq
        )
        _check_len(
            WhirShapeMismatch, f"codeword_merkle_proofs[{rnd - 1}] queries", proofs, nq
        )
        for vals in opened:
            if vals.shape != (1 << k, 4):
                raise ElementShapeMismatch(
                    context=f"codeword opened value (round {rnd})",
                    expected=(1 << k, 4),
                    actual=vals.shape,
                )
            _ensure_canonical(vals, f"codeword opened value (round {rnd})")
        for pf in proofs:
            _check_len(
                WhirShapeMismatch,
                f"codeword merkle proof depth (round {rnd})",
                pf,
                depth,
            )
            for sib in pf:
                _digest(sib, "codeword merkle sibling")
    _check_len(
        WhirShapeMismatch,
        "final_poly",
        wp.final_poly,
        1 << params.log_final_poly_len(),
    )
    for c in wp.final_poly:
        _ensure_ef(c, "final poly coeff")
    _digest(proof.common_main_commit, "common main commit")
    for air_id, vdata in enumerate(proof.trace_vdata):
        if vdata is not None:
            for d in vdata.cached_commitments:
                _digest(d, f"AIR {air_id} cached commitment")
    return layouts
