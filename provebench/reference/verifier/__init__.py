"""Full SWIRL verifier (host, numpy).

Cf. reference ``crates/stark-backend/src/verifier/mod.rs:57``: params check,
trace-height linear constraints, transcript preamble replay, batch
constraint verification (GKR + sumcheck + DAG evaluation), stacked-reduction
verification, WHIR verification.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..fields import ext
from ..keygen import MultiStarkVerifyingKey
from ..params import SystemParams
from ..proof import Proof
from ..prover.stacked_pcs import StackedLayout
from ..transcript import Transcript
from .batch_constraints import BatchConstraintError, verify_zerocheck_and_logup
from .errors import (
    PreprocessedTraceHeightMismatch,
    SystemParamsMismatch,
    TraceHeightsTooLarge,
    VerifierError,
)
from .errors import EmptyTraces as _EmptyTraces
from .gkr import GkrError
from .proof_shape import (
    CachedCommitmentsMismatch,
    ProofShapeError,
    PublicValuesCountMismatch,
    verify_proof_shape,
)
from .stacked_reduction import StackedReductionError, verify_stacked_reduction
from .whir import WhirError, verify_whir


def verify(
    params: SystemParams,
    mvk: MultiStarkVerifyingKey,
    proof: Proof,
    transcript: Optional[Transcript] = None,
    scheme=None,
) -> None:
    """Raises on any failure; on acceptance returns the batch sumcheck's
    point r, at which the proof's column openings claim each column's value
    (this copy returns it for ``reference/openings.py``).

    ``scheme`` (swirl_torch/hash/scheme.py) selects the hash family for the
    transcript and Merkle checks; None = inner BabyBear Poseidon2-16."""
    if transcript is None:
        transcript = Transcript() if scheme is None else scheme.new_transcript()
    if params != mvk.params:
        raise SystemParamsMismatch()
    per_air = mvk.per_air
    l_skip = params.l_skip
    num_airs = len(per_air)
    num_traces = sum(1 for v in proof.trace_vdata if v is not None)
    if num_traces == 0:
        raise _EmptyTraces()

    layouts = verify_proof_shape(mvk, proof, scheme=scheme)

    trace_id_to_air_id = sorted(
        range(num_airs),
        key=lambda a: (
            proof.trace_vdata[a] is None,
            -(proof.trace_vdata[a].log_height if proof.trace_vdata[a] else 0),
            a,
        ),
    )[:num_traces]

    for c_idx, constraint in enumerate(mvk.trace_height_constraints):
        total = 0
        for air_id in trace_id_to_air_id:
            lh = proof.trace_vdata[air_id].log_height
            total += (1 << max(lh, l_skip)) * constraint.coefficients[air_id]
        if total >= constraint.threshold:
            raise TraceHeightsTooLarge(
                constraint_idx=c_idx, total=total, threshold=constraint.threshold
            )

    # preamble
    transcript.observe_commit(mvk.pre_hash)
    transcript.observe_commit(proof.common_main_commit)
    for air_id in range(num_airs):
        vdata = proof.trace_vdata[air_id]
        avk = per_air[air_id]
        pvs = proof.public_values[air_id]
        if not avk.is_required:
            transcript.observe(1 if vdata is not None else 0)
        if vdata is not None:
            if avk.preprocessed_data is not None:
                if avk.preprocessed_data.hypercube_dim + l_skip != vdata.log_height:
                    raise PreprocessedTraceHeightMismatch(
                        air_idx=air_id,
                        expected=avk.preprocessed_data.hypercube_dim + l_skip,
                        actual=vdata.log_height,
                    )
                transcript.observe_commit(avk.preprocessed_data.commit)
            else:
                transcript.observe(vdata.log_height)
            if len(vdata.cached_commitments) != len(avk.params.width.cached_mains):
                raise CachedCommitmentsMismatch(
                    air_idx=air_id,
                    expected=len(avk.params.width.cached_mains),
                    actual=len(vdata.cached_commitments),
                )
            for c in vdata.cached_commitments:
                transcript.observe_commit(c)
            if len(pvs) != avk.params.num_public_values:
                raise PublicValuesCountMismatch(
                    air_idx=air_id,
                    expected=avk.params.num_public_values,
                    actual=len(pvs),
                )
        for pv in pvs:
            transcript.observe(pv)

    n_per_trace = [
        proof.trace_vdata[a].log_height - l_skip for a in trace_id_to_air_id
    ]
    r = verify_zerocheck_and_logup(
        transcript,
        params,
        per_air,
        proof.public_values,
        proof.gkr_proof,
        proof.batch_constraint_proof,
        trace_id_to_air_id,
        n_per_trace,
    )

    need_rot_per_commit = [
        [per_air[a].params.need_rot for a in trace_id_to_air_id]
    ]
    for a in trace_id_to_air_id:
        need_rot = per_air[a].params.need_rot
        if per_air[a].preprocessed_data is not None:
            need_rot_per_commit.append([need_rot])
        for _ in proof.trace_vdata[a].cached_commitments:
            need_rot_per_commit.append([need_rot])

    u = verify_stacked_reduction(
        transcript,
        proof.stacking_proof,
        layouts,
        need_rot_per_commit,
        l_skip,
        params.n_stack,
        proof.batch_constraint_proof.column_openings,
        r,
    )

    u_cube = []
    cur = u[0]
    for _ in range(l_skip):
        u_cube.append(cur)
        cur = ext.emul(cur, cur)
    u_cube.extend(u[1:])

    commits = [proof.common_main_commit]
    for a in trace_id_to_air_id:
        if per_air[a].preprocessed_data is not None:
            commits.append(per_air[a].preprocessed_data.commit)
        commits.extend(proof.trace_vdata[a].cached_commitments)

    verify_whir(
        transcript,
        params,
        proof.whir_proof,
        proof.stacking_proof.stacking_openings,
        commits,
        u_cube,
        scheme=scheme,
    )
    return r
