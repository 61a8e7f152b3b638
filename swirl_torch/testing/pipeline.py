"""Pipeline decomposition helpers: run the prover only up to the batch
constraint stage and verify that stage in isolation.

Peer of ``swirl/testing/pipeline.py`` and of the reference
``test_utils/mod.rs:40`` (``prove_up_to_batch_constraints``), used by the
conformance suite's stage-isolation tests (lib.rs:378-565): exercising GKR
+ the batched zerocheck sumcheck without committing to the opening stages,
so stage-level negatives (e.g. a tampered q0 claim) hit the exact rejecting
check. The prover side runs the Coordinator's own commit, preamble and RAP
stage, so its transcript holds the full prove's events up to that stage.
"""

from __future__ import annotations

import numpy as np

from ..prover.backend import Coordinator, DeviceMultiStarkProvingKey, ProvingContext, trace_provers
from ..prover.logup_zerocheck import prove_zerocheck_and_logup
from ..transcript import Transcript


def prove_up_to_batch_constraints(
    backend,
    mpk: DeviceMultiStarkProvingKey,
    unsorted_ctx: ProvingContext,
    transcript: Transcript = None,
):
    """Commit + preamble + RAP constraint stage only.

    Returns (common_commit, trace_vdata, public_values, gkr_proof,
    batch_proof, r, post-stage transcript) — everything the stage-level
    verifier needs.
    """
    coordinator = Coordinator(backend, transcript or Transcript())
    ctx = unsorted_ctx.sorted_for_stacking()
    common_commit, _, trace_vdata, public_values = coordinator.commit_and_observe(mpk, ctx)
    gkr_proof, batch_proof, r = prove_zerocheck_and_logup(
        coordinator.transcript, mpk.params, mpk.max_constraint_degree, trace_provers(mpk, ctx),
        save_memory=bool(backend.config.zerocheck_save_memory),
    )
    return common_commit, trace_vdata, public_values, gkr_proof, batch_proof, r, coordinator.transcript


def verify_up_to_batch_constraints(
    mvk,
    common_commit: np.ndarray,
    trace_vdata,
    public_values,
    gkr_proof,
    batch_proof,
    transcript: Transcript = None,
):
    """Stage-level verification of the RAP constraint proof (preamble replay
    + GKR verify + batch-constraint verify)."""
    from ..verifier.batch_constraints import verify_zerocheck_and_logup

    transcript = transcript or Transcript()
    params = mvk.params
    transcript.observe_commit(mvk.pre_hash)
    transcript.observe_commit(common_commit)
    num_airs = len(mvk.per_air)
    for air_id in range(num_airs):
        avk = mvk.per_air[air_id]
        vdata = trace_vdata[air_id]
        if not avk.is_required:
            transcript.observe(1 if vdata is not None else 0)
        if vdata is not None:
            if avk.preprocessed_data is not None:
                transcript.observe_commit(avk.preprocessed_data.commit)
            else:
                transcript.observe(vdata.log_height)
            for c in vdata.cached_commitments:
                transcript.observe_commit(c)
        for pv in public_values[air_id]:
            transcript.observe(pv)

    trace_id_to_air_id = sorted(
        (a for a in range(num_airs) if trace_vdata[a] is not None),
        key=lambda a: (-trace_vdata[a].log_height, a),
    )
    n_per_trace = [
        trace_vdata[a].log_height - params.l_skip for a in trace_id_to_air_id
    ]
    return verify_zerocheck_and_logup(
        transcript,
        params,
        mvk.per_air,
        public_values,
        gkr_proof,
        batch_proof,
        trace_id_to_air_id,
        n_per_trace,
    )
