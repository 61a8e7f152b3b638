"""A leaf-shaped proof of the torch port (swirl_torch) through
``prove_fused(mode="segmented")`` on the CPU, judged by the benchmark's
plain reference (``provebench/reference``) as the benchmark's check judges
its proofs.

The shape is the leaf tier's: ``log_blowup = 2`` and constraint degree 4,
with both packages' params built by ``test_torch_leaf.leaf_params_small``.
The AIR is the benchmark's ``synthetic`` family (a 2^8-row SyntheticAir
with interactions, the kill column zero) and the trace the family's own,
made from a seed. The reference's verifier must accept the proof's bytes
under its own verifying key, and the proof's column openings must equal
the trace's values at the verifier's point
(``reference.openings.column_openings``); with one opening changed it must
reject. Tolerance: exact equality (finite field).
"""

import os
import sys

import numpy as np
import pytest
import torch

from test_torch_leaf import DEGREE, leaf_params_small

BENCH_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "provebench")
if BENCH_DIR not in sys.path:
    sys.path.insert(0, BENCH_DIR)

import harness  # noqa: E402  (the benchmark's, from provebench/)

SEED = 2_400_000_017
CFG = {"air": {"log_height": 8, "width": 12, "num_constraints": 4, "num_interactions": 2, "degree": DEGREE,
               "kill_column": 0}}


@pytest.fixture(scope="module")
def leaf_case():
    """(reference params, reference vk, the trace, the proof's bytes)."""
    from reference.keygen import MultiStarkKeygenBuilder

    from swirl_torch.codec import encode_proof
    from swirl_torch.engine import StarkEngine
    from swirl_torch.prover import fused
    from swirl_torch.prover.backend import ProvingContext

    family = harness.load_module("families", "synthetic")
    eng = StarkEngine(leaf_params_small("swirl_torch"), device="cpu")
    pk, _ = eng.keygen([family.program_air(CFG)])
    dpk = eng.transport_pk(pk)
    ref_air = family.reference_air(CFG)
    trace = family.device_trace(CFG, ref_air.common_main_width(), SEED, torch.device("cpu"))
    proof = fused.prove_fused(eng.backend, dpk, ProvingContext([eng.context_for(0, trace)]), mode="segmented")

    params = leaf_params_small("reference")

    def no_preprocessed(*_):
        raise AssertionError("the reference's keygen met a preprocessed trace")

    builder = MultiStarkKeygenBuilder(params, no_preprocessed)
    builder.add_air(ref_air)
    return params, builder.generate_pk().get_vk(), trace, encode_proof(proof)


@pytest.mark.parametrize("tampered", [False, True], ids=["sound", "tampered"])
def test_leaf_proof_through_prove_fused_against_the_reference(leaf_case, tampered):
    from reference.codec import decode_proof
    from reference.openings import column_openings
    from reference.verifier import verify
    from reference.verifier.errors import VerifierError

    params, vk, trace, data = leaf_case
    assert (params.log_blowup, params.max_constraint_degree) == (2, 4)
    proof = decode_proof(data)
    openings = proof.batch_constraint_proof.column_openings[0][0]
    if tampered:
        first = np.array(openings[0], dtype=np.uint64)
        first[0] = (first[0] + 1) % 2013265921
        openings[0] = first
        with pytest.raises(VerifierError):
            verify(params, vk, proof)
        return
    r = verify(params, vk, proof)
    want = column_openings(trace, params.l_skip, r, vk.per_air[0].params.need_rot)
    got = np.asarray(openings, dtype=np.uint64).reshape(-1, 4)
    assert got.shape == want.shape
    assert np.array_equal(got, want)
