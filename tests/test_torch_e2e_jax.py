"""The port's proofs against the JAX engine's, byte for byte, on three
cheap conformance shapes (mixed heights, two cached parts, an absent
optional AIR), and the pipeline stage tests of ``tests/test_e2e_extra.py``
on ``swirl_torch.testing.pipeline``. Each package builds its own AIRs and
params from the same arguments and encodes with its own codec; the JAX
engine runs on the CPU.
"""

import copy
import importlib

import numpy as np
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

from swirl_torch.fields.babybear import P  # noqa: E402


def _mixed_heights(pkg):
    fx = importlib.import_module(f"{pkg}.testing.fixtures")
    fib, mix = fx.FibonacciAir(), fx.MixtureAir(3)
    ctxs = [
        (fx.FibonacciAir.generate_trace(1, 2, 32), fx.FibonacciAir.pvs(1, 2, 32), []),
        (mix.generate_trace(8), [], []),
    ]
    return (2, 5, 3), [fib, mix], ctxs, None


def _two_cached_parts(pkg):
    fx = importlib.import_module(f"{pkg}.testing.fixtures")
    common, cached = fx.MultiCachedAir.generate_traces(16)
    return (2, 4, 2), [fx.MultiCachedAir()], [(common, [], cached)], None


def _absent_optional(pkg):
    """Two AIRs at keygen, only the first proved."""
    fx = importlib.import_module(f"{pkg}.testing.fixtures")
    trace = fx.FibonacciAir.generate_trace(1, 1, 16)
    return (2, 4, 3), [fx.FibonacciAir(), fx.MixtureAir(3)], [(trace, fx.FibonacciAir.pvs(1, 1, 16), [])], [0]


SHAPES = {"mixed_heights": _mixed_heights, "two_cached_parts": _two_cached_parts,
          "absent_optional_air": _absent_optional}


def _prove(pkg, build):
    """(vk bytes, proof bytes) of the shape through ``pkg``'s engine, with
    its own verifier run on the proof."""
    engine = importlib.import_module(f"{pkg}.engine")
    codec = importlib.import_module(f"{pkg}.codec")
    backend = importlib.import_module(f"{pkg}.prover.backend")
    params_of = importlib.import_module(f"{pkg}.params").test_system_params_small
    params, airs, ctxs, present = build(pkg)
    kw = {"device": "cpu"} if pkg == "swirl_torch" else {}
    eng = engine.StarkEngine(params_of(*params), **kw)
    if present is None:
        vk, proof = eng.run_test(airs, ctxs)
    else:
        pk, vk = eng.keygen(airs)
        ctx = backend.ProvingContext([eng.context_for(i, *ctxs[k]) for k, i in enumerate(present)])
        proof = eng.prove(eng.transport_pk(pk), ctx)
        eng.verify(vk, proof)
    return codec.encode_vk(vk), codec.encode_proof(proof)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_proof_matches_jax_bytes(name):
    assert _prove("swirl_torch", SHAPES[name]) == _prove("swirl", SHAPES[name])


@pytest.fixture(scope="module")
def pipeline_stage_run():
    """One prove-up-to-batch-constraints run shared by the stage tests, and
    the full prove's transcript log on the same inputs."""
    from swirl_torch.engine import StarkEngine
    from swirl_torch.params import test_system_params_small
    from swirl_torch.prover.backend import ProvingContext
    from swirl_torch.testing.fixtures import SelfInteractionAir
    from swirl_torch.testing.pipeline import prove_up_to_batch_constraints
    from swirl_torch.transcript import Transcript

    air = SelfInteractionAir(width=4)
    eng = StarkEngine(test_system_params_small(2, 5, 2), device="cpu")
    pk, vk = eng.keygen([air])
    ctx = ProvingContext([eng.context_for(0, air.generate_trace(32), [], [])])
    dpk = eng.transport_pk(pk)
    stage = prove_up_to_batch_constraints(eng.backend, dpk, ctx, Transcript(record=True))
    full = Transcript(record=True)
    eng.prove(dpk, ctx, full)
    return vk, stage, full.log


def test_stage_roundtrip(pipeline_stage_run):
    from swirl_torch.testing.pipeline import verify_up_to_batch_constraints

    vk, (commit, vdata, pvs, gkr, batch, r, _t), _ = pipeline_stage_run
    verify_up_to_batch_constraints(vk, commit, vdata, pvs, gkr, batch)


def test_stage_transcript_is_the_full_prove_prefix(pipeline_stage_run):
    _, (*_, transcript), full_log = pipeline_stage_run
    assert 0 < len(transcript.log) < len(full_log)
    assert transcript.log == full_log[: len(transcript.log)]


def test_tampered_q0_rejected_at_stage(pipeline_stage_run):
    from swirl_torch.testing.pipeline import verify_up_to_batch_constraints
    from swirl_torch.verifier.batch_constraints import BatchConstraintError
    from swirl_torch.verifier.gkr import GkrError

    vk, (commit, vdata, pvs, gkr, batch, r, _t), _ = pipeline_stage_run
    gkr = copy.deepcopy(gkr)
    gkr.q0_claim = (gkr.q0_claim + np.uint64(1)) % np.uint64(P)
    with pytest.raises((BatchConstraintError, GkrError)):
        verify_up_to_batch_constraints(vk, commit, vdata, pvs, gkr, batch)
