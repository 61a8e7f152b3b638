"""The port's verifier (``swirl_torch.verifier``) against the JAX package's
on the CPU.

- The port decodes the golden vk and proof bytes with its own codec and
  its verifier accepts them.
- The tamper matrix of ``tests/test_e2e.py``: each tamper is applied to a
  proof the port made. The port's verifier reads the port's objects;
  ``swirl.verifier`` reads ``swirl.codec``'s decoding of the tampered
  proof's bytes (a tamper of an element's shape, which no codec can write,
  is applied to both decodings of the untampered bytes). Both must reject
  with the same error class.
- ``tests/test_transcript_extractor.py`` on the port's recorded transcripts
  of the golden cases.
"""

import numpy as np
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

from swirl_torch import codec as tcodec  # noqa: E402
from swirl_torch.engine import StarkEngine  # noqa: E402
from swirl_torch.fields.babybear import P  # noqa: E402
from swirl_torch.params import test_system_params_small as small_params  # noqa: E402
from swirl_torch.testing.fixtures import FibonacciAir, SelfInteractionAir  # noqa: E402
from swirl_torch.testing.golden import golden_cases, paths_for  # noqa: E402
from swirl_torch.transcript import Transcript  # noqa: E402
from swirl_torch.verifier import verify  # noqa: E402
from swirl_torch.verifier.proof_shape import ProofShapeError  # noqa: E402
from swirl_torch.verifier.transcript_extractor import (  # noqa: E402
    ExtractionError,
    StreamExhausted,
    TrailingEntries,
    UnexpectedEntryKind,
    ValueMismatch,
    extract_proof_from_transcript,
    whir_hints_from_proof,
)

GOLDEN = ["fib", "interactions", "preprocessed", "cached_preprocessed"]


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", GOLDEN)
def test_port_verifier_accepts_golden_bytes(name):
    paths = paths_for(name)
    vk = tcodec.decode_vk(_read(paths["vk"]))
    verify(vk.params, vk, tcodec.decode_proof(_read(paths["proof"])))


def _prove(params, air, trace, pvs):
    vk, proof = StarkEngine(params, device="cpu").run_test([air], [(trace, pvs, [])])
    return tcodec.encode_vk(vk), tcodec.encode_proof(proof)


@pytest.fixture(scope="module")
def proofs():
    """Port proofs as (vk bytes, proof bytes): a Fibonacci of 64 rows, and
    a self-interaction of 8 rows (the GKR path populated)."""
    air = FibonacciAir()
    sint = SelfInteractionAir(4)
    return {
        "fib": _prove(small_params(2, 6, 3), air, air.generate_trace(0, 1, 64), air.pvs(0, 1, 64)),
        "selfint": _prove(small_params(2, 4, 3), sint, sint.generate_trace(8), []),
    }


def _bump(a, i=0):
    a[i] = (int(a[i]) + 1) % P


def _pv(p):
    p.public_values[0][2] = (p.public_values[0][2] + 1) % P


def _short_sibling(p):
    pf = p.whir_proof.initial_round_merkle_proofs[0][0]
    pf[0] = pf[0][:7]


def _short_ef(p):
    part = p.batch_constraint_proof.column_openings[0][0]
    part[0] = part[0][:3]


def _eval_count(p):
    poly = p.whir_proof.whir_sumcheck_polys[0]
    p.whir_proof.whir_sumcheck_polys[0] = poly + [poly[0]]


def _final_poly_shape(p):
    p.whir_proof.final_poly[0] = np.zeros(8, dtype=np.uint64)


def _commit_shape(p):
    p.common_main_commit = p.common_main_commit[:4]


# name -> (proof, tamper, changes an element's shape)
TAMPERS = {
    "public_value": ("fib", _pv, False),
    "opening": ("fib", lambda p: _bump(p.batch_constraint_proof.column_openings[0][0][0]), False),
    "final_poly": ("fib", lambda p: _bump(p.whir_proof.final_poly[0]), False),
    "q0_claim": ("selfint", lambda p: _bump(p.gkr_proof.q0_claim), False),
    "merkle_sibling": ("fib", lambda p: _bump(p.whir_proof.initial_round_merkle_proofs[0][0][0]), False),
    "short_sibling": ("fib", _short_sibling, True),
    "short_ef_opening": ("fib", _short_ef, True),
    "whir_eval_count": ("fib", _eval_count, True),
    "final_poly_shape": ("fib", _final_poly_shape, True),
    "commit_shape": ("fib", _commit_shape, True),
}


def _rejection(verify_fn, vk, proof) -> Exception:
    with pytest.raises(Exception) as err:
        verify_fn(vk.params, vk, proof)
    return err.value


@pytest.mark.parametrize("name", sorted(TAMPERS))
def test_tamper_rejected_like_jax(proofs, name):
    from swirl import codec as jcodec
    from swirl.verifier import verify as jax_verify

    case, tamper, reshapes = TAMPERS[name]
    vk_bytes, proof_bytes = proofs[case]
    port = tcodec.decode_proof(proof_bytes)
    tamper(port)
    if reshapes:
        ref = jcodec.decode_proof(proof_bytes)
        tamper(ref)
    else:
        ref = jcodec.decode_proof(tcodec.encode_proof(port))
    got = _rejection(verify, tcodec.decode_vk(vk_bytes), port)
    want = _rejection(jax_verify, jcodec.decode_vk(vk_bytes), ref)
    assert type(got).__name__ == type(want).__name__
    # a shape is refused before any indexing, as the reference's verifier does
    assert isinstance(got, ProofShapeError) == reshapes


# ------------------------------------------------------ transcript extractor


def _assert_fields_equal(a, b):
    assert np.array_equal(a.common_main_commit, b.common_main_commit)
    ga, gb = a.gkr_proof, b.gkr_proof
    assert ga.logup_pow_witness == gb.logup_pow_witness
    assert np.array_equal(ga.q0_claim, gb.q0_claim)
    assert len(ga.claims_per_layer) == len(gb.claims_per_layer)
    for ca, cb in zip(ga.claims_per_layer, gb.claims_per_layer):
        for f in ("p_xi_0", "q_xi_0", "p_xi_1", "q_xi_1"):
            assert np.array_equal(getattr(ca, f), getattr(cb, f))
    ba, bb = a.batch_constraint_proof, b.batch_constraint_proof
    for x, y in zip(ba.univariate_round_coeffs, bb.univariate_round_coeffs):
        assert np.array_equal(x, y)
    assert len(ba.column_openings) == len(bb.column_openings)
    for pa, pb in zip(ba.column_openings, bb.column_openings):
        for fa, fb in zip(pa, pb):
            assert len(fa) == len(fb)
            for x, y in zip(fa, fb):
                assert np.array_equal(x, y)
    sa, sb = a.stacking_proof, b.stacking_proof
    for oa, ob in zip(sa.stacking_openings, sb.stacking_openings):
        for x, y in zip(oa, ob):
            assert np.array_equal(x, y)
    wa, wb = a.whir_proof, b.whir_proof
    assert wa.mu_pow_witness == wb.mu_pow_witness
    assert wa.folding_pow_witnesses == wb.folding_pow_witnesses
    assert wa.query_phase_pow_witnesses == wb.query_phase_pow_witnesses
    for x, y in zip(wa.codeword_commits, wb.codeword_commits):
        assert np.array_equal(x, y)
    for x, y in zip(wa.ood_values, wb.ood_values):
        assert np.array_equal(x, y)
    for x, y in zip(wa.final_poly, wb.final_poly):
        assert np.array_equal(x, y)


@pytest.fixture(scope="module")
def recorded():
    """name -> (vk, proof, log): the port's golden proofs with the prover's
    recorded transcript."""
    out = {}
    for name in ("fib", "interactions"):
        params, airs, ctxs = golden_cases()[name]()
        transcript = Transcript(record=True)
        vk, proof = StarkEngine(params, device="cpu").run_test(airs, ctxs, transcript)
        out[name] = vk, proof, list(transcript.log)
    return out


@pytest.mark.parametrize("name", ["fib", "interactions"])
def test_extracted_fields_equal_the_proof(recorded, name):
    vk, proof, log = recorded[name]
    _assert_fields_equal(proof, extract_proof_from_transcript(vk, proof.trace_vdata, proof.public_values, log))


def test_extracted_proof_verifies_with_hints(recorded):
    """With the Merkle-bound WHIR objects supplied out of band, the
    extracted proof is the proof and passes the full verifier."""
    vk, proof, log = recorded["fib"]
    extracted = extract_proof_from_transcript(
        vk, proof.trace_vdata, proof.public_values, log, whir_hints=whir_hints_from_proof(proof)
    )
    assert tcodec.encode_proof(extracted) == tcodec.encode_proof(proof)
    StarkEngine(vk.params, device="cpu").verify(vk, extracted)


def test_tampered_stream_detected(recorded):
    vk, proof, log = recorded["fib"]
    with pytest.raises(ExtractionError):
        extract_proof_from_transcript(vk, proof.trace_vdata, proof.public_values, log[:-1])


def test_typed_extraction_errors(recorded):
    vk, proof, log = recorded["fib"]

    def extract(stream):
        return extract_proof_from_transcript(vk, proof.trace_vdata, proof.public_values, stream)

    with pytest.raises(StreamExhausted) as ei:
        extract(log[:-1])
    assert ei.value.fields["position"] == len(log) - 1

    with pytest.raises(TrailingEntries) as ei:
        extract(log + [("observe", 0), ("observe", 0)])
    assert ei.value.fields["remaining"] == 2

    k, v = log[10]
    flipped = list(log)
    flipped[10] = ("sample" if k == "observe" else "observe", v)
    with pytest.raises(UnexpectedEntryKind) as ei:
        extract(flipped)
    assert ei.value.fields["position"] == 10

    bad = list(log)
    bad[0] = (bad[0][0], (bad[0][1] + 1) % (1 << 31))
    with pytest.raises(ValueMismatch) as ei:
        extract(bad)
    assert ei.value.fields["label"] == "vk pre-hash"

    assert TrailingEntries(position=3, remaining=2) == TrailingEntries(position=3, remaining=2)
    assert TrailingEntries(position=3, remaining=2) != TrailingEntries(position=3, remaining=1)
