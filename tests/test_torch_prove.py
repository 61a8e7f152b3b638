"""Whole proofs through the torch port (swirl_torch) on the CPU.

The port must reproduce the golden proofs byte for byte with their
transcript logs, give the same bytes as the JAX package on a random-witness
SyntheticAir proof, and that proof must pass ``swirl.verifier.verify``.
Each package builds its own cases, params and AIRs and encodes with its own
codec; the two meet at the bytes, and the JAX verifier reads the port's
proof through ``swirl.codec``. On CPU tensors every kernel wrapper runs its
plain PyTorch version.
"""

import numpy as np
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

from swirl_torch.codec import encode_proof, encode_vk  # noqa: E402
from swirl_torch.engine import StarkEngine  # noqa: E402
from swirl_torch.fields.babybear import P  # noqa: E402
from swirl_torch.testing.golden import encode_transcript_log, golden_cases, paths_for  # noqa: E402
from swirl_torch.transcript import Transcript  # noqa: E402

GOLDEN = ["fib", "interactions", "preprocessed", "cached_preprocessed"]


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", GOLDEN)
def test_port_reproduces_golden_proof(name):
    params, airs, ctxs = golden_cases()[name]()
    transcript = Transcript(record=True)
    vk, proof = StarkEngine(params, device="cpu").run_test(airs, ctxs, transcript)
    paths = paths_for(name)
    assert encode_transcript_log(transcript.log) == _read(paths["transcript"])
    assert encode_vk(vk) == _read(paths["vk"])
    assert encode_proof(proof) == _read(paths["proof"])


def test_unbalanced_interactions_are_refused():
    """A receiver row that no sender matches leaves a non-zero LogUp sum.
    The debug check is off, as in the reference's ``test_unbalanced_fails``,
    so that the prover itself refuses (the debug check's own refusal is in
    ``tests/test_torch_debug.py``)."""
    from swirl_torch.testing.fixtures import DummyInteractionAir

    params, airs, ctxs = golden_cases()["interactions"]()
    recv = np.array(ctxs[1][0], dtype=np.uint64)
    recv[0, 1] = 8  # (7, 9) -> (8, 9)
    ctxs = [ctxs[0], (DummyInteractionAir.make_trace(recv.tolist()), [], [])]
    with pytest.raises(ValueError, match="fractional sum is non-zero"):
        StarkEngine(params, device="cpu").run_test(airs, ctxs, debug=False)


def synthetic_pair(pkg, shapes, seed: int, degree: int):
    """SyntheticAirs of the package ``pkg`` (``swirl`` or ``swirl_torch``)
    and their random witnesses from ``default_rng(seed)``. Column 0 is the
    kill column and stays zero, so any values in the other columns satisfy
    every constraint and balance every bus."""
    import importlib

    syn = importlib.import_module(f"{pkg}.testing.synthetic")
    rng = np.random.default_rng(seed)
    airs, ctxs = [], []
    for log_h, width in shapes:
        air = syn.SyntheticAir(
            syn.uniform_shape(log_h, width, num_constraints=4, num_interactions=2, degree=degree)
        )
        trace = rng.integers(0, P, (1 << log_h, air.common_main_width()), dtype=np.uint64)
        trace[:, 0] = 0
        airs.append(air)
        ctxs.append((trace, [], []))
    return airs, ctxs


def verify_port_bytes(vk_bytes: bytes, proof_bytes: bytes) -> None:
    """Verify the port's encoded proof with the JAX package's verifier."""
    from swirl.codec import decode_proof, decode_vk
    from swirl.verifier import verify

    vk = decode_vk(vk_bytes)
    verify(vk.params, vk, decode_proof(proof_bytes))


@pytest.fixture(scope="module")
def random_synthetic():
    """(port vk bytes, port proof bytes, JAX vk bytes, JAX proof bytes) for
    two SyntheticAirs with random witnesses, 2^8 rows and 2 rows (below
    2^l_skip: a lifted, strided trace)."""
    from swirl.codec import encode_proof as jax_encode_proof
    from swirl.codec import encode_vk as jax_encode_vk
    from swirl.engine import StarkEngine as JaxEngine
    from swirl.params import test_system_params_small as jax_params
    from swirl_torch.params import test_system_params_small

    shapes = ((8, 8), (1, 5))
    airs, ctxs = synthetic_pair("swirl_torch", shapes, 7, 3)
    vk, proof = StarkEngine(test_system_params_small(2, 7, 3), device="cpu").run_test(airs, ctxs)
    jairs, jctxs = synthetic_pair("swirl", shapes, 7, 3)
    jvk, jproof = JaxEngine(jax_params(2, 7, 3)).run_test(jairs, jctxs, debug=False)
    return encode_vk(vk), encode_proof(proof), jax_encode_vk(jvk), jax_encode_proof(jproof)


def test_random_proof_matches_jax_bytes(random_synthetic):
    vk, proof, jvk, jproof = random_synthetic
    assert vk == jvk
    assert proof == jproof


def test_random_proof_passes_the_verifier(random_synthetic):
    vk, proof, _, _ = random_synthetic
    verify_port_bytes(vk, proof)
