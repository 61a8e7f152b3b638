"""A leaf-shaped proof through the torch port (swirl_torch) on the CPU.

The leaf tier (``leaf_params_with_100_bits_security``) is the first
configuration of the port with ``log_blowup = 2`` and
``max_constraint_degree = 4``. Here both packages build small params of
that shape the way their ``test_system_params_small`` builds its own, and
prove two degree-4 SyntheticAirs (2^8 x 8 and 2^1 x 5) with random
witnesses from ``default_rng(7)``. The port's vk and proof must equal the
JAX engine's byte for byte, and the JAX verifier must accept the port's
bytes. Tolerance: exact equality (finite field, bytes).
"""

import importlib

import pytest

import jax

jax.config.update("jax_platforms", "cpu")

from swirl_torch.codec import encode_proof, encode_vk  # noqa: E402
from swirl_torch.engine import StarkEngine  # noqa: E402

from test_torch_prove import synthetic_pair, verify_port_bytes  # noqa: E402

L_SKIP, N_STACK, K_WHIR = 2, 7, 3
LOG_BLOWUP, DEGREE = 2, 4
SHAPES = ((8, 8), (1, 5))


def leaf_params_small(pkg: str):
    """``test_system_params_small(2, 7, 3)`` of package ``pkg`` with the
    leaf tier's log_blowup 2 and constraint degree 4."""
    params = importlib.import_module(f"{pkg}.params")
    return params.SystemParams(
        l_skip=L_SKIP,
        n_stack=N_STACK,
        w_stack=1 << 12,
        log_blowup=LOG_BLOWUP,
        whir=params.test_whir_config_small(
            LOG_BLOWUP, L_SKIP + N_STACK, K_WHIR, (L_SKIP + N_STACK) % K_WHIR
        ),
        logup=params.LogUpSecurityParameters(
            max_interaction_count=1 << 30, log_max_message_length=7, pow_bits=2
        ),
        max_constraint_degree=DEGREE,
    )


@pytest.fixture(scope="module")
def leaf_proofs():
    """(port vk bytes, port proof bytes, JAX vk bytes, JAX proof bytes)."""
    from swirl.codec import encode_proof as jax_encode_proof
    from swirl.codec import encode_vk as jax_encode_vk
    from swirl.engine import StarkEngine as JaxEngine

    airs, ctxs = synthetic_pair("swirl_torch", SHAPES, 7, DEGREE)
    vk, proof = StarkEngine(leaf_params_small("swirl_torch"), device="cpu").run_test(airs, ctxs)
    jairs, jctxs = synthetic_pair("swirl", SHAPES, 7, DEGREE)
    jvk, jproof = JaxEngine(leaf_params_small("swirl")).run_test(jairs, jctxs, debug=False)
    return encode_vk(vk), encode_proof(proof), jax_encode_vk(jvk), jax_encode_proof(jproof)


def test_leaf_shaped_proof_matches_jax_bytes(leaf_proofs):
    vk, proof, jvk, jproof = leaf_proofs
    assert vk == jvk
    assert proof == jproof


def test_leaf_shaped_proof_passes_the_verifier(leaf_proofs):
    vk, proof, _, _ = leaf_proofs
    verify_port_bytes(vk, proof)
