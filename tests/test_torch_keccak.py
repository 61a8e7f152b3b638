"""Keccak-f[1600] through the torch port on the CPU: the port's copy of the
model (``swirl_torch/models/keccak.py``) against the reference's, and the
port's ``run_test`` on 2 permutations (64 rows, the parameters of
``tests/test_keccak.py``): debug check, prove and verify, the proof's bytes
accepted by ``swirl.verifier``, a tampered column opening refused by both
verifiers, and a flipped bit refused by the debug check at its row.
Tolerance: exact equality.
"""

import copy
import hashlib

import numpy as np
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

import swirl.models.keccak as jk  # noqa: E402
import swirl_torch.models.keccak as tk  # noqa: E402
from swirl_torch.codec import decode_proof, encode_proof, encode_vk  # noqa: E402
from swirl_torch.engine import StarkEngine  # noqa: E402
from swirl_torch.fields.babybear import P  # noqa: E402
from swirl_torch import params as tparams  # noqa: E402
from swirl_torch.prover.backend import ProvingContext  # noqa: E402
from swirl_torch.verifier.errors import VerifierError  # noqa: E402

PARAMS = (2, 5, 3)


def _trace(pkg, perms: int, seed: int):
    inputs = np.random.default_rng(seed).integers(0, 1 << 63, (perms, 5, 5), dtype=np.uint64)
    return pkg.KeccakAir.generate_trace(inputs)


def test_sha3_matches_hashlib():
    for msg in [b"", b"abc", b"swirl" * 50, bytes(range(200))]:
        assert tk.sha3_256(msg) == hashlib.sha3_256(msg).digest()


def test_keccak_f_matches_reference():
    lanes = np.random.default_rng(3).integers(0, 1 << 63, (4, 5, 5), dtype=np.uint64)
    assert np.array_equal(tk.keccak_f(lanes), jk.keccak_f(lanes))


def test_trace_matches_reference():
    got, want = _trace(tk, 3, 0), _trace(jk, 3, 0)
    assert got.shape == (128, tk.NUM_KECCAK_COLS) and got.dtype == want.dtype
    assert np.array_equal(got, want)


def test_column_layout_matches_reference():
    assert tk.NUM_KECCAK_COLS == jk.NUM_KECCAK_COLS == 2633
    names = [n for n in vars(jk.Cols) if n.isupper()]
    assert [getattr(tk.Cols, n) for n in names] == [getattr(jk.Cols, n) for n in names]
    for fn, args in (("step_flag", (5,)), ("preimage", (1, 2, 3)), ("a", (4, 0, 1)), ("c", (2, 63)),
                     ("c_prime", (4, 7)), ("a_prime", (3, 4, 62)), ("a_pp", (2, 2, 2)),
                     ("a_pp_00_bit", (9,)), ("a_ppp_00", (3,))):
        assert getattr(tk.Cols, fn)(*args) == getattr(jk.Cols, fn)(*args)


@pytest.fixture(scope="module")
def keccak_run():
    """(engine, pk, vk, proof, trace) of the port's run_test on the CPU:
    keygen, the debug check, prove and the port's verifier."""
    trace = _trace(tk, 2, 2)
    assert trace.shape == (64, tk.NUM_KECCAK_COLS)
    eng = StarkEngine(tparams.test_system_params_small(*PARAMS), device="cpu")
    air = tk.KeccakAir()
    vk, proof = eng.run_test([air], [(trace, [], [])])
    pk, _ = eng.keygen([air])
    return eng, pk, vk, proof, trace


def _tamper(proof):
    bad = copy.deepcopy(proof)
    ops = bad.batch_constraint_proof.column_openings[0][0]
    ops[5] = (np.asarray(ops[5]) + 1) % P
    return bad


def test_port_proof_passes_the_jax_verifier(keccak_run):
    from swirl.codec import decode_proof as jax_decode_proof
    from swirl.codec import decode_vk as jax_decode_vk
    from swirl.verifier import verify

    _, _, vk, proof, _ = keccak_run
    jvk = jax_decode_vk(encode_vk(vk))
    verify(jvk.params, jvk, jax_decode_proof(encode_proof(proof)))


def test_tampered_opening_is_refused_by_both_verifiers(keccak_run):
    from swirl.codec import decode_proof as jax_decode_proof
    from swirl.codec import decode_vk as jax_decode_vk
    from swirl.verifier import verify
    from swirl.verifier.errors import VerifierError as JaxVerifierError

    eng, _, vk, proof, _ = keccak_run
    bad = _tamper(decode_proof(encode_proof(proof)))
    with pytest.raises(VerifierError) as port_err:
        eng.verify(vk, bad)
    jvk = jax_decode_vk(encode_vk(vk))
    with pytest.raises(JaxVerifierError) as jax_err:
        verify(jvk.params, jvk, jax_decode_proof(encode_proof(bad)))
    assert type(port_err.value).__name__ == type(jax_err.value).__name__


def test_flipped_bit_is_refused_by_the_debug_check_at_its_row(keccak_run):
    """One a_prime bit flipped in the middle of the trace: a bit constraint
    still holds, but the theta parity link and the recomposition of A fail
    at that row, and the check names it."""
    eng, pk, _, _, trace = keccak_run
    row = 37
    bad = trace.copy()
    col = tk.Cols.a_prime(2, 3, 17)
    bad[row, col] ^= 1
    ctx = ProvingContext([eng.context_for(0, bad, [], [])])
    with pytest.raises(AssertionError, match=rf"of AIR KeccakAir \(id 0\) failed at row {row}$"):
        eng.debug([tk.KeccakAir()], pk, ctx)


@pytest.mark.slow
def test_proof_matches_jax_engine_bytes(keccak_run):
    """The JAX engine's proof of the same 64-row trace (about 230 s on a CPU)."""
    from swirl.codec import encode_proof as jax_encode_proof
    from swirl.engine import StarkEngine as JaxEngine
    from swirl.params import test_system_params_small as jax_params

    _, _, _, proof, trace = keccak_run
    _, jproof = JaxEngine(jax_params(*PARAMS)).run_test([jk.KeccakAir()], [(trace, [], [])], debug=False)
    assert encode_proof(proof) == jax_encode_proof(jproof)
