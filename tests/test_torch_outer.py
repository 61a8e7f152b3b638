"""The BN254 outer hash scheme through the torch port (swirl_torch) on the CPU.

The port keeps its own copies of the JAX package's host BN254 modules
(``hash/{bn254_constants,grain,bn254_rc3,bn254_poseidon2,multi_field,
scheme}.py``); these tests hold each copy to its original on the same
inputs (the permutation at widths 2 and 3, the sponge hash, the 2-to-1
compression, the felt packing, the transcript's samples and grind
witnesses, the host Merkle tree), reproduce the golden ``outer`` case's
transcript events and vk pre-hash, and run the four cases of
``tests/test_outer_engine.py`` through the port's engine. Tolerance: exact
equality (finite fields).
"""

import copy

import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

import swirl.hash.bn254_poseidon2 as jbn  # noqa: E402
import swirl.hash.multi_field as jmf  # noqa: E402
import swirl.hash.scheme as jscheme  # noqa: E402
import swirl_torch.hash.bn254_poseidon2 as tbn  # noqa: E402
import swirl_torch.hash.multi_field as tmf  # noqa: E402
import swirl_torch.hash.scheme as tscheme  # noqa: E402
from swirl_torch.engine import StarkEngine  # noqa: E402
from swirl_torch.fields.babybear import P  # noqa: E402
from swirl_torch.params import test_system_params_small as small_params  # noqa: E402
from swirl_torch.testing.fixtures import FibonacciAir  # noqa: E402
from swirl_torch.testing.golden import (  # noqa: E402
    CASE_SCHEME,
    case_has_codec,
    decode_transcript_log,
    encode_transcript_log,
    golden_cases,
    paths_for,
    pre_hash_hex,
)
from swirl_torch.verifier.errors import VerifierError  # noqa: E402

P_BN254 = tbn.P_BN254


def _bn_ints(rng, n):
    return [int.from_bytes(rng.bytes(32), "little") % P_BN254 for _ in range(n)]


@pytest.mark.parametrize("width", [2, 3])
def test_permutation_matches_jax(width):
    rng = np.random.default_rng(width)
    for state in ([0] * width, [P_BN254 - 1] * width, *(_bn_ints(rng, width) for _ in range(4))):
        assert tbn.permute(state, width) == jbn.permute(state, width)
    assert tbn.constants(width) == jbn.constants(width)


def test_hash_compress_and_packing_match_jax():
    rng = np.random.default_rng(7)
    for n in (0, 1, 7, 8, 9, 16, 17, 40):
        vals = rng.integers(0, P, n, dtype=np.uint64)
        assert tmf.pack_felts(vals) == jmf.pack_felts(vals)
        assert tmf.MultiFieldHasher.hash_slice(vals) == jmf.MultiFieldHasher.hash_slice(vals)
    a, b = _bn_ints(rng, 2)
    assert tmf.MultiFieldHasher.compress(a, b) == jmf.MultiFieldHasher.compress(a, b)
    assert tbn.hash_scalars([a, b, 5]) == jbn.hash_scalars([a, b, 5])
    rows = rng.integers(0, P, (8, 5), dtype=np.uint64)
    assert tmf.MultiFieldHasher.merkle_root(rows) == jmf.MultiFieldHasher.merkle_root(rows)


def _drive(mod, seed: int):
    """Observations, commits, samples and grinds through a transcript of
    ``mod``; returns everything it produced."""
    rng = np.random.default_rng(seed)
    t = mod.MultiFieldTranscript(record=True)
    out = []
    for step in range(30):
        t.observe(int(rng.integers(0, P)))
        if step % 4 == 0:
            t.observe_commit(_bn_ints(rng, 1)[0])
        if step % 3 == 1:
            t.observe_ext(rng.integers(0, P, 4, dtype=np.uint64))
        if step % 2 == 0:
            out.append(t.sample())
        if step % 5 == 0:
            out.append([int(v) for v in t.sample_ext()])
            out.append(t.sample_bits(step % 20 + 1))
        if step % 7 == 3:
            out.append(t.grind(step % 6 + 1))
    return out, t.log


@pytest.mark.parametrize("seed", [0, 1])
def test_transcript_samples_and_grinds_match_jax(seed):
    got, got_log = _drive(tmf, seed)
    want, want_log = _drive(jmf, seed)
    assert got == want
    assert got_log == want_log
    # the port's validator replays the JAX package's log and refuses a change
    v = tmf.MultiFieldTranscriptValidator(want_log)
    _drive_validator(v, seed)
    v.finish()
    bad = list(want_log)
    bad[3] = (bad[3][0], bad[3][1] + 1)
    with pytest.raises(AssertionError, match="divergence at event 3"):
        _drive_validator(tmf.MultiFieldTranscriptValidator(bad), seed)


def _drive_validator(v, seed):
    rng = np.random.default_rng(seed)
    for step in range(30):
        v.observe(int(rng.integers(0, P)))
        if step % 4 == 0:
            v.observe_commit(_bn_ints(rng, 1)[0])
        if step % 3 == 1:
            v.observe_ext(rng.integers(0, P, 4, dtype=np.uint64))
        if step % 2 == 0:
            v.sample()
        if step % 5 == 0:
            v.sample_ext()
            v.sample_bits(step % 20 + 1)
        if step % 7 == 3:
            v.grind(step % 6 + 1)


@pytest.mark.parametrize("ext", [False, True])
def test_host_tree_matches_jax(ext):
    """The port's tree builder (a tensor in, read to the host once) builds
    the JAX package's tree from the same matrix, and answers the device
    tree's ``batch_query_proofs_arr`` with a tensor of indices."""
    rng = np.random.default_rng(3)
    shape = (2, 16, 4) if ext else (3, 16)
    mat = rng.integers(0, P, shape, dtype=np.uint64)
    scheme = tscheme.get_scheme("bn254-outer")
    root, tree = scheme.tree_builder()(torch.from_numpy(mat.astype(np.int64)), 4, ext)
    want = jscheme.build_host_tree(mat, 4, ext, jscheme.Bn254OuterScheme.hash_slice,
                                   jscheme.Bn254OuterScheme.compress)
    assert tree.layers == want.layers and root == want.root
    idx = [0, 3, 1]
    assert tree.batch_query_proofs_arr(torch.tensor(idx)) == want.batch_query_proofs(idx)
    assert all(isinstance(d, int) for path in tree.batch_query_proofs(idx) for d in path)


def test_scheme_names():
    assert tscheme.get_scheme(None).name == "babybear-poseidon2"
    assert tscheme.get_scheme("bn254").name == tscheme.get_scheme("bn254-outer").name == "bn254-outer"
    assert tscheme.get_scheme("babybear").tree_builder() is None
    with pytest.raises(ValueError, match="unknown hash scheme"):
        tscheme.get_scheme("sha256")


def test_port_reproduces_golden_outer_case():
    """The golden outer case's transcript, event for event, and its vk
    pre-hash (one BN254 scalar); the port's verifier accepts the proof."""
    assert not case_has_codec("outer")
    params, airs, ctxs = golden_cases()["outer"]()
    eng = StarkEngine(params, hash_scheme=CASE_SCHEME["outer"], device="cpu")
    transcript = eng.scheme.new_transcript(record=True)
    vk, proof = eng.run_test(airs, ctxs, transcript)
    paths = paths_for("outer")
    with open(paths["transcript"], "rb") as f:
        golden = f.read()
    got = decode_transcript_log(encode_transcript_log(transcript.log))
    want = decode_transcript_log(golden)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"outer: the transcript diverges at event {i}"
    assert len(got) == len(want)
    assert encode_transcript_log(transcript.log) == golden
    assert any(v >= 1 << 64 for _, v in got)  # BN254 digests survive the codec whole
    with open(paths["prehash"]) as f:
        assert pre_hash_hex(vk.pre_hash) == f.read().strip()


@pytest.fixture(scope="module")
def outer_proven():
    eng = StarkEngine(small_params(2, 6, 3), hash_scheme="bn254-outer", device="cpu")
    air = FibonacciAir()
    vk, proof = eng.run_test([air], [(air.generate_trace(0, 1, 64), air.pvs(0, 1, 64), [])])
    return eng, vk, proof


def test_outer_proof_e2e(outer_proven):
    eng, vk, proof = outer_proven
    assert isinstance(proof.common_main_commit, int)
    assert isinstance(vk.pre_hash, int)
    for c in proof.whir_proof.codeword_commits:
        assert isinstance(c, int)
    for pf_set in proof.whir_proof.initial_round_merkle_proofs:
        for pf in pf_set:
            assert all(isinstance(sib, int) for sib in pf)
    for pf_set in proof.whir_proof.codeword_merkle_proofs:
        for pf in pf_set:
            assert all(isinstance(sib, int) for sib in pf)
    eng.verify(vk, proof)


def test_outer_proof_diverges_from_inner(outer_proven):
    _, _, outer_proof = outer_proven
    air = FibonacciAir()
    _, inner_proof = StarkEngine(small_params(2, 6, 3), device="cpu").run_test(
        [air], [(air.generate_trace(0, 1, 64), air.pvs(0, 1, 64), [])], debug=False
    )
    a = np.asarray(outer_proof.batch_constraint_proof.univariate_round_coeffs[0])
    b = np.asarray(inner_proof.batch_constraint_proof.univariate_round_coeffs[0])
    assert not np.array_equal(a, b)


def test_outer_tamper_rejected(outer_proven):
    eng, vk, proof = outer_proven
    bad = copy.deepcopy(proof)
    bad.common_main_commit = (bad.common_main_commit + 1) % P_BN254
    with pytest.raises(VerifierError):
        eng.verify(vk, bad)

    bad2 = copy.deepcopy(proof)
    pf = bad2.whir_proof.initial_round_merkle_proofs[0][0]
    pf[0] = (pf[0] + 1) % P_BN254
    with pytest.raises(VerifierError):
        eng.verify(vk, bad2)

    bad3 = copy.deepcopy(proof)
    bad3.whir_proof.codeword_commits[0] = np.zeros(8, dtype=np.uint64)
    with pytest.raises(VerifierError):
        eng.verify(vk, bad3)


def test_outer_preprocessed_air():
    """Preprocessed commitments carry BN254 digests too (the keygen
    committer goes through the scheme's tree builder)."""
    from swirl_torch.testing.fixtures import FibonacciSelectorAir

    eng = StarkEngine(small_params(2, 4, 3), hash_scheme="bn254-outer", device="cpu")
    air = FibonacciSelectorAir([i % 2 == 0 for i in range(16)])
    vk, proof = eng.run_test([air], [(air.generate_trace(1, 1), air.pvs(1, 1), [])])
    prep = vk.per_air[0].preprocessed_data
    assert prep is not None and isinstance(prep.commit, int)
    eng.verify(vk, proof)


def test_device_transcript_is_refused_under_the_outer_scheme(outer_proven):
    """The device sponge is BabyBear Poseidon2-16: a prove under the BN254
    scheme must not take it."""
    from swirl_torch.prover.backend import ProvingContext
    from swirl_torch.prover.device_transcript import DeviceTranscript
    from swirl_torch.prover.errors import ProverError

    eng, _, _ = outer_proven
    air = FibonacciAir()
    pk, _ = eng.keygen([air])
    ctx = ProvingContext([eng.context_for(0, air.generate_trace(0, 1, 64), air.pvs(0, 1, 64), [])])
    with pytest.raises(ProverError, match="BabyBear Poseidon2-16"):
        eng.prove(eng.transport_pk(pk), ctx, DeviceTranscript("cpu"))
