"""The torch port's host protocol tools against the JAX package's:
``observe_ext_np`` and ``TranscriptValidator`` (``swirl_torch/transcript.py``,
as ``tests/test_hash_transcript.py`` holds JAX's), the Lean extraction
(``swirl_torch/lean_extraction.py``: the same Lean text as
``swirl/lean_extraction.py`` from the two packages' keygens), and the golden
tools (``swirl_torch/testing/golden.py``): ``build_case`` on the CPU
reproduces ``tests/golden`` byte for byte for the four BabyBear cases and
``regenerate`` writes the same files. Tolerance: exact equality.
"""

import filecmp
import os

import numpy as np
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

import swirl  # noqa: E402
import swirl_torch  # noqa: E402
from swirl import lean_extraction as jlean  # noqa: E402
from swirl import transcript as jtr  # noqa: E402
from swirl_torch import lean_extraction as tlean  # noqa: E402
from swirl_torch import transcript as ttr  # noqa: E402
from swirl_torch.fields.babybear import P  # noqa: E402
from swirl_torch.testing import golden  # noqa: E402

BABYBEAR_CASES = ("fib", "interactions", "preprocessed", "cached_preprocessed")


def _events(mod):
    rec = mod.Transcript(record=True)
    rec.observe(5)
    rec.observe_slice([1, 2, 3])
    s1 = rec.sample()
    rec.observe(9)
    s2 = rec.sample_ext()
    mod.observe_ext_np(rec, np.arange(24, dtype=np.uint64).reshape(2, 3, 4) * 7919 % P)
    s3 = rec.sample_bits(10)
    return rec, (s1, list(s2), s3)


def test_observe_ext_np_matches_jax():
    trec, tvals = _events(ttr)
    jrec, jvals = _events(jtr)
    assert trec.log == jrec.log
    assert [int(x) for x in trec.state] == [int(x) for x in jrec.state]
    assert tvals[0] == jvals[0] and tvals[2] == jvals[2]
    assert [int(x) for x in tvals[1]] == [int(x) for x in jvals[1]]


def test_validator_replay_matches():
    rec, (s1, s2, s3) = _events(ttr)
    val = ttr.TranscriptValidator(rec.log)
    val.observe(5)
    val.observe_slice([1, 2, 3])
    assert val.sample() == s1
    val.observe(9)
    assert val.sample_ext().tolist() == [int(x) for x in s2]
    ttr.observe_ext_np(val, np.arange(24, dtype=np.uint64).reshape(2, 3, 4) * 7919 % P)
    assert val.sample_bits(10) == s3
    val.finish()


@pytest.mark.parametrize("mod", [ttr, jtr], ids=["port", "jax"])
def test_divergence_detected(mod):
    rec = mod.Transcript(record=True)
    rec.observe(5)
    rec.sample()
    val = mod.TranscriptValidator(rec.log)
    with pytest.raises(mod.TranscriptDivergence, match="divergence at event 0"):
        val.observe(6)
    val2 = mod.TranscriptValidator(rec.log)
    val2.observe(5)
    with pytest.raises(mod.TranscriptDivergence, match="consumed 1 of 2"):
        val2.finish()
    val3 = mod.TranscriptValidator(rec.log)
    val3.observe(5)
    val3.sample()
    with pytest.raises(mod.TranscriptDivergence, match="exhausted at event 2"):
        val3.sample()


@pytest.fixture(scope="module")
def built():
    """{case: build_case(case, device="cpu")} for the BabyBear cases."""
    return {name: golden.build_case(name, device="cpu") for name in BABYBEAR_CASES}


@pytest.mark.parametrize("name", BABYBEAR_CASES)
def test_build_case_matches_golden(built, name):
    vk_bytes, pre_hash, proof_bytes, log, _, _ = built[name]
    paths = golden.paths_for(name)
    with open(paths["vk"], "rb") as f:
        assert f.read() == vk_bytes
    with open(paths["proof"], "rb") as f:
        assert f.read() == proof_bytes
    with open(paths["prehash"]) as f:
        assert f.read().strip() == pre_hash
    with open(paths["transcript"], "rb") as f:
        assert f.read() == golden.encode_transcript_log(log)


@pytest.mark.parametrize("name", BABYBEAR_CASES)
def test_verifier_replays_the_prover_log(built, name):
    """The port's verifier against a validator built from the prover's
    recorded log (the reference's recorder/validator harness); a log with
    one event changed diverges there."""
    from swirl_torch.engine import StarkEngine

    _, _, _, log, vk, proof = built[name]
    params = golden.golden_cases()[name]()[0]
    eng = StarkEngine(params, device="cpu")
    val = ttr.TranscriptValidator(log)
    eng.verify(vk, proof, transcript=val)
    val.finish()
    at = len(log) // 2
    bad = list(log)
    bad[at] = (bad[at][0], (bad[at][1] + 1) % P)
    with pytest.raises(ttr.TranscriptDivergence, match=f"at event {at}"):
        eng.verify(vk, proof, transcript=ttr.TranscriptValidator(bad))


def test_regenerate_writes_the_same_files(tmp_path, monkeypatch):
    monkeypatch.setattr(golden, "GOLDEN_DIR", str(tmp_path))
    golden.regenerate(list(BABYBEAR_CASES), device="cpu")
    repo_golden = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
    for name in BABYBEAR_CASES:
        for path in golden.paths_for(name).values():
            assert filecmp.cmp(path, os.path.join(repo_golden, os.path.basename(path)), shallow=False), path


def _vk(pkg, airs):
    from importlib import import_module

    params = import_module(f"{pkg.__name__}.params").test_system_params_small(2, 5, 3)
    keygen = import_module(f"{pkg.__name__}.keygen")
    return [keygen.keygen_air(air, params, False)[0] for air in airs]


def _airs(pkg, which):
    from importlib import import_module

    fx = import_module(f"{pkg.__name__}.testing.fixtures")
    if which == "fixtures":
        return [fx.FibonacciAir(), fx.SelfInteractionAir(width=6),
                fx.DummyInteractionAir(2, is_send=True, bus_index=3),
                fx.FibonacciSelectorAir([i % 3 != 2 for i in range(16)])]
    return [import_module(f"{pkg.__name__}.models.keccak").KeccakAir()]


@pytest.mark.parametrize("which", ["fixtures", "keccak"])
def test_render_vk_matches_jax(which):
    """The Lean text of each AIR of the fixtures and of keccak-f, rendered
    from each package's verifying keys."""
    from types import SimpleNamespace

    jairs, tairs = _airs(swirl, which), _airs(swirl_torch, which)
    names = [a.name() for a in tairs]
    assert names == [a.name() for a in jairs]
    got = tlean.render_vk(SimpleNamespace(per_air=_vk(swirl_torch, tairs)), names)
    want = jlean.render_vk(SimpleNamespace(per_air=_vk(swirl, jairs)), names)
    assert got == want
    assert got.count("namespace ") == len(names)
