"""The port's copies of the JAX package's host modules against their
originals: params presets, the transcript, the host Poseidon2, the native
library and the codec. The port keeps its own copy of every host module it
uses (it imports nothing of ``swirl``); these tests hold each copy to the
original on the same numpy inputs. Tolerance: exact equality.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

import swirl.codec as jcodec  # noqa: E402
import swirl.hash.poseidon2 as jp2  # noqa: E402
import swirl.native as jnative  # noqa: E402
import swirl.params as jparams  # noqa: E402
import swirl.transcript as jtranscript  # noqa: E402
import swirl_torch.codec as tcodec  # noqa: E402
import swirl_torch.hash.poseidon2 as tp2  # noqa: E402
import swirl_torch.native as tnative  # noqa: E402
import swirl_torch.params as tparams  # noqa: E402
import swirl_torch.transcript as ttranscript  # noqa: E402
from swirl_torch.fields.babybear import P  # noqa: E402
from swirl_torch.testing.golden import paths_for  # noqa: E402

PRESETS = (
    [("app_params_with_100_bits_security", h) for h in range(20, 25)]
    + [("leaf_params_with_100_bits_security", h) for h in range(23, 26)]
    + [("internal_params_with_100_bits_security", None)]
    + [("root_params_with_100_bits_security", None)]
    + [("test_system_params_small", (2, 6, 3)), ("test_system_params_small", (2, 7, 3))]
)


def _fields(obj):
    """A params object as nested plain values (dataclasses by field name),
    so objects of the two packages compare field by field."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__, {f.name: _fields(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if isinstance(obj, (list, tuple)):
        return [_fields(x) for x in obj]
    return obj


@pytest.mark.parametrize("preset,arg", PRESETS)
def test_params_preset_matches_jax(preset, arg):
    args = arg if isinstance(arg, tuple) else (() if arg is None else (arg,))
    got = getattr(tparams, preset)(*args)
    want = getattr(jparams, preset)(*args)
    assert _fields(got) == _fields(want)
    assert got.log_stacked_height == want.log_stacked_height


def _drive(mod, seed: int):
    """The same observations and samples through a transcript of ``mod``;
    returns the samples and the final sponge state."""
    rng = np.random.default_rng(seed)
    t = mod.Transcript()
    out = []
    for step in range(40):
        t.observe(int(rng.integers(0, P)))
        if step % 3 == 0:
            t.observe_commit(rng.integers(0, P, 8, dtype=np.uint64))
        if step % 4 == 1:
            t.observe_ext(rng.integers(0, P, 4, dtype=np.uint64))
        if step % 2 == 0:
            out.append(t.sample())
        if step % 5 == 0:
            out.append([int(v) for v in t.sample_ext()])
            out.append(t.sample_bits(step % 20 + 1))
    return out, np.array(t.state, dtype=np.uint64)


@pytest.mark.parametrize("seed", [0, 1])
def test_transcript_matches_jax(seed):
    got, got_state = _drive(ttranscript, seed)
    want, want_state = _drive(jtranscript, seed)
    assert got == want
    assert np.array_equal(got_state, want_state)


@pytest.mark.parametrize("bits", [1, 8, 12])
def test_grind_matches_jax(bits):
    tt, tj = ttranscript.Transcript(), jtranscript.Transcript()
    for t in (tt, tj):
        for v in (5, 17, 123456789):
            t.observe(v)
    w = tt.grind(bits)
    assert w == tj.grind(bits)
    assert np.array_equal(tt.state, tj.state)
    assert tt.sample() == tj.sample()


def test_native_library_matches_jax(tmp_path, monkeypatch):
    """The port's native build (under build/) loads wherever g++ is, and its
    permutation and grind equal the numpy references and the JAX package's
    library. The JAX package builds its library in place beside its source,
    so a worker of a parallel run could load it while another writes it:
    here it builds from a copy of its source (read only) in ``tmp_path``,
    privately to this test."""
    src = os.path.join(os.path.dirname(jnative.__file__), "swirl_host.cpp")
    shutil.copyfile(src, tmp_path / "swirl_host.cpp")
    monkeypatch.setattr(jnative, "_HERE", str(tmp_path))
    monkeypatch.setattr(jnative, "_SRC", str(tmp_path / "swirl_host.cpp"))
    monkeypatch.setattr(jnative, "_tried", False)
    monkeypatch.setattr(jnative, "_lib", None)
    if shutil.which("g++"):
        assert tnative.available()
        assert jnative.available()
    s = np.random.default_rng(3).integers(0, P, (9, 16), dtype=np.uint64)
    assert np.array_equal(tp2.permute_np(s), jp2.permute_np(s))
    if not tnative.available():
        return
    assert np.array_equal(tnative.permute_batch(s), tp2.permute_np(s))
    t = ttranscript.Transcript()
    t.observe(7)
    w = tnative.grind(t.state, t.absorb_idx, t.sample_idx, 6)
    assert w == _numpy_grind(t, 6)
    assert np.array_equal(tnative.permute_batch(s), jnative.permute_batch(s))
    assert w == jnative.grind(t.state, t.absorb_idx, t.sample_idx, 6)


def _numpy_grind(t, bits: int) -> int:
    """The port's numpy grind (the native library switched off) from a copy
    of ``t``'s sponge."""
    c = ttranscript.Transcript()
    c.state, c.absorb_idx, c.sample_idx = t.state.copy(), t.absorb_idx, t.sample_idx
    real = tnative.available
    tnative.available = lambda: False
    try:
        return c.grind(bits)
    finally:
        tnative.available = real


def _sponge_at(seed: int, absorbed: int, samples: int):
    t = ttranscript.Transcript()
    for v in np.random.default_rng(seed).integers(0, P, absorbed, dtype=np.uint64):
        t.observe(int(v))
    for _ in range(samples):
        t.sample()
    return t


@pytest.mark.parametrize("bits", [1, 5, 12, 13, 15])
def test_native_grind_takes_the_smallest_witness(bits):
    """Below 13 bits the port's native grind returns its first hit in index
    order, above it takes each block's least: the same witness as the JAX
    package's library and the port's numpy grind, from sponges at several
    cursors (absorb 3 and 7; 8, where a full block permutes first; a sample
    cursor below the rate)."""
    if not tnative.available():
        pytest.skip("no C++ toolchain")
    for seed, absorbed, samples in ((0, 3, 0), (1, 7, 0), (2, 8, 0), (3, 5, 2)):
        t = _sponge_at(seed, absorbed, samples)
        w = tnative.grind(t.state, t.absorb_idx, t.sample_idx, bits)
        if jnative.available():
            assert w == jnative.grind(t.state, t.absorb_idx, t.sample_idx, bits)
        assert w == _numpy_grind(t, bits)
        assert t.check_witness(bits, w)


@pytest.mark.parametrize("width", [1, 7, 8, 9, 16, 33])
def test_host_hashes_match_jax(width):
    rng = np.random.default_rng(width)
    m = rng.integers(0, P, (11, width), dtype=np.uint64)
    assert np.array_equal(tp2.hash_rows_np(m), jp2.hash_rows_np(m))
    assert np.array_equal(tp2.hash_slice_np(m[0]), jp2.hash_slice_np(m[0]))
    left, right = m[:, :1].repeat(8, 1), rng.integers(0, P, (11, 8), dtype=np.uint64)
    assert np.array_equal(tp2.compress_np(left, right), jp2.compress_np(left, right))
    assert all(np.array_equal(a, b) for a, b in zip(tp2.constants(), jp2.constants()))


@pytest.mark.parametrize("name", ["fib", "interactions", "preprocessed", "cached_preprocessed"])
def test_codec_round_trips_golden_bytes(name):
    """Each golden vk and proof, decoded and re-encoded by the port's codec,
    gives the same bytes; the port's decoded vk encodes the same under the
    JAX package's reading too."""
    paths = paths_for(name)
    with open(paths["vk"], "rb") as f:
        vk_bytes = f.read()
    with open(paths["proof"], "rb") as f:
        proof_bytes = f.read()
    vk = tcodec.decode_vk(vk_bytes)
    assert tcodec.encode_vk(vk) == vk_bytes
    assert tcodec.encode_proof(tcodec.decode_proof(proof_bytes)) == proof_bytes
    assert jcodec.encode_vk(jcodec.decode_vk(vk_bytes)) == vk_bytes
    assert _fields(vk.params) == _fields(jcodec.decode_vk(vk_bytes).params)


def _ef(rng, *shape):
    return rng.integers(0, P, shape + (4,), dtype=np.uint64)


# the verifier's polynomial helpers: name -> arguments from a seeded rng
POLY_ARGS = {
    "interpolate_linear_at_01": lambda rng: (_ef(rng, 2), _ef(rng)),
    "interpolate_quadratic_at_012": lambda rng: (_ef(rng, 3), _ef(rng)),
    "interpolate_cubic_at_0123": lambda rng: (_ef(rng, 4), _ef(rng)),
    "lagrange_interpolate_at_integers": lambda rng: (_ef(rng, 7), _ef(rng)),
    "eval_eq_prism": lambda rng: (3, list(_ef(rng, 4)), list(_ef(rng, 4))),
    "eval_rot_kernel_prism": lambda rng: (3, list(_ef(rng, 4)), list(_ef(rng, 4))),
    "eval_mobius_eq_mle": lambda rng: (_ef(rng, 5), _ef(rng, 5)),
    "evals_mobius_eq_hypercube": lambda rng: (_ef(rng, 4),),
    "eval_mle_evals_at_point": lambda rng: (_ef(rng, 16), _ef(rng, 4)),
    "sum_over_subgroup_from_coeffs": lambda rng: (_ef(rng, 40), 3),
    "univariate_from_evals_on_subgroup": lambda rng: (_ef(rng, 8),),
    "powers_ef": lambda rng: (_ef(rng), 9),
}


@pytest.mark.parametrize("name", sorted(POLY_ARGS))
def test_verifier_poly_helpers_match_jax(name):
    import swirl.poly as jpoly
    import swirl_torch.poly as tpoly

    for seed in range(3):
        args = POLY_ARGS[name](np.random.default_rng(seed))
        assert np.array_equal(getattr(tpoly, name)(*args), getattr(jpoly, name)(*args))


def test_ext_helpers_match_jax():
    import swirl.fields.ext as jext
    import swirl_torch.fields.ext as text

    rng = np.random.default_rng(5)
    a, b = _ef(rng, 6), _ef(rng, 6)
    assert np.array_equal(text.edot(a, b), jext.edot(a, b))
    raw = rng.integers(0, 1 << 40, (3, 4), dtype=np.uint64)
    assert np.array_equal(text.from_coeffs(raw), jext.from_coeffs(raw))
    for x, y in ((a[0], a[0]), (a[0], b[0]), (a[1], a[1] + np.uint64(P))):
        assert text.eeq(x, y) == jext.eeq(x, y)
    assert text.eeq(a[1], a[1] + np.uint64(P)) and not text.eeq(a[0], b[0])


def test_eval_nodes_matches_jax():
    """The verifier's single-point DAG evaluation of a SyntheticAir at a
    random EF point, rotations, selectors and public values included."""
    import swirl
    import swirl_torch

    from swirl.prover import dag_eval as jde
    from swirl_torch.prover import dag_eval as tde

    def dag_of(pkg):
        from importlib import import_module

        syn = import_module(f"{pkg.__name__}.testing.synthetic")
        params = import_module(f"{pkg.__name__}.params")
        keygen = import_module(f"{pkg.__name__}.keygen")
        air = syn.SyntheticAir(syn.uniform_shape(4, 6, num_constraints=5, num_interactions=2, degree=3))
        vk, _ = keygen.keygen_air(air, params.test_system_params_small(2, 4, 3), False)
        return vk.symbolic_constraints

    rng = np.random.default_rng(6)
    sels = tuple(_ef(rng, 3))
    parts = [[(c, n) for c, n in zip(_ef(rng, 6), _ef(rng, 6))]]
    got = tde.eval_nodes(dag_of(swirl_torch), tde.HostEvaluator(sels, None, parts, [7]))
    want = jde.eval_nodes(dag_of(swirl), jde.HostEvaluator(sels, None, parts, [7]))
    assert len(got) == len(want) > 0
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
